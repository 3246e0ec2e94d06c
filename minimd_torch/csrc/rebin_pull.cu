// One-hot pull rebin for Hopper (sm_90a).
//
// Replaces: minimd_tpu/ops/rebin_pallas.py, make_rebin_pull_slab (z-slab
// programs, LANE == 128 grids such as the 131k deck) and
// make_rebin_pull_pallas (per-(z, y)-row programs, e.g. the 4k deck with
// C = 48). Both have one contract, pull(cid, chans) -> (outs, counts,
// overflow), and so does this kernel.
//
// What bounds it on the H100: memory and latency, not arithmetic. Each
// destination cell scans the new cell ids of its 27 neighbor cells (27*C
// int32 reads, almost all served by L1/L2 since neighboring cells share
// them) and copies the few atoms that land in it: 6 float channels plus
// the int32 type, once each. At 864k atoms that is ~5.7 MB of cell ids
// read 27 times and ~40 MB of channels moved once.
//
// What this simple design does about it: one warp per destination cell.
// The warp walks the 27 neighbor cells in rebin_local's order (dz outer,
// dy, dx inner; minimd_tpu/cells.py rebin_local / rebin_pull) and their
// slots in ascending order, 32 at a time. A ballot selects the slots whose
// new cell id equals the target, and a popc prefix over the ballot ranks
// them; the running base carries across neighbor cells. So the output is
// the same permutation, bit for bit, as the plain rebin_pull. Selected
// atoms go to slot base+rank when it is below C; slots left unfilled are
// written as zero, as the plain version leaves them. Per-cell counts are
// written out, and the capacity overflow sum(max(count - C, 0)) is summed
// with an integer atomic (exact, so the order does not matter). The type
// moves as int32.
//
// The neighbor lookup is one function, `neighbor`, that wraps
// periodically. The sharded migration (dead-cell padding on decomposed
// axes, rebin_pallas.py:49-63) needs it to report a dead cell instead, so
// the multi-device port adds that there. Needs min(nb) >= 3, as the
// plain pull does.

#include <cuda_runtime.h>

namespace {

constexpr int kFloatChans = 6;  // x0 x1 x2 v0 v1 v2

struct Chans {
  const float* in[kFloatChans];
  float* out[kFloatChans];
  const int* tin;
  int* tout;
};

__device__ __forceinline__ int neighbor(int c, int d, int n) {
  const int u = c + d;
  return u < 0 ? u + n : (u >= n ? u - n : u);
}

__global__ void rebin_pull_kernel(const int* __restrict__ cid, Chans ch,
                                  int* __restrict__ counts,
                                  int* __restrict__ overflow, int nbx, int nby,
                                  int nbz, int C) {
  const int ncells = nbx * nby * nbz;
  const int target = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  if (target >= ncells) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int cx = target % nbx;
  const int cy = (target / nbx) % nby;
  const int cz = target / (nbx * nby);
  const long long dst0 = (long long)target * C;

  int base = 0;
  for (int dz = -1; dz <= 1; ++dz) {
    const int wz = neighbor(cz, dz, nbz);
    for (int dy = -1; dy <= 1; ++dy) {
      const int wy = neighbor(cy, dy, nby);
      for (int dx = -1; dx <= 1; ++dx) {
        const int wx = neighbor(cx, dx, nbx);
        const long long src0 = (long long)((wz * nby + wy) * nbx + wx) * C;
        for (int s0 = 0; s0 < C; s0 += 32) {
          const int s = s0 + lane;
          const bool sel = s < C && cid[src0 + s] == target;
          const unsigned ballot = __ballot_sync(0xffffffffu, sel);
          const int rank = base + __popc(ballot & below);
          if (sel && rank < C) {
            const long long src = src0 + s;
            const long long dst = dst0 + rank;
#pragma unroll
            for (int k = 0; k < kFloatChans; ++k) ch.out[k][dst] = ch.in[k][src];
            ch.tout[dst] = ch.tin[src];
          }
          base += __popc(ballot);
        }
      }
    }
  }

  for (int r = (base < C ? base : C) + lane; r < C; r += 32) {
#pragma unroll
    for (int k = 0; k < kFloatChans; ++k) ch.out[k][dst0 + r] = 0.0f;
    ch.tout[dst0 + r] = 0;
  }
  if (lane == 0) {
    counts[target] = base;
    if (base > C) atomicAdd(overflow, base - C);
  }
}

}  // namespace

// cid: (M,) int32 new cell ids (-1 = empty); in0..in5: (M,) float32
// channels; tin: (M,) int32 types; out0..out5 / tout: (ncells, C) outputs;
// counts: (ncells,) int32; overflow: one int32, zeroed by the caller.
// Returns cudaGetLastError().
extern "C" int rebin_pull_launch(const void* cid,
                                 const void* in0, const void* in1,
                                 const void* in2, const void* in3,
                                 const void* in4, const void* in5,
                                 const void* tin,
                                 void* out0, void* out1, void* out2,
                                 void* out3, void* out4, void* out5,
                                 void* tout, void* counts, void* overflow,
                                 int nbx, int nby, int nbz, int C,
                                 void* stream) {
  Chans ch;
  const void* ins[kFloatChans] = {in0, in1, in2, in3, in4, in5};
  void* outs[kFloatChans] = {out0, out1, out2, out3, out4, out5};
  for (int k = 0; k < kFloatChans; ++k) {
    ch.in[k] = (const float*)ins[k];
    ch.out[k] = (float*)outs[k];
  }
  ch.tin = (const int*)tin;
  ch.tout = (int*)tout;
  const int ncells = nbx * nby * nbz;
  const int threads = 128;  // 4 warps = 4 destination cells per block
  const int blocks = (ncells * 32 + threads - 1) / threads;
  rebin_pull_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cid, ch, (int*)counts, (int*)overflow, nbx, nby, nbz, C);
  return (int)cudaGetLastError();
}
