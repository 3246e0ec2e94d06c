// The two pinned micro-probes for Hopper (sm_90a): an FP32 FMA chain and
// an HBM copy sweep.
//
// Replaces: scripts/exp_micro.py, make_fma (a trace-time-unrolled 24-deep
// FMA chain over (256, 128) f32 blocks, grid (G,)) and make_copy (y = x + 1
// over CB (256, 128) f32 blocks, swept `reps` times as the major grid
// dimension). They exist to pin the card's FP32 FMA rate and its memory
// copy rate, so that a drift in the card or its clock can be told from a
// drift in the code the compiler makes for the big kernels.
//
// fma_chain: what bounds it is FP32 throughput, 33.5 TFMA/s on an H100 SXM
// (67 TFLOP/s). One thread per element carries its own dependent chain of
// reps * 24 fmaf(y, 1.000001f, 1e-7f), the 24 unrolled; a dependent FMA
// waits ~4 cycles for the one before, so the latency is hidden by the warps
// in flight (2M threads, 8192 blocks of 256: every SM full), not inside
// the thread. The result rounds once per link; the plain PyTorch version
// (y * a + b) rounds twice, so the two differ by a few ulps.
//
// copy_add: what bounds it is memory, 3.35 TB/s: each sweep reads and
// writes the whole array once (2 x 64 MB at the TPU's shape). The sweep is
// the grid's y dimension, as the TPU kernel's grid has it, so every sweep
// is a block of its own that the compiler cannot merge with another; blocks
// are dispatched x-fastest, so a sweep finds the start of the array evicted
// from the 50 MB L2 by the sweep before. Each thread moves one float4.
// Every sweep writes the same values, so blocks of two sweeps that overlap
// in time write the same bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 24;  // links per rep, exp_micro.py DEPTH
constexpr int kThreads = 256;

__global__ void fma_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, long long n,
                                 int reps) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) v = fmaf(v, 1.000001f, 1e-7f);
  }
  y[i] = v;
}

__global__ void copy_add_kernel(const float4* __restrict__ x,
                                float4* __restrict__ y, long long n4) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = x[i];
  a.x += 1.0f;
  a.y += 1.0f;
  a.z += 1.0f;
  a.w += 1.0f;
  y[i] = a;
}

}  // namespace

// x, y: (n,) float32. Returns cudaGetLastError().
extern "C" int fma_chain_launch(const void* x, void* y, long long n, int reps,
                                void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  fma_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, reps);
  return (int)cudaGetLastError();
}

// x, y: (n,) float32 with n % 4 == 0 and 16-byte aligned (the wrapper
// checks); one launch of `reps` sweeps (1 <= reps <= 65535). Returns
// cudaGetLastError().
extern "C" int copy_add_launch(const void* x, void* y, long long n, int reps,
                               void* stream) {
  const long long n4 = n / 4;
  const dim3 grid((unsigned)((n4 + kThreads - 1) / kThreads), (unsigned)reps);
  copy_add_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)y, n4);
  return (int)cudaGetLastError();
}
