// Fused LJ velocity-Verlet step for Hopper (sm_90a): the LJ force, both
// kicks and the drift of one plain step in one kernel.
//
// Replaces: minimd_tpu/ops/lj_step_pallas.py:90, make_lj_step_pallas
// (pallas_call :298; one Pallas program per (z, y) cell row: the LJ force
// over a lane-packed candidate block, both kicks, the drift, and the next
// step's candidate re-pack). Per own slot, with f = F(x_k) the force of
// lj_force.cu:
//
//   v_k     = w_k + dtf*f      the step-k velocity (thermo reads it)
//   w_{k+1} = v_k + dtf*f      the next step's first kick
//   x_{k+1} = x_k + dt*w_{k+1}
//
// and with EV one partial per cell of the energy (x 4 eps), the virial
// (x 0.5) and sum v_k . v_k (the wrapper sums the partials, vsq in float64).
// The kernel reads the raw cell-major grid, so the TPU's re-pack of the
// next step's candidates has no counterpart here.
//
// What bounds it on the H100: instruction issue in the LJ candidate loop
// (lj_pair.cuh has the count); the epilogue adds 36 bytes per slot (w
// read, w and x written), ~6 MB at 131k atoms, a few microseconds of
// memory time. What it saves is the plain step's three kick/drift
// launches and their host overhead.
//
// What the design does about it: the LJ kernel's shape (one warp per
// cell, the lanes taking its slots 32 at a time, the pair loop of
// lj_pair.cuh: only valid candidates near the own-atom box, compacted in
// walk order, slot groups with no atom skipped) with the kicks and drift
// in the epilogue of the lane that owns the slot.
//
// Positions ping-pong. Neighbor blocks read x_k through the non-coherent
// path (__ldg, cellgrid.cuh) while this block writes x_{k+1}: writing x in
// place would race, and a non-coherent read of a buffer being written is
// undefined. So x_{k+1} goes to a second buffer (the caller alternates
// two). w is updated in place: each thread reads and writes only its own
// slot. x_{k+1} is written for all C slots of the cell, empty ones too:
// their f and w are 0, so the sentinel is copied unchanged, and the other
// buffer holds no stale slot.
//
// The kicks and the drift are written with __fmul_rn/__fadd_rn: nvcc would
// contract w + dtf*f into an FMA, where the plain version (ops/lj_step.py,
// one torch op each) rounds the product and the sum separately. Given the
// same f they round as it does; f itself differs from the plain version's
// by f32 summation order, so x and w agree to f32 rounding, not bitwise.
//
// Not done yet (later work): CUDA-graph capture of an interval of fused
// steps, the approximate reciprocal, staging with cp.async or TMA.

#include <cuda_runtime.h>

#include "lj_pair.cuh"

namespace {

template <bool EV, bool PARTS>
__global__ void lj_step_kernel(const __grid_constant__ CellGrid g,
                               float* __restrict__ w,
                               float* __restrict__ x_next,
                               float* __restrict__ eng_part,
                               float* __restrict__ vir_part,
                               float* __restrict__ vsq_part,
                               const __grid_constant__ LJCoeffs k,
                               float eng_scale, float dt, float dtf,
                               float valid_below) {
  extern __shared__ float4 stage[];  // lj_stage_bytes(C): kept candidates
  const long long M = g.M;
  const int cell = blockIdx.x;
  const CellWalk cw = cell_walk(g, cell, valid_below);

  // slot groups as in lj_force.cu; es, ws, vs in warp_sum's order
  float es = 0.f, ws = 0.f, vs = 0.f;
  for (int grp = 0; grp * 32 < g.C; ++grp) {
    const int i = grp * 32 + threadIdx.x;
    const bool own = i < g.C;
    const long long si = (long long)cell * g.C + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (own) {
      xi = g.x[si];
      yi = g.x[M + si];
      zi = g.x[2 * M + si];
    }
    const bool valid = own && xi < valid_below;
    float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f, vir = 0.f;
    if (__any_sync(0xffffffffu, valid)) {
      lj_pair_sums<EV, PARTS>(g, cw, i, valid, xi, yi, zi, k, valid_below,
                              stage, fx, fy, fz, e, vir);
    }
    float vsq = 0.f;
    if (own) {
      const float pos[3] = {xi, yi, zi};
      const float frc[3] = {fx, fy, fz};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const long long s = d * M + si;
        const float v = __fadd_rn(w[s], __fmul_rn(dtf, frc[d]));
        const float wn = __fadd_rn(v, __fmul_rn(dtf, frc[d]));
        w[s] = wn;
        x_next[s] = __fadd_rn(pos[d], __fmul_rn(dt, wn));
        if (EV) vsq += v * v;
      }
    }
    if (EV) {
      es += warp_sum(e);
      ws += warp_sum(vir);
      vs += warp_sum(vsq);
    }
  }
  if (EV && threadIdx.x == 0) {
    eng_part[cell] = es * eng_scale;
    vir_part[cell] = ws * 0.5f;
    vsq_part[cell] = vs;
  }
}

// PARTS: C > 512 (lj_pair_sums').
template <bool EV, bool PARTS>
cudaError_t launch(int ncells, size_t smem, cudaStream_t s, const CellGrid& g,
                   float* w, float* x_next, float* eng, float* vir,
                   float* vsq, const LJCoeffs& k, float eng_scale, float dt,
                   float dtf, float valid_below) {
  const cudaError_t err = allow_stage(lj_step_kernel<EV, PARTS>, smem);
  if (err != cudaSuccess) return err;
  lj_step_kernel<EV, PARTS><<<ncells, 32, smem, s>>>(  // one warp per cell
      g, w, x_next, eng, vir, vsq, k, eng_scale, dt, dtf, valid_below);
  return cudaGetLastError();
}

}  // namespace

// x: (3, M) float32 positions x_k (read only); w: (3, M) float32 half-kick
// velocities w_k, overwritten with w_{k+1}; x_next: (3, M) float32 out, a
// buffer other than x; eng/vir/vsq: (ncells,) float32 partials (ignored
// unless evflag); a slot holds an atom iff its x < valid_below. Returns
// the CUDA error of the shared-memory opt-in or cudaGetLastError().
extern "C" int lj_step_launch(const void* x, void* w, void* x_next, void* eng,
                              void* vir, void* vsq, int nbx, int nby, int nbz,
                              int C, float prdx, float prdy, float prdz,
                              float cutsq, double eps, float sig6, float dt,
                              float dtf, float valid_below, int evflag,
                              void* stream) {
  const int ncells = nbx * nby * nbz;
  const CellGrid g{(const float*)x, (long long)ncells * C, nbx, nby, nbz, C,
                   prdx, prdy, prdz};
  const size_t smem = lj_stage_bytes(C);
  const LJCoeffs k{cutsq, (float)(48.0 * eps), (float)(24.0 * eps), sig6};
  const float eng_scale = (float)(4.0 * eps);
  const bool parts = C > kStageC;
  const auto go = evflag ? (parts ? launch<true, true> : launch<true, false>)
                         : (parts ? launch<false, true> : launch<false, false>);
  return (int)go(ncells, smem, (cudaStream_t)stream, g, (float*)w,
                 (float*)x_next, evflag ? (float*)eng : nullptr,
                 evflag ? (float*)vir : nullptr,
                 evflag ? (float*)vsq : nullptr, k, eng_scale, dt, dtf,
                 valid_below);
}
