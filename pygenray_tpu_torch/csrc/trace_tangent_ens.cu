// Final-state ray trace with one forward tangent across an ensemble of
// environments: one launch advances every (realization, candidate) ray of a
// Monte-Carlo eigenray search, one CUDA thread per ray.
//
// Replaces: the Pallas TPU ensemble tangent kernel
// `trace_pallas_tangent_ensemble` (pygenray_tpu/ops/pallas_stepper.py:1258,
// `_make_final_kernel(ens=True)` :826): the forward-tangent kernel of
// trace_tangent.cu (B2) with a realization axis.  Grid block (x, e) traces
// realization e's candidates x * 64 ... x * 64 + 63 of its (M,) launch
// parameters p0[e] and seeds dp0[e] against realization e's own per-step
// coefficient rows (range-dependent spectral fits, rows blended linearly in
// range at mid-step and step end, e's block of the (E, nsteps, K) tables)
// and its own launch-range rows (E, K).  The bathymetry, the bottom-angle
// series and the launch constants are realization 0's, as in the JAX kernel
// (:1294-1333): Monte-Carlo ensembles perturb the sound speed only.  The
// source depth is one scalar.  float32, no Kahan (the forward-AD
// convention), death codes 3 > 1 > 2.
//
// The step is tangent_step.cuh's, the one B2 and B3 call, so realization
// e's row is B2 run on realization e alone, bit for bit; the plain version
// (pygenray_tpu_torch/integrate.py:_trace_tangent_ens_impl) is B2's plain
// loop run once over the (E, M) rays, each realization on its own rows.
//
// Design: B2's, with blockIdx.y choosing the realization: each thread keeps
// the primal and tangent state in registers for all steps; a dead ray is
// frozen; the realization's launch-range rows and the bottom-angle series go
// to shared memory; its per-step rows come from global memory, every thread
// of a block reading the same row at step k (broadcasts served from L1).
// Blocks of 64 threads, as B2: a Newton batch is a few candidates per
// realization (at most MC_BRACKET_CAP = 24), so small blocks spread the E
// realizations' blocks over more SMs.
//
// What bounds it on an H100: FP32 throughput, as B2 (about 2.5 times the forward
// step's operations per ray-step).  At BASELINE config 4's Newton batches
// (16 realizations x <= 24 candidates x 500 steps) it is latency-bound: one
// thread's 500 dependent Dual steps set the time, the card's 132 SMs hold
// one or two blocks each.  Its rows are 16 x 500 x 64 x 4 x 4 B = 8 MB,
// read once per launch (L2-resident after the first).
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include "tangent_step.cuh"

#define TE_BLOCK 64

namespace {

using namespace tangent_step;

template <bool POW>
__global__ void __launch_bounds__(TE_BLOCK)
trace_tangent_ens_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ dp0v,
                         float z0, const float* __restrict__ ccoef,
                         const float* __restrict__ cpcoef, const float* __restrict__ bacoef,
                         const float* __restrict__ b0s, const float* __restrict__ b1s,
                         const unsigned char* __restrict__ xoob, const float* __restrict__ cms,
                         const float* __restrict__ cpms, const float* __restrict__ c1s,
                         const float* __restrict__ cp1s, float* __restrict__ T_out,
                         float* __restrict__ z_out, float* __restrict__ p_out,
                         float* __restrict__ dT_out, float* __restrict__ dz_out,
                         float* __restrict__ dp_out, int* __restrict__ n_surf_out,
                         int* __restrict__ n_bott_out, int* __restrict__ death_out) {
  const int e = blockIdx.y;
  // realization e's launch-range rows, and the bottom-angle series
  __shared__ float s_c[TS_MAX_K];
  __shared__ float s_cp[TS_MAX_K];
  __shared__ float s_ba[TS_MAX_KB];
  load_series(P, ccoef + (size_t)e * P.K, cpcoef + (size_t)e * P.K, bacoef, s_c, s_cp, s_ba);

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P.B) return;
  const size_t rows = (size_t)e * P.nsteps * P.K;  // realization e's per-step rows
  const StepInputs in = {b0s, b1s, xoob, cms + rows, cpms + rows, c1s + rows, cp1s + rows};
  const size_t i = (size_t)e * P.B + j;

  // the launch tangent seeds p only; a dead ray is frozen
  RayState s = initial_state<POW>(s_c, s_cp, P, z0, 0.0f, p0v[i], dp0v[i]);
  for (int k = 0; k < P.nsteps && s.alive; ++k) step<POW, true>(P, in, s_c, s_cp, s_ba, k, s);

  T_out[i] = s.T.v;
  z_out[i] = s.z.v;
  p_out[i] = s.p.v;
  dT_out[i] = s.T.t;
  dz_out[i] = s.z.t;
  dp_out[i] = s.p.t;
  n_surf_out[i] = s.n_surf;
  n_bott_out[i] = s.n_bott;
  death_out[i] = s.death;
}

}  // namespace

extern "C" int trace_tangent_ens_f32(const float* p0, const float* dp0, float z0,
                                     const float* ccoef, const float* cpcoef,
                                     const float* bacoef, const float* b0s, const float* b1s,
                                     const unsigned char* xoob, const float* cms,
                                     const float* cpms, const float* c1s, const float* cp1s,
                                     float* T, float* z, float* p, float* dT, float* dz, float* dp,
                                     int* n_surf, int* n_bott, int* death, int E, int M, int K,
                                     int Kb, int nsteps, int use_pow, int bangle_cheb,
                                     int term_back, int any_x_oob, int rd, float x0, float h,
                                     float zlo_m, float zhi_p, float sc, float off, float sin_lim,
                                     float s2b, float c2b, float b_sum, float b_span,
                                     void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || K < 1 || K > TS_MAX_K || Kb < 1 || Kb > TS_MAX_KB ||
      nsteps < 1 || !rd || !(cms && cpms && c1s && cp1s))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(M, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
  const dim3 grid((M + TE_BLOCK - 1) / TE_BLOCK, E);
  cudaStream_t s = (cudaStream_t)stream;
  if (use_pow)
    trace_tangent_ens_kernel<true><<<grid, TE_BLOCK, 0, s>>>(
        P, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, T, z, p, dT,
        dz, dp, n_surf, n_bott, death);
  else
    trace_tangent_ens_kernel<false><<<grid, TE_BLOCK, 0, s>>>(
        P, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, T, z, p, dT,
        dz, dp, n_surf, n_bott, death);
  return (int)cudaGetLastError();
}
