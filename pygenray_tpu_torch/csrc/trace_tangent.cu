// Final-state ray trace with one forward tangent: the whole fixed-step
// integration of a batch of rays in one launch, one CUDA thread per ray,
// advancing the ray state (T, z, p) and its tangent with respect to the
// launch parameter p0 together.
//
// Replaces: the Pallas TPU forward-tangent kernel `_make_step_math` +
// `_make_final_kernel` without a save plan
// (pygenray_tpu/ops/pallas_stepper.py:730-1031) as launched by
// `trace_pallas_tangent` (:1161): the Newton engine of the eigenray search,
// which needs (z_end, dz_end/dp0) for every candidate angle each iteration.
// It covers what that kernel covers:
//   * profile c(z), dc/dz(z) from Chebyshev fits, evaluated by Horner on
//     the monomial re-expression (use_pow) or by Clenshaw;
//   * range-independent (one coefficient row) or range-dependent (per-step
//     rows blended linearly in range, read at mid-step and step end);
//   * constant or Chebyshev bottom angle;
//   * float32, no Kahan compensation (the forward-AD convention);
//   * death codes 3 > 1 > 2 (no calm/dyn/hot bodies, so never 5).
// The JAX kernel gets its tangent by applying jax.jvp to the step inside the
// kernel trace; here the step is written once (tangent_step.cuh, shared with
// trace_tangent_save.cu) over the `Dual` type of dual.cuh, in the expression
// order of its plain version
// (pygenray_tpu_torch/integrate.py:_trace_tangent_impl, the forward trace's
// step run on pygenray_tpu_torch/ops/dual.py's Duals), so the primal is the
// forward kernel's (csrc/trace_fan.cu with Kahan off) and the tangent is
// differentiated by the same rules as JAX's: through both Newton iterations
// of the crossing fraction, through clip only inside its range, through the
// branch a selection takes.
//
// Design.  Each thread keeps the primal and tangent state (T, z, p, kT, kz,
// kp and their tangents) in registers for all nsteps steps and runs the
// crossing fix only when its own ray crosses a boundary; a dead ray is
// frozen.  Range-independent coefficient rows (K <= 256) and the
// bottom-angle series (Kb <= 128) sit in shared memory; range-dependent rows
// come from global memory, and every thread of a block reads the same row at
// step k, so those reads are broadcasts served from L1.  The per-step
// bathymetry b0s/b1s, the domain-exit flags xoob (host float64) and the
// blended rows come from the wrapper, computed by the plain version's own
// code.  Blocks of 64 threads: eigenray batches are small (4 to ~150
// candidates at the repo's eigenray configurations), and small blocks
// spread them over more of the card's 132 SMs.
//
// What bounds it on an H100: FP32 issue, as for the forward kernel, about
// three times its operations per ray-step (each Dual product is three
// multiplies and an add).  The outputs are 9 x 4 B per ray; the inputs a few
// kB plus, range-dependent, 4 x nsteps x K floats read once per block.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include "tangent_step.cuh"

#define TT_BLOCK 64

namespace {

using namespace tangent_step;

template <bool POW, bool RD>
__global__ void __launch_bounds__(TT_BLOCK)
trace_tangent_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ dp0v,
                     const float* __restrict__ z0v, const float* __restrict__ ccoef,
                     const float* __restrict__ cpcoef, const float* __restrict__ bacoef,
                     const float* __restrict__ b0s, const float* __restrict__ b1s,
                     const unsigned char* __restrict__ xoob, const float* __restrict__ cms,
                     const float* __restrict__ cpms, const float* __restrict__ c1s,
                     const float* __restrict__ cp1s, float* __restrict__ T_out,
                     float* __restrict__ z_out, float* __restrict__ p_out,
                     float* __restrict__ dT_out, float* __restrict__ dz_out,
                     float* __restrict__ dp_out, int* __restrict__ n_surf_out,
                     int* __restrict__ n_bott_out, int* __restrict__ death_out) {
  // the initial right-hand side's rows (every step's, range-independent)
  __shared__ float s_c[TS_MAX_K];
  __shared__ float s_cp[TS_MAX_K];
  __shared__ float s_ba[TS_MAX_KB];
  load_series(P, ccoef, cpcoef, bacoef, s_c, s_cp, s_ba);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.B) return;
  const StepInputs in = {b0s, b1s, xoob, cms, cpms, c1s, cp1s};

  // the launch tangent seeds p only; a dead ray is frozen
  RayState s = initial_state<POW>(s_c, s_cp, P, z0v[i], 0.0f, p0v[i], dp0v[i]);
  for (int k = 0; k < P.nsteps && s.alive; ++k) step<POW, RD>(P, in, s_c, s_cp, s_ba, k, s);

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

template <bool POW, bool RD>
void launch(const Params& P, cudaStream_t s, const float* p0, const float* dp0, const float* z0,
            const float* ccoef, const float* cpcoef, const float* bacoef, const float* b0s,
            const float* b1s, const unsigned char* xoob, const float* cms, const float* cpms,
            const float* c1s, const float* cp1s, float* T, float* z, float* p, float* dT,
            float* dz, float* dp, int* n_surf, int* n_bott, int* death) {
  const dim3 grid((P.B + TT_BLOCK - 1) / TT_BLOCK);
  trace_tangent_kernel<POW, RD><<<grid, TT_BLOCK, 0, s>>>(
      P, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, T, z, p, dT,
      dz, dp, n_surf, n_bott, death);
}

}  // namespace

extern "C" int trace_tangent_f32(const float* p0, const float* dp0, const float* z0,
                                 const float* ccoef, const float* cpcoef, const float* bacoef,
                                 const float* b0s, const float* b1s, const unsigned char* xoob,
                                 const float* cms, const float* cpms, const float* c1s,
                                 const float* cp1s, float* T, float* z, float* p, float* dT,
                                 float* dz, float* dp, int* n_surf, int* n_bott, int* death,
                                 int B, int K, int Kb, int nsteps, int use_pow, int bangle_cheb,
                                 int term_back, int any_x_oob, int rd, float x0, float h,
                                 float zlo_m, float zhi_p, float sc, float off, float sin_lim,
                                 float s2b, float c2b, float b_sum, float b_span, void* stream) {
  if (B <= 0 || K < 1 || K > TS_MAX_K || Kb < 1 || Kb > TS_MAX_KB || nsteps < 1)
    return (int)cudaErrorInvalidValue;
  if (rd && !(cms && cpms && c1s && cp1s)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(B, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
  cudaStream_t s = (cudaStream_t)stream;
#define TT_ARGS \
  P, s, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, T, z, p, dT, \
      dz, dp, n_surf, n_bott, death
  if (use_pow) {
    if (rd) launch<true, true>(TT_ARGS);
    else launch<true, false>(TT_ARGS);
  } else {
    if (rd) launch<false, true>(TT_ARGS);
    else launch<false, false>(TT_ARGS);
  }
#undef TT_ARGS
  return (int)cudaGetLastError();
}
