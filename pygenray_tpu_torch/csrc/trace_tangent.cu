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
// the other tangent kernels) over the `Dual` type of dual.cuh, in the
// expression order of its plain version
// (pygenray_tpu_torch/integrate.py:_trace_tangent_impl, the forward trace's
// step run on pygenray_tpu_torch/ops/dual.py's Duals), so the primal is the
// forward kernel's (csrc/trace_fan.cu with Kahan off) and the tangent is
// differentiated by the same rules as JAX's: through both Newton iterations
// of the crossing fraction, through clip only inside its range, through the
// branch a selection takes.
//
// Design: tangent_trace.cuh's, shared with the save-grid kernel
// (trace_tangent_save.cu), of which this kernel is the case of one segment
// of all the steps, no source-depth seed and no save grid: one thread a ray,
// c and dc/dz in one loop, K fixed on the fit ladder, a range-independent
// field's coefficients in registers up to K = 32, a range-dependent field's
// step rows staged into shared memory by `cp.async`, one barrier a step.
// The per-step bathymetry b0s/b1s, the domain-exit flags xoob (host
// float64) and the blended rows come from the wrapper, computed by the plain
// version's own code.  Blocks of 64 threads: eigenray batches are small (4
// to ~150 candidates at the repo's eigenray configurations), and small
// blocks spread them over more of the card's 132 SMs.
//
// What bounds it on an H100.  At the eigenray solver's batches (config 3:
// 156 candidates, 3 blocks) one ray's chain of dependent Dual steps sets the
// time, not FP32 issue (about 2.5 times the forward kernel's operations a
// ray-step: each Dual product is three multiplies and an add).  The outputs
// are 9 x 4 B per ray; the inputs a few kB plus, range-dependent, 4 x
// nsteps x K floats read once per block.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include "stage_rows.cuh"
#include "tangent_step.cuh"
#include "tangent_trace.cuh"

namespace {

using namespace tangent_step;

// the launch tangent seeds p only
template <bool POW, bool RD, int KC>
__global__ void __launch_bounds__(TT_BLOCK)
trace_tangent_kernel(Params P, int v16, const float* __restrict__ p0v,
                     const float* __restrict__ dp0v, const float* __restrict__ z0v,
                     const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                     const float* __restrict__ bacoef, StepInputs in, TraceOut out) {
  trace_rays<POW, RD, KC, false>(P, v16, p0v, dp0v, z0v, nullptr, ccoef, cpcoef, bacoef, in,
                                 out);
}

template <bool POW, bool RD>
struct Launch {
  template <int KC>
  static int run(const Params& P, int v16, cudaStream_t s, const float* p0, const float* dp0,
                 const float* z0, const float* ccoef, const float* cpcoef, const float* bacoef,
                 StepInputs in, TraceOut out) {
    const dim3 grid((P.B + TT_BLOCK - 1) / TT_BLOCK);
    trace_tangent_kernel<POW, RD, KC><<<grid, TT_BLOCK, 0, s>>>(P, v16, p0, dp0, z0, ccoef,
                                                                cpcoef, bacoef, in, out);
    return (int)cudaGetLastError();
  }
};

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
  // one segment of all the steps
  const Params P = make_params(B, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
  const StepInputs in = {b0s, b1s, xoob, cms, cpms, c1s, cp1s};
  const TraceOut out = {T, z, p, dT, dz, dp, n_surf, n_bott, death, nullptr};
  const int v16 = rd ? copy16_ok(K, cms, cpms, c1s, cp1s) : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TT_ARGS K, P, v16, s, p0, dp0, z0, ccoef, cpcoef, bacoef, in, out
  if (use_pow)
    return rd ? with_fixed_k<Launch<true, true>>(TT_ARGS)
              : with_fixed_k<Launch<true, false>>(TT_ARGS);
  return rd ? with_fixed_k<Launch<false, true>>(TT_ARGS)
            : with_fixed_k<Launch<false, false>>(TT_ARGS);
#undef TT_ARGS
}
