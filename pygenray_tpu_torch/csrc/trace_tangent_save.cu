// Save-grid ray trace with one forward tangent: the whole fixed-step
// integration of a batch of rays in one launch, one CUDA thread per ray,
// advancing the ray state (T, z, p) and its tangent with respect to a seed
// (dp0, dz0) in the launch parameter and the source depth together, and
// writing both at the launch point and after every segment of `sps` steps.
//
// Replaces: the Pallas TPU save-grid forward-tangent kernel `kernel_save` of
// `_make_final_kernel` with a save plan
// (pygenray_tpu/ops/pallas_stepper.py:826-1087) as launched by
// `trace_pallas_tangent_save` (:1194): the engine of differentiation through
// trace() over the launch parameters and of the receiver side, where the
// spreading Jacobian dz/dtheta0 along the whole path gives arrival
// amplitudes, caustic counts and transmission-loss fields from one launch.
// It covers what that kernel covers: what trace_tangent.cu covers (spectral
// profile by Horner or Clenshaw, range-independent or range-dependent,
// constant or Chebyshev bottom angle, float32, no Kahan compensation, death
// codes 3 > 1 > 2), plus the source-depth seed and the save grid.
//
// The body is tangent_trace.cuh's, shared with trace_tangent.cu (B2), so
// this kernel's last row is that kernel's output bit for bit, and its primal
// is the forward kernel's save grid (csrc/trace_fan.cu with Kahan off).  Its
// plain version is pygenray_tpu_torch/integrate.py:_trace_tangent_save_impl.
//
// Design: tangent_trace.cuh's (one thread a ray, c and dc/dz in one loop, K
// fixed on the fit ladder, a range-independent field's coefficients in
// registers up to K = 32, a range-dependent field's step rows staged in
// shared memory by `cp.async`), with the state written at the launch point
// and after every segment.  The save grids are (nseg+1, B), so that a warp
// writes 32 consecutive floats of one row.  A lane pair a ray (c on one
// lane, dc/dz on the other, as the ensemble kernel) measured 36-50 % slower
// at the receiver side's three shapes (PERF.md).
//
// What bounds it on an H100.  At the receiver side's small batches one
// ray's chain of dependent Dual steps sets the time (the TL demo fills 32
// blocks, the array response one); at a full-width fan (102,400 rays) FP32
// issue does.  The six save grids are 24 (nseg+1) B a ray, far below what
// the memory moves in the kernel's time.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py).

#include <cuda_runtime.h>

#include "stage_rows.cuh"
#include "tangent_step.cuh"
#include "tangent_trace.cuh"

namespace {

using namespace tangent_step;

template <bool POW, bool RD, int KC>
__global__ void __launch_bounds__(TT_BLOCK)
trace_tangent_save_kernel(Params P, int v16, const float* __restrict__ p0v,
                          const float* __restrict__ dp0v, const float* __restrict__ z0v,
                          const float* __restrict__ dz0v, const float* __restrict__ ccoef,
                          const float* __restrict__ cpcoef, const float* __restrict__ bacoef,
                          StepInputs in, TraceOut out) {
  trace_rays<POW, RD, KC, true>(P, v16, p0v, dp0v, z0v, dz0v, ccoef, cpcoef, bacoef, in, out);
}

template <bool POW, bool RD>
struct Launch {
  template <int KC>
  static int run(const Params& P, int v16, cudaStream_t s, const float* p0, const float* dp0,
                 const float* z0, const float* dz0, const float* ccoef, const float* cpcoef,
                 const float* bacoef, StepInputs in, TraceOut out) {
    const dim3 grid((P.B + TT_BLOCK - 1) / TT_BLOCK);
    trace_tangent_save_kernel<POW, RD, KC><<<grid, TT_BLOCK, 0, s>>>(
        P, v16, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Grids T, z, p, dT, dz, dp are (nseg+1, B) row-major; the rest (B,).
extern "C" int trace_tangent_save_f32(
    const float* p0, const float* dp0, const float* z0, const float* dz0, const float* ccoef,
    const float* cpcoef, const float* bacoef, const float* b0s, const float* b1s,
    const unsigned char* xoob, const float* cms, const float* cpms, const float* c1s,
    const float* cp1s, float* T, float* z, float* p, float* dT, float* dz, float* dp,
    int* n_surf, int* n_bott, int* death, int* dseg, int B, int K, int Kb, int nseg, int sps,
    int use_pow, int bangle_cheb, int term_back, int any_x_oob, int rd, float x0, float h,
    float zlo_m, float zhi_p, float sc, float off, float sin_lim, float s2b, float c2b,
    float b_sum, float b_span, void* stream) {
  if (B <= 0 || K < 1 || K > TS_MAX_K || Kb < 1 || Kb > TS_MAX_KB || nseg < 1 || sps < 1)
    return (int)cudaErrorInvalidValue;
  if (rd && !(cms && cpms && c1s && cp1s)) return (int)cudaErrorInvalidValue;
  const Params P = make_params(B, K, Kb, nseg * sps, sps, nseg, bangle_cheb, term_back,
                               any_x_oob, x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum,
                               b_span);
  const StepInputs in = {b0s, b1s, xoob, cms, cpms, c1s, cp1s};
  const TraceOut out = {T, z, p, dT, dz, dp, n_surf, n_bott, death, dseg};
  const int v16 = rd ? copy16_ok(K, cms, cpms, c1s, cp1s) : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TSV_ARGS K, P, v16, s, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out
  if (use_pow)
    return rd ? with_fixed_k<Launch<true, true>>(TSV_ARGS)
              : with_fixed_k<Launch<true, false>>(TSV_ARGS);
  return rd ? with_fixed_k<Launch<false, true>>(TSV_ARGS)
            : with_fixed_k<Launch<false, false>>(TSV_ARGS);
#undef TSV_ARGS
}
