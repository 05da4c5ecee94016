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
// The step is tangent_step.cuh's, shared with trace_tangent.cu, so this
// kernel's last row is that kernel's output bit for bit, and its primal is
// the forward kernel's save grid (csrc/trace_fan.cu with Kahan off).  Its
// plain version is pygenray_tpu_torch/integrate.py:_trace_tangent_save_impl.
//
// Design.  One thread per ray, state and tangent in registers, as
// trace_tangent.cu.  A dead ray is frozen: it takes no more steps, but every
// remaining save row still receives its frozen state and tangent, as in the
// plain version, so no output is left unwritten.  `dseg` is the first save
// row at which the ray is dead (nseg + 1 for a survivor): alive_save[k] is
// k < dseg.  The save grids are (nseg+1, B), so that a warp writes 32
// consecutive floats of one row.  Blocks of 64 threads, as trace_tangent.cu:
// eigenray-sized batches spread over more of the card's 132 SMs, and a
// full-width fan has 1,600 blocks either way.
//
// What bounds it on an H100: FP32 issue, as the final-state kernel (each Dual
// product is three multiplies and an add); the six save grids are
// 24 (nseg+1) B a ray, far below what the memory moves in the kernel's time.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py).

#include <cuda_runtime.h>

#include "tangent_step.cuh"

#define TSV_BLOCK 64

namespace {

using namespace tangent_step;

struct SaveGrids {
  float* __restrict__ T;
  float* __restrict__ z;
  float* __restrict__ p;
  float* __restrict__ dT;
  float* __restrict__ dz;
  float* __restrict__ dp;
};

__device__ __forceinline__ void save_row(const SaveGrids& g, size_t at, const RayState& s) {
  g.T[at] = s.T.v;
  g.z[at] = s.z.v;
  g.p[at] = s.p.v;
  g.dT[at] = s.T.t;
  g.dz[at] = s.z.t;
  g.dp[at] = s.p.t;
}

template <bool POW, bool RD>
__global__ void __launch_bounds__(TSV_BLOCK)
trace_tangent_save_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ dp0v,
                          const float* __restrict__ z0v, const float* __restrict__ dz0v,
                          const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                          const float* __restrict__ bacoef, StepInputs in, SaveGrids out,
                          int* __restrict__ n_surf_out, int* __restrict__ n_bott_out,
                          int* __restrict__ death_out, int* __restrict__ dseg_out) {
  // the initial right-hand side's rows (every step's, range-independent)
  __shared__ float s_c[TS_MAX_K];
  __shared__ float s_cp[TS_MAX_K];
  __shared__ float s_ba[TS_MAX_KB];
  load_series(P, ccoef, cpcoef, bacoef, s_c, s_cp, s_ba);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.B) return;

  RayState s = initial_state<POW>(s_c, s_cp, P, z0v[i], dz0v[i], p0v[i], dp0v[i]);
  int dseg = s.alive ? P.nseg + 1 : 0;
  save_row(out, (size_t)i, s);
  for (int seg = 0; seg < P.nseg; ++seg) {
    const int k_end = (seg + 1) * P.sps;
    for (int k = seg * P.sps; k < k_end && s.alive; ++k)
      step<POW, RD>(P, in, s_c, s_cp, s_ba, k, s);
    if (!s.alive) dseg = min(dseg, seg + 1);
    save_row(out, (size_t)(seg + 1) * P.B + i, s);
  }
  n_surf_out[i] = s.n_surf;
  n_bott_out[i] = s.n_bott;
  death_out[i] = s.death;
  dseg_out[i] = dseg;
}

template <bool POW, bool RD>
void launch(const Params& P, cudaStream_t s, const float* p0, const float* dp0, const float* z0,
            const float* dz0, const float* ccoef, const float* cpcoef, const float* bacoef,
            const StepInputs& in, const SaveGrids& out, int* n_surf, int* n_bott, int* death,
            int* dseg) {
  const dim3 grid((P.B + TSV_BLOCK - 1) / TSV_BLOCK);
  trace_tangent_save_kernel<POW, RD><<<grid, TSV_BLOCK, 0, s>>>(
      P, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out, n_surf, n_bott, death, dseg);
}

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
  const SaveGrids out = {T, z, p, dT, dz, dp};
  cudaStream_t s = (cudaStream_t)stream;
#define TSV_ARGS P, s, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out, n_surf, n_bott, death, dseg
  if (use_pow) {
    if (rd) launch<true, true>(TSV_ARGS);
    else launch<true, false>(TSV_ARGS);
  } else {
    if (rd) launch<false, true>(TSV_ARGS);
    else launch<false, false>(TSV_ARGS);
  }
#undef TSV_ARGS
  return (int)cudaGetLastError();
}
