// Final-state ray trace with one forward tangent per direction of the
// Chebyshev sound-speed coefficients: the whole travel-time Jacobian of a
// spectral fit in one launch, one CUDA thread per (direction, ray), or per
// (station, direction, ray) for a range-dependent fit.
//
// Replaces the Pallas TPU coefficient-tangent kernels:
//   * B5, `_make_coef_kernel` (pygenray_tpu/ops/pallas_stepper.py:1366-1516)
//     as launched by `trace_pallas_coef_tangent` (:1518), range-independent:
//     direction d perturbs the profile's coefficients as c + a * dcoef[d]
//     and dc/dz + a * dcpcoef[d] together, and thread (d, b) advances ray
//     b's primal state and its derivative at a = 0 (tangents (D, B));
//   * B6, `_make_coef_kernel_rd` (:1619-1816) as launched by
//     `trace_pallas_coef_tangent_rd` (:1820), range-dependent: thread
//     (j, g, b) perturbs station j's coefficients along direction g.  Each
//     step's profile is the stations' rows blended linearly in range,
//     (1 - w) row[i] + w row[i + 1], so the blended row's tangent is
//     hat_j * dcoef[g] with the hat weight hat_j = (1 - w) if i == j, w if
//     i + 1 == j, else 0, from the step's station interval (i, w) (`hat`
//     :1671), computed here from the rows (i, w) at the launch range, at
//     each step's middle and at its end (pygenray_tpu_torch/integrate.py:
//     _station_iw_rows, the numbers the primal rows were blended with); the
//     launch derivative uses the hat at the launch range (:1709)
//     (tangents (nr, Dk, B)).
// The JAX kernels enter the direction through jax.jvp of an epsilon input;
// here the coefficients are `Dual`s {c[k], hat * dc[k]} (dual.cuh's
// dclenshaw; the range-independent kernel is hat = 1, and 1.0f * dc[k] is
// dc[k]) and the launch tangents are 0.  As there, the series are evaluated
// by Clenshaw only (a unit direction re-expressed in monomials has
// 2^k-scale entries, which a float32 Horner tangent cannot carry;
// :1552-1558): the wrapper (pygenray_tpu_torch/ops/stepper.py) hands this
// kernel the Chebyshev rows whatever the environment's poly_ok says.
// Constant or Chebyshev bottom angle, float32, no Kahan (the forward-AD
// convention), death codes 3 > 1 > 2.
//
// The step is tangent_step.cuh's, the one B2-B4 call, over `CoefRows`.  The
// Dual values do not depend on the tangents, so the primal is the
// final-state tangent kernel's (trace_tangent.cu, range-independent or RD)
// on the same Clenshaw rows, bit for bit, and the crossing fraction, the
// reflection and the Heun remainder carry the coefficient tangent through
// every series they evaluate.  The plain versions are
// pygenray_tpu_torch/integrate.py:_trace_coef_tangent_impl and
// _trace_coef_tangent_rd_impl.  The JAX kernel's (direction x ray) lane
// packing and its COEF_RD_LANES_MAX chunking (:1817) fit the TPU's vector
// layout and are not carried over: here the grid has an axis per direction
// and per station.
//
// Design: grid (ceil(B / 64), D, nr), nr = 1 range-independent.  Block
// (x, g, j) copies the launch range's rows, the bottom-angle series and
// direction g's two rows to shared memory and traces rays x * 64 ...
// x * 64 + 63 with the state in registers for all steps; a dead ray is
// frozen.  Range-dependent, the per-step blended rows (nsteps, K) at
// mid-step and step end come from global memory, as in B2's RD path (every
// thread of the grid reads the same row at step k: broadcasts served from
// L1 and L2).  The primal and the counters do not depend on the direction or
// the station: the threads of (j, g) = (0, 0) write them (the JAX kernels
// return block 0's copy).  Blocks of 64 threads, as B2: at bench.py's
// Jacobian (512 rays x 16 directions) the grid is 8 x 16 blocks, at its 2D
// Jacobian (64 rays x 16 directions x 32 stations) 1 x 16 x 32, four per SM
// of the card's 132.  The grid's y and z extents are at most 65,535 each.
//
// What bounds it on an H100: FP32 issue.  Each series term is a Dual
// Clenshaw term with a Dual coefficient (8 operations, 9 with the hat
// product), about 2.5 times the forward step's operations a ray-step, as
// B2; one thread's dependent steps set the time at these shapes.  It reads a
// few kB (range-dependent, 4 x nsteps x K floats, read by every block) and
// writes 3 x 4 B per thread and 6 x 4 B per ray.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include "tangent_step.cuh"

#define TC_BLOCK 64

namespace {

using namespace tangent_step;

// station j's weight in a row blended at the station interval (i, w)
__device__ __forceinline__ float hat(const int* st_i, const float* st_w, int n, int j) {
  const int i = st_i[n];
  const float w = st_w[n];
  return i == j ? 1.0f - w : (i == j - 1 ? w : 0.0f);
}

template <bool RD>
__global__ void __launch_bounds__(TC_BLOCK)
trace_coef_tangent_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ z0v,
                          const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                          const float* __restrict__ bacoef, const float* __restrict__ b0s,
                          const float* __restrict__ b1s, const unsigned char* __restrict__ xoob,
                          const float* __restrict__ cms, const float* __restrict__ cpms,
                          const float* __restrict__ c1s, const float* __restrict__ cp1s,
                          const int* __restrict__ st_i, const float* __restrict__ st_w,
                          const float* __restrict__ dcoef, const float* __restrict__ dcpcoef,
                          float* __restrict__ T_out, float* __restrict__ z_out,
                          float* __restrict__ p_out, float* __restrict__ dT_out,
                          float* __restrict__ dz_out, float* __restrict__ dp_out,
                          int* __restrict__ n_surf_out, int* __restrict__ n_bott_out,
                          int* __restrict__ death_out) {
  const int g = blockIdx.y;  // direction
  const int j = blockIdx.z;  // perturbed station (0 range-independent)
  // the launch range's rows, direction g's rows and the bottom-angle series
  __shared__ float s_c[TS_MAX_K];
  __shared__ float s_cp[TS_MAX_K];
  __shared__ float s_dc[TS_MAX_K];
  __shared__ float s_dcp[TS_MAX_K];
  __shared__ float s_ba[TS_MAX_KB];
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    s_dc[k] = dcoef[(size_t)g * P.K + k];
    s_dcp[k] = dcpcoef[(size_t)g * P.K + k];
  }
  load_series(P, ccoef, cpcoef, bacoef, s_c, s_cp, s_ba);  // ends with a barrier

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const StepInputs in = {b0s, b1s, xoob, cms, cpms, c1s, cp1s};

  // the launch tangents are 0: the direction enters through the series
  const CoefRows r0 = {s_c, s_cp, s_dc, s_dcp, RD ? hat(st_i, st_w, 0, j) : 1.0f};
  RayState s = initial_state<false>(r0, P, z0v[b], 0.0f, p0v[b], 0.0f);
  for (int k = 0; k < P.nsteps && s.alive; ++k) {
    if (RD) {
      const size_t row = (size_t)k * P.K;
      const CoefRows rm = {in.cms + row, in.cpms + row, s_dc, s_dcp,
                           hat(st_i, st_w, 2 * k + 1, j)};  // mid-step
      const CoefRows r1 = {in.c1s + row, in.cp1s + row, s_dc, s_dcp,
                           hat(st_i, st_w, 2 * k + 2, j)};  // step's end
      step_rows<false>(P, in, rm, r1, s_ba, k, s);
    } else {
      step_rows<false>(P, in, r0, r0, s_ba, k, s);
    }
  }

  const size_t o = ((size_t)j * gridDim.y + g) * P.B + b;
  dT_out[o] = s.T.t;
  dz_out[o] = s.z.t;
  dp_out[o] = s.p.t;
  if (j == 0 && g == 0) {
    T_out[b] = s.T.v;
    z_out[b] = s.z.v;
    p_out[b] = s.p.v;
    n_surf_out[b] = s.n_surf;
    n_bott_out[b] = s.n_bott;
    death_out[b] = s.death;
  }
}

}  // namespace

// rd = 0: B5, tangents (D, B), nr = 1 and the per-step rows and station
// rows unused (may be null); rd = 1: B6, tangents (nr, D, B)
extern "C" int trace_coef_tangent_f32(
    const float* p0, const float* z0, const float* ccoef, const float* cpcoef,
    const float* bacoef, const float* b0s, const float* b1s, const unsigned char* xoob,
    const float* cms, const float* cpms, const float* c1s, const float* cp1s, const int* st_i,
    const float* st_w, const float* dcoef, const float* dcpcoef, float* T, float* z, float* p,
    float* dT, float* dz, float* dp, int* n_surf, int* n_bott, int* death, int B, int K, int Kb,
    int nsteps, int D, int nr, int bangle_cheb, int term_back, int any_x_oob, int rd, float x0,
    float h, float zlo_m, float zhi_p, float sc, float off, float sin_lim, float s2b, float c2b,
    float b_sum, float b_span, void* stream) {
  if (B <= 0 || D <= 0 || D > 65535 || nr <= 0 || nr > 65535 || K < 1 || K > TS_MAX_K ||
      Kb < 1 || Kb > TS_MAX_KB || nsteps < 1)
    return (int)cudaErrorInvalidValue;
  if (rd ? !(cms && cpms && c1s && cp1s && st_i && st_w) : nr != 1)
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(B, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
  const dim3 grid((B + TC_BLOCK - 1) / TC_BLOCK, D, nr);
#define TC_ARGS \
  P, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, st_i, st_w, dcoef, \
      dcpcoef, T, z, p, dT, dz, dp, n_surf, n_bott, death
  if (rd) trace_coef_tangent_kernel<true><<<grid, TC_BLOCK, 0, (cudaStream_t)stream>>>(TC_ARGS);
  else trace_coef_tangent_kernel<false><<<grid, TC_BLOCK, 0, (cudaStream_t)stream>>>(TC_ARGS);
#undef TC_ARGS
  return (int)cudaGetLastError();
}
