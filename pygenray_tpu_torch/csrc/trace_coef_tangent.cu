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
// Design.  Range-independent (B5): grid (ceil(B / 64), D), one direction a
// thread.  Block (x, g) copies the launch rows, the bottom-angle series and
// direction g's two rows to shared memory and traces rays x * 64 ...
// x * 64 + 63 with the state in registers for all steps; a dead ray is
// frozen.  Range-dependent (B6): grid (ceil(B / 64), D, nr), one
// direction of one station a thread, as B5: carrying N directions over one
// primal path measured slower for N = 2, 4 and 8 at the main paths' shapes
// (PERF.md), which hold one or two warps a scheduler.  The stations'
// (nr, K) tables sit in shared memory (in global memory, read through L1,
// when 2 nr K floats would not fit), and each step's blended
// rows are made in the kernel from them: the block blends step k + 1's
// four rows, (1 - w) t[i] + w t[i + 1] (integrate._blend_rows' expression,
// float for float), into one half of a double buffer while it steps with
// step k's rows from the other half, one barrier a step, and keeps the
// rows' station intervals (i, w) beside them for the hat weights.  So the
// wrapper builds no per-step rows, and no coefficient load waits on global
// memory.  A block's threads stay in the step loop together (a dead or
// masked ray skips the step but not the barrier) until none of its rays is
// alive.  The c and dc/dz series run in one loop (tangent_step.cuh's
// `CoefRows`), their two recurrences overlapping; K = 16, 32 and 64, the
// lengths the main paths use, are compiled with K fixed.  The primal and
// the counters do not depend on the direction or the station: the threads
// of (j, g) = (0, 0) write them (the JAX kernels return block 0's copy).
// The grid's y and z extents are at most 65,535 each.
//
// What bounds it on an H100.  The work is FP32 issue: each series term is a
// Dual Clenshaw term with a Dual coefficient, 3 operations for the primal
// and 6 for each tangent (the hat product included), against the forward
// step's 3.  It reads a few kB (the station tables) and writes 3 x 4 B per
// (station, direction, ray) and 6 x 4 B per ray.  At the main paths' shapes
// (the inversion: 9 x 32 x 128; the 2D Jacobian: 32 x 16 x 64) the card
// holds about one warp per scheduler, so a thread's dependent chain of
// steps (hundreds of series terms, each an add after a multiply) and its
// own issue set the time, not the card's peak; the fused series halve the
// chain of a right-hand side.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include "tangent_step.cuh"

#define TC_BLOCK 64
#define TC_MAX_SMEM (200 * 1024)  // dynamic shared memory a block may take, bytes

namespace {

using namespace tangent_step;

// station j's weight in a row blended at the station interval (i, w)
__device__ __forceinline__ float hat(int i, float w, int j) {
  return i == j ? 1.0f - w : (i == j - 1 ? w : 0.0f);
}

// rows of one step, made by the block from the station tables: mid-step c
// and dc/dz at the interval (im, wm), step-end c and dc/dz at (i1, w1),
// each (1 - w) t[i] + w t[i + 1], into buf[0 .. 4K)
__device__ __forceinline__ void blend_step(const float* ctab, const float* cptab, int K, int im,
                                           float wm, int i1, float w1, float* buf) {
  for (int q = threadIdx.x; q < 4 * K; q += blockDim.x) {
    const int r = q / K;
    const int k = q - r * K;
    const float* t = (r & 1) ? cptab : ctab;
    const int i = r < 2 ? im : i1;
    const float w = r < 2 ? wm : w1;
    buf[q] = (1.0f - w) * t[i * K + k] + w * t[(i + 1) * K + k];
  }
}

template <bool RD, int KC>
__global__ void __launch_bounds__(TC_BLOCK)
trace_coef_tangent_kernel(Params P, int D, int nr, int tab_smem, const float* __restrict__ p0v,
                          const float* __restrict__ z0v, const float* __restrict__ ccoef,
                          const float* __restrict__ cpcoef, const float* __restrict__ bacoef,
                          const float* __restrict__ b0s, const float* __restrict__ b1s,
                          const unsigned char* __restrict__ xoob, const int* __restrict__ st_i,
                          const float* __restrict__ st_w, const float* __restrict__ dcoef,
                          const float* __restrict__ dcpcoef, float* __restrict__ T_out,
                          float* __restrict__ z_out, float* __restrict__ p_out,
                          float* __restrict__ dT_out, float* __restrict__ dz_out,
                          float* __restrict__ dp_out, int* __restrict__ n_surf_out,
                          int* __restrict__ n_bott_out, int* __restrict__ death_out) {
  using R = CoefRows<KC>;
  const int K = KC > 0 ? KC : P.K;
  const int g = blockIdx.y;  // direction
  const int j = blockIdx.z;  // perturbed station (0 range-independent)
  // the launch range's rows and the bottom-angle series; dynamic: the
  // direction's two rows (K each), then (RD) the station tables when they
  // fit and the double buffer of step rows (2, 4K)
  __shared__ float s_c[TS_MAX_K];
  __shared__ float s_cp[TS_MAX_K];
  __shared__ float s_ba[TS_MAX_KB];
  __shared__ int s_i[2][2];    // RD: the buffer's station intervals, mid-step and step end
  __shared__ float s_w[2][2];
  extern __shared__ float s_dyn[];
  float* s_dc = s_dyn;
  float* s_dcp = s_dc + K;
  float* s_tab = s_dcp + K;
  float* s_buf = s_tab + (tab_smem ? 2 * nr * K : 0);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_dc[k] = dcoef[(size_t)g * K + k];
    s_dcp[k] = dcpcoef[(size_t)g * K + k];
  }
  const float* ctab = ccoef;
  const float* cptab = cpcoef;
  int nim = 0, ni1 = 0;  // RD: the station intervals of the next step to blend
  float nwm = 0.0f, nw1 = 0.0f;
  if (RD) {
    if (tab_smem) {
      for (int q = threadIdx.x; q < nr * K; q += blockDim.x) {
        s_tab[q] = ccoef[q];
        s_tab[nr * K + q] = cpcoef[q];
      }
      __syncthreads();
      ctab = s_tab;
      cptab = s_tab + nr * K;
    }
    // the launch range's rows, and step 0's
    const int i0 = st_i[0];
    const float w0 = st_w[0];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      s_c[k] = (1.0f - w0) * ctab[i0 * K + k] + w0 * ctab[(i0 + 1) * K + k];
      s_cp[k] = (1.0f - w0) * cptab[i0 * K + k] + w0 * cptab[(i0 + 1) * K + k];
    }
    blend_step(ctab, cptab, K, st_i[1], st_w[1], st_i[2], st_w[2], s_buf);
    if (threadIdx.x == 0) {
      s_i[0][0] = st_i[1];
      s_w[0][0] = st_w[1];
      s_i[0][1] = st_i[2];
      s_w[0][1] = st_w[2];
    }
    if (P.nsteps > 1) {
      nim = st_i[3];
      nwm = st_w[3];
      ni1 = st_i[4];
      nw1 = st_w[4];
    }
    for (int k = threadIdx.x; k < P.Kb; k += blockDim.x) s_ba[k] = bacoef[k];
    __syncthreads();
  } else {
    load_series(P, ccoef, cpcoef, bacoef, s_c, s_cp, s_ba);  // ends with a barrier
  }

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = b < P.B;
  if (!RD && !act) return;
  const StepInputs in = {b0s, b1s, xoob, nullptr, nullptr, nullptr, nullptr};

  // the launch tangents are 0: the direction enters through the series
  const R r0 = {s_c, s_cp, s_dc, s_dcp, RD ? hat(st_i[0], st_w[0], j) : 1.0f};
  RayState s = initial_state<false>(r0, P, act ? z0v[b] : 0.0f, 0.0f, act ? p0v[b] : 0.0f, 0.0f);
  s.alive = s.alive && act;
  if (RD) {
    for (int k = 0; k < P.nsteps; ++k) {
      const int cur = k & 1;
      float* rows = s_buf + cur * 4 * K;
      if (k + 1 < P.nsteps) {  // step k + 1's rows into the other half
        blend_step(ctab, cptab, K, nim, nwm, ni1, nw1, s_buf + (cur ^ 1) * 4 * K);
        if (threadIdx.x == 0) {
          s_i[cur ^ 1][0] = nim;
          s_w[cur ^ 1][0] = nwm;
          s_i[cur ^ 1][1] = ni1;
          s_w[cur ^ 1][1] = nw1;
        }
        if (k + 2 < P.nsteps) {
          nim = st_i[2 * k + 5];
          nwm = st_w[2 * k + 5];
          ni1 = st_i[2 * k + 6];
          nw1 = st_w[2 * k + 6];
        }
      }
      if (s.alive) {
        const R rm = {rows, rows + K, s_dc, s_dcp, hat(s_i[cur][0], s_w[cur][0], j)};
        const R r1 = {rows + 2 * K, rows + 3 * K, s_dc, s_dcp, hat(s_i[cur][1], s_w[cur][1], j)};
        step_rows<false>(P, in, rm, r1, s_ba, k, s);
      }
      if (!__syncthreads_or(s.alive)) break;
    }
    if (!act) return;
  } else {
    for (int k = 0; k < P.nsteps && s.alive; ++k) step_rows<false>(P, in, r0, r0, s_ba, k, s);
  }

  const size_t o = ((size_t)j * D + g) * P.B + b;
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

template <bool RD, int KC>
int launch(const Params& P, int D, int nr, cudaStream_t stream, const float* p0, const float* z0,
           const float* ccoef, const float* cpcoef, const float* bacoef, const float* b0s,
           const float* b1s, const unsigned char* xoob, const int* st_i, const float* st_w,
           const float* dcoef, const float* dcpcoef, float* T, float* z, float* p, float* dT,
           float* dz, float* dp, int* n_surf, int* n_bott, int* death) {
  auto kern = trace_coef_tangent_kernel<RD, KC>;
  const size_t dirs = 2 * (size_t)P.K * sizeof(float);
  const size_t tabs = RD ? 2 * (size_t)nr * P.K * sizeof(float) : 0;
  const size_t bufs = RD ? 8 * (size_t)P.K * sizeof(float) : 0;
  const int tab_smem = RD && dirs + tabs + bufs <= TC_MAX_SMEM;
  const size_t smem = dirs + bufs + (tab_smem ? tabs : 0);
  if (smem > TC_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P.B + TC_BLOCK - 1) / TC_BLOCK, D, RD ? nr : 1);
  kern<<<grid, TC_BLOCK, smem, stream>>>(P, D, nr, tab_smem, p0, z0, ccoef, cpcoef, bacoef, b0s,
                                         b1s, xoob, st_i, st_w, dcoef, dcpcoef, T, z, p, dT, dz,
                                         dp, n_surf, n_bott, death);
  return (int)cudaGetLastError();
}

// K fixed at compile time for the lengths the main paths use
template <bool RD, class... A>
int launch_k(int K, A... a) {
  switch (K) {
    case 16: return launch<RD, 16>(a...);
    case 32: return launch<RD, 32>(a...);
    case 64: return launch<RD, 64>(a...);
    default: return launch<RD, 0>(a...);
  }
}

}  // namespace

// rd = 0: B5, tangents (D, B), nr = 1, the station rows unused (may be
// null); rd = 1: B6, ccoef/cpcoef the stations' (nr, K) tables, st_i/st_w
// the station intervals of integrate._station_iw_rows, tangents (nr, D, B)
extern "C" int trace_coef_tangent_f32(
    const float* p0, const float* z0, const float* ccoef, const float* cpcoef,
    const float* bacoef, const float* b0s, const float* b1s, const unsigned char* xoob,
    const int* st_i, const float* st_w, const float* dcoef, const float* dcpcoef, float* T,
    float* z, float* p, float* dT, float* dz, float* dp, int* n_surf, int* n_bott, int* death,
    int B, int K, int Kb, int nsteps, int D, int nr, int bangle_cheb, int term_back,
    int any_x_oob, int rd, float x0, float h, float zlo_m, float zhi_p, float sc, float off,
    float sin_lim, float s2b, float c2b, float b_sum, float b_span, void* stream) {
  if (B <= 0 || D <= 0 || D > 65535 || nr <= 0 || nr > 65535 || K < 1 || K > TS_MAX_K ||
      Kb < 1 || Kb > TS_MAX_KB || nsteps < 1)
    return (int)cudaErrorInvalidValue;
  if (rd ? !(st_i && st_w && nr >= 2) : nr != 1) return (int)cudaErrorInvalidValue;
  const Params P = make_params(B, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
#define TC_ARGS \
  K, P, D, nr, (cudaStream_t)stream, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, st_i, st_w, \
      dcoef, dcpcoef, T, z, p, dT, dz, dp, n_surf, n_bott, death
  const int err = rd ? launch_k<true>(TC_ARGS) : launch_k<false>(TC_ARGS);
#undef TC_ARGS
  return err;
}
