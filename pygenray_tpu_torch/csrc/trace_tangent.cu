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
// kernel trace; here the step is written once over the `Dual` type of
// dual.cuh, in the expression order of its plain version
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

#include "dual.cuh"

#define TT_BLOCK 64
#define TT_MAX_K 256
#define TT_MAX_KB 128
#define TT_TINY 1e-30f
#define TT_DEG2RAD 0.017453292519943295f  // float32(pi / 180)

namespace {

struct Params {
  int B, K, Kb, nsteps;
  int bangle_cheb, term_back, any_x_oob;
  float x0, h;          // range origin and step [m]
  float zlo_m, zhi_p;   // depth domain widened by bbox_tol
  float sc, off;        // depth -> Chebyshev coordinate u = sc*z - off
  float sin_lim;        // vertical-ray limit on |c p|
  float s2b, c2b;       // sin/cos of twice a constant bottom angle
  float b_sum, b_span;  // bottom-angle series domain: u = (2x - sum)/span
};

template <bool POW>
__device__ __forceinline__ Dual dpoly(const float* c, int K, Dual u) {
  return POW ? dhorner(c, K, u) : dclenshaw(c, K, u);
}

struct DDeriv {
  Dual kT, kz, kp, c;
};

template <bool POW>
__device__ __forceinline__ Dual ev_c(const float* cc, const Params& P, Dual z) {
  return dpoly<POW>(cc, P.K, dclip(P.sc * z - P.off, -1.0f, 1.0f));
}

template <bool POW>
__device__ __forceinline__ DDeriv rhs(const float* cc, const float* cpc, const Params& P, Dual z,
                                      Dual p) {
  const Dual u = dclip(P.sc * z - P.off, -1.0f, 1.0f);
  const Dual c = dpoly<POW>(cc, P.K, u);
  const Dual cp = dpoly<POW>(cpc, P.K, u);
  const Dual cp2 = c * p;
  const Dual inv_s = drsqrt(dmax(1.0f - cp2 * cp2, TT_TINY));
  const Dual invc = 1.0f / c;
  return {inv_s * invc, cp2 * inv_s, -cp * inv_s * invc * invc, c};
}

__device__ __forceinline__ Dual hermite(Dual s, Dual y0, Dual y1, Dual m0, Dual m1) {
  const Dual s2 = s * s;
  const Dual s3 = s2 * s;
  return (2.0f * s3 - 3.0f * s2 + 1.0f) * y0 + (s3 - 2.0f * s2 + s) * m0 +
         (-2.0f * s3 + 3.0f * s2) * y1 + (s3 - s2) * m1;
}

__device__ __forceinline__ Dual hermite_d(Dual s, Dual y0, Dual y1, Dual m0, Dual m1) {
  const Dual s2 = s * s;
  return (6.0f * s2 - 6.0f * s) * y0 + (3.0f * s2 - 4.0f * s + 1.0f) * m0 +
         (-6.0f * s2 + 6.0f * s) * y1 + (3.0f * s2 - 2.0f * s) * m1;
}

// the reflection: S is float (a constant bottom angle) or Dual (a
// Chebyshev one, which moves with the crossing range)
template <class S>
__device__ __forceinline__ Dual reflect(S s2b, S c2b, Dual cos_th, Dual sin_th, Dual c_c,
                                        bool surf, Dual p_c, float& back_cos) {
  back_cos = (c2b * cos_th + s2b * sin_th).v;
  return surf ? -p_c : (s2b * cos_th - c2b * sin_th) / c_c;
}

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
  __shared__ float s_c[TT_MAX_K];
  __shared__ float s_cp[TT_MAX_K];
  __shared__ float s_ba[TT_MAX_KB];
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    s_c[k] = ccoef[k];
    s_cp[k] = cpcoef[k];
  }
  for (int k = threadIdx.x; k < P.Kb; k += blockDim.x) s_ba[k] = bacoef[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.B) return;
  const float hs = P.h;
  const float h6 = hs / 6.0f;

  // ---- initial state: the launch tangent seeds p only ----
  const float z0 = z0v[i];
  Dual T = {0.0f, 0.0f}, z = {z0, 0.0f}, p = {p0v[i], dp0v[i]};
  DDeriv k1 = rhs<POW>(s_c, s_cp, P, z, p);
  bool alive = (z0 >= P.zlo_m) && (z0 <= P.zhi_p);
  int death = alive ? 0 : 2;
  int n_surf = 0, n_bott = 0;

  for (int k = 0; k < P.nsteps && alive; ++k) {
    const size_t row = RD ? (size_t)k * P.K : 0;
    const float* cm = RD ? cms + row : s_c;  // mid-step rows
    const float* cpm = RD ? cpms + row : s_cp;
    const float* c1 = RD ? c1s + row : s_c;  // end-of-step rows
    const float* cp1 = RD ? cp1s + row : s_cp;

    // ---- RK4 (k1 carried from the previous step's end derivative) ----
    const DDeriv k2 = rhs<POW>(cm, cpm, P, z + 0.5f * hs * k1.kz, p + 0.5f * hs * k1.kp);
    const DDeriv k3 = rhs<POW>(cm, cpm, P, z + 0.5f * hs * k2.kz, p + 0.5f * hs * k2.kp);
    const DDeriv k4 = rhs<POW>(c1, cp1, P, z + hs * k3.kz, p + hs * k3.kp);
    const Dual dT = h6 * (k1.kT + 2.0f * k2.kT + 2.0f * k3.kT + k4.kT);
    const Dual dz = h6 * (k1.kz + 2.0f * k2.kz + 2.0f * k3.kz + k4.kz);
    const Dual dp = h6 * (k1.kp + 2.0f * k2.kp + 2.0f * k3.kp + k4.kp);
    const Dual z1 = z + dz;
    const Dual p1 = p + dp;

    // ---- boundary crossing ----
    const float b0 = b0s[k];
    const float b1 = b1s[k];
    const bool surf = (z1.v < 0.0f) && (z.v >= 0.0f);
    const bool bott = (z1.v > b1) && (z.v <= b0);
    Dual dT_tot = dT, dz_tot = dz, p_new = p1;
    bool back_dead = false;
    if (surf || bott) {
      // localize the crossing inside the step (cubic Hermite in s)
      const float bnd0 = surf ? 0.0f : b0;
      const float bnd1 = surf ? 0.0f : b1;
      const float db = bnd1 - bnd0;
      const Dual mz0 = hs * k1.kz;
      const Dual mz1 = hs * k4.kz;
      const Dual g0 = z - bnd0;
      const Dual g1 = z1 - bnd1;
      const Dual dg = g0 - g1;
      Dual f = dclip(g0 / (fabsf(dg.v) > TT_TINY ? dg : Dual{1.0f, 0.0f}), 0.0f, 1.0f);
      for (int it = 0; it < 2; ++it) {
        const Dual G = hermite(f, z, z1, mz0, mz1) - (bnd0 + f * db);
        const Dual Gp = hermite_d(f, z, z1, mz0, mz1) - db;
        f = dclip(f - G / (fabsf(Gp.v) > TT_TINY ? Gp : Dual{1.0f, 0.0f}), 0.0f, 1.0f);
      }
      // state at the crossing
      const Dual t_off = hermite(f, Dual{0.0f, 0.0f}, dT, hs * k1.kT, hs * k4.kT);
      const Dual z_c = hermite(f, z, z1, mz0, mz1);
      const Dual p_c = hermite(f, p, p1, hs * k1.kp, hs * k4.kp);
      // reflect (sin θ' = sin 2β cos θ - cos 2β sin θ, sin θ = c p)
      const Dual c_c = ev_c<POW>(cm, P, z_c);
      const Dual sin_th = dclip(p_c * c_c, -1.0f, 1.0f);
      const Dual cos_th = dsqrt(dmax(1.0f - sin_th * sin_th, 0.0f));
      Dual p_ref;
      float back_cos;
      if (P.bangle_cheb) {
        const float x0k = __fadd_rn(P.x0, __fmul_rn((float)k, hs));
        const Dual x_c = x0k + f * hs;
        const Dual ub = dclip((2.0f * x_c - P.b_sum) / P.b_span, -1.0f, 1.0f);
        const Dual b2 = 2.0f * (dclenshaw(s_ba, P.Kb, ub) * TT_DEG2RAD);
        Dual s2b, c2b;
        dsincos(b2, s2b, c2b);
        p_ref = reflect(s2b, c2b, cos_th, sin_th, c_c, surf, p_c, back_cos);
      } else {
        p_ref = reflect(P.s2b, P.c2b, cos_th, sin_th, c_c, surf, p_c, back_cos);
      }
      back_dead = P.term_back && bott && (back_cos < -1e-9f);
      // re-integrate the remainder of the step from the crossing (Heun)
      const Dual hr = (1.0f - f) * hs;
      const DDeriv r1 = rhs<POW>(cm, cpm, P, z_c, p_ref);
      const DDeriv r2 = rhs<POW>(c1, cp1, P, z_c + hr * r1.kz, p_ref + hr * r1.kp);
      if (!back_dead) {
        dT_tot = t_off + hr * 0.5f * (r1.kT + r2.kT);
        dz_tot = (z_c + hr * 0.5f * (r1.kz + r2.kz)) - z;
        p_new = p_ref + hr * 0.5f * (r1.kp + r2.kp);
      }
      n_surf += surf;
      n_bott += bott;
    }

    // ---- accumulate (no compensation) ----
    T = T + dT_tot;
    z = z + dz_tot;
    p = p_new;

    // ---- end-of-step derivative (next step's k1) + death checks ----
    k1 = rhs<POW>(c1, cp1, P, z, p);
    const bool vert = fabsf(k1.c.v * p.v) > P.sin_lim;
    const bool oob = (z.v > P.zhi_p) || (z.v < P.zlo_m) || (P.any_x_oob && xoob[k]);
    death = back_dead ? 3 : (vert ? 1 : (oob ? 2 : death));
    alive = !(vert || oob || back_dead);
  }
  T_out[i] = T.v;
  z_out[i] = z.v;
  p_out[i] = p.v;
  dT_out[i] = T.t;
  dz_out[i] = z.t;
  dp_out[i] = p.t;
  n_surf_out[i] = n_surf;
  n_bott_out[i] = n_bott;
  death_out[i] = death;
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
  if (B <= 0 || K < 1 || K > TT_MAX_K || Kb < 1 || Kb > TT_MAX_KB || nsteps < 1)
    return (int)cudaErrorInvalidValue;
  if (rd && !(cms && cpms && c1s && cp1s)) return (int)cudaErrorInvalidValue;
  Params P;
  P.B = B;
  P.K = K;
  P.Kb = Kb;
  P.nsteps = nsteps;
  P.bangle_cheb = bangle_cheb;
  P.term_back = term_back;
  P.any_x_oob = any_x_oob;
  P.x0 = x0;
  P.h = h;
  P.zlo_m = zlo_m;
  P.zhi_p = zhi_p;
  P.sc = sc;
  P.off = off;
  P.sin_lim = sin_lim;
  P.s2b = s2b;
  P.c2b = c2b;
  P.b_sum = b_sum;
  P.b_span = b_span;
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
