// The event-aware RK4 step on (value, tangent) pairs, shared by the
// forward-tangent kernels: trace_tangent.cu (final state only),
// trace_tangent_save.cu (state and tangent at every save point),
// trace_tangent_ens.cu (over an ensemble) and the coefficient-tangent
// kernels of trace_coef_tangent.cu.  One
// definition, so the kernels cannot drift apart: the save-grid kernel's last
// row is the final-state kernel's output bit for bit, and the
// coefficient-tangent kernels' primal is the final-state kernel's on the
// same Clenshaw rows.
//
// The step reads the profile's two series through a row type:
//   * `Rows` (constant coefficients, the launch-parameter tangents; the
//     kernels B2 and B3) evaluates the c and dc/dz series in two loops;
//   * `PairRows<KC>` (the same series, from rows the block staged in shared
//     memory; the ensemble kernel B4) has two lanes of a warp carry one ray:
//     the even lane evaluates c, the odd lane dc/dz, Horner or Clenshaw, and
//     the pair swaps the results, so both lanes must step the same ray
//     together (they hold the same state and take the same branches);
//   * `CoefRows<KC>` (coefficients that carry a tangent along a direction
//     of the Chebyshev coefficients, weighted by a station's hat; Clenshaw
//     only; the kernels B5 and B6) evaluates c and dc/dz in one loop.
// K is fixed at compile time when KC > 0.  Each recurrence keeps its own
// operations in their order, so the bits do not move, and the two
// independent chains overlap (on two lanes, or in one loop).
//
// Replaces `_make_step_math` of the Pallas TPU tangent kernels
// (pygenray_tpu/ops/pallas_stepper.py:730-823).  The step is written over the
// `Dual` type of dual.cuh in the expression order of its plain version
// (pygenray_tpu_torch/integrate.py:_event_step run on
// pygenray_tpu_torch/ops/dual.py's Duals by _tangent_loop); build with
// -fmad=false and without fast math (ops/_build.py).
#pragma once

#include <cuda_runtime.h>

#include "dual.cuh"

#define TS_MAX_K 256   // coefficient rows held in shared memory
#define TS_MAX_KB 128  // bottom-angle series length
#define TS_TINY 1e-30f
#define TS_DEG2RAD 0.017453292519943295f  // float32(pi / 180)

namespace tangent_step {

struct Params {
  int B, K, Kb;
  int nsteps;     // final-state kernel: steps in all
  int sps, nseg;  // save-grid kernel: steps a segment, segments
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

// the (c, dc/dz) series of a profile with constant coefficients
struct Rows {
  const float* c;
  const float* cp;
};

// the (c, dc/dz) series of a profile with constant coefficients, evaluated
// by a lane pair; KC > 0: K = KC at compile time
template <int KC>
struct PairRows {
  const float* c;
  const float* cp;
};

// the (c, dc/dz) series with coefficients {c[k], hat * dc[k]}: perturbed
// along the direction (dc, dcp), with the station's weight hat in the
// blended row (1 for a range-independent fit); KC > 0: K = KC at compile
// time
template <int KC>
struct CoefRows {
  const float* c;
  const float* cp;
  const float* dc;
  const float* dcp;
  float hat;
};

// both series of a profile at u: (c, dc/dz)
template <bool POW>
__device__ __forceinline__ void series2(const Rows& r, int K, Dual u, Dual& c, Dual& cp) {
  c = dpoly<POW>(r.c, K, u);
  cp = dpoly<POW>(r.cp, K, u);
}

template <bool POW>
__device__ __forceinline__ Dual series_c(const Rows& r, int K, Dual u) {
  return dpoly<POW>(r.c, K, u);
}

// both series, each by one lane of the pair (threads 2i and 2i + 1 of a
// warp-aligned block), each recurrence in dhorner's or dclenshaw's order
// (dual.cuh); the pair swaps its results through a shuffle of its two lanes
template <bool POW, int KC>
__device__ __forceinline__ void series2(const PairRows<KC>& r, int Kp, Dual u, Dual& c,
                                        Dual& cp) {
  const bool odd = threadIdx.x & 1;
  const Dual mine = dpoly<POW>(odd ? r.cp : r.c, KC > 0 ? KC : Kp, u);
  const unsigned pair = 3u << (threadIdx.x & 30);
  const Dual other = {__shfl_xor_sync(pair, mine.v, 1), __shfl_xor_sync(pair, mine.t, 1)};
  c = odd ? other : mine;
  cp = odd ? mine : other;
}

// the c series alone: both lanes evaluate it
template <bool POW, int KC>
__device__ __forceinline__ Dual series_c(const PairRows<KC>& r, int Kp, Dual u) {
  return dpoly<POW>(r.c, KC > 0 ? KC : Kp, u);
}

// coefficient k of a series with its tangent, hat * dc[k] (the plain
// version's Dual table holds the same single float32 product)
__device__ __forceinline__ Dual coef_at(const float* c, const float* dc, float hat, int k) {
  return {c[k], hat * dc[k]};
}

// Clenshaw over Dual coefficients, the c and dc/dz series in one loop
template <bool POW, int KC>
__device__ __forceinline__ void series2(const CoefRows<KC>& r, int Kp, Dual u, Dual& c,
                                        Dual& cp) {
  static_assert(!POW, "coefficient tangents are evaluated by Clenshaw only");
  const int K = KC > 0 ? KC : Kp;
  Dual b1 = {0.0f, 0.0f}, b2 = {0.0f, 0.0f}, q1 = {0.0f, 0.0f}, q2 = {0.0f, 0.0f};
  for (int k = K - 1; k >= 1; --k) {
    const Dual t = coef_at(r.c, r.dc, r.hat, k) + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
    const Dual tp = coef_at(r.cp, r.dcp, r.hat, k) + 2.0f * u * q1 - q2;
    q2 = q1;
    q1 = tp;
  }
  c = coef_at(r.c, r.dc, r.hat, 0) + u * b1 - b2;
  cp = coef_at(r.cp, r.dcp, r.hat, 0) + u * q1 - q2;
}

template <bool POW, int KC>
__device__ __forceinline__ Dual series_c(const CoefRows<KC>& r, int Kp, Dual u) {
  static_assert(!POW, "coefficient tangents are evaluated by Clenshaw only");
  const int K = KC > 0 ? KC : Kp;
  Dual b1 = {0.0f, 0.0f}, b2 = {0.0f, 0.0f};
  for (int k = K - 1; k >= 1; --k) {
    const Dual t = coef_at(r.c, r.dc, r.hat, k) + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
  }
  return coef_at(r.c, r.dc, r.hat, 0) + u * b1 - b2;
}

struct DDeriv {
  Dual kT, kz, kp, c;
};

template <bool POW, class R>
__device__ __forceinline__ Dual ev_c(const R& r, const Params& P, Dual z) {
  return series_c<POW>(r, P.K, dclip(P.sc * z - P.off, -1.0f, 1.0f));
}

template <bool POW, class R>
__device__ __forceinline__ DDeriv rhs(const R& r, const Params& P, Dual z, Dual p) {
  const Dual u = dclip(P.sc * z - P.off, -1.0f, 1.0f);
  Dual c, cp;
  series2<POW>(r, P.K, u, c, cp);
  const Dual cp2 = c * p;
  const Dual inv_s = drsqrt(dmax(1.0f - cp2 * cp2, TS_TINY));
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

// per-step inputs from the wrapper, computed by the plain version's own code
struct StepInputs {
  const float* __restrict__ b0s;  // (nsteps,) bathymetry at each step's start ...
  const float* __restrict__ b1s;  // ... and end
  const unsigned char* __restrict__ xoob;  // (nsteps,) x leaves the range domain
  // range-dependent: (nsteps, K) rows at mid-step and at the step's end
  const float* __restrict__ cms;
  const float* __restrict__ cpms;
  const float* __restrict__ c1s;
  const float* __restrict__ cp1s;
};

// the range-independent coefficient rows and the bottom-angle series, copied
// to shared memory by the whole block (ends with a barrier)
__device__ __forceinline__ void load_series(const Params& P, const float* ccoef,
                                            const float* cpcoef, const float* bacoef, float* s_c,
                                            float* s_cp, float* s_ba) {
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    s_c[k] = ccoef[k];
    s_cp[k] = cpcoef[k];
  }
  for (int k = threadIdx.x; k < P.Kb; k += blockDim.x) s_ba[k] = bacoef[k];
  __syncthreads();
}

// the launch constants from the C entry points' arguments
inline Params make_params(int B, int K, int Kb, int nsteps, int sps, int nseg, int bangle_cheb,
                          int term_back, int any_x_oob, float x0, float h, float zlo_m,
                          float zhi_p, float sc, float off, float sin_lim, float s2b, float c2b,
                          float b_sum, float b_span) {
  Params P;
  P.B = B;
  P.K = K;
  P.Kb = Kb;
  P.nsteps = nsteps;
  P.sps = sps;
  P.nseg = nseg;
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
  return P;
}

// one ray's state, kept in registers across all steps
struct RayState {
  Dual T, z, p;
  DDeriv k1;  // the derivative at the state (the next step's first stage)
  bool alive;
  int death, n_surf, n_bott;
};

// the launch state: tangents seed p0 and the source depth z0; r0: the
// series at the launch range
template <bool POW, class R>
__device__ __forceinline__ RayState initial_state(const R& r0, const Params& P, float z0,
                                                  float dz0, float p0, float dp0) {
  RayState s;
  s.T = {0.0f, 0.0f};
  s.z = {z0, dz0};
  s.p = {p0, dp0};
  s.k1 = rhs<POW>(r0, P, s.z, s.p);
  s.alive = (z0 >= P.zlo_m) && (z0 <= P.zhi_p);
  s.death = s.alive ? 0 : 2;
  s.n_surf = 0;
  s.n_bott = 0;
  return s;
}

// the launch state over constant-coefficient rows
template <bool POW>
__device__ __forceinline__ RayState initial_state(const float* s_c, const float* s_cp,
                                                  const Params& P, float z0, float dz0, float p0,
                                                  float dp0) {
  return initial_state<POW>(Rows{s_c, s_cp}, P, z0, dz0, p0, dp0);
}

// step k of a live ray: RK4 with the end derivative carried over, the
// boundary-crossing fix, uncompensated accumulation, death checks.  rm, r1:
// the series at mid-step and at the step's end; s_ba: the bottom-angle
// series in shared memory.
template <bool POW, class R>
__device__ __forceinline__ void step_rows(const Params& P, const StepInputs& in, const R& rm,
                                          const R& r1, const float* s_ba, int k, RayState& s) {
  const float hs = P.h;
  const float h6 = hs / 6.0f;
  const Dual T = s.T, z = s.z, p = s.p;
  const DDeriv k1 = s.k1;

  // ---- RK4 (k1 carried from the previous step's end derivative) ----
  const DDeriv k2 = rhs<POW>(rm, P, z + 0.5f * hs * k1.kz, p + 0.5f * hs * k1.kp);
  const DDeriv k3 = rhs<POW>(rm, P, z + 0.5f * hs * k2.kz, p + 0.5f * hs * k2.kp);
  const DDeriv k4 = rhs<POW>(r1, P, z + hs * k3.kz, p + hs * k3.kp);
  const Dual dT = h6 * (k1.kT + 2.0f * k2.kT + 2.0f * k3.kT + k4.kT);
  const Dual dz = h6 * (k1.kz + 2.0f * k2.kz + 2.0f * k3.kz + k4.kz);
  const Dual dp = h6 * (k1.kp + 2.0f * k2.kp + 2.0f * k3.kp + k4.kp);
  const Dual z1 = z + dz;
  const Dual p1 = p + dp;

  // ---- boundary crossing ----
  const float b0 = in.b0s[k];
  const float b1 = in.b1s[k];
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
    Dual f = dclip(g0 / (fabsf(dg.v) > TS_TINY ? dg : Dual{1.0f, 0.0f}), 0.0f, 1.0f);
    for (int it = 0; it < 2; ++it) {
      const Dual G = hermite(f, z, z1, mz0, mz1) - (bnd0 + f * db);
      const Dual Gp = hermite_d(f, z, z1, mz0, mz1) - db;
      f = dclip(f - G / (fabsf(Gp.v) > TS_TINY ? Gp : Dual{1.0f, 0.0f}), 0.0f, 1.0f);
    }
    // state at the crossing
    const Dual t_off = hermite(f, Dual{0.0f, 0.0f}, dT, hs * k1.kT, hs * k4.kT);
    const Dual z_c = hermite(f, z, z1, mz0, mz1);
    const Dual p_c = hermite(f, p, p1, hs * k1.kp, hs * k4.kp);
    // reflect (sin θ' = sin 2β cos θ - cos 2β sin θ, sin θ = c p)
    const Dual c_c = ev_c<POW>(rm, P, z_c);
    const Dual sin_th = dclip(p_c * c_c, -1.0f, 1.0f);
    const Dual cos_th = dsqrt(dmax(1.0f - sin_th * sin_th, 0.0f));
    Dual p_ref;
    float back_cos;
    if (P.bangle_cheb) {
      const float x0k = __fadd_rn(P.x0, __fmul_rn((float)k, hs));
      const Dual x_c = x0k + f * hs;
      const Dual ub = dclip((2.0f * x_c - P.b_sum) / P.b_span, -1.0f, 1.0f);
      const Dual b2 = 2.0f * (dclenshaw(s_ba, P.Kb, ub) * TS_DEG2RAD);
      Dual s2b, c2b;
      dsincos(b2, s2b, c2b);
      p_ref = reflect(s2b, c2b, cos_th, sin_th, c_c, surf, p_c, back_cos);
    } else {
      p_ref = reflect(P.s2b, P.c2b, cos_th, sin_th, c_c, surf, p_c, back_cos);
    }
    back_dead = P.term_back && bott && (back_cos < -1e-9f);
    // re-integrate the remainder of the step from the crossing (Heun)
    const Dual hr = (1.0f - f) * hs;
    const DDeriv q1 = rhs<POW>(rm, P, z_c, p_ref);
    const DDeriv q2 = rhs<POW>(r1, P, z_c + hr * q1.kz, p_ref + hr * q1.kp);
    if (!back_dead) {
      dT_tot = t_off + hr * 0.5f * (q1.kT + q2.kT);
      dz_tot = (z_c + hr * 0.5f * (q1.kz + q2.kz)) - z;
      p_new = p_ref + hr * 0.5f * (q1.kp + q2.kp);
    }
    s.n_surf += surf;
    s.n_bott += bott;
  }

  // ---- accumulate (no compensation) ----
  s.T = T + dT_tot;
  s.z = z + dz_tot;
  s.p = p_new;

  // ---- end-of-step derivative (next step's k1) + death checks ----
  s.k1 = rhs<POW>(r1, P, s.z, s.p);
  const bool vert = fabsf(s.k1.c.v * s.p.v) > P.sin_lim;
  const bool oob = (s.z.v > P.zhi_p) || (s.z.v < P.zlo_m) || (P.any_x_oob && in.xoob[k]);
  s.death = back_dead ? 3 : (vert ? 1 : (oob ? 2 : s.death));
  s.alive = !(vert || oob || back_dead);
}

// step k over constant-coefficient rows: s_c/s_cp, the range-independent
// rows in shared memory, or (RD) row k of the per-step tables
template <bool POW, bool RD>
__device__ __forceinline__ void step(const Params& P, const StepInputs& in, const float* s_c,
                                     const float* s_cp, const float* s_ba, int k, RayState& s) {
  const size_t row = RD ? (size_t)k * P.K : 0;
  const Rows rm = RD ? Rows{in.cms + row, in.cpms + row} : Rows{s_c, s_cp};  // mid-step
  const Rows r1 = RD ? Rows{in.c1s + row, in.cp1s + row} : Rows{s_c, s_cp};  // step's end
  step_rows<POW>(P, in, rm, r1, s_ba, k, s);
}

}  // namespace tangent_step
