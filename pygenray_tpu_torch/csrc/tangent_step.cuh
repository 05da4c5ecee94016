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
//   * `PairRows<KC>` (the c and dc/dz series, from rows the block staged in
//     shared memory; the ensemble kernel B4) has two lanes of a warp carry
//     one ray: the even lane evaluates c, the odd lane dc/dz, Horner or
//     Clenshaw, and the pair swaps the results, so both lanes must step the
//     same ray together (they hold the same state and take the same
//     branches);
//   * `FusedRows<KC>` and `FusedRegs<KC>` (one thread a ray, c and dc/dz
//     in one loop, from shared memory or, up to K = TS_REG_MAX_K, from
//     registers loaded once; the final-state and save-grid kernels B2 and
//     B3, through tangent_trace.cuh);
//   * `CoefRows<KC>` (coefficients that carry a tangent along a direction
//     of the Chebyshev coefficients, weighted by a station's hat; Clenshaw
//     only; the range-dependent kernel B6) evaluates c and dc/dz in one
//     loop;
//   * `CoefPairRegs<KC>` and `CoefPairRows<KC>` (the same coefficients,
//     range-independent; the kernel B5) have a lane pair carry one
//     direction of one ray as `PairRows` does: the even lane evaluates c on
//     {c[k], dc[k]}, the odd lane dc/dz on {cp[k], dcp[k]}, each lane its
//     own rows, in registers or from shared memory; the swap's shuffle
//     names the whole warp, whose lanes step together (`warp_steps`).
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

#include <type_traits>

#include "dual.cuh"

#define TS_MAX_K 256   // coefficient rows held in shared memory
#define TS_MAX_KB 128  // bottom-angle series length
#define TS_REG_MAX_K 32  // series held in registers (FusedRegs) up to this K
#define TS_TINY 1e-30f
#define TS_DEG2RAD 0.017453292519943295f  // float32(pi / 180)

namespace tangent_step {

struct Params {
  int B, K, Kb;
  int nsteps;     // steps in all
  int sps, nseg;  // steps a segment, segments (final-state kernels: nsteps, 1)
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

// the (c, dc/dz) series of a profile with constant coefficients, evaluated
// by a lane pair; KC > 0: K = KC at compile time
template <int KC>
struct PairRows {
  const float* c;
  const float* cp;
};

// the (c, dc/dz) series of a profile with constant coefficients, both
// evaluated by one thread in one loop; KC > 0: K = KC at compile time
template <int KC>
struct FusedRows {
  const float* c;
  const float* cp;
};

// the same, the coefficients in registers (KC <= TS_REG_MAX_K)
template <int KC>
struct FusedRegs {
  float c[KC];
  float cp[KC];
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

// the (c, dc/dz) series with coefficients {a[k], da[k]} of one direction
// of a range-independent fit (the hat is 1), evaluated by a lane pair as
// `PairRows`: the even lane's rows are c's and the direction's dc, the odd
// lane's dc/dz's and its dcp; KC > 0: K = KC at compile time.  A: where
// the lane's rows are, `const float*` into shared memory (`CoefPairRows`)
// or `float[KC]` in registers (`CoefPairRegs`, KC > 0)
template <int KC, class A>
struct CoefPair {
  A a;
  A da;
};
template <int KC>
using CoefPairRows = CoefPair<KC, const float*>;
template <int KC>
using CoefPairRegs = CoefPair<KC, float[(KC > 0 ? KC : 1)]>;

// Whether the lanes of a warp step together (every lane of the warp runs
// each step and each branch that holds a shuffle, so that a shuffle names
// the whole warp): the coefficient pairs' rows.  With a mask that names
// only the pair, ptxas serializes a shuffle over the warp's distinct masks.
template <class R>
struct warp_steps {
  static constexpr bool value = false;
};
template <int KC, class A>
struct warp_steps<CoefPair<KC, A>> {
  static constexpr bool value = true;
};

// the two lanes of a pair, threads 2i and 2i + 1 of a warp-aligned block:
// each its own c or dc/dz series, the pair swapping the results through a
// shuffle that names the lanes ``mask`` (the pair's, or the whole warp's)
__device__ __forceinline__ void pair_swap(Dual mine, unsigned mask, Dual& c, Dual& cp) {
  const bool odd = threadIdx.x & 1;
  const Dual other = {__shfl_xor_sync(mask, mine.v, 1), __shfl_xor_sync(mask, mine.t, 1)};
  c = odd ? other : mine;
  cp = odd ? mine : other;
}

// both series, each by one lane of the pair, each recurrence in dhorner's
// or dclenshaw's order (dual.cuh)
template <bool POW, int KC>
__device__ __forceinline__ void series2(const PairRows<KC>& r, int Kp, Dual u, Dual& c,
                                        Dual& cp) {
  const bool odd = threadIdx.x & 1;
  pair_swap(dpoly<POW>(odd ? r.cp : r.c, KC > 0 ? KC : Kp, u), 3u << (threadIdx.x & 30), c, cp);
}

// the c series alone: both lanes evaluate it
template <bool POW, int KC>
__device__ __forceinline__ Dual series_c(const PairRows<KC>& r, int Kp, Dual u) {
  return dpoly<POW>(r.c, KC > 0 ? KC : Kp, u);
}

template <int KC>
__device__ __forceinline__ FusedRegs<KC> fused_regs(const float* c, const float* cp) {
  FusedRegs<KC> r;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    r.c[k] = c[k];
    r.cp[k] = cp[k];
  }
  return r;
}

// both series of one thread in one loop, each recurrence in dhorner's or
// dclenshaw's order, the loop unrolled U times (U >= K: in full, for
// coefficients in registers; rows in shared memory take U = 4, so that the
// compiler does not hold a whole step's rows in registers)
template <bool POW, int KC, int U>
__device__ __forceinline__ void dpoly2(const float* a, const float* b, int Kp, Dual u, Dual& ra,
                                       Dual& rb) {
  const int K = KC > 0 ? KC : Kp;
  if (POW) {
    Dual x = {0.0f + a[K - 1], 0.0f}, y = {0.0f + b[K - 1], 0.0f};
#pragma unroll(U)
    for (int k = K - 2; k >= 0; --k) {
      x = x * u + a[k];
      y = y * u + b[k];
    }
    ra = x;
    rb = y;
    return;
  }
  Dual b1 = {0.0f, 0.0f}, b2 = {0.0f, 0.0f}, q1 = {0.0f, 0.0f}, q2 = {0.0f, 0.0f};
#pragma unroll(U)
  for (int k = K - 1; k >= 1; --k) {
    const Dual t = a[k] + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
    const Dual tp = b[k] + 2.0f * u * q1 - q2;
    q2 = q1;
    q1 = tp;
  }
  ra = a[0] + u * b1 - b2;
  rb = b[0] + u * q1 - q2;
}

template <bool POW, int KC>
__device__ __forceinline__ void series2(const FusedRows<KC>& r, int Kp, Dual u, Dual& c,
                                        Dual& cp) {
  dpoly2<POW, KC, 4>(r.c, r.cp, Kp, u, c, cp);
}

template <bool POW, int KC>
__device__ __forceinline__ Dual series_c(const FusedRows<KC>& r, int Kp, Dual u) {
  return dpoly<POW>(r.c, KC > 0 ? KC : Kp, u);
}

template <bool POW, int KC>
__device__ __forceinline__ void series2(const FusedRegs<KC>& r, int, Dual u, Dual& c, Dual& cp) {
  dpoly2<POW, KC, KC>(r.c, r.cp, KC, u, c, cp);
}

// the c series alone (the compiler drops the unused dc/dz recurrence)
template <bool POW, int KC>
__device__ __forceinline__ Dual series_c(const FusedRegs<KC>& r, int, Dual u) {
  Dual c, cp;
  dpoly2<POW, KC, KC>(r.c, r.cp, KC, u, c, cp);
  return c;
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

// Clenshaw over the Dual coefficients {a[k], da[k]} (coef_at's with the
// hat 1), in CoefRows' order, the loop unrolled U times
template <int KC, int U>
__device__ __forceinline__ Dual dclenshaw_dc(const float* a, const float* da, int Kp, Dual u) {
  const int K = KC > 0 ? KC : Kp;
  Dual b1 = {0.0f, 0.0f}, b2 = {0.0f, 0.0f};
#pragma unroll(U)
  for (int k = K - 1; k >= 1; --k) {
    const Dual t = Dual{a[k], da[k]} + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
  }
  return Dual{a[0], da[0]} + u * b1 - b2;
}

// a lane's series (c on the even lane, dc/dz on the odd), swapped in the
// pair; from shared memory the loop is unrolled 4 times, as FusedRows',
// from registers fully
template <bool POW, int KC, class A>
__device__ __forceinline__ void series2(const CoefPair<KC, A>& r, int Kp, Dual u, Dual& c,
                                        Dual& cp) {
  static_assert(!POW, "coefficient tangents are evaluated by Clenshaw only");
  constexpr int U = std::is_pointer<A>::value ? 4 : KC;
  pair_swap(dclenshaw_dc<KC, U>(r.a, r.da, Kp, u), 0xffffffffu, c, cp);
}

// the c series alone (the crossing fix): each lane runs its own series and
// the odd lane takes the even lane's c through the same swap, so no lane
// holds a second set of rows
template <bool POW, int KC, class A>
__device__ __forceinline__ Dual series_c(const CoefPair<KC, A>& r, int Kp, Dual u) {
  Dual c, cp;
  series2<POW>(r, Kp, u, c, cp);
  return c;
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
  // lanes that step together run the fix when a live ray of the warp
  // crosses (a dead ray's lanes step a copy that is dropped, so they do not
  // vote), and only the crossing lanes keep its results (surf = bott =
  // false leaves back_dead false and the counters as they were)
  if (warp_steps<R>::value ? __any_sync(0xffffffffu, s.alive && (surf || bott))
                           : (surf || bott)) {
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
    if ((surf || bott) && !back_dead) {
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

}  // namespace tangent_step
