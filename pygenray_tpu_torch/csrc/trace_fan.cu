// Forward ray-fan trace: the whole fixed-step integration of a fan of rays
// in one launch, one CUDA thread per ray.
//
// Replaces: the Pallas TPU mega-kernel `_make_kernel`
// (pygenray_tpu/ops/pallas_stepper.py:228-701) as launched by
// `trace_pallas` (:2733), in all its profile modes (template SEG):
//   * spectral (SEG = 0): profile c(z), dc/dz(z) from Chebyshev fits,
//     evaluated by Horner on the monomial re-expression (use_pow) or by
//     Clenshaw, chosen at run time; range-independent (one coefficient row)
//     or range-dependent (the per-step rows blended linearly in range that
//     the JAX kernel DMAs from `_station_rows`, :2695: row k of the
//     mid-step and step-end tables at step k);
//   * segment (SEG = 1, basis "pow", Horner; SEG = 2, basis "cheb",
//     Clenshaw): the piecewise fits of rough fields (`_seg_horner` /
//     `_seg_clenshaw` :132-166, `ev` :254-284): per ray a segment pick
//     seg = min(floor(t), S - 1) with t = clamp((z - zlo) * hinv, 0, S) and
//     a local series in u = 2 (t - seg) - 1 over column seg of the (K, S)
//     tables; range-dependent, the two bracketing stations' tables blended
//     with the per-step (i, w) rows of `_station_iw_rows` (:2672), as
//     `blend_station` (:275-284) does;
//   * constant or Chebyshev bottom angle;
//   * Kahan-compensated T and z, on or off;
//   * float32 only, as the Pallas kernel is.
// The step arithmetic is that of the torch-op loop
// (pygenray_tpu_torch/integrate.py:_trace_impl, the plain version held
// against this kernel), expression for expression: RK4 with the carried end
// derivative, Hermite localisation of a boundary crossing with two Newton
// iterations, the transcendental-free reflection, the Heun remainder, death
// codes 3 > 1 > 2.
//
// Design.  What the TPU kernel computes, not its layout: no (8,128) tiles,
// no edge padding, no block-level any(cross) branch, no calm/dyn/hot
// bodies (so death code 5 never occurs), no station DMA.  Each thread holds
// its ray state in registers for all nseg*sps steps and runs the crossing
// fix only when its own ray crosses a boundary.  The range-independent
// coefficient rows (K <= 256) and the bottom-angle series (Kb <= 128) sit
// in shared memory; every thread reads the same entry, so the reads are
// broadcasts.  Range-dependent rows stay in global memory: every thread of
// a block reads the same row at step k, so those reads are broadcasts too,
// served from L1 (4 x K floats a step, against ~300 operations).
// Segment mode, range-independent: the two (K, S) tables go to dynamic
// shared memory (2 K S floats: 32 KB at K = 32, 96 KB at the ladder's top
// K = 96, so the launch raises the block's dynamic limit above 48 KB).
// Segment mode, range-dependent: the stations' (nr, K, S) tables stay
// resident in device memory (512 KB per field at nr = 16, K = 32: held in
// L2) and each coefficient pick blends the two bracketing stations,
// (1 - w) T[i][k][seg] + w T[i+1][k][seg].  That is the plain version's
// blend followed by its gather, the same float32 products and sum element
// by element, so the kernel stays bit for bit equal to it without
// materialising per-step (K, S) tables (16 MB each at the rough field's
// 1,000 steps).  The alternative, a cooperative per-step blend into shared
// memory, would put two barriers in every step of a loop whose rays stop
// at different steps; blending at the pick costs two loads and three
// operations more per term and needs no barrier.  The
// per-step bathymetry b0s/b1s and the domain-exit flags xoob come from the
// wrapper, computed exactly as the plain version computes them (the flags on
// the host in float64: float32 range arithmetic must not decide deaths).
// Saves go to (nseg+1, B) outputs, neighbouring threads on neighbouring
// addresses; the wrapper transposes them to (B, nseg+1).
//
// What bounds it on an H100: FP32 issue.  At the headline fan (102,400
// rays, 490 steps, K = 16) a step costs four right-hand-side evaluations of
// two K-term series each, about 300 float operations per ray, so about
// 1.5e10 per launch.  The saves are 3 x 50 x 102,400 x 4 B ~ 61 MB and the
// per-step inputs a few kB, so memory traffic is minor.  The design keeps
// every operand in registers or shared memory to leave issue as the only
// limit.  The range-dependent segment mode adds four scattered loads per
// series term (two stations, c and dc/dz), served from L1 and L2: its
// bound on the card is operations too, but its time is set by those loads.
//
// Rounding.  Built without --use_fast_math (Kahan needs IEEE add order;
// 1/c, sqrt, sin and cos stay IEEE-accurate) and with -fmad=false, so every
// product and sum rounds on its own as in torch's separate elementwise
// kernels; rsqrtf is the reciprocal square root torch.rsqrt uses on the
// card.  The kernel then reproduces its plain version bit for bit.  The
// explicit __fmul_rn/__fadd_rn on the crossing range keep that rounding
// even where contraction is enabled.

#include <cuda_runtime.h>

#define TF_BLOCK 128
#define TF_MAX_K 256
#define TF_MAX_KB 128
#define TF_MAX_SEG_SMEM (200 * 1024)  // segment tables in shared memory, bytes (the card: 227 KB)
#define TF_TINY 1e-30f
#define TF_DEG2RAD 0.017453292519943295f  // float32(pi / 180)

namespace {

struct Params {
  int B, K, Kb, nseg, sps;
  int bangle_cheb, term_back, kahan, any_x_oob;
  float x0, h;          // range origin and step [m]
  float zlo_m, zhi_p;   // depth domain widened by bbox_tol
  float sc, off;        // depth -> Chebyshev coordinate u = sc*z - off
  float sin_lim;        // vertical-ray limit on |c p|
  float s2b, c2b;       // sin/cos of twice a constant bottom angle
  float b_sum, b_span;  // bottom-angle series domain: u = (2x - sum)/span
  int S;                        // segment mode: segments a profile
  float seg_zlo, seg_hinv;      // ... t = (z - seg_zlo) * seg_hinv
  float seg_Sf;                 // ... float(S)
};

// torch.clamp semantics: NaN propagates
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float maxf(float x, float lo) {
  return (x != x || x > lo) ? x : lo;
}

__device__ __forceinline__ float clenshaw(const float* c, int K, float u) {
  float b1 = 0.0f, b2 = 0.0f;
  for (int k = K - 1; k >= 1; --k) {
    const float t = c[k] + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
  }
  return c[0] + u * b1 - b2;
}

// The profile of one stage: spectral coefficient rows (c, cp), or segment
// tables (K, S), and range-dependent the next station's tables (c2, cp2)
// with the blend weights w and omw = 1 - w.
struct Prof {
  const float* c;
  const float* cp;
  const float* c2;
  const float* cp2;
  float w, omw;
};

// where a depth falls: the series argument u, and in segment mode the
// column s of the tables (integrate._make_eval's segment branch)
struct Coord {
  float u;
  int s;
};

template <int SEG>
__device__ __forceinline__ Coord coord(const Params& P, float z) {
  if (SEG == 0) return {clampf(P.sc * z - P.off, -1.0f, 1.0f), 0};
  const float t = clampf((z - P.seg_zlo) * P.seg_hinv, 0.0f, P.seg_Sf);
  const float fl = floorf(t);
  const float segf = fl > P.seg_Sf - 1.0f ? P.seg_Sf - 1.0f : fl;  // NaN stays, as torch.clamp
  int s = (int)segf;
  s = s < 0 ? 0 : (s > P.S - 1 ? P.S - 1 : s);  // guards memory only: s is in range unless z is NaN
  return {2.0f * (t - segf) - 1.0f, s};
}

// coefficient k of one series at this ray's column
template <bool RD, int SEG>
__device__ __forceinline__ float coef(const float* t, const float* t2, float w, float omw,
                                      const Params& P, int s, int k) {
  if (SEG == 0) return t[k];
  const int j = k * P.S + s;
  if (RD) return omw * t[j] + w * t2[j];  // the plain version's blend, then its gather
  return t[j];
}

template <bool POW, bool RD, int SEG>
__device__ __forceinline__ float series(const float* t, const float* t2, float w, float omw,
                                        const Params& P, Coord q) {
  const int K = P.K;
  if (SEG == 0 ? POW : SEG == 1) {  // Horner
    float acc = 0.0f + coef<RD, SEG>(t, t2, w, omw, P, q.s, K - 1);
    for (int k = K - 2; k >= 0; --k) acc = acc * q.u + coef<RD, SEG>(t, t2, w, omw, P, q.s, k);
    return acc;
  }
  float b1 = 0.0f, b2 = 0.0f;  // Clenshaw
  for (int k = K - 1; k >= 1; --k) {
    const float tk = coef<RD, SEG>(t, t2, w, omw, P, q.s, k) + 2.0f * q.u * b1 - b2;
    b2 = b1;
    b1 = tk;
  }
  return coef<RD, SEG>(t, t2, w, omw, P, q.s, 0) + q.u * b1 - b2;
}

template <bool POW, bool RD, int SEG>
__device__ __forceinline__ float ev_c(const Prof& pr, const Params& P, float z) {
  return series<POW, RD, SEG>(pr.c, pr.c2, pr.w, pr.omw, P, coord<SEG>(P, z));
}

struct Deriv {
  float kT, kz, kp, c;
};

template <bool POW, bool RD, int SEG>
__device__ __forceinline__ Deriv rhs(const Prof& pr, const Params& P, float z, float p) {
  const Coord q = coord<SEG>(P, z);
  const float c = series<POW, RD, SEG>(pr.c, pr.c2, pr.w, pr.omw, P, q);
  const float cp = series<POW, RD, SEG>(pr.cp, pr.cp2, pr.w, pr.omw, P, q);
  const float cp2 = c * p;
  const float inv_s = rsqrtf(maxf(1.0f - cp2 * cp2, TF_TINY));
  const float invc = 1.0f / c;
  return {inv_s * invc, cp2 * inv_s, -cp * inv_s * invc * invc, c};
}

__device__ __forceinline__ float hermite(float s, float y0, float y1, float m0, float m1) {
  const float s2 = s * s;
  const float s3 = s2 * s;
  return (2.0f * s3 - 3.0f * s2 + 1.0f) * y0 + (s3 - 2.0f * s2 + s) * m0 +
         (-2.0f * s3 + 3.0f * s2) * y1 + (s3 - s2) * m1;
}

__device__ __forceinline__ float hermite_d(float s, float y0, float y1, float m0, float m1) {
  const float s2 = s * s;
  return (6.0f * s2 - 6.0f * s) * y0 + (3.0f * s2 - 4.0f * s + 1.0f) * m0 +
         (-6.0f * s2 + 6.0f * s) * y1 + (3.0f * s2 - 2.0f * s) * m1;
}

__device__ __forceinline__ void kahan_add(float& val, float& comp, float delta) {
  const float y = delta - comp;
  const float t = val + y;
  comp = (t - val) - y;
  val = t;
}

template <bool POW, bool RD, int SEG>
__global__ void __launch_bounds__(TF_BLOCK)
trace_fan_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ z0v,
                 const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                 const float* __restrict__ bacoef, const float* __restrict__ b0s,
                 const float* __restrict__ b1s, const unsigned char* __restrict__ xoob,
                 const float* __restrict__ cms, const float* __restrict__ cpms,
                 const float* __restrict__ c1s, const float* __restrict__ cp1s,
                 const int* __restrict__ st_i, const float* __restrict__ st_w,
                 float* __restrict__ ts, float* __restrict__ zs, float* __restrict__ ps,
                 int* __restrict__ n_surf_out, int* __restrict__ n_bott_out,
                 int* __restrict__ death_out, int* __restrict__ dseg_out) {
  // spectral: the initial right-hand side's rows (every step's,
  // range-independent); segment, range-independent: the (K, S) tables
  __shared__ float s_c[TF_MAX_K];
  __shared__ float s_cp[TF_MAX_K];
  __shared__ float s_ba[TF_MAX_KB];
  extern __shared__ float s_tab[];  // segment, range-independent: 2 K S floats
  const int KS = P.K * P.S;
  if (SEG == 0) {
    for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
      s_c[k] = ccoef[k];
      s_cp[k] = cpcoef[k];
    }
  } else if (!RD) {
    for (int j = threadIdx.x; j < KS; j += blockDim.x) {
      s_tab[j] = ccoef[j];
      s_tab[KS + j] = cpcoef[j];
    }
  }
  for (int k = threadIdx.x; k < P.Kb; k += blockDim.x) s_ba[k] = bacoef[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.B) return;
  const int B = P.B;
  const float hs = P.h;
  const float h6 = hs / 6.0f;

  // the profile of a stage: spectral rows (row k of the per-step tables,
  // range-dependent), or segment tables (the two stations of interval
  // st_i[j] with weight st_w[j], range-dependent; j = 0 at the launch
  // range, 2k + 1 and 2k + 2 at step k's middle and end)
  auto seg_prof = [&](int j) -> Prof {
    if (!RD) return {s_tab, s_tab + KS, nullptr, nullptr, 0.0f, 1.0f};
    const size_t st = (size_t)st_i[j] * KS;
    const float w = st_w[j];
    return {ccoef + st, cpcoef + st, ccoef + st + KS, cpcoef + st + KS, w, 1.0f - w};
  };
  const Prof prof0 = SEG ? seg_prof(0) : Prof{s_c, s_cp, nullptr, nullptr, 0.0f, 1.0f};

  // ---- initial state ----
  const float z0 = z0v[i];
  const float p0 = p0v[i];
  float T = 0.0f, Tc = 0.0f, z = z0, zc = 0.0f, p = p0;
  Deriv k1 = rhs<POW, RD, SEG>(prof0, P, z0, p0);
  bool alive = (z0 >= P.zlo_m) && (z0 <= P.zhi_p);
  int death = alive ? 0 : 2;
  int n_surf = 0, n_bott = 0;
  int dseg = alive ? P.nseg + 1 : 0;  // first save index at which the ray is dead
  ts[i] = T;
  zs[i] = z;
  ps[i] = p;

  for (int seg = 0; seg < P.nseg; ++seg) {
    for (int k = seg * P.sps; k < (seg + 1) * P.sps; ++k) {
      if (!alive) {
        // a frozen ray still takes the compensated update with a zero
        // increment, exactly as the where()-masked plain version does
        if (P.kahan) {
          kahan_add(T, Tc, 0.0f);
          kahan_add(z, zc, 0.0f);
        }
        continue;
      }
      Prof pm, p1r;  // mid-step and end-of-step profiles
      if (SEG) {
        pm = seg_prof(2 * k + 1);
        p1r = seg_prof(2 * k + 2);
      } else {
        const size_t row = RD ? (size_t)k * P.K : 0;
        pm = {RD ? cms + row : s_c, RD ? cpms + row : s_cp, nullptr, nullptr, 0.0f, 1.0f};
        p1r = {RD ? c1s + row : s_c, RD ? cp1s + row : s_cp, nullptr, nullptr, 0.0f, 1.0f};
      }
      // ---- RK4 (k1 carried from the previous step's end derivative) ----
      const Deriv k2 = rhs<POW, RD, SEG>(pm, P, z + 0.5f * hs * k1.kz, p + 0.5f * hs * k1.kp);
      const Deriv k3 = rhs<POW, RD, SEG>(pm, P, z + 0.5f * hs * k2.kz, p + 0.5f * hs * k2.kp);
      const Deriv k4 = rhs<POW, RD, SEG>(p1r, P, z + hs * k3.kz, p + hs * k3.kp);
      const float dT = h6 * (k1.kT + 2.0f * k2.kT + 2.0f * k3.kT + k4.kT);
      const float dz = h6 * (k1.kz + 2.0f * k2.kz + 2.0f * k3.kz + k4.kz);
      const float dp = h6 * (k1.kp + 2.0f * k2.kp + 2.0f * k3.kp + k4.kp);
      const float z1 = z + dz;
      const float p1 = p + dp;

      // ---- boundary crossing ----
      const float b0 = b0s[k];
      const float b1 = b1s[k];
      const bool surf = (z1 < 0.0f) && (z >= 0.0f);
      const bool bott = (z1 > b1) && (z <= b0);
      float dT_tot = dT, dz_tot = dz, p_new = p1;
      bool back_dead = false;
      if (surf || bott) {
        // localize the crossing inside the step (cubic Hermite in s)
        const float bnd0 = surf ? 0.0f : b0;
        const float bnd1 = surf ? 0.0f : b1;
        const float db = bnd1 - bnd0;
        const float mz0 = hs * k1.kz;
        const float mz1 = hs * k4.kz;
        const float g0 = z - bnd0;
        const float g1 = z1 - bnd1;
        float f = clampf(g0 / (fabsf(g0 - g1) > TF_TINY ? g0 - g1 : 1.0f), 0.0f, 1.0f);
        for (int it = 0; it < 2; ++it) {
          const float G = hermite(f, z, z1, mz0, mz1) - (bnd0 + f * db);
          const float Gp = hermite_d(f, z, z1, mz0, mz1) - db;
          f = clampf(f - G / (fabsf(Gp) > TF_TINY ? Gp : 1.0f), 0.0f, 1.0f);
        }
        // state at the crossing
        const float t_off = hermite(f, 0.0f, dT, hs * k1.kT, hs * k4.kT);
        const float z_c = hermite(f, z, z1, mz0, mz1);
        const float p_c = hermite(f, p, p1, hs * k1.kp, hs * k4.kp);
        // reflect (sin θ' = sin 2β cos θ - cos 2β sin θ, sin θ = c p)
        const float c_c = ev_c<POW, RD, SEG>(pm, P, z_c);
        const float sin_th = clampf(p_c * c_c, -1.0f, 1.0f);
        const float cos_th = sqrtf(maxf(1.0f - sin_th * sin_th, 0.0f));
        float s2b = P.s2b, c2b = P.c2b;
        if (P.bangle_cheb) {
          // crossing range in float32, rounded op by op like the plain version
          const float x0k = __fadd_rn(P.x0, __fmul_rn((float)k, hs));
          const float x_c = __fadd_rn(x0k, __fmul_rn(f, hs));
          const float ub = clampf((2.0f * x_c - P.b_sum) / P.b_span, -1.0f, 1.0f);
          const float b2 = 2.0f * (clenshaw(s_ba, P.Kb, ub) * TF_DEG2RAD);
          s2b = sinf(b2);
          c2b = cosf(b2);
        }
        const float p_ref = surf ? -p_c : (s2b * cos_th - c2b * sin_th) / c_c;
        back_dead = P.term_back && bott && (c2b * cos_th + s2b * sin_th < -1e-9f);
        // re-integrate the remainder of the step from the crossing (Heun)
        const float hr = (1.0f - f) * hs;
        const Deriv r1 = rhs<POW, RD, SEG>(pm, P, z_c, p_ref);
        const Deriv r2 = rhs<POW, RD, SEG>(p1r, P, z_c + hr * r1.kz, p_ref + hr * r1.kp);
        if (!back_dead) {
          dT_tot = t_off + hr * 0.5f * (r1.kT + r2.kT);
          dz_tot = (z_c + hr * 0.5f * (r1.kz + r2.kz)) - z;
          p_new = p_ref + hr * 0.5f * (r1.kp + r2.kp);
        }
        n_surf += surf;
        n_bott += bott;
      }

      // ---- accumulate ----
      if (P.kahan) {
        kahan_add(T, Tc, dT_tot);
        kahan_add(z, zc, dz_tot);
      } else {
        T = T + dT_tot;
        z = z + dz_tot;
      }
      p = p_new;

      // ---- end-of-step derivative (next step's k1) + death checks ----
      k1 = rhs<POW, RD, SEG>(p1r, P, z, p);
      const bool vert = fabsf(k1.c * p) > P.sin_lim;
      const bool oob = (z > P.zhi_p) || (z < P.zlo_m) || (P.any_x_oob && xoob[k]);
      death = back_dead ? 3 : (vert ? 1 : (oob ? 2 : death));
      alive = !(vert || oob || back_dead);
    }
    // compensated readout: comp holds the overshoot, so val - comp
    const size_t row = (size_t)(seg + 1) * B + i;
    ts[row] = T - Tc;
    zs[row] = z - zc;
    ps[row] = p;
    if (!alive && dseg > seg + 1) dseg = seg + 1;
  }
  n_surf_out[i] = n_surf;
  n_bott_out[i] = n_bott;
  death_out[i] = death;
  dseg_out[i] = dseg;
}

template <bool POW, bool RD, int SEG>
int launch(const Params& P, cudaStream_t s, const float* p0, const float* z0, const float* ccoef,
           const float* cpcoef, const float* bacoef, const float* b0s, const float* b1s,
           const unsigned char* xoob, const float* cms, const float* cpms, const float* c1s,
           const float* cp1s, const int* st_i, const float* st_w, float* ts, float* zs, float* ps,
           int* n_surf, int* n_bott, int* death, int* dseg) {
  const dim3 grid((P.B + TF_BLOCK - 1) / TF_BLOCK);
  // segment mode, range-independent: both (K, S) tables in dynamic shared
  // memory; above 48 KB a block may take it only once the limit is raised
  const size_t smem = (SEG && !RD) ? 2 * (size_t)P.K * P.S * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trace_fan_kernel<POW, RD, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trace_fan_kernel<POW, RD, SEG><<<grid, TF_BLOCK, smem, s>>>(
      P, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, st_i, st_w, ts, zs,
      ps, n_surf, n_bott, death, dseg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int trace_fan_f32(const float* p0, const float* z0, const float* ccoef,
                             const float* cpcoef, const float* bacoef, const float* b0s,
                             const float* b1s, const unsigned char* xoob, const float* cms,
                             const float* cpms, const float* c1s, const float* cp1s,
                             const int* st_i, const float* st_w, float* ts, float* zs, float* ps,
                             int* n_surf, int* n_bott, int* death, int* dseg, int B, int K,
                             int Kb, int nseg, int sps, int use_pow, int bangle_cheb,
                             int term_back, int kahan, int seg, int S, float seg_zlo,
                             float seg_hinv, int any_x_oob, int rd, float x0, float h,
                             float zlo_m, float zhi_p, float sc, float off, float sin_lim,
                             float s2b, float c2b, float b_sum, float b_span, void* stream) {
  if (B <= 0 || K < 1 || Kb < 1 || Kb > TF_MAX_KB || nseg < 1 || sps < 1 || seg < 0 || seg > 2)
    return (int)cudaErrorInvalidValue;
  if (seg == 0 && (K > TF_MAX_K || (rd && !(cms && cpms && c1s && cp1s))))
    return (int)cudaErrorInvalidValue;
  if (seg != 0 && (S < 1 || (rd && !(st_i && st_w)) || (!rd && 2 * (size_t)K * S * sizeof(float) > TF_MAX_SEG_SMEM)))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.B = B;
  P.K = K;
  P.Kb = Kb;
  P.nseg = nseg;
  P.sps = sps;
  P.bangle_cheb = bangle_cheb;
  P.term_back = term_back;
  P.kahan = kahan;
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
  P.S = seg ? S : 1;
  P.seg_zlo = seg_zlo;
  P.seg_hinv = seg_hinv;
  P.seg_Sf = (float)P.S;
  cudaStream_t s = (cudaStream_t)stream;
#define TF_ARGS \
  P, s, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, st_i, st_w, ts, zs, \
      ps, n_surf, n_bott, death, dseg
  if (seg == 1) return rd ? launch<false, true, 1>(TF_ARGS) : launch<false, false, 1>(TF_ARGS);
  if (seg == 2) return rd ? launch<false, true, 2>(TF_ARGS) : launch<false, false, 2>(TF_ARGS);
  if (use_pow) return rd ? launch<true, true, 0>(TF_ARGS) : launch<true, false, 0>(TF_ARGS);
  return rd ? launch<false, true, 0>(TF_ARGS) : launch<false, false, 0>(TF_ARGS);
#undef TF_ARGS
}
