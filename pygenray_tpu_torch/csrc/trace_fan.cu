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
// fix only when its own ray crosses a boundary.  A right-hand side
// evaluates its two series (c and dc/dz) in one loop: each recurrence keeps
// its own operations in their order, so the bits are those of two loops,
// and the two dependent chains (a Clenshaw term is a multiply and two adds
// after the last) overlap.  Spectral K = 16, 32 and 64, the lengths the main
// paths use, and the segment fit ladders' K (8, 12, 16, 24 Horner; 32, 48,
// 64, 96 Clenshaw) are compiled with K fixed; other K run the same loop
// with K read at run time.  The range-independent coefficient rows (K <=
// 256) and the bottom-angle series (Kb <= 128) sit in shared memory; every
// thread reads the same entry, so the reads are broadcasts.
// Spectral, range-dependent (B1c): the wrapper hands the kernel the
// stations' (nr, K) tables and the station interval (i, w) of the launch
// range and of each step's middle and end (integrate._station_iw_rows),
// not per-step rows.  The tables go to shared memory (to global memory,
// read through L1, if 2 nr K floats would not fit beside the rows); the
// block blends step k + 1's four rows (mid-step and step-end c and dc/dz,
// (1 - w) t[i] + w t[i + 1]: integrate._blend_rows' expression, float for
// float) into one half of a double buffer while it steps with step k's
// rows from the other half, and the station intervals of step k + 2 are
// loaded while step k runs.  One barrier a step; a dead ray, and a thread
// past the last ray, stay in the loop (frozen) so that every barrier is
// met.  So no coefficient load waits on global memory, and the wrapper
// builds no per-step rows (some twenty torch operations a call).
// Segment mode, range-independent: the two (K, S) tables go to dynamic
// shared memory (2 K S floats: 32 KB at K = 32, 96 KB at the ladder's top
// K = 96, so the launch raises the block's dynamic limit above 48 KB).
// Segment mode, range-dependent (B1d): as the TPU kernel (`blend_station`)
// and the plain version (`_blend_rows`, then a gather) do, the block blends
// each step's four (K, S) tables once: c and dc/dz at the step's middle and
// end, from the stations' (nr, K, S) tables in device memory (512 KB a
// field at nr = 16, K = 32: held in L2) with the step's (i, w), by
// `_blend_rows`' expression float for float, into shared memory, with c and
// dc/dz side by side so that one 8-byte load serves both series.  Each ray
// then picks column seg of that step's tables with no blend and no load
// from device memory inside its series loop.  The launcher picks the layout
// from (K, S) (`seg_layout`): a double buffer when two steps' tables fit
// (K <= 48 at S = 128), the block blending step k + 1 while it steps k, one
// barrier a step; one buffer up to K = 96, two barriers a step; beyond that
// (only an exact-order fit reaches it) no buffer: each pick blends the two
// stations from device memory, (1 - w) T[i][k][seg] + w T[i+1][k][seg],
// the same float32 products and sum.  At 64 to 192 KB of tables a block
// holds an SM alone, so its blocks are TF_SEG_BLOCK = 512 threads wide (16
// warps an SM, 128 blocks for 65,536 rays); dead rays and threads past the
// last ray stay in the loop so that every barrier is met.
// The per-step bathymetry b0s/b1s and the domain-exit flags
// xoob come from the wrapper, computed exactly as the plain version
// computes them (the flags on the host in float64: float32 range
// arithmetic must not decide deaths).  Saves of the block-wide modes go to
// (nseg+1, B) outputs, neighbouring threads on neighbouring addresses, and
// the wrapper transposes them to (B, nseg+1) (written by each thread as
// its own row, they cost B1c 3 % at config 1 on an H100: a block's
// threads save at the same step, then meet at its barrier).
// Spectral, range-independent (B1a, the headline fan): the coefficient
// rows go to shared memory, from where ptxas reads them once, before the
// step loop, into uniform registers, so no series term loads anything
// (read from the constant bank instead, they cost a uniform load a pair of
// terms and 11 % at the headline fan on an H100; held in registers, 2 %).
// A step issues about 530 instructions.  TF_BLOCK = 128 threads a block:
// the headline fan's 800 blocks are resident at once, 6 or 7 on an SM, and
// the busiest SM sub-partition holds 7 warps whatever the block size
// (3,200 warps > 6 x 528; one warp a block measured 0.3-1.1 % slower).
// Each thread writes its saves as its own row of a (B, nseg+1) output, the
// layout of the caller's TraceResult, so the wrapper copies nothing
// (PERF.md).
// Every mode: the right-hand side's clamp, max and 1/sqrt take their
// one-instruction forms (max_nan, min_nan, rsqrt_normal).
//
// What bounds it on an H100.  At the headline fan and config 1 (102,400
// rays, 490 and 980 steps, K = 16) FP32 issue: a step costs four
// right-hand-side evaluations of two K-term series each, about 370 float
// operations per ray, so about 1.9e10 per launch; the saves are 3 x 51 x
// 102,400 x 4 B ~ 63 MB and the per-step inputs a few kB, so memory
// traffic is minor.  At the inversion's 2-save forward (128 rays, 300
// steps, K = 32) one block holds every ray and the time is one thread's
// dependent chain: four right-hand sides in a row a step, each 31 Clenshaw
// terms of about 12 cycles with the two series overlapped (PERF.md).  The
// range-dependent segment mode at the rough field (65,536 rays x 1,000
// steps, K = 32) is bound by operations too: about 1,170 a ray-step, one
// 8-byte shared-memory load a series term, and the block's blend of 4 K S
// entries a step shared by its 512 rays.
//
// Rounding.  Built without --use_fast_math (Kahan needs IEEE add order;
// 1/c, sqrt, sin and cos stay IEEE-accurate) and with -fmad=false, so every
// product and sum rounds on its own as in torch's separate elementwise
// kernels; rsqrt_normal gives, for the normal arguments it gets, the bits
// of rsqrtf, the reciprocal square root torch.rsqrt uses on the card.  The
// kernel then reproduces its plain version bit for bit.  The
// explicit __fmul_rn/__fadd_rn on the crossing range keep that rounding
// even where contraction is enabled.

#include <cuda_runtime.h>

#include <cstdint>

#define TF_BLOCK 128
#define TF_SEG_BLOCK 512  // segment mode, range-dependent, step tables in shared memory
#define TF_MAX_K 256
#define TF_MAX_KB 128
#define TF_MAX_SEG_SMEM (200 * 1024)  // segment tables in shared memory, bytes (the card: 227 KB)
#define TF_SEG_S 128  // segments a profile in the shared-memory layouts (ops/seg.py SEG_S)
// segment mode, range-dependent: where a step's blended tables go (seg_layout)
#define TF_SEG_PICK 0    // nowhere: each pick blends the two stations from device memory
#define TF_SEG_DOUBLE 1  // two buffers in shared memory, one barrier a step
#define TF_SEG_SINGLE 2  // one buffer in shared memory, two barriers a step
#define TF_TINY 1e-30f
#define TF_DEG2RAD 0.017453292519943295f  // float32(pi / 180)

namespace {

struct Params {
  int B, K, Kb, nseg, sps;
  int nr, tab_smem;     // range-dependent spectral: stations; tables in shared memory
  int seg_double;       // segment, range-dependent: two buffers of step tables
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

// segment mode, range-dependent: the layout of a step's blended tables for
// (K, S) (ops/stepper.seg_layout mirrors it): two buffers of the step's
// four (K, S) tables in shared memory when they fit, else one, else none
__host__ int seg_layout(int K, int S) {
  const size_t step = 4 * (size_t)K * S * sizeof(float);
  if (S != TF_SEG_S) return TF_SEG_PICK;
  if (2 * step <= TF_MAX_SEG_SMEM) return TF_SEG_DOUBLE;
  if (step <= TF_MAX_SEG_SMEM) return TF_SEG_SINGLE;
  return TF_SEG_PICK;
}

// torch.clamp semantics: NaN propagates
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float maxf(float x, float lo) {
  return (x != x || x > lo) ? x : lo;
}

// the spectral coordinate's clamp to [-1, 1] and a right-hand side's maxf
// in two and one instructions (max.NaN, min.NaN: a NaN in gives a NaN out,
// the values of the two above otherwise), and rsqrtf of a normal number
// without the subnormal scaling (the same bits: MUFU.RSQ), where they take
// three, three and four; a right-hand side's argument of 1/sqrt is
// >= TF_TINY, normal
__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
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
// tables (K, S), and picked range-dependent the next station's tables (c2,
// cp2) with the blend weights w and omw = 1 - w; or (SB) the step's blended
// (K, S) table of {c, dc/dz} pairs.
struct Prof {
  const float* c = nullptr;
  const float* cp = nullptr;
  const float* c2 = nullptr;
  const float* cp2 = nullptr;
  float w = 0.0f, omw = 1.0f;
  const float2* cc = nullptr;
};

// where a depth falls: the series argument u, and in segment mode the
// column s of the tables (integrate._make_eval's segment branch)
struct Coord {
  float u;
  int s;
};

template <int SEG>
__device__ __forceinline__ Coord coord(const Params& P, float z) {
  if (SEG == 0) return {max_nan(min_nan(P.sc * z - P.off, 1.0f), -1.0f), 0};
  const float t = clampf((z - P.seg_zlo) * P.seg_hinv, 0.0f, P.seg_Sf);
  const float fl = floorf(t);
  const float segf = fl > P.seg_Sf - 1.0f ? P.seg_Sf - 1.0f : fl;  // NaN stays, as torch.clamp
  int s = (int)segf;
  s = s < 0 ? 0 : (s > P.S - 1 ? P.S - 1 : s);  // guards memory only: s is in range unless z is NaN
  return {2.0f * (t - segf) - 1.0f, s};
}

// coefficient k of both series (c, dc/dz) at this ray's column; a caller
// that uses one series leaves the other's loads to dead-code elimination
template <bool RD, int SEG, bool SB>
__device__ __forceinline__ float2 coef(const Prof& pr, const Params& P, int s, int k) {
  if (SB) return pr.cc[k * TF_SEG_S + s];  // the step's table, blended by the block
  if (SEG == 0) return make_float2(pr.c[k], pr.cp[k]);
  const int j = k * P.S + s;
  if (RD)  // the plain version's blend, then its gather
    return make_float2(pr.omw * pr.c[j] + pr.w * pr.c2[j], pr.omw * pr.cp[j] + pr.w * pr.cp2[j]);
  return make_float2(pr.c[j], pr.cp[j]);
}

// the c series at q (K = KC when KC > 0, else P.K)
template <bool POW, bool RD, int SEG, int KC, bool SB>
__device__ __forceinline__ float series(const Prof& pr, const Params& P, Coord q) {
  const int K = KC > 0 ? KC : P.K;
  if (SEG == 0 ? POW : SEG == 1) {  // Horner
    float acc = 0.0f + coef<RD, SEG, SB>(pr, P, q.s, K - 1).x;
    for (int k = K - 2; k >= 0; --k) acc = acc * q.u + coef<RD, SEG, SB>(pr, P, q.s, k).x;
    return acc;
  }
  float b1 = 0.0f, b2 = 0.0f;  // Clenshaw
  for (int k = K - 1; k >= 1; --k) {
    const float tk = coef<RD, SEG, SB>(pr, P, q.s, k).x + 2.0f * q.u * b1 - b2;
    b2 = b1;
    b1 = tk;
  }
  return coef<RD, SEG, SB>(pr, P, q.s, 0).x + q.u * b1 - b2;
}

// the c and dc/dz series at q in one loop: each recurrence keeps its own
// operations in their order (the bits of two separate loops), and the two
// independent chains overlap
template <bool POW, bool RD, int SEG, int KC, bool SB>
__device__ __forceinline__ void series2(const Prof& pr, const Params& P, Coord q, float& c,
                                        float& cp) {
  const int K = KC > 0 ? KC : P.K;
  if (SEG == 0 ? POW : SEG == 1) {  // Horner
    const float2 v = coef<RD, SEG, SB>(pr, P, q.s, K - 1);
    float a = 0.0f + v.x;
    float d = 0.0f + v.y;
    for (int k = K - 2; k >= 0; --k) {
      const float2 vk = coef<RD, SEG, SB>(pr, P, q.s, k);
      a = a * q.u + vk.x;
      d = d * q.u + vk.y;
    }
    c = a;
    cp = d;
    return;
  }
  float b1 = 0.0f, b2 = 0.0f, e1 = 0.0f, e2 = 0.0f;  // Clenshaw
  for (int k = K - 1; k >= 1; --k) {
    const float2 vk = coef<RD, SEG, SB>(pr, P, q.s, k);
    const float tk = vk.x + 2.0f * q.u * b1 - b2;
    b2 = b1;
    b1 = tk;
    const float sk = vk.y + 2.0f * q.u * e1 - e2;
    e2 = e1;
    e1 = sk;
  }
  const float2 v0 = coef<RD, SEG, SB>(pr, P, q.s, 0);
  c = v0.x + q.u * b1 - b2;
  cp = v0.y + q.u * e1 - e2;
}

template <bool POW, bool RD, int SEG, int KC, bool SB>
__device__ __forceinline__ float ev_c(const Prof& pr, const Params& P, float z) {
  return series<POW, RD, SEG, KC, SB>(pr, P, coord<SEG>(P, z));
}

struct Deriv {
  float kT, kz, kp, c;
};

template <bool POW, bool RD, int SEG, int KC, bool SB>
__device__ __forceinline__ Deriv rhs(const Prof& pr, const Params& P, float z, float p) {
  float c, cp;
  series2<POW, RD, SEG, KC, SB>(pr, P, coord<SEG>(P, z), c, cp);
  const float cp2 = c * p;
  const float inv_s = rsqrt_normal(max_nan(1.0f - cp2 * cp2, TF_TINY));
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

// rows of one step, made by the block from the station tables: mid-step c
// and dc/dz at the interval (im, wm), step-end c and dc/dz at (i1, w1),
// each (1 - w) t[i] + w t[i + 1] (integrate._blend_rows' expression), into
// buf[0 .. 4K)
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

// (1 - w) a + w b entry by entry, omw = 1 - w
__device__ __forceinline__ float4 lerp4(float omw, float w, float4 a, float4 b) {
  return make_float4(omw * a.x + w * b.x, omw * a.y + w * b.y, omw * a.z + w * b.z,
                     omw * a.w + w * b.w);
}

// segment mode, range-dependent: one step's tables, made by the block from
// the stations' (nr, K, S) tables ct (c) and cpt (dc/dz): the mid-step
// table at the interval (im, wm) into buf[0 .. KS) and the step-end table
// at (i1, w1) into buf[KS .. 2 KS), entry k S + s the pair {c, dc/dz}, each
// (1 - w) t[i] + w t[i + 1] (integrate._blend_rows' expression).  Four
// entries a thread at a time, as 16-byte loads; when the step's middle and
// end share their interval (most steps) one set of loads serves both.
__device__ __forceinline__ void blend_seg_step(const float* ct, const float* cpt, int KS, int im,
                                               float wm, int i1, float w1, float2* buf) {
  const int n4 = KS >> 2;
  const float4* c4 = reinterpret_cast<const float4*>(ct);
  const float4* p4 = reinterpret_cast<const float4*>(cpt);
  const float om = 1.0f - wm, o1 = 1.0f - w1;
  const bool same = i1 == im;
  float4* out = reinterpret_cast<float4*>(buf);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const size_t jm = (size_t)im * n4 + q, j1 = (size_t)i1 * n4 + q;
    const float4 a = c4[jm], b = c4[jm + n4], pa = p4[jm], pb = p4[jm + n4];
    const float4 mc = lerp4(om, wm, a, b), md = lerp4(om, wm, pa, pb);
    const float4 ec = same ? lerp4(o1, w1, a, b) : lerp4(o1, w1, c4[j1], c4[j1 + n4]);
    const float4 ed = same ? lerp4(o1, w1, pa, pb) : lerp4(o1, w1, p4[j1], p4[j1 + n4]);
    out[2 * q] = make_float4(mc.x, md.x, mc.y, md.y);
    out[2 * q + 1] = make_float4(mc.z, md.z, mc.w, md.w);
    out[2 * n4 + 2 * q] = make_float4(ec.x, ed.x, ec.y, ed.y);
    out[2 * n4 + 2 * q + 1] = make_float4(ec.z, ed.z, ec.w, ed.w);
  }
}

template <bool POW, bool RD, int SEG, int KC, bool SB>
__global__ void __launch_bounds__(SB ? TF_SEG_BLOCK : TF_BLOCK)
trace_fan_kernel(Params P, const float* __restrict__ p0v, const float* __restrict__ z0v,
                 const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                 const float* __restrict__ bacoef, const float* __restrict__ b0s,
                 const float* __restrict__ b1s, const unsigned char* __restrict__ xoob,
                 const int* __restrict__ st_i, const float* __restrict__ st_w,
                 float* __restrict__ ts, float* __restrict__ zs, float* __restrict__ ps,
                 int* __restrict__ n_surf_out, int* __restrict__ n_bott_out,
                 int* __restrict__ death_out, int* __restrict__ dseg_out) {
  // spectral, range-dependent: the stations' rows are blended here, step by
  // step, by the whole block; segment, range-dependent (SB): the stations'
  // tables likewise.  The threads stay in the loop together (BLK).
  constexpr bool SR = RD && SEG == 0;
  constexpr bool BLK = SR || SB;
  // spectral: the initial right-hand side's rows (every step's,
  // range-independent)
  __shared__ float s_c[TF_MAX_K];
  __shared__ float s_cp[TF_MAX_K];
  __shared__ float s_ba[TF_MAX_KB];
  // segment, range-independent: the (K, S) tables, 2 K S floats; spectral,
  // range-dependent: the (nr, K) station tables when they fit, then a
  // double buffer of step rows (2, 4K); segment, range-dependent (SB): one
  // or two buffers of a step's tables (2 K S {c, dc/dz} pairs each)
  extern __shared__ __align__(16) float s_tab[];
  const int K = KC > 0 ? KC : P.K;
  const int KS = P.K * P.S;
  const int nsteps = P.nseg * P.sps;
  const float* ctab = ccoef;
  const float* cptab = cpcoef;
  float* s_buf = s_tab;
  float2* const s_seg = reinterpret_cast<float2*>(s_tab);
  const bool dbl = SR || P.seg_double;  // BLK: step k + 1 blended while step k runs
  int nim = 0, ni1 = 0;  // BLK: the station intervals of the next step to blend
  float nwm = 0.0f, nw1 = 0.0f;
  auto next_iw = [&](int k) {  // BLK: step k's intervals, if there is a step k
    if (k < nsteps) {
      nim = st_i[2 * k + 1];
      nwm = st_w[2 * k + 1];
      ni1 = st_i[2 * k + 2];
      nw1 = st_w[2 * k + 2];
    }
  };
  if (SR) {
    if (P.tab_smem) {
      for (int q = threadIdx.x; q < P.nr * K; q += blockDim.x) {
        s_tab[q] = ccoef[q];
        s_tab[P.nr * K + q] = cpcoef[q];
      }
      __syncthreads();
      ctab = s_tab;
      cptab = s_tab + P.nr * K;
      s_buf = s_tab + 2 * P.nr * K;
    }
    // the launch range's rows, and step 0's
    const int i0 = st_i[0];
    const float w0 = st_w[0];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      s_c[k] = (1.0f - w0) * ctab[i0 * K + k] + w0 * ctab[(i0 + 1) * K + k];
      s_cp[k] = (1.0f - w0) * cptab[i0 * K + k] + w0 * cptab[(i0 + 1) * K + k];
    }
    blend_step(ctab, cptab, K, st_i[1], st_w[1], st_i[2], st_w[2], s_buf);
    next_iw(1);
  } else if (SB) {
    // the launch range's tables (both halves of the first buffer)
    blend_seg_step(ccoef, cpcoef, KS, st_i[0], st_w[0], st_i[0], st_w[0], s_seg);
  } else if (SEG == 0) {
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
  if (!BLK && i >= P.B) return;
  const bool act = i < P.B;  // BLK: a masked thread still blends and meets the barriers
  // save j at sv + j * svs: range-independent spectral (B1a), this ray's row
  // of a (B, nseg+1) grid; the block-wide modes, column i of (nseg+1, B)
  constexpr bool ROWS = SEG == 0 && !RD;
  const size_t sv = ROWS ? (size_t)i * (P.nseg + 1) : i, svs = ROWS ? 1 : P.B;
  const float hs = P.h;
  const float h6 = hs / 6.0f;

  // the profile of a stage, segment mode without the block's tables: the
  // (K, S) tables, range-independent, or the two stations of interval
  // st_i[j] with weight st_w[j], range-dependent (j = 0 at the launch
  // range, 2k + 1 and 2k + 2 at step k's middle and end)
  auto seg_prof = [&](int j) -> Prof {
    if (!RD) return {s_tab, s_tab + KS};
    const size_t st = (size_t)st_i[j] * KS;
    const float w = st_w[j];
    return {ccoef + st, cpcoef + st, ccoef + st + KS, cpcoef + st + KS, w, 1.0f - w};
  };
  Prof prof0;
  if (SB) {
    prof0.cc = s_seg;
  } else if (SEG) {
    prof0 = seg_prof(0);
  } else {
    prof0.c = s_c;
    prof0.cp = s_cp;
  }

  // ---- initial state ----
  const float z0 = act ? z0v[i] : 0.0f;
  const float p0 = act ? p0v[i] : 0.0f;
  float T = 0.0f, Tc = 0.0f, z = z0, zc = 0.0f, p = p0;
  Deriv k1 = rhs<POW, RD, SEG, KC, SB>(prof0, P, z0, p0);
  bool alive = act && (z0 >= P.zlo_m) && (z0 <= P.zhi_p);
  int death = alive ? 0 : 2;
  int n_surf = 0, n_bott = 0;
  int dseg = alive ? P.nseg + 1 : 0;  // first save index at which the ray is dead
  if (act) {
    ts[sv] = T;
    zs[sv] = z;
    ps[sv] = p;
  }
  if (SB) {  // step 0's tables over the launch range's, once all have read those
    __syncthreads();
    blend_seg_step(ccoef, cpcoef, KS, st_i[1], st_w[1], st_i[2], st_w[2], s_seg);
    next_iw(1);
    __syncthreads();
  }

  for (int seg = 0; seg < P.nseg; ++seg) {
    for (int k = seg * P.sps; k < (seg + 1) * P.sps; ++k) {
      const float* rows = s_buf + (k & 1) * 4 * K;  // SR: step k's rows
      const float2* srows = s_seg + (dbl ? (k & 1) * 2 * KS : 0);  // SB: step k's tables
      if (BLK && dbl && k + 1 < nsteps) {  // step k + 1's into the other half
        if (SR)
          blend_step(ctab, cptab, K, nim, nwm, ni1, nw1, s_buf + ((k + 1) & 1) * 4 * K);
        else
          blend_seg_step(ccoef, cpcoef, KS, nim, nwm, ni1, nw1, s_seg + ((k + 1) & 1) * 2 * KS);
        next_iw(k + 2);
      }
      if (!alive) {
        // a frozen ray still takes the compensated update with a zero
        // increment, exactly as the where()-masked plain version does
        if (P.kahan) {
          kahan_add(T, Tc, 0.0f);
          kahan_add(z, zc, 0.0f);
        }
      } else {
        Prof pm, p1r;  // mid-step and end-of-step profiles
        if (SB) {
          pm.cc = srows;
          p1r.cc = srows + KS;
        } else if (SEG) {
          pm = seg_prof(2 * k + 1);
          p1r = seg_prof(2 * k + 2);
        } else {
          pm = {RD ? rows : s_c, RD ? rows + K : s_cp};
          p1r = {RD ? rows + 2 * K : s_c, RD ? rows + 3 * K : s_cp};
        }
        // ---- RK4 (k1 carried from the previous step's end derivative) ----
        const Deriv k2 =
            rhs<POW, RD, SEG, KC, SB>(pm, P, z + 0.5f * hs * k1.kz, p + 0.5f * hs * k1.kp);
        const Deriv k3 =
            rhs<POW, RD, SEG, KC, SB>(pm, P, z + 0.5f * hs * k2.kz, p + 0.5f * hs * k2.kp);
        const Deriv k4 = rhs<POW, RD, SEG, KC, SB>(p1r, P, z + hs * k3.kz, p + hs * k3.kp);
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
          const float c_c = ev_c<POW, RD, SEG, KC, SB>(pm, P, z_c);
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
          const Deriv r1 = rhs<POW, RD, SEG, KC, SB>(pm, P, z_c, p_ref);
          const Deriv r2 =
              rhs<POW, RD, SEG, KC, SB>(p1r, P, z_c + hr * r1.kz, p_ref + hr * r1.kp);
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
        k1 = rhs<POW, RD, SEG, KC, SB>(p1r, P, z, p);
        const bool vert = fabsf(k1.c * p) > P.sin_lim;
        const bool oob = (z > P.zhi_p) || (z < P.zlo_m) || (P.any_x_oob && xoob[k]);
        death = back_dead ? 3 : (vert ? 1 : (oob ? 2 : death));
        alive = !(vert || oob || back_dead);
      }
      if (BLK) {
        __syncthreads();  // step k's rows read (double: step k + 1's written)
        if (!dbl && k + 1 < nsteps) {  // one buffer: step k + 1's tables over step k's
          blend_seg_step(ccoef, cpcoef, KS, nim, nwm, ni1, nw1, s_seg);
          next_iw(k + 2);
          __syncthreads();
        }
      }
    }
    if (act) {
      // compensated readout: comp holds the overshoot, so val - comp
      const size_t o = sv + (seg + 1) * svs;
      ts[o] = T - Tc;
      zs[o] = z - zc;
      ps[o] = p;
    }
    if (!alive && dseg > seg + 1) dseg = seg + 1;
  }
  if (!act) return;
  n_surf_out[i] = n_surf;
  n_bott_out[i] = n_bott;
  death_out[i] = death;
  dseg_out[i] = dseg;
}

template <bool POW, bool RD, int SEG, int KC, bool SB>
int launch(const Params& P, cudaStream_t s, const float* p0, const float* z0,
           const float* ccoef, const float* cpcoef, const float* bacoef, const float* b0s,
           const float* b1s, const unsigned char* xoob, const int* st_i, const float* st_w,
           float* ts, float* zs, float* ps, int* n_surf, int* n_bott, int* death, int* dseg) {
  auto kern = trace_fan_kernel<POW, RD, SEG, KC, SB>;
  const int block = SB ? TF_SEG_BLOCK : TF_BLOCK;
  const dim3 grid((P.B + block - 1) / block);
  // segment mode, range-independent: both (K, S) tables in dynamic shared
  // memory; range-dependent (SB): one or two buffers of a
  // step's four (K, S) tables; spectral, range-dependent: the station
  // tables (when they fit) and the step rows' double buffer; above 48 KB a
  // block may take it only once the limit is raised
  const size_t KS = (size_t)P.K * P.S;
  size_t smem = 0;
  if (SEG && !RD) smem = 2 * KS * sizeof(float);
  if (SB) smem = (P.seg_double ? 2 : 1) * 4 * KS * sizeof(float);
  if (!SEG && RD) smem = (8 + (P.tab_smem ? 2 * (size_t)P.nr : 0)) * P.K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, block, smem, s>>>(P, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, st_i, st_w,
                                 ts, zs, ps, n_surf, n_bott, death, dseg);
  return (int)cudaGetLastError();
}

// K fixed at compile time for the lengths the main paths use: spectral 16,
// 32 and 64; segment, the fit ladders' orders (envdata.SEG_ORDER_LADDER,
// Horner; SEG_CHEB_LADDER, Clenshaw)
template <bool POW, bool RD, int SEG, bool SB, class... A>
int launch_k(int K, A... a) {
  if constexpr (SEG == 0) {
    switch (K) {
      case 16: return launch<POW, RD, 0, 16, SB>(a...);
      case 32: return launch<POW, RD, 0, 32, SB>(a...);
      case 64: return launch<POW, RD, 0, 64, SB>(a...);
    }
  } else if constexpr (SEG == 1) {
    switch (K) {
      case 8: return launch<POW, RD, 1, 8, SB>(a...);
      case 12: return launch<POW, RD, 1, 12, SB>(a...);
      case 16: return launch<POW, RD, 1, 16, SB>(a...);
      case 24: return launch<POW, RD, 1, 24, SB>(a...);
    }
  } else {
    switch (K) {
      case 32: return launch<POW, RD, 2, 32, SB>(a...);
      case 48: return launch<POW, RD, 2, 48, SB>(a...);
      case 64: return launch<POW, RD, 2, 64, SB>(a...);
      case 96: return launch<POW, RD, 2, 96, SB>(a...);
    }
  }
  return launch<POW, RD, SEG, 0, SB>(a...);
}

template <int SEG, class... A>
int launch_seg(int K, int rd, int layout, A... a) {
  if (!rd) return launch_k<false, false, SEG, false>(K, a...);
  if (layout == TF_SEG_PICK) return launch<false, true, SEG, 0, false>(a...);
  return launch_k<false, true, SEG, true>(K, a...);
}

}  // namespace

// segment mode, range-dependent: the layout the launcher takes for (K, S):
// 0 each pick blends from device memory, 1 two buffers of step tables in
// shared memory, 2 one buffer
extern "C" int trace_fan_seg_layout(int K, int S) { return seg_layout(K, S); }

// rd: ccoef/cpcoef are the stations' tables, (nr, K) spectral or (nr, K,
// S) segment, and st_i/st_w the station intervals of
// integrate._station_iw_rows
extern "C" int trace_fan_f32(const float* p0, const float* z0, const float* ccoef,
                             const float* cpcoef, const float* bacoef, const float* b0s,
                             const float* b1s, const unsigned char* xoob, const int* st_i,
                             const float* st_w, float* ts, float* zs, float* ps, int* n_surf,
                             int* n_bott, int* death, int* dseg, int B, int K, int Kb, int nseg,
                             int sps, int use_pow, int bangle_cheb, int term_back, int kahan,
                             int seg, int S, int nr, float seg_zlo, float seg_hinv,
                             int any_x_oob, int rd, float x0, float h, float zlo_m, float zhi_p,
                             float sc, float off, float sin_lim, float s2b, float c2b,
                             float b_sum, float b_span, void* stream) {
  if (B <= 0 || K < 1 || Kb < 1 || Kb > TF_MAX_KB || nseg < 1 || sps < 1 || seg < 0 || seg > 2 ||
      (rd && !(st_i && st_w && nr >= 2)))
    return (int)cudaErrorInvalidValue;
  if (seg == 0 && K > TF_MAX_K) return (int)cudaErrorInvalidValue;
  if (seg != 0 && (S < 1 || (!rd && 2 * (size_t)K * S * sizeof(float) > TF_MAX_SEG_SMEM)))
    return (int)cudaErrorInvalidValue;
  const int layout = seg && rd ? seg_layout(K, S) : TF_SEG_PICK;
  // the blended layouts read the station tables 16 bytes at a time
  if (layout != TF_SEG_PICK && (((uintptr_t)ccoef | (uintptr_t)cpcoef) & 15))
    return (int)cudaErrorMisalignedAddress;
  Params P;
  P.B = B;
  P.K = K;
  P.Kb = Kb;
  P.nseg = nseg;
  P.sps = sps;
  P.nr = rd ? nr : 1;
  // station tables in shared memory beside the step rows when they fit
  P.tab_smem = (2 * (size_t)P.nr + 8) * K * sizeof(float) <= TF_MAX_SEG_SMEM;
  P.seg_double = layout == TF_SEG_DOUBLE;
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
  P, s, p0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, st_i, st_w, ts, zs, ps, n_surf, \
      n_bott, death, dseg
  if (seg == 1) return launch_seg<1>(K, rd, layout, TF_ARGS);
  if (seg == 2) return launch_seg<2>(K, rd, layout, TF_ARGS);
  if (use_pow)
    return rd ? launch_k<true, true, 0, false>(K, TF_ARGS)
              : launch_k<true, false, 0, false>(K, TF_ARGS);
  return rd ? launch_k<false, true, 0, false>(K, TF_ARGS)
            : launch_k<false, false, 0, false>(K, TF_ARGS);
#undef TF_ARGS
}
