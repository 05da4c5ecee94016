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
// Design.  One thread a ray, its primal and tangent state in registers for
// all steps, c and dc/dz evaluated in one loop (tangent_step.cuh's
// `FusedRegs`, `FusedRows`), so that the two series' recurrences overlap in
// the ray's dependent chain.  K = 16, 24, 32, 48, 64 and 96 (the spectral
// fit ladder's orders + 1, envdata.py) are compiled with K fixed, so the
// series unroll; up to K = TS_REG_MAX_K a range-independent field's
// coefficients sit in registers, loaded once from shared memory (the
// receiver side's fields are K = 16), above it they are read from shared
// memory; any other K up to TS_MAX_K takes a run-time-K build.  A
// range-dependent field's per-step rows are staged into a shared-memory
// double buffer by `cp.async` copies (stage_rows.cuh, as the ensemble kernel
// does), one barrier a step: a dead ray, or a thread past B, skips the
// step's arithmetic but stays in the loop until no ray of the block is
// alive.  A dead ray is frozen: every remaining save row still receives its
// frozen state and tangent, as in the plain version, so no output is left
// unwritten.  `dseg` is the first save row at which the ray is dead (nseg +
// 1 for a survivor): alive_save[k] is k < dseg.  The save grids are (nseg+1,
// B), so that a warp writes 32 consecutive floats of one row.  Blocks of 64
// threads: the receiver side's small batches (the TL demo's 2,001 rays, the
// array response's tens of eigenrays) spread over more of the card's SMs.
// A lane pair a ray (c on one lane, dc/dz on the other, as the ensemble
// kernel) measured 36-50 % slower at the receiver side's three shapes
// (PERF.md).
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

// a range-independent field's rows: in registers up to TS_REG_MAX_K, else
// read from shared memory
template <int KC, bool REG = (KC > 0 && KC <= TS_REG_MAX_K)>
struct ConstRows {
  using type = FusedRows<KC>;
  __device__ static type load(const float* c, const float* cp) { return {c, cp}; }
};

template <int KC>
struct ConstRows<KC, true> {
  using type = FusedRegs<KC>;
  __device__ static type load(const float* c, const float* cp) { return fused_regs<KC>(c, cp); }
};

template <bool POW, bool RD, int KC>
__global__ void __launch_bounds__(TSV_BLOCK)
trace_tangent_save_kernel(Params P, int v16, const float* __restrict__ p0v,
                          const float* __restrict__ dp0v, const float* __restrict__ z0v,
                          const float* __restrict__ dz0v, const float* __restrict__ ccoef,
                          const float* __restrict__ cpcoef, const float* __restrict__ bacoef,
                          StepInputs in, SaveGrids out, int* __restrict__ n_surf_out,
                          int* __restrict__ n_bott_out, int* __restrict__ death_out,
                          int* __restrict__ dseg_out) {
  constexpr int KS = KC > 0 ? KC : TS_MAX_K;  // shared-memory row length
  const int K = KC > 0 ? KC : P.K;
  // the launch range's rows (every step's, range-independent), the
  // bottom-angle series and, range-dependent, the double buffer of step
  // rows: half (k & 1) holds step k's mid-step c, dc/dz, then step-end c,
  // dc/dz
  __shared__ float s_c[KS];
  __shared__ float s_cp[KS];
  __shared__ float s_ba[TS_MAX_KB];
  __shared__ __align__(16) float s_rows[RD ? 2 * 4 * KS : 4];
  if constexpr (RD) {
    stage_rows<KC>(in.cms, in.cpms, in.c1s, in.cp1s, 0, K, v16, s_rows);  // step 0's
    cp_async_wait_all();
  }
  load_series(P, ccoef, cpcoef, bacoef, s_c, s_cp, s_ba);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = i < P.B;
  if (!RD && !act) return;  // range-independent: no barrier follows

  const typename ConstRows<KC>::type r0 = ConstRows<KC>::load(s_c, s_cp);
  RayState s = initial_state<POW>(r0, P, act ? z0v[i] : 0.0f, act ? dz0v[i] : 0.0f,
                                  act ? p0v[i] : 0.0f, act ? dp0v[i] : 0.0f);
  s.alive = s.alive && act;
  int dseg = s.alive ? P.nseg + 1 : 0;
  if (act) save_row(out, (size_t)i, s);
  bool run = true;  // range-dependent: some ray of the block is alive
  for (int seg = 0; seg < P.nseg; ++seg) {
    const int k_end = (seg + 1) * P.sps;
    for (int k = seg * P.sps; k < k_end; ++k) {
      if constexpr (RD) {
        if (!run) break;  // the same for the whole block
        const float* cur = s_rows + (k & 1) * 4 * K;
        if (k + 1 < P.nsteps)  // step k + 1's rows into the other half
          stage_rows<KC>(in.cms, in.cpms, in.c1s, in.cp1s, (size_t)(k + 1) * K, K, v16,
                         s_rows + ((k & 1) ^ 1) * 4 * K);
        using R = FusedRows<KC>;
        if (s.alive) step_rows<POW>(P, in, R{cur, cur + K}, R{cur + 2 * K, cur + 3 * K}, s_ba, k, s);
        cp_async_wait_all();
        // step k's half read, step k + 1's written, by every thread
        run = __syncthreads_or(s.alive);
      } else {
        if (!s.alive) break;
        step_rows<POW>(P, in, r0, r0, s_ba, k, s);
      }
    }
    if (!s.alive) dseg = min(dseg, seg + 1);
    if (act) save_row(out, (size_t)(seg + 1) * P.B + i, s);
  }
  if (!act) return;
  n_surf_out[i] = s.n_surf;
  n_bott_out[i] = s.n_bott;
  death_out[i] = s.death;
  dseg_out[i] = dseg;
}

template <bool POW, bool RD, int KC>
int launch(const Params& P, int v16, cudaStream_t s, const float* p0, const float* dp0,
           const float* z0, const float* dz0, const float* ccoef, const float* cpcoef,
           const float* bacoef, const StepInputs& in, const SaveGrids& out, int* n_surf,
           int* n_bott, int* death, int* dseg) {
  const dim3 grid((P.B + TSV_BLOCK - 1) / TSV_BLOCK);
  trace_tangent_save_kernel<POW, RD, KC><<<grid, TSV_BLOCK, 0, s>>>(
      P, v16, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out, n_surf, n_bott, death, dseg);
  return (int)cudaGetLastError();
}

// K fixed at compile time for the spectral fit ladder's lengths
// (envdata.py: orders 15, 23, 31, 47, 63, 95); any other K at run time
template <bool POW, bool RD, class... A>
int launch_k(int K, A... a) {
  switch (K) {
    case 16: return launch<POW, RD, 16>(a...);
    case 24: return launch<POW, RD, 24>(a...);
    case 32: return launch<POW, RD, 32>(a...);
    case 48: return launch<POW, RD, 48>(a...);
    case 64: return launch<POW, RD, 64>(a...);
    case 96: return launch<POW, RD, 96>(a...);
  }
  return launch<POW, RD, 0>(a...);
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
  const int v16 = rd ? copy16_ok(K, cms, cpms, c1s, cp1s) : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define TSV_ARGS K, P, v16, s, p0, dp0, z0, dz0, ccoef, cpcoef, bacoef, in, out, n_surf, n_bott, \
                 death, dseg
  if (use_pow) {
    if (rd) return launch_k<true, true>(TSV_ARGS);
    return launch_k<true, false>(TSV_ARGS);
  }
  if (rd) return launch_k<false, true>(TSV_ARGS);
  return launch_k<false, false>(TSV_ARGS);
#undef TSV_ARGS
}
