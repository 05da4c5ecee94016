// Final-state ray trace with one forward tangent across an ensemble of
// environments: one launch advances every (realization, candidate) ray of a
// Monte-Carlo eigenray search, two CUDA threads (a lane pair) per ray.
//
// Replaces: the Pallas TPU ensemble tangent kernel
// `trace_pallas_tangent_ensemble` (pygenray_tpu/ops/pallas_stepper.py:1258,
// `_make_final_kernel(ens=True)` :826): the forward-tangent kernel of
// trace_tangent.cu (B2) with a realization axis.  Grid block (x, e) traces
// realization e's candidates x * 32 ... x * 32 + 31 of its (M,) launch
// parameters p0[e] and seeds dp0[e] against realization e's own per-step
// coefficient rows (range-dependent spectral fits, rows blended linearly in
// range at mid-step and step end, e's block of the (E, nsteps, K) tables)
// and its own launch-range rows (E, K).  The bathymetry, the bottom-angle
// series and the launch constants are realization 0's, as in the JAX kernel
// (:1294-1333): Monte-Carlo ensembles perturb the sound speed only.  The
// source depth is one scalar.  float32, no Kahan (the forward-AD
// convention), death codes 3 > 1 > 2.
//
// The step is tangent_step.cuh's, the one B2 and B3 call, so realization
// e's row is B2 run on realization e alone, bit for bit; the plain version
// (pygenray_tpu_torch/integrate.py:_trace_tangent_ens_impl) is B2's plain
// loop run once over the (E, M) rays, each realization on its own rows.
//
// Design.  Two lanes of a warp carry one ray (a lane pair), each keeping
// the ray's primal and tangent state in registers for all steps: the even
// lane evaluates the c series, the odd lane dc/dz (tangent_step.cuh's
// `PairRows`), and the pair swaps the results through a shuffle; the rest
// of the step both lanes compute alike.  The block stages realization e's
// rows of step k + 1 (mid-step and step-end c and dc/dz, 4 K floats, 1 KB
// at K = 64) into one half of a shared-memory double buffer with
// `cp.async` copies (16 bytes each when K is a multiple of 4 and the tables
// are 16-byte aligned, else 4) while its threads step with step k's rows
// from the other half: one `cp.async.wait_group` and one barrier a step, so
// no coefficient load of the dependent chain waits on L1 or L2.  The
// launch-range rows and the bottom-angle series sit in shared memory too
// (`load_series`).  K = 16, 24, 32, 48, 64 and 96 (the spectral fit
// ladder's orders + 1, envdata.py) are compiled with K fixed, so the loops
// unroll and the loads issue ahead of the terms that need them; any other
// K up to TS_MAX_K takes a run-time-K build.  A block's threads stay in the
// step loop together: a dead ray, or a pair past M, skips the step's
// arithmetic but still copies and meets the barrier, until no ray of the
// block is alive.  Blocks of 64 threads (32 rays): a Newton batch is a few
// candidates per realization (at most MC_BRACKET_CAP = 24), so small blocks
// spread the E realizations' blocks over more SMs.  One thread a ray with
// both series in one loop measured 12 % slower at both of config 4b's
// shapes (PERF.md).
//
// What bounds it on an H100.  At config 4b's shapes (16 realizations x 24
// Newton candidates, or x 512 fan angles, 500 steps) the card holds at most
// one warp a scheduler, so one ray's chain of 500 dependent Dual steps sets
// the time: latency, not FP32 throughput (about 2.5 times the forward
// step's operations per ray-step) and not bytes (16 x 500 x 64 x 4 x 4 B =
// 8 MB of rows, read once per launch, L2-resident after the first).  The
// design shortens that chain: the series' coefficients come from shared
// memory at fixed offsets, and a right-hand side's two series run at once
// on two lanes, each lane's chain one series long.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py),
// as trace_fan.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "tangent_step.cuh"

#define TE_BLOCK 64
#define TE_RAYS (TE_BLOCK / 2)  // rays a block: a lane pair each

namespace {

using namespace tangent_step;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one step's four rows, each K floats from offset `row` of the
// realization's (nsteps, K) tables, into buf[0 .. 4K) by asynchronous copies
// of the whole block (v16: 16 bytes a copy), as one commit group
template <int KC>
__device__ __forceinline__ void stage_rows(const float* cm, const float* cpm, const float* c1,
                                           const float* cp1, size_t row, int Kp, bool v16,
                                           float* buf) {
  const int K = KC > 0 ? KC : Kp;
  const int w = v16 ? 4 : 1;  // floats a copy
  const int n = K / w;        // copies a row
  for (int q = threadIdx.x; q < 4 * n; q += blockDim.x) {
    const int r = q / n;
    const int k = (q - r * n) * w;
    const float* src = (r == 0 ? cm : (r == 1 ? cpm : (r == 2 ? c1 : cp1))) + row + k;
    if (v16)
      cp_async16(buf + r * K + k, src);
    else
      cp_async4(buf + r * K + k, src);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool POW, int KC>
__global__ void __launch_bounds__(TE_BLOCK)
trace_tangent_ens_kernel(Params P, int v16, const float* __restrict__ p0v,
                         const float* __restrict__ dp0v, float z0,
                         const float* __restrict__ ccoef, const float* __restrict__ cpcoef,
                         const float* __restrict__ bacoef, const float* __restrict__ b0s,
                         const float* __restrict__ b1s, const unsigned char* __restrict__ xoob,
                         const float* __restrict__ cms, const float* __restrict__ cpms,
                         const float* __restrict__ c1s, const float* __restrict__ cp1s,
                         float* __restrict__ T_out, float* __restrict__ z_out,
                         float* __restrict__ p_out, float* __restrict__ dT_out,
                         float* __restrict__ dz_out, float* __restrict__ dp_out,
                         int* __restrict__ n_surf_out, int* __restrict__ n_bott_out,
                         int* __restrict__ death_out) {
  using R = PairRows<KC>;
  constexpr int KS = KC > 0 ? KC : TS_MAX_K;  // shared-memory row length
  const int K = KC > 0 ? KC : P.K;
  const int e = blockIdx.y;
  // realization e's launch-range rows, the bottom-angle series, and the
  // double buffer of step rows: half (k & 1) holds step k's mid-step c,
  // dc/dz, then step-end c, dc/dz
  __shared__ float s_c[KS];
  __shared__ float s_cp[KS];
  __shared__ float s_ba[TS_MAX_KB];
  __shared__ __align__(16) float s_rows[2 * 4 * KS];
  const size_t rows = (size_t)e * P.nsteps * K;  // realization e's per-step rows
  const float* cm = cms + rows;
  const float* cpm = cpms + rows;
  const float* c1 = c1s + rows;
  const float* cp1 = cp1s + rows;
  stage_rows<KC>(cm, cpm, c1, cp1, 0, K, v16, s_rows);  // step 0's
  cp_async_wait_all();
  load_series(P, ccoef + (size_t)e * K, cpcoef + (size_t)e * K, bacoef, s_c, s_cp, s_ba);

  const int j = blockIdx.x * TE_RAYS + threadIdx.x / 2;  // the pair's ray
  const bool act = j < P.B;
  const size_t i = (size_t)e * P.B + j;
  const StepInputs in = {b0s, b1s, xoob, nullptr, nullptr, nullptr, nullptr};

  // the launch tangent seeds p only; a dead ray is frozen; both lanes of a
  // pair step it
  RayState s = initial_state<POW>(R{s_c, s_cp}, P, z0, 0.0f, act ? p0v[i] : 0.0f,
                                  act ? dp0v[i] : 0.0f);
  s.alive = s.alive && act;
  for (int k = 0; k < P.nsteps; ++k) {
    const float* cur = s_rows + (k & 1) * 4 * K;
    if (k + 1 < P.nsteps)  // step k + 1's rows into the other half
      stage_rows<KC>(cm, cpm, c1, cp1, (size_t)(k + 1) * K, K, v16,
                     s_rows + ((k & 1) ^ 1) * 4 * K);
    if (s.alive) step_rows<POW>(P, in, R{cur, cur + K}, R{cur + 2 * K, cur + 3 * K}, s_ba, k, s);
    cp_async_wait_all();
    // step k's half read, step k + 1's written, by every thread
    if (!__syncthreads_or(s.alive)) break;
  }
  if (!act || (threadIdx.x & 1)) return;  // the even lane writes

  T_out[i] = s.T.v;
  z_out[i] = s.z.v;
  p_out[i] = s.p.v;
  dT_out[i] = s.T.t;
  dz_out[i] = s.z.t;
  dp_out[i] = s.p.t;
  n_surf_out[i] = s.n_surf;
  n_bott_out[i] = s.n_bott;
  death_out[i] = s.death;
}

template <bool POW, int KC>
int launch(const Params& P, int E, int v16, cudaStream_t s, const float* p0, const float* dp0,
           float z0, const float* ccoef, const float* cpcoef, const float* bacoef,
           const float* b0s, const float* b1s, const unsigned char* xoob, const float* cms,
           const float* cpms, const float* c1s, const float* cp1s, float* T, float* z, float* p,
           float* dT, float* dz, float* dp, int* n_surf, int* n_bott, int* death) {
  const dim3 grid((P.B + TE_RAYS - 1) / TE_RAYS, E);
  trace_tangent_ens_kernel<POW, KC><<<grid, TE_BLOCK, 0, s>>>(
      P, v16, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob, cms, cpms, c1s, cp1s, T, z, p,
      dT, dz, dp, n_surf, n_bott, death);
  return (int)cudaGetLastError();
}

// K fixed at compile time for the spectral fit ladder's lengths
// (envdata.py: orders 15, 23, 31, 47, 63, 95); any other K at run time
template <bool POW, class... A>
int launch_k(int K, A... a) {
  switch (K) {
    case 16: return launch<POW, 16>(a...);
    case 24: return launch<POW, 24>(a...);
    case 32: return launch<POW, 32>(a...);
    case 48: return launch<POW, 48>(a...);
    case 64: return launch<POW, 64>(a...);
    case 96: return launch<POW, 96>(a...);
  }
  return launch<POW, 0>(a...);
}

}  // namespace

// the K the kernel is compiled for with K fixed, and whether its step rows
// are copied 16 bytes at a time, for a launch at K whose tables start at
// the addresses cms ... cp1s: bit 0 K fixed, bit 1 16-byte copies
extern "C" int trace_tangent_ens_layout(int K, const void* cms, const void* cpms,
                                        const void* c1s, const void* cp1s) {
  const int fixed = K == 16 || K == 24 || K == 32 || K == 48 || K == 64 || K == 96;
  const uintptr_t a = (uintptr_t)cms | (uintptr_t)cpms | (uintptr_t)c1s | (uintptr_t)cp1s;
  const int v16 = K % 4 == 0 && (a & 15) == 0;
  return fixed | (v16 << 1);
}

extern "C" int trace_tangent_ens_f32(const float* p0, const float* dp0, float z0,
                                     const float* ccoef, const float* cpcoef,
                                     const float* bacoef, const float* b0s, const float* b1s,
                                     const unsigned char* xoob, const float* cms,
                                     const float* cpms, const float* c1s, const float* cp1s,
                                     float* T, float* z, float* p, float* dT, float* dz, float* dp,
                                     int* n_surf, int* n_bott, int* death, int E, int M, int K,
                                     int Kb, int nsteps, int use_pow, int bangle_cheb,
                                     int term_back, int any_x_oob, int rd, float x0, float h,
                                     float zlo_m, float zhi_p, float sc, float off, float sin_lim,
                                     float s2b, float c2b, float b_sum, float b_span,
                                     void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || K < 1 || K > TS_MAX_K || Kb < 1 || Kb > TS_MAX_KB ||
      nsteps < 1 || !rd || !(cms && cpms && c1s && cp1s))
    return (int)cudaErrorInvalidValue;
  const Params P = make_params(M, K, Kb, nsteps, nsteps, 1, bangle_cheb, term_back, any_x_oob,
                               x0, h, zlo_m, zhi_p, sc, off, sin_lim, s2b, c2b, b_sum, b_span);
  const int v16 = (trace_tangent_ens_layout(K, cms, cpms, c1s, cp1s) >> 1) & 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_pow)
    return launch_k<true>(K, P, E, v16, s, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob,
                          cms, cpms, c1s, cp1s, T, z, p, dT, dz, dp, n_surf, n_bott, death);
  return launch_k<false>(K, P, E, v16, s, p0, dp0, z0, ccoef, cpcoef, bacoef, b0s, b1s, xoob,
                         cms, cpms, c1s, cp1s, T, z, p, dT, dz, dp, n_surf, n_bott, death);
}
