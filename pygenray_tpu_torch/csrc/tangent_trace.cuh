// The whole fixed-step trace of one ray with one forward tangent: the body
// of the final-state tangent kernel (trace_tangent.cu, B2) and of the
// save-grid tangent kernel (trace_tangent_save.cu, B3).  One definition, so
// that the two cannot drift apart: B3's last save row is B2's output bit for
// bit, and B2 is B3 with one segment of all the steps, no source-depth seed
// and no save grid.
//
// Design.  One thread a ray, its primal and tangent state in registers for
// all steps, c and dc/dz evaluated in one loop (tangent_step.cuh's
// `FusedRegs`, `FusedRows`), so that the two series' recurrences overlap in
// the ray's dependent chain.  K = 16, 24, 32, 48, 64 and 96 (the spectral
// fit ladder's orders + 1, envdata.py) are compiled with K fixed
// (`with_fixed_k`), so the series unroll; up to K = TS_REG_MAX_K a
// range-independent field's coefficients sit in registers, loaded once from
// shared memory (the main paths' fields are K = 16), above it they are read
// from shared memory; any other K up to TS_MAX_K takes a run-time-K build.
// A range-dependent field's per-step rows are staged into a shared-memory
// double buffer by `cp.async` copies (stage_rows.cuh, as the ensemble kernel
// does), one barrier a step: a dead ray, or a thread past B, skips the
// step's arithmetic but stays in the loop until no ray of the block is
// alive.  A dead ray is frozen: with a save grid, every remaining save row
// still receives its frozen state and tangent, as in the plain version, so
// no output is left unwritten; `dseg` is the first save row at which the
// ray is dead (nseg + 1 for a survivor).  Blocks of TT_BLOCK = 64 threads:
// the eigenray solver's and the receiver side's batches are small (config
// 3's 156 candidates, the array response's tens of eigenrays, the TL demo's
// 2,001 rays), and small blocks spread them over more of the card's SMs.
//
// Rounding: built with -fmad=false and without fast math (ops/_build.py).
#pragma once

#include <cuda_runtime.h>

#include "stage_rows.cuh"
#include "tangent_step.cuh"

#define TT_BLOCK 64

namespace tangent_step {

// A launch's outputs.  With a save grid, T .. dp are (nseg+1, B) row-major
// (a warp writes 32 consecutive floats of one row) and dseg is (B,);
// without, T .. dp are the (B,) final state and dseg is unused.
struct TraceOut {
  float* __restrict__ T;
  float* __restrict__ z;
  float* __restrict__ p;
  float* __restrict__ dT;
  float* __restrict__ dz;
  float* __restrict__ dp;
  int* __restrict__ n_surf;
  int* __restrict__ n_bott;
  int* __restrict__ death;
  int* __restrict__ dseg;
};

__device__ __forceinline__ void write_state(const TraceOut& o, size_t at, const RayState& s) {
  o.T[at] = s.T.v;
  o.z[at] = s.z.v;
  o.p[at] = s.p.v;
  o.dT[at] = s.T.t;
  o.dz[at] = s.z.t;
  o.dp[at] = s.p.t;
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

// Trace ray blockIdx.x * blockDim.x + threadIdx.x over P.nseg segments of
// P.sps steps, seeded with (dp0, dz0) (dz0v null: no source-depth seed);
// SAVE: write the state and tangent at the launch point and after every
// segment, else only at the end.
template <bool POW, bool RD, int KC, bool SAVE>
__device__ __forceinline__ void trace_rays(const Params& P, int v16, const float* p0v,
                                           const float* dp0v, const float* z0v,
                                           const float* dz0v, const float* ccoef,
                                           const float* cpcoef, const float* bacoef,
                                           const StepInputs& in, const TraceOut& out) {
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
  RayState s = initial_state<POW>(r0, P, act ? z0v[i] : 0.0f, act && dz0v ? dz0v[i] : 0.0f,
                                  act ? p0v[i] : 0.0f, act ? dp0v[i] : 0.0f);
  s.alive = s.alive && act;
  int dseg = s.alive ? P.nseg + 1 : 0;
  if (SAVE && act) write_state(out, (size_t)i, s);
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
        if (s.alive)
          step_rows<POW>(P, in, R{cur, cur + K}, R{cur + 2 * K, cur + 3 * K}, s_ba, k, s);
        cp_async_wait_all();
        // step k's half read, step k + 1's written, by every thread
        run = __syncthreads_or(s.alive);
      } else {
        if (!s.alive) break;
        step_rows<POW>(P, in, r0, r0, s_ba, k, s);
      }
    }
    if (!s.alive) dseg = min(dseg, seg + 1);
    if (SAVE && act) write_state(out, (size_t)(seg + 1) * P.B + i, s);
  }
  if (!act) return;
  if (!SAVE) write_state(out, (size_t)i, s);
  out.n_surf[i] = s.n_surf;
  out.n_bott[i] = s.n_bott;
  out.death[i] = s.death;
  if (SAVE) out.dseg[i] = dseg;
}

// L::run<KC>(a...): KC = K for the spectral fit ladder's lengths
// (envdata.py: orders 15, 23, 31, 47, 63, 95; mirrored by ops/stepper.py's
// SAVE_FIXED_K), KC = 0 (K at run time) for any other K; B2, B3 and the
// range-independent coefficient-tangent kernel (trace_coef_tangent.cu)
template <class L, class... A>
int with_fixed_k(int K, A... a) {
  switch (K) {
    case 16: return L::template run<16>(a...);
    case 24: return L::template run<24>(a...);
    case 32: return L::template run<32>(a...);
    case 48: return L::template run<48>(a...);
    case 64: return L::template run<64>(a...);
    case 96: return L::template run<96>(a...);
  }
  return L::template run<0>(a...);
}

}  // namespace tangent_step
