// Per-step coefficient rows staged into shared memory by asynchronous
// copies (`cp.async`, sm_80 and later), shared by the tangent kernels that
// read range-dependent per-step rows: trace_tangent_ens.cu (B4) and
// trace_tangent_save.cu (B3).  A block copies step k + 1's four rows
// (mid-step c and dc/dz, then step-end c and dc/dz, each K floats) into one
// half of a double buffer while its threads step with step k's rows from the
// other half; each thread waits for its own copies and the block meets one
// barrier a step.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tangent_step {

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

// one step's four rows, each K floats from offset `row` of the (nsteps, K)
// tables, into buf[0 .. 4K) by asynchronous copies of the whole block (v16:
// 16 bytes a copy), as one commit group
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

// whether K-float rows of tables starting at a, b, c and d can be copied 16
// bytes at a time: K a multiple of 4 and every table 16-byte aligned
inline int copy16_ok(int K, const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t x = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d;
  return K % 4 == 0 && (x & 15) == 0;
}

}  // namespace tangent_step
