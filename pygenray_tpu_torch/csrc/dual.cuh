// Forward-mode dual numbers for the tangent kernels: a value v and one
// forward tangent t, carried together through every operation.
//
// Each rule is written in the order of pygenray_tpu_torch/ops/dual.py, the
// plain version (torch ops on value and tangent tensors), so that a kernel
// built with -fmad=false reproduces it operation for operation.  A `float`
// operand is a constant (tangent 0).  The rules differentiate what jax.jvp
// differentiates in the JAX package's tangent kernel: a selection takes the
// tangent of the branch it selects, and clip/max pass the tangent inside
// their range, none outside it and half of it at a tie with a bound (JAX's
// `maximum` splits a tie 0.5/0.5).
#pragma once

#include <cuda_runtime.h>

struct Dual {
  float v, t;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.t + b.t}; }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.t}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.t}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.t - b.t}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.t}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.t}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.t * b.v + a.v * b.t};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.t * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.t}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.t - q * b.t) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.t / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return {q, -(q * b.t) / b.v};
}

// torch.clamp(x, lo, hi) (NaN propagates); tangent inside, half at a tie
__device__ __forceinline__ Dual dclip(Dual x, float lo, float hi) {
  const float v = x.v < lo ? lo : (x.v > hi ? hi : x.v);
  const bool inside = (x.v > lo) && (x.v < hi);
  const bool tie = (x.v == lo) || (x.v == hi);
  return {v, inside ? x.t : (tie ? 0.5f * x.t : 0.0f)};
}

// torch.clamp(x, min=lo)
__device__ __forceinline__ Dual dmax(Dual x, float lo) {
  const float v = (x.v != x.v || x.v > lo) ? x.v : lo;
  return {v, x.v > lo ? x.t : (x.v == lo ? 0.5f * x.t : 0.0f)};
}

__device__ __forceinline__ Dual drsqrt(Dual x) {
  const float r = rsqrtf(x.v);
  return {r, x.t * (-0.5f * (r / x.v))};
}

__device__ __forceinline__ Dual dsqrt(Dual x) {
  const float s = sqrtf(x.v);
  return {s, 0.5f * x.t / s};
}

__device__ __forceinline__ void dsincos(Dual x, Dual& s, Dual& c) {
  const float sv = sinf(x.v);
  const float cv = cosf(x.v);
  s = {sv, cv * x.t};
  c = {cv, -sv * x.t};
}

// power-basis polynomial with constant coefficients c[0..K-1] at u
__device__ __forceinline__ Dual dhorner(const float* c, int K, Dual u) {
  Dual acc = {0.0f + c[K - 1], 0.0f};
  for (int k = K - 2; k >= 0; --k) acc = acc * u + c[k];
  return acc;
}

// Chebyshev series with constant coefficients c[0..K-1] at u (Clenshaw)
__device__ __forceinline__ Dual dclenshaw(const float* c, int K, Dual u) {
  Dual b1 = {0.0f, 0.0f}, b2 = {0.0f, 0.0f};
  for (int k = K - 1; k >= 1; --k) {
    const Dual t = c[k] + 2.0f * u * b1 - b2;
    b2 = b1;
    b1 = t;
  }
  return c[0] + u * b1 - b2;
}
