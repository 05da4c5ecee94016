#!/usr/bin/env python3
"""Hold the final-state and save-grid tangent kernels of two checkouts to
each other without a card: their CUDA sources built for the host by g++.

    python3 tools/host_tangent_rehearsal.py PARENT_ROOT [CHANGE_ROOT]

Each ROOT holds a ``pygenray_tpu_torch`` package (CHANGE_ROOT defaults to
this repository).  Both checkouts' ``csrc/trace_tangent.cu`` (B2) and
``csrc/trace_tangent_save.cu`` (B3) are compiled with g++
(``-ffp-contract=off``, as nvcc's ``-fmad=false``) against a stand-in
``cuda_runtime.h``: a block's threads run as ``std::thread``s, one block
at a time, ``__shared__`` is ``static``, ``__syncthreads`` a pthread
barrier and ``__syncthreads_or`` a barrier-fenced OR; ``cp.async`` copies
land at once (a step writes only the half of the double buffer no thread
reads).  Each C entry point is called through ctypes on the CPU operands
``ops/stepper._inputs`` builds, as the wrappers call them on the card.
For every case (Munk fields with K = 16 to 96 compiled fixed and two
run-time K, Horner and Clenshaw, range-dependent fields, a curved bottom, a
range exit, a seamount with death codes 1, 2 and 3; the eigenray solver's
2-save plan and a 7-save one) the change's B2 must equal the parent's B2
and both checkouts' B3 last save rows (seed dz0 = 0) bit for bit, a NaN
equal to any NaN.  Prints one line a case; exits 1 on any difference.

The host's libm rounds sin, cos and 1/sqrt apart from the card's, so the
numbers are the host build's: this checks that two versions of the kernel
code compute the same thing, not the card's values (``chip_smoke.py`` does
that).  A few seconds of g++ and about a minute of tracing.  ``build``
and its stand-in header also serve ``tools/host_fan_rehearsal.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SHIM = r"""
#pragma once
#include <pthread.h>
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 74 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct float2 { float x, y; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
using std::max;
using std::min;
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }  // B4 only
inline pthread_barrier_t g_bar;
inline std::atomic<int> g_or{0};
inline void __syncthreads() { pthread_barrier_wait(&g_bar); }
inline int __syncthreads_or(int p) {
  if (p) g_or.store(1);
  pthread_barrier_wait(&g_bar);
  const int r = g_or.load();
  pthread_barrier_wait(&g_bar);
  if (threadIdx.x == 0) g_or.store(0);
  pthread_barrier_wait(&g_bar);
  return r;
}
template <class F, class... A>
void host_launch(dim3 grid, unsigned block, size_t, cudaStream_t, F kern, A... a) {
  blockDim = dim3(block);
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      pthread_barrier_init(&g_bar, nullptr, block);
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          kern(a...);
        });
      for (auto& t : ts) t.join();
      pthread_barrier_destroy(&g_bar);
    }
}
"""


def build(root, out, names=("trace_tangent", "trace_tangent_save")):
    """Host libraries of ``root``'s kernel sources ``names`` (``csrc/<name>.cu``;
    by default B2 and B3) under ``out``: {name: path}."""
    csrc = out / "csrc"
    shutil.copytree(pathlib.Path(root) / "pygenray_tpu_torch" / "csrc", csrc)
    (out / "shim").mkdir()
    (out / "shim" / "cuda_runtime.h").write_text(SHIM)
    for f in csrc.iterdir():
        t = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(", r"host_launch(\2, \1, ",
                   f.read_text())
        # dynamic shared memory: one 256 KB array, 16-byte aligned
        t = re.sub(r"extern __shared__ (__align__\(\d+\) )?float (\w+)\[\];",
                   r"static __align__(16) float \2[1 << 16];", t)
        t = re.sub(r"(void cp_async(16|4)\(float\* dst, const float\* src\) \{).*?\n\}",
                   r"\1 memcpy(dst, src, \2); }", t, flags=re.S)
        t = re.sub(r'asm volatile\("cp\.async\.[a-z_]+ ?[0-9]*;\\n" ::: "memory"\);', "", t)
        # the fan kernel's one-instruction max, min and 1/sqrt
        t = re.sub(r'asm\("(max|min)\.NaN\.f32 %0, %1, %2;" : "=f"\(r\) : "f"\(x\), "f"\(y\)\);',
                   lambda m: "r = x != x ? x : (y != y ? y : (x %s y ? x : y));"
                   % (">" if m.group(1) == "max" else "<"), t)
        t = re.sub(r'asm\("rsqrt\.approx\.ftz\.f32 %0, %1;" : "=f"\(r\) : "f"\(x\)\);',
                   "r = rsqrtf(x);", t)
        f.write_text(t)
    libs = {}
    for name in names:
        libs[name] = out / f"lib{name}.so"
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-I", str(out / "shim"), "-x", "c++",
                        str(csrc / f"{name}.cu"), "-o", str(libs[name])], check=True)
    return libs


def main():
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    change = pathlib.Path(sys.argv[2] if len(sys.argv) == 3 else
                          pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(change))
    import torch

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
    from pygenray_tpu_torch.ops import stepper

    def entry(path, name):
        fn = getattr(ctypes.CDLL(str(path)), f"{name}_f32")
        fn.argtypes, fn.restype = stepper._ARGTYPES[f"{name}_f32"], ctypes.c_int
        return fn

    def tail(inp, g):
        c = inp.consts
        return [int(c.any_x_oob), int(inp.rd), g[0], g[2], c.zlo_m, c.zhi_p, c.sc, c.off,
                c.sin_lim, c.s2b, c.c2b, c.b_sum, c.b_span, None]

    def run(fn, save, env, z0, p0, dp0, g, s):
        inp = stepper._inputs(env, z0, p0, g, s)
        B, nseg, c = inp.p0.shape[0], g[4], inp.consts
        shape = (nseg + 1, B) if save else (B,)
        fl = tuple(torch.full(shape, -7.0) for _ in range(6))
        it = tuple(torch.full((B,), -7, dtype=torch.int32) for _ in range(4 if save else 3))
        dz0 = torch.zeros(B)  # held until the call returns
        seeds = [dp0.data_ptr(), inp.z0.data_ptr()] + ([dz0.data_ptr()] if save else [])
        dims = [nseg, g[3]] if save else [g[3] * nseg]
        err = fn(inp.p0.data_ptr(), *seeds, *inp.pointers(), *(o.data_ptr() for o in fl + it),
                 B, inp.ccoef.shape[0], inp.bacoef.shape[0], *dims, int(c.use_pow),
                 int(c.bangle_cheb), int(c.term_back), *tail(inp, g))
        if err:
            raise RuntimeError(f"entry point returned {err}")
        return tuple(a[-1] for a in fl) + it[:3] if save else fl + it

    def same(a, b):
        return all(bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
                   for x, y in zip(a, b))

    def munk(nz=2048, r_max=100e3, nr=8, bathy=None, **kw):
        z, r = np.linspace(0.0, 6000.0, nz), np.linspace(0.0, r_max, nr)
        b = np.full(nr, 5000.0) if bathy is None else bathy(r)
        return pt.make_env_data(np.outer(np.ones(nr), pt.munk_ssp(z)), r, z, b, r,
                                dtype=torch.float32, device="cpu", **kw)

    def rd(nz, order=None):
        z, r = np.linspace(0.0, 6000.0, nz), np.linspace(0.0, 100e3, 16)
        c = np.array([pt.munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r])
        kw = {} if order is None else dict(cheb_order=order, cheb_exact_order=True)
        return pt.make_env_data(c, r, z, np.linspace(4400.0, 4900.0, 16), r,
                                dtype=torch.float32, device="cpu", **kw)

    clen = lambda e: dataclasses.replace(e, poly_ok=False)
    fields = [munk(), clen(munk()), munk(nz=512), clen(munk(nz=512)),
              *(munk(nz=512, cheb_order=o, cheb_exact_order=True)
                for o in (31, 47, 63, 95, 19, 40)),
              munk(nr=32, bathy=lambda r: 4400.0 + 300.0 * np.sin(r / 30e3)),
              munk(r_max=90e3), rd(2048), rd(512), rd(512, 31), rd(512, 63), rd(512, 30)]
    rs = np.linspace(0.0, 20e3, 32)
    zs = np.linspace(0.0, 6000.0, 2048)
    seamount = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(zs)), rs, zs,
                                3200.0 + 1600.0 * np.cos(2 * np.pi * rs / 20e3), rs,
                                dtype=torch.float32, device="cpu")
    n = 150
    with tempfile.TemporaryDirectory() as tmp:
        libs = {side: build(root, pathlib.Path(tmp) / side)
                for side, root in (("parent", sys.argv[1]), ("change", change))}
        b2 = {k: entry(v["trace_tangent"], "trace_tangent") for k, v in libs.items()}
        b3 = {k: entry(v["trace_tangent_save"], "trace_tangent_save") for k, v in libs.items()}
        bad = 0
        for env in fields + [seamount]:
            deaths = env is seamount
            ang = (np.r_[np.linspace(-60.0, 60.0, n - 4), -90.0, -89.999, 89.999, 0.0]
                   if deaths else np.linspace(-18.0, 18.0, n))
            z0 = np.full(n, 1300.0)
            z0[-1] = 6500.0 if deaths else 1300.0
            c0 = float(np.interp(1300.0, env.z.numpy(), env.c[0].numpy()))
            p0 = torch.as_tensor(np.sin(np.radians(-ang)) / c0, dtype=torch.float32)
            z0 = torch.as_tensor(z0, dtype=torch.float32)
            dp0 = torch.as_tensor(np.linspace(0.5, 1.5, n), dtype=torch.float32)
            x1 = 20e3 if deaths else 100e3
            s = pt.SolverSettings(dx=100.0 if env.range_dependent else 200.0)
            for nsave in (2, 7):
                g = (0.0, x1, *_plan(0.0, x1, nsave, s.dx))
                outs = [run(b2["change"], False, env, z0, p0, dp0, g, s),
                        run(b2["parent"], False, env, z0, p0, dp0, g, s),
                        run(b3["change"], True, env, z0, p0, dp0, g, s),
                        run(b3["parent"], True, env, z0, p0, dp0, g, s)]
                ok = all(same(outs[0], o) for o in outs[1:])
                bad += not ok
                print(f"K={env.c_cheb.shape[-1]} horner={bool(env.poly_ok)} "
                      f"rd={bool(env.range_dependent)} saves={nsave} "
                      f"death_codes={sorted(set(outs[0][8].tolist()))} equal={ok}", flush=True)
    print(f"{bad} cases differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
