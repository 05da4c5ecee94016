#!/usr/bin/env python3
"""Hold the tangent kernels of two checkouts to each other without a card:
their CUDA sources built for the host by g++.

    python3 tools/host_tangent_rehearsal.py [--coef] PARENT_ROOT [CHANGE_ROOT]

Each ROOT holds a ``pygenray_tpu_torch`` package (CHANGE_ROOT defaults to
this repository).  Both checkouts' ``csrc/trace_tangent.cu`` (B2),
``csrc/trace_tangent_save.cu`` (B3) and ``csrc/trace_coef_tangent.cu`` (B5
and B6) are compiled with g++ (``-ffp-contract=off``, as nvcc's
``-fmad=false``) against a stand-in ``cuda_runtime.h``: a block's threads
run as ``std::thread``s, one block at a time, ``__shared__`` is ``static``,
``__syncthreads`` a pthread barrier and ``__syncthreads_or`` a
barrier-fenced OR; ``__shfl_xor_sync`` and ``__any_sync`` exchange values
between the lanes their mask names (a barrier of those lanes); ``cp.async``
copies land at once (a step writes only the half of the double buffer no
thread reads).  Each C entry point is called through ctypes on the CPU
operands ``ops/stepper._inputs`` builds, as the wrappers call them on the
card.  B2 and B3: for every case (Munk fields with K = 16 to 96 compiled
fixed and two run-time K, Horner and Clenshaw, range-dependent fields, a
curved bottom, a range exit, a seamount with death codes 1, 2 and 3; the
eigenray solver's 2-save plan and a 7-save one) the change's B2 must equal
the parent's B2 and both checkouts' B3 last save rows (seed dz0 = 0).  B5
and B6 (``--coef``: these alone): the change's outputs must equal the
parent's on ``COEF_RAYS`` rays over 30 km (the seamount: 20 km) along
seeded random directions: the headline fan (±14°) and a bottom-bouncing
one (±30°) with D = 1, 3, 16 and 24, a curved bottom, the seamount's
deaths, K = 24, 32, 64 with D = 3, 24 and K, K = 96 (compiled fixed, rows in
shared memory), run-time K = 41 with D = 3 and 70, and two range-dependent
fields (B6).  Bit for bit, a NaN equal to any NaN.  Prints one line a case;
exits 1 on any difference.

The host's libm rounds sin, cos and 1/sqrt apart from the card's, so the
numbers are the host build's: this checks that two versions of the kernel
code compute the same thing, not the card's values (``chip_smoke.py`` does
that).  A few seconds of g++ a checkout, about a minute of tracing for B2
and B3 and one and a half for B5 and B6 (a warp's lanes meet at a barrier
at every exchange).  ``build`` and its stand-in header also serve
``tools/host_fan_rehearsal.py`` and ``tests/test_torch_coef_host.py``.
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

COEF_RAYS = 47  # rays of each coefficient-tangent case (a warp left part-filled)
COEF_X1 = 30e3  # their range, m

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
// __shfl_xor_sync and __any_sync: each lane of the mask posts its value,
// the mask's lanes meet at a barrier of their own (a spin on a generation
// count), and each reads the posts it needs; posts alternate between two
// slots, so a lane cannot overwrite a post another lane has yet to read
struct LaneBar {
  std::atomic<unsigned> n{0}, gen{0};
};
inline LaneBar g_lane_bar[1024];
inline float g_post[2][1024];
inline thread_local unsigned t_posts = 0;
inline float* lane_post(unsigned mask, float v) {
  const unsigned t = threadIdx.x;
  float* slot = g_post[t_posts++ & 1];
  slot[t] = v;
  LaneBar& b = g_lane_bar[(t & ~31u) + __builtin_ctz(mask)];
  const unsigned gen = b.gen.load(std::memory_order_acquire);
  if (b.n.fetch_add(1, std::memory_order_acq_rel) + 1 == (unsigned)__builtin_popcount(mask)) {
    b.n.store(0, std::memory_order_relaxed);
    b.gen.fetch_add(1, std::memory_order_release);
  } else {
    while (b.gen.load(std::memory_order_acquire) == gen) std::this_thread::yield();
  }
  return slot + (t & ~31u);  // the warp's posts
}
inline float __shfl_xor_sync(unsigned mask, float v, int lane_mask) {
  return lane_post(mask, v)[(threadIdx.x & 31u) ^ (unsigned)lane_mask];
}
inline int __any_sync(unsigned mask, int p) {
  const float* w = lane_post(mask, p ? 1.0f : 0.0f);
  int any = 0;
  for (unsigned l = 0; l < 32; ++l) any |= ((mask >> l) & 1u) && w[l] != 0.0f;
  return any;
}
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
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
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


def entry(path, name):
    """The C entry point ``<name>_f32`` of the host library ``path``, typed
    as ``ops/stepper.py`` types it (import the package first)."""
    from pygenray_tpu_torch.ops import stepper

    fn = getattr(ctypes.CDLL(str(path)), f"{name}_f32")
    fn.argtypes, fn.restype = stepper._ARGTYPES[f"{name}_f32"], ctypes.c_int
    return fn


def tail(inp, g):
    """The arguments every entry point ends with (``stepper._launch``), no
    stream."""
    c = inp.consts
    return [int(c.any_x_oob), int(inp.rd), g[0], g[2], c.zlo_m, c.zhi_p, c.sc, c.off,
            c.sin_lim, c.s2b, c.c2b, c.b_sum, c.b_span, None]


def same(a, b):
    """Every output equal, bit for bit, a NaN equal to any NaN."""
    import torch

    return all(bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()) if x.is_floating_point()
               else bool((x == y).all()) for x, y in zip(a, b))


def run_coef(fn, env, z0, p0, dcoef, dcpcoef, g, s):
    """``trace_coef_tangent_f32`` (B5, or B6 on a range-dependent field)
    through the host entry point ``fn`` on CPU tensors, as
    ``stepper._coef_launch`` launches it: ``(T, z, p, dT, dz, dp, n_surf,
    n_bott, death)``, tangents (D, B) or (nr, D, B)."""
    import torch

    from pygenray_tpu_torch.ops import stepper

    env = dataclasses.replace(env, poly_ok=False)
    inp = stepper._inputs(env, z0, p0, g, s, stations=True)
    dc, dcp = (torch.as_tensor(d, dtype=torch.float32).contiguous() for d in (dcoef, dcpcoef))
    B, K, nr, D = inp.p0.shape[0], env.c_cheb.shape[-1], env.c_cheb.shape[0], dc.shape[0]
    tshape = (nr, D, B) if inp.rd else (D, B)
    fl = (*(torch.full((B,), -7.0) for _ in range(3)),
          *(torch.full(tshape, -7.0) for _ in range(3)))
    it = tuple(torch.full((B,), -7, dtype=torch.int32) for _ in range(3))
    c = inp.consts
    err = fn(inp.p0.data_ptr(), inp.z0.data_ptr(), *inp.station_pointers(), dc.data_ptr(),
             dcp.data_ptr(), *(o.data_ptr() for o in fl + it), B, K, inp.bacoef.shape[0],
             g[3] * g[4], D, nr if inp.rd else 1, int(c.bangle_cheb), int(c.term_back),
             *tail(inp, g))
    if err:
        raise RuntimeError(f"entry point returned {err}")
    return fl + it


def directions(env, D, seed):
    """D random coefficient directions of ``env``'s fit, float32 (D, K)
    tables: dc from a seeded normal draw, dc/dz chained through the
    Chebyshev derivative matrix as ``adjoint._directions`` chains unit
    ones."""
    import torch

    from pygenray_tpu_torch.adjoint import cheb_derivative_matrix

    K = env.c_cheb.shape[-1]
    dc = np.random.default_rng(seed).standard_normal((D, K))
    dcp = dc @ np.asarray(cheb_derivative_matrix(K, *env.z_dom), dtype=np.float64).T
    return (torch.as_tensor(dc, dtype=torch.float32), torch.as_tensor(dcp, dtype=torch.float32))


def main():
    args = sys.argv[1:]
    coef_only = "--coef" in args
    args = [a for a in args if a != "--coef"]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    change = pathlib.Path(args[1] if len(args) == 2 else
                          pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(change))
    import torch

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
    from pygenray_tpu_torch.ops import stepper

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

    def launch_p0(env, angles):
        c0 = float(np.interp(1300.0, env.z.numpy(), env.c[0].numpy()))
        return torch.as_tensor(np.sin(np.radians(-angles)) / c0, dtype=torch.float32)

    names = ("trace_tangent", "trace_tangent_save", "trace_coef_tangent")
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = {side: build(root, pathlib.Path(tmp) / side, names)
                for side, root in (("parent", args[0]), ("change", change))}
        b2 = {k: entry(v["trace_tangent"], "trace_tangent") for k, v in libs.items()}
        b3 = {k: entry(v["trace_tangent_save"], "trace_tangent_save") for k, v in libs.items()}
        b56 = {k: entry(v["trace_coef_tangent"], "trace_coef_tangent") for k, v in libs.items()}
        if not coef_only:
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
            for env in fields + [seamount]:
                deaths = env is seamount
                ang = (np.r_[np.linspace(-60.0, 60.0, n - 4), -90.0, -89.999, 89.999, 0.0]
                       if deaths else np.linspace(-18.0, 18.0, n))
                z0 = np.full(n, 1300.0)
                z0[-1] = 6500.0 if deaths else 1300.0
                p0 = launch_p0(env, ang)
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
                          f"death_codes={sorted(set(outs[0][8].tolist()))} equal={ok}",
                          flush=True)

        # the coefficient-tangent kernels, B5 (range-independent) and B6:
        # (field, fan, directions), COEF_RAYS rays from 1300 m over COEF_X1;
        # on the seamount (20 km) steep and vertical rays and a source below
        # the domain die with codes 1, 2 and 3
        curved = munk(nr=32, bathy=lambda r: 4400.0 + 300.0 * np.sin(r / 30e3))
        seamount = munk(r_max=20e3, nr=32,
                        bathy=lambda r: 3200.0 + 1600.0 * np.cos(2 * np.pi * r / 20e3))
        fits = {K: munk(nz=512, cheb_order=K - 1, cheb_exact_order=True)
                for K in (24, 32, 41, 64, 96)}
        fans = {"headline": np.linspace(-14.0, 14.0, COEF_RAYS),
                "bounce": np.linspace(-30.0, 30.0, COEF_RAYS),
                "deaths": np.r_[np.linspace(-60.0, 60.0, COEF_RAYS - 4), -90.0, -89.999, 89.999,
                                0.0]}
        head = munk()
        cases = ([(head, "headline", D) for D in (1, 3, 16, 24)]
                 + [(head, "bounce", D) for D in (1, 3, 16, 24)]
                 + [(curved, "bounce", D) for D in (3, 16)]
                 + [(seamount, "deaths", D) for D in (3, 16)]
                 + [(fits[K], "bounce", D) for K in (24, 32, 64) for D in sorted({3, 24, K})]
                 + [(fits[96], "bounce", 24), (fits[41], "bounce", 3), (fits[41], "bounce", 70)]
                 + [(rd(512), "bounce", 3), (rd(512, 31), "headline", 2)])
        s = pt.SolverSettings(dx=200.0)
        for env, fan, D in cases:
            K = int(env.c_cheb.shape[-1])
            x1 = 20e3 if env is seamount else COEF_X1
            g = (0.0, x1, *_plan(0.0, x1, 2, s.dx))
            p0 = launch_p0(env, fans[fan])
            z0 = torch.full((COEF_RAYS,), 1300.0)
            z0[-1] = 6500.0 if fan == "deaths" else 1300.0
            dc, dcp = directions(env, D, 1000 * K + D)
            outs = [run_coef(b56[side], env, z0, p0, dc, dcp, g, s) for side in ("change",
                                                                                "parent")]
            ok = same(*outs)
            bad += not ok
            bottom = "curved" if env is curved else "seamount" if env is seamount else "flat"
            print(f"coef K={K} rd={bool(env.range_dependent)} fan={fan} D={D} bottom={bottom} "
                  f"bounces={int((outs[0][6] + outs[0][7]).sum())} death_codes={sorted(set(outs[0][8].tolist()))} equal={ok}", flush=True)
    print(f"{bad} cases differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
