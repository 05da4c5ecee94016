"""The forward ray-fan kernel: wrapper, support test and plain version.

Counterpart of ``pygenray_tpu/ops/pallas_stepper.py`` for its forward
mega-kernel (``trace_pallas``, :2733).  The kernel is CUDA C++
(``csrc/trace_fan.cu``, built by ``ops/_build.py``): one thread per ray
integrates every step of every segment in registers.  It covers the
range-independent spectral configuration (Horner or Clenshaw, constant or
Chebyshev bottom angle, Kahan on or off) in float32.

``trace_kernel`` launches the kernel on a CUDA tensor and raises on what
it cannot run; it never falls back.  On a CPU tensor it runs the kernel's
plain version, the torch-op loop of ``integrate._trace_impl``, whose
arithmetic the kernel reproduces expression for expression.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..integrate import TraceResult, _as_batch, _save_ranges, _trace_impl, _use_cheb
from ..utils.cache import LRUCache, env_struct_key
from .interp import linear_interp

__all__ = ["kernel_supported", "trace_kernel", "LAUNCHES"]

# Number of kernel launches since import (or since a caller reset it): a
# run can show that its main path went through the kernel.
LAUNCHES = 0

MAX_K = 256  # coefficient rows held in shared memory (csrc TF_MAX_K)
MAX_KB = 128  # bottom-angle series length (csrc TF_MAX_KB)


def kernel_supported(env, settings) -> bool:
    """True when the CUDA kernel covers this configuration: a
    range-independent spectral (Chebyshev) profile, constant or Chebyshev
    bottom angle, float32.  (The JAX package's ``pallas_supported``
    narrowed to this kernel: range-dependent and segment profiles are
    later kernels.)"""
    return (
        _use_cheb(env, settings)
        and not env.range_dependent
        and env.bangle_mode in ("const", "cheb")
        and env.dtype == torch.float32
        and env.c_cheb.shape[-1] <= MAX_K
        and env.bangle_cheb.shape[0] <= MAX_KB
    )


@dataclasses.dataclass(frozen=True)
class LaunchConsts:
    """Per-launch scalars of the kernel, each rounded to float32 by the
    binding exactly where the plain version rounds its Python scalars."""

    zlo_m: float  # z_dom[0] - bbox_tol
    zhi_p: float  # z_dom[1] + bbox_tol
    sc: float  # depth -> Chebyshev coordinate: u = sc*z - off
    off: float
    sin_lim: float  # vertical-ray limit on |c p|
    s2b: float  # sin/cos of twice a constant bottom angle
    c2b: float
    b_sum: float  # bottom-angle series domain: u = (2x - b_sum) / b_span
    b_span: float
    bangle_cheb: bool
    term_back: bool
    kahan: bool
    use_pow: bool
    any_x_oob: bool


def _launch_consts(env, settings, x0, h, nsteps):
    """The kernel's constants plus the per-step x-out-of-domain flags,
    precomputed on the host in float64 (float32 x0 + k*h carries ~mm of
    rounding over 100 km — far above bbox_tol — and must never decide
    domain-exit deaths)."""
    zlo, zhi = env.z_dom
    rlo, rhi = env.r_dom
    btol = settings.bbox_tol
    b = math.radians(env.bangle_const)
    blo, bhi = env.bathy_r_dom
    ks64 = np.arange(nsteps, dtype=np.float64)
    xoob = (x0 + ks64 * h < rlo - btol) | (x0 + (ks64 + 1.0) * h > rhi + btol)
    consts = LaunchConsts(
        zlo_m=zlo - btol,
        zhi_p=zhi + btol,
        sc=2.0 / (zhi - zlo),
        off=(zlo + zhi) / (zhi - zlo),
        sin_lim=math.sin(math.radians(settings.vertical_limit_deg)),
        s2b=math.sin(2 * b),
        c2b=math.cos(2 * b),
        b_sum=blo + bhi,
        b_span=bhi - blo,
        bangle_cheb=env.bangle_mode == "cheb",
        term_back=bool(settings.terminate_backwards),
        kahan=bool(settings.kahan),
        use_pow=bool(env.poly_ok),
        any_x_oob=bool(xoob.any()),
    )
    return consts, xoob


# launch set-up depends only on the environment's structure (metadata,
# shapes, dtype, device), the step plan and the settings
_SETUP_CACHE = LRUCache(64)


def _launch_setup(env, settings, geom):
    x0, _, h, sps, nseg = geom
    key = (env_struct_key(env), geom, settings)
    got = _SETUP_CACHE.get(key)
    if got is None:
        consts, xoob = _launch_consts(env, settings, x0, h, sps * nseg)
        xoob_t = torch.as_tensor(xoob.astype(np.uint8), device=env.device)
        got = (consts, xoob_t)
        _SETUP_CACHE.put(key, got)
    return got


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (
    [_P] * 15  # p0 z0 ccoef cpcoef bacoef b0s b1s xoob ts zs ps n_surf n_bott death dseg
    + [_I] * 10  # B K Kb nseg sps use_pow bangle_cheb term_back kahan any_x_oob
    + [_F] * 11  # x0 h zlo_m zhi_p sc off sin_lim s2b c2b b_sum b_span
    + [_P]  # stream
)
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from . import _build

        fn = _build.load().trace_fan_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def trace_kernel(env, z0, p0, geom, settings) -> TraceResult:
    """Trace a fan through the CUDA kernel; returns a ``TraceResult`` (ODE
    convention) exactly as the torch-op loop does.

    ``geom`` is ``(x0, x1, h, steps_per_seg, num_seg)`` from
    ``integrate._plan``.  On a CUDA environment this launches the kernel or
    raises; on a CPU environment it runs the plain version, ``_trace_impl``.
    """
    global LAUNCHES
    if not kernel_supported(env, settings):
        raise ValueError("configuration not covered by the CUDA trace kernel")
    dev = env.device
    if dev.type == "cpu":
        return _trace_impl(env, z0, p0, geom, settings)
    if dev.type != "cuda":
        raise ValueError(f"trace_kernel runs on CUDA or CPU tensors, not {dev.type}")

    x0, x1, h, sps, nseg = geom
    nsteps = sps * nseg
    f32 = torch.float32
    z0v, p0v = _as_batch(env, z0, p0)
    z0v, p0v = z0v.contiguous(), p0v.contiguous()
    B = p0v.shape[0]
    consts, xoob = _launch_setup(env, settings, geom)
    ctab, cptab = (env.c_pow, env.dcdz_pow) if consts.use_pow else (env.c_cheb, env.dcdz_cheb)
    ccoef, cpcoef = ctab[0].contiguous(), cptab[0].contiguous()
    bacoef = env.bangle_cheb.contiguous()

    # per-step bathymetry, computed exactly as the plain version does
    ks = torch.arange(nsteps, dtype=f32, device=dev)
    b0s = linear_interp(x0 + ks * h, env.bathy_r, env.bathy, env.uniform_bathy_r).contiguous()
    b1s = linear_interp(x0 + (ks + 1.0) * h, env.bathy_r, env.bathy,
                        env.uniform_bathy_r).contiguous()

    num_save = nseg + 1
    ts = torch.empty((num_save, B), dtype=f32, device=dev)
    zs = torch.empty_like(ts)
    ps = torch.empty_like(ts)
    n_surf = torch.empty(B, dtype=torch.int32, device=dev)
    n_bott = torch.empty_like(n_surf)
    death = torch.empty_like(n_surf)
    dseg = torch.empty_like(n_surf)
    if B > 0:
        fn = _kernel_fn()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            c = consts
            err = fn(
                p0v.data_ptr(), z0v.data_ptr(), ccoef.data_ptr(), cpcoef.data_ptr(),
                bacoef.data_ptr(), b0s.data_ptr(), b1s.data_ptr(), xoob.data_ptr(),
                ts.data_ptr(), zs.data_ptr(), ps.data_ptr(), n_surf.data_ptr(),
                n_bott.data_ptr(), death.data_ptr(), dseg.data_ptr(),
                B, ccoef.shape[0], bacoef.shape[0], nseg, sps,
                int(c.use_pow), int(c.bangle_cheb), int(c.term_back), int(c.kahan),
                int(c.any_x_oob),
                x0, h, c.zlo_m, c.zhi_p, c.sc, c.off, c.sin_lim, c.s2b, c.c2b,
                c.b_sum, c.b_span, stream,
            )
        if err != 0:
            raise RuntimeError(f"trace_fan_f32 launch failed: CUDA error {err}")
        LAUNCHES += 1

    # alive at save point k  <=>  k precedes the ray's first-dead save index
    alive_save = torch.arange(num_save, dtype=torch.int32, device=dev)[None, :] < dseg[:, None]
    return TraceResult(
        rs=_save_ranges(x0, x1, nseg, ts),
        ts=ts.t().contiguous(),
        zs=zs.t().contiguous(),
        ps=ps.t().contiguous(),
        n_bott=n_bott,
        n_surf=n_surf,
        alive=death == 0,
        alive_save=alive_save,
        death_code=death,
    )
