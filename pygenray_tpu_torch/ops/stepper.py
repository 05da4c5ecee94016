"""The CUDA trace kernels: wrappers, support tests and plain versions.

Counterparts of two Pallas launchers of ``pygenray_tpu/ops/pallas_stepper.py``:

* ``trace_kernel`` — the forward mega-kernel (``trace_pallas``, :2733), in
  CUDA C++ ``csrc/trace_fan.cu``: one thread per ray integrates every step
  of every segment in registers and writes the save grid.
* ``trace_tangent_kernel`` — the final-state forward-tangent kernel
  (``trace_pallas_tangent``, :1161), in ``csrc/trace_tangent.cu``: the same
  step on (value, tangent) pairs, final state only; the Newton engine of
  the eigenray search.

Both cover spectral profiles (Horner or Clenshaw; range-independent, or
range-dependent through per-step blended coefficient rows) with a constant
or Chebyshev bottom angle, in float32.  The kernels are built by
``ops/_build.py``.  On a CUDA tensor a wrapper launches its kernel or
raises on what it cannot run; it never falls back.  On a CPU tensor it
runs the kernel's plain version, the torch-op loop whose arithmetic the
kernel reproduces expression for expression: ``integrate._trace_impl`` and
``integrate._trace_tangent_impl``.  Both read the per-step data of
``integrate._step_data``, so kernel and plain version see the same numbers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..integrate import (
    TraceResult, _as_batch, _save_ranges, _step_data, _trace_impl, _trace_tangent_impl,
    _use_cheb,
)
from ..utils.cache import LRUCache, env_struct_key

__all__ = [
    "kernel_supported", "tangent_supported", "trace_kernel", "trace_tangent_kernel",
    "LAUNCHES", "TANGENT_LAUNCHES",
]

# Numbers of kernel launches since import (or since a caller reset them):
# a run can show that its main path went through each kernel.
LAUNCHES = 0  # trace_fan_f32
TANGENT_LAUNCHES = 0  # trace_tangent_f32

MAX_K = 256  # coefficient rows held in shared memory (csrc TF_MAX_K)
MAX_KB = 128  # bottom-angle series length (csrc TF_MAX_KB)


def kernel_supported(env, settings) -> bool:
    """True when the CUDA kernels cover this configuration: a spectral
    (Chebyshev) profile, range-independent or range-dependent, constant or
    Chebyshev bottom angle, float32.  (The JAX package's
    ``pallas_supported`` narrowed to these kernels: the segment mode is a
    later kernel.)"""
    return (
        _use_cheb(env, settings)
        and env.bangle_mode in ("const", "cheb")
        and env.dtype == torch.float32
        and env.c_cheb.shape[-1] <= MAX_K
        and env.bangle_cheb.shape[0] <= MAX_KB
    )


def tangent_supported(env, settings) -> bool:
    """True when the CUDA forward-tangent kernel covers this configuration:
    what ``kernel_supported`` admits (counterpart of the JAX package's
    ``tangent_supported``, ``ops/pallas_stepper.py:722``).  The tangent
    kernel never compensates (no Kahan), whatever ``settings.kahan`` says."""
    return kernel_supported(env, settings)


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
    """``(consts, xoob)``: the launch constants and the per-step domain
    flags on the device, cached (building the flags is a host→device
    copy, which would synchronize every call)."""
    x0, _, h, sps, nseg = geom
    key = (env_struct_key(env), geom, settings)
    got = _SETUP_CACHE.get(key)
    if got is None:
        consts, xoob = _launch_consts(env, settings, x0, h, sps * nseg)
        got = (consts, torch.as_tensor(xoob, device=env.device))
        _SETUP_CACHE.put(key, got)
    return got


@dataclasses.dataclass(frozen=True)
class _Inputs:
    """The device operands both kernels read, in launch order."""

    z0: torch.Tensor
    p0: torch.Tensor
    consts: LaunchConsts
    ccoef: torch.Tensor  # (K,) the initial right-hand side's rows ...
    cpcoef: torch.Tensor  # ... (every step's, range-independent)
    bacoef: torch.Tensor  # (Kb,) bottom-angle series
    b0s: torch.Tensor  # (nsteps,) bathymetry at each step's start and end
    b1s: torch.Tensor
    xoob: torch.Tensor  # (nsteps,) bool, one byte each
    rows: tuple  # range-dependent: (c_m, cp_m, c_1, cp_1), each (nsteps, K)

    def pointers(self):
        """Device addresses, in launch order (every tensor here is
        contiguous and held by this object while the kernel may read it);
        NULL rows for a range-independent field."""
        rows = self.rows or (None,) * 4
        return [t if t is None else t.data_ptr()
                for t in (self.ccoef, self.cpcoef, self.bacoef, self.b0s, self.b1s, self.xoob,
                          *rows)]


def _inputs(env, z0, p0, geom, settings) -> _Inputs:
    """Launch operands, computed by the plain version's own code
    (``integrate._step_data``) so the kernel reads its exact numbers."""
    z0v, p0v = _as_batch(env, z0, p0)
    consts, xoob = _launch_setup(env, settings, geom)
    sd = _step_data(env, geom, True, consts.use_pow, False, settings.bbox_tol, xoob)
    rows = ()
    if env.range_dependent:
        rows = tuple(t.contiguous() for t in (*sd.prof_ms, *sd.prof_1s))
    return _Inputs(
        z0v.contiguous(), p0v.contiguous(), consts, sd.prof0[0].contiguous(),
        sd.prof0[1].contiguous(), env.bangle_cheb.contiguous(), sd.b0s.contiguous(),
        sd.b1s.contiguous(), sd.oob_step.contiguous(), rows,
    )


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IN = [_P] * 10  # ccoef cpcoef bacoef b0s b1s xoob c_m cp_m c_1 cp_1 (_Inputs.pointers)
_FLOATS = [_F] * 11  # x0 h zlo_m zhi_p sc off sin_lim s2b c2b b_sum b_span
_ARGTYPES = {
    "trace_fan_f32": (
        [_P] * 2 + _IN  # p0 z0, inputs
        + [_P] * 7  # ts zs ps n_surf n_bott death dseg
        + [_I] * 11  # B K Kb nseg sps use_pow bangle_cheb term_back kahan any_x_oob rd
        + _FLOATS + [_P]  # stream
    ),
    "trace_tangent_f32": (
        [_P] * 3 + _IN  # p0 dp0 z0, inputs
        + [_P] * 9  # T z p dT dz dp n_surf n_bott death
        + [_I] * 9  # B K Kb nsteps use_pow bangle_cheb term_back any_x_oob rd
        + _FLOATS + [_P]  # stream
    ),
}
_FNS = {}


def _kernel_fn(name):
    """The C entry point ``name`` of the kernel library built from
    ``csrc/<source>.cu``."""
    fn = _FNS.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(name.rsplit("_", 1)[0]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name, dev, pointers, ints, inp, geom):
    """Call a kernel's C entry point on the current stream of ``dev``:
    its pointers, its own integers, then the arguments both kernels end
    with."""
    c = inp.consts
    x0, _, h, _, _ = geom
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn(name)(
            *pointers, *ints, int(c.any_x_oob), int(bool(inp.rows)),
            x0, h, c.zlo_m, c.zhi_p, c.sc, c.off, c.sin_lim, c.s2b, c.c2b, c.b_sum,
            c.b_span, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_device(env, what):
    dev = env.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev.type}")
    return dev


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
    dev = _check_device(env, "trace_kernel")
    if dev.type == "cpu":
        return _trace_impl(env, z0, p0, geom, settings)

    x0, x1, h, sps, nseg = geom
    inp = _inputs(env, z0, p0, geom, settings)
    B = inp.p0.shape[0]
    num_save = nseg + 1
    ts = torch.empty((num_save, B), dtype=torch.float32, device=dev)
    zs = torch.empty_like(ts)
    ps = torch.empty_like(ts)
    n_surf = torch.empty(B, dtype=torch.int32, device=dev)
    n_bott = torch.empty_like(n_surf)
    death = torch.empty_like(n_surf)
    dseg = torch.empty_like(n_surf)
    if B > 0:
        c = inp.consts
        outs = (ts, zs, ps, n_surf, n_bott, death, dseg)
        _launch("trace_fan_f32", dev,
                [inp.p0.data_ptr(), inp.z0.data_ptr(), *inp.pointers(),
                 *(o.data_ptr() for o in outs)],
                (B, inp.ccoef.shape[0], inp.bacoef.shape[0], nseg, sps, int(c.use_pow),
                 int(c.bangle_cheb), int(c.term_back), int(c.kahan)),
                inp, geom)
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


def trace_tangent_kernel(env, z0, p0, dp0, geom, settings):
    """Final-state trace with one forward tangent through the CUDA kernel:
    returns ``(T, z, p, dT, dz, dp, n_surf, n_bott, death)``, each (B,), in
    the ODE convention (counterpart of ``trace_pallas_tangent``).  ``dp0``
    is the tangent of ``p0`` (ones for the diagonal Jacobian dz_end/dp0
    that Newton eigenrays use); no Kahan compensation.

    On a CUDA environment this launches the kernel or raises; on a CPU
    environment it runs the plain version, ``_trace_tangent_impl``.
    """
    global TANGENT_LAUNCHES
    if not tangent_supported(env, settings):
        raise ValueError("configuration not covered by the CUDA tangent kernel")
    dev = _check_device(env, "trace_tangent_kernel")
    if dev.type == "cpu":
        return _trace_tangent_impl(env, z0, p0, dp0, geom, settings)

    _, _, _, sps, nseg = geom
    inp = _inputs(env, z0, p0, geom, settings)
    B = inp.p0.shape[0]
    dp0v = torch.as_tensor(dp0, dtype=torch.float32, device=dev).expand(B).contiguous()
    outs = tuple(torch.empty(B, dtype=torch.float32, device=dev) for _ in range(6)) + tuple(
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    if B > 0:
        c = inp.consts
        _launch("trace_tangent_f32", dev,
                [inp.p0.data_ptr(), dp0v.data_ptr(), inp.z0.data_ptr(), *inp.pointers(),
                 *(o.data_ptr() for o in outs)],
                (B, inp.ccoef.shape[0], inp.bacoef.shape[0], sps * nseg, int(c.use_pow),
                 int(c.bangle_cheb), int(c.term_back)),
                inp, geom)
        TANGENT_LAUNCHES += 1
    return outs
