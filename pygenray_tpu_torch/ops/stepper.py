"""The CUDA trace kernels: wrappers, support tests and plain versions.

Counterparts of the six Pallas launchers of ``pygenray_tpu/ops/pallas_stepper.py``:

* ``trace_kernel`` — the forward mega-kernel (``trace_pallas``, :2733), in
  CUDA C++ ``csrc/trace_fan.cu``: one thread per ray integrates every step
  of every segment in registers and writes the save grid.  Spectral
  profiles (Horner or Clenshaw) and, in its segment mode, the piecewise
  fits of rough fields (local Horner or Clenshaw over a per-ray segment
  pick).
* ``trace_tangent_kernel`` — the final-state forward-tangent kernel
  (``trace_pallas_tangent``, :1161), in ``csrc/trace_tangent.cu``: the same
  step on (value, tangent) pairs, final state only; the Newton engine of
  the eigenray search.  Its body is the save-grid kernel's
  (``csrc/tangent_trace.cuh``) with one segment and no save grid.
* ``trace_tangent_save_kernel`` — the save-grid forward-tangent kernel
  (``trace_pallas_tangent_save``, :1194), in ``csrc/trace_tangent_save.cu``:
  the tangent kernels' step (shared through ``csrc/tangent_step.cuh``),
  seeded in ``p0`` and ``z0``, with the state and its tangent written at
  every save point.  Both kernels run one thread a ray, c and dc/dz in one
  loop, K compiled fixed for the spectral fit ladder's lengths
  (``SAVE_FIXED_K``; a range-independent field's coefficients in
  registers), a range-dependent field's step rows staged in shared memory
  as the ensemble kernel's; the engine of autograd through ``trace`` and
  of the receiver side (amplitudes, impulse responses, transmission-loss
  fields).
* ``trace_tangent_ensemble_kernel`` — the ensemble forward-tangent kernel
  (``trace_pallas_tangent_ensemble``, :1258), in
  ``csrc/trace_tangent_ens.cu``: the final-state tangent kernel's step
  over E realizations of a range-dependent field at once, each block
  staging its realization's per-step rows in shared memory (a double
  buffer filled by asynchronous copies), a lane pair per ray evaluating c
  and dc/dz at once, K compiled fixed for the spectral fit ladder's
  lengths (``ens_layout``); the Newton engine of the Monte-Carlo eigenray
  search.
* ``trace_coef_tangent_kernel`` and ``trace_coef_tangent_rd_kernel`` — the
  coefficient-tangent kernels (``trace_pallas_coef_tangent``, :1518, and
  ``trace_pallas_coef_tangent_rd``, :1820), in ``csrc/trace_coef_tangent.cu``
  (one kernel template, range-independent or RD): the same step with the tangent
  taken along directions of the Chebyshev coefficients (per station, for a
  range-dependent fit) instead of the launch parameters; the engine of the
  travel-time Jacobians and coefficient gradients of ``adjoint.py``.

The tangent kernels cover spectral profiles only (Horner or Clenshaw;
range-independent, or range-dependent through per-step blended
coefficient rows); all cover a constant or Chebyshev bottom angle, in
float32.  The kernels are built by ``ops/_build.py``.  On a CUDA tensor a
wrapper launches its kernel or raises on what it cannot run; it never
falls back.  On a CPU tensor it runs the kernel's plain version, the
torch-op loop whose arithmetic the kernel reproduces expression for
expression: ``integrate._trace_impl``, ``integrate._trace_tangent_impl``,
``integrate._trace_tangent_save_impl``,
``integrate._trace_tangent_ens_impl``, ``integrate._trace_coef_tangent_impl``
and ``integrate._trace_coef_tangent_rd_impl``.  All read the per-step data of
``integrate._step_data``, so kernel and plain version see the same numbers.
For a range-dependent field the fan kernel and the coefficient-tangent
kernel take the stations' tables (``integrate._profile_tabs``) and the
station indices and weights of ``integrate._station_iw_rows``, and blend
each step's rows themselves with the plain version's expression; the
tangent kernels B2-B4 take the per-step rows ``_step_data`` blends.  The
coefficient-tangent kernels evaluate the series by Clenshaw only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..envdata import env_member
from ..integrate import (
    TraceResult, _as_batch, _ens_step_data, _profile_tabs, _save_ranges, _station_iw_rows,
    _step_bathy, _step_data,
    _trace_coef_tangent_impl, _trace_coef_tangent_rd_impl, _trace_impl,
    _trace_tangent_ens_impl, _trace_tangent_impl, _trace_tangent_save_impl, _use_cheb, _use_seg,
)
from ..utils.cache import LRUCache, env_struct_key

__all__ = [
    "kernel_supported", "tangent_supported", "trace_kernel", "trace_tangent_kernel",
    "trace_tangent_save_kernel", "trace_tangent_ensemble_kernel", "trace_coef_tangent_kernel",
    "trace_coef_tangent_rd_kernel", "LAUNCHES", "SEG_LAUNCHES", "TANGENT_LAUNCHES",
    "TANGENT_SAVE_LAUNCHES", "TANGENT_ENS_LAUNCHES", "COEF_TANGENT_LAUNCHES",
    "COEF_TANGENT_RD_LAUNCHES",
]

# Numbers of kernel launches since import (or since a caller reset them):
# a run can show that its main path went through each kernel.
LAUNCHES = 0  # trace_fan_f32
SEG_LAUNCHES = 0  # trace_fan_f32 in its segment mode (counted in LAUNCHES too)
TANGENT_LAUNCHES = 0  # trace_tangent_f32
TANGENT_SAVE_LAUNCHES = 0  # trace_tangent_save_f32
TANGENT_ENS_LAUNCHES = 0  # trace_tangent_ens_f32
COEF_TANGENT_LAUNCHES = 0  # trace_coef_tangent_f32, range-independent
COEF_TANGENT_RD_LAUNCHES = 0  # trace_coef_tangent_f32, range-dependent

MAX_K = 256  # coefficient rows held in shared memory (csrc TF_MAX_K)
MAX_KB = 128  # bottom-angle series length (csrc TF_MAX_KB)
# bytes of segment tables a block holds in shared memory (csrc
# TF_MAX_SEG_SMEM; the card gives a block 227 KB): a range-independent fit's
# two (Ks, S) tables, or a range-dependent fit's blended step tables
MAX_SEG_SMEM = 200 * 1024
SEG_SMEM_S = 128  # segments a profile of the shared-memory step tables (csrc TF_SEG_S)
SEG_LAYOUTS = ("pick", "double", "single")  # csrc TF_SEG_PICK, TF_SEG_DOUBLE, TF_SEG_SINGLE


def seg_layout(Ks: int, S: int) -> str:
    """Where the fan kernel keeps a range-dependent segment fit's per-step
    tables (the four (Ks, S) tables of c and dc/dz at a step's middle and
    end, which the block blends from the stations' tables), as its launcher
    (``csrc/trace_fan.cu`` ``seg_layout``) chooses: "double", two steps'
    tables in shared memory, one barrier a step; "single", one step's, two
    barriers a step; "pick", none, each coefficient pick blending the two
    stations from device memory (only an exact-order fit above the ladder
    reaches it)."""
    step = 4 * Ks * S * 4
    if S != SEG_SMEM_S:
        return "pick"
    if 2 * step <= MAX_SEG_SMEM:
        return "double"
    return "single" if step <= MAX_SEG_SMEM else "pick"


# K the ensemble tangent kernel is compiled for with K fixed (csrc
# trace_tangent_ens.cu launch_k): the spectral fit ladder's lengths
# (envdata.make_env_data, orders + 1) up to 96
ENS_FIXED_K = (16, 24, 32, 48, 64, 96)


# K the final-state and save-grid tangent kernels are compiled for with K
# fixed (csrc/tangent_trace.cuh with_fixed_k): the same ladder
SAVE_FIXED_K = ENS_FIXED_K


def ens_layout(K: int, tables) -> tuple:
    """How the ensemble tangent kernel's launcher (``csrc/trace_tangent_ens.cu``
    ``trace_tangent_ens_layout``) runs K-term step rows held in ``tables``
    (the four (E, nsteps, K) tensors of ``integrate._ens_step_data``):
    ``("fixed" or "run-time" K, bytes an asynchronous copy moves)``, 16
    when K is a multiple of 4 and every table starts on a 16-byte boundary,
    else 4."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tables)
    return ("fixed" if K in ENS_FIXED_K else "run-time", 16 if K % 4 == 0 and aligned else 4)


def fan_saves_in_rows(seg: int, rd: bool) -> bool:
    """Whether the fan kernel (``csrc/trace_fan.cu``, ``trace_fan_kernel``'s
    ``ROWS``) writes a launch's save grids as (B, nseg+1) rows, each ray its
    own (the range-independent spectral mode: ``seg`` 0, not ``rd``), or as
    (nseg+1, B) columns, which ``trace_kernel`` transposes (the block-wide
    modes: range-dependent spectral and segment fits)."""
    return seg == 0 and not rd


def _seg_mode(env, settings) -> int:
    """The fan kernel's profile mode: 0 spectral (or no kernel mode: a
    table profile), 1 the segment fit in basis "pow" (Horner), 2 in basis
    "cheb" (Clenshaw)."""
    if _use_cheb(env, settings):
        return 0
    try:
        if not _use_seg(env, settings):
            return 0
    except ValueError:  # interp="seg" on an environment without the fit
        return 0
    return 2 if env.seg_basis == "cheb" else 1


def tangent_supported(env, settings) -> bool:
    """True when the CUDA forward-tangent kernels (final-state, save-grid
    and ensemble) cover this configuration: a spectral (Chebyshev) profile,
    range-independent or range-dependent, constant or Chebyshev bottom
    angle, float32 (the JAX package's ``tangent_supported``,
    ``ops/pallas_stepper.py:722``: the tangent kernels have no segment
    mode).  They never compensate (no Kahan), whatever ``settings.kahan``
    says."""
    return (
        _use_cheb(env, settings)
        and env.bangle_mode in ("const", "cheb")
        and env.dtype == torch.float32
        and env.c_cheb.shape[-1] <= MAX_K
        and env.bangle_cheb.shape[-1] <= MAX_KB
    )


def kernel_supported(env, settings) -> bool:
    """True when the CUDA fan kernel covers this configuration: what
    ``tangent_supported`` admits, and the segment profiles of rough fields
    (basis "pow" or "cheb"), range-independent or range-dependent, with a
    constant or Chebyshev bottom angle in float32 (the JAX package's
    ``pallas_supported``, ``ops/pallas_stepper.py:72``).  Its
    ``seg_kernel_ok`` caps a range-dependent segment fit at what the TPU's
    vector memory holds; the CUDA kernel takes a range-dependent fit of any
    size, its step tables where ``seg_layout`` says.  A range-independent
    fit's two tables go to shared memory (``MAX_SEG_SMEM``)."""
    if tangent_supported(env, settings):
        return True
    if not _seg_mode(env, settings):
        return False
    Ks, S = env.c_seg.shape[-2:]
    return (
        env.bangle_mode in ("const", "cheb")
        and env.dtype == torch.float32
        and env.bangle_cheb.shape[-1] <= MAX_KB
        and (env.range_dependent or 8 * Ks * S <= MAX_SEG_SMEM)
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
    seg: int  # profile mode (_seg_mode): 0 spectral, 1 segment Horner, 2 segment Clenshaw
    seg_zlo: float  # segment pick: t = (z - seg_zlo) * seg_hinv
    seg_hinv: float


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
        seg=_seg_mode(env, settings),
        seg_zlo=zlo,
        seg_hinv=float(env.c_seg.shape[-1]) / (zhi - zlo),
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
    """The device operands the kernels read, in launch order."""

    z0: torch.Tensor | None
    p0: torch.Tensor | None
    consts: LaunchConsts
    # the initial right-hand side's rows (K,) or (E, K); segment tables (Ks,
    # S); range-dependent, for the kernels that blend stations themselves,
    # the station tables (nr, K) or (nr, Ks, S)
    ccoef: torch.Tensor
    cpcoef: torch.Tensor
    bacoef: torch.Tensor  # (Kb,) bottom-angle series
    b0s: torch.Tensor  # (nsteps,) bathymetry at each step's start and end
    b1s: torch.Tensor
    xoob: torch.Tensor  # (nsteps,) bool, one byte each
    # range-dependent, per-step rows (the tangent kernels B2-B4): (c_m, cp_m,
    # c_1, cp_1), each (nsteps, K)
    rows: tuple
    rd: bool  # range-dependent
    # range-dependent, station tables: the station index and weight at the
    # launch range, then at each step's middle and end, (2 nsteps + 1,)
    st_i: torch.Tensor | None = None
    st_w: torch.Tensor | None = None

    def _ptrs(self, ts):
        return [t if t is None else t.data_ptr() for t in ts]

    def pointers(self):
        """Device addresses for the kernels that read per-step rows, in
        launch order (every tensor here is contiguous and held by this
        object while the kernel may read it); NULL rows for a
        range-independent field."""
        return self._ptrs((self.ccoef, self.cpcoef, self.bacoef, self.b0s, self.b1s, self.xoob,
                           *(self.rows or (None,) * 4)))

    def station_pointers(self):
        """Device addresses for the kernels that blend station tables
        themselves (the fan kernel, the coefficient-tangent kernel); NULL
        station rows for a range-independent field."""
        return self._ptrs((self.ccoef, self.cpcoef, self.bacoef, self.b0s, self.b1s, self.xoob,
                           self.st_i, self.st_w))


def step_geometry(env, geom):
    """``(b0s, b1s, st_i, st_w)``: the per-step inputs of the kernels that
    blend stations themselves (the fan and coefficient-tangent kernels),
    the per-step bathymetry of the plain version (``integrate._step_bathy``)
    and, for a range-dependent field, its station intervals
    (``integrate._station_iw_rows``; else None).  They depend on the
    field's range stations, its bathymetry and the step plan only: a caller
    that launches again on the same geometry with new coefficients (an
    inversion's iterates) builds them once and passes them as ``geo``."""
    st = _station_iw_rows(env, geom) if bool(env.range_dependent) else (None, None)
    return (*_step_bathy(env, geom), *st)


def _inputs(env, z0, p0, geom, settings, stations=False, geo=None) -> _Inputs:
    """Launch operands, computed by the plain version's own code
    (``integrate._step_data``, ``_profile_tabs``, ``_station_iw_rows``) so
    the kernel reads its exact numbers.  ``stations`` (the fan and
    coefficient-tangent kernels): a range-dependent field goes as its
    station tables and station intervals, which the kernel blends itself,
    not as per-step blended rows, and the per-step inputs are ``geo``
    (``step_geometry``, built here when None).  A segment fit always goes
    so (only the fan kernel takes one)."""
    z0v, p0v = _as_batch(env, z0, p0)
    consts, xoob = _launch_setup(env, settings, geom)
    seg, rd = consts.seg, bool(env.range_dependent)
    rows, st_i, st_w = (), None, None
    if stations or seg:
        b0s, b1s, st_i, st_w = step_geometry(env, geom) if geo is None else geo
        tabs = _profile_tabs(env, seg == 0, consts.use_pow, seg != 0)
        ccoef, cpcoef = tabs if rd else (t[0] for t in tabs)
    else:
        sd = _step_data(env, geom, seg == 0, consts.use_pow, seg != 0, settings.bbox_tol, xoob)
        b0s, b1s = sd.b0s, sd.b1s
        ccoef, cpcoef = sd.prof0
        if rd:
            rows = tuple(t.contiguous() for t in (*sd.prof_ms, *sd.prof_1s))
    return _Inputs(
        z0v.contiguous(), p0v.contiguous(), consts, ccoef.contiguous(), cpcoef.contiguous(),
        env.bangle_cheb.contiguous(), b0s.contiguous(), b1s.contiguous(), xoob, rows, rd, st_i,
        st_w,
    )


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IN = [_P] * 10  # ccoef cpcoef bacoef b0s b1s xoob c_m cp_m c_1 cp_1 (_Inputs.pointers)
_IN_ST = [_P] * 8  # ccoef cpcoef bacoef b0s b1s xoob st_i st_w (_Inputs.station_pointers)
# every kernel ends with: any_x_oob rd, x0 h zlo_m zhi_p sc off sin_lim s2b c2b b_sum
# b_span, stream (_launch)
_TAIL = [_I] * 2 + [_F] * 11 + [_P]
_ARGTYPES = {
    "trace_fan_f32": (
        [_P] * 2 + _IN_ST  # p0 z0, inputs
        + [_P] * 7  # ts zs ps n_surf n_bott death dseg
        + [_I] * 12  # B K Kb nseg sps use_pow bangle_cheb term_back kahan seg S nr
        + [_F] * 2 + _TAIL  # seg_zlo seg_hinv
    ),
    "trace_tangent_f32": (
        [_P] * 3 + _IN  # p0 dp0 z0, inputs
        + [_P] * 9  # T z p dT dz dp n_surf n_bott death
        + [_I] * 7 + _TAIL  # B K Kb nsteps use_pow bangle_cheb term_back
    ),
    "trace_tangent_save_f32": (
        [_P] * 4 + _IN  # p0 dp0 z0 dz0, inputs
        + [_P] * 10  # T z p dT dz dp (nseg+1, B), n_surf n_bott death dseg (B,)
        + [_I] * 8 + _TAIL  # B K Kb nseg sps use_pow bangle_cheb term_back
    ),
    "trace_tangent_ens_f32": (
        [_P] * 2 + [_F] + _IN  # p0 dp0 (E, M), z0, inputs
        + [_P] * 9  # T z p dT dz dp n_surf n_bott death (E, M)
        + [_I] * 8 + _TAIL  # E M K Kb nsteps use_pow bangle_cheb term_back
    ),
    "trace_coef_tangent_f32": (
        [_P] * 2 + _IN_ST + [_P] * 2  # p0 z0, inputs, dcoef dcpcoef (D, K)
        + [_P] * 9  # T z p (B,), dT dz dp (nr, D, B), n_surf n_bott death (B,)
        + [_I] * 8 + _TAIL  # B K Kb nsteps D nr bangle_cheb term_back
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


def _launch(name, dev, args, inp, geom):
    """Call a kernel's C entry point on the current stream of ``dev``:
    its own arguments, then those every kernel ends with."""
    c = inp.consts
    x0, _, h, _, _ = geom
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn(name)(
            *args, int(c.any_x_oob), int(inp.rd),
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


def trace_kernel(env, z0, p0, geom, settings, geo=None) -> TraceResult:
    """Trace a fan through the CUDA kernel; returns a ``TraceResult`` (ODE
    convention) exactly as the torch-op loop does.

    ``geom`` is ``(x0, x1, h, steps_per_seg, num_seg)`` from
    ``integrate._plan``; ``geo`` is its ``step_geometry``, built here when
    None.  On a CUDA environment this launches the kernel or raises; on a
    CPU environment it runs the plain version, ``_trace_impl``.
    """
    global LAUNCHES, SEG_LAUNCHES
    if not kernel_supported(env, settings):
        raise ValueError("configuration not covered by the CUDA trace kernel")
    dev = _check_device(env, "trace_kernel")
    if dev.type == "cpu":
        return _trace_impl(env, z0, p0, geom, settings)

    x0, x1, h, sps, nseg = geom
    inp = _inputs(env, z0, p0, geom, settings, stations=True, geo=geo)
    B = inp.p0.shape[0]
    rows = fan_saves_in_rows(inp.consts.seg, inp.rd)
    ts = torch.empty((B, nseg + 1) if rows else (nseg + 1, B), dtype=torch.float32, device=dev)
    zs = torch.empty_like(ts)
    ps = torch.empty_like(ts)
    n_surf = torch.empty(B, dtype=torch.int32, device=dev)
    n_bott = torch.empty_like(n_surf)
    death = torch.empty_like(n_surf)
    dseg = torch.empty_like(n_surf)
    if B > 0:
        c = inp.consts
        outs = (ts, zs, ps, n_surf, n_bott, death, dseg)
        # series terms and segments: (K,) rows or (nr, K) station tables, or
        # (..., Ks, S) segment tables
        K, S = (inp.ccoef.shape[-2], inp.ccoef.shape[-1]) if c.seg else (inp.ccoef.shape[-1], 1)
        nr = inp.ccoef.shape[0] if inp.rd else 1
        _launch("trace_fan_f32", dev,
                [inp.p0.data_ptr(), inp.z0.data_ptr(), *inp.station_pointers(),
                 *(o.data_ptr() for o in outs),
                 B, K, inp.bacoef.shape[0], nseg, sps, int(c.use_pow), int(c.bangle_cheb),
                 int(c.term_back), int(c.kahan), c.seg, S, nr, c.seg_zlo, c.seg_hinv],
                inp, geom)
        LAUNCHES += 1
        SEG_LAUNCHES += bool(c.seg)
    if not rows:
        ts, zs, ps = (g.t().contiguous() for g in (ts, zs, ps))
    return _fan_result(x0, x1, ts, zs, ps, n_surf, n_bott, death, dseg)


def _fan_result(x0, x1, ts, zs, ps, n_surf, n_bott, death, dseg) -> TraceResult:
    """The ``TraceResult`` of a fan kernel launch from its outputs: the
    (B, nseg+1) save grids ``ts``, ``zs``, ``ps``, the (B,) counters and
    death codes, and ``dseg``, each ray's first save index at which it is
    dead (nseg+1 for a ray alive at the end); ``x0``, ``x1``: the range of
    the plan."""
    nseg = ts.shape[1] - 1
    # alive at save point k  <=>  k precedes the ray's first-dead save index
    saves = torch.arange(nseg + 1, dtype=torch.int32, device=ts.device)
    return TraceResult(
        rs=_save_ranges(x0, x1, nseg, ts), ts=ts, zs=zs, ps=ps, n_bott=n_bott, n_surf=n_surf,
        alive=death == 0, alive_save=saves[None, :] < dseg[:, None], death_code=death,
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
                 *(o.data_ptr() for o in outs),
                 B, inp.ccoef.shape[0], inp.bacoef.shape[0], sps * nseg, int(c.use_pow),
                 int(c.bangle_cheb), int(c.term_back)],
                inp, geom)
        TANGENT_LAUNCHES += 1
    return outs


def trace_tangent_save_kernel(env, z0, p0, dp0, geom, settings, dz0=None):
    """Save-grid trace with one forward tangent through the CUDA kernel:
    returns ``(TraceResult, (dts, dzs, dps))``, the tangent arrays (B,
    nseg+1), in the ODE convention (counterpart of
    ``trace_pallas_tangent_save``).  ``(dp0, dz0)`` seeds the tangents of
    ``p0`` and of the source depth (``dz0`` defaults to 0); no Kahan
    compensation.  A dead ray's later rows hold its frozen state and
    tangent.

    On a CUDA environment this launches the kernel or raises; on a CPU
    environment it runs the plain version, ``_trace_tangent_save_impl``.
    """
    global TANGENT_SAVE_LAUNCHES
    if not tangent_supported(env, settings):
        raise ValueError("configuration not covered by the CUDA save-grid tangent kernel")
    dev = _check_device(env, "trace_tangent_save_kernel")
    if dev.type == "cpu":
        return _trace_tangent_save_impl(env, z0, p0, dp0, geom, settings, dz0=dz0)

    x0, x1, _, sps, nseg = geom
    inp = _inputs(env, z0, p0, geom, settings)
    B = inp.p0.shape[0]
    seed = lambda d: torch.as_tensor(0.0 if d is None else d, dtype=torch.float32,
                                     device=dev).expand(B).contiguous()
    dp0v, dz0v = seed(dp0), seed(dz0)
    # (nseg+1, B): a warp writes 32 consecutive floats of one save row
    grids = tuple(torch.empty((nseg + 1, B), dtype=torch.float32, device=dev) for _ in range(6))
    n_surf, n_bott, death, dseg = (torch.empty(B, dtype=torch.int32, device=dev)
                                   for _ in range(4))
    if B > 0:
        c = inp.consts
        _launch("trace_tangent_save_f32", dev,
                [inp.p0.data_ptr(), dp0v.data_ptr(), inp.z0.data_ptr(), dz0v.data_ptr(),
                 *inp.pointers(), *(o.data_ptr() for o in grids),
                 *(o.data_ptr() for o in (n_surf, n_bott, death, dseg)),
                 B, inp.ccoef.shape[0], inp.bacoef.shape[0], nseg, sps, int(c.use_pow),
                 int(c.bangle_cheb), int(c.term_back)],
                inp, geom)
        TANGENT_SAVE_LAUNCHES += 1

    ts, zs, ps, dts, dzs, dps = (g.t().contiguous() for g in grids)
    # alive at save point k  <=>  k precedes the ray's first-dead save index
    alive_save = torch.arange(nseg + 1, dtype=torch.int32, device=dev)[None, :] < dseg[:, None]
    res = TraceResult(
        rs=_save_ranges(x0, x1, nseg, ts), ts=ts, zs=zs, ps=ps, n_bott=n_bott, n_surf=n_surf,
        alive=death == 0, alive_save=alive_save, death_code=death,
    )
    return res, (dts, dzs, dps)


def trace_tangent_ensemble_kernel(env_ens, z0, p0, dp0, geom, settings, sd=None):
    """Final-state trace with one forward tangent across an ensemble
    through the CUDA kernel: realization e's (M,) launch parameters
    ``p0[e]`` and seeds ``dp0[e]`` against its own range-dependent field;
    returns ``(T, z, p, dT, dz, dp, n_surf, n_bott, death)``, each (E, M),
    in the ODE convention (counterpart of ``trace_pallas_tangent_ensemble``).
    ``env_ens`` is a stacked ensemble (``make_env_ensemble``) whose
    realizations share their bathymetry; ``z0`` is one scalar source depth;
    no Kahan compensation.  ``sd`` is the ensemble's step data
    (``integrate._ens_step_data``), which a caller that launches more than
    once (the Monte-Carlo Newton loop) builds once; built here when None.

    On a CUDA ensemble this launches the kernel or raises; on a CPU
    ensemble it runs the plain version, ``_trace_tangent_ens_impl``.
    """
    global TANGENT_ENS_LAUNCHES
    if torch.as_tensor(z0).ndim != 0:
        raise ValueError("the ensemble tangent kernel takes a scalar source depth (got shape "
                         f"{tuple(torch.as_tensor(z0).shape)}); per-candidate depths are "
                         "unsupported")
    env0 = env_member(env_ens, 0)
    if not tangent_supported(env0, settings):
        raise ValueError("configuration not covered by the CUDA ensemble tangent kernel")
    dev = _check_device(env_ens, "trace_tangent_ensemble_kernel")
    if sd is None:
        sd = _ens_step_data(env_ens, geom, settings)
    if dev.type == "cpu":
        return _trace_tangent_ens_impl(env_ens, z0, p0, dp0, geom, settings, sd)

    p0 = torch.as_tensor(p0, dtype=torch.float32, device=dev).contiguous()
    E, M = p0.shape
    if E != env_ens.c.shape[0]:
        raise ValueError(f"p0 has {E} rows for an ensemble of {env_ens.c.shape[0]}")
    dp0v = torch.as_tensor(dp0, dtype=torch.float32, device=dev).expand(E, M).contiguous()
    outs = tuple(torch.empty((E, M), dtype=torch.float32, device=dev) for _ in range(6)) + tuple(
        torch.empty((E, M), dtype=torch.int32, device=dev) for _ in range(3))
    if M > 0:
        # realization e's rows at offset e * nsteps * K; bathymetry, bottom
        # angle and launch constants from realization 0
        c, _ = _launch_setup(env0, settings, geom)
        inp = _Inputs(None, None, c, *sd.prof0, env0.bangle_cheb.contiguous(), sd.b0s, sd.b1s,
                      sd.oob_step, (*sd.prof_ms, *sd.prof_1s), True)
        _launch("trace_tangent_ens_f32", dev,
                [p0.data_ptr(), dp0v.data_ptr(), float(z0), *inp.pointers(),
                 *(o.data_ptr() for o in outs),
                 E, M, inp.ccoef.shape[1], inp.bacoef.shape[0], geom[3] * geom[4],
                 int(c.use_pow), int(c.bangle_cheb), int(c.term_back)],
                inp, geom)
        TANGENT_ENS_LAUNCHES += 1
    return outs


def _coef_launch(env, z0, p0, dcoef, dcpcoef, geom, settings, rd, geo):
    """Both coefficient-tangent wrappers: the checks, the plain version on
    a CPU environment, else one launch of ``trace_coef_tangent_f32``
    (range-independent, or ``rd``), counted; ``geo``: ``step_geometry``,
    built here when None."""
    global COEF_TANGENT_LAUNCHES, COEF_TANGENT_RD_LAUNCHES
    if bool(env.range_dependent) != rd:
        raise ValueError("trace_coef_tangent_rd_kernel takes range-dependent fits and "
                         "trace_coef_tangent_kernel range-independent ones")
    env = dataclasses.replace(env, poly_ok=False)
    if not tangent_supported(env, settings):
        raise ValueError("configuration not covered by the CUDA coefficient-tangent kernel")
    dev = _check_device(env, "the coefficient-tangent kernel")
    if dev.type == "cpu":
        impl = _trace_coef_tangent_rd_impl if rd else _trace_coef_tangent_impl
        return impl(env, z0, p0, dcoef, dcpcoef, geom, settings)

    _, _, _, sps, nseg = geom
    K, nr = env.c_cheb.shape[-1], env.c_cheb.shape[0]
    dc, dcp = (torch.as_tensor(d, dtype=torch.float32, device=dev).contiguous()
               for d in (dcoef, dcpcoef))
    if dc.ndim != 2 or dc.shape[1] != K or dcp.shape != dc.shape:
        raise ValueError(f"coefficient directions must be two (D, {K}) tables; got "
                         f"{tuple(dc.shape)} and {tuple(dcp.shape)}")
    if not 1 <= dc.shape[0] <= 65535 or (rd and nr > 65535):
        raise ValueError("the kernel's grid takes 1 to 65535 directions and stations")
    inp = _inputs(env, z0, p0, geom, settings, stations=True, geo=geo)
    B = inp.p0.shape[0]
    tshape = (nr, dc.shape[0], B) if rd else (dc.shape[0], B)
    outs = (tuple(torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3))
            + tuple(torch.empty(tshape, dtype=torch.float32, device=dev) for _ in range(3))
            + tuple(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)))
    if B > 0:
        c = inp.consts
        _launch("trace_coef_tangent_f32", dev,
                [inp.p0.data_ptr(), inp.z0.data_ptr(), *inp.station_pointers(), dc.data_ptr(),
                 dcp.data_ptr(), *(o.data_ptr() for o in outs),
                 B, K, inp.bacoef.shape[0], sps * nseg, dc.shape[0], nr if rd else 1,
                 int(c.bangle_cheb), int(c.term_back)],
                inp, geom)
        if rd:
            COEF_TANGENT_RD_LAUNCHES += 1
        else:
            COEF_TANGENT_LAUNCHES += 1
    return outs


def trace_coef_tangent_kernel(env, z0, p0, dcoef, dcpcoef, geom, settings, geo=None):
    """Final-state trace with one forward tangent per coefficient direction
    of a range-independent spectral fit, through the CUDA kernel: direction
    d perturbs the Chebyshev coefficients ``c + a * dcoef[d]`` and ``dc/dz
    + a * dcpcoef[d]`` together.  Returns ``(T, z, p, dT, dz, dp, n_surf,
    n_bott, death)``: the primal fields and counters (B,), the tangents (D,
    B), in the ODE convention (counterpart of ``trace_pallas_coef_tangent``).
    The series are evaluated by Clenshaw whatever ``env.poly_ok`` says (the
    wrapper traces ``dataclasses.replace(env, poly_ok=False)``); no Kahan
    compensation.  ``geo``: the plan's ``step_geometry``, built here when
    None.

    On a CUDA environment this launches the kernel or raises; on a CPU
    environment it runs the plain version, ``_trace_coef_tangent_impl``.
    """
    return _coef_launch(env, z0, p0, dcoef, dcpcoef, geom, settings, False, geo)


def trace_coef_tangent_rd_kernel(env, z0, p0, dcoef, dcpcoef, geom, settings, geo=None):
    """``trace_coef_tangent_kernel`` for a range-dependent spectral fit:
    every direction g of ``(dcoef, dcpcoef)`` (Dk, K) applied at each
    station j in turn, through the CUDA kernel.  Returns the primal fields
    and counters (B,) and the tangents (nr, Dk, B) (counterpart of
    ``trace_pallas_coef_tangent_rd``).  Clenshaw whatever ``env.poly_ok``
    says; no Kahan compensation.  ``geo``: the plan's ``step_geometry``,
    built here when None.

    On a CUDA environment this launches the kernel or raises; on a CPU
    environment it runs the plain version, ``_trace_coef_tangent_rd_impl``.
    """
    return _coef_launch(env, z0, p0, dcoef, dcpcoef, geom, settings, True, geo)
