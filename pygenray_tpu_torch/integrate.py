"""Batched, event-aware fixed-step ray integration in torch ops.

Counterpart of ``pygenray_tpu/integrate.py``.  The whole (B,) fan of rays
advances together through shared range stations:

* **Fixed-step RK4** with the end derivative carried to the next step
  (first-same-as-last).
* **Reflections without terminal events.**  Surface/bottom crossings are
  detected per step, localized inside the step with a cubic Hermite model
  of z(x) plus two Newton iterations, the state is interpolated to the
  crossing, reflected (θ' = -θ at the surface, θ' = 2β - θ at the bottom,
  with no inverse trig), and the rest of the step is re-integrated with
  Heun — all as ``torch.where`` merges.
* **Alive-masks instead of ray dropping.**  Vertical rays, domain exits and
  backwards bounces freeze the ray state and set a death code.
* **Compensated (Kahan) accumulation** of T and z, so float32 runs hold
  travel-time error far below the 0.1 ms tomography budget.

``_trace_impl`` is a plain Python loop over segments and steps with the
same arithmetic as the JAX scan, line for line.  It covers every profile
backend (table, Chebyshev by Horner or Clenshaw, segment), range-dependent
fields, all bottom-angle models, float32 and float64.  It is the port's CPU
path and the plain version of the CUDA kernel (``ops/stepper.py``), which
``trace`` launches for the configurations it covers when the environment
lives on a CUDA device.

The step is written once (``_event_step``) over the helpers of
``ops/dual.py``: on tensors it is the forward trace's arithmetic, on
``Dual`` (value, tangent) pairs it also carries one forward tangent.
``_trace_tangent_impl`` runs it that way for the final state and its
derivative with respect to the launch parameter: the Newton engine of
the eigenray search and the plain version of the tangent kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .envdata import EnvData, env_member
from .ops import dual as D
from .ops.cheb import clenshaw, horner
from .ops.interp import cubic_spline_eval, interval_index, linear_interp

__all__ = ["SolverSettings", "TraceResult", "trace", "DEATH_CODES"]

# The JAX package also defines code 5 (its Pallas calm-block audit); the
# port has no calm blocks, so that code never occurs here.
DEATH_CODES = {
    0: "alive",
    1: "vertical",
    2: "out_of_domain",
    3: "backwards",
}

_TINY = 1e-30
BACKENDS = ("auto", "ops", "kernel")


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration.

    ``dx`` is the nominal range step [m]; the actual step is chosen so an
    integer number of steps lands exactly on each save point.  ``interp``
    selects the profile backend: "auto" uses the spectral (Chebyshev) path
    when the environment fit succeeded, else the segment fit, else exact
    table interpolation.  ``backend``: "auto" launches the CUDA kernel when
    the environment is on a CUDA device and the kernel covers the
    configuration, else runs the torch-op loop; "ops" always runs the
    torch-op loop; "kernel" runs the kernel's wrapper and raises when the
    kernel does not cover the configuration.
    """

    dx: float = 50.0
    interp: str = "auto"  # auto | table | cheb | seg
    terminate_backwards: bool = True
    vertical_limit_deg: float = 90.0 - 1e-3
    bbox_tol: float = 1e-6
    # compensated (Kahan) accumulation of T and z: essential in float32
    kahan: bool = True
    backend: str = "auto"  # auto | ops | kernel


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Raw fan-trace output in the ODE convention (positive z down)."""

    rs: torch.Tensor  # (num_save,)
    ts: torch.Tensor  # (B, num_save)
    zs: torch.Tensor  # (B, num_save)
    ps: torch.Tensor  # (B, num_save)
    n_bott: torch.Tensor  # (B,) int32
    n_surf: torch.Tensor  # (B,) int32
    alive: torch.Tensor  # (B,) bool — survived to the receiver
    alive_save: torch.Tensor  # (B, num_save) bool — alive at each save point
    death_code: torch.Tensor  # (B,) int32 — see DEATH_CODES


# ---------------------------------------------------------------------------
# profile evaluation
# ---------------------------------------------------------------------------


def _use_cheb(env: EnvData, settings: SolverSettings) -> bool:
    if settings.interp in ("table", "seg"):
        return False
    if settings.interp == "cheb":
        if not env.has_cheb:
            raise ValueError("environment has no Chebyshev fit; use interp='auto'/'table'")
        return True
    return env.has_cheb


def _use_seg(env: EnvData, settings: SolverSettings) -> bool:
    """Piecewise-segment profile backend, used when the global spectral fit
    is absent."""
    if settings.interp == "seg":
        if not env.has_seg:
            raise ValueError("environment has no segment fit; use interp='auto'/'table'")
        return True
    return settings.interp == "auto" and not env.has_cheb and env.has_seg


def _use_pow(env: EnvData, settings: SolverSettings, use_cheb: bool) -> bool:
    """Monomial (Horner) path: 1 fma/term vs Clenshaw's 2 ops/term.
    Guarded per environment at build time (``EnvData.poly_ok``)."""
    return use_cheb and bool(env.poly_ok)


def _profile_tabs(env: EnvData, use_cheb: bool, use_pow: bool, use_seg: bool):
    """Per-station tables for the active profile backend: (nr, K) spectral
    coefficients (monomial when ``use_pow``), (nr, Ks, S) segment tiles, or
    (nr, nz) raw columns."""
    if use_cheb:
        return (env.c_pow, env.dcdz_pow) if use_pow else (env.c_cheb, env.dcdz_cheb)
    if use_seg:
        return env.c_seg, env.dcdz_seg
    return env.c, env.dcdz


def _make_eval(env: EnvData, use_cheb: bool, use_pow: bool = False,
               use_seg: bool = False):
    """Returns ``(ev, ev_c)``: full ``(c, dcdz)`` and c-only evaluation of a
    station profile at batched depths."""
    zlo, zhi = env.z_dom

    if use_seg:
        # piecewise-segment backend: per-ray segment pick + local-u Horner
        # ("pow" basis) or Clenshaw ("cheb" basis)
        S = env.c_seg.shape[-1]
        S_f = float(S)
        hinv = S_f / (zhi - zlo)
        seg_poly = horner if env.seg_basis == "pow" else clenshaw

        def _seg_u(z):
            t = torch.clamp((z - zlo) * hinv, 0.0, S_f)
            segf = torch.clamp(torch.floor(t), max=S_f - 1.0)
            return segf.to(torch.int64), 2.0 * (t - segf) - 1.0

        def ev(prof, z):
            seg, u = _seg_u(z)
            c = seg_poly(u, prof[0].transpose(-1, -2)[seg])
            cp = seg_poly(u, prof[1].transpose(-1, -2)[seg])
            return c, cp

        def ev_c(prof, z):
            seg, u = _seg_u(z)
            return seg_poly(u, prof[0].transpose(-1, -2)[seg])

        return ev, ev_c

    if use_cheb:
        # spectral: the only backend the forward-tangent trace runs, so
        # depths may be Duals (ops.dual); dc/dz's tangent comes from the c
        # series' chain and d(cp) from the cp series'
        sc = 2.0 / (zhi - zlo)
        off = (zlo + zhi) / (zhi - zlo)
        poly = D.horner if use_pow else D.clenshaw

        def ev(prof, z):
            # clamp to the fit domain: constant extrapolation at the edges
            u = D.clamp(sc * z - off, -1.0, 1.0)
            return poly(u, prof[0]), poly(u, prof[1])

        def ev_c(prof, z):
            u = D.clamp(sc * z - off, -1.0, 1.0)
            return poly(u, prof[0])

    else:

        def ev(prof, z):
            i = interval_index(z, env.z, env.uniform_z)
            z0g = env.z[i]
            w = (z - z0g) / (env.z[i + 1] - z0g)
            c = (1.0 - w) * prof[0][i] + w * prof[0][i + 1]
            cp = (1.0 - w) * prof[1][i] + w * prof[1][i + 1]
            return c, cp

        def ev_c(prof, z):
            i = interval_index(z, env.z, env.uniform_z)
            z0g = env.z[i]
            w = (z - z0g) / (env.z[i + 1] - z0g)
            return (1.0 - w) * prof[0][i] + w * prof[0][i + 1]

    return ev, ev_c


def _station_iw(env: EnvData, x):
    """``(i, w)``: the station interval of each range in ``x`` (any shape)
    and the linear weight of station ``i + 1``.  The one source of these
    numbers for the blended tables here and for the segment-mode fan kernel,
    which blends at each coefficient pick instead (``ops/stepper.py``)."""
    i = interval_index(x, env.r, env.uniform_r)
    return i, (x - env.r[i]) / (env.r[i + 1] - env.r[i])


def _station_iw_rows(env: EnvData, geom):
    """``(st_i, st_w)``: the station interval index (int32) and weight of
    ``_station_iw`` at the launch range, then at step k's middle (entry
    2k + 1) and end (2k + 2), each (2 nsteps + 1,).  The kernels that blend
    stations themselves read these rows: the segment-mode fan kernel (at
    each coefficient pick) and the range-dependent coefficient-tangent
    kernel (its hat weights)."""
    _, xsm, xs1 = _step_ranges(env, geom)
    i0, w0 = _station_iw(env, torch.tensor(geom[0], dtype=env.dtype, device=env.device))
    im, wm = _station_iw(env, xsm)
    i1, w1 = _station_iw(env, xs1)
    flat = lambda a0, am, a1: torch.cat([a0.reshape(1), torch.stack([am, a1], 1).reshape(-1)])
    return flat(i0, im, i1).to(torch.int32).contiguous(), flat(w0, wm, w1).contiguous()


def _blend_rows(env: EnvData, ctab, cptab, x):
    """Station tables blended linearly in range at ranges ``x`` (any shape):
    returns a pair of tables with ``x``'s shape prepended."""
    i, w = _station_iw(env, x)
    w = w.reshape(w.shape + (1,) * (ctab.dim() - 1))
    return (
        (1.0 - w) * ctab[i] + w * ctab[i + 1],
        (1.0 - w) * cptab[i] + w * cptab[i + 1],
    )


def _make_bangle(env: EnvData):
    """``sincos2b(x) -> (sin 2β, cos 2β)`` for the bottom reflection.

    The bottom reflection θ' = 2β - θ is applied without any inverse trig:
    sin θ' = sin 2β cos θ - cos 2β sin θ with sin θ = c·p taken directly
    from the ray state.  For a constant-slope bottom, sin/cos 2β are
    Python constants.
    """
    if env.bangle_mode == "const":
        b = math.radians(env.bangle_const)
        s2b, c2b = math.sin(2 * b), math.cos(2 * b)

        def sincos2b(x):
            return s2b, c2b

    elif env.bangle_mode == "cheb":
        coef = env.bangle_cheb
        blo, bhi = env.bathy_r_dom
        span = _scalar(bhi - blo, coef)

        def sincos2b(x):  # x may be a Dual (the forward-tangent trace)
            u = D.clamp((2.0 * x - (blo + bhi)) / span, -1.0, 1.0)
            b2 = 2.0 * (D.clenshaw(u, coef) * (math.pi / 180.0))
            return D.sincos(b2)

    else:

        def sincos2b(x):
            beta = cubic_spline_eval(x, env.bathy_r, env.bangle_coef, env.uniform_bathy_r)
            b2 = 2.0 * (beta * (math.pi / 180.0))
            return torch.sin(b2), torch.cos(b2)

    return sincos2b


# ---------------------------------------------------------------------------
# cubic Hermite (normalized s in [0,1]; slopes pre-scaled by h)
# ---------------------------------------------------------------------------


def _hermite(s, y0, y1, m0, m1):
    s2 = s * s
    s3 = s2 * s
    return (
        (2 * s3 - 3 * s2 + 1) * y0
        + (s3 - 2 * s2 + s) * m0
        + (-2 * s3 + 3 * s2) * y1
        + (s3 - s2) * m1
    )


def _hermite_d(s, y0, y1, m0, m1):
    s2 = s * s
    return (
        (6 * s2 - 6 * s) * y0
        + (3 * s2 - 4 * s + 1) * m0
        + (-6 * s2 + 6 * s) * y1
        + (3 * s2 - 2 * s) * m1
    )


def _kahan_add(val, comp, delta):
    y = delta - comp
    t = val + y
    comp = (t - val) - y
    return t, comp


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor beside ``like``.  Divide by this, never by a
    Python number: on a CUDA device torch turns ``t / 6.0`` into
    ``t * (1/6.0)``, which rounds differently from the IEEE division the
    CPU (and the CUDA kernel) performs."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _save_ranges(x0: float, x1: float, nseg: int, like: torch.Tensor) -> torch.Tensor:
    """The nseg+1 save ranges, in ``like``'s dtype and device."""
    ks = torch.arange(nseg + 1, dtype=like.dtype, device=like.device)
    return x0 + (x1 - x0) * ks / _scalar(float(nseg), like)


def _plan(x0: float, x1: float, num_save: int, dx: float):
    """Static step plan: (h, steps_per_seg, num_seg)."""
    num_seg = max(1, num_save - 1)
    seg_len = (x1 - x0) / num_seg
    steps_per_seg = max(1, int(round(seg_len / dx)))
    h = seg_len / steps_per_seg
    return h, steps_per_seg, num_seg


def _as_batch(env: EnvData, z0, p0):
    """(B,) launch tensors on the environment's device and dtype."""
    p0 = torch.as_tensor(p0, dtype=env.dtype, device=env.device).reshape(-1)
    z0 = torch.as_tensor(z0, dtype=env.dtype, device=env.device).expand(p0.shape)
    return z0, p0


@dataclasses.dataclass(frozen=True)
class StepData:
    """Per-step inputs of a trace, computed once outside the step loop.
    The kernels' wrappers (``ops/stepper.py``) pass these same tensors to
    the CUDA kernels, so kernel and plain version read the same numbers."""

    xs0: torch.Tensor  # (nsteps,) step start ranges
    b0s: torch.Tensor  # (nsteps,) bathymetry at each step's start ...
    b1s: torch.Tensor  # ... and end
    oob_step: torch.Tensor  # (nsteps,) bool: x leaves the range domain
    prof0: tuple  # profile tables at x0 (the initial right-hand side)
    prof_ms: tuple | None  # range-dependent: per-step rows at mid-step ...
    prof_1s: tuple | None  # ... and at the step's end; None otherwise


def _step_ranges(env: EnvData, geom):
    """``(xs0, xsm, xs1)``: each step's start, middle and end range."""
    x0, _, h, sps, nseg = geom
    ks = torch.arange(sps * nseg, dtype=env.dtype, device=env.device)
    xs0 = x0 + ks * h
    return xs0, xs0 + 0.5 * h, x0 + (ks + 1.0) * h


def _step_data(env: EnvData, geom, use_cheb, use_pow, use_seg, btol,
               oob_step=None, blend=True) -> StepData:
    """``oob_step``: the domain flags when the caller holds them already
    (the kernels' wrappers cache them per plan).  ``blend=False`` leaves a
    range-dependent field's tables unblended (``prof0``, ``prof_ms`` and
    ``prof_1s`` None): the segment-mode kernel blends at each pick."""
    x0, _, h, sps, nseg = geom
    nsteps = sps * nseg
    dtype, device = env.dtype, env.device
    rlo, rhi = env.r_dom
    xs0, xsm, xs1 = _step_ranges(env, geom)
    b0s = linear_interp(xs0, env.bathy_r, env.bathy, env.uniform_bathy_r)
    b1s = linear_interp(xs1, env.bathy_r, env.bathy, env.uniform_bathy_r)
    if oob_step is None:
        # out-of-domain flags precomputed on the host in float64: f32 x0 +
        # k*h accumulates ~mm of rounding over 100 km, which must not decide
        # deaths
        ks64 = np.arange(nsteps, dtype=np.float64)
        oob_step = torch.as_tensor(
            (x0 + ks64 * h < rlo - btol) | (x0 + (ks64 + 1.0) * h > rhi + btol),
            device=device,
        )
    ctab, cptab = _profile_tabs(env, use_cheb, use_pow, use_seg)
    if env.range_dependent and not blend:
        prof0 = prof_ms = prof_1s = None
    elif env.range_dependent:
        prof_ms = _blend_rows(env, ctab, cptab, xsm)
        prof_1s = _blend_rows(env, ctab, cptab, xs1)
        prof0 = _blend_rows(env, ctab, cptab, torch.tensor(x0, dtype=dtype, device=device))
    else:
        prof_ms = prof_1s = None
        prof0 = (ctab[0], cptab[0])
    return StepData(xs0, b0s, b1s, oob_step, prof0, prof_ms, prof_1s)


def _make_rhs(ev):
    """``rhs(prof, z, p) -> (dT/dx, dz/dx, dp/dx, c)``; z and p may be
    Duals."""

    def rhs(prof, z, p):
        c, cp = ev(prof, z)
        cp2 = c * p
        inv_s = D.rsqrt(D.maximum(1.0 - cp2 * cp2, _TINY))
        invc = 1.0 / c
        return inv_s * invc, cp2 * inv_s, -cp * inv_s * invc * invc, c

    return rhs


def _event_step(rhs, ev_c, sincos2b, hs, h6, term_back, prof_m, prof_1, b0, b1, x0k,
                alive, z, p, kT1, kz1, kp1):
    """One RK4 step with the boundary-crossing fix, before it is applied:
    returns ``(dT_tot, dz_tot, p_new, surf, bott, cross, back_dead)``.
    The ray state may be tensors or Duals (``ops.dual``); the branch masks
    read values only.  Counterpart of the JAX package's
    ``_make_step_math`` (``ops/pallas_stepper.py:739-821``)."""
    # -- RK4 step (k1 carried from previous step's end derivative)
    kT2, kz2, kp2, _ = rhs(prof_m, z + 0.5 * hs * kz1, p + 0.5 * hs * kp1)
    kT3, kz3, kp3, _ = rhs(prof_m, z + 0.5 * hs * kz2, p + 0.5 * hs * kp2)
    kT4, kz4, kp4, _ = rhs(prof_1, z + hs * kz3, p + hs * kp3)
    dT = h6 * (kT1 + 2 * kT2 + 2 * kT3 + kT4)
    dz = h6 * (kz1 + 2 * kz2 + 2 * kz3 + kz4)
    dp = h6 * (kp1 + 2 * kp2 + 2 * kp3 + kp4)
    z1 = z + dz
    p1 = p + dp

    # -- boundary crossing detection
    surf = (z1 < 0.0) & (z >= 0.0)
    bott = (z1 > b1) & (z <= b0)
    cross = alive & (surf | bott)

    # -- localize the crossing inside the step (cubic Hermite in s)
    bnd0 = torch.where(surf, 0.0, b0)
    bnd1 = torch.where(surf, 0.0, b1)
    db = bnd1 - bnd0
    mz0 = hs * kz1
    mz1 = hs * kz4
    g0 = z - bnd0
    g1 = z1 - bnd1
    f = g0 / D.where(torch.abs(D.value(g0 - g1)) > _TINY, g0 - g1, 1.0)
    f = D.clamp(f, 0.0, 1.0)
    for _ in range(2):  # Newton refinement on the Hermite cubic
        G = _hermite(f, z, z1, mz0, mz1) - (bnd0 + f * db)
        Gp = _hermite_d(f, z, z1, mz0, mz1) - db
        f = D.clamp(f - G / D.where(torch.abs(D.value(Gp)) > _TINY, Gp, 1.0), 0.0, 1.0)

    # -- state at the crossing
    t_off = _hermite(f, D.zeros_like(dT), dT, hs * kT1, hs * kT4)
    z_c = _hermite(f, z, z1, mz0, mz1)
    p_c = _hermite(f, p, p1, hs * kp1, hs * kp4)
    x_c = x0k + f * hs

    # -- reflect (transcendental-free; see _make_bangle)
    c_c = ev_c(prof_m, z_c)
    sin_th = D.clamp(p_c * c_c, -1.0, 1.0)
    cos_th = D.sqrt(D.maximum(1.0 - sin_th * sin_th, 0.0))
    s2b, c2b = sincos2b(x_c)
    p_ref = D.where(surf, -p_c, (s2b * cos_th - c2b * sin_th) / c_c)
    if term_back:
        # |2β - θ| > 90°  ⇔  cos(2β - θ) < 0; small epsilon so the
        # degenerate vertical-ray case is not misclassified — it dies as
        # vertical
        back_dead = cross & bott & (D.value(c2b * cos_th + s2b * sin_th) < -1e-9)
    else:
        back_dead = torch.zeros_like(cross)

    # -- re-integrate the remainder of the step from the crossing
    # (Heun: at most one step long, starting on the boundary)
    hr = (1.0 - f) * hs
    rT1, rz1, rp1, _ = rhs(prof_m, z_c, p_ref)
    rT2, rz2, rp2, _ = rhs(prof_1, z_c + hr * rz1, p_ref + hr * rp1)
    dT_fix = t_off + hr * 0.5 * (rT1 + rT2)
    z_fix = z_c + hr * 0.5 * (rz1 + rz2)
    p_fix = p_ref + hr * 0.5 * (rp1 + rp2)

    # -- merge
    use_fix = cross & ~back_dead
    dT_tot = D.where(use_fix, dT_fix, dT)
    dz_tot = D.where(use_fix, z_fix - z, dz)
    p_new = D.where(use_fix, p_fix, p1)
    return dT_tot, dz_tot, p_new, surf, bott, cross, back_dead


class _Stepper:
    """What both traces share: the evaluators, the per-step data and the
    step constants of one (environment, plan, settings)."""

    def __init__(self, env: EnvData, geom, settings: SolverSettings, sd: StepData = None):
        x0, x1, h, sps, nseg = geom
        self.nseg, self.sps = nseg, sps
        use_cheb = _use_cheb(env, settings)
        use_pow = _use_pow(env, settings, use_cheb)
        use_seg = _use_seg(env, settings)
        ev, self.ev_c = _make_eval(env, use_cheb, use_pow, use_seg)
        self.rhs = _make_rhs(ev)
        self.sincos2b = _make_bangle(env)
        self.zlo, self.zhi = env.z_dom
        self.btol = settings.bbox_tol
        self.sin_lim = math.sin(math.radians(settings.vertical_limit_deg))
        self.term_back = settings.terminate_backwards
        self.hs = torch.tensor(h, dtype=env.dtype, device=env.device)
        self.h6 = self.hs / _scalar(6.0, self.hs)
        self.sd = sd or _step_data(env, geom, use_cheb, use_pow, use_seg, self.btol)
        self.prof0 = self.sd.prof0  # the initial right-hand side's tables

    def rows(self, k):
        """(mid-step, end-of-step) profile tables of step k."""
        sd = self.sd
        if sd.prof_ms is None:
            return sd.prof0, sd.prof0
        return (sd.prof_ms[0][k], sd.prof_ms[1][k]), (sd.prof_1s[0][k], sd.prof_1s[1][k])

    def alive0(self, z0):
        return (z0 >= self.zlo - self.btol) & (z0 <= self.zhi + self.btol)

    def step(self, k, alive, z, p, kT1, kz1, kp1):
        prof_m, prof_1 = self.rows(k)
        return _event_step(
            self.rhs, self.ev_c, self.sincos2b, self.hs, self.h6, self.term_back,
            prof_m, prof_1, self.sd.b0s[k], self.sd.b1s[k], self.sd.xs0[k],
            alive, z, p, kT1, kz1, kp1,
        )

    def end_of_step(self, k, alive, z, p, kT1, kz1, kp1, back_dead, death):
        """Next step's k1 and the death checks (codes 3 > 1 > 2); returns
        ``(kT, kz, kp, death, newly_dead)``."""
        _, prof_1 = self.rows(k)
        kTe, kze, kpe, c_e = self.rhs(prof_1, z, p)
        zv = D.value(z)
        vert = torch.abs(D.value(c_e) * D.value(p)) > self.sin_lim
        oob = (zv > self.zhi + self.btol) | (zv < self.zlo - self.btol) | self.sd.oob_step[k]
        newly = alive & (vert | oob | back_dead)
        death = torch.where(
            alive & back_dead, 3,
            torch.where(alive & vert, 1, torch.where(alive & oob, 2, death)),
        ).to(torch.int32)
        return (D.where(alive, kTe, kT1), D.where(alive, kze, kz1), D.where(alive, kpe, kp1),
                death, newly)


class _EnsStepper(_Stepper):
    """Realization 0's ``_Stepper`` (evaluators, bathymetry, domain flags,
    step constants) over an (E, M) ray state, each realization reading its
    own profile rows from ``_ens_step_data`` as (E, 1, K) tables."""

    def __init__(self, env_ens: EnvData, geom, settings: SolverSettings, sd: StepData):
        super().__init__(env_member(env_ens, 0), geom, settings, sd)
        self.prof0 = tuple(t[:, None] for t in sd.prof0)

    def rows(self, k):
        sd = self.sd
        return tuple(t[:, k, None] for t in sd.prof_ms), tuple(t[:, k, None] for t in sd.prof_1s)


def _ens_step_data(env_ens: EnvData, geom, settings: SolverSettings, oob_step=None) -> StepData:
    """Each realization's spectral step data stacked: ``prof0`` (E, K),
    ``prof_ms`` and ``prof_1s`` (E, nsteps, K), every realization's rows
    blended by ``_blend_rows`` at the shared stations, so row e is
    ``_step_data`` on realization e bit for bit; the ranges, bathymetry and
    domain flags are realization 0's.  The ensemble tangent kernel reads
    these tensors and its plain version these numbers; a caller that traces
    an ensemble more than once (the Monte-Carlo Newton loop) builds them
    once.  Raises unless the fits are range-dependent and every
    realization has realization 0's stations, bathymetry and bottom angle,
    which the kernel shares (as the JAX kernel does,
    ``pallas_stepper.py:1309``)."""
    if not env_ens.range_dependent:
        raise ValueError("the ensemble tangent trace requires range-dependent fits")
    for f in ("r", "bathy", "bathy_r", "bottom_angle", "bangle_cheb"):
        t = getattr(env_ens, f)
        if not bool((t == t[:1]).all()):
            raise ValueError(f"the ensemble tangent trace takes realization 0's stations, "
                             f"bathymetry and bottom angle for every realization; {f} differs")
    env0 = env_member(env_ens, 0)
    use_pow = _use_pow(env0, settings, True)
    sd0 = _step_data(env0, geom, True, use_pow, False, settings.bbox_tol, oob_step, blend=False)
    # (nr, E, K) station tables: blended rows come out (..., E, K)
    ctab, cptab = (t.transpose(0, 1) for t in _profile_tabs(env_ens, True, use_pow, False))
    _, xsm, xs1 = _step_ranges(env0, geom)
    per_e = lambda rows: tuple(t.transpose(0, 1).contiguous() for t in rows)
    x0 = torch.tensor(geom[0], dtype=env_ens.dtype, device=env_ens.device)
    return dataclasses.replace(
        sd0, prof0=tuple(t.contiguous() for t in _blend_rows(env0, ctab, cptab, x0)),
        prof_ms=per_e(_blend_rows(env0, ctab, cptab, xsm)),
        prof_1s=per_e(_blend_rows(env0, ctab, cptab, xs1)))


def _trace_impl(env: EnvData, z0, p0, geom, settings: SolverSettings) -> TraceResult:
    x0, x1, h, sps, nseg = geom
    dtype, device = env.dtype, env.device
    z0, p0 = _as_batch(env, z0, p0)
    B = p0.shape[0]
    st = _Stepper(env, geom, settings)

    # ---- initial state ---------------------------------------------------
    kT, kz, kp, _ = st.rhs(st.prof0, z0, p0)
    alive = st.alive0(z0)
    death = torch.where(alive, 0, 2).to(torch.int32)
    T = torch.zeros(B, dtype=dtype, device=device)
    Tc = torch.zeros(B, dtype=dtype, device=device)
    z = z0
    zc = torch.zeros(B, dtype=dtype, device=device)
    p = p0
    n_surf = torch.zeros(B, dtype=torch.int32, device=device)
    n_bott = torch.zeros(B, dtype=torch.int32, device=device)
    saves = [(T, z0, p0, alive)]

    for seg in range(nseg):
        for k in range(seg * sps, (seg + 1) * sps):
            dT_tot, dz_tot, p_new, surf, bott, cross, back_dead = st.step(
                k, alive, z, p, kT, kz, kp)
            upd = alive
            if settings.kahan:
                T, Tc = _kahan_add(T, Tc, torch.where(upd, dT_tot, 0.0))
                z, zc = _kahan_add(z, zc, torch.where(upd, dz_tot, 0.0))
            else:
                T = T + torch.where(upd, dT_tot, 0.0)
                z = z + torch.where(upd, dz_tot, 0.0)
            p = torch.where(upd, p_new, p)
            n_surf = n_surf + (cross & surf & upd).to(torch.int32)
            n_bott = n_bott + (cross & bott & upd).to(torch.int32)
            kT, kz, kp, death, newly = st.end_of_step(k, alive, z, p, kT, kz, kp,
                                                      back_dead, death)
            alive = alive & ~newly

        # compensated readout: comp holds the amount the running value
        # OVERSHOT the true sum, so the corrected value is val - comp
        saves.append((T - Tc, z - zc, p, alive))

    # assemble save-grid arrays: initial state + one point per segment
    rs = _save_ranges(x0, x1, nseg, st.hs)
    ts, zs, ps, alive_save = (torch.stack(col, dim=1) for col in zip(*saves))
    return TraceResult(
        rs=rs,
        ts=ts,
        zs=zs,
        ps=ps,
        n_bott=n_bott,
        n_surf=n_surf,
        alive=alive,
        alive_save=alive_save,
        death_code=death,
    )


def _check_tangent(env: EnvData, settings: SolverSettings):
    if not _use_cheb(env, settings) or env.bangle_mode not in ("const", "cheb"):
        raise ValueError("the forward-tangent trace needs a spectral profile and a "
                         "constant or Chebyshev bottom angle")


def _tangent_loop(st: _Stepper, z0, p0, dp0, dz0, save: bool):
    """The forward trace's step run on Duals (``ops.dual``) seeded with
    ``(dp0, dz0)``, without Kahan compensation, over launch tensors ``z0``
    and ``p0`` of one shape, (B,) or, through an ``_EnsStepper``, (E, M).
    Returns the final ``(T, z, p)`` Duals, ``n_surf``, ``n_bott``, ``death``
    and, with ``save``, the list of ``(T, z, p, alive)`` at row 0 and after
    every segment (else None).  One loop for every tangent trace, so the
    save grid's last row is the final-state trace bit for bit, and an
    ensemble's row e the final-state trace on realization e."""
    dtype, device = p0.dtype, p0.device
    dp0 = torch.as_tensor(dp0, dtype=dtype, device=device).expand(p0.shape)
    zero = torch.zeros(p0.shape, dtype=dtype, device=device)
    if dz0 is None:
        dz0 = zero
    else:
        dz0 = torch.as_tensor(dz0, dtype=dtype, device=device).expand(p0.shape)
    p = D.Dual(p0, dp0)
    z = D.Dual(z0, dz0)
    kT, kz, kp, _ = st.rhs(st.prof0, z, p)
    alive = st.alive0(z0)
    death = torch.where(alive, 0, 2).to(torch.int32)
    T = D.Dual(zero, zero)
    n_surf = torch.zeros(p0.shape, dtype=torch.int32, device=device)
    n_bott = torch.zeros(p0.shape, dtype=torch.int32, device=device)
    saves = [(T, z, p, alive)] if save else None
    for seg in range(st.nseg):
        for k in range(seg * st.sps, (seg + 1) * st.sps):
            dT_tot, dz_tot, p_new, surf, bott, cross, back_dead = st.step(
                k, alive, z, p, kT, kz, kp)
            T = T + D.where(alive, dT_tot, 0.0)
            z = z + D.where(alive, dz_tot, 0.0)
            p = D.where(alive, p_new, p)
            n_surf = n_surf + (cross & surf & alive).to(torch.int32)
            n_bott = n_bott + (cross & bott & alive).to(torch.int32)
            kT, kz, kp, death, newly = st.end_of_step(k, alive, z, p, kT, kz, kp,
                                                      back_dead, death)
            alive = alive & ~newly
        if save:
            saves.append((T, z, p, alive))
    return T, z, p, n_surf, n_bott, death, saves


def _trace_tangent_impl(env: EnvData, z0, p0, dp0, geom, settings: SolverSettings):
    """Final-state trace plus one forward tangent seeded by ``dp0`` (the
    tangent of ``p0``; the source depth's is 0).  Returns ``(T, z, p, dT,
    dz, dp, n_surf, n_bott, death)``, each (B,), in the ODE convention, as
    the JAX package's ``trace_pallas_tangent`` does.

    The plain version of the tangent kernel (``ops/stepper.py``,
    ``csrc/trace_tangent.cu``): the forward trace's step run on Duals
    (``ops.dual``), without Kahan compensation whatever ``settings.kahan``
    says (the forward-AD convention of the JAX package), so its primal is
    ``_trace_impl`` with ``kahan=False``.  Covers spectral profiles
    (Horner or Clenshaw; range-independent or range-dependent) with a
    constant or Chebyshev bottom angle, float32 or float64.
    """
    _check_tangent(env, settings)
    st = _Stepper(env, geom, settings)
    z0, p0 = _as_batch(env, z0, p0)
    T, z, p, n_surf, n_bott, death, _ = _tangent_loop(st, z0, p0, dp0, None, save=False)
    return T.v, z.v, p.v, T.t, z.t, p.t, n_surf, n_bott, death


def _trace_tangent_save_impl(env: EnvData, z0, p0, dp0, geom, settings: SolverSettings,
                             dz0=None):
    """Save-grid trace plus one forward tangent seeded by ``(dp0, dz0)``,
    the tangents of the launch parameter and of the source depth (``dz0``
    defaults to 0).  Returns ``(TraceResult, (dts, dzs, dps))``, the tangent
    arrays (B, nseg+1), in the ODE convention, as the JAX package's
    ``trace_pallas_tangent_save`` does.

    The plain version of the save-grid tangent kernel (``ops/stepper.py``,
    ``csrc/trace_tangent_save.cu``): the loop of ``_trace_tangent_impl``
    with the state and its tangent stored at the launch point and after
    every segment.  No Kahan compensation, so the primal is ``_trace_impl``
    with ``kahan=False`` and the last row is ``_trace_tangent_impl`` (for
    ``dz0 = 0``), both bit for bit.  A dead ray's later rows hold its frozen
    state and tangent.  Same coverage as ``_trace_tangent_impl``.
    """
    x0, x1, _, _, nseg = geom
    _check_tangent(env, settings)
    st = _Stepper(env, geom, settings)
    z0, p0 = _as_batch(env, z0, p0)
    _, _, _, n_surf, n_bott, death, saves = _tangent_loop(st, z0, p0, dp0, dz0, save=True)
    Ts, zs, ps, alives = zip(*saves)
    grid = lambda duals, part: torch.stack([getattr(d, part) for d in duals], dim=1)
    res = TraceResult(
        rs=_save_ranges(x0, x1, nseg, Ts[0].v),
        ts=grid(Ts, "v"),
        zs=grid(zs, "v"),
        ps=grid(ps, "v"),
        n_bott=n_bott,
        n_surf=n_surf,
        alive=alives[-1],
        alive_save=torch.stack(alives, dim=1),
        death_code=death,
    )
    return res, (grid(Ts, "t"), grid(zs, "t"), grid(ps, "t"))


def _trace_tangent_ens_impl(env_ens: EnvData, z0, p0, dp0, geom, settings: SolverSettings,
                            sd: StepData = None):
    """``_trace_tangent_impl`` over an ensemble: realization ``e``'s (M,)
    launch parameters ``p0[e]`` and seeds ``dp0[e]`` (``dp0`` broadcasts
    to ``p0``'s (E, M)) against its own profile rows, from one scalar
    source depth ``z0``.  Returns the same nine outputs with (E, M) fields.
    The plain version of the ensemble tangent kernel (``ops/stepper.py``,
    ``csrc/trace_tangent_ens.cu``): one Dual loop over the (E, M) rays,
    reading the rows the kernel is given (``_ens_step_data``; ``sd`` when
    the caller holds them already), so row e is ``_trace_tangent_impl`` on
    realization e bit for bit."""
    _check_tangent(env_member(env_ens, 0), settings)
    st = _EnsStepper(env_ens, geom, settings, sd or _ens_step_data(env_ens, geom, settings))
    p0 = torch.as_tensor(p0, dtype=env_ens.dtype, device=env_ens.device)
    z0 = torch.as_tensor(z0, dtype=env_ens.dtype, device=env_ens.device).expand(p0.shape)
    T, z, p, n_surf, n_bott, death, _ = _tangent_loop(st, z0, p0, dp0, None, save=False)
    return T.v, z.v, p.v, T.t, z.t, p.t, n_surf, n_bott, death


class _CoefStepper(_Stepper):
    """A ``_Stepper`` whose profile tables are ``Dual``\\ s: the primal
    rows with, as their tangent, a coefficient direction ``(dcoef,
    dcpcoef)`` (D, K) of the (c, dc/dz) Chebyshev series.  Range-independent:
    the ray state is (D, B) and every step's tables carry the tangent (D, 1,
    K).  Range-dependent: the state is (nr, D, B), and station j's tangent
    row at range x is ``hat_j(x) * dcoef`` with the linear hat weight
    ``hat_j = (1 - w)[i == j] + w[i + 1 == j]`` of the station interval (i,
    w) there (``_station_iw_rows``), a (nr, D, 1, K) table.  Clenshaw only
    (the caller's environment has ``poly_ok`` off)."""

    def __init__(self, env: EnvData, geom, settings: SolverSettings, dcoef, dcpcoef):
        super().__init__(env, geom, settings)
        self.rd = bool(env.range_dependent)
        if not self.rd:
            dt = (dcoef[:, None, :], dcpcoef[:, None, :])
            self.prof0 = self._dual(self.sd.prof0, dt)
            return
        st_i, st_w = _station_iw_rows(env, geom)
        j = torch.arange(env.c_cheb.shape[0], dtype=torch.int32, device=env.device)
        i, w = st_i[:, None], st_w[:, None]
        # (2 nsteps + 1, nr): d(blended row)/d(station j)
        self.hats = torch.where(i == j, 1.0 - w, torch.where(i == j - 1, w, 0.0))
        self.dir = (dcoef[None, :, None, :], dcpcoef[None, :, None, :])
        self.prof0 = self._dual(self.sd.prof0, self._hat_rows(0))

    @staticmethod
    def _dual(prof, tang):
        return D.Dual(prof[0], tang[0]), D.Dual(prof[1], tang[1])

    def _hat_rows(self, n):
        """The tangent tables at entry ``n`` of the station rows."""
        h = self.hats[n][:, None, None, None]
        return h * self.dir[0], h * self.dir[1]

    def rows(self, k):
        if not self.rd:
            return self.prof0, self.prof0
        prof_m, prof_1 = super().rows(k)
        return (self._dual(prof_m, self._hat_rows(2 * k + 1)),
                self._dual(prof_1, self._hat_rows(2 * k + 2)))


def _coef_tangent_loop(env: EnvData, z0, p0, dcoef, dcpcoef, geom, settings: SolverSettings):
    """What both coefficient-tangent traces share: ``_tangent_loop`` over
    a (D, B) or (nr, D, B) ray state through a ``_CoefStepper`` on the
    Clenshaw environment, launch tangents 0, no Kahan; the primal fields
    and counters are read off the first direction (every direction carries
    the same primal)."""
    env = dataclasses.replace(env, poly_ok=False)
    _check_tangent(env, settings)
    dcoef, dcpcoef = (torch.as_tensor(d, dtype=env.dtype, device=env.device)
                      for d in (dcoef, dcpcoef))
    st = _CoefStepper(env, geom, settings, dcoef, dcpcoef)
    lead = (env.c_cheb.shape[0],) if env.range_dependent else ()
    z0, p0 = (t.expand(*lead, dcoef.shape[0], -1) for t in _as_batch(env, z0, p0))
    T, z, p, n_surf, n_bott, death, _ = _tangent_loop(st, z0, p0, 0.0, None, save=False)
    first = lambda a: a.reshape(-1, a.shape[-1])[0]
    return (first(T.v), first(z.v), first(p.v), T.t, z.t, p.t, first(n_surf), first(n_bott),
            first(death))


def _trace_coef_tangent_impl(env: EnvData, z0, p0, dcoef, dcpcoef, geom,
                             settings: SolverSettings):
    """Final-state trace with one forward tangent per coefficient direction
    of a range-independent spectral fit: direction d perturbs the Chebyshev
    coefficients as ``c + a * dcoef[d]`` and ``dc/dz + a * dcpcoef[d]``
    together and differentiates at a = 0.  Returns ``(T, z, p, dT, dz, dp,
    n_surf, n_bott, death)``: the primal fields and counters (B,), the
    tangents (D, B), in the ODE convention, as the JAX package's
    ``trace_pallas_coef_tangent`` does.

    The plain version of the coefficient-tangent kernel (``ops/stepper.py``,
    ``csrc/trace_coef_tangent.cu``).  The series are evaluated by Clenshaw
    whatever ``env.poly_ok`` says (a unit direction re-expressed in
    monomials has 2^k-scale entries, which a float32 Horner tangent cannot
    carry), so the primal is ``_trace_tangent_impl`` on the
    ``poly_ok=False`` environment, bit for bit.  Float32 or float64."""
    if env.range_dependent:
        raise ValueError("the coefficient-tangent trace requires a range-independent fit; "
                         "use _trace_coef_tangent_rd_impl")
    return _coef_tangent_loop(env, z0, p0, dcoef, dcpcoef, geom, settings)


def _trace_coef_tangent_rd_impl(env: EnvData, z0, p0, dcoef, dcpcoef, geom,
                                settings: SolverSettings):
    """``_trace_coef_tangent_impl`` for a range-dependent spectral fit:
    every direction g of ``(dcoef, dcpcoef)`` (Dk, K) applied at each
    station j in turn (station j's coefficients perturbed, the blend
    carrying the perturbation with its hat weight).  Returns the primal
    fields and counters (B,) and the tangents (nr, Dk, B), as the JAX
    package's ``trace_pallas_coef_tangent_rd`` does.  The plain version of
    ``csrc/trace_coef_tangent.cu``'s range-dependent kernel; its primal is ``_trace_tangent_impl``
    on the ``poly_ok=False`` environment, bit for bit."""
    if not env.range_dependent:
        raise ValueError("the range-dependent coefficient-tangent trace requires a "
                         "range-dependent fit; use _trace_coef_tangent_impl")
    return _coef_tangent_loop(env, z0, p0, dcoef, dcpcoef, geom, settings)


# ---------------------------------------------------------------------------
# autograd over the launch parameters: reverse and forward mode through
# trace() ride the save-grid tangent trace instead of differentiating the
# torch-op loop step by step
# ---------------------------------------------------------------------------


def _rides_tangent_trace(env, settings) -> bool:
    """True when a derivative over the launch parameters can ride the
    save-grid tangent trace: a spectral profile with a constant or
    Chebyshev bottom angle, and not ``backend="ops"``."""
    return (settings.backend != "ops" and _use_cheb(env, settings)
            and env.bangle_mode in ("const", "cheb"))


def _tangent_grids(env, z0, p0, dp0, dz0, geom, settings):
    """One save-grid tangent trace: the kernel's wrapper where it covers
    the configuration (float32), else the plain Dual loop (float64, more
    series terms than the kernel holds); ``backend="kernel"`` raises there,
    as ``trace`` does without differentiation."""
    from .ops.stepper import tangent_supported, trace_tangent_save_kernel

    if tangent_supported(env, settings):
        return trace_tangent_save_kernel(env, z0, p0, dp0, geom, settings, dz0=dz0)
    if settings.backend == "kernel":
        raise ValueError("CUDA kernel backend unsupported for this configuration")
    return _trace_tangent_save_impl(env, z0, p0, dp0, geom, settings, dz0=dz0)


class _TraceLaunchAD(torch.autograd.Function):
    """``trace`` with derivatives over the launch parameters ``p0`` and
    ``z0``, both (B,).  Counterpart of the JAX package's ``_traced_pallas``
    and its ``custom_jvp`` rule.

    Each ray depends only on its own ``p0`` and ``z0``, so one save-grid
    tangent trace with the unit seed ``dp0 = 1, dz0 = 0`` gives the whole
    diagonal ``d(ts, zs, ps)/dp0``, and one with ``dp0 = 0, dz0 = 1`` the
    diagonal over ``z0``.  The forward pass launches one trace per
    direction asked for (``need_z``, ``need_p``) and keeps the diagonals;
    the tangent trace returns the primal too, so no forward-fan launch is
    added.  That primal is the uncompensated one (no Kahan), as everywhere
    under AD in the JAX package.  User tangents and cotangents enter
    linearly: ``d_out = Dp * dp0 + Dz * dz0`` (``jvp``) and ``grad_p0 =
    sum over save points of g_ts*Dt + g_zs*Dz + g_ps*Dp`` (``backward``).
    """

    @staticmethod
    def forward(z0, p0, env, geom, settings, need_z, need_p):
        if not (need_z or need_p):
            raise ValueError("_TraceLaunchAD needs a direction to differentiate over")
        res = None
        grids = []
        one, zero = torch.ones_like(p0), torch.zeros_like(p0)
        for need, dp0, dz0 in ((need_p, one, zero), (need_z, zero, one)):
            if need:
                r, tang = _tangent_grids(env, z0, p0, dp0, dz0, geom, settings)
                res = r if res is None else res
                grids.extend(tang)
            else:
                grids.extend(p0.new_zeros(0) for _ in range(3))
        return (res.ts, res.zs, res.ps, res.rs, res.n_bott, res.n_surf, res.alive,
                res.alive_save, res.death_code, *grids)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.need = (inputs[5], inputs[6])
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*output[3:])
        ctx.save_for_backward(*output[9:])
        ctx.save_for_forward(*output[9:])

    @staticmethod
    def vmap(info, in_dims, z0, p0, env, geom, settings, need_z, need_p):
        """``torch.func.vmap`` over the launch tensors: rays are
        independent, so the mapped dimension joins the ray dimension of one
        launch.  (``jacfwd`` maps only the tangents, which enter ``jvp``
        linearly, and so stays one launch too.)"""
        N, B = info.batch_size, p0.shape[-1]

        def rays(x, dim):
            x = x.expand(N, B) if dim is None else x.movedim(dim, 0)
            return x.reshape(N * B)

        out = _TraceLaunchAD.apply(rays(z0, in_dims[0]), rays(p0, in_dims[1]), env, geom,
                                   settings, need_z, need_p)
        per_ray = [o.shape[:1] == (N * B,) for o in out]  # not rs, not an empty placeholder
        return (tuple(o.reshape(N, B, *o.shape[1:]) if m else o for o, m in zip(out, per_ray)),
                tuple(0 if m else None for m in per_ray))

    @staticmethod
    def _diagonals(ctx, saved):
        need_z, need_p = ctx.need
        return (saved[0:3] if need_p else None), (saved[3:6] if need_z else None)

    @staticmethod
    def backward(ctx, g_ts, g_zs, g_ps, *_):
        d_p, d_z = _TraceLaunchAD._diagonals(ctx, ctx.saved_tensors)

        def pull(diag):
            terms = [g * d for g, d in zip((g_ts, g_zs, g_ps), diag or ()) if g is not None]
            return sum(terms).sum(dim=1) if terms else None

        return pull(d_z), pull(d_p), None, None, None, None, None

    @staticmethod
    def jvp(ctx, dz0, dp0, *_):
        d_p, d_z = _TraceLaunchAD._diagonals(ctx, ctx.saved_tensors)
        outs = [None, None, None]
        for diag, seed in ((d_p, dp0), (d_z, dz0)):
            if diag is None or seed is None:
                continue
            col = seed[:, None]
            for i in range(3):
                term = diag[i] * col
                outs[i] = term if outs[i] is None else outs[i] + term
        return (*outs, *(None,) * 12)


def _wants_derivative(x) -> bool:
    """A tensor the caller differentiates over: it requires grad, carries a
    forward-mode tangent, or is wrapped by a ``torch.func`` transform
    (``torch._C._functorch.is_functorch_wrapped_tensor`` is private: checked
    with torch 2.11 and 2.13)."""
    if not isinstance(x, torch.Tensor):
        return False
    if x.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(x):
        return True
    return torch.autograd.forward_ad.unpack_dual(x).tangent is not None


def _env_wants_derivative(env: EnvData) -> bool:
    return any(_wants_derivative(getattr(env, f.name)) for f in dataclasses.fields(env))


def _trace_ad(env, z0, p0, geom, settings, need_z, need_p, need_env) -> TraceResult:
    """``trace`` under differentiation (see ``trace``'s docstring)."""
    if need_env or not _rides_tangent_trace(env, settings):
        # table or segment profile, spline bottom angle, a gradient on the
        # environment: plain autograd through the torch-op loop
        if settings.backend == "kernel":
            raise ValueError("CUDA kernel backend unsupported for this derivative")
        return _trace_impl(env, z0, p0, geom, dataclasses.replace(settings, kahan=False))
    z0b, p0b = _as_batch(env, z0, p0)
    out = _TraceLaunchAD.apply(z0b, p0b, env, geom, settings, need_z, need_p)
    ts, zs, ps, rs, n_bott, n_surf, alive, alive_save, death = out[:9]
    return TraceResult(rs=rs, ts=ts, zs=zs, ps=ps, n_bott=n_bott, n_surf=n_surf, alive=alive,
                       alive_save=alive_save, death_code=death)


def trace(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    num_save: int,
    settings: SolverSettings = SolverSettings(),
) -> TraceResult:
    """Trace a batch of rays from range ``x0`` to ``x1`` (x1 > x0).

    ``z0`` is the source depth (scalar or (B,)); ``p0`` the initial ray
    parameters sin(θ)/c in the ODE convention (positive down), as a tensor
    or array; both are moved to the environment's device and dtype.  States
    are saved on ``num_save`` equally spaced ranges; the final point is the
    exact end state.

    Dispatch (``settings.backend``): the CUDA kernel (``ops/stepper.py``)
    runs when the environment is on a CUDA device and
    ``kernel_supported(env, settings)`` holds; otherwise the torch-op loop
    runs.  ``backend="kernel"`` raises when the kernel does not cover the
    configuration; ``backend="ops"`` always takes the torch-op loop.

    Differentiation: when ``p0`` or ``z0`` is a tensor that requires grad,
    carries a forward-mode tangent or is inside a ``torch.func`` transform,
    the derivative over the launch parameters rides the save-grid tangent
    trace (``_TraceLaunchAD``: the CUDA kernel of ``ops/stepper.py`` on a
    CUDA environment in float32, the plain Dual loop otherwise), one trace
    per direction, for spectral profiles with a constant or Chebyshev
    bottom angle.  Other configurations, a derivative over a tensor of
    ``env``, and ``backend="ops"`` differentiate the torch-op loop by plain
    autograd; ``backend="kernel"`` raises on whatever the kernel does not
    cover, as it does without differentiation.  Under differentiation the primal is the uncompensated one
    (no Kahan), whatever ``settings.kahan`` says.
    """
    if not x1 > x0:
        raise ValueError("trace requires x1 > x0; mirror the environment for backwards shots")
    if settings.backend not in BACKENDS:
        raise ValueError(f"unknown backend {settings.backend!r}; use one of {BACKENDS}")
    h, sps, nseg = _plan(float(x0), float(x1), int(num_save), settings.dx)
    geom = (float(x0), float(x1), float(h), int(sps), int(nseg))

    need = (_wants_derivative(z0), _wants_derivative(p0), _env_wants_derivative(env))
    if any(need):
        return _trace_ad(env, z0, p0, geom, settings, *need)

    if settings.backend != "ops":
        from .ops.stepper import kernel_supported, trace_kernel

        ok = kernel_supported(env, settings)
        if settings.backend == "kernel" and not ok:
            raise ValueError("CUDA kernel backend unsupported for this configuration")
        if ok and (settings.backend == "kernel" or env.device.type == "cuda"):
            return trace_kernel(env, z0, p0, geom, settings)
    return _trace_impl(env, z0, p0, geom, settings)
