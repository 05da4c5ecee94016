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
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .envdata import EnvData
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
        sc = 2.0 / (zhi - zlo)
        off = (zlo + zhi) / (zhi - zlo)
        poly = horner if use_pow else clenshaw

        def ev(prof, z):
            # clamp to the fit domain: constant extrapolation at the edges
            u = torch.clamp(sc * z - off, -1.0, 1.0)
            return poly(u, prof[0]), poly(u, prof[1])

        def ev_c(prof, z):
            u = torch.clamp(sc * z - off, -1.0, 1.0)
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


def _blend_rows(env: EnvData, ctab, cptab, x):
    """Station tables blended linearly in range at ranges ``x`` (any shape):
    returns a pair of tables with ``x``'s shape prepended."""
    i = interval_index(x, env.r, env.uniform_r)
    w = (x - env.r[i]) / (env.r[i + 1] - env.r[i])
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

        def sincos2b(x):
            u = torch.clamp((2.0 * x - (blo + bhi)) / span, -1.0, 1.0)
            b2 = 2.0 * (clenshaw(u, coef) * (math.pi / 180.0))
            return torch.sin(b2), torch.cos(b2)

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


def _trace_impl(env: EnvData, z0, p0, geom, settings: SolverSettings) -> TraceResult:
    x0, x1, h, sps, nseg = geom
    nsteps = sps * nseg
    dtype, device = env.dtype, env.device
    z0, p0 = _as_batch(env, z0, p0)
    B = p0.shape[0]

    use_cheb = _use_cheb(env, settings)
    use_pow = _use_pow(env, settings, use_cheb)
    use_seg = _use_seg(env, settings)
    ev, ev_c = _make_eval(env, use_cheb, use_pow, use_seg)
    sincos2b = _make_bangle(env)
    zlo, zhi = env.z_dom
    rlo, rhi = env.r_dom
    btol = settings.bbox_tol
    sin_lim = math.sin(math.radians(settings.vertical_limit_deg))
    hs = torch.tensor(h, dtype=dtype, device=device)
    h6 = hs / _scalar(6.0, hs)

    def rhs(prof, z, p):
        c, cp = ev(prof, z)
        cp2 = c * p
        inv_s = torch.rsqrt(torch.clamp(1.0 - cp2 * cp2, min=_TINY))
        invc = 1.0 / c
        return inv_s * invc, cp2 * inv_s, -cp * inv_s * invc * invc, c

    # ---- per-step data (precomputed outside the loop) --------------------
    ks = torch.arange(nsteps, dtype=dtype, device=device)
    xs0 = x0 + ks * h
    xsm = xs0 + 0.5 * h
    xs1 = x0 + (ks + 1.0) * h
    b0s = linear_interp(xs0, env.bathy_r, env.bathy, env.uniform_bathy_r)
    b1s = linear_interp(xs1, env.bathy_r, env.bathy, env.uniform_bathy_r)
    # out-of-domain flags precomputed on the host in float64: f32 x0 + k*h
    # accumulates ~mm of rounding over 100 km, which must not decide deaths
    ks64 = np.arange(nsteps, dtype=np.float64)
    oob_step = torch.as_tensor(
        (x0 + ks64 * h < rlo - btol) | (x0 + (ks64 + 1.0) * h > rhi + btol),
        device=device,
    )

    ctab, cptab = _profile_tabs(env, use_cheb, use_pow, use_seg)
    if env.range_dependent:
        prof_ms = _blend_rows(env, ctab, cptab, xsm)
        prof_1s = _blend_rows(env, ctab, cptab, xs1)
        prof0 = _blend_rows(env, ctab, cptab, torch.tensor(x0, dtype=dtype, device=device))
    else:
        prof0 = (ctab[0], cptab[0])

    # ---- initial state ---------------------------------------------------
    kT, kz, kp, _ = rhs(prof0, z0, p0)
    alive = (z0 >= zlo - btol) & (z0 <= zhi + btol)
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
            if env.range_dependent:
                prof_m = (prof_ms[0][k], prof_ms[1][k])
                prof_1 = (prof_1s[0][k], prof_1s[1][k])
            else:
                prof_m = prof_1 = prof0
            kT1, kz1, kp1 = kT, kz, kp

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
            b0 = b0s[k]
            b1 = b1s[k]
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
            f = g0 / torch.where(torch.abs(g0 - g1) > _TINY, g0 - g1, 1.0)
            f = torch.clamp(f, 0.0, 1.0)
            for _ in range(2):  # Newton refinement on the Hermite cubic
                G = _hermite(f, z, z1, mz0, mz1) - (bnd0 + f * db)
                Gp = _hermite_d(f, z, z1, mz0, mz1) - db
                f = torch.clamp(f - G / torch.where(torch.abs(Gp) > _TINY, Gp, 1.0), 0.0, 1.0)

            # -- state at the crossing
            t_off = _hermite(f, torch.zeros_like(dT), dT, hs * kT1, hs * kT4)
            z_c = _hermite(f, z, z1, mz0, mz1)
            p_c = _hermite(f, p, p1, hs * kp1, hs * kp4)
            x_c = xs0[k] + f * hs

            # -- reflect (transcendental-free; see _make_bangle)
            c_c = ev_c(prof_m, z_c)
            sin_th = torch.clamp(p_c * c_c, -1.0, 1.0)
            cos_th = torch.sqrt(torch.clamp(1.0 - sin_th * sin_th, min=0.0))
            s2b, c2b = sincos2b(x_c)
            p_ref = torch.where(surf, -p_c, (s2b * cos_th - c2b * sin_th) / c_c)
            if settings.terminate_backwards:
                # |2β - θ| > 90°  ⇔  cos(2β - θ) < 0; small epsilon so the
                # degenerate vertical-ray case is not misclassified — it
                # dies as vertical
                back_dead = cross & bott & (c2b * cos_th + s2b * sin_th < -1e-9)
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
            dT_tot = torch.where(use_fix, dT_fix, dT)
            dz_tot = torch.where(use_fix, z_fix - z, dz)
            p_new = torch.where(use_fix, p_fix, p1)

            upd = alive
            if settings.kahan:
                T, Tc = _kahan_add(T, Tc, torch.where(upd, dT_tot, 0.0))
                z, zc = _kahan_add(z, zc, torch.where(upd, dz_tot, 0.0))
            else:
                T = T + torch.where(upd, dT_tot, 0.0)
                z = z + torch.where(upd, dz_tot, 0.0)
            p = torch.where(upd, p_new, p)

            # -- end-of-step derivative (next step's k1) + death checks
            kTe, kze, kpe, c_e = rhs(prof_1, z, p)
            vert = torch.abs(c_e * p) > sin_lim
            oob = (z > zhi + btol) | (z < zlo - btol) | oob_step[k]
            newly = alive & (vert | oob | back_dead)
            death = torch.where(
                alive & back_dead, 3,
                torch.where(alive & vert, 1, torch.where(alive & oob, 2, death)),
            ).to(torch.int32)
            n_surf = n_surf + (cross & surf & upd).to(torch.int32)
            n_bott = n_bott + (cross & bott & upd).to(torch.int32)
            kT = torch.where(upd, kTe, kT1)
            kz = torch.where(upd, kze, kz1)
            kp = torch.where(upd, kpe, kp1)
            alive = alive & ~newly

        # compensated readout: comp holds the amount the running value
        # OVERSHOT the true sum, so the corrected value is val - comp
        saves.append((T - Tc, z - zc, p, alive))

    # assemble save-grid arrays: initial state + one point per segment
    rs = _save_ranges(x0, x1, nseg, hs)
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
    """
    if not x1 > x0:
        raise ValueError("trace requires x1 > x0; mirror the environment for backwards shots")
    if settings.backend not in BACKENDS:
        raise ValueError(f"unknown backend {settings.backend!r}; use one of {BACKENDS}")
    h, sps, nseg = _plan(float(x0), float(x1), int(num_save), settings.dx)
    geom = (float(x0), float(x1), float(h), int(sps), int(nseg))

    if settings.backend != "ops":
        from .ops.stepper import kernel_supported, trace_kernel

        ok = kernel_supported(env, settings)
        if settings.backend == "kernel" and not ok:
            raise ValueError("CUDA kernel backend unsupported for this configuration")
        if ok and (settings.backend == "kernel" or env.device.type == "cuda"):
            return trace_kernel(env, z0, p0, geom, settings)
    return _trace_impl(env, z0, p0, geom, settings)
