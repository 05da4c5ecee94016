"""User-facing ray shooting API: ``shoot_rays`` (fan) and ``shoot_ray``.

Counterpart of ``pygenray_tpu/shoot.py`` (reference parity with pygenray's
``launch_rays.py:11-322``).  The user launch angle θ maps to the ODE launch
angle -θ for every batch size.  Backwards shots (receiver_range <
source_range) mirror the environment about the range axis, integrate
forward, and un-mirror the saved ranges.  The fan is one batched
``trace``: on a CUDA environment the forward kernel, else the torch-op loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .envdata import EnvData, host_profile_tables
from .integrate import DEATH_CODES, SolverSettings, trace
from .ops.host import bilinear_np
from .ray_objects import Ray, RayFan

__all__ = ["shoot_rays", "shoot_ray", "settings_for"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _debug_report(res, launch_angles, backwards, stream=None):
    """Per-ray termination diagnostics, printed when ``debug=True``: for
    every dropped ray, the death reason (``DEATH_CODES``) and the last saved
    alive state approximating where it died, plus per-ray bounce counts."""
    import sys

    stream = stream or sys.stderr
    alive = _np(res.alive)
    code = _np(res.death_code)
    alive_save = _np(res.alive_save)
    rs = _np(res.rs).astype(float)
    if backwards:
        rs = -rs
    zs = -_np(res.zs).astype(float)  # user convention
    n_bott = _np(res.n_bott)
    n_surf = _np(res.n_surf)
    angles = np.broadcast_to(np.asarray(launch_angles, float), alive.shape)
    for k in np.flatnonzero(~alive):
        idx = np.flatnonzero(alive_save[k])
        reason = DEATH_CODES.get(int(code[k]), f"code {int(code[k])}")
        if idx.size:
            j = idx[-1]
            where = f"last alive near x={rs[j]:.1f} m, z={zs[k, j]:.1f} m"
        else:
            where = "died before the first save point"
        print(
            f"debug: ray {k} (launch {angles[k]:+.4f} deg) terminated: "
            f"{reason}; {where}; bounces bottom={int(n_bott[k])} "
            f"surface={int(n_surf[k])}",
            file=stream, flush=True,
        )
    print(
        f"debug: {int(alive.sum())}/{alive.size} rays alive; "
        f"bounces bottom[min/max]={int(n_bott.min())}/{int(n_bott.max())} "
        f"surface[min/max]={int(n_surf.min())}/{int(n_surf.max())}",
        file=stream, flush=True,
    )


def settings_for(rtol=1e-9, dx=None, interp="auto", terminate_backwards=True,
                 backend="auto"):
    """Solver settings; ``rtol`` is accepted for reference-API compatibility
    and mapped onto a nominal fixed step when ``dx`` is not given."""
    if dx is None:
        dx = float(np.clip(50.0 * (rtol / 1e-9) ** 0.25, 5.0, 500.0))
    return SolverSettings(dx=dx, interp=interp,
                          terminate_backwards=terminate_backwards,
                          backend=backend)


def _resolve_env(environment, flatearth, mirrored, interp, dtype, device):
    if isinstance(environment, EnvData):
        if mirrored:
            from .envdata import mirror_env_data

            return mirror_env_data(environment)
        return environment
    return environment.env_data(
        flatearth=flatearth, mirrored=mirrored, interp=interp, dtype=dtype,
        device=device,
    )


def _trace_fan(
    source_depth,
    source_range,
    theta_ode,
    receiver_range,
    num_range_save,
    environment,
    settings,
    flatearth,
    dtype,
    device,
):
    """Shared fan-trace core in the ODE convention. Returns (result, env, backwards)."""
    backwards = receiver_range < source_range
    env = _resolve_env(environment, flatearth, backwards, settings.interp, dtype, device)
    if backwards:
        x0, x1 = -source_range, -receiver_range
    else:
        x0, x1 = source_range, receiver_range

    source_depth = np.asarray(source_depth, float)
    r_h, z_h, c_h = host_profile_tables(env)
    c_src = bilinear_np(
        np.broadcast_to(x0, source_depth.shape), source_depth, r_h, z_h, c_h
    )
    p0 = np.sin(np.radians(np.asarray(theta_ode, float))) / c_src
    p0 = torch.as_tensor(p0, dtype=env.dtype, device=env.device)
    if source_depth.ndim:
        source_depth = torch.tensor(source_depth, dtype=env.dtype, device=env.device)
    else:
        source_depth = float(source_depth)

    res = trace(env, source_depth, p0, x0, x1, num_range_save, settings)
    return res, env, backwards


def shoot_rays(
    source_depth: float,
    source_range: float,
    launch_angles,
    receiver_range: float,
    num_range_save: int,
    environment,
    rtol=1e-9,
    terminate_backwards: bool = True,
    n_processes: int = None,  # accepted for API compatibility; unused
    debug: bool = False,
    flatearth: bool = True,
    *,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    device="cpu",
    keep_dropped: bool = False,
    nan_dropped: bool = True,
    backend: str = "auto",
    verbose: bool = False,
) -> RayFan:
    """Integrate a fan of rays; returns a ``RayFan``.

    Reference signature (pygenray ``launch_rays.py:11-23``) plus: ``dx``
    (nominal step, m), ``interp`` (profile backend), ``dtype`` and
    ``device`` (where an ``OceanEnvironment2D``'s tensors are built; an
    ``EnvData`` keeps its own), ``backend`` (see ``SolverSettings``) and
    ``keep_dropped`` (keep dead rays in the fan with their death
    diagnostics instead of dropping them).  Rays that turn vertical, leave
    the domain, or bounce backwards are dropped from the fan exactly like
    the reference drops ``None`` rays.

    With ``keep_dropped=True``, save points past a ray's death are NaN; pass
    ``nan_dropped=False`` to keep the integrator's frozen last-alive state
    instead.
    """
    import sys
    import time as _time

    launch_angles = np.atleast_1d(np.asarray(launch_angles, float))
    theta_ode = -launch_angles
    settings = settings_for(rtol, dx, interp, terminate_backwards, backend)
    # source_depth may be per-ray (a vertical source array) or scalar
    src_arr = np.asarray(source_depth, float)
    if src_arr.ndim:
        src_arr = np.broadcast_to(src_arr, launch_angles.shape)
        source_depth = src_arr

    if verbose:
        print(
            f"shoot_rays: tracing {launch_angles.size} rays to "
            f"{receiver_range / 1e3:.1f} km ...", file=sys.stderr, flush=True,
        )
        t0 = _time.perf_counter()

    res, env, backwards = _trace_fan(
        source_depth, source_range, theta_ode, receiver_range, num_range_save,
        environment, settings, flatearth, dtype, device,
    )

    alive = _np(res.alive)
    if debug:
        _debug_report(res, launch_angles, backwards)
    if verbose:
        print(
            f"shoot_rays: done in {_time.perf_counter() - t0:.3f} s "
            f"({int(alive.sum())}/{alive.size} rays alive)",
            file=sys.stderr, flush=True,
        )
    keep = np.ones_like(alive) if keep_dropped else alive
    rs = _np(res.rs).astype(float)
    if backwards:
        rs = -rs
    M = int(keep.sum())
    rs_fan = np.broadcast_to(rs, (M, rs.shape[0])).copy()

    ts = _np(res.ts).astype(float)[keep]
    zs = -_np(res.zs).astype(float)[keep]
    ps = -_np(res.ps).astype(float)[keep]
    if keep_dropped and nan_dropped:
        # save points a dropped ray never reached stay NaN instead of
        # freezing the last alive state
        unreached = ~_np(res.alive_save)[keep]
        ts[unreached] = np.nan
        zs[unreached] = np.nan
        ps[unreached] = np.nan

    return RayFan.from_arrays(
        thetas=launch_angles[keep],
        rs=rs_fan,
        ts=ts,
        zs=zs,
        ps=ps,
        n_botts=_np(res.n_bott)[keep],
        n_surfs=_np(res.n_surf)[keep],
        source_depths=(
            src_arr[keep].copy() if src_arr.ndim else np.full(M, source_depth, float)
        ),
        alive=alive[keep],
        death_code=_np(res.death_code)[keep],
    )


def shoot_ray(
    source_depth: float,
    source_range: float,
    launch_angle: float,
    receiver_range: float,
    num_range_save: int,
    environment,
    rtol=1e-9,
    terminate_backwards: bool = True,
    debug: bool = False,
    flatearth: bool = True,
    *,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    device="cpu",
) -> Ray | None:
    """Integrate a single ray; returns a ``Ray`` or None if it was dropped.

    Reference quirk preserved: the returned ``Ray.launch_angle`` is the
    *negated* user input.
    """
    theta_ode = -float(launch_angle)
    settings = settings_for(rtol, dx, interp, terminate_backwards)
    res, env, backwards = _trace_fan(
        source_depth, source_range, np.array([theta_ode]), receiver_range,
        num_range_save, environment, settings, flatearth, dtype, device,
    )
    if debug:
        _debug_report(res, np.array([launch_angle], float), backwards)
    if not bool(_np(res.alive)[0]):
        return None
    rs = _np(res.rs).astype(float)
    if backwards:
        rs = -rs
    y = np.stack([_np(res.ts)[0], _np(res.zs)[0], _np(res.ps)[0]])
    return Ray(
        rs,
        y,
        int(_np(res.n_bott)[0]),
        int(_np(res.n_surf)[0]),
        theta_ode,
        source_depth,
    )
