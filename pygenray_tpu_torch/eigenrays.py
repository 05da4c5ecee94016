"""Eigenray search: batched root finding over launch angle.

Counterpart of ``pygenray_tpu/eigenrays.py`` (the reference ``pygenray``'s
``eigenrays.py:11-268``): bracket sign changes of final depth across the
fan, then iterate per bracket.  Every (receiver depth
× bracket) candidate across *all* receiver depths advances together: each
iteration is one batched final-state trace of all candidate angles, and the
converged angles get one batched full-save trace at the end.

The solver loop runs on the environment's device (``_device_solve``): per
iteration one forward-tangent trace for ``method="newton"`` (on a CUDA card
the tangent kernel ``csrc/trace_tangent.cu``), or one 2-save forward trace
for ``"regula_falsi"`` (the forward kernel ``csrc/trace_fan.cu``), then the
shared ``rootfind_update`` on tensors and one host check of ``any(active)``.
The final full-save trace of the hit angles is one forward-kernel launch.
On a device mesh (``mesh=``) the candidates shard over its devices, one
such loop a shard.

The reference's stale-index bookkeeping bug for failed brackets
(`eigenrays.py:159-164`: the parallel branch records loop variable ``k``
left over from args building) is fixed: each failed bracket records its own
original bracketing angles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .envdata import host_profile_tables
from .integrate import _plan, _trace_impl, _trace_tangent_impl, _use_cheb, trace
from .ops.host import bilinear_np
from .ray_objects import EigenRays, Ray
from .rootfind import rootfind_update
from .shoot import _resolve_env, settings_for

__all__ = ["find_eigenrays", "find_eigenrays_batch"]

_DEG = np.pi / 180.0


def _pack_trace(ts, zs, ps, nb, ns):
    """Pack a full-save trace into one (B, 3S+2) tensor for a single
    device→host copy."""
    dt = ts.dtype
    return torch.cat([ts, zs, ps, nb[:, None].to(dt), ns[:, None].to(dt)], dim=1)


def _empty_diagnostics():
    """Zero-bracket solver diagnostics (same keys/dtypes as a real solve),
    so ``er.diagnostics`` exists whether or not any bracket was found."""
    return {
        "rd_idx": np.zeros(0, int),
        "iterations": np.zeros(0, np.int32),
        "converged": np.zeros(0, bool),
        "dropped": np.zeros(0, bool),
        "depth_residual": np.zeros(0, float),
    }


def _final_tangent(env, z0, p0, geom, settings):
    """``(z_end, alive, dz_end/dp0)`` of one batch (ODE convention) from one
    forward tangent seeded by ones.

    The tangent kernel where it covers the configuration (on a CPU
    environment, its plain version); the plain tangent for the other
    spectral configurations (float64); else ``torch.func.jvp`` over the
    torch-op loop without Kahan (table and segment profiles, spline bottom
    angles), as the JAX package runs ``jax.jvp`` over its scan.
    """
    from .ops.stepper import tangent_supported, trace_tangent_kernel

    ones = torch.ones_like(p0)
    if settings.backend != "ops" and tangent_supported(env, settings):
        out = trace_tangent_kernel(env, z0, p0, ones, geom, settings)
    elif settings.backend == "kernel":
        raise ValueError("CUDA kernel backend unsupported for this configuration")
    elif _use_cheb(env, settings) and env.bangle_mode in ("const", "cheb"):
        out = _trace_tangent_impl(env, z0, p0, ones, geom, settings)
    else:
        s_ad = dataclasses.replace(settings, kahan=False)

        def zfun(p):
            res = _trace_impl(env, z0, p, geom, s_ad)
            return res.zs[:, -1], res.alive

        (z_ode, alive), (dz_ode, _) = torch.func.jvp(zfun, (p0,), (ones,))
        return z_ode, alive, dz_ode
    return out[1], out[8] == 0, out[4]


def _check_mesh(mesh):
    """Raise on a mesh the candidate split cannot take, before any trace."""
    if mesh is not None:
        from .parallel.sharding import mesh_size

        mesh_size(mesh, "find_eigenrays")


def _device_solve(env, x0, x1, num_range_save, settings, ztol, max_iter, use_newton, mesh,
                  rd_a, th1_a, th2_a, z1_a, z2_a, c_src_a, z0_a):
    """``_solve_on_device`` over every candidate, or with ``mesh`` over
    each shard of the candidate axis on its device: the candidates padded
    to a multiple of the device count with copies of candidate 0, each
    shard iterating until its own candidates converge, the shards'
    results concatenated and the copies sliced away (as the JAX package's
    ``_device_solve``)."""
    cols = np.stack([rd_a, th1_a, th2_a, z1_a, z2_a, c_src_a, z0_a])
    solve = lambda e, c: _solve_on_device(e, x0, x1, num_range_save, settings, ztol, max_iter,
                                          use_newton, *c)
    if mesh is None:
        return solve(env, cols)
    from .parallel.sharding import mesh_size, replicate_env, run_shards

    n = mesh_size(mesh, "find_eigenrays")
    NB0 = cols.shape[1]
    cols = np.concatenate([cols, np.repeat(cols[:, :1], -NB0 % n, axis=1)], axis=1)
    outs = run_shards(mesh, solve, replicate_env(env, mesh), np.split(cols, n, axis=1),
                      kernels=settings.backend != "ops")
    return tuple(np.concatenate(parts)[:NB0] for parts in zip(*outs))


def _solve_on_device(env, x0, x1, num_range_save, settings, ztol, max_iter, use_newton,
                     rd_a, th1_a, th2_a, z1_a, z2_a, c_src_a, z0_a):
    """All root-finding iterations on the environment's device.

    A loop of at most ``max_iter + 2`` iterations, each one batched
    final-state trace (one tangent-kernel launch for Newton, one
    forward-kernel launch for regula falsi, on a CUDA card) plus the
    bracket/Newton update on tensors, and one host check of
    ``any(active)``; then one full-save trace of the hit angles.
    Per-candidate receiver depth, source sound speed and source depth
    travel in one (8, NB) host→device copy, and the whole result in one
    device→host copy, so ``find_eigenrays_batch`` solves configurations
    with different sources in one loop.

    Returns ``(theta_hit, converged, dead, iterations, resid, full)`` as
    numpy arrays; ``full`` is the packed full-save trace, (NB, 3S+2).
    """
    dev, dt = env.device, env.dtype
    h, sps, nseg = _plan(float(x0), float(x1), 2, settings.dx)
    geom = (float(x0), float(x1), float(h), int(sps), int(nseg))
    s_it = dataclasses.replace(settings, kahan=settings.kahan and not use_newton)

    denom0 = np.where(np.abs(z2_a - z1_a) > 0, z2_a - z1_a, 1.0)
    theta0 = th1_a - (z1_a + rd_a) * (th2_a - th1_a) / denom0
    packed = torch.as_tensor(
        np.stack([theta0, th1_a, th2_a, z1_a, z2_a, rd_a, c_src_a, z0_a]), dtype=dt,
        device=dev)
    theta, th1, th2, z1, z2, rd, c_src, z0v = packed
    inv_csrc = 1.0 / c_src
    NB = theta.shape[0]
    conv = torch.zeros(NB, dtype=torch.bool, device=dev)
    dead = torch.zeros_like(conv)
    th_hit = torch.full((NB,), float("nan"), dtype=dt, device=dev)
    iters = torch.zeros(NB, dtype=torch.int32, device=dev)
    resid = torch.full_like(th_hit, float("nan"))

    for _ in range(max_iter + 2):
        active = ~(conv | dead)
        if not bool(active.any()):
            break
        p0 = torch.sin(-theta * _DEG) * inv_csrc
        if use_newton:
            z_ode, alive, dz_ode = _final_tangent(env, z0v, p0, geom, s_it)
            dz_dth = -dz_ode * (-torch.cos(theta * _DEG) * _DEG * inv_csrc)
        else:
            res = trace(env, z0v, p0, x0, x1, 2, s_it)
            z_ode, alive, dz_dth = res.zs[:, -1], res.alive, None
        z_end = -z_ode
        iters = iters + active.to(torch.int32)
        (theta, th1, th2, z1, z2, conv, dead, th_hit, act, _hit) = rootfind_update(
            torch, theta, th1, th2, z1, z2, conv, dead, th_hit,
            z_end, alive, dz_dth, rd, ztol, use_newton,
        )
        resid = torch.where(act, torch.abs(z_end + rd), resid)

    # final full-save trace of the hit angles; non-converged lanes trace
    # their initial angle, discarded on the host
    th_full = torch.where(conv, th_hit, packed[0])
    res_f = trace(env, z0v, torch.sin(-th_full * _DEG) * inv_csrc, x0, x1, num_range_save,
                  settings)
    head = torch.stack([th_hit, conv.to(dt), dead.to(dt), iters.to(dt), resid], dim=1)
    out = torch.cat([head, _pack_trace(res_f.ts, res_f.zs, res_f.ps, res_f.n_bott,
                                       res_f.n_surf)], dim=1)
    out = out.cpu().numpy().astype(float)
    return (
        out[:, 0], out[:, 1] > 0.5, out[:, 2] > 0.5,
        out[:, 3].astype(np.int32), out[:, 4], out[:, 5:],
    )


def _rays(full, x0, x1, num_range_save, backwards, thetas, source_depths):
    """``Ray`` objects from packed full-save rows."""
    nseg = max(num_range_save - 1, 1)
    S = nseg + 1
    rs = x0 + (x1 - x0) * np.arange(nseg + 1) / nseg
    if backwards:
        rs = -rs
    return [
        Ray(rs, np.stack([row[:S], row[S:2 * S], row[2 * S:3 * S]]),
            int(row[3 * S]), int(row[3 * S + 1]), launch_angle=float(th),
            source_depth=sd)
        for row, th, sd in zip(full, thetas, source_depths)
    ]


def find_eigenrays(
    rays,
    receiver_depths,
    source_depth,
    source_range,
    receiver_range,
    num_range_save,
    environment,
    ztol=1,
    max_iter=20,
    num_workers=None,  # accepted for API compatibility; unused
    method: str = "newton",
    verbose: bool = False,
    mesh=None,
    device="cuda",
    **kwargs,
):
    """Find eigenrays for each receiver depth via batched root finding.

    ``rays`` is the initial fan (``RayFan`` from ``shoot_rays``);
    ``receiver_depths`` are positive depths (the fan's ``zs`` use the
    negative-down user convention, so an eigenray hits when
    ``z_end + receiver_depth ≈ 0``).  Extra kwargs mirror ``shoot_ray``
    (rtol, flatearth, dx, interp, dtype, terminate_backwards, backend).
    ``device``: where an ``OceanEnvironment2D``'s tensors are built (the
    CUDA device unless the caller asks for another, e.g. ``"cpu"``); an
    ``EnvData`` keeps its own.

    ``method``: "newton" (default) uses exact dz/dθ derivatives from one
    forward tangent per iteration for quadratic convergence, safeguarded by
    the bracket (falls back to a false-position step whenever the Newton
    candidate leaves it).  "regula_falsi" reproduces the reference's pure
    false-position iteration (the reference's ``eigenrays.py:206-268``).

    ``verbose`` shows per-iteration progress (a tqdm bar when tqdm is
    installed); it keeps the iteration state on the host.

    ``mesh``: an optional 1D device mesh (``parallel.make_mesh``): the
    (receiver depth × bracket) candidates shard across it for the
    root-finding loop and the full-save trace, each shard on its device
    iterating until its own candidates converge; candidate counts that do
    not divide the mesh are padded with copies of candidate 0 and sliced
    away.  The fan and the verbose host loop are not sharded.
    """
    _check_mesh(mesh)
    rtol = kwargs.get("rtol", 1e-9)
    flatearth = kwargs.get("flatearth", True)
    dx = kwargs.get("dx", None)
    interp = kwargs.get("interp", "auto")
    dtype = kwargs.get("dtype", None)
    terminate_backwards = kwargs.get("terminate_backwards", True)
    backend = kwargs.get("backend", "auto")
    settings = settings_for(rtol, dx, interp, terminate_backwards, backend)

    backwards = receiver_range < source_range
    env = _resolve_env(environment, flatearth, backwards, settings.interp, dtype, device)
    x0 = -source_range if backwards else source_range
    x1 = -receiver_range if backwards else receiver_range
    r_h, z_h, c_h = host_profile_tables(env)
    c_src = bilinear_np(x0, source_depth, r_h, z_h, c_h)

    def shoot_batch(user_thetas, num_save):
        """Batched trace in user angle convention; returns TraceResult."""
        theta_ode = -np.asarray(user_thetas, float)
        p0 = torch.as_tensor(np.sin(np.radians(theta_ode)) / c_src, dtype=env.dtype,
                             device=env.device)
        return trace(env, source_depth, p0, x0, x1, num_save, settings)

    def shoot_batch_grad(user_thetas):
        """(z_end, alive, dz_end/dθ_user) via one forward tangent.

        z_end_i depends only on p0_i, so a single tangent seeded by ones
        yields the whole diagonal Jacobian (no Kahan compensation)."""
        th = np.asarray(user_thetas, float)
        p0 = np.sin(np.radians(-th)) / c_src
        dp0_dth = -np.cos(np.radians(th)) * _DEG / c_src
        h, sps, nseg = _plan(float(x0), float(x1), 2, settings.dx)
        geom = (float(x0), float(x1), float(h), int(sps), int(nseg))
        z_ode, alive, dz_ode = _final_tangent(
            env, source_depth, torch.as_tensor(p0, dtype=env.dtype, device=env.device), geom,
            dataclasses.replace(settings, kahan=False))
        z_user = -z_ode.cpu().numpy().astype(float)
        dz_dth = -dz_ode.cpu().numpy().astype(float) * dp0_dth
        return z_user, alive.cpu().numpy(), dz_dth

    # ---- collect brackets across all receiver depths ---------------------
    receiver_depths = np.atleast_1d(np.asarray(receiver_depths, float))
    items = []  # (rd_idx, rd, theta1, theta2, z1, z2)
    num_eigenrays = {}
    for rd_idx, rd in enumerate(receiver_depths):
        depth_sign = np.sign(rays.zs[:, -1] + rd)
        starts = np.where(np.diff(depth_sign))[0]
        num_eigenrays[rd] = len(starts)
        for s in starts:
            items.append(dict(
                rd_idx=rd_idx, rd=rd,
                theta1=float(rays.thetas[s]), theta2=float(rays.thetas[s + 1]),
                z1=float(rays.zs[s, -1]), z2=float(rays.zs[s + 1, -1]),
            ))

    erays_dict = {rd_idx: [] for rd_idx in range(len(receiver_depths))}
    failed = {rd_idx: [] for rd_idx in range(len(receiver_depths))}
    num_found = {}

    if len(items) == 0:
        for rd_idx in range(len(receiver_depths)):
            num_found[rd_idx] = 0
        er = EigenRays(
            receiver_depths, erays_dict, environment, num_eigenrays, num_found, failed
        )
        er.diagnostics = _empty_diagnostics()
        return er

    NB = len(items)
    rd_arr = np.array([it["rd"] for it in items])
    th1 = np.array([it["theta1"] for it in items])
    th2 = np.array([it["theta2"] for it in items])
    z1 = np.array([it["z1"] for it in items])
    z2 = np.array([it["z2"] for it in items])
    th1_orig, th2_orig = th1.copy(), th2.copy()

    def _assemble(theta_hit, converged, dead, iterations, resid, full=None):
        # final full-resolution trajectories of the converged angles: the
        # device solver traced them already (``full``); the verbose host
        # path traces them here, fetched in one packed copy
        conv_idx = np.where(converged)[0]
        if conv_idx.size:
            if full is None:
                res = shoot_batch(theta_hit[conv_idx], num_save=num_range_save)
                packed = _pack_trace(res.ts, res.zs, res.ps, res.n_bott, res.n_surf)
                packed = packed.cpu().numpy().astype(float)
            else:
                packed = full[conv_idx]
            found = _rays(packed, x0, x1, num_range_save, backwards, theta_hit[conv_idx],
                          [source_depth] * conv_idx.size)
            for i, ray in zip(conv_idx, found):
                erays_dict[items[i]["rd_idx"]].append(ray)

        # each failed bracket records its OWN original angles (the
        # reference's stale-index fix)
        for i in np.where(~converged)[0]:
            failed[items[i]["rd_idx"]].append((th1_orig[i], th2_orig[i]))

        for rd_idx in range(len(receiver_depths)):
            num_found[rd_idx] = len(erays_dict[rd_idx])

        er = EigenRays(
            receiver_depths, erays_dict, environment, num_eigenrays, num_found, failed
        )
        # structured solver diagnostics (per bracket, flattened across depths)
        er.diagnostics = {
            "rd_idx": np.array([it["rd_idx"] for it in items]),
            "iterations": np.asarray(iterations),
            "converged": np.asarray(converged),
            "dropped": np.asarray(dead),
            "depth_residual": np.asarray(resid),
        }
        return er

    # ---- batched root-finding iterations ---------------------------------
    use_newton = method == "newton"
    if not verbose:
        return _assemble(*_device_solve(
            env, x0, x1, num_range_save, settings, ztol, max_iter, use_newton, mesh,
            rd_arr, th1, th2, z1, z2,
            np.full_like(th1, float(c_src)), np.full_like(th1, float(source_depth)),
        ))

    denom = np.where(np.abs(z2 - z1) > 1e-300, z2 - z1, 1.0)
    theta = th1 - (z1 + rd_arr) * (th2 - th1) / denom
    converged = np.zeros(NB, bool)
    dead = np.zeros(NB, bool)
    theta_hit = np.full(NB, np.nan)
    iterations = np.zeros(NB, np.int32)
    resid = np.full(NB, np.nan)
    it_range = range(max_iter + 2)
    try:
        from tqdm import tqdm

        it_range = tqdm(it_range, desc="Finding eigenrays")
    except ImportError:  # tqdm is optional; fall back to plain iteration
        pass
    for _ in it_range:
        active = ~(converged | dead)
        if not active.any():
            break
        if use_newton:
            z_end, alive, dz_dth = shoot_batch_grad(theta)
        else:
            res = shoot_batch(theta, num_save=2)
            alive = res.alive.cpu().numpy()
            z_end = -res.zs[:, -1].cpu().numpy().astype(float)  # user convention
            dz_dth = None

        iterations += active.astype(np.int32)
        (theta, th1, th2, z1, z2, converged, dead, theta_hit,
         act, _hit) = rootfind_update(
            np, theta, th1, th2, z1, z2, converged, dead, theta_hit,
            z_end, alive, dz_dth, rd_arr, ztol, use_newton,
        )
        resid = np.where(act, np.abs(z_end + rd_arr), resid)

    return _assemble(theta_hit, converged, dead, iterations, resid)


def find_eigenrays_batch(
    fan_angles,
    receiver_depths,
    source_depths,
    source_range,
    receiver_range,
    num_range_save,
    environment,
    ztol=1,
    max_iter=20,
    method: str = "newton",
    mesh=None,
    device="cuda",
    **kwargs,
):
    """Solve SEVERAL eigenray problems in one batched pipeline.

    C configurations share the environment and the (source_range,
    receiver_range) geometry but carry their own source depth and
    (optionally) their own receiver-depth array.  The whole batch is one
    batched fan trace for all C fans (per-ray source depths) and one
    ``_device_solve`` over every (config × depth × bracket) candidate.

    - ``fan_angles``: one (B,) angle array shared by every config, or a
      list of C equal-length arrays (per-config fans).
    - ``receiver_depths``: one depth array shared by every config, or a
      list of C arrays.
    - ``source_depths``: sequence of C source depths.

    Returns a list of C ``EigenRays``, each as ``find_eigenrays`` would
    return for that configuration.  ``device`` and ``mesh`` as for
    ``find_eigenrays`` (the batched fan trace is not sharded).
    """
    _check_mesh(mesh)
    rtol = kwargs.get("rtol", 1e-9)
    flatearth = kwargs.get("flatearth", True)
    dx = kwargs.get("dx", None)
    interp = kwargs.get("interp", "auto")
    dtype = kwargs.get("dtype", None)
    terminate_backwards = kwargs.get("terminate_backwards", True)
    backend = kwargs.get("backend", "auto")
    settings = settings_for(rtol, dx, interp, terminate_backwards, backend)

    source_depths = [float(s) for s in np.atleast_1d(source_depths)]
    C = len(source_depths)
    if isinstance(fan_angles, (list, tuple)):
        angle_sets = [np.asarray(a, float) for a in fan_angles]
        if len(angle_sets) != C or len({a.size for a in angle_sets}) != 1:
            raise ValueError(
                "per-config fan_angles must be C equal-length arrays"
            )
    else:
        angle_sets = [np.asarray(fan_angles, float)] * C
    if isinstance(receiver_depths, (list, tuple)) and np.ndim(
        receiver_depths[0]
    ) >= 1:
        rd_sets = [np.atleast_1d(np.asarray(r, float)) for r in receiver_depths]
        if len(rd_sets) != C:
            raise ValueError("receiver_depths list must have one entry per config")
    else:
        rd_sets = [np.atleast_1d(np.asarray(receiver_depths, float))] * C
    B = angle_sets[0].size

    backwards = receiver_range < source_range
    env = _resolve_env(environment, flatearth, backwards, settings.interp, dtype, device)
    x0 = -source_range if backwards else source_range
    x1 = -receiver_range if backwards else receiver_range
    r_h, z_h, c_h = host_profile_tables(env)
    c_srcs = np.array(
        [bilinear_np(x0, sd, r_h, z_h, c_h) for sd in source_depths]
    )

    # ---- phase 1: ONE batched fan trace for all C configs ----------------
    p0_all = np.concatenate(
        [np.sin(np.radians(-angle_sets[c])) / c_srcs[c] for c in range(C)]
    )
    z0_all = np.repeat(source_depths, B)
    # num_range_save (not a final-only 2) so the step plan — and therefore
    # the brackets — match a user-shot `shoot_rays(..., num_range_save, ...)`
    # fan bitwise
    res = trace(
        env, torch.as_tensor(z0_all, dtype=env.dtype, device=env.device),
        torch.as_tensor(p0_all, dtype=env.dtype, device=env.device),
        x0, x1, num_range_save, settings,
    )
    # trace() returns ODE-convention depths (positive down); bracketing and
    # _device_solve use the user convention (negative down, like RayFan.zs)
    z_fan = -res.zs[:, -1].cpu().numpy().astype(float).reshape(C, B)
    alive_fan = res.alive.cpu().numpy().reshape(C, B)

    # ---- phase 2: bracket per (config × depth) on the host ----------------
    items = []
    num_eigenrays = [dict() for _ in range(C)]
    for c in range(C):
        zc = np.where(alive_fan[c], z_fan[c], np.nan)
        for rd_idx, rd in enumerate(rd_sets[c]):
            sign = np.sign(zc + rd)
            ok = alive_fan[c][:-1] & alive_fan[c][1:]
            starts = np.where((np.diff(sign) != 0) & ok)[0]
            num_eigenrays[c][rd] = len(starts)
            for s in starts:
                items.append(dict(
                    cfg=c, rd_idx=rd_idx, rd=float(rd),
                    theta1=float(angle_sets[c][s]),
                    theta2=float(angle_sets[c][s + 1]),
                    z1=float(z_fan[c, s]), z2=float(z_fan[c, s + 1]),
                ))

    erays = [
        {rd_idx: [] for rd_idx in range(len(rd_sets[c]))} for c in range(C)
    ]
    failed = [
        {rd_idx: [] for rd_idx in range(len(rd_sets[c]))} for c in range(C)
    ]

    def _finish():
        out = []
        for c in range(C):
            num_found = {ri: len(erays[c][ri]) for ri in erays[c]}
            er = EigenRays(
                rd_sets[c], erays[c], environment, num_eigenrays[c],
                num_found, failed[c],
            )
            er.diagnostics = _empty_diagnostics()
            out.append(er)
        return out

    if not items:
        return _finish()

    # ---- phase 3: ONE device solve over every candidate -------------------
    rd_arr = np.array([it["rd"] for it in items])
    th1 = np.array([it["theta1"] for it in items])
    th2 = np.array([it["theta2"] for it in items])
    z1 = np.array([it["z1"] for it in items])
    z2 = np.array([it["z2"] for it in items])
    cand_cs = np.array([c_srcs[it["cfg"]] for it in items])
    cand_z0 = np.array([source_depths[it["cfg"]] for it in items])

    theta_hit, converged, dead, iterations, resid, full = _device_solve(
        env, x0, x1, num_range_save, settings, ztol, max_iter,
        method == "newton", mesh, rd_arr, th1, th2, z1, z2, cand_cs, cand_z0,
    )

    # ---- phase 4: assemble per-config EigenRays ----------------------------
    conv_idx = np.where(converged)[0]
    found = _rays(full[conv_idx], x0, x1, num_range_save, backwards, theta_hit[conv_idx],
                  cand_z0[conv_idx].tolist())
    for i, ray in zip(conv_idx, found):
        erays[items[i]["cfg"]][items[i]["rd_idx"]].append(ray)
    for i in np.where(~converged)[0]:
        it = items[i]
        failed[it["cfg"]][it["rd_idx"]].append((it["theta1"], it["theta2"]))

    out = _finish()
    for c in range(C):
        sel = np.array([it["cfg"] == c for it in items], bool)
        out[c].diagnostics = {
            "rd_idx": np.array([it["rd_idx"] for it in items])[sel],
            "iterations": np.asarray(iterations)[sel],
            "converged": np.asarray(converged)[sel],
            "dropped": np.asarray(dead)[sel],
            "depth_residual": np.asarray(resid)[sel],
        }
    return out
