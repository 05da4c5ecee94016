"""Monte-Carlo tomography: ensembles of perturbed environments.

Counterpart of ``pygenray_tpu/montecarlo.py`` (BASELINE.json configs[4]:
10^6 rays over internal-wave-perturbed sound-speed realizations).  An
ensemble is one ``EnvData`` whose data tensors carry a leading realization
axis E (``make_env_ensemble``, ``envdata.stack_env_data``).

* ``trace_ensemble`` runs one ``trace`` per realization (on a CUDA card the
  fan kernel, ``csrc/trace_fan.cu``, in its spectral or segment mode) and
  stacks the results to (E, B, ...).
* ``mc_eigenray_times`` brackets every realization's fan and iterates all
  (realization × bracket) candidates together.  On a range-dependent
  spectral float32 ensemble (``_ensemble_kernel_ok``) every fan and Newton
  iteration is one launch of the ensemble tangent kernel
  (``csrc/trace_tangent_ens.cu``; its plain version on a CPU), the
  brackets are compacted on the device into a fixed capacity
  (``MC_BRACKET_CAP``), and the converged angles get one Kahan fan-kernel
  trace per realization: the "one-shot" path, one device→host copy.
  Otherwise (a vertical receiver array, a segment or table ensemble,
  float64, ``backend="ops"``, or more brackets than the capacity) the
  "two-phase" path brackets on the host and iterates on the device.  The
  iteration loops run on device tensors with one host check of "any
  candidate active" per iteration, as ``eigenrays._device_solve`` does.

On a device mesh (``mesh=``, ``parallel.make_mesh``) the realization axis
splits over its devices (``parallel.sharding.ensemble_shards``; E must
divide evenly): each shard traces and solves its own realizations on its
device, so the ensemble tangent kernel takes E/n realizations a launch,
and the results are concatenated in realization order.

Not ported, being TPU workarounds or layout (ROADMAP): the table-gather ray
chunking, and the calm and dyn block classifiers (``calm`` and ``dyn``
must be None).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .envdata import EnvData, env_member, host_profile_tables, make_env_data, stack_env_data
from .integrate import SolverSettings, TraceResult, _ens_step_data, _plan, trace
from .ops.host import bilinear_np
from .rootfind import rootfind_update

__all__ = ["make_env_ensemble", "trace_ensemble", "mc_eigenray_times"]

MC_BRACKET_CAP = 24  # fixed per-realization bracket capacity of the one-shot path
_DEG = np.pi / 180.0


def make_env_ensemble(
    c_ens, r, z, bathy, bathy_r, interp: str = "auto", dtype=None,
    cheb_order: int = 255, device="cuda", **kw
) -> EnvData:
    """Stack per-realization environments into one EnvData with a leading
    ensemble axis on every data field (static metadata must agree, so the
    Chebyshev order is fixed by the first realization's adaptive fit).

    Same host build as the JAX package's ``make_env_ensemble``: the
    Chebyshev fit first, then the segment fit, then exact tables; every
    member refitted at the largest order any member needs (and, for
    segment fits, the basis any member needs); one member that fails the
    monomial guard sends the whole ensemble to Clenshaw.  ``device`` (the
    CUDA device unless the caller asks for another) and ``dtype`` (float32
    by default) as for ``make_env_data``.
    """
    c_ens = np.asarray(c_ens, np.float64)
    E = c_ens.shape[0]
    kw.setdefault("force_range_dependent", True)
    kw.setdefault("cheb_order", cheb_order)  # perturbed fields need high order
    build = lambda e, **k: make_env_data(c_ens[e], r, z, bathy, bathy_r, dtype=dtype,
                                         device=device, **k)
    probes = [build(e, interp=interp, **kw) for e in range(E)]
    kw2 = {k: v for k, v in kw.items()
           if k not in ("cheb_order", "cheb_exact_order",
                        "seg_order", "seg_exact_order", "seg_basis")}
    if interp not in ("table", "seg") and not all(p.has_cheb for p in probes):
        if interp == "cheb":
            raise ValueError(
                "some realizations fail the Chebyshev fit guard; "
                "use interp='seg' or 'table' for rough ensembles"
            )
        try:
            probes = [build(e, interp="seg", **kw2) for e in range(E)]
            interp = "seg"
        except ValueError:
            interp = "table"  # even the segment gates fail: exact tables
            warnings.warn(
                "ensemble fell back to table interpolation (global AND "
                "segment fit gates failed — reachable only for tables "
                "sampling their finest structure below ~4 points per "
                "wavelength, see ops/seg.py); resample the realizations "
                "onto a finer depth grid",
                stacklevel=2,
            )
            probes = [build(e, interp="table", **kw) for e in range(E)]
    elif interp == "seg":
        probes = [build(e, interp="seg", **kw2) for e in range(E)]

    if probes[0].has_seg:
        # align the per-realization segment orders and basis so the members
        # stack (one member on the high-order Chebyshev rungs lifts the
        # whole ensemble there)
        ks = max(p.c_seg.shape[1] for p in probes) - 1
        sb = "cheb" if any(p.seg_basis == "cheb" for p in probes) else "pow"
        envs = [
            p if (p.c_seg.shape[1] - 1 == ks and p.seg_basis == sb)
            else build(e, interp="seg", seg_order=ks, seg_exact_order=True, seg_basis=sb, **kw2)
            for e, p in enumerate(probes)
        ]
    elif interp == "table" or not probes[0].has_cheb:
        envs = probes
    else:
        order = max(p.c_cheb.shape[1] for p in probes) - 1
        # refit only the members whose adaptive order differs
        envs = [
            p if p.c_cheb.shape[1] - 1 == order
            else build(e, interp=interp, cheb_order=order, cheb_exact_order=True, **kw2)
            for e, p in enumerate(probes)
        ]
    if len({e.poly_ok for e in envs}) > 1:
        # one non-conforming realization demotes the ensemble to Clenshaw
        envs = [dataclasses.replace(e, poly_ok=False) for e in envs]
    return stack_env_data(envs)


def _members(env_ens):
    return [env_member(env_ens, e) for e in range(env_ens.c.shape[0])]


def trace_ensemble(
    env_ens: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    num_save: int,
    settings: SolverSettings = SolverSettings(),
    mesh=None,
    calm=None,
    dyn=None,
) -> TraceResult:
    """Trace a (possibly per-realization) angle batch through every
    realization: ``p0`` is (B,) shared or (E, B) per-realization; returns a
    TraceResult with a leading ensemble axis (E, B, ...).

    One ``trace`` per realization: on a CUDA ensemble the fan kernel where
    it covers the configuration (spectral or segment profiles), one launch
    each.  ``mesh``: an optional 1D device mesh; the realizations split
    over it (E must divide evenly), each shard on its device, and the
    result is gathered on the mesh's first device.  ``calm`` and ``dyn``
    must be None (not ported).
    """
    if calm is not None or dyn is not None:
        raise ValueError("the calm and dyn block classifiers are TPU scheduling and are not "
                         "ported; pass calm=None and dyn=None")
    if not float(x1) > float(x0):
        raise ValueError(
            "trace_ensemble requires x1 > x0; mirror the environment for "
            "backwards shots"
        )
    if mesh is not None:
        return _trace_ensemble_sharded(env_ens, z0, p0, x0, x1, num_save, settings, mesh)
    p0 = torch.as_tensor(p0, dtype=env_ens.dtype, device=env_ens.device)
    outs = [trace(m, z0, p0[e] if p0.ndim == 2 else p0, x0, x1, num_save, settings)
            for e, m in enumerate(_members(env_ens))]
    fields = {f.name: torch.stack([getattr(o, f.name) for o in outs])
              for f in dataclasses.fields(TraceResult) if f.name != "rs"}
    return TraceResult(rs=outs[0].rs, **fields)


def _trace_ensemble_sharded(env_ens, z0, p0, x0, x1, num_save, settings, mesh):
    """``trace_ensemble`` on each shard of the realization axis (the
    counterpart of the JAX package's ``_trace_ensemble_sharded``): a
    per-realization ``p0`` split with its realizations, a shared one on
    every shard's device; the (E, B, ...) result gathered on the mesh's
    first device."""
    from .integrate import _gather_trace, _wants_derivative
    from .parallel.sharding import ensemble_shards, run_shards

    shards = ensemble_shards(env_ens, mesh)
    p0 = torch.as_tensor(p0, dtype=env_ens.dtype)
    ps = (torch.split(p0, p0.shape[0] // len(shards)) if p0.ndim == 2
          else [p0] * len(shards))
    ps = [p.to(e.device) for p, e in zip(ps, shards)]
    derivative = _wants_derivative(p0) or _wants_derivative(z0)
    outs = run_shards(mesh, lambda e, p: trace_ensemble(e, z0, p, x0, x1, num_save, settings),
                      shards, ps, threads=False if derivative else None,
                      kernels=settings.backend != "ops")
    return _gather_trace(mesh, outs)


def _by_realization(env_ens, mesh, settings, fn, per_e, axes):
    """``fn(env_ens, *per_e)``; with ``mesh``, ``fn(shard, *per_e rows of
    the shard)`` on each shard of the realization axis, on its device
    (``per_e``: host arrays with a leading E axis), the shards' host
    results concatenated along ``axes`` (an axis for one result, a tuple
    of them for a tuple of results)."""
    if mesh is None:
        return fn(env_ens, *per_e)
    from .parallel.sharding import ensemble_shards, run_shards

    shards = ensemble_shards(env_ens, mesh)
    parts = [np.split(np.asarray(a), len(shards)) for a in per_e]
    outs = run_shards(mesh, fn, shards, *parts, kernels=settings.backend != "ops")
    if isinstance(axes, int):
        return np.concatenate(outs, axis=axes)
    return tuple(np.concatenate(xs, axis=ax) for xs, ax in zip(zip(*outs), axes))


def mc_eigenray_times(
    env_ens: EnvData,
    fan_angles,
    receiver_depth: float,
    source_depth: float,
    source_range: float,
    receiver_range: float,
    ztol: float = 1.0,
    max_iter: int = 20,
    settings: SolverSettings = SolverSettings(),
    mesh=None,
):
    """Eigenray travel times across an ensemble of environments.

    Runs a fan per realization, brackets the arrivals, then iterates all
    (realization × bracket) Newton/regula-falsi candidates together.
    ``receiver_depth`` is a scalar or an array of depths (a vertical
    receiver array, like ``find_eigenrays``):

    - scalar: returns a dict of (E, M) arrays (M = max bracket count over
      realizations): ``theta`` (user launch angles), ``t`` (travel times),
      ``z_resid`` (final-depth residual), ``n_surf``/``n_bott``, and
      ``valid`` (bracket exists and converged);
    - array of n depths: the same fan serves every depth and all
      (depth × realization × bracket) candidates solve together; returns
      (n, E, M) arrays.

    ``path`` says which solve ran: "one-shot" (fan, bracketing, Newton and
    the final evaluation on the device, the ensemble tangent kernel
    driving the iterations) or "two-phase".  ``mesh``: an optional 1D
    device mesh; the realization axis splits over it (E must divide
    evenly), each shard solving its own realizations on its device.
    """
    if mesh is not None:  # raise on a mesh the realizations cannot take, before any trace
        from .parallel.sharding import ensemble_shards

        ensemble_shards(env_ens, mesh)
    fan_angles = np.asarray(fan_angles, float)
    E = env_ens.c.shape[0]
    if not float(receiver_range) > float(source_range):
        raise ValueError(
            "mc_eigenray_times requires receiver_range > source_range; "
            "mirror the ensemble for backwards geometry"
        )
    rds = np.atleast_1d(np.asarray(receiver_depth, float))
    scalar_depth = np.ndim(receiver_depth) == 0

    r_h, z_h, c_h = host_profile_tables(env_ens)
    c_src = np.array([bilinear_np(source_range, source_depth, r_h[e], z_h[e], c_h[e])
                      for e in range(E)])
    kernel_ok = _ensemble_kernel_ok(env_ens, settings)

    # 0. the one-shot solve; if a realization overflows the bracket
    # capacity, the two-phase flow below reuses the fan's final depths
    z_end = None
    if scalar_depth and fan_angles.size >= 2 and kernel_ok:
        out, z_end_f = _mc_one_shot_device(
            env_ens, fan_angles, c_src, float(source_depth), float(source_range),
            float(receiver_range), float(receiver_depth), float(ztol), int(max_iter), settings,
            mesh,
        )
        if not (out[7] > 0.5).any():  # no capacity overflow
            counts = out[6, :, 0].astype(int)
            M = int(counts.max()) if counts.size else 0
            if M == 0:
                return _mc_empty_result((E, 0))
            conv = out[1, :, :M] > 0.5
            return {
                "theta": np.where(conv, out[0, :, :M], np.nan),
                "t": np.where(conv, out[2, :, :M], np.nan),
                "z_resid": np.where(conv, out[3, :, :M], np.nan),
                "n_surf": np.where(conv, out[4, :, :M].astype(np.int64), -1),
                "n_bott": np.where(conv, out[5, :, :M].astype(np.int64), -1),
                "valid": conv,
                "path": "one-shot",
            }
        warnings.warn(
            f"a realization has more than MC_BRACKET_CAP={MC_BRACKET_CAP} "
            "arrival brackets; falling back to the two-phase solve "
            "(raise pygenray_tpu_torch.montecarlo.MC_BRACKET_CAP to keep the "
            "one-shot path)",
            stacklevel=2,
        )
        z_end = z_end_f  # the one-shot already traced the fan

    # 1. the fan through every realization (unless the one-shot traced it)
    if z_end is None:
        p0 = np.sin(np.radians(-np.broadcast_to(fan_angles, (E, fan_angles.size)))) / c_src[:, None]
        if kernel_ok:
            z_ode, alive_f = _fan_final_state(env_ens, source_depth, p0, source_range,
                                              receiver_range, settings, mesh)
            z_end = np.where(alive_f, -z_ode, np.nan)
        else:
            fan = trace_ensemble(env_ens, source_depth, p0, source_range, receiver_range, 2,
                                 settings, mesh)
            z_end = -fan.zs[..., -1].cpu().numpy().astype(float)  # (E, B) user convention
            z_end = np.where(fan.alive.cpu().numpy(), z_end, np.nan)

    # 2. bracket per (depth × realization); candidates for every depth ride
    # one concatenated (E, Mtot) axis with per-candidate receiver depths
    sign = np.sign(z_end[None, :, :] + rds[:, None, None])  # (n_rd, E, B)
    keys = ("theta", "t", "z_resid", "n_surf", "n_bott", "valid")
    per_depth = []  # (M_d, th1, th2, z1, z2, valid) per depth
    for d in range(rds.shape[0]):
        starts = [np.where(np.diff(sign[d, e]) != 0)[0] for e in range(E)]
        M_d = max((len(s) for s in starts), default=0)
        th1 = np.zeros((E, M_d))
        th2 = np.zeros((E, M_d))
        z1 = np.ones((E, M_d))
        z2 = -np.ones((E, M_d))
        valid = np.zeros((E, M_d), bool)
        for e, s in enumerate(starts):
            k = len(s)
            th1[e, :k] = fan_angles[s]
            th2[e, :k] = fan_angles[s + 1]
            z1[e, :k] = z_end[e, s]
            z2[e, :k] = z_end[e, s + 1]
            valid[e, :k] = True
        per_depth.append((M_d, th1, th2, z1, z2, valid))

    Ms = [p[0] for p in per_depth]
    M_max = max(Ms, default=0)
    if sum(Ms) == 0:
        return _mc_empty_result((E, 0) if scalar_depth else (rds.shape[0], E, 0))

    cat = lambda i: np.concatenate([p[i] for p in per_depth], axis=1)
    th1, th2, z1, z2 = cat(1), cat(2), cat(3), cat(4)
    valid = np.concatenate([p[5] for p in per_depth], axis=1)
    rd_arr = np.concatenate(
        [np.full((E, p[0]), rds[d]) for d, p in enumerate(per_depth)], axis=1
    )
    denom = np.where(np.abs(z2 - z1) > 1e-300, z2 - z1, 1.0)
    theta0 = th1 - (z1 + rd_arr) * (th2 - th1) / denom

    # 3+4. every iteration and the Kahan final evaluation on the device
    out = _solve_ensemble_device(
        env_ens, theta0, th1, th2, z1, z2, ~valid, c_src, float(source_depth),
        float(source_range), float(receiver_range), rd_arr, float(ztol), int(max_iter),
        settings, kernel_ok, mesh,
    )
    converged = out[1] > 0.5
    vals = {
        "theta": np.where(converged, out[0], np.nan),
        "t": np.where(converged, out[2], np.nan),
        "z_resid": np.where(converged, out[3], np.nan),
        "n_surf": np.where(converged, out[4].astype(np.int64), -1),
        "n_bott": np.where(converged, out[5].astype(np.int64), -1),
        "valid": converged,
        "path": "two-phase",
    }
    if scalar_depth:
        return vals

    # unpack the concatenated candidate axis back into (n_rd, E, M_max)
    fill = {"theta": np.nan, "t": np.nan, "z_resid": np.nan,
            "n_surf": -1, "n_bott": -1, "valid": False}
    result = {}
    for k in keys:
        stack = np.full((rds.shape[0], E, M_max), fill[k],
                        dtype=vals[k].dtype if k != "valid" else bool)
        lo = 0
        for d, M_d in enumerate(Ms):
            stack[d, :, :M_d] = vals[k][:, lo:lo + M_d]
            lo += M_d
        result[k] = stack
    result["path"] = "two-phase"
    return result


def _mc_empty_result(shape):
    """No-bracket result with the same dtypes as the populated path
    (``valid`` must be boolean: callers use it as a mask)."""
    return {
        "theta": np.zeros(shape), "t": np.zeros(shape),
        "z_resid": np.zeros(shape),
        "n_surf": np.zeros(shape, np.int64),
        "n_bott": np.zeros(shape, np.int64),
        "valid": np.zeros(shape, bool),
    }


def _ensemble_kernel_ok(env_ens, settings) -> bool:
    """True when the ensemble tangent kernel covers this ensemble: not
    ``backend="ops"``, a range-dependent field and what
    ``ops.stepper.tangent_supported`` admits for realization 0 (a spectral
    float32 fit).  On a CUDA ensemble the kernel then runs, on a CPU one
    its plain version, the same Newton algorithm."""
    from .ops.stepper import tangent_supported

    if settings.backend == "ops":
        return False
    env0 = env_member(env_ens, 0)
    try:
        return bool(env0.range_dependent and tangent_supported(env0, settings))
    except ValueError:  # interp="cheb" on an ensemble without the fit
        return False


def _geom(x0, x1, dx):
    h, sps, nseg = _plan(float(x0), float(x1), 2, dx)
    return (float(x0), float(x1), float(h), int(sps), int(nseg))


def _ens_tangent(env_ens, source_depth, p0, dp0, geom, settings, sd=None):
    from .ops.stepper import trace_tangent_ensemble_kernel

    return trace_tangent_ensemble_kernel(env_ens, source_depth, p0, dp0, geom, settings, sd)


def _fan_final_state(env_ens, source_depth, p0, x0, x1, settings, mesh=None):
    """(z_end_ode, alive) of an (E, B) fan: one ensemble-kernel launch and
    one device→host copy (a shard, on a mesh)."""
    s_it = dataclasses.replace(settings, kahan=False)

    def run(env, p0):
        p0 = torch.as_tensor(p0, dtype=env.dtype, device=env.device)
        out = _ens_tangent(env, source_depth, p0, torch.zeros_like(p0),
                           _geom(x0, x1, settings.dx), s_it)
        packed = torch.stack([out[1], (out[8] == 0).to(out[1].dtype)]).cpu().numpy()
        return packed[0].astype(float), packed[1] > 0.5

    return _by_realization(env_ens, mesh, settings, run, (p0,), (0, 0))


def _solve(zeval, theta, th1, th2, z1, z2, dead, rd, ztol, max_iter, use_newton):
    """Root finding over an (E, M) candidate matrix on its device: at most
    ``max_iter + 2`` iterations, each one ``zeval`` (z_end, alive, dz/dθ)
    and the shared ``rootfind_update``, with one host check of "any
    candidate active".  Returns ``(conv, th_hit)``."""
    conv = torch.zeros_like(dead)
    th_hit = torch.full_like(theta, float("nan"))
    for _ in range(max_iter + 2):
        if not bool((~(conv | dead)).any()):
            break
        z_e, alive, dz_dth = zeval(theta)
        (theta, th1, th2, z1, z2, conv, dead, th_hit, _act, _hit) = rootfind_update(
            torch, theta, th1, th2, z1, z2, conv, dead, th_hit,
            z_e, alive, dz_dth, rd, ztol, use_newton,
        )
    return conv, th_hit


def _final_fans(env_ens, source_depth, p_fin, x0, x1, settings):
    """The Kahan final evaluation of the converged angles: one 2-save
    ``trace`` per realization (on a CUDA card one fan-kernel launch each);
    returns the (E, M) final times, depths and bounce counters."""
    res = [trace(m, source_depth, p_fin[e], x0, x1, 2, settings)
           for e, m in enumerate(_members(env_ens))]
    return (torch.stack([r.ts[:, -1] for r in res]), torch.stack([r.zs[:, -1] for r in res]),
            torch.stack([r.n_surf for r in res]), torch.stack([r.n_bott for r in res]))


def _mc_one_shot_device(
    env_ens, fan_angles, c_src, source_depth, source_range, receiver_range,
    rd, ztol, max_iter, settings, mesh=None,
):
    """The fan, bracketing, every Newton iteration and the final
    evaluation on the ensemble's device, and one device→host copy.

    Bracketing is a fixed-capacity compaction (the first
    ``MC_BRACKET_CAP`` sign changes per realization, in the host path's
    ``np.where(np.diff(sign) != 0)`` order); an overflow flag lets the
    caller fall back to the two-phase flow.  Returns the packed (8, E, M)
    result (θ, converged, t, |z residual|, n_surf, n_bott, bracket count,
    overflow) and the fan's (E, B) final depths, as numpy arrays.  On a
    mesh, all of it once a shard of the realization axis.
    """
    return _by_realization(
        env_ens, mesh, settings,
        lambda env, cs: _one_shot(env, fan_angles, cs, source_depth, source_range,
                                  receiver_range, rd, ztol, max_iter, settings),
        (c_src,), (1, 0))


def _one_shot(env_ens, fan_angles, c_src, source_depth, source_range, receiver_range, rd, ztol,
              max_iter, settings):
    """``_mc_one_shot_device`` on one device."""
    geom = _geom(source_range, receiver_range, settings.dx)
    s_it = dataclasses.replace(settings, kahan=False)
    dev, dt = env_ens.device, env_ens.dtype
    E, B, M = env_ens.c.shape[0], fan_angles.shape[0], MC_BRACKET_CAP
    angles_d = torch.as_tensor(fan_angles, dtype=dt, device=dev)
    csrc_d = torch.as_tensor(c_src, dtype=dt, device=dev)[:, None]
    sd = _ens_step_data(env_ens, geom, s_it)  # the kernel's rows, once for every launch

    def zeval(theta):
        p0 = torch.sin(-theta * _DEG) / csrc_d
        out = _ens_tangent(env_ens, source_depth, p0, torch.ones_like(p0), geom, s_it, sd)
        dz_dth = -out[4] * (-torch.cos(theta * _DEG) * _DEG / csrc_d)
        return -out[1], out[8] == 0, dz_dth

    # the fan, then the brackets compacted on the device
    p0f = torch.sin(-angles_d.expand(E, B) * _DEG) / csrc_d
    out_f = _ens_tangent(env_ens, source_depth, p0f, torch.zeros_like(p0f), geom, s_it, sd)
    z_end = torch.where(out_f[8] == 0, -out_f[1], float("nan"))
    sign = torch.sign(z_end + rd)
    mask = (sign[:, 1:] - sign[:, :-1]) != 0  # a NaN neighbour counts as a change
    count = mask.sum(dim=1)
    keyv = torch.where(mask, torch.arange(B - 1, device=dev)[None, :], B)
    order = torch.sort(keyv, dim=1).values[:, :M]
    valid = order <= B - 2
    idx = torch.clamp(order, max=B - 2)
    th1, th2 = angles_d[idx], angles_d[idx + 1]
    z1 = torch.take_along_dim(z_end, idx, dim=1)
    z2 = torch.take_along_dim(z_end, idx + 1, dim=1)
    den = torch.where(torch.abs(z2 - z1) > 0, z2 - z1, 1.0)
    theta0 = th1 - (z1 + rd) * (th2 - th1) / den

    conv, th_hit = _solve(zeval, theta0, th1, th2, z1, z2, ~valid, rd, ztol, max_iter, True)

    # the final evaluation through the Kahan fan kernel: the tangent kernel
    # that drives the iterations never compensates, reported times must
    th_fin = torch.where(conv, th_hit, 0.0)
    t_end, z_fin, ns, nb = _final_fans(env_ens, source_depth, torch.sin(-th_fin * _DEG) / csrc_d,
                                       source_range, receiver_range, settings)
    Mc = th_hit.shape[1]
    packed = torch.stack([
        th_hit, conv.to(dt), t_end, torch.abs(-z_fin + rd), ns.to(dt), nb.to(dt),
        count[:, None].to(dt).expand(E, Mc), (count > M)[:, None].to(dt).expand(E, Mc),
    ])
    host = torch.cat([packed.reshape(-1), z_end.reshape(-1)]).cpu().numpy().astype(float)
    return host[:packed.numel()].reshape(8, E, Mc), host[packed.numel():].reshape(E, B)


def _solve_ensemble_device(
    env_ens, theta0, th1, th2, z1, z2, dead0, c_src,
    source_depth, source_range, receiver_range, rd, ztol, max_iter, settings, use_kernel,
    mesh=None,
):
    """Root finding over all (realization × bracket) candidates plus the
    final evaluation of the converged angles on the ensemble's device: one
    host→device copy in, one device→host copy out.

    With ``use_kernel`` (``_ensemble_kernel_ok``), Newton with the
    exact dz/dθ (one ensemble-kernel launch per iteration); otherwise a
    bracket-safeguarded regula falsi on one 2-save ``trace`` per
    realization per iteration.  The final evaluation compensates (Kahan)
    as ``settings`` says.  On a mesh, all of it once a shard of the
    realization axis.
    """
    rd_arr = np.broadcast_to(np.asarray(rd, float), theta0.shape)
    rows = np.stack([theta0, th1, th2, z1, z2, dead0.astype(float), rd_arr], axis=1)
    return _by_realization(
        env_ens, mesh, settings,
        lambda env, rows, cs: _solve_candidates(env, rows, cs, source_depth, source_range,
                                                receiver_range, ztol, max_iter, settings,
                                                use_kernel),
        (rows, c_src), 1)


def _solve_candidates(env_ens, rows, c_src, source_depth, source_range, receiver_range, ztol,
                      max_iter, settings, use_kernel):
    """``_solve_ensemble_device`` on one device: ``rows`` (E, 7, M) the
    candidates' θ0, brackets, dead flags and receiver depths."""
    geom = _geom(source_range, receiver_range, settings.dx)
    dev, dt = env_ens.device, env_ens.dtype
    s_it = dataclasses.replace(settings, kahan=settings.kahan and not use_kernel)
    packed = torch.as_tensor(rows, dtype=dt, device=dev).transpose(0, 1).contiguous()
    th0, t1, t2, za, zb, dd0, rd_d = packed
    csrc_d = torch.as_tensor(c_src, dtype=dt, device=dev)[:, None]
    sd = _ens_step_data(env_ens, geom, s_it) if use_kernel else None

    def zeval(theta):
        p0 = torch.sin(-theta * _DEG) / csrc_d
        if use_kernel:
            out = _ens_tangent(env_ens, source_depth, p0, torch.ones_like(p0), geom, s_it, sd)
            return -out[1], out[8] == 0, -out[4] * (-torch.cos(theta * _DEG) * _DEG / csrc_d)
        res = [trace(m, source_depth, p0[e], source_range, receiver_range, 2, s_it)
               for e, m in enumerate(_members(env_ens))]
        return (-torch.stack([r.zs[:, -1] for r in res]), torch.stack([r.alive for r in res]),
                None)

    conv, th_hit = _solve(zeval, th0, t1, t2, za, zb, dd0 > 0.5, rd_d, ztol, max_iter,
                          use_kernel)
    th_fin = torch.where(conv, th_hit, 0.0)
    t_end, z_fin, ns, nb = _final_fans(env_ens, source_depth, torch.sin(-th_fin * _DEG) / csrc_d,
                                       source_range, receiver_range, settings)
    out = torch.stack([th_hit, conv.to(dt), t_end, torch.abs(-z_fin + rd_d), ns.to(dt),
                       nb.to(dt)])
    return out.cpu().numpy().astype(float)
