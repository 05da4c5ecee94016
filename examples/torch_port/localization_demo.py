"""Acoustic source-depth localization via travel-time AD on the
PyTorch/CUDA port.

Estimate an unknown source depth from eigenray arrival times at a vertical
receiver array, by Gauss-Newton over BOTH launch parameters — the source
depth ``z0`` and the per-arrival launch slownesses ``p0`` —
differentiating straight through ``trace()`` with ``torch.func.jvp``.  On
a CUDA card each seeded direction rides the save-grid forward-tangent
kernel (one launch per direction the call differentiates over); on the
CPU the same code runs that kernel's plain version.

Setup:
1. truth: a source at z* = 850 m in a Munk ocean transmits to a vertical
   array at 50 km; the observables are eigenray arrival times (+0.2 ms
   clock noise),
2. initialization: a coarse depth guess (1150 m, 300 m off); model
   arrivals are matched to observations by nearest time per receiver,
3. joint Gauss-Newton: unknowns u = [z0, p0_1..p0_B], residuals
   r = [ (z_end_i - z_rcv_i)/sigma_z , (T_i - T_obs_i)/sigma_T ] — the
   eigenray endpoint constraint and the time fit solved TOGETHER, so no
   re-root-finding inside the loop.  The Jacobian costs exactly two jvp
   evaluations per iteration: one z0-seeded, one p0-seeded (per-ray
   independence makes the p0 block diagonal).

In float32 the iteration is sensitive to rounding: one arrival sits near
a caustic (dz_end/dp0 crosses zero), and after a poor step there the
trajectory depends on the last bits of the residuals.

    python examples/torch_port/localization_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np
import torch

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.envdata import make_env_data
from pygenray_tpu_torch.integrate import SolverSettings, trace

OUT = pathlib.Path(__file__).resolve().parent
R_MAX = 50e3
Z_TRUE = 850.0
Z_INIT = 1150.0
RDS = np.array([700.0, 1000.0, 1300.0, 1600.0, 1900.0, 2200.0])
KW = dict(flatearth=False, interp="cheb", dx=200.0)
SETTINGS = SolverSettings(dx=200.0, interp="cheb")
SIGMA_T = 2e-4  # clock/picking noise [s]
SIGMA_Z = 0.5  # endpoint constraint scale [m]


def build_env(z, c1d, device, nr=8, r_max=R_MAX, dtype=None):
    r = np.linspace(0.0, r_max, nr)
    c = np.outer(np.ones(nr), c1d)
    return make_env_data(c, r, z, np.full(nr, 5500.0), r, cheb_order=63,
                         cheb_exact_order=True, dtype=dtype, device=device)


def endpoints(env, z0, p0, r_max=R_MAX, settings=SETTINGS):
    """Final travel times and depths (positive down) of the rays launched
    at ``p0`` from the source depth ``z0``."""
    res = trace(env, z0, p0, 0.0, r_max, 2, settings)
    return res.ts[:, -1], res.zs[:, -1]


def jvp_columns(env, z0, p0, r_max=R_MAX, settings=SETTINGS):
    """``(t_end, z_end, dt_dz0, dz_dz0, dt_dp0, dz_dp0)``: the endpoints and
    the two seeded jvp evaluations that assemble the Gauss-Newton
    Jacobian — the z0 column (a unit tangent on the scalar source depth),
    and the diagonal p0 block (ray i depends only on p0_i; a tangent of
    ones).  Each evaluation differentiates over its seeded parameter
    alone: a zero tangent on the other would still make ``trace``
    differentiate over it, one more tangent trace."""
    (t_end, z_end), (dt_dz0, dz_dz0) = torch.func.jvp(
        lambda z: endpoints(env, z, p0, r_max, settings), (z0,), (torch.ones_like(z0),))
    _, (dt_dp0, dz_dp0) = torch.func.jvp(
        lambda p: endpoints(env, z0, p, r_max, settings), (p0,), (torch.ones_like(p0),))
    return t_end, z_end, dt_dz0, dz_dz0, dt_dp0, dz_dp0


def arrivals(env, z_src, fan_angles, r_max=R_MAX, rds=RDS):
    """Per-receiver (launch angle, arrival time) from eigenray finding."""
    fan = pr.shoot_rays(z_src, 0.0, fan_angles, r_max, 2, env, **KW)
    er = pr.find_eigenrays(fan, rds, z_src, 0.0, r_max, 2, env, ztol=0.25,
                           **KW)
    out = []
    for i in range(len(rds)):
        if len(er.launch_angles[i]) == 0:  # shadow-zone depth: no arrivals
            out.append((np.empty(0), np.empty(0)))
            continue
        order = np.argsort(er.launch_angles[i])
        out.append((er.launch_angles[i][order], er.ts[i][order, -1]))
    return out


def match_by_time(model, observed, rds=RDS, tol=0.05):
    """Greedy nearest-time pairing of model arrivals to observed times.

    Returns (launch angles, observed times, receiver depths) for pairs
    closer than ``tol`` seconds, each observation used at most once.
    """
    thetas, t_obs, z_rcv = [], [], []
    for (th_m, t_m), (_, t_o), rd in zip(model, observed, rds):
        used = np.zeros(len(t_o), bool)
        for th, t in zip(th_m, t_m):
            j = int(np.argmin(np.abs(t_o - t) + 1e9 * used))
            if not used[j] and abs(t_o[j] - t) < tol:
                used[j] = True
                thetas.append(th)
                t_obs.append(t_o[j])
                z_rcv.append(rd)
    return np.array(thetas), np.array(t_obs), np.array(z_rcv)


def _host(a):
    return a.detach().cpu().numpy()


def run(smoke=False, device="cuda"):
    """The demo's computation and its asserts.  ``smoke=True`` shrinks every
    size for the test suite; ``device`` is where the tensors live (the CUDA
    card unless the caller asks for ``"cpu"``)."""
    # smoke keeps the full range — shorter ranges put the array in a
    # shadow zone with too few arrivals — and shrinks only the fan/grid
    r_max = R_MAX
    rds = RDS[::2] if smoke else RDS
    z = np.linspace(0.0, 6000.0, 500 if smoke else 900)
    c1d = pr.munk_ssp(z)
    env = build_env(z, c1d, device, r_max=r_max)
    fan_angles = np.linspace(-14, 14, 141 if smoke else 281)
    rng = np.random.default_rng(7)

    # --- truth: observed arrival times at the array --------------------
    obs = arrivals(env, Z_TRUE, fan_angles, r_max, rds)
    obs = [(th, t + rng.normal(0.0, SIGMA_T, t.shape)) for th, t in obs]
    n_obs = sum(len(t) for _, t in obs)
    print(f"observed {n_obs} arrivals across {len(rds)} receiver depths")

    # --- initialization: model arrivals at the coarse depth guess ------
    model0 = arrivals(env, Z_INIT, fan_angles, r_max, rds)
    thetas, t_obs, z_rcv = match_by_time(model0, obs, rds)
    B = len(thetas)
    print(f"matched {B} arrivals at init depth {Z_INIT:.0f} m")
    assert B >= (4 if smoke else 8), "too few matched arrivals to localize"

    c_init = float(np.interp(Z_INIT, z, c1d))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=env.device)
    p0 = f32(np.sin(np.radians(-thetas)) / c_init)

    def residual(t_end, z_end):
        # trace()'s zs are positive-down depths (the negative-down user
        # convention applies to the Ray/RayFan objects, not TraceResult)
        return np.concatenate([
            (_host(z_end) - z_rcv) / SIGMA_Z,
            (_host(t_end) - t_obs) / SIGMA_T,
        ])

    # --- joint Gauss-Newton over (z0, p0) -------------------------------
    z0 = f32(Z_INIT)
    history = [float(z0)]
    for it in range(12):
        _, _, dt_dz0, dz_dz0, dt_dp0, dz_dp0 = jvp_columns(env, z0, p0, r_max)
        # the iterate's residual from the compensated trace, as the trial
        # steps' below: under differentiation trace() returns the
        # uncompensated primal (no Kahan, as the JAX package's kernel path
        # does), while the JAX demo's jax.jvp through its CPU scan returns
        # the compensated one, so its backtracking compares like with like
        r = residual(*endpoints(env, z0, p0, r_max))
        J = np.zeros((2 * B, 1 + B))
        J[:B, 0] = _host(dz_dz0) / SIGMA_Z
        J[B:, 0] = _host(dt_dz0) / SIGMA_T
        J[:B, 1:] = np.diag(_host(dz_dp0)) / SIGMA_Z
        J[B:, 1:] = np.diag(_host(dt_dp0)) / SIGMA_T

        du, *_ = np.linalg.lstsq(J, -r, rcond=None)
        # trust region on the depth step (the linearization radius of the
        # oscillatory z_end(z0) map) + backtracking on the full residual
        if abs(du[0]) > 75.0:
            du *= 75.0 / abs(du[0])
        step = 1.0
        for _ in range(5):
            z0_t = z0 + f32(step * du[0])
            p0_t = p0 + f32(step * du[1:])
            r_t = residual(*endpoints(env, z0_t, p0_t, r_max))
            if np.linalg.norm(r_t) < np.linalg.norm(r):
                break
            step *= 0.5
        z0, p0 = z0_t, p0_t
        history.append(float(z0))
        print(f"iter {it:2d}: z0 = {float(z0):8.2f} m   "
              f"|r| = {np.linalg.norm(r_t):10.3f}  (step {step:g})")
        if abs(step * du[0]) < 0.05:
            break

    z_hat = float(z0)
    err = abs(z_hat - Z_TRUE)
    print(f"estimated source depth {z_hat:.1f} m (truth {Z_TRUE:.0f} m, "
          f"error {err:.1f} m, init offset {abs(Z_INIT - Z_TRUE):.0f} m)")
    t_end, _ = endpoints(env, f32(z_hat), p0, r_max)
    assert err < 10.0, f"localization demo degraded: {err:.1f} m error"
    print("localization demo OK")
    return {"z_hat": z_hat, "error_m": err, "matched": B, "iterations": len(history) - 1,
            "history": history, "rds": rds, "z_rcv": z_rcv, "t_obs": t_obs,
            "t_model": _host(t_end), "env": env, "z0": z0, "p0": p0, "r_max": r_max}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    z_rcv, t_obs, t_end = res["z_rcv"], res["t_obs"], res["t_model"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax1.plot(res["history"], "o-", color="tab:red", label="estimate")
    ax1.axhline(Z_TRUE, color="k", ls="--", label="truth")
    ax1.set_xlabel("Gauss-Newton iteration")
    ax1.set_ylabel("source depth [m]")
    ax1.invert_yaxis()
    ax1.legend()
    ax1.set_title(f"depth convergence (final error {res['error_m']:.1f} m)")
    for rd in res["rds"]:
        m = z_rcv == rd
        ax2.plot(t_obs[m], np.full(m.sum(), rd), "k.", ms=10)
        ax2.plot(t_end[m], np.full(m.sum(), rd), "rx", ms=8)
    ax2.plot([], [], "k.", label="observed")
    ax2.plot([], [], "rx", label="modeled at $\\hat{z}_0$")
    ax2.invert_yaxis()
    ax2.set_xlabel("arrival time [s]")
    ax2.set_ylabel("receiver depth [m]")
    ax2.legend()
    ax2.set_title("arrival pattern fit")
    fig.savefig(out / "localization.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
