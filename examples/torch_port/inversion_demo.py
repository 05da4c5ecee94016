"""End-to-end ocean acoustic tomography inversion demo on the PyTorch/CUDA
port.

The full loop the framework exists for:

1. truth: a Munk ocean with a warm (fast) anomaly layer,
2. observables: eigenray arrival-time anomalies δT at a vertical receiver
   array — eigenrays found independently in the baseline and perturbed
   oceans (the real measurement: fixed source/receiver endpoints),
3. forward operator: the Fermat path-integral sensitivity kernel
   G = ∂T/∂(spectral sound-speed coefficients) along baseline eigenrays,
4. inversion: truncated-SVD least squares; recovered δĉ(z) vs truth.

Runs on the card in float32 (δT signals are ms-scale against the engine's
~7 µs floor).

    python examples/torch_port/inversion_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np
import numpy.polynomial.chebyshev as ncheb

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.envdata import make_env_data
from pygenray_tpu_torch.integrate import SolverSettings

OUT = pathlib.Path(__file__).resolve().parent
R_MAX = 60e3
SRC = 1300.0
KW = dict(flatearth=False, interp="cheb", dx=200.0)


def build(c1d, z, device, nr=8, r_max=R_MAX):
    r = np.linspace(0.0, r_max, nr)
    c = np.outer(np.ones(nr), c1d)
    return make_env_data(
        c, r, z, np.full(nr, 5500.0), r,
        cheb_order=63, cheb_exact_order=True,  # resolve ~200 m structure
        device=device,
    )


def eigen_times(env, rds, fan_angles, r_max=R_MAX):
    """Eigenray (launch angle, arrival time) lists per receiver depth."""
    fan = pr.shoot_rays(SRC, 0.0, fan_angles, r_max, 2, env, **KW)
    er = pr.find_eigenrays(fan, rds, SRC, 0.0, r_max, 50, env, ztol=0.25, **KW)
    out = []
    for i in range(len(rds)):
        if len(er.launch_angles[i]) == 0:  # shadow-zone depth
            out.append((np.empty(0), np.empty(0)))
            continue
        order = np.argsort(er.launch_angles[i])
        out.append((er.launch_angles[i][order], er.ts[i][order, -1]))
    return out


def run(smoke=False, device="cuda"):
    """The demo's computation and its assert.  ``smoke=True`` shrinks every
    size for the test suite; ``device`` is where the tensors live (the CUDA
    card unless the caller asks for ``"cpu"``)."""
    # smoke keeps the full range — shorter ranges put receiver depths in
    # shadow zones with no eigenrays — and shrinks only the fan/grids
    r_max = R_MAX
    z = np.linspace(0.0, 6000.0, 500 if smoke else 900)
    c_base = pr.munk_ssp(z)
    dc_true = 2.0 * np.exp(-(((z - 700.0) / 250.0) ** 2))
    env_base = build(c_base, z, device, r_max=r_max)
    env_pert = build(c_base + dc_true, z, device, r_max=r_max)
    settings = SolverSettings(dx=200.0, interp="cheb")

    fan_angles = np.linspace(-15, 15, 101 if smoke else 301)
    rds = np.linspace(400.0, 2400.0, 8 if smoke else 16)
    base = eigen_times(env_base, rds, fan_angles, r_max)
    pert = eigen_times(env_pert, rds, fan_angles, r_max)

    # match arrivals per depth by order (identical multipath topology for a
    # small perturbation); collect δT observations + baseline angles
    thetas, dT_obs = [], []
    for (th_b, t_b), (th_p, t_p) in zip(base, pert):
        n = min(len(th_b), len(th_p))
        thetas.append(th_b[:n])
        dT_obs.append(t_p[:n] - t_b[:n])
    thetas = np.concatenate(thetas)
    dT_obs = np.concatenate(dT_obs)
    print(f"{thetas.size} matched eigenray arrivals across {len(rds)} depths")
    print(f"observed dT: {dT_obs.min() * 1e3:.3f} .. {dT_obs.max() * 1e3:.3f} ms")

    # --- Fermat forward operator along the baseline eigenrays -------------
    c_src = np.interp(SRC, z, c_base)
    p0 = np.sin(np.radians(-thetas)) / c_src
    T0, G = pr.fermat_jacobian(env_base, SRC, p0, 0.0, r_max, settings, num_save=600)

    # --- truncated-SVD inversion ------------------------------------------
    U, sv, Vt = np.linalg.svd(G, full_matrices=False)
    keep = sv > 0.02 * sv[0]
    print(f"SVD: keeping {int(keep.sum())}/{sv.size} modes")
    dcoef = Vt[keep].T @ ((U[:, keep].T @ dT_obs) / sv[keep])

    u = (2 * z - (z[0] + z[-1])) / (z[-1] - z[0])
    dc_hat = ncheb.chebval(u, dcoef)

    # the honest comparison: what the ray geometry can resolve.  R = VᵀV is
    # the model resolution operator; project the truth through it.
    K = G.shape[1]
    ct = ncheb.chebfit(u, dc_true, K - 1)
    Vk = Vt[keep]
    dc_res = ncheb.chebval(u, Vk.T @ (Vk @ ct))

    band = (z > 200.0) & (z < 3200.0)  # depths the eigenrays sample
    rms_err = np.sqrt(np.mean((dc_hat[band] - dc_res[band]) ** 2))
    corr = np.corrcoef(dc_hat[band], dc_res[band])[0, 1]
    corr_raw = np.corrcoef(dc_hat[band], dc_true[band])[0, 1]
    print(
        f"recovery vs resolvable truth: rms {rms_err:.3f} m/s, corr {corr:.3f} "
        f"(vs raw truth: corr {corr_raw:.3f})"
    )
    assert corr > 0.8, "inversion demo degraded"
    print("inversion demo OK")
    return {"arrivals": int(thetas.size), "modes_kept": int(keep.sum()),
            "rms_err": float(rms_err), "corr": float(corr), "corr_raw": float(corr_raw),
            "z": z, "dc_true": dc_true, "dc_res": dc_res, "dc_hat": dc_hat}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    z = res["z"]
    plt.figure(figsize=(6, 7))
    plt.plot(res["dc_true"], -z, "k", lw=2, label="truth")
    plt.plot(res["dc_res"], -z, "b:", lw=1.5, label="resolvable truth")
    plt.plot(res["dc_hat"], -z, "r--", lw=2, label="recovered")
    plt.ylim(-4000, 0)
    plt.xlabel("δc [m/s]")
    plt.ylabel("depth [m]")
    plt.legend()
    plt.title(f"Tomographic recovery ({res['arrivals']} eigenrays, corr {res['corr']:.2f})")
    plt.savefig(out / "inversion.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
