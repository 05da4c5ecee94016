"""Rough-field tomography sensitivity demo on the PyTorch/CUDA port.

Internal-wave-perturbed profiles carry multi-m/s structure at the table
grid scale — exactly the fields where tomography sensitivity matters most
and where a global spectral fit fails.  The engine integrates them on the
piecewise-segment backend, and `fermat_jacobian` expresses dT/dc in that
same segment basis.

The demo:
 1. builds one internal-wave realization (seg-backed, float64),
 2. assembles the Fermat travel-time Jacobian for a small fan,
 3. projects depth-local sound-speed perturbations through it to get the
    depth-resolved sensitivity kernel dT/dc(z) per ray,
 4. validates one projection against a brute-force perturbed retrace via
    the eikonal endpoint identity: the Fermat operator is the
    FIXED-ENDPOINT (eigenray/tomography) sensitivity, while a re-shot
    fixed-angle ray also moves its endpoint, so
    dT_fixed_angle = dT_fermat + p_end * dz_end.

The fit is float64 (the retrace difference is microseconds), which no
CUDA kernel of the port takes: on the card the traces run as the torch-op
step loop.

    python examples/torch_port/rough_field_sensitivity_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np

from pygenray_tpu_torch.adjoint import fermat_jacobian, perturbation_response
from pygenray_tpu_torch.envdata import make_env_data
from pygenray_tpu_torch.integrate import SolverSettings, trace
from pygenray_tpu_torch.models import perturbed_munk_tables

OUT = pathlib.Path(__file__).resolve().parent

R_MAX = 50e3
SRC_DEPTH = 1300.0


def _host(a):
    return a.detach().cpu().numpy().astype(np.float64)


def run(smoke=False, device="cuda"):
    """The demo's computation and its assert.  ``smoke=True`` shrinks the
    range/fan for the test suite; ``device`` is where the tensors live (the
    CUDA card unless the caller asks for ``"cpu"``)."""
    r_max = 20e3 if smoke else R_MAX
    # one internal-wave realization; seg-backed (the global fit gate fails
    # on this roughness, the segment ladder catches it)
    c_ens, r, z = perturbed_munk_tables(1, r_max=r_max, nr=8 if smoke else 16,
                                        nz=1024, seed=11, mu_rms=1e-3)
    env = make_env_data(c_ens[0], r, z, np.full(len(r), 5000.0), r,
                        interp="seg", dtype="float64", device=device)
    print(f"segment fit: basis={env.seg_basis}, K={env.c_seg.shape[1]}")

    angles = (np.array([-8.0, 0.0]) if smoke
              else np.array([-10.0, -6.0, 0.0, 6.0]))
    c_src = np.interp(SRC_DEPTH, z, c_ens[0][0])
    p0 = np.sin(np.radians(-angles)) / c_src
    settings = SolverSettings(dx=100.0 if smoke else 50.0)

    # Fermat Jacobian in the segment basis: (B, K, S) for this
    # range-independent-style projection (collapse the station axis)
    res0 = trace(env, SRC_DEPTH, p0, 0.0, r_max, 2, settings)
    T_end = _host(res0.ts)[:, -1]
    z_end0 = _host(res0.zs)[:, -1]
    p_end0 = _host(res0.ps)[:, -1]
    _, G = fermat_jacobian(env, SRC_DEPTH, p0, 0.0, r_max, settings,
                           range_dependent=False)
    print("travel times [s]:", np.round(T_end, 3))

    # depth-resolved kernel: response to narrow Gaussian perturbations
    # centred on a depth grid (a numerically friendly delta comb)
    zq = np.linspace(100.0, 4900.0, 25 if smoke else 97)
    sigma = 120.0
    kern = np.empty((len(p0), zq.size))
    for j, zc in enumerate(zq):
        dc = np.exp(-0.5 * ((z - zc) / sigma) ** 2)  # [m/s] unit bump
        kern[:, j] = perturbation_response(G, env, dc, z_samples=z)

    # validate one projection against a brute-force perturbed retrace.
    # The re-shot rays keep their LAUNCH ANGLE, so their endpoints move;
    # subtracting the eikonal endpoint term p_end*dz_end recovers the
    # fixed-endpoint (eigenray) sensitivity the Fermat operator computes.
    zc = 1000.0
    eps = 0.005  # [m/s]
    dc = np.exp(-0.5 * ((z - zc) / sigma) ** 2)
    env_p = make_env_data(c_ens[0] + eps * dc[None, :], r, z,
                          np.full(len(r), 5000.0), r, interp="seg",
                          dtype="float64",
                          seg_order=env.c_seg.shape[1] - 1,
                          seg_exact_order=True, seg_basis=env.seg_basis,
                          device=device)
    res_p = trace(env_p, SRC_DEPTH, p0, 0.0, r_max, 2, settings)
    dT_angle = _host(res_p.ts)[:, -1] - T_end
    dz_end = _host(res_p.zs)[:, -1] - z_end0
    dT_true = dT_angle - p_end0 * dz_end  # fixed-endpoint response
    dT_lin = eps * perturbation_response(G, env, dc, z_samples=z)
    print("dT fixed-endpoint (retrace) [µs]:", np.round(dT_true * 1e6, 3))
    print("dT Fermat                   [µs]:", np.round(dT_lin * 1e6, 3))
    rel = np.abs(dT_lin - dT_true) / np.maximum(np.abs(dT_true), 1e-12)
    print("relative error:", np.round(rel, 4))
    assert np.all(rel < 0.05), rel
    return {"travel_times": T_end, "dT_true": dT_true, "dT_fermat": dT_lin,
            "max_rel_err": float(rel.max()), "angles": angles, "zq": zq, "kern": kern}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    # plot: one axis, one line per ray, direct labels at the line ends
    angles, zq, kern = res["angles"], res["zq"], res["kern"]
    fig, ax = plt.subplots(figsize=(7, 5))
    colors = plt.cm.viridis(np.linspace(0.15, 0.8, len(angles)))
    for i, th in enumerate(angles):
        ax.plot(kern[i] * 1e6, zq, color=colors[i], lw=2,
                label=f"{th:+.0f}° launch")
    ax.legend(loc="lower left", frameon=False, fontsize=9)
    ax.invert_yaxis()
    ax.set_xlabel("dT per unit δc bump [µs / (m/s)]")
    ax.set_ylabel("perturbation depth [m]")
    ax.set_title("Rough-field travel-time sensitivity (segment basis)")
    ax.grid(alpha=0.25, lw=0.5)
    fig.tight_layout()
    fig.savefig(out / "rough_field_sensitivity.png", dpi=120)
    plt.close("all")
    print(f"wrote {out / 'rough_field_sensitivity.png'}")
    return res


if __name__ == "__main__":
    main()
