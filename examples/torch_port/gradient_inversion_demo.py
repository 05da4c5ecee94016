"""Gradient-based 2D tomography on the PyTorch/CUDA port, with reverse-mode
coefficient gradients.

Where ``inversion_demo.py`` assembles the full Fermat Jacobian and solves
a linear least-squares system, this demo runs the NONLINEAR inversion the
`travel_times_of_coef` map exists for: minimize a travel-time misfit over
the full range-dependent spectral coefficient table (nr × K unknowns)
with ``torch.autograd`` + Adam.  Each gradient is ONE reverse pass — on a
CUDA card the cotangent contracts through the range-dependent
coefficient-tangent kernel on the device, and the (B, nr, K) Jacobian is
never materialized; the forward pass is one fan-kernel launch.

1. truth: a range-dependent Munk ocean with a warm anomaly localized in
   BOTH range and depth,
2. observables: direct travel times of a B-ray fan at the receiver range,
3. inversion: Adam on 0.5·||f(cc) − T_obs||² + λ·||cc − cc0||² starting
   from the unperturbed ocean,
4. result: misfit drops orders of magnitude; the recovered δc(r, z) map
   concentrates at the anomaly's (range, depth) cell.

    python examples/torch_port/gradient_inversion_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np
import numpy.polynomial.chebyshev as ncheb
import torch

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.adjoint import travel_times_of_coef
from pygenray_tpu_torch.envdata import make_env_data
from pygenray_tpu_torch.integrate import SolverSettings

OUT = pathlib.Path(__file__).resolve().parent
SRC = 1300.0


def build(z, r, dc_rz, dtype, cheb_order, device):
    c = np.outer(np.ones(len(r)), pr.munk_ssp(z)) + dc_rz
    # the unknown is the full (nr, K) table, so the unperturbed baseline
    # must carry the range-dependent layout too; dcdz="consistent" makes
    # the field Hamiltonian-consistent AND frees the order choice from
    # the central-differences dc/dz fit gate
    return make_env_data(
        c, r, z, np.full(len(r), 5500.0), r, dtype=dtype,
        cheb_order=cheb_order, cheb_exact_order=True,
        force_range_dependent=True, dcdz="consistent", device=device,
    )


def misfit_and_grad(f, cc, T_obs, cc0, lam):
    """The misfit 0.5·Σ d² + λ·Σ (cc − cc0)², d = f(cc) − T_obs, as a torch
    function of a leaf copy of ``cc``, and its gradient over that leaf
    (``torch.autograd.grad``: one reverse pass through ``f``)."""
    cc = cc.detach().requires_grad_(True)
    d = f(cc) - T_obs
    val = 0.5 * torch.sum(d * d) + lam * torch.sum((cc - cc0) ** 2)
    (g,) = torch.autograd.grad(val, cc)
    return val.detach(), g


def run(smoke=False, device="cuda"):
    """The demo's computation and its asserts.  ``smoke=True`` shrinks every
    size and, off the card, takes float64 (the autograd fallback through
    the torch-op loop, as the JAX demo takes its scan fallback there);
    ``device`` is where the tensors live (the CUDA card unless the caller
    asks for ``"cpu"``)."""
    on_card = torch.device(device).type == "cuda"

    r_max = 30e3 if smoke else 60e3
    nr = 5 if smoke else 9
    # order 23 resolves Munk + the 300 m anomaly lens within the fit gate
    K = 24 if smoke else 32
    B = 16 if smoke else 128
    iters = 40 if smoke else 150
    dtype = torch.float64 if smoke and not on_card else torch.float32

    z = np.linspace(0.0, 6000.0, 600 if smoke else 1200)
    r = np.linspace(0.0, r_max, nr)
    # truth: +3 m/s warm lens at 900 m depth, centered at 40% range
    # (sigma_z=700 m keeps the perturbed field within order-23's fit gate)
    dc_true = (3.0 * np.exp(-(((z - 900.0) / 700.0) ** 2))[None, :]
               * np.exp(-(((r - 0.4 * r_max) / (0.18 * r_max)) ** 2))[:, None])
    env_true = build(z, r, dc_true, dtype, K - 1, device)
    env0 = build(z, r, 0.0 * dc_true, dtype, K - 1, device)
    assert env0.range_dependent and env0.c_cheb.shape == (nr, K)

    s = SolverSettings(dx=300.0 if smoke else 200.0, interp="cheb",
                       kahan=False)
    angles = np.linspace(-11.0, 11.0, B)
    c_src = np.interp(SRC, z, env0.c[0].cpu().numpy())
    p0 = np.sin(np.radians(-angles)) / c_src  # cast to the field's dtype by the map

    f_true = travel_times_of_coef(env_true, SRC, p0, 0.0, r_max, s)
    T_obs = f_true(env_true.c_cheb)
    f = travel_times_of_coef(env0, SRC, p0, 0.0, r_max, s)
    cc0 = env0.c_cheb
    lam = 1e-10  # Tikhonov pull toward the background

    # Adam on the coefficient table
    cc = cc0.clone()
    m = torch.zeros_like(cc)
    v = torch.zeros_like(cc)
    # Adam's step is ~lr per coordinate: the unknowns are sound-speed
    # coefficients in m/s and the anomaly is ~3 m/s.  Swept on the smoke
    # config: 0.03 drops the misfit 318x in 40 iterations (0.25
    # overshoots and oscillates, 3e-4 crawls)
    lr, b1, b2, eps = 0.03, 0.9, 0.999, 1e-12
    hist = []
    for it in range(iters):
        val, g = misfit_and_grad(f, cc, T_obs, cc0, lam)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = v / (1 - b2 ** (it + 1))
        cc = cc - lr * mh / (torch.sqrt(vh) + eps)
        hist.append(float(val))
        if it % max(1, iters // 8) == 0:
            print(f"iter {it:4d}  misfit {hist[-1]:.3e}")

    drop = hist[0] / max(hist[-1], 1e-300)
    print(f"misfit {hist[0]:.3e} -> {hist[-1]:.3e}  ({drop:.1f}x)")
    assert hist[-1] < hist[0] * (0.25 if smoke else 0.05), (
        "gradient inversion failed to reduce the misfit")

    # honest skill metric for an underdetermined inversion (B data points
    # vs nr*K unknowns): predict travel-time anomalies for a HELD-OUT fan
    # the optimizer never saw.  Field-map correlation would grade the
    # null-space, which travel times cannot constrain.
    val_angles = np.linspace(-10.3, 10.3, B + 7)  # offset grid
    p0_val = np.sin(np.radians(-val_angles)) / c_src
    f_val = travel_times_of_coef(env0, SRC, p0_val, 0.0, r_max, s)
    f_val_true = travel_times_of_coef(env_true, SRC, p0_val, 0.0, r_max, s)
    host = lambda a: a.detach().cpu().numpy().astype(float)
    with torch.no_grad():
        dT_pred = host(f_val(cc) - f_val(cc0))
        dT_true = host(f_val_true(env_true.c_cheb) - f_val(cc0))
    cor = float(np.corrcoef(dT_pred, dT_true)[0, 1])
    rms_res = float(np.sqrt(np.mean((dT_pred - dT_true) ** 2)))
    rms_sig = float(np.sqrt(np.mean(dT_true ** 2)))
    print(f"held-out dT: corr {cor:.3f}, residual rms {rms_res * 1e3:.4f} ms"
          f" vs signal rms {rms_sig * 1e3:.4f} ms")
    assert cor > 0.9, cor
    assert rms_res < 0.5 * rms_sig, (rms_res, rms_sig)
    return {"misfit_first": hist[0], "misfit_last": hist[-1], "drop": drop,
            "heldout_corr": cor, "heldout_residual_rms_s": rms_res,
            "heldout_signal_rms_s": rms_sig, "hist": hist, "z": z, "r": r,
            "z_dom": env0.z_dom, "dc_true": dc_true, "dcc": host(cc - cc0)}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    # recovered perturbation field on a (r, z) grid (for the figure; the
    # point-wise map carries the inversion's null-space)
    z, r, dc_true, dcc = res["z"], res["r"], res["dc_true"], res["dcc"]  # dcc: (nr, K)
    zlo, zhi = res["z_dom"]
    zg = np.linspace(zlo, min(zhi, 3000.0), 240)
    u = 2.0 * (zg - zlo) / (zhi - zlo) - 1.0
    rec = np.stack([ncheb.chebval(u, dcc[j]) for j in range(len(r))])
    tru = np.stack([np.interp(zg, z, np.asarray(dc_true[j], float)) for j in range(len(r))])

    fig, axs = plt.subplots(1, 3, figsize=(13, 4))
    vmax = float(np.abs(tru).max())
    for ax, fld, title in ((axs[0], tru, "truth δc(r,z)"),
                           (axs[1], rec, "recovered δc(r,z)")):
        im = ax.pcolormesh(r / 1e3, zg, fld.T, cmap="RdBu_r",
                           vmin=-vmax, vmax=vmax)
        ax.invert_yaxis()
        ax.set_xlabel("range [km]")
        ax.set_ylabel("depth [m]")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, label="m/s")
    axs[2].semilogy(res["hist"])
    axs[2].set_xlabel("Adam iteration")
    axs[2].set_ylabel("misfit")
    axs[2].set_title(f"misfit ({res['drop']:.0f}× drop; held-out δT corr "
                     f"{res['heldout_corr']:.2f})")
    fig.tight_layout()
    fig.savefig(out / "gradient_inversion_demo.png", dpi=110)
    plt.close("all")
    print(f"wrote {out / 'gradient_inversion_demo.png'}")
    return res


if __name__ == "__main__":
    main()
