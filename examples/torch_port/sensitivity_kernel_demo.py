"""Travel-time sensitivity kernel demo on the PyTorch/CUDA port: the
tomography forward operator.

Computes ∂T/∂c(z) for a handful of eigenray-like paths by differentiating
the ray engine, and plots the depth-resolved kernels — each ray samples
the ocean where it spends time, so steep rays carry deep information and
flat rays axial information.  On a CUDA card the whole (rays × terms)
Jacobian is one launch of the coefficient-tangent kernel.

    python examples/torch_port/sensitivity_kernel_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np
import numpy.polynomial.chebyshev as ncheb
import torch

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.envdata import make_env_data
from pygenray_tpu_torch.integrate import SolverSettings

OUT = pathlib.Path(__file__).resolve().parent


def run(smoke=False, device="cuda"):
    """The demo's computation.  ``smoke=True`` shrinks the grid/range for
    the test suite; ``device`` is where the tensors live (the CUDA card
    unless the caller asks for ``"cpu"``).  The field is float32 on the
    card, where the coefficient-tangent kernel takes it, and float64 on the
    CPU (the JAX demo asks for float64, which JAX gives on the CPU with x64
    enabled and turns into float32 on an accelerator)."""
    dtype = "float32" if torch.device(device).type == "cuda" else "float64"
    r_max = 30e3 if smoke else 100e3
    z = np.linspace(0.0, 6000.0, 500 if smoke else 1200)
    r = np.linspace(0.0, r_max, 8)
    c = np.outer(np.ones(8), pr.munk_ssp(z))
    env = make_env_data(c, r, z, np.full(8, 5500.0), r, dtype=dtype, device=device)

    angles = (np.array([-8.0, 0.0, 8.0]) if smoke
              else np.array([-12.0, -8.0, -4.0, 0.0, 4.0, 8.0, 12.0]))
    c_src = np.interp(1300.0, z, c[0])
    p0 = np.sin(np.radians(-angles)) / c_src

    T0, jac = pr.travel_time_jacobian(
        env, 1300.0, p0, 0.0, r_max,
        SolverSettings(dx=200.0 if smoke else 100.0, interp="cheb")
    )
    jac = jac.detach().cpu().numpy().astype(np.float64)
    assert np.isfinite(jac).all()

    # quantitative check: a +1 m/s warm layer at 1000±200 m
    dc = np.exp(-(((z - 1000.0) / 200.0) ** 2))
    dT = pr.perturbation_response(jac, env, dc)
    for a, d in zip(angles, dT):
        print(f"angle {a:+5.1f}°: δT = {d * 1e3:+7.3f} ms per (+1 m/s warm layer)")
    return {"travel_times": T0.detach().cpu().numpy(), "dT_warm_layer": dT, "angles": angles,
            "z": z, "jac": jac}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    # convert coefficient-space gradients to dT/dc(z) kernels: evaluate the
    # dual pairing against delta-like bumps, i.e. chebval of the Jacobian
    z, jac = res["z"], res["jac"]
    u = (2 * z - (z[0] + z[-1])) / (z[-1] - z[0])
    plt.figure(figsize=(7, 6))
    for b, a in enumerate(res["angles"]):
        kern = ncheb.chebval(u, jac[b])  # δT per (coef-basis δc)
        plt.plot(kern * 1e3, -z, label=f"{a:+.0f}°")
    plt.xlabel("sensitivity [ms per m/s, spectral basis]")
    plt.ylabel("depth [m]")
    plt.legend(title="launch angle")
    plt.title("Travel-time sensitivity kernels (AD through the ray engine)")
    plt.savefig(out / "sensitivity_kernels.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
