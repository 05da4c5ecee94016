"""Monte-Carlo tomography demo on the PyTorch/CUDA port: internal-wave
travel-time wander.

Traces eigenrays through an ensemble of internal-wave-perturbed Munk
profiles and plots the arrival-time spread at a receiver — the statistical
observable ocean tomography inverts.  On a CUDA card the whole ensemble's
eigenray search runs as the ensemble tangent kernel (the fan and each
Newton iteration one launch for every realization at once).

    python examples/torch_port/monte_carlo_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.models import perturbed_munk_tables

OUT = pathlib.Path(__file__).resolve().parent


def run(smoke=False, device="cuda"):
    """The demo's computation and its assert.  ``smoke=True`` shrinks the
    ensemble for the test suite; ``device`` is where the tensors live (the
    CUDA card unless the caller asks for ``"cpu"``)."""
    E = 4 if smoke else 24
    r_max = 30e3 if smoke else 100e3
    c_ens, r, z = perturbed_munk_tables(
        E, r_max=r_max, nr=12 if smoke else 48, nz=1024, mu_rms=5e-4)
    env_ens = pr.make_env_ensemble(c_ens, r, z, np.full(len(r), 5000.0), r, device=device)

    arr = pr.mc_eigenray_times(
        env_ens,
        np.linspace(-14.0, 14.0, 128 if smoke else 512),
        receiver_depth=1300.0,
        source_depth=1300.0,
        source_range=0.0,
        receiver_range=r_max,
        ztol=1.0,
    )

    t = arr["t"]  # (E, M)
    valid = arr["valid"]
    print(f"arrivals per realization: {valid.sum(axis=1)}")
    assert valid.any(), "monte-carlo demo found no arrivals"

    # per-arrival rms wander (matching arrivals across realizations by angle)
    spread = np.nanstd(np.where(valid, t, np.nan), axis=0)
    print("per-arrival rms travel-time wander [ms]:", np.round(spread * 1e3, 3))
    return {"valid_arrivals": int(valid.sum()), "t": t, "valid": valid, "spread": spread}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    t, valid = res["t"], res["valid"]
    plt.figure(figsize=(8, 5))
    for e in range(t.shape[0]):
        te = t[e][valid[e]]
        plt.scatter(te, np.full_like(te, e), s=10, c="k", alpha=0.6)
    plt.xlabel("arrival time [s]")
    plt.ylabel("realization")
    plt.title("Internal-wave travel-time wander (eigenray arrivals)")
    plt.savefig(out / "mc_arrivals.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
