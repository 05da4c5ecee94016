"""Arrival amplitudes demo on the PyTorch/CUDA port: eigenrays -> complex
arrival factors.

The workflow ocean acousticians run after an eigenray search: feed the
converged launch angles to `arrival_amplitudes` to get each arrival's
geometric transmission loss, caustic (KMAH) count, and phase — the
impulse-response skeleton at the receiver.  On a CUDA card the amplitudes
come from one launch of the save-grid tangent kernel.

    python examples/torch_port/amplitude_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.models import munk_env

OUT = pathlib.Path(__file__).resolve().parent


def run(smoke=False, device="cuda"):
    """The demo's computation and its asserts.  ``smoke=True`` shrinks every
    size for the test suite; ``device`` is where the tensors live (the CUDA
    card unless the caller asks for ``"cpu"``)."""
    r_max = 30e3 if smoke else 100e3
    env = munk_env(r_max=r_max, nr=12 if smoke else 50, nz=500 if smoke else 1200)
    angles = np.linspace(-14.0, 14.0, 256 if smoke else 2048)
    num_save = 100 if smoke else 400
    # at the 30 km smoke range only near-axis depths receive arrivals
    z_src, z_rcv = 1300.0, (1200.0 if smoke else 1000.0)

    fan = pr.shoot_rays(z_src, 0.0, angles, r_max, num_save, env,
                        flatearth=False, device=device)
    erays = pr.find_eigenrays(fan, np.asarray([z_rcv]), z_src, 0.0, r_max,
                              num_save, env, ztol=1.0, flatearth=False, device=device)
    th_eig = np.asarray(erays.launch_angles[0], float)
    assert th_eig.size > 0, "no eigenrays found"

    arr = pr.arrival_amplitudes(z_src, 0.0, th_eig, r_max, env,
                                num_save=256 if smoke else 1024,
                                flatearth=False, device=device)
    ok = arr.alive
    print(f"{ok.sum()} arrivals at z={z_rcv} m, r={r_max/1e3:.0f} km")
    for i in np.flatnonzero(ok):
        print(
            f"  theta0 {arr.theta0[i]:+7.3f} deg  t {arr.travel_time[i]:9.4f} s"
            f"  TL {arr.tl_db[i]:6.2f} dB  kmah {int(arr.kmah[i])}"
            f"  surf {int(arr.n_surf[i])}  phase {arr.phase[i]:+.2f} rad"
        )
    assert np.all(np.isfinite(arr.tl_db[ok]))
    # every arrival landed within a few ztol of the receiver depth
    assert np.all(np.abs(-arr.z_r[ok] - z_rcv) < 10.0)
    return {"arrivals": int(ok.sum()), "r_max": r_max, "z_rcv": z_rcv, "amplitudes": arr}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    arr, r_max, z_rcv = res["amplitudes"], res["r_max"], res["z_rcv"]
    ok = arr.alive
    fig, ax = plt.subplots(figsize=(8, 5))
    m, s, b = ax.stem(arr.travel_time[ok], -arr.tl_db[ok])
    plt.setp(s, lw=1.2)
    for i in np.flatnonzero(ok):
        ax.annotate(f"K{int(arr.kmah[i])}",
                    (arr.travel_time[i], -arr.tl_db[i]),
                    textcoords="offset points", xytext=(0, 6), ha="center",
                    fontsize=8)
    ax.set_xlabel("travel time (s)")
    ax.set_ylabel("arrival level, -TL (dB re 1 m)")
    ax.set_title(f"Munk arrivals at {r_max/1e3:.0f} km, z={z_rcv:.0f} m "
                 "(K = caustic count)")
    fig.savefig(out / "arrival_amplitudes.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
