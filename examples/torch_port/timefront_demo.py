"""Classic tomography demo on the PyTorch/CUDA port: Munk-profile ray fan,
timefront, and eigenrays.

The quick-start workflow at full scale: a 4096-ray fan to 100 km, the
timefront at the receiver range, and eigenrays at a vertical receiver
array.  On a CUDA card the fan runs as the fan kernel and the eigenray
search's Newton iterations as the tangent kernel.  Writes PNGs next to
this script.

    python examples/torch_port/timefront_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))

import numpy as np

import pygenray_tpu_torch as pr
from pygenray_tpu_torch.models import munk_env
from pygenray_tpu_torch.utils.profiling import Timer

OUT = pathlib.Path(__file__).resolve().parent


def run(smoke=False, device="cuda"):
    """The demo's computation and its asserts.  ``smoke=True`` shrinks every
    size for the test suite; ``device`` is where the tensors live (the CUDA
    card unless the caller asks for ``"cpu"``)."""
    r_max = 30e3 if smoke else 100e3
    env = munk_env(r_max=r_max, nr=12 if smoke else 50, nz=500 if smoke else 1200)
    angles = np.linspace(-14.0, 14.0, 256 if smoke else 4096)
    num_save = 100 if smoke else 400
    timer = Timer()

    with timer.phase("fan"):
        fan = pr.shoot_rays(
            1300.0, 0.0, angles, r_max, num_save, env, flatearth=False, device=device
        )

    receiver_depths = np.linspace(600.0, 2200.0, 8 if smoke else 32)
    with timer.phase("eigenrays"):
        erays = pr.find_eigenrays(
            fan, receiver_depths, 1300.0, 0.0, r_max, num_save, env,
            ztol=1.0, flatearth=False, device=device,
        )

    found = sum(erays.num_eigenrays_found[i] for i in range(len(receiver_depths)))
    print(f"eigenrays found across {len(receiver_depths)} depths: {found}")
    assert found > 0, "timefront demo found no eigenrays"
    print(timer.report())
    return {"rays": len(fan), "eigenrays_found": int(found), "phases_s": dict(timer.phases),
            "fan": fan, "eigenrays": erays}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figures; ``outdir`` redirects them."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fan = res["fan"]
    plt.figure(figsize=(11, 5))
    fan[:: max(len(fan) // 128, 1)].plot_ray_fan()
    plt.savefig(out / "ray_fan.png", dpi=120, bbox_inches="tight")
    plt.close("all")

    plt.figure(figsize=(7, 6))
    fan.plot_time_front()
    plt.savefig(out / "timefront.png", dpi=120, bbox_inches="tight")
    plt.close("all")

    plt.figure(figsize=(8, 5))
    res["eigenrays"].plot_angle_time(s=8)
    plt.savefig(out / "arrival_pattern.png", dpi=120, bbox_inches="tight")
    plt.close("all")
    return res


if __name__ == "__main__":
    main()
