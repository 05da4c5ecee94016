"""Transmission-loss field demo on the PyTorch/CUDA port: Munk channel
convergence zones.

The classic ray-model deliverable: a TL(r, z) map of the deep sound
channel showing the insonified duct, caustic envelopes, and
convergence-zone focusing, from ONE traced fan + one forward-tangent
launch (`transmission_loss_field`; on a CUDA card the save-grid tangent
kernel).  The incoherent (flux) field gives the smooth energy picture; the
coherent (geometric-beam) field adds the interference structure at a
chosen frequency.

The axis-insonification assert (80 % of the on-axis cells finite) is the
JAX demo's own; both packages fall short of it at full size (ROADMAP C1).

    python examples/torch_port/tl_demo.py
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
    r_max = 30e3 if smoke else 120e3
    env = munk_env(r_max=r_max, nr=12 if smoke else 50,
                   nz=500 if smoke else 1200)
    angles = np.linspace(-13.0, 13.0, 301 if smoke else 2001)
    depths = np.linspace(0.0, 5000.0, 101 if smoke else 251)

    fld = pr.transmission_loss_field(
        1000.0, 0.0, angles, r_max, env,
        frequency=75.0, depths=depths,
        num_range=81 if smoke else 301, flatearth=False, device=device)

    # the duct must be insonified and TL must grow with range on axis
    axis = np.argmin(np.abs(depths - 1000.0))
    on_axis = fld.tl_incoherent[axis]
    finite = np.isfinite(on_axis)
    assert finite.mean() > 0.8, "sound channel axis not insonified"
    near = on_axis[finite][: finite.sum() // 4].mean()
    far = on_axis[finite][-finite.sum() // 4:].mean()
    assert far > near, "TL should increase with range along the axis"
    assert np.isfinite(fld.tl_coherent).any()
    print(f"on-axis TL: {near:.1f} dB (near) -> {far:.1f} dB (far)")
    return {"axis_insonified": float(finite.mean()), "tl_near_db": float(near),
            "tl_far_db": float(far), "field": fld}


def main(smoke=False, outdir=None, device="cuda"):
    """``run`` and the figure; ``outdir`` redirects it."""
    out = pathlib.Path(outdir) if outdir is not None else OUT
    res = run(smoke=smoke, device=device)
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fld = res["field"]
    fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    fld.plot("incoherent", ax=axes[0], vmin=60, vmax=110)
    fld.plot("coherent", ax=axes[1], vmin=60, vmax=110)
    fig.tight_layout()
    fig.savefig(out / "tl_field.png", dpi=110)
    plt.close("all")
    print(f"wrote {out / 'tl_field.png'}")
    return res


if __name__ == "__main__":
    main()
