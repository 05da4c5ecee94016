"""Write ``receiver_jax_f32.npz``: the JAX package's receiver-side answers
(arrival amplitudes and a transmission-loss field), for ``chip_smoke.py`` to
hold the PyTorch port to on a CUDA card (that machine has no JAX).

Run from the repository root on a CPU (about a minute):

    JAX_PLATFORMS=cpu python tests/fixtures/make_receiver_fixture.py

Both parts use the headline field (BASELINE config 0 as ``bench.py`` sets it
up: Munk, nz = 2048, nr = 32, flat 5000 m bottom, 100 km, dx = 200 m) in
float32, a 1300 m source and ``flatearth=False``:

* ``arr/*`` — ``arrival_amplitudes`` for ``ARR_ANGLES`` (96 angles in
  ±12°, 200 saves): every field of the ``Arrivals``;
* ``tl/*`` — ``transmission_loss_field`` for ``TL_ANGLES`` (401 angles in
  ±13°) at 75 Hz on 51 depths × 60 ranges: both fields.

On a CPU the JAX package gets its tangent by ``jax.jvp`` through its scan
without Kahan compensation, the reference its own kernel tests use.  The
parameters are stored beside the results (``params``, JSON).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
OUT = HERE / "receiver_jax_f32.npz"

PARAMS = dict(
    r_max=100e3, src=1300.0, dx=200.0, nz=2048, nr=32, bottom=5000.0,
    arr_angles=(-12.0, 12.0, 96), arr_num_save=200,
    tl_angles=(-13.0, 13.0, 401), tl_depths=(0.0, 5000.0, 51), tl_num_range=61,
    tl_frequency=75.0,
)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import pygenray_tpu as pr

    P = PARAMS
    z = np.linspace(0.0, 6000.0, P["nz"])
    r = np.linspace(0.0, P["r_max"], P["nr"])
    c = np.outer(np.ones(P["nr"]), pr.munk_ssp(z))
    env = pr.make_env_data(c, r, z, np.full(P["nr"], P["bottom"]), r, dtype=jnp.float32)

    out = {"params": np.array(json.dumps(P))}
    arr = pr.arrival_amplitudes(
        P["src"], 0.0, np.linspace(*P["arr_angles"][:2], int(P["arr_angles"][2])), P["r_max"],
        env, num_save=P["arr_num_save"], dx=P["dx"], flatearth=False)
    for f in dataclasses.fields(arr):
        out[f"arr/{f.name}"] = np.asarray(getattr(arr, f.name))
    fld = pr.transmission_loss_field(
        P["src"], 0.0, np.linspace(*P["tl_angles"][:2], int(P["tl_angles"][2])), P["r_max"],
        env, frequency=P["tl_frequency"],
        depths=np.linspace(*P["tl_depths"][:2], int(P["tl_depths"][2])),
        num_range=P["tl_num_range"], dx=P["dx"], flatearth=False)
    out["tl/tl_incoherent"] = fld.tl_incoherent.astype(np.float32)
    out["tl/tl_coherent"] = fld.tl_coherent.astype(np.float32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes): {int(arr.alive.sum())} live arrivals, "
          f"kmah up to {int(arr.kmah.max())}, "
          f"{int(np.isfinite(fld.tl_incoherent).sum())} insonified cells")


if __name__ == "__main__":
    main()
