"""Write ``mc_jax_f32.npz``: the JAX package's Monte-Carlo answers, for
``chip_smoke.py`` to hold the PyTorch port to on a CUDA card (that machine
has no JAX).

Run from the repository root on a CPU (about a minute):

    JAX_PLATFORMS=cpu python tests/fixtures/make_mc_fixture.py

Two results, float32, each rebuilt on the card from the stored parameters
with the port's own copies of the numpy code:

* ``mc`` — ``mc_eigenray_times`` at ``examples/monte_carlo_demo.py``'s
  smoke size: ``perturbed_munk_tables(4, r_max=30 km, nr=12, nz=1024)``
  over a flat 5000 m bottom, a 128-angle ±14° fan, source and receiver at
  1300 m, ztol = 1 m, the default step (dx = 50 m), ``backend="xla"``
  (two-phase regula falsi on the scan); stored: ``valid``, ``theta``,
  ``t``, ``n_surf``, ``n_bott`` (E, M);
* ``rough`` — ``trace_ensemble`` through the first two realizations of
  ``bench.py``'s rough field (``rough_field.py``: nz = 2001, 16 stations
  over 100 km) of 1,024 rays ±15° from 1300 m to 30 km, dx = 100 m, 2 saves,
  on the scan; stored: the final travel times and depths (E, B), the
  bounce counters and death codes.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
sys.path.insert(0, str(HERE))
OUT = HERE / "mc_jax_f32.npz"

PARAMS = {
    "mc": {"E": 4, "r_max": 30e3, "nr": 12, "nz": 1024, "mu_rms": 5e-4, "seed": 0,
           "bathy": 5000.0, "fan": [-14.0, 14.0, 128], "receiver_depth": 1300.0,
           "source_depth": 1300.0, "ztol": 1.0, "dx": 50.0},
    "rough": {"E": 2, "nz": 2001, "nr": 16, "r_max": 100e3, "seed": 0, "bathy": 5000.0,
              "fan": [-15.0, 15.0, 1024], "source_depth": 1300.0, "x1": 30e3, "dx": 100.0,
              "c_src": 1500.0},
}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pygenray_tpu.environment import munk_ssp
    from pygenray_tpu.integrate import SolverSettings
    from pygenray_tpu.models import perturbed_munk_tables
    from pygenray_tpu.montecarlo import make_env_ensemble, mc_eigenray_times, trace_ensemble
    from rough_field import rough_tables

    out = {"params": np.array(json.dumps(PARAMS))}
    P = PARAMS["mc"]
    c, r, z = perturbed_munk_tables(P["E"], r_max=P["r_max"], nr=P["nr"], nz=P["nz"],
                                    mu_rms=P["mu_rms"], seed=P["seed"])
    env = make_env_ensemble(c, r, z, np.full(len(r), P["bathy"]), r, dtype=jnp.float32)
    res = mc_eigenray_times(env, np.linspace(*P["fan"][:2], int(P["fan"][2])),
                            P["receiver_depth"], P["source_depth"], 0.0, P["r_max"],
                            ztol=P["ztol"],
                            settings=SolverSettings(dx=P["dx"], backend="xla"))
    for k in ("valid", "theta", "t", "n_surf", "n_bott"):
        out[f"mc/{k}"] = np.asarray(res[k])
    print("mc: arrivals per realization", res["valid"].sum(axis=1), "path", res["path"],
          flush=True)

    P = PARAMS["rough"]
    c, r, z = rough_tables(munk_ssp, P["E"], P["nz"], P["nr"], P["r_max"], P["seed"])
    env = make_env_ensemble(c, r, z, np.full(len(r), P["bathy"]), r, dtype=jnp.float32)
    angles = np.linspace(*P["fan"][:2], int(P["fan"][2]))
    p0 = jnp.asarray(np.sin(np.radians(-angles)) / P["c_src"], jnp.float32)
    fan = trace_ensemble(env, P["source_depth"], p0, 0.0, P["x1"], 2,
                         SolverSettings(dx=P["dx"], backend="xla"))
    out["rough/ts"] = np.asarray(fan.ts)[..., -1]
    out["rough/zs"] = np.asarray(fan.zs)[..., -1]
    for k in ("n_surf", "n_bott", "death_code"):
        out[f"rough/{k}"] = np.asarray(getattr(fan, k))
    print("rough: segment basis", env.seg_basis, "terms", env.c_seg.shape[2], "bounces",
          int(out["rough/n_surf"].sum() + out["rough/n_bott"].sum()), flush=True)
    np.savez(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
