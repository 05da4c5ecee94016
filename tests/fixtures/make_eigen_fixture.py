"""Write ``eigen_jax_f32.npz``: the JAX package's eigenray answers at full
width, for ``chip_smoke.py`` to hold the PyTorch port to on a CUDA card
(that machine has no JAX).

Run from the repository root on a CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/fixtures/make_eigen_fixture.py

Each case (``CASES``) is one ``find_eigenrays`` or ``find_eigenrays_batch``
call of the JAX package in float32, on an environment named by ``env``:

* ``pair``, ``timefront`` — BASELINE configs 2 and 3 as ``bench.py`` sets
  them up (``build_env``: Munk, nz = 2048, nr = 32, flat 5000 m bottom; a
  1024-angle ±14° fan to 100 km, dx = 200 m; ztol = 1 m; 50 saves);
* ``iter_newton``, ``iter_rf`` — a case where the solver iterates: a
  64-angle fan and ztol = 1 cm, by Newton and by regula falsi;
* ``batch`` — ``bench.py``'s batched configurations (``munk_env(nr=8,
  nz=2000)``, 1024 angles, dx = 50 m, sources 800-1600 m);
* ``rd`` — BASELINE config 1's range-dependent field (64 stations, sloped
  4400→4900 m bottom, dx = 100 m), receivers at 800 and 1300 m, ztol =
  1 cm.  At ztol = 1 m two float32 solvers may stop 0.05 m apart on a steep
  ray, which moves its travel time by 2e-5 s, past the 1e-5 s the
  comparison allows; and a 2000 m receiver adds a bottom-bounced bracket
  that float32 Newton cannot close to 1 cm (its residual stalls at 4.5 cm).

Stored per case: the parameters (``cases``, JSON), and per (source,
receiver depth) the eigenray count, the launch angles sorted and the
final travel times sorted alike; for ``pair`` also the travel times of the
scipy RK45 oracle (``tests/reference_impl.py``, rtol = atol = 1e-11) at the
JAX angles.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
OUT = HERE / "eigen_jax_f32.npz"

R_MAX = 100e3
SRC = 1300.0

CASES = [
    dict(name="pair", env="headline", fan=(-14.0, 14.0, 1024), fan_dx=200.0,
         receivers=[1300.0], sources=[SRC], dx=200.0, ztol=1.0, method="newton"),
    dict(name="timefront", env="headline", fan=(-14.0, 14.0, 1024), fan_dx=200.0,
         receivers=np.linspace(500.0, 2100.0, 64).tolist(), sources=[SRC], dx=200.0,
         ztol=1.0, method="newton"),
    dict(name="iter_newton", env="headline", fan=(-14.0, 14.0, 64), fan_dx=200.0,
         receivers=[800.0, 1300.0, 2000.0], sources=[SRC], dx=200.0, ztol=1e-2,
         method="newton"),
    dict(name="iter_rf", env="headline", fan=(-14.0, 14.0, 64), fan_dx=200.0,
         receivers=[800.0, 1300.0, 2000.0], sources=[SRC], dx=200.0, ztol=1e-2,
         method="regula_falsi"),
    dict(name="batch", env="munk_env", fan=(-14.0, 14.0, 1024), fan_dx=None,
         receivers=[1300.0], sources=[800.0, 1100.0, 1300.0, 1600.0], dx=50.0, ztol=1.0,
         method="newton"),
    dict(name="rd", env="range_dependent", fan=(-14.0, 14.0, 512), fan_dx=100.0,
         receivers=[800.0, 1300.0], sources=[SRC], dx=100.0, ztol=1e-2,
         method="newton"),
]
NUM_SAVE = 50


def tables(name):
    """(c, r, z, bathy) of a named environment, from the JAX package's
    Munk profile (the port's copy gives the same numbers)."""
    from pygenray_tpu.environment import munk_ssp

    z = np.linspace(0.0, 6000.0, 2048)
    if name == "headline":
        r = np.linspace(0.0, R_MAX, 32)
        return np.outer(np.ones(32), munk_ssp(z)), r, z, np.full(32, 5000.0)
    if name == "range_dependent":
        r = np.linspace(0.0, R_MAX, 64)
        c = np.array([munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r])
        return c, r, z, np.linspace(4400.0, 4900.0, 64)
    raise ValueError(name)


def run_case(pr, case):
    import jax.numpy as jnp

    from pygenray_tpu.eigenrays import find_eigenrays_batch
    from pygenray_tpu.envdata import make_env_data
    from pygenray_tpu.models import munk_env

    angles = np.linspace(*case["fan"][:2], int(case["fan"][2]))
    kw = dict(ztol=case["ztol"], flatearth=False, dx=case["dx"], method=case["method"])
    if case["env"] == "munk_env":
        env = munk_env(r_max=R_MAX, nr=8, nz=2000)
        ers = find_eigenrays_batch(angles, case["receivers"], case["sources"], 0.0, R_MAX,
                                   NUM_SAVE, env, dtype="float32", **kw)
    else:
        c, r, z, bathy = tables(case["env"])
        env = make_env_data(c, r, z, bathy, r, dtype=jnp.float32)
        fan = pr.shoot_rays(case["sources"][0], 0.0, angles, R_MAX, 2, env, flatearth=False,
                            dx=case["fan_dx"])
        ers = [pr.find_eigenrays(fan, case["receivers"], case["sources"][0], 0.0, R_MAX,
                                 NUM_SAVE, env, **kw)]
    counts, ang, ts, iters = [], [], [], []
    for er in ers:
        for i in range(len(case["receivers"])):
            n = int(er.num_eigenrays_found[i])
            counts.append(n)
            if n:
                order = np.argsort(er.launch_angles[i])
                ang.append(np.asarray(er.launch_angles[i], float)[order])
                ts.append(np.asarray(er.ts[i], float)[order, -1])
        iters.append(int(er.diagnostics["iterations"].max(initial=0)))
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0)
    return np.array(counts), cat(ang), cat(ts), max(iters)


def oracle_times(angles):
    sys.path.insert(0, str(HERE.parent))
    import reference_impl as oracle

    c, r, z, bathy = tables("headline")
    oenv = oracle.OracleEnv.from_tables(c, r, z, bathy, r)
    return np.array([
        oracle.trace_ray_oracle(oenv, SRC, 0.0, -a, R_MAX, 2, rtol=1e-11, atol=1e-11)[1][0, -1]
        for a in angles
    ])


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import pygenray_tpu as pr

    out = {"cases": np.array(json.dumps(CASES))}
    for case in CASES:
        counts, ang, ts, it = run_case(pr, case)
        name = case["name"]
        out[f"{name}/counts"] = counts
        out[f"{name}/angles"] = ang
        out[f"{name}/ts"] = ts
        out[f"{name}/iterations"] = np.array(it)
        print(name, "eigenrays", int(counts.sum()), "max iterations", it, flush=True)
    out["pair/oracle_ts"] = oracle_times(out["pair/angles"])
    print("pair oracle - JAX [ms]:", (out["pair/ts"] - out["pair/oracle_ts"]) * 1e3)
    np.savez(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
