"""Write ``port_tests_jax.npz``: JAX-package answers that the port's CPU
tests hold the port to, where computing them live costs a JAX compile of
many seconds in every test process.

Run from the repository root on a CPU (about two and a half minutes, most
of it the JAX package's mesh compiles):

    JAX_PLATFORMS=cpu python tests/fixtures/make_port_tests_fixture.py

The cases are the tests' own (imported from the test modules, so the two
cannot drift apart):

* ``tangent_rd/0`` ... ``/8`` — ``tests/test_torch_tangent.py``'s
  range-dependent reference: the final state, its tangent for a unit seed
  in p0 and the counters, by ``jax.jvp`` through the JAX package's scan
  without Kahan (float32, the monomial path off);
* ``response/*`` — ``tests/test_torch_response.py``'s end-to-end case: the
  JAX package's ``array_response`` on the float64 isovelocity slab (``t``,
  ``waveform``, and for receiver d every field of its ``Arrivals`` under
  ``response/d<d>/``);
* ``eigenrays/<case>/*`` — ``tests/test_torch_eigenrays.py``'s
  ``find_eigenrays`` cases (``JAX_CASES``: float32 and float64 Newton and
  regula falsi, a backwards shot, table and segment profiles) through the
  JAX package, on the port's fans (``case_call``), each ``EigenRays`` as
  ``eigen_record`` stores it;
* ``sharding/*`` — ``tests/test_torch_sharding.py``'s cases on the JAX
  package's 8-device virtual CPU mesh (``tests/conftest.py``'s): the
  sharded ``shoot_rays`` fan, ``trace`` of a sharded batch (the XLA scan,
  and the Pallas kernel in interpret mode), ``trace_ensemble`` over the
  realization axis (float64 XLA, float32 Pallas), ``mc_eigenray_times``
  (float32 Pallas, one-shot) and ``find_eigenrays`` (float64).

The tests' parameters are stored beside the results (``params``, JSON), and
each test checks them against its own before it reads the answers.  The
Pallas kernels stay live in the tests (one interpreter run each).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys

import numpy as np

# the 8-device virtual CPU mesh of tests/conftest.py, before jax starts
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
sys.path.insert(0, str(HERE.parent))  # the tests
OUT = HERE / "port_tests_jax.npz"


def params():
    """The test parameters the answers depend on, as the tests define them."""
    import test_torch_eigenrays as eg
    import test_torch_response as rsp
    import test_torch_sharding as sh
    import test_torch_tangent as tan

    return {
        "eigenrays": eg.eigen_params(),
        "tangent_rd": {"x1": tan.X1, "dx": tan.DX, "angles": tan.ANGLES.tolist(), "nr": tan.NR},
        "response": {"c0": rsp.C0, "range": rsp.RANGE, "zd": rsp.ZD.tolist(), "e2e": rsp.E2E},
        "sharding": sh.PARAMS,
    }


def eigenray_answers(out):
    """``tests/test_torch_eigenrays.py``'s cases through the JAX package."""
    import pygenray_tpu as jp
    import test_torch_eigenrays as eg

    for case in eg.JAX_CASES:
        for k, v in eg.eigen_record(eg.case_call(jp, case)).items():
            out[f"eigenrays/{case}/{k}"] = v


def sharding_answers(out):
    """``tests/test_torch_sharding.py``'s cases on the JAX package's mesh."""
    import jax
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import pygenray_tpu.montecarlo as jmc
    import test_torch_sharding as sh
    from pygenray_tpu.integrate import SolverSettings, trace
    from pygenray_tpu.parallel import make_mesh, shard_rays
    from pygenray_tpu.shoot import settings_for

    assert jax.device_count() == 8
    mesh, P = make_mesh(), sh.PARAMS
    put = lambda name, **arrays: out.update(
        {f"sharding/{name}/{k}": np.asarray(v) for k, v in arrays.items()})
    f, t, k, e, m, g = (P[n] for n in ("fan", "trace", "kernel", "ens", "mc", "eig"))
    tab = sh.munk_tables(f["nz"], f["nr"], f["x1"], 5000.0)
    env = jp.make_env_data(*tab, interp="table", dtype=jnp.float64)
    fan = jp.shoot_rays(1300.0, 0.0, sh.lin(f["angles"]), f["x1"], f["num_save"], env,
                        flatearth=False, dx=f["dx"], mesh=mesh)
    put("fan", thetas=fan.thetas, ts=fan.ts, zs=fan.zs, n_botts=fan.n_botts,
        n_surfs=fan.n_surfs)
    res = trace(env, 1300.0, shard_rays(jnp.asarray(sh.trace_p0()), mesh), 0.0, t["x1"],
                t["num_save"], settings_for(dx=t["dx"], interp="table"))
    put("trace", ts=res.ts, zs=res.zs, n_bott=res.n_bott, n_surf=res.n_surf,
        death_code=res.death_code)
    env_k = dataclasses.replace(jp.make_env_data(
        *sh.munk_tables(k["nz"], k["nr"], k["x1"], 4600.0), dtype=jnp.float32), poly_ok=False)
    res = trace(env_k, 1300.0, shard_rays(jnp.asarray(sh.kernel_p0()), mesh), 0.0, k["x1"],
                k["num_save"], SolverSettings(dx=k["dx"], backend="pallas"))
    put("kernel", ts=res.ts, zs=res.zs, n_bott=res.n_bott, n_surf=res.n_surf,
        death_code=res.death_code, alive_save=res.alive_save)
    c, r, z = sh.ensemble_tables()
    ens = {dt: jmc.make_env_ensemble(c, r, z, np.full(len(r), 5000.0), r, dtype=dt)
           for dt in (jnp.float64, jnp.float32)}
    ens[jnp.float32] = dataclasses.replace(ens[jnp.float32], poly_ok=False)
    for dt, name, backend in ((jnp.float64, "ens64", "xla"), (jnp.float32, "ens32", "pallas")):
        res = jmc.trace_ensemble(ens[dt], 1300.0, jnp.asarray(sh.ens_p0(), dt), 0.0,
                                 e["r_max"], e["num_save"],
                                 SolverSettings(dx=e["dx"], backend=backend), mesh=mesh)
        put(name, ts=res.ts, zs=res.zs, n_bott=res.n_bott, n_surf=res.n_surf,
            death_code=res.death_code)
    mc = jmc.mc_eigenray_times(ens[jnp.float32], sh.lin(m["fan"]), m["receiver_depth"],
                               m["source_depth"], 0.0, m["x1"], ztol=m["ztol"],
                               settings=SolverSettings(dx=m["dx"], backend="pallas"),
                               mesh=make_mesh(m["devices"]))
    assert mc["path"] == "one-shot"
    put("mc", valid=mc["valid"], t=mc["t"], theta=mc["theta"], n_bott=mc["n_bott"])
    env = jp.make_env_data(*sh.munk_tables(g["nz"], g["nr"], g["x1"], 5000.0), interp="cheb",
                           dtype=jnp.float64)
    rays = jp.shoot_rays(1300.0, 0.0, sh.lin(g["angles"]), g["x1"], 2, env, flatearth=False,
                         dx=g["dx"])
    er = jp.find_eigenrays(rays, g["rds"], 1300.0, 0.0, g["x1"], g["num_save"], env,
                           ztol=g["ztol"], flatearth=False, dx=g["dx"], mesh=mesh)
    for d in range(len(g["rds"])):
        order = np.argsort(er.launch_angles[d])
        put("eig", **{f"angles{d}": np.asarray(er.launch_angles[d])[order],
                      f"ts{d}": np.asarray(er.ts[d])[order]})


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import test_torch_response as rsp
    import test_torch_tangent as tan

    out = {"params": np.array(json.dumps(params()))}

    je = dataclasses.replace(jp.make_env_data(*tan._tables("rd"), dtype=jnp.float32),
                             poly_ok=False)
    for j, a in enumerate(tan._jax_scan_tangent(je, jnp.asarray(tan._p0(), jnp.float32))):
        out[f"tangent_rd/{j}"] = np.asarray(a)

    env = jp.make_env_data(*rsp._slab(), dtype=np.float64)
    ar = jp.array_response(1000.0, 0.0, rsp.ZD, rsp.RANGE, env, **rsp.E2E)
    out["response/t"] = np.asarray(ar.t)
    out["response/waveform"] = np.asarray(ar.waveform)
    for d, resp in enumerate(ar.responses):
        for f in dataclasses.fields(resp.arrivals):
            v = getattr(resp.arrivals, f.name)
            if v is not None:
                out[f"response/d{d}/{f.name}"] = np.asarray(v)

    eigenray_answers(out)
    sharding_answers(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
