"""The port's device mesh (``pygenray_tpu_torch.parallel``) on a mesh that
names the CPU eight times: the counterpart of ``tests/test_sharding.py``'s
eight virtual CPU devices (``tests/conftest.py``).

* Counterparts of ``tests/test_sharding.py``'s tests: the mesh, sharded
  against unsharded ``shoot_rays``, ``trace`` (where each shard ran, and
  the gathered result on the mesh's first device), ``pad_to_multiple``,
  ``trace_ensemble`` (plain and ``backend="kernel"``), ``mc_eigenray_times``,
  the ensemble's divisibility error, ``find_eigenrays``, and the kernel
  backend's per-shard dispatch (its plain version on a CPU).  Not its calm
  and dyn block tests: those classifiers are TPU block scheduling and are
  not ported.
* Sharded against unsharded in the port: float64 travel times within
  1e-12 s and depths within 1e-9 m, counters and death codes equal.
* Sharded against the JAX package's own mesh results (its 8-device
  virtual mesh; ``fixtures/port_tests_jax.npz``, section ``sharding``,
  written by ``fixtures/make_port_tests_fixture.py``: the JAX mesh programs
  compile for minutes) at the port's tolerances against the JAX package:
  float64 1e-9 s and 1e-6 m (``test_torch_integrate.py``), float32 5e-6 s
  and 1e-2 m (``test_torch_stepper.py``), eigenrays 1e-9 degrees and
  seconds (``test_torch_eigenrays.py``).
* A one-device mesh is the unsharded trace bit for bit; a batch that does
  not divide the mesh raises ``ValueError``; two shards in worker threads
  equal the sequential run and a worker's exception re-raises; the dry run
  (``parallel.dryrun_multichip``) at two devices; ``parallel``'s
  signatures are the JAX package's; sixteen threads on the launch counters
  and the launch set-up cache lose no increment.

The sizes are cut from ``tests/test_sharding.py``'s (coarser steps, fewer
stations): on a CPU each shard pays the torch-op loop's per-step cost, so
a mesh of eight costs about eight unsharded traces.
"""

import dataclasses
import inspect
import sys
import threading

import numpy as np
import pytest
import torch

import pygenray_tpu.parallel.sharding as jsh
import pygenray_tpu_torch as tp
import pygenray_tpu_torch.integrate as tint
import pygenray_tpu_torch.montecarlo as tmc
from pygenray_tpu_torch.envdata import DATA_FIELDS
from pygenray_tpu_torch.ops import stepper
from pygenray_tpu_torch.parallel import (
    Mesh, dryrun_multichip, make_mesh, pad_to_multiple, replicate_env, run_shards, shard_rays,
)
from pygenray_tpu_torch.parallel import sharding as tsh
from torch_fixtures import jax_answers, one_blas_thread  # noqa: F401

N_DEV = 8
# the cases' parameters, which fixtures/make_port_tests_fixture.py reads too
PARAMS = {
    "fan": {"angles": [-14.0, 14.0, 64], "x1": 20e3, "num_save": 10, "dx": 2000.0,
            "nz": 400, "nr": 8},
    "trace": {"angles": [-10.0, 10.0, 64], "x1": 20e3, "num_save": 10, "dx": 2000.0},
    "kernel": {"angles": [-16.0, 16.0, 64], "x1": 20e3, "num_save": 10, "dx": 2000.0,
               "nz": 512, "nr": 8},
    "ens": {"E": N_DEV, "nz": 256, "nr": 4, "r_max": 20e3, "seed": 3, "angles": [-10.0, 10.0, 8],
            "num_save": 5, "dx": 2000.0},
    # two devices, four realizations a shard: each CPU shard repeats the
    # plain Dual loop's per-step cost (about a second a shard here)
    "mc": {"devices": 2, "fan": [-12.0, 12.0, 25], "receiver_depth": 1600.0,
           "source_depth": 1300.0, "x1": 20e3, "ztol": 1.0, "dx": 2000.0},
    "eig": {"angles": [-12.0, 12.0, 33], "rds": [1000.0, 1300.0], "x1": 40e3, "num_save": 20,
            "ztol": 0.5, "dx": 4000.0, "nz": 400, "nr": 8},
}

def lin(spec):
    return np.linspace(spec[0], spec[1], int(spec[2]))


def munk_tables(nz, nr, r_max, bathy):
    """A range-independent Munk field: (c, r, z, bathy, bathy_r)."""
    z, r = np.linspace(0.0, 6000.0, nz), np.linspace(0.0, r_max, nr)
    return np.outer(np.ones(nr), tp.munk_ssp(z)), r, z, np.full(nr, bathy), r


def ensemble_tables():
    """E smooth realizations, each a Munk axis sloping in range (16
    Chebyshev terms: an internal-wave field's 64 cost the plain Dual loop
    several times more): (c (E, nr, nz), r, z)."""
    p = PARAMS["ens"]
    z, r = np.linspace(0.0, 6000.0, p["nz"]), np.linspace(0.0, p["r_max"], p["nr"])
    slopes = np.random.default_rng(p["seed"]).uniform(-0.01, 0.01, p["E"])
    return np.array([[tp.munk_ssp(z, sofar_depth=1500 + s * ri) for ri in r]
                     for s in slopes]), r, z


def trace_p0():
    return np.sin(np.radians(lin(PARAMS["trace"]["angles"]))) / 1500.0


def kernel_p0():
    return (np.sin(np.radians(-lin(PARAMS["kernel"]["angles"]))) / 1500.0).astype(np.float32)


def ens_p0():
    return np.sin(np.radians(-lin(PARAMS["ens"]["angles"]))) / 1500.0


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's answers on its 8-device mesh."""
    return jax_answers("sharding", **PARAMS)


@pytest.fixture(scope="module")
def envs():
    """The port's environments of the cases, from numpy tables."""
    f, k, g = PARAMS["fan"], PARAMS["kernel"], PARAMS["eig"]
    c, r, z = ensemble_tables()
    out = {
        "table": tp.make_env_data(*munk_tables(f["nz"], f["nr"], f["x1"], 5000.0),
                                  interp="table", dtype="float64", device="cpu"),
        "cheb": tp.make_env_data(*munk_tables(g["nz"], g["nr"], g["x1"], 5000.0),
                                 interp="cheb", dtype="float64", device="cpu"),
        # Clenshaw in float32: XLA contracts Horner's multiply-adds, torch does not
        "kernel": dataclasses.replace(tp.make_env_data(
            *munk_tables(k["nz"], k["nr"], k["x1"], 4600.0), dtype="float32", device="cpu"),
            poly_ok=False),
        "ens_float64": tmc.make_env_ensemble(c, r, z, np.full(len(r), 5000.0), r,
                                             dtype="float64", device="cpu"),
        "ens_float32": dataclasses.replace(tmc.make_env_ensemble(
            c, r, z, np.full(len(r), 5000.0), r, dtype="float32", device="cpu"), poly_ok=False),
    }
    return out


def assert_same_trace(a, b, exact=False):
    """Sharded ``a`` against unsharded ``b`` (TraceResults)."""
    for f in ("n_bott", "n_surf", "death_code", "alive", "alive_save"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if exact:
        assert torch.equal(a.ts, b.ts) and torch.equal(a.zs, b.zs)
    torch.testing.assert_close(a.ts, b.ts, rtol=0, atol=1e-12)
    torch.testing.assert_close(a.zs, b.zs, rtol=0, atol=1e-9)


def assert_near_jax(got, ref, prefix, t_tol, z_tol, fields=("n_bott", "n_surf", "death_code")):
    """A port TraceResult against the JAX answers ``ref[prefix + field]``."""
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[prefix + f], err_msg=f)
    np.testing.assert_allclose(got.ts.numpy(), ref[prefix + "ts"], rtol=0, atol=t_tol)
    if prefix + "zs" in ref:
        np.testing.assert_allclose(got.zs.numpy(), ref[prefix + "zs"], rtol=0, atol=z_tol)


def test_virtual_mesh_has_8_devices(mesh):
    assert mesh.device_list == (torch.device("cpu"),) * N_DEV
    assert mesh.shape == {"rays": N_DEV} and mesh.axis_names == ("rays",)
    assert make_mesh(3, devices=["cpu"] * N_DEV).shape == {"rays": 3}
    with pytest.raises(ValueError, match="available"):
        make_mesh(N_DEV + 1, devices=["cpu"] * N_DEV)


def test_sharded_fan_matches_unsharded(mesh, envs, jax_mesh):
    f = PARAMS["fan"]
    kw = dict(flatearth=False, dx=f["dx"], device="cpu")
    args = (1300.0, 0.0, lin(f["angles"]), f["x1"], f["num_save"], envs["table"])
    rf0 = tp.shoot_rays(*args, **kw)
    rf1 = tp.shoot_rays(*args, mesh=mesh, **kw)
    np.testing.assert_allclose(rf1.ts, rf0.ts, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rf1.zs, rf0.zs, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(rf1.n_botts, rf0.n_botts)
    np.testing.assert_array_equal(rf1.n_surfs, rf0.n_surfs)
    np.testing.assert_array_equal(rf1.thetas, jax_mesh["fan/thetas"])
    np.testing.assert_allclose(rf1.ts, jax_mesh["fan/ts"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rf1.zs, jax_mesh["fan/zs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rf1.n_botts, jax_mesh["fan/n_botts"])
    np.testing.assert_array_equal(rf1.n_surfs, jax_mesh["fan/n_surfs"])


def test_trace_output_is_sharded(mesh, envs, jax_mesh, monkeypatch):
    """Each shard traces its own rays on its device; the gathered result
    sits on the mesh's first device, in ray order."""
    t = PARAMS["trace"]
    s = tp.settings_for(dx=t["dx"], interp="table")
    shards = []
    impl = tint._trace_impl

    def spy(env, z0, p0, geom, settings):
        shards.append((p0.shape[0], p0.device, env.device))
        return impl(env, z0, p0, geom, settings)

    monkeypatch.setattr(tint, "_trace_impl", spy)
    p0 = shard_rays(trace_p0(), mesh)
    assert [c.shape[0] for c in p0.chunks] == [8] * N_DEV and p0.shape == (64,)
    res = tp.trace(envs["table"], 1300.0, p0, 0.0, t["x1"], t["num_save"], s)
    assert shards == [(8, torch.device("cpu"), torch.device("cpu"))] * N_DEV
    assert res.ts.shape == (64, t["num_save"]) and res.ts.device == mesh.device_list[0]
    monkeypatch.undo()
    assert_same_trace(res, tp.trace(envs["table"], 1300.0, trace_p0(), 0.0, t["x1"],
                                    t["num_save"], s))
    assert_near_jax(res, jax_mesh, "trace/", 1e-9, 1e-6)


def test_pad_to_multiple():
    padded, n = pad_to_multiple(np.arange(13.0), 8)
    assert padded.shape == (16,) and n == 13 and (padded[13:] == 0).all()
    padded, n = pad_to_multiple(torch.arange(13.0), 8, fill=-1.0)
    assert padded.shape == (16,) and n == 13 and bool((padded[13:] == -1).all())
    same, n = pad_to_multiple(torch.arange(16.0), 8)
    assert same.shape == (16,) and n == 16


class TestEnsembleMesh:
    """Realization-axis sharding of the Monte-Carlo entry points."""

    def test_sharded_ensemble_matches_unsharded_xla(self, mesh, envs, jax_mesh):
        e = PARAMS["ens"]
        s = tp.SolverSettings(dx=e["dx"])
        args = (1300.0, ens_p0(), 0.0, e["r_max"], e["num_save"], s)
        res0 = tp.trace_ensemble(envs["ens_float64"], *args)
        res1 = tp.trace_ensemble(envs["ens_float64"], *args, mesh=mesh)
        assert res1.ts.shape == (N_DEV, 8, e["num_save"])
        assert_same_trace(res1, res0)
        assert_near_jax(res1, jax_mesh, "ens64/", 1e-9, 1e-6)

    def test_sharded_ensemble_kernel_path(self, mesh, envs, jax_mesh):
        """``backend="kernel"``: each shard's realizations through the fan
        kernel's wrapper (its plain version on a CPU)."""
        e = PARAMS["ens"]
        s = tp.SolverSettings(dx=e["dx"], backend="kernel")
        p0 = ens_p0().astype(np.float32)
        args = (1300.0, p0, 0.0, e["r_max"], e["num_save"], s)
        res0 = tp.trace_ensemble(envs["ens_float32"], *args)
        res1 = tp.trace_ensemble(envs["ens_float32"], *args, mesh=mesh)
        assert_same_trace(res1, res0, exact=True)
        assert_near_jax(res1, jax_mesh, "ens32/", 5e-6, 1e-2)

    def test_mc_eigenray_times_mesh(self, envs, jax_mesh):
        m = PARAMS["mc"]
        kw = dict(receiver_depth=m["receiver_depth"], source_depth=m["source_depth"],
                  source_range=0.0, receiver_range=m["x1"], ztol=m["ztol"],
                  settings=tp.SolverSettings(dx=m["dx"]))
        two = make_mesh(devices=["cpu"] * m["devices"])
        out0 = tp.mc_eigenray_times(envs["ens_float32"], lin(m["fan"]), **kw)
        out1 = tp.mc_eigenray_times(envs["ens_float32"], lin(m["fan"]), mesh=two, **kw)
        assert out0["path"] == out1["path"] == "one-shot"
        v = out0["valid"]
        assert v.sum(axis=1).min() >= 1
        for k in ("valid", "theta", "t", "n_surf", "n_bott"):
            np.testing.assert_array_equal(out1[k], out0[k], err_msg=k)
        np.testing.assert_array_equal(v, jax_mesh["mc/valid"])
        np.testing.assert_allclose(out1["t"][v], jax_mesh["mc/t"][v], rtol=0, atol=5e-6)
        np.testing.assert_allclose(out1["theta"][v], jax_mesh["mc/theta"][v], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(out1["n_bott"][v], jax_mesh["mc/n_bott"][v])

    def test_mesh_divisibility_error(self, mesh, envs):
        ens = envs["ens_float64"]
        three = dataclasses.replace(ens, **{f: getattr(ens, f)[:3] for f in DATA_FIELDS})
        p0 = ens_p0()[:4]
        with pytest.raises(ValueError, match="divide evenly"):
            tp.trace_ensemble(three, 1300.0, p0, 0.0, 20e3, 5, tp.SolverSettings(dx=500.0),
                              mesh=mesh)
        with pytest.raises(ValueError, match="divide evenly"):
            tp.mc_eigenray_times(three, lin(PARAMS["mc"]["fan"]), 1600.0, 1300.0, 0.0, 20e3,
                                 mesh=mesh)


def test_find_eigenrays_mesh_matches_unsharded(mesh, envs, jax_mesh):
    """Candidate-axis sharding of the eigenray solve: 2 depths' candidates
    padded to the mesh with copies of candidate 0 and sliced away."""
    g = PARAMS["eig"]
    env = envs["cheb"]
    rays = tp.shoot_rays(1300.0, 0.0, lin(g["angles"]), g["x1"], 2, env, flatearth=False,
                         dx=g["dx"], device="cpu")
    kw = dict(ztol=g["ztol"], flatearth=False, dx=g["dx"])
    args = (rays, g["rds"], 1300.0, 0.0, g["x1"], g["num_save"], env)
    er0 = tp.find_eigenrays(*args, **kw)
    er1 = tp.find_eigenrays(*args, mesh=mesh, **kw)
    n = sum(er0.num_eigenrays_found.values())
    assert n >= 3 and n % N_DEV  # the padding ran
    assert er0.num_eigenrays_found == er1.num_eigenrays_found
    for k in ("iterations", "converged", "rd_idx"):
        np.testing.assert_array_equal(er1.diagnostics[k], er0.diagnostics[k])
    for d in range(len(g["rds"])):
        np.testing.assert_allclose(er1.launch_angles[d], er0.launch_angles[d], rtol=1e-12)
        np.testing.assert_allclose(er1.ts[d], er0.ts[d], rtol=1e-12)
        order = np.argsort(er1.launch_angles[d])
        np.testing.assert_allclose(er1.launch_angles[d][order], jax_mesh[f"eig/angles{d}"],
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(er1.ts[d][order], jax_mesh[f"eig/ts{d}"], rtol=0, atol=1e-9)
    two_d = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("a", "b"))
    with pytest.raises(ValueError, match="find_eigenrays expects a 1D mesh"):
        tp.find_eigenrays(*args, mesh=two_d, **kw)


def test_sharded_kernel_dispatch_matches_unsharded_kernel(mesh, envs, jax_mesh, monkeypatch):
    """A sharded fan with ``backend="kernel"`` goes through the fan
    kernel's wrapper once a shard (on a CPU, its plain version: no launch)
    and equals the unsharded wrapper's result."""
    k = PARAMS["kernel"]
    s = tp.SolverSettings(dx=k["dx"], backend="kernel")
    env = envs["kernel"]
    calls = []
    wrapper = stepper.trace_kernel
    monkeypatch.setattr(stepper, "trace_kernel",
                        lambda env, z0, p0, *a: calls.append(p0.shape[0]) or wrapper(env, z0, p0,
                                                                                    *a))
    n0 = stepper.LAUNCHES
    res_sh = tp.trace(env, 1300.0, shard_rays(kernel_p0(), mesh), 0.0, k["x1"], k["num_save"], s)
    assert calls == [8] * N_DEV and stepper.LAUNCHES == n0
    res_1 = tp.trace(env, 1300.0, kernel_p0(), 0.0, k["x1"], k["num_save"], s)
    assert_same_trace(res_sh, res_1, exact=True)
    assert_near_jax(res_sh, jax_mesh, "kernel/", 5e-6, 1e-2,
                    ("n_bott", "n_surf", "death_code", "alive_save"))


def test_uneven_batch_raises(mesh, envs):
    """13 rays do not divide 8 devices (JAX's ``device_put`` raises too)."""
    with pytest.raises(ValueError, match="does not divide"):
        shard_rays(np.zeros(13), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tp.shoot_rays(1300.0, 0.0, np.linspace(-5, 5, 13), 10e3, 2, envs["table"], dx=1000.0,
                      mesh=mesh, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        shard_rays(np.zeros(16), object())


def test_one_device_mesh_is_unsharded_bitwise(envs):
    t = PARAMS["trace"]
    s = tp.settings_for(dx=t["dx"], interp="table")
    one = make_mesh(devices=["cpu"])
    z0 = np.linspace(1000.0, 1500.0, 64)  # per-ray source depths shard with p0
    a = tp.trace(envs["table"], z0, shard_rays(trace_p0(), one), 0.0, t["x1"], t["num_save"], s)
    b = tp.trace(envs["table"], z0, trace_p0(), 0.0, t["x1"], t["num_save"], s)
    for f in ("rs", "ts", "zs", "ps", "n_bott", "n_surf", "alive", "alive_save", "death_code"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert replicate_env(envs["table"], one) == (envs["table"],)


def test_dryrun_multichip_on_two_cpu_devices():
    out = dryrun_multichip(2, device="cpu")
    assert out["mesh"] == ["cpu", "cpu"] and out["fan_rays"] == 8 and out["realizations"] == 2
    assert out["fan_launches"] == out["ensemble_segment_launches"] == 0  # plain versions


def test_threaded_dispatch_of_two_shards(envs):
    """Two shards in worker threads: the sequential run's results, each
    shard's launches counted on its own thread, and a worker's exception
    re-raised in the caller once both shards have ended."""
    two = make_mesh(devices=["cpu"] * 2)
    t = PARAMS["trace"]
    s = tp.settings_for(dx=t["dx"], interp="table")
    p0 = shard_rays(trace_p0(), two)

    def shard(p, i):
        stepper._count("LAUNCHES", 0)
        stepper._count("TANGENT_LAUNCHES", i + 1)
        return tp.trace(envs["table"], 1300.0, p, 0.0, t["x1"], t["num_save"], s)

    n0 = stepper.TANGENT_LAUNCHES
    seq = run_shards(two, shard, p0.chunks, [0, 1], threads=False)
    par = run_shards(two, shard, p0.chunks, [0, 1], threads=True)
    for a, b in zip(par, seq):
        assert torch.equal(a.ts, b.ts) and torch.equal(a.n_bott, b.n_bott)
    assert two.launches == [{"TANGENT_LAUNCHES": 1}, {"TANGENT_LAUNCHES": 2}]
    assert stepper.TANGENT_LAUNCHES == n0 + 6
    ended = []

    def fail(i):
        if i == 0:
            raise RuntimeError("shard 0 failed")
        ended.append(i)

    with pytest.raises(RuntimeError, match="shard 0 failed"):
        run_shards(two, fail, [0, 1], threads=True)
    assert ended == [1]
    stepper.TANGENT_LAUNCHES -= 6


@pytest.mark.parametrize("name", ["make_mesh", "pad_to_multiple", "shard_rays",
                                  "replicate_env"])
def test_parallel_signatures_match_jax(name):
    ref = inspect.signature(getattr(jsh, name)).parameters
    got = inspect.signature(getattr(tsh, name)).parameters
    assert [(k, p.kind, p.default) for k, p in got.items()] == [
        (k, p.kind, p.default) for k, p in ref.items()]
    assert tsh.RAY_AXIS == jsh.RAY_AXIS


def test_counters_and_setup_cache_under_threads(envs):
    """Sixteen threads, with the interpreter switching threads every
    microsecond, add to the launch counters and hit the launch set-up cache
    (``stepper._SETUP_CACHE``, an ``LRUCache`` of 64 entries, here past its
    size): every increment is counted, on the shared counter and on each
    thread's own."""
    env = envs["kernel"]
    s = tp.SolverSettings(dx=1000.0)
    geoms = [(0.0, 1e3 * (i + 1), 1000.0, 1, i + 1) for i in range(80)]
    n_threads, n_iter = 16, 300
    n0, seg0 = stepper.LAUNCHES, stepper.SEG_LAUNCHES
    own, errors = [None] * n_threads, []
    start = threading.Barrier(n_threads)

    def work(k):
        try:
            start.wait()
            for i in range(n_iter):
                stepper._count("LAUNCHES")
                stepper._count("SEG_LAUNCHES", 2)
                geom = geoms[(i + 7 * k) % len(geoms)]
                _, xoob = stepper._launch_setup(env, s, geom)
                assert xoob.shape[0] == geom[4]
            own[k] = stepper.thread_launches()
        except Exception as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert stepper.LAUNCHES - n0 == n_threads * n_iter
    assert stepper.SEG_LAUNCHES - seg0 == 2 * n_threads * n_iter
    assert own == [{"LAUNCHES": n_iter, "SEG_LAUNCHES": 2 * n_iter}] * n_threads
    assert len(stepper._SETUP_CACHE) == stepper._SETUP_CACHE.maxsize
    stepper.LAUNCHES, stepper.SEG_LAUNCHES = n0, seg0
