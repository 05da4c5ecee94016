"""The port's eigenray search (``find_eigenrays``, ``find_eigenrays_batch``)
and its root-finding update, on CPU, against the JAX package.

* ``rootfind_update``: numpy and torch bit for bit; the JAX package's
  ``jnp`` call within 1 float64 ulp (XLA may contract a product and a sum).
* ``find_eigenrays`` through both packages on the same numpy tables and
  fans: eigenray counts equal; in float64 launch angles within 1e-9° and
  final travel times within 1e-9 s (both run the same arithmetic; observed
  ~1e-13), in float32 within 5e-3° and 1e-5 s
  (``tests/test_eigenray_newton.py``'s bounds); Newton and regula falsi, a
  backwards shot, no brackets, table interpolation (the ``torch.func.jvp``
  path); diagnostics with the same keys and dtypes.
* The verbose host loop against the loop on the environment's device, and
  ``find_eigenrays_batch`` against one call per configuration.
* Without ``device=``, the entry points build on the CUDA device: on a box
  without a card they raise.

The kernels behind the solver on a card run in ``chip_smoke.py``.
"""

import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.rootfind import rootfind_update as j_rootfind_update
from pygenray_tpu_torch.rootfind import rootfind_update

R = 30e3
DX = 1000.0
ANGLES = np.linspace(-14.0, 14.0, 40)
RDS = [1300.0, 2500.0]
NUM_SAVE = 5
ZTOL = 1e-2
TOL = {"float64": (1e-9, 1e-9), "float32": (5e-3, 1e-5)}  # (degrees, seconds)


def _tables():
    z = np.linspace(0.0, 6000.0, 512)
    r = np.linspace(0.0, R, 6)
    return np.outer(np.ones(6), jp.munk_ssp(z)), r, z, np.full(6, 4600.0), r


@pytest.fixture(scope="module")
def envs():
    """Per dtype: the JAX package's and the port's environment from the
    same numpy tables, and the port's fan (host arrays, which both
    packages' ``find_eigenrays`` read alike: the fans agree, see
    ``test_torch_shoot.py``)."""
    out = {}
    for dtype in ("float64", "float32"):
        je = jp.make_env_data(*_tables(), dtype=jnp.dtype(dtype))
        te = tp.make_env_data(*_tables(), dtype=getattr(torch, dtype), device="cpu")
        fan = tp.shoot_rays(1300.0, 0.0, ANGLES, R, 2, te, flatearth=False, dx=DX)
        out[dtype] = (je, te, fan, fan)
    return out


def _solve(pkg, fan, env, method, **kw):
    return pkg.find_eigenrays(fan, RDS, 1300.0, 0.0, R, NUM_SAVE, env, ztol=ZTOL,
                              flatearth=False, dx=DX, method=method, **kw)


@pytest.fixture(scope="module")
def solved(envs):
    """(JAX, port) EigenRays per (dtype, method), computed once."""
    cache = {}

    def get(dtype, method):
        if (dtype, method) not in cache:
            je, te, jf, tf = envs[dtype]
            cache[dtype, method] = (_solve(jp, jf, je, method), _solve(tp, tf, te, method))
        return cache[dtype, method]

    return get


def assert_eigenrays_match(ej, et, n_depths, ang_tol, t_tol):
    for i in range(n_depths):
        assert et.num_eigenrays_found[i] == ej.num_eigenrays_found[i]
        if not ej.num_eigenrays_found[i]:
            continue
        oj, ot = np.argsort(ej.launch_angles[i]), np.argsort(et.launch_angles[i])
        np.testing.assert_allclose(et.launch_angles[i][ot], ej.launch_angles[i][oj],
                                   rtol=0, atol=ang_tol)
        np.testing.assert_allclose(et.ts[i][ot], ej.ts[i][oj], rtol=0, atol=t_tol)
        np.testing.assert_array_equal(et.n_botts[i][ot], ej.n_botts[i][oj])
        np.testing.assert_array_equal(et.n_surfs[i][ot], ej.n_surfs[i][oj])
    assert et.num_eigenrays == ej.num_eigenrays


@pytest.mark.parametrize("method", [True, False], ids=["newton", "regula_falsi"])
def test_rootfind_update_numpy_torch_jax(method):
    rng = np.random.default_rng(0)
    n = 300
    args = [rng.normal(size=n) for _ in range(5)]  # theta, th1, th2, z1, z2
    conv, dead = rng.random(n) < 0.2, rng.random(n) < 0.1
    th_hit = np.where(rng.random(n) < 0.5, np.nan, rng.normal(size=n))
    z_end, alive = rng.normal(size=n), rng.random(n) < 0.9
    dz = rng.normal(size=n)
    dz[:5] = 0.0  # a zero derivative: Newton falls back to false position
    rd = rng.normal(size=n)
    state = (*args, conv, dead, th_hit, z_end, alive, dz, rd)
    a = rootfind_update(np, *state, 0.3, method)
    b = rootfind_update(torch, *map(torch.as_tensor, state), 0.3, method)
    c = j_rootfind_update(jnp, *map(jnp.asarray, state), 0.3, method)
    for x, y, w in zip(a, b, c):
        np.testing.assert_array_equal(x, y.numpy())
        x, w = np.asarray(x, float), np.asarray(w, float)
        np.testing.assert_allclose(x, w, rtol=2.3e-16, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["newton", "regula_falsi"])
def test_find_eigenrays_matches_jax(dtype, method, solved):
    ej, et = solved(dtype, method)
    assert sum(et.num_eigenrays_found.values()) >= 3
    assert_eigenrays_match(ej, et, len(RDS), *TOL[dtype])
    np.testing.assert_array_equal(et.diagnostics["converged"], ej.diagnostics["converged"])
    if dtype == "float64":
        np.testing.assert_array_equal(et.diagnostics["iterations"],
                                      ej.diagnostics["iterations"])
    # the solver's last shot of every converged candidate ends within ztol
    # of its receiver (the full-save ray, on another step plan, may end a
    # few centimetres further off)
    conv = et.diagnostics["converged"]
    assert conv.all() and np.all(et.diagnostics["depth_residual"] < ZTOL)


def test_newton_iterates_and_beats_regula_falsi(solved):
    newton, rf = solved("float64", "newton")[1], solved("float64", "regula_falsi")[1]
    n_it, r_it = newton.diagnostics["iterations"].max(), rf.diagnostics["iterations"].max()
    assert 2 <= n_it <= r_it


def test_diagnostics_keys_and_dtypes(solved):
    ej, et = solved("float64", "newton")
    assert et.diagnostics.keys() == ej.diagnostics.keys()
    for k, v in ej.diagnostics.items():
        assert et.diagnostics[k].dtype == np.asarray(v).dtype, k
        assert et.diagnostics[k].shape == np.asarray(v).shape, k


def test_verbose_matches_device_path(envs, solved):
    _, te, _, tf = envs["float64"]
    dev = solved("float64", "newton")[1]
    host = _solve(tp, tf, te, "newton", verbose=True)
    assert_eigenrays_match(dev, host, len(RDS), 1e-10, 1e-10)
    for k in ("iterations", "converged", "dropped", "rd_idx"):
        np.testing.assert_array_equal(host.diagnostics[k], dev.diagnostics[k])


def test_no_brackets(envs):
    je, te, jf, tf = envs["float64"]
    kw = dict(flatearth=False, dx=DX)
    ej = jp.find_eigenrays(jf, [5500.0], 1300.0, 0.0, R, NUM_SAVE, je, **kw)
    et = tp.find_eigenrays(tf, [5500.0], 1300.0, 0.0, R, NUM_SAVE, te, **kw)
    assert et.num_eigenrays == ej.num_eigenrays == {5500.0: 0}
    assert et.num_eigenrays_found == ej.num_eigenrays_found == {0: 0}
    for k, v in ej.diagnostics.items():
        assert et.diagnostics[k].dtype == v.dtype and et.diagnostics[k].size == 0


def test_backwards_shot_matches_jax(envs):
    """Receiver before the source: both packages mirror the environment."""
    je, te, _, _ = envs["float64"]
    kw = dict(flatearth=False, dx=DX, ztol=ZTOL, method="regula_falsi")
    tf = tp.shoot_rays(1300.0, R, ANGLES, 0.0, 2, te, flatearth=False, dx=DX)
    ej = jp.find_eigenrays(tf, [1300.0], 1300.0, R, 0.0, NUM_SAVE, je, **kw)
    et = tp.find_eigenrays(tf, [1300.0], 1300.0, R, 0.0, NUM_SAVE, te, **kw)
    assert et.num_eigenrays_found[0] >= 2
    assert_eigenrays_match(ej, et, 1, *TOL["float64"])
    assert et.rs[0][0, 0] == R and et.rs[0][0, -1] == 0.0


def test_table_interp_jvp_path_matches_jax():
    """Table profiles have no forward-tangent trace: Newton runs
    ``torch.func.jvp`` over the torch-op loop, as the JAX package runs
    ``jax.jvp`` over its scan."""
    kw = dict(flatearth=False, dx=3000.0)
    args = _tables()
    je = jp.make_env_data(*args, interp="table", dtype=jnp.float64)
    te = tp.make_env_data(*args, interp="table", device="cpu", dtype=torch.float64)
    assert not te.has_cheb
    angles = np.linspace(-12.0, 12.0, 8)
    tf = tp.shoot_rays(1300.0, 0.0, angles, R, 2, te, **kw)
    ej = jp.find_eigenrays(tf, [1300.0], 1300.0, 0.0, R, 2, je, ztol=ZTOL, **kw)
    et = tp.find_eigenrays(tf, [1300.0], 1300.0, 0.0, R, 2, te, ztol=ZTOL, **kw)
    assert et.num_eigenrays_found[0] >= 2
    assert_eigenrays_match(ej, et, 1, *TOL["float64"])


def test_batch_matches_per_config_calls(envs):
    _, te, _, _ = envs["float64"]
    sources = [1100.0, 1500.0]
    kw = dict(ztol=ZTOL, flatearth=False, dx=DX)
    batch = tp.find_eigenrays_batch(ANGLES, RDS, sources, 0.0, R, NUM_SAVE, te, **kw)
    for sd, eb in zip(sources, batch):
        # the batch shoots its fans with num_range_save saves: the same plan
        fan = tp.shoot_rays(sd, 0.0, ANGLES, R, NUM_SAVE, te, flatearth=False, dx=DX)
        single = tp.find_eigenrays(fan, RDS, sd, 0.0, R, NUM_SAVE, te, **kw)
        assert sum(single.num_eigenrays_found.values()) >= 2
        assert_eigenrays_match(single, eb, len(RDS), 1e-10, 1e-10)
        for k in ("iterations", "converged", "rd_idx"):
            np.testing.assert_array_equal(eb.diagnostics[k], single.diagnostics[k])


@pytest.mark.parametrize("fn", ["find_eigenrays", "find_eigenrays_batch"])
def test_mesh_is_not_ported_yet(fn, envs):
    _, te, _, tf = envs["float64"]
    first = tf if fn == "find_eigenrays" else ANGLES
    with pytest.raises(NotImplementedError, match="A11"):
        getattr(tp, fn)(first, RDS, 1300.0, 0.0, R, NUM_SAVE, te, mesh=object())


def _default_device_calls():
    """Each entry point called without ``device=`` on host inputs."""
    from pygenray_tpu_torch.envdata import DATA_FIELDS, META_FIELDS

    cpu_env = tp.make_env_data(*_tables(), device="cpu")
    fields = {f: getattr(cpu_env, f).numpy() for f in DATA_FIELDS}
    meta = {m: getattr(cpu_env, m) for m in META_FIELDS}
    fan = tp.shoot_rays(1300.0, 0.0, ANGLES, R, 2, cpu_env, flatearth=False, dx=DX)
    ocean = lambda: tp.OceanEnvironment2D()  # noqa: E731
    return {
        "shoot_rays": lambda: tp.shoot_rays(1300.0, 0.0, ANGLES, R, 2, ocean(), dx=DX),
        "shoot_ray": lambda: tp.shoot_ray(1300.0, 0.0, 5.0, R, 2, ocean(), dx=DX),
        "find_eigenrays": lambda: tp.find_eigenrays(fan, RDS, 1300.0, 0.0, R, 2, ocean(),
                                                    dx=DX),
        "find_eigenrays_batch": lambda: tp.find_eigenrays_batch(ANGLES, RDS, [1300.0], 0.0, R,
                                                                2, ocean(), dx=DX),
        "env_data": lambda: ocean().env_data(),
        "make_env_data": lambda: tp.make_env_data(*_tables()),
        "env_from_reference": lambda: tp.env_from_reference(fields, meta),
    }


@pytest.mark.parametrize("entry", ["shoot_rays", "shoot_ray", "find_eigenrays",
                                   "find_eigenrays_batch", "env_data", "make_env_data",
                                   "env_from_reference"])
def test_entry_points_default_to_cuda(entry):
    """Without ``device=`` an entry point builds on the CUDA device: with no
    card torch raises, and no CPU result comes back."""
    call = _default_device_calls()[entry]
    if torch.cuda.is_available():
        out = call()
        if entry in ("env_data", "make_env_data", "env_from_reference"):
            assert out.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


def test_jax_guard_covers_the_new_modules():
    """``test_torch_shoot.py::test_port_never_imports_jax`` scans every
    module of the package, these included."""
    pkg = pathlib.Path(tp.__file__).parent
    for mod in ("eigenrays.py", "rootfind.py", "ops/dual.py", "ops/stepper.py"):
        assert (pkg / mod).is_file(), mod
    assert all(name in tp.__all__ for name in ("find_eigenrays", "find_eigenrays_batch"))
