"""The port's user API (``shoot_rays``/``shoot_ray``) end to end on CPU.

* Golden fixtures at the JAX tests' own tolerances
  (``tests/test_physics.py::TestMunkRegression``): the reference package's
  ``munk_regression.npz`` within 2.3e-6 s and the rtol=1e-12 scipy oracle
  ``munk_tight_oracle.npz`` within 5e-7 s.
* The same calls through both packages in float64: forward and backwards
  (mirrored) shots, ``keep_dropped``/``nan_dropped``, per-ray source
  depths, a single ray; every ``RayFan``/``Ray`` field equal (travel times
  within 1e-9 s).
* The port never imports jax.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.models import munk_env as j_munk_env
from pygenray_tpu.utils.xrlite import DataArray as JDA
from pygenray_tpu_torch.models import munk_env as t_munk_env
from pygenray_tpu_torch.utils.xrlite import DataArray as TDA

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
ANGLES = [-8.0, -4.0, 0.0, 4.0, 8.0]
TABLE = dict(interp="table", dtype="float64")


@pytest.fixture(scope="module")
def golden_fan():
    env = t_munk_env(r_max=50e3, nr=30, nz=400)
    return tp.shoot_rays(1300.0, 0.0, [-a for a in ANGLES], 50e3, 50, env,
                         rtol=1e-9, flatearth=False, device="cpu", **TABLE)


def test_regression_vs_reference_fixture(golden_fan):
    ref = np.load(FIXTURES / "munk_regression.npz")
    np.testing.assert_allclose(golden_fan.ts, ref["ts"], atol=2.3e-6)
    np.testing.assert_allclose(golden_fan.zs, ref["zs"], atol=0.1)
    np.testing.assert_allclose(golden_fan.ps, ref["ps"], atol=0.1)
    np.testing.assert_array_equal(golden_fan.n_botts, ref["n_botts"])
    np.testing.assert_array_equal(golden_fan.n_surfs, ref["n_surfs"])


def test_regression_vs_tight_oracle(golden_fan):
    ref = np.load(FIXTURES / "munk_tight_oracle.npz")
    np.testing.assert_allclose(golden_fan.ts, ref["ts"], atol=5e-7)
    np.testing.assert_allclose(golden_fan.zs, ref["zs"], atol=0.01)


def _sloped_envs():
    """A range-independent Munk field over a curved bottom (Chebyshev bottom
    angle), as an OceanEnvironment2D of each package."""
    z = np.linspace(0.0, 6000.0, 512)
    r = np.linspace(0.0, 30e3, 6)
    c = np.outer(np.ones(6), jp.munk_ssp(z))
    bathy = 4300.0 + 400.0 * np.sin(r / 9e3)

    def build(pkg, DA):
        ss = DA(c, dims=["range", "depth"], coords={"range": r, "depth": z})
        bb = DA(bathy, dims=["range"], coords={"range": r})
        return pkg.OceanEnvironment2D(sound_speed=ss, bathymetry=bb, flat_earth_transform=False)

    return build(jp, JDA), build(tp, TDA)


FAN_FIELDS = ("thetas", "rs", "n_botts", "n_surfs", "source_depths", "alive", "death_code")


def assert_fans_equal(jf, tf):
    for f in FAN_FIELDS:
        np.testing.assert_array_equal(getattr(jf, f), getattr(tf, f), err_msg=f)
    # rays that reached the receiver: absolute bounds; the frozen state of a
    # dropped ray kept with nan_dropped=False agrees relatively (its last
    # step is near-singular)
    live = tf.alive
    for f, tol in (("ts", 1e-9), ("zs", 1e-6), ("ps", 1e-15)):
        a, b = getattr(jf, f), getattr(tf, f)
        np.testing.assert_allclose(a[live], b[live], rtol=0, atol=tol, err_msg=f)
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=tol, equal_nan=True, err_msg=f)


@pytest.mark.parametrize("backwards", [False, True])
def test_shoot_rays_matches_jax(backwards):
    je, te = _sloped_envs()
    src, rcv = (25e3, 2e3) if backwards else (0.0, 22e3)
    angles = np.linspace(-20, 20, 40)
    kw = dict(flatearth=False, dx=250.0, dtype="float64")
    jf = jp.shoot_rays(1300.0, src, angles, rcv, 6, je, **kw)
    tf = tp.shoot_rays(1300.0, src, angles, rcv, 6, te, device="cpu", **kw)
    assert_fans_equal(jf, tf)
    assert tf.n_botts.sum() > 0 and tf.ts.shape == (40, 6)
    if backwards:
        assert tf.rs[0, 0] == 25e3 and tf.rs[0, -1] == 2e3


@pytest.mark.parametrize("nan_dropped", [True, False])
def test_keep_dropped_matches_jax(nan_dropped):
    jenv = j_munk_env(r_max=30e3, nr=4, nz=256)
    tenv = t_munk_env(r_max=30e3, nr=4, nz=256)
    angles = [-90.0, -60.0, -10.0, 0.0, 10.0, 89.999]
    kw = dict(flatearth=False, dx=300.0, dtype="float64", keep_dropped=True,
              nan_dropped=nan_dropped)
    jf = jp.shoot_rays(1000.0, 0.0, angles, 20e3, 5, jenv, **kw)
    tf = tp.shoot_rays(1000.0, 0.0, angles, 20e3, 5, tenv, device="cpu", **kw)
    assert_fans_equal(jf, tf)
    assert not tf.alive.all() and tf.alive.any()
    assert np.isnan(tf.ts).any() == nan_dropped
    # default: dropped rays leave the fan
    dropped = tp.shoot_rays(1000.0, 0.0, angles, 20e3, 5, tenv, flatearth=False, dx=300.0,
                            dtype="float64", device="cpu")
    assert len(dropped.ts) == int(tf.alive.sum())


def test_per_ray_source_depths_and_single_ray_match_jax(capsys):
    jenv = j_munk_env(r_max=30e3, nr=4, nz=256)
    tenv = t_munk_env(r_max=30e3, nr=4, nz=256)
    depths = np.array([500.0, 700.0, 900.0, 1100.0, 1700.0, 2500.0, 1300.0])
    angles = np.array([-10.0, -5.0, 6.0, 0.0, 5.0, 10.0, -90.0])
    kw = dict(flatearth=False, dx=300.0, dtype="float64", keep_dropped=True)
    jf = jp.shoot_rays(depths, 0.0, angles, 15e3, 4, jenv, debug=True, **kw)
    j_err = capsys.readouterr().err
    tf = tp.shoot_rays(depths, 0.0, angles, 15e3, 4, tenv, debug=True, device="cpu", **kw)
    t_err = capsys.readouterr().err
    assert_fans_equal(jf, tf)
    assert t_err == j_err and "terminated:" in t_err
    # shoot_ray is the same trace for one ray (ODE convention, negated angle)
    ray = tp.shoot_ray(900.0, 0.0, 6.0, 15e3, 4, tenv, flatearth=False, dx=300.0,
                       dtype="float64", device="cpu")
    np.testing.assert_array_equal(ray.r, tf.rs[2])
    np.testing.assert_allclose(ray.t, jf.ts[2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(ray.z, jf.zs[2], rtol=0, atol=1e-6)
    assert (ray.n_bottom, ray.n_surface, ray.launch_angle) == (
        jf.n_botts[2], jf.n_surfs[2], -6.0)
    assert tp.shoot_ray(1300.0, 0.0, -90.0, 15e3, 4, tenv, flatearth=False, dx=300.0,
                        dtype="float64", device="cpu") is None


def test_rayfan_npz_round_trip(tmp_path, golden_fan):
    path = tmp_path / "fan.npz"
    golden_fan.save_npz(path)
    back = tp.RayFan.load_npz(path)
    np.testing.assert_array_equal(back.ts, golden_fan.ts)
    np.testing.assert_array_equal(back.n_botts, golden_fan.n_botts)


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|pygenray_tpu)(\.|\s|$)", re.M)


def test_port_never_imports_jax():
    src = ROOT / "pygenray_tpu_torch"
    # the package's sources; _build/ holds build outputs, not package code
    offenders = [str(p.relative_to(ROOT)) for p in src.rglob("*.py")
                 if "_build" not in p.relative_to(src).parts
                 and _JAX_IMPORT.search(p.read_text())]
    assert offenders == []
    code = "import sys, pygenray_tpu_torch; assert 'jax' not in sys.modules, 'jax imported'"
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
