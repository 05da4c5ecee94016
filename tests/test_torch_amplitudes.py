"""Arrival amplitudes in the port (``pygenray_tpu_torch.amplitudes``).

* The JAX package's own cases (``tests/test_amplitudes.py``) on the port
  with ``device="cpu"``, at shorter ranges and coarser steps (the plain Dual
  loop runs a few ms a step on a CPU): spherical spreading ``A = 1/s``
  within 1e-3, the spreading Jacobian against central differences within
  2e-3, a surface bounce's phase, caustics counted, dead rays NaN.
* The port's ``Arrivals`` against the JAX package's on one shared small fan
  in float32 (same numpy tables through ``env_from_reference``): KMAH,
  counters, death codes and NaN masks equal; amplitudes within 1e-3
  relative and TL within 1e-2 dB (both trace without Kahan in float32, in
  different operation orders; measured 2e-5), travel times within 1e-4 s,
  arrival depths within 0.05 m, arrival angles within 0.01 degrees.
* The ``Arrivals`` container, the argument check, the default device.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu_torch.envdata import DATA_FIELDS, META_FIELDS
from pygenray_tpu_torch.ops import stepper
from torch_fixtures import one_blas_thread  # noqa: F401

F64 = torch.float64


def const_env(c0=1500.0, depth=20000.0):
    z = np.linspace(0.0, depth, 64)
    r = np.linspace(0.0, 300e3, 8)
    return tp.make_env_data(np.full((r.size, z.size), c0), r, z, np.full(r.size, depth), r,
                            dtype=F64, device="cpu")


def munk_env(depth=5000.0):
    z = np.linspace(0.0, depth, 512)
    r = np.linspace(0.0, 150e3, 8)
    c = np.broadcast_to(tp.munk_ssp(z), (r.size, z.size)).copy()
    return tp.make_env_data(c, r, z, np.full(r.size, depth), r, dtype=F64, device="cpu")


def test_isovelocity_spherical_spreading():
    env = const_env()
    angles = np.array([-10.0, -5.0, -1.0, 2.0, 8.0])
    R = 20e3
    n0 = stepper.TANGENT_SAVE_LAUNCHES
    arr = tp.arrival_amplitudes(10000.0, 0.0, angles, R, env, num_save=17, dx=1250.0)
    assert stepper.TANGENT_SAVE_LAUNCHES == n0  # CPU tensors: no launch
    s = R / np.cos(np.radians(angles))  # slant range of the straight ray
    assert np.all(arr.alive)
    np.testing.assert_allclose(arr.amplitude, 1.0 / s, rtol=1e-3)
    np.testing.assert_allclose(arr.tl_db, 20 * np.log10(s), rtol=1e-3)
    assert np.all(arr.kmah == 0) and np.all(arr.n_surf == 0)
    np.testing.assert_allclose(arr.phase, 0.0)
    np.testing.assert_allclose(arr.theta_r, np.abs(angles), atol=1e-3)
    np.testing.assert_allclose(arr.path_length, s, rtol=1e-6)


def test_ad_spreading_matches_finite_differences():
    env = munk_env()
    angles = np.array([-8.0, -4.0, 0.5, 3.0, 7.0])
    R, z0, kw = 30e3, 1300.0, dict(dx=500.0, device="cpu")
    arr = tp.arrival_amplitudes(z0, 0.0, angles, R, env, num_save=31, **kw)
    assert np.all(arr.alive) and np.all(arr.n_surf == 0) and np.all(arr.n_bott == 0)
    # invert the amplitude formula back to |dz_r/dtheta0|
    c0 = float(tp.munk_ssp(np.asarray([z0]))[0])
    cr = tp.bilinear_np(np.full_like(arr.z_r, R), -arr.z_r, env.r.numpy(), env.z.numpy(),
                        env.c.numpy())
    jac_ad = (cr * np.cos(np.radians(angles))) / (
        c0 * R * np.cos(np.radians(arr.theta_r)) * arr.amplitude ** 2)
    # same num_save and dx: the two discrete maps must be the same one
    d = 1e-4
    zp = tp.shoot_rays(z0, 0.0, angles + d, R, 31, env, **kw).zs[:, -1]
    zm = tp.shoot_rays(z0, 0.0, angles - d, R, 31, env, **kw).zs[:, -1]
    np.testing.assert_allclose(jac_ad, np.abs(zp - zm) / (2 * np.radians(d)), rtol=2e-3)


def test_surface_bounce_phase():
    env = const_env(depth=30000.0)
    # up-going steep ray from a shallow source: one surface bounce, then
    # straight to the receiver (image-source geometry, no caustic)
    arr = tp.arrival_amplitudes(100.0, 0.0, np.array([20.0]), 10e3, env, num_save=33,
                                dx=400.0)
    assert int(arr.n_surf[0]) == 1 and int(arr.kmah[0]) == 0
    np.testing.assert_allclose(arr.phase, np.pi)
    np.testing.assert_allclose(arr.amplitude, np.cos(np.radians(20.0)) / 10e3, rtol=1e-3)


def test_munk_caustics_counted_and_dead_rays_nan():
    env = munk_env()
    angles = np.concatenate([np.linspace(-6.0, 6.0, 13), [89.99]])
    arr = tp.arrival_amplitudes(1300.0, 0.0, angles, 60e3, env, num_save=121, dx=500.0)
    ok = arr.alive
    assert ok[:-1].all() and not ok[-1]  # the near-vertical ray dies (code 1)
    assert int(arr.death_code[-1]) == 1
    assert np.isnan(arr.amplitude[-1]) and np.isnan(arr.tl_db[-1])
    # SOFAR refocusing: the axial fan has passed caustics by 60 km
    assert np.any(arr.kmah[ok] >= 1)
    amps = arr.amplitude[ok]
    assert np.all(np.isfinite(amps)) and np.all(amps > 0)
    np.testing.assert_allclose(np.abs(arr.pressure()[ok]), amps)


# ---- against the JAX package on one shared small fan -----------------------

# the fan, plan and tables of test_torch_tlfield.py's shared case: in one
# process the JAX package compiles its tangent trace once for both files
R_SHARED, ANGLES = 30e3, np.linspace(-20.0, 20.0, 141)
EXACT = ("kmah", "n_surf", "n_bott", "alive", "death_code", "phase", "theta0")
CLOSE = {"amplitude": (1e-3, 0.0), "tl_db": (0.0, 1e-2), "travel_time": (0.0, 1e-4),
         "z_r": (0.0, 0.05), "theta_r": (0.0, 1e-2), "path_length": (1e-6, 0.0)}


@pytest.fixture(scope="module")
def shared():
    z = np.linspace(0.0, 6000.0, 1024)
    r = np.linspace(0.0, R_SHARED, 6)
    je = jp.make_env_data(np.outer(np.ones(6), jp.munk_ssp(z)), r, z, np.full(6, 4600.0), r,
                          dtype=jnp.float32)
    te = tp.env_from_reference({f: np.asarray(getattr(je, f)) for f in DATA_FIELDS},
                               {m: getattr(je, m) for m in META_FIELDS}, device="cpu",
                               dtype=torch.float32)
    kw = dict(num_save=31, dx=500.0, flatearth=False)
    return (jp.arrival_amplitudes(1300.0, 0.0, ANGLES, R_SHARED, je, **kw),
            tp.arrival_amplitudes(1300.0, 0.0, ANGLES, R_SHARED, te, **kw))


@pytest.mark.parametrize("field", EXACT + tuple(CLOSE))
def test_arrivals_match_jax(field, shared):
    ja, ta = (np.asarray(getattr(a, field)) for a in shared)
    assert ja.shape == ta.shape == ANGLES.shape
    if field in EXACT:
        np.testing.assert_array_equal(ta, ja)
        return
    rtol, atol = CLOSE[field]
    np.testing.assert_array_equal(np.isnan(ta), np.isnan(ja))
    np.testing.assert_allclose(ta, ja, rtol=rtol, atol=atol)


def test_shared_fan_has_bounces_and_caustics(shared):
    ta = shared[1]
    assert ta.alive.all() and ta.n_bott.max() >= 1 and ta.n_surf.max() >= 1
    assert ta.kmah.max() >= 1 and isinstance(ta.amplitude, np.ndarray)


# ---- the container, the checks, the device ---------------------------------


def test_arrivals_container(tmp_path):
    a = shared_like()
    assert len(a) == 4 and len(a[1:3]) == 2 and len(a[2]) == 1
    np.testing.assert_array_equal(a[np.array([True, False, False, True])].theta0, [0.0, 3.0])
    np.testing.assert_allclose(a.pressure(), a.amplitude * np.exp(1j * a.phase))
    a.save_npz(tmp_path / "a.npz")
    back = tp.Arrivals.load_npz(tmp_path / "a.npz")
    for f in dataclasses.fields(tp.Arrivals):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(a, f.name))
    from scipy import io

    a.save_mat(tmp_path / "a.mat")
    mat = io.loadmat(tmp_path / "a.mat", squeeze_me=True, struct_as_record=False)["arrivals"]
    np.testing.assert_array_equal(mat.travel_time, a.travel_time)
    # an archive written before path_length existed still loads
    legacy = dataclasses.replace(a, path_length=None)
    legacy.save_npz(tmp_path / "l.npz")
    assert tp.Arrivals.load_npz(tmp_path / "l.npz").path_length is None
    assert legacy[0].path_length is None


def shared_like():
    f = lambda *v: np.asarray(v, float)
    return tp.Arrivals(
        theta0=f(0.0, 1.0, 2.0, 3.0), amplitude=f(1e-4, 2e-4, np.nan, 3e-4),
        tl_db=f(80.0, 74.0, np.nan, 70.5), phase=f(0.0, np.pi, 0.0, -np.pi / 2),
        kmah=np.array([0, 0, 0, 1]), travel_time=f(20.0, 20.1, 20.2, 20.3),
        z_r=f(-1000.0, -1100.0, -1200.0, -1300.0), theta_r=f(1.0, 2.0, 3.0, 4.0),
        n_surf=np.array([0, 1, 0, 0]), n_bott=np.array([0, 0, 0, 0]),
        alive=np.array([True, True, False, True]), death_code=np.array([0, 0, 1, 0]),
        path_length=f(30e3, 30.1e3, 30.2e3, 30.3e3))


def test_arguments_and_default_device():
    env = const_env()
    with pytest.raises(ValueError, match="receiver_range"):
        tp.arrival_amplitudes(100.0, 5e3, [1.0], 1e3, env)
    # without device= an environment object is built on the CUDA device:
    # with no card torch raises, and no CPU result comes back
    from pygenray_tpu_torch.models import munk_env as munk_environment

    ocean = munk_environment(r_max=10e3, nr=4, nz=200)
    call = lambda: tp.arrival_amplitudes(1300.0, 0.0, [1.0, 2.0], 5e3, ocean, num_save=3,
                                         dx=1000.0, flatearth=False)
    if torch.cuda.is_available():
        assert len(call()) == 2
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
