"""Parity of the port's ops and host helpers with the JAX package.

Inputs are made with numpy from a fixed seed and go through both packages:
the torch evaluators (``clenshaw``, ``horner``, the interpolators) match the
JAX ones within 1e-12 in float64; the numpy modules the port copies
(``ops/host.py``, the fitting halves of ``ops/cheb.py`` and ``ops/seg.py``,
``utils/xrlite.py``) give identical results.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pygenray_tpu.ops.cheb as jcheb
import pygenray_tpu.ops.host as jhost
import pygenray_tpu.ops.interp as jinterp
import pygenray_tpu.ops.seg as jseg
import pygenray_tpu.utils.xrlite as jxr
import pygenray_tpu_torch.ops.cheb as tcheb
import pygenray_tpu_torch.ops.host as thost
import pygenray_tpu_torch.ops.interp as tinterp
import pygenray_tpu_torch.ops.seg as tseg
import pygenray_tpu_torch.utils.xrlite as txr
from pygenray_tpu_torch.utils.cache import LRUCache, env_struct_key

TOL = 1e-12
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(a_jax, b_torch, tol=TOL):
    np.testing.assert_allclose(np.asarray(a_jax), b_torch.numpy(), rtol=0, atol=tol)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


# ---------------------------------------------------------------------------
# series evaluators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 16, 48])
@pytest.mark.parametrize("fn", ["clenshaw", "horner"])
def test_series_evaluators_match(rng, K, fn):
    u = rng.uniform(-1, 1, 257)
    coef = rng.normal(size=K)
    _close(getattr(jcheb, fn)(jnp.asarray(u), jnp.asarray(coef)),
           getattr(tcheb, fn)(_t(u), _t(coef)))
    # batched coefficients: (..., K) broadcasting against u
    coefb = rng.normal(size=(257, K))
    _close(getattr(jcheb, fn)(jnp.asarray(u), jnp.asarray(coefb)),
           getattr(tcheb, fn)(_t(u), _t(coefb)))


def test_cheb_fitting_half_is_identical(rng):
    z = np.linspace(0.0, 5000.0, 301)
    c = 1500.0 + 0.02 * np.outer(rng.uniform(0.5, 1.5, 3), z) + rng.normal(0, 0.01, (3, 301))
    for order in (7, 23):
        cj, rj = jcheb.fit_profile_cheb(c, z, order=order)
        ct, rt = tcheb.fit_profile_cheb(c, z, order=order)
        np.testing.assert_array_equal(cj, ct)
        assert rj == rt
    x = np.linspace(0.0, 1e5, 400)
    y = np.sin(x / 2e4)
    for a, b in zip(jcheb.fit_series_cheb(x, y, 40), tcheb.fit_series_cheb(x, y, 40)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jcheb.cheb2poly_matrix(12), tcheb.cheb2poly_matrix(12))
    coef = rng.normal(size=(2, 16)) * 0.1 ** np.arange(16)
    assert jcheb.poly_ok(coef, 1e-3) == tcheb.poly_ok(coef, 1e-3)
    assert jcheb.poly_ok(rng.normal(size=(1, 64)), 1e-3) == tcheb.poly_ok(
        rng.normal(size=(1, 64)), 1e-3)
    np.testing.assert_array_equal(jcheb.cheb_mirror(coef), tcheb.cheb_mirror(coef))
    np.testing.assert_array_equal(jcheb.cheb_mirror(coef), tcheb.cheb_mirror(_t(coef)).numpy())


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uniform", [True, False])
def test_interval_index_and_linear_match(rng, uniform):
    g = np.linspace(-50.0, 950.0, 41) if uniform else np.cumsum(rng.uniform(1, 50, 41))
    x = rng.uniform(g[0] - 100, g[-1] + 100, 500)
    x[:3] = g[[0, 7, -1]]  # exact knots
    y = rng.normal(size=41)
    np.testing.assert_array_equal(
        np.asarray(jinterp.interval_index(jnp.asarray(x), jnp.asarray(g), uniform)),
        tinterp.interval_index(_t(x), _t(g), uniform).numpy(),
    )
    _close(jinterp.linear_interp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(y), uniform),
           tinterp.linear_interp(_t(x), _t(g), _t(y), uniform))
    # 0-d query (station lookups)
    _close(jinterp.linear_interp(jnp.asarray(x[5]), jnp.asarray(g), jnp.asarray(y), uniform),
           tinterp.linear_interp(_t(x[5]), _t(g), _t(y), uniform))


def test_bilinear_matches(rng):
    xg = np.linspace(0.0, 1e5, 11)
    yg = np.sort(rng.uniform(0, 5000, 30))
    v = rng.normal(size=(11, 30))
    x = rng.uniform(-1e4, 1.1e5, 300)
    y = rng.uniform(-100, 5100, 300)
    for ux in (True, False):
        _close(jinterp.bilinear_interp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xg),
                                       jnp.asarray(yg), jnp.asarray(v), ux, False),
               tinterp.bilinear_interp(_t(x), _t(y), _t(xg), _t(yg), _t(v), ux, False))
    np.testing.assert_array_equal(jhost.bilinear_np(x, y, xg, yg, v),
                                  thost.bilinear_np(x, y, xg, yg, v))


@pytest.mark.parametrize("n", [2, 3, 9])
def test_cubic_spline_matches(rng, n):
    knots = np.sort(rng.uniform(0, 1e5, n))
    vals = rng.normal(size=n)
    cj = jinterp.cubic_spline_coeffs(knots, vals)
    ct = tinterp.cubic_spline_coeffs(knots, vals)
    np.testing.assert_array_equal(cj, ct)
    t = rng.uniform(knots[0] - 1e3, knots[-1] + 1e3, 200)
    _close(jinterp.cubic_spline_eval(jnp.asarray(t), jnp.asarray(knots), jnp.asarray(cj)),
           tinterp.cubic_spline_eval(_t(t), _t(knots), _t(ct)), tol=1e-9)


# ---------------------------------------------------------------------------
# copied host modules
# ---------------------------------------------------------------------------


def test_host_kernels_identical(rng):
    rin = np.linspace(0, 1e5, 6)
    zin = np.linspace(0, 5000, 50)
    cin = 1500 + rng.normal(0, 5, (6, 50))
    cpin = np.gradient(cin, zin, axis=1)
    depths = np.full(6, 4500.0)
    x = 3.3e4
    for y in (np.array([0.0, 1200.0, 4e-4]), np.array([0.0, -3.0, -6e-4]),
              np.array([0.0, 4700.0, 6.6e-4])):
        np.testing.assert_array_equal(jhost.derivs_np(x, y, cin, cpin, rin, zin),
                                      thost.derivs_np(x, y, cin, cpin, rin, zin))
        assert jhost.ray_angle_np(x, y, cin, rin, zin) == thost.ray_angle_np(x, y, cin, rin, zin)
        for ev in ("surface_bounce", "bottom_bounce", "vertical_ray", "ray_bounding_box_event"):
            args = (x, y, cin, cpin, rin, zin, depths, rin)
            assert getattr(jhost, ev)(*args) == getattr(thost, ev)(*args)
    xq = rng.uniform(-1e4, 1.1e5, 50)
    np.testing.assert_array_equal(jhost.linear_np(xq, rin, depths + rin * 1e-3),
                                  thost.linear_np(xq, rin, depths + rin * 1e-3))


def test_seg_module_identical(rng):
    z = np.linspace(0.0, 4000.0, 201)
    c = 1500.0 + 0.015 * z + 0.5 * np.sin(z / 150.0)
    c = np.stack([c, c + 0.1])
    for basis in ("pow", "cheb"):
        fj = jseg.fit_profile_seg(c, z, order=7, basis=basis)
        ft = tseg.fit_profile_seg(c, z, order=7, basis=basis)
        np.testing.assert_array_equal(fj[0], ft[0])
        assert fj[1:] == ft[1:]
        np.testing.assert_array_equal(jseg.seg_derivative(fj[0], 0.0, 4000.0, basis),
                                      tseg.seg_derivative(ft[0], 0.0, 4000.0, basis))
        zq = rng.uniform(-10, 4010, 100)
        np.testing.assert_array_equal(jseg.seg_eval_np(fj[0], zq, 0.0, 4000.0, basis=basis),
                                      tseg.seg_eval_np(ft[0], zq, 0.0, 4000.0, basis=basis))
    assert jseg.SEG_S == tseg.SEG_S


def test_xrlite_identical(rng):
    v = rng.normal(size=(4, 30))
    coords = {"range": np.linspace(0, 1e4, 4), "depth": np.cumsum(rng.uniform(1, 9, 30))}
    a = jxr.LiteDataArray(v, dims=["range", "depth"], coords=coords)
    b = txr.LiteDataArray(v, dims=["range", "depth"], coords=coords)
    np.testing.assert_array_equal(a.differentiate("depth").values,
                                  b.differentiate("depth").values)
    np.testing.assert_array_equal(a.isel(range=2).values, b.isel(range=2).values)
    assert a.dims == b.dims and a.shape == b.shape


# ---------------------------------------------------------------------------
# cache helpers
# ---------------------------------------------------------------------------


def test_lru_cache_evicts_least_recent():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # refreshes "a"
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert len(c) == 2


def test_env_struct_key_tracks_structure_not_values():
    from pygenray_tpu_torch.models import munk_env

    env = munk_env(r_max=20e3, nr=4, nz=128).env_data(flatearth=False, dtype=torch.float64, device="cpu")
    same_shape = dataclasses.replace(env, c=env.c + 1.0)
    assert env_struct_key(env) == env_struct_key(same_shape)
    assert env_struct_key(env) != env_struct_key(env.to(dtype=torch.float32))
    assert env_struct_key(env) != env_struct_key(dataclasses.replace(env, poly_ok=not env.poly_ok))
    hash(env_struct_key(env))
