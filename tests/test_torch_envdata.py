"""Parity of the port's environment layer with the JAX package.

The same numpy tables (made from a fixed seed) go through
``pygenray_tpu.make_env_data`` and ``pygenray_tpu_torch.make_env_data`` in
float64: every tensor field must equal the JAX field exactly and every
piece of static metadata must be equal, for the five environment kinds the
engine distinguishes (Munk Horner, Munk Clenshaw, range-dependent, sloped
bottom with a Chebyshev bottom angle, table-only), plus the segment fit.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.envdata import mirror_env_data as jmirror, host_profile_tables as jhost
from pygenray_tpu_torch.envdata import (
    DATA_FIELDS,
    META_FIELDS,
    env_from_reference,
    host_profile_tables as thost,
    mirror_env_data as tmirror,
    resolve_dtype,
)
from torch_fixtures import one_blas_thread  # noqa: F401

F64 = torch.float64


def _tables(kind, seed=7):
    rng = np.random.default_rng(seed)
    nr = 8
    r = np.linspace(0.0, 100e3, nr)
    nz = {"munk_horner": 1024, "munk_clenshaw": 256}.get(kind, 400)
    z = np.linspace(0.0, 6000.0, nz)
    c = np.outer(np.ones(nr), jp.munk_ssp(z))
    bathy = np.full(nr, 4600.0)
    kw = {}
    if kind == "range_dependent":
        c = np.array([jp.munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r])
    elif kind == "sloped":
        bathy = 4400.0 + 300.0 * np.sin(r / 30e3) + rng.uniform(-5, 5, nr)
    elif kind == "table":
        c = c + rng.normal(0.0, 0.3, c.shape)
        kw["interp"] = "table"
    elif kind == "seg":
        r, c, bathy = r[[0, -1]], c[:2], bathy[:2]
        kw["interp"] = "seg"
    return (c, r, z, bathy, r), kw


def env_pair(kind, dtype="float64"):
    args, kw = _tables(kind)
    je = jp.make_env_data(*args, dtype=jnp.dtype(dtype), **kw)
    te = tp.make_env_data(*args, dtype=resolve_dtype(dtype), device="cpu", **kw)
    return je, te


def assert_env_equal(je, te):
    for f in DATA_FIELDS:
        a = np.asarray(getattr(je, f))
        b = getattr(te, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for m in META_FIELDS:
        assert getattr(je, m) == getattr(te, m), m


KINDS = ["munk_horner", "munk_clenshaw", "range_dependent", "sloped", "table", "seg"]


@pytest.mark.parametrize("kind", KINDS)
def test_make_env_data_fields_equal(kind):
    je, te = env_pair(kind)
    assert_env_equal(je, te)
    expect = {
        "munk_horner": lambda e: e.has_cheb and e.poly_ok and not e.range_dependent,
        "munk_clenshaw": lambda e: e.has_cheb and not e.poly_ok,
        "range_dependent": lambda e: e.range_dependent and e.has_cheb,
        "sloped": lambda e: e.bangle_mode == "cheb",
        "table": lambda e: not e.has_cheb and not e.has_seg,
        "seg": lambda e: e.has_seg and not e.has_cheb,
    }[kind]
    assert expect(te), kind


@pytest.mark.parametrize("kind", ["munk_horner", "sloped"])
def test_env_from_reference_round_trips(kind):
    je, te = env_pair(kind)
    fields = {f: np.asarray(getattr(je, f)) for f in DATA_FIELDS}
    meta = {m: getattr(je, m) for m in META_FIELDS}
    assert_env_equal(je, env_from_reference(fields, meta, device="cpu", dtype=F64))
    # and back out of the port the same way
    fields_t = {f: getattr(te, f).numpy() for f in DATA_FIELDS}
    meta_t = {m: getattr(te, m) for m in META_FIELDS}
    assert_env_equal(je, env_from_reference(fields_t, meta_t, device="cpu", dtype="float64"))
    with pytest.raises(ValueError):
        env_from_reference({}, meta)


@pytest.mark.parametrize("kind", ["sloped", "range_dependent"])
def test_mirror_env_data_matches(kind):
    je, te = env_pair(kind)
    jm, tm = jmirror(je), tmirror(te)
    for f in DATA_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(jm, f)), getattr(tm, f).numpy(),
                                   rtol=1e-14, atol=1e-12, err_msg=f)
    for m in META_FIELDS:
        assert getattr(jm, m) == getattr(tm, m), m
    assert tmirror(te) is tm  # memoized per environment object


def test_host_profile_tables_and_with_spectral():
    je, te = env_pair("munk_horner")
    for a, b in zip(jhost(je), thost(te)):
        np.testing.assert_array_equal(a, b)
    cc = np.asarray(je.c_cheb) * 1.0001
    jw = jp.with_spectral(je, cc, np.asarray(je.dcdz_cheb))
    tw = tp.with_spectral(te, torch.as_tensor(cc), te.dcdz_cheb)
    assert_env_equal(jw, tw)


def test_float32_build_and_to():
    je, te = env_pair("munk_horner", "float32")
    assert_env_equal(je, te)
    moved = te.to("cpu", dtype=F64)
    assert moved.dtype == F64 and moved.device == te.device
    assert moved.z_dom == te.z_dom and moved.poly_ok == te.poly_ok
    assert resolve_dtype(None) == torch.float32
    assert resolve_dtype(np.float64) == F64
    with pytest.raises(ValueError):
        resolve_dtype("int32")


def test_ocean_environment_env_data_matches():
    """OceanEnvironment2D (copied host layer) + flat-earth transform +
    ``env_data`` give the JAX package's EnvData."""
    from pygenray_tpu.utils.xrlite import DataArray as JDA
    from pygenray_tpu_torch.utils.xrlite import DataArray as TDA

    rng = np.random.default_rng(3)
    z = np.linspace(0.0, 5500.0, 300)
    r = np.linspace(0.0, 60e3, 5)
    c = np.outer(np.ones(5), jp.munk_ssp(z)) + rng.normal(0, 1e-3, (5, 300))
    bathy = 4800.0 + 100.0 * np.cos(r / 20e3)

    def build(pkg, DA):
        ss = DA(c, dims=["range", "depth"], coords={"range": r, "depth": z})
        bb = DA(bathy, dims=["range"], coords={"range": r})
        return pkg.OceanEnvironment2D(sound_speed=ss, bathymetry=bb, lat=30.0)

    jo, to = build(jp, JDA), build(tp, TDA)
    np.testing.assert_array_equal(jo.sound_speed_fe.values, to.sound_speed_fe.values)
    for flat in (True, False):
        for mirrored in (False, True):
            je = jo.env_data(flatearth=flat, mirrored=mirrored, dtype=jnp.float64)
            te = to.env_data(flatearth=flat, mirrored=mirrored, dtype=F64, device="cpu")
            assert_env_equal(je, te)
    assert to.env_data(dtype="float64", device="cpu") is to.env_data(dtype=F64, device="cpu")  # cached
    dep = np.linspace(0, 5000, 11)
    np.testing.assert_array_equal(jp.eflat(dep, 35.0)[0], tp.eflat(dep, 35.0)[0])
    np.testing.assert_allclose(jp.eflatinv(dep, 35.0)[0], tp.eflatinv(dep, 35.0)[0],
                               rtol=0, atol=0)
