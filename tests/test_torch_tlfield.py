"""Transmission-loss fields in the port (``pygenray_tpu_torch.tlfield``).

* The JAX package's own cases (``tests/test_tlfield.py``) on the port with
  ``device="cpu"``, with fewer rays and columns (the plain Dual loop runs a
  few ms a step on a CPU) and their own bounds: the incoherent field
  against spherical spreading (median 0.3 dB, 95 % 1 dB), the coherent
  field against Lloyd's mirror (median 0.5 dB, 90 % 2 dB), the archive
  round trip, the argument checks.
* The port's ``TLField`` against the JAX package's on one shared small fan
  in float32 (same numpy tables through ``env_from_reference``): empty cells
  equal, the incoherent field within 1e-3 dB, the coherent pressure within
  1e-2 of the field's largest (the phase omega * t moves with the 1e-5 s
  by which two float32 traces without Kahan differ; measured 2e-3), and
  the flip classification on a hand-made tangent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.tlfield import _classified_flip_counts as j_flip_counts
from pygenray_tpu_torch.envdata import DATA_FIELDS, META_FIELDS
from pygenray_tpu_torch.ops import stepper
from pygenray_tpu_torch.tlfield import _classified_flip_counts
from torch_fixtures import one_blas_thread  # noqa: F401

C0 = 1500.0


def iso_env(depth=20000.0, r_max=50e3):
    z = np.linspace(0.0, depth, 64)
    r = np.linspace(0.0, r_max, 8)
    return tp.make_env_data(np.full((r.size, z.size), C0), r, z, np.full(r.size, depth), r,
                            dtype=torch.float64, device="cpu")


def test_incoherent_spherical_spreading():
    # deep source, fan too shallow to reach either boundary: every cell
    # inside the insonified cone sees exactly one (straight) eigenray,
    # so TL_inc = 20 log10(slant range)
    env = iso_env()
    z0, R = 10000.0, 20e3
    n0 = stepper.TANGENT_SAVE_LAUNCHES
    fld = tp.transmission_loss_field(z0, 0.0, np.linspace(-14.0, 14.0, 1601), R, env,
                                     depths=np.linspace(6000.0, 14000.0, 161), num_range=41,
                                     dx=500.0)
    assert stepper.TANGENT_SAVE_LAUNCHES == n0  # CPU tensors: no launch
    assert fld.tl_coherent is None and fld.frequency is None
    assert fld.ranges[0] > 0.0 and fld.ranges[-1] == pytest.approx(R)
    zz, rr = np.meshgrid(fld.depths, fld.ranges, indexing="ij")
    tl_exact = 20.0 * np.log10(np.hypot(rr, zz - z0))
    # inside the cone (|elevation| < 12 deg), past the first few columns
    elev = np.degrees(np.arctan2(np.abs(zz - z0), rr))
    sel = (elev < 12.0) & (rr > 2e3) & np.isfinite(fld.tl_incoherent)
    assert sel.sum() > 800
    err = np.abs(fld.tl_incoherent - tl_exact)[sel]
    assert np.nanmedian(err) < 0.3  # dB
    assert np.nanpercentile(err, 95) < 1.0  # binning noise tail


def test_coherent_lloyds_mirror():
    # shallow source over a deep isovelocity half-space: the coherent
    # field is the two-path image sum p = e^{iks1}/s1 - e^{iks2}/s2
    env = iso_env(depth=30000.0)
    z0, R, f = 50.0, 4e3, 150.0
    k = 2 * np.pi * f / C0
    fld = tp.transmission_loss_field(z0, 0.0, np.linspace(-20.0, 20.0, 3201), R, env,
                                     frequency=f, depths=np.linspace(100.0, 1200.0, 111),
                                     num_range=81)
    assert fld.tl_coherent is not None and fld.frequency == f
    zz, rr = np.meshgrid(fld.depths, fld.ranges, indexing="ij")
    s1 = np.hypot(rr, zz - z0)
    s2 = np.hypot(rr, zz + z0)  # image source above the surface
    tl_exact = -20.0 * np.log10(np.abs(np.exp(1j * k * s1) / s1 - np.exp(1j * k * s2) / s2))
    elev = np.degrees(np.arctan2(zz + z0, rr))  # reflected-path angle
    # away from interference nulls and inside the fan cone
    null = tl_exact > 20.0 * np.log10(s1) + 10.0
    sel = (elev < 16.0) & (rr > 1e3) & ~null & np.isfinite(fld.tl_coherent)
    assert sel.sum() > 500
    err = np.abs(fld.tl_coherent - tl_exact)[sel]
    assert np.nanmedian(err) < 0.5
    assert np.nanpercentile(err, 90) < 2.0
    # the incoherent field of the same run: two-path power sum
    tl_inc_exact = -10.0 * np.log10(1.0 / s1 ** 2 + 1.0 / s2 ** 2)
    assert np.nanmedian(np.abs(fld.tl_incoherent - tl_inc_exact)[sel]) < 0.5


def test_npz_round_trip_and_default_depths(tmp_path):
    env = iso_env()
    fld = tp.transmission_loss_field(10000.0, 0.0, np.linspace(-10, 10, 101), 10e3, env,
                                     frequency=40.0, depths=np.linspace(8000.0, 12000.0, 41),
                                     num_range=11, dx=1000.0)
    fld.save_npz(tmp_path / "tl.npz")
    back = tp.TLField.load_npz(tmp_path / "tl.npz")
    for f in ("ranges", "depths", "tl_incoherent", "tl_coherent"):
        np.testing.assert_array_equal(getattr(back, f), getattr(fld, f))
    assert back.frequency == 40.0 and back.source_depth == 10000.0 and back.source_range == 0.0
    # no frequency, default depth grid: 200 bins over the water column
    inc = tp.transmission_loss_field(10000.0, 0.0, [-1.0, 1.0], 2e3, env, num_range=3,
                                     dx=1000.0)
    assert inc.depths.shape == (200,) and inc.depths[-1] == 20000.0
    inc.save_npz(tmp_path / "inc.npz")
    assert tp.TLField.load_npz(tmp_path / "inc.npz").tl_coherent is None


def test_input_validation_and_default_device():
    env = iso_env()
    with pytest.raises(ValueError, match="receiver_range"):
        tp.transmission_loss_field(100.0, 5e3, [1.0, 2.0], 1e3, env)
    with pytest.raises(ValueError, match="at least 2"):
        tp.transmission_loss_field(100.0, 0.0, [1.0], 1e3, env)
    with pytest.raises(ValueError, match="increasing"):
        tp.transmission_loss_field(100.0, 0.0, [1.0, 2.0], 1e3, env, num_range=3, dx=500.0,
                                   depths=np.array([50.0, 40.0]))
    from pygenray_tpu_torch.models import munk_env

    ocean = munk_env(r_max=10e3, nr=4, nz=200)
    call = lambda: tp.transmission_loss_field(1300.0, 0.0, [1.0, 2.0], 5e3, ocean, num_range=3,
                                              dx=1000.0, flatearth=False)
    if torch.cuda.is_available():
        assert call().tl_incoherent.shape[1] == 2
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


# ---- against the JAX package on one shared small fan -----------------------


@pytest.fixture(scope="module")
def shared():
    R = 30e3
    z = np.linspace(0.0, 6000.0, 1024)
    r = np.linspace(0.0, R, 6)
    je = jp.make_env_data(np.outer(np.ones(6), jp.munk_ssp(z)), r, z, np.full(6, 4600.0), r,
                          dtype=jnp.float32)
    te = tp.env_from_reference({f: np.asarray(getattr(je, f)) for f in DATA_FIELDS},
                               {m: getattr(je, m) for m in META_FIELDS}, device="cpu",
                               dtype=torch.float32)
    kw = dict(frequency=75.0, depths=np.linspace(0.0, 4600.0, 47), num_range=31, dx=500.0,
              flatearth=False)
    angles = np.linspace(-20.0, 20.0, 141)
    return (jp.transmission_loss_field(1300.0, 0.0, angles, R, je, **kw),
            tp.transmission_loss_field(1300.0, 0.0, angles, R, te, **kw))


def test_field_grids_and_empty_cells_match_jax(shared):
    jf, tf = shared
    for f in ("ranges", "depths"):
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f))
    assert tf.tl_incoherent.shape == (47, 30) == tf.tl_coherent.shape
    assert (tf.frequency, tf.source_depth, tf.source_range) == (75.0, 1300.0, 0.0)
    np.testing.assert_array_equal(np.isnan(tf.tl_incoherent), np.isnan(jf.tl_incoherent))
    np.testing.assert_array_equal(np.isnan(tf.tl_coherent), np.isnan(jf.tl_coherent))
    assert np.isfinite(tf.tl_incoherent).mean() > 0.5


def test_incoherent_field_matches_jax(shared):
    jf, tf = shared
    np.testing.assert_allclose(tf.tl_incoherent, jf.tl_incoherent, rtol=0, atol=1e-3)


def test_coherent_field_matches_jax(shared):
    jf, tf = shared
    press = lambda tl: 10.0 ** (-tl / 20.0)
    diff = np.nanmax(np.abs(press(tf.tl_coherent) - press(jf.tl_coherent)))
    assert diff <= 1e-2 * np.nanmax(press(jf.tl_coherent))


def test_flip_classification_matches_jax():
    """Sign flips of a hand-made tangent near the surface, near the bottom
    and in mid-water: the port's copy classifies them as the JAX package's."""
    rng = np.random.default_rng(11)
    B, S = 12, 40
    dzs = np.cumsum(rng.normal(size=(B, S)), axis=1)
    dzs[:, 0] = 0.0
    dzs[rng.random((B, S)) < 0.1] = 0.0  # touches without a crossing
    depth = rng.choice([50.0, 2000.0, 3950.0], size=(B, S))
    bathy_at = np.full((1, S), 4000.0)
    alive = np.cumsum(rng.random((B, S)) < 0.02, axis=1) == 0
    slope = np.abs(rng.normal(scale=0.2, size=(B, S)))
    got = _classified_flip_counts(dzs, depth, bathy_at, alive, slope, 500.0)
    want = j_flip_counts(dzs, depth, bathy_at, alive, slope, 500.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(int(g[:, -1].sum()) > 0 for g in got), [int(g[:, -1].sum()) for g in got]
