"""Monte-Carlo ensembles in the port (``pygenray_tpu_torch.montecarlo``,
``models/internal_waves.py``) against the JAX package, on CPU.

* The internal-wave fields are the JAX package's bit for bit.
* ``make_env_ensemble`` gives the JAX package's stacked leaves exactly (every
  data field ``array_equal``, the metadata equal) for an internal-wave
  Chebyshev ensemble, a rough segment ensemble (``bench.py``'s recipe at nz
  = 400, two realizations, four stations) and an ensemble whose members
  disagree on the monomial guard.
* ``trace_ensemble`` (the plain torch-op loop on a CPU) against the JAX
  package's ``trace_ensemble`` on its XLA scan, with
  ``tests/test_pallas.py``'s bounds: counters, death codes and
  ``alive_save`` equal, travel times within 5e-6 s, depths within 1e-2 m
  (the rough ensemble over 10 km, see the test).
* ``mc_eigenray_times``: the port's default one-shot Newton (the ensemble
  tangent kernel's plain version on a CPU) against the JAX package's
  two-phase regula falsi on its scan, within ``tests/test_montecarlo.py``'s
  Newton-against-regula-falsi bounds (valid equal, angles within 0.05°,
  times within 5e-4 s, bottom bounces equal, residual under 1 m); the
  port's own two-phase regula falsi (``backend="ops"``) against the same
  call within 5e-5 s and 0.02°; a depth array against per-depth calls; the
  overflow fallback past ``MC_BRACKET_CAP``.

The eigenray ensemble is a smooth range-dependent Munk field per
realization (16 Chebyshev terms) over 20 km at dx = 1 km: the plain Dual
loop costs about 6 ms a realization-step on a CPU at 24 terms, and an
internal-wave field's 64 terms would triple that.
"""

import dataclasses
import pathlib
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu.montecarlo as jmc
import pygenray_tpu_torch as tp
import pygenray_tpu_torch.montecarlo as tmc
from pygenray_tpu.integrate import SolverSettings as JSettings
from pygenray_tpu.models import internal_waves as jiw
from pygenray_tpu_torch.envdata import (
    DATA_FIELDS, META_FIELDS, env_from_reference, env_member, stack_env_data,
)
from pygenray_tpu_torch.integrate import SolverSettings
from pygenray_tpu_torch.models import internal_waves as tiw

sys.path.insert(0, str(pathlib.Path(__file__).parent / "fixtures"))
import rough_field  # noqa: E402
from torch_fixtures import one_blas_thread  # noqa: E402, F401


def rough_tables(E, nz, nr, r_max):
    """``bench.py``'s rough-field ensemble (``tests/fixtures/rough_field.py``)."""
    return rough_field.rough_tables(jp.munk_ssp, E, nz, nr, r_max)


def _tables(kind):
    if kind == "iw":
        c, r, z = jiw.perturbed_munk_tables(2, r_max=20e3, nr=4, nz=400, seed=5)
    elif kind == "rough":
        c, r, z = rough_tables(2, 400, 4, 20e3)
    elif kind == "poly_ok":
        # the same smooth profile twice, the second 24 km/s faster
        # (physically meaningless): its float32 Horner fails the monomial
        # guard at the common order, which demotes the whole ensemble
        z, r = np.linspace(0.0, 6000.0, 400), np.linspace(0.0, 20e3, 4)
        c0 = np.array([jp.munk_ssp(z, sofar_depth=1200 + 0.01 * ri, eps=0.003) for ri in r])
        c = np.stack([c0, c0 + 24000.0])
    else:  # "eig": per realization a Munk axis sloping in range
        z, r = np.linspace(0.0, 6000.0, 1024), np.linspace(0.0, 20e3, 8)
        slopes = np.random.default_rng(3).uniform(-0.01, 0.01, 2)
        c = np.array([[jp.munk_ssp(z, sofar_depth=1500 + s * ri) for ri in r] for s in slopes])
    return c, r, z


_ENVS = {}


def ensemble_pair(kind):
    """(JAX ensemble, port ensemble) from the same tables, float32."""
    if kind not in _ENVS:
        c, r, z = _tables(kind)
        bathy = np.full(len(r), 5000.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # high-order fits of 400 samples
            je = jmc.make_env_ensemble(c, r, z, bathy, r, dtype=jnp.float32)
            te = tmc.make_env_ensemble(c, r, z, bathy, r, dtype=torch.float32, device="cpu")
        _ENVS[kind] = (je, te)
    return _ENVS[kind]


@pytest.mark.parametrize("seed", [0, 11])
def test_internal_waves_are_the_jax_packages(seed):
    z, r = np.linspace(0.0, 6000.0, 300), np.linspace(0.0, 50e3, 20)
    np.testing.assert_array_equal(tiw.iw_perturbations(z, r, 3, seed=seed),
                                  jiw.iw_perturbations(z, r, 3, seed=seed))
    for mine, theirs in zip(tiw.perturbed_munk_tables(2, r_max=30e3, nr=8, nz=256, seed=seed),
                            jiw.perturbed_munk_tables(2, r_max=30e3, nr=8, nz=256, seed=seed)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("kind", ["iw", "rough", "poly_ok"])
def test_make_env_ensemble_matches_jax(kind):
    je, te = ensemble_pair(kind)
    expect = {"iw": (True, False), "rough": (False, True), "poly_ok": (True, False)}[kind]
    assert (te.has_cheb, te.has_seg) == expect
    if kind == "rough":
        assert te.seg_basis == "cheb" and te.c_seg.shape[:3] == (2, 4, 32)
    if kind == "poly_ok":
        assert not te.poly_ok
        c, r, z = _tables(kind)
        members = [tp.make_env_data(ci, r, z, np.full(4, 5000.0), r, force_range_dependent=True,
                                    cheb_order=255, device="cpu") for ci in c]
        assert [m.poly_ok for m in members] == [True, False]
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)),
                                      err_msg=f)
    for m in META_FIELDS:
        assert getattr(te, m) == getattr(je, m), m
    # the JAX ensemble's leaves carry across whole
    fields = {f: np.asarray(getattr(je, f)) for f in DATA_FIELDS}
    back = env_from_reference(fields, {m: getattr(je, m) for m in META_FIELDS}, device="cpu")
    for f in DATA_FIELDS:
        assert torch.equal(getattr(back, f), getattr(te, f)), f
    # a member is one realization; stacking the members gives the ensemble
    again = stack_env_data([env_member(te, e) for e in range(2)])
    for f in DATA_FIELDS:
        assert torch.equal(getattr(again, f), getattr(te, f)), f
    with pytest.raises(ValueError, match="disagree"):
        stack_env_data([env_member(te, 0), dataclasses.replace(env_member(te, 1),
                                                               uniform_z=not te.uniform_z)])


@pytest.mark.parametrize("kind,span,dx", [("eig", 25.0, 500.0), ("rough", 16.0, 500.0)])
def test_trace_ensemble_plain_matches_jax(kind, span, dx):
    """The Chebyshev case is the eigenray ensemble (24 terms: the JAX scan
    compiles an internal-wave field's 64 unrolled terms for 10 s), over 20
    km.  The rough case runs over 10 km: a segment fit jumps by up to its
    residual at each segment boundary (0.1 m/s), so where float32 rounding
    moves a depth across one, the two packages' rays part; over 20 km 11 of
    these 48 rays part by more than 1e-2 m in depth (up to 0.14 m, times
    within 5e-6 s), over 10 km none does (ROADMAP C)."""
    je, te = ensemble_pair(kind)
    if kind == "eig":  # Clenshaw: XLA contracts Horner's multiply-adds, torch does not
        je, te = (dataclasses.replace(e, poly_ok=False) for e in (je, te))
    x1 = 10e3 if kind == "rough" else 20e3
    angles = np.linspace(-span, span, 24)
    p0 = np.sin(np.radians(-angles)) / 1500.0
    ref = jmc.trace_ensemble(je, 1300.0, jnp.asarray(p0, jnp.float32), 0.0, x1, 3,
                             JSettings(dx=dx, backend="xla"))
    got = tmc.trace_ensemble(te, 1300.0, p0, 0.0, x1, 3, SolverSettings(dx=dx))
    assert got.ts.shape == (2, 24, 3) and got.alive_save.shape == (2, 24, 3)
    for f in ("n_surf", "n_bott", "death_code", "alive_save", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert int((got.n_surf + got.n_bott).sum()) > 0  # the crossing fix ran
    for f, tol in (("ts", 5e-6), ("zs", 1e-2)):
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f)))
        assert d.max() <= tol, (f, d.max())
    # per-realization launch parameters: row e traces p0[e]
    per = tmc.trace_ensemble(te, 1300.0, np.stack([p0, p0[::-1]]), 0.0, x1, 3,
                             SolverSettings(dx=dx))
    assert torch.equal(per.ts[0], got.ts[0]) and torch.equal(per.ts[1], got.ts[1].flip(0))


MC_KW = dict(receiver_depth=1600.0, source_depth=1300.0, source_range=0.0,
             receiver_range=20e3, ztol=1.0)
MC_FAN = np.linspace(-12.0, 12.0, 25)
MC_DX = 1000.0


@pytest.fixture(scope="module")
def mc_runs():
    """The JAX package's two-phase regula falsi on its scan, and the port's
    default one-shot Newton, on the eigenray ensemble."""
    je, te = ensemble_pair("eig")
    ref = jmc.mc_eigenray_times(je, MC_FAN, settings=JSettings(dx=MC_DX, backend="xla"),
                                **MC_KW)
    got = tmc.mc_eigenray_times(te, MC_FAN, settings=SolverSettings(dx=MC_DX), **MC_KW)
    return te, ref, got


def _same_arrivals(got, ref, angle_deg, time_s):
    assert np.array_equal(got["valid"], ref["valid"])
    v = got["valid"]
    assert v.sum(axis=1).min() >= 1
    np.testing.assert_allclose(got["theta"][v], ref["theta"][v], atol=angle_deg)
    np.testing.assert_allclose(got["t"][v], ref["t"][v], atol=time_s)
    np.testing.assert_array_equal(got["n_bott"][v], ref["n_bott"][v])
    assert np.all(got["z_resid"][v] < 1.0)


def test_mc_one_shot_newton_matches_jax_regula_falsi(mc_runs):
    _, ref, got = mc_runs
    assert ref["path"] == "two-phase" and got["path"] == "one-shot"
    _same_arrivals(got, ref, 0.05, 5e-4)


def test_mc_ops_two_phase_matches_jax(mc_runs):
    te, ref, _ = mc_runs
    got = tmc.mc_eigenray_times(te, MC_FAN, settings=SolverSettings(dx=MC_DX, backend="ops"),
                                **MC_KW)
    assert got["path"] == "two-phase"
    _same_arrivals(got, ref, 0.02, 5e-5)


def test_mc_depth_array_matches_per_depth_calls(mc_runs):
    """Both through the two-phase regula falsi (``backend="ops"``): the
    array concatenates the depths' candidates, so each candidate's
    arithmetic is the scalar call's."""
    te = mc_runs[0]
    s = SolverSettings(dx=MC_DX, backend="ops")
    kw = {k: v for k, v in MC_KW.items() if k != "receiver_depth"}
    rds = np.array([1800.0, 2500.0])
    multi = tmc.mc_eigenray_times(te, MC_FAN, rds, settings=s, **kw)
    assert multi["valid"].shape[:2] == (2, 2) and multi["path"] == "two-phase"
    for d, rd in enumerate(rds):
        single = tmc.mc_eigenray_times(te, MC_FAN, float(rd), settings=s, **kw)
        M = single["valid"].shape[1]
        assert np.array_equal(multi["valid"][d, :, :M], single["valid"])
        assert not multi["valid"][d, :, M:].any()
        v = single["valid"]
        assert v.any()
        np.testing.assert_allclose(multi["theta"][d, :, :M][v], single["theta"][v], atol=1e-6)
        np.testing.assert_allclose(multi["t"][d, :, :M][v], single["t"][v], atol=1e-9)
        np.testing.assert_array_equal(multi["n_bott"][d, :, :M][v], single["n_bott"][v])


def test_mc_overflow_falls_back_to_two_phase(mc_runs, monkeypatch):
    """Past ``MC_BRACKET_CAP`` brackets the call warns, reuses the one-shot
    fan's final depths and solves two-phase: the same arrivals
    (``tests/test_montecarlo.py``'s bounds)."""
    te, _, base = mc_runs
    counts = base["valid"].sum(axis=1)
    assert counts.max() >= 2  # enough brackets that a capacity of 1 overflows
    monkeypatch.setattr(tmc, "MC_BRACKET_CAP", 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fb = tmc.mc_eigenray_times(te, MC_FAN, settings=SolverSettings(dx=MC_DX), **MC_KW)
    assert any("MC_BRACKET_CAP" in str(x.message) for x in w)
    assert fb["path"] == "two-phase"
    np.testing.assert_array_equal(fb["valid"].sum(axis=1), counts)
    for e in range(2):
        for k, tol in (("t", 5e-5), ("theta", 0.02)):
            np.testing.assert_allclose(np.sort(fb[k][e][fb["valid"][e]]),
                                       np.sort(base[k][e][base["valid"][e]]), atol=tol)


def test_mc_not_ported_options_raise():
    _, te = ensemble_pair("eig")
    # the mesh is ported (tests/test_torch_sharding.py): what is not a
    # parallel.Mesh raises TypeError
    with pytest.raises(TypeError, match="Mesh"):
        tmc.mc_eigenray_times(te, MC_FAN, mesh=object(), **MC_KW)
    with pytest.raises(TypeError, match="Mesh"):
        tmc.trace_ensemble(te, 1300.0, np.zeros(2), 0.0, 1e3, 2, mesh=object())
    for kw in ({"calm": np.zeros((2, 4))}, {"dyn": np.zeros((2, 1, 4))}):
        with pytest.raises(ValueError, match="calm and dyn"):
            tmc.trace_ensemble(te, 1300.0, np.zeros(2), 0.0, 1e3, 2, **kw)
    assert tp.make_env_ensemble is tmc.make_env_ensemble
    assert tp.trace_ensemble is tmc.trace_ensemble and tp.mc_eigenray_times is tmc.mc_eigenray_times
