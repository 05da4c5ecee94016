"""The port's torch-op trace loop against the JAX package's XLA scan.

``pygenray_tpu_torch.integrate._trace_impl`` and
``pygenray_tpu.integrate._trace_impl`` trace the same fans (launch
parameters from numpy) through environments built from the same numpy
tables, in float64, over every profile backend and bottom model.  Bounce
counters, death codes and ``alive_save`` must be equal; travel times agree
within 1e-9 s and depths within 1e-6 m (both integrate the same arithmetic;
the bounds leave room for a few float64 ulps of different op fusion).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.integrate import SolverSettings as JSettings, _trace_impl as j_trace_impl
from pygenray_tpu_torch.integrate import (
    BACKENDS,
    DEATH_CODES,
    SolverSettings,
    _plan,
    _trace_impl,
    trace,
)
from torch_fixtures import one_blas_thread  # noqa: F401

TS_TOL = 1e-9
ZS_TOL = 1e-6


def _tables(case):
    """(c, r, z, bathy, bathy_r), make_env_data kwargs, x1 for one case."""
    rng = np.random.default_rng(11)
    nr = 6
    r = np.linspace(0.0, 40e3, nr)
    z = np.linspace(0.0, 6000.0, 1024 if case in ("cheb_horner", "kahan_off") else 256)
    c = np.outer(np.ones(nr), jp.munk_ssp(z))
    bathy, bathy_r = np.full(nr, 4600.0), r
    kw = {}
    if case.startswith("range_dependent"):
        c = np.array([jp.munk_ssp(z, sofar_depth=1300 + 0.004 * ri) for ri in r])
    if case.endswith("table"):
        kw["interp"] = "table"
    if case == "sloped":
        bathy = 4400.0 + 300.0 * np.sin(r / 12e3)
    elif case == "spline_bottom":
        bathy_r = np.linspace(0.0, 40e3, 40)
        bathy = 4400.0 + rng.uniform(0.0, 400.0, 40)
    elif case == "seg":
        c, r, bathy, bathy_r = c[:2], r[[0, -1]], bathy[:2], r[[0, -1]]
        kw["interp"] = "seg"
    elif case == "backwards":
        # a steep up-slope wall at 10-14 km: down-going rays reflect past vertical
        bathy_r = np.linspace(0.0, 40e3, 41)
        bathy = np.clip(4600.0 - 1.2 * (bathy_r - 10e3), 600.0, 4600.0)
    return (c, r, z, bathy, bathy_r), kw


CASES = {
    # case: (angles, x1, settings kwargs)
    "table": (np.linspace(-16, 16, 24), 20e3, {}),
    "cheb_clenshaw": (np.linspace(-18, 18, 77), 20e3, {}),
    "cheb_horner": (np.linspace(-18, 18, 33), 20e3, {}),
    "range_dependent": (np.linspace(-17, 17, 40), 20e3, {}),
    "range_dependent_table": (np.linspace(-17, 17, 16), 20e3, {}),
    "sloped": (np.linspace(-20, -12, 32), 25e3, {}),
    "spline_bottom": (np.linspace(-20, 20, 32), 20e3, {}),
    "seg": (np.linspace(-18, 18, 24), 20e3, {}),
    "kahan_off": (np.linspace(-18, 18, 32), 20e3, {"kahan": False}),
    # vertical, near-vertical and horizontal rays, and a shot past r_dom
    "deaths": (np.array([-90.0, -89.999, -60.0, 0.0, 12.0, 89.999]), 42e3, {}),
    "backwards": (np.linspace(-35, 35, 48), 20e3, {}),
}


def env_pair(case):
    args, kw = _tables(case)
    je = jp.make_env_data(*args, dtype=jnp.float64, **kw)
    te = tp.make_env_data(*args, dtype=torch.float64, device="cpu", **kw)
    return je, te


def run_pair(case, dx=250.0, z0=1300.0, num_save=5, **extra):
    angles, x1, skw = CASES[case]
    skw = {**skw, **extra}
    je, te = env_pair(case)
    h, sps, nseg = _plan(0.0, x1, num_save, dx)
    geom = (0.0, x1, h, sps, nseg)
    c_src = np.interp(z0, np.asarray(je.z), np.asarray(je.c[0]))
    p0 = np.sin(np.radians(-angles)) / c_src
    ref = j_trace_impl(je, z0, jnp.asarray(p0), geom, JSettings(dx=dx, **skw))
    out = _trace_impl(te, z0, torch.as_tensor(p0), geom, SolverSettings(dx=dx, **skw))
    return je, te, ref, out


def assert_result_match(ref, out):
    for f in ("n_surf", "n_bott", "death_code", "alive", "alive_save"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(out, f).numpy(),
                                      err_msg=f)
    # save points a ray reached alive: absolute bounds; the frozen state of a
    # dead ray (its last step can take T to ~1e13 s at a vertical turn)
    # agrees relatively (its last step is near-singular)
    live = np.asarray(ref.alive_save)
    for f, tol in (("ts", TS_TOL), ("zs", ZS_TOL), ("ps", 1e-15)):
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        np.testing.assert_allclose(a[live], b[live], rtol=0, atol=tol, err_msg=f)
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=tol, err_msg=f)
    np.testing.assert_allclose(np.asarray(ref.rs), out.rs.numpy(), rtol=0, atol=1e-9)
    assert out.ts.shape == ref.ts.shape and out.n_surf.dtype == torch.int32


@pytest.mark.parametrize("case", list(CASES))
def test_trace_impl_matches_jax_f64(case):
    je, te, ref, out = run_pair(case)
    assert_result_match(ref, out)
    # each case exercises what it names
    codes = set(out.death_code.tolist())
    assert 5 not in codes  # the port has no calm-block audit
    check = {
        "table": lambda: not te.has_cheb,
        "cheb_clenshaw": lambda: te.has_cheb and not te.poly_ok,
        "cheb_horner": lambda: te.poly_ok,
        "range_dependent": lambda: te.range_dependent and te.has_cheb,
        "range_dependent_table": lambda: te.range_dependent and not te.has_cheb,
        "sloped": lambda: te.bangle_mode == "cheb" and int(out.n_bott.sum()) > 0,
        "spline_bottom": lambda: te.bangle_mode == "spline" and int(out.n_bott.sum()) > 0,
        "seg": lambda: te.has_seg and not te.has_cheb,
        "kahan_off": lambda: True,
        "deaths": lambda: {1, 2} <= codes,
        "backwards": lambda: 3 in codes,
    }[case]
    assert check(), case
    assert int((out.n_surf + out.n_bott).sum()) > 0 or case == "deaths"


def test_kahan_flag_changes_f32_arithmetic():
    """kahan=False must change float32 travel times (the flag is honored)."""
    args, _ = _tables("cheb_horner")
    te = tp.make_env_data(*args, dtype=torch.float32, device="cpu")
    h, sps, nseg = _plan(0.0, 20e3, 5, 250.0)
    p0 = torch.as_tensor(np.sin(np.radians(np.linspace(-12, 12, 16))) / 1500.0)
    on = _trace_impl(te, 1300.0, p0, (0.0, 20e3, h, sps, nseg), SolverSettings(dx=250.0))
    off = _trace_impl(te, 1300.0, p0, (0.0, 20e3, h, sps, nseg),
                      SolverSettings(dx=250.0, kahan=False))
    assert on.ts.dtype == torch.float32
    assert not torch.equal(on.ts, off.ts)
    torch.testing.assert_close(on.ts, off.ts, rtol=0, atol=1e-4)


def test_terminate_backwards_off_keeps_rays():
    je, te, ref, out = run_pair("backwards", terminate_backwards=False)
    assert_result_match(ref, out)
    assert 3 not in set(out.death_code.tolist())


def test_plan_matches():
    from pygenray_tpu.integrate import _plan as j_plan

    for args in [(0.0, 100e3, 50, 200.0), (0.0, 50e3, 2, 50.0), (-5e3, 7e3, 13, 333.0),
                 (0.0, 1e3, 1, 5000.0)]:
        assert _plan(*args) == j_plan(*args)
    assert _plan(0.0, 100e3, 50, 200.0) == pytest.approx((100e3 / 490, 10, 49))


def test_trace_dispatch_on_cpu():
    """On CPU tensors "auto" and "ops" run the torch-op loop and "kernel"
    runs the kernel's plain version; "kernel" raises on what the kernel does
    not cover; unknown backends and x1 <= x0 raise."""
    args, _ = _tables("cheb_horner")
    te32 = tp.make_env_data(*args, dtype=torch.float32, device="cpu")
    te64 = tp.make_env_data(*args, dtype=torch.float64, device="cpu")
    p0 = np.sin(np.radians(np.linspace(-10, 10, 8))) / 1500.0
    outs = [trace(te32, 1300.0, p0, 0.0, 10e3, 3, SolverSettings(dx=500.0, backend=b))
            for b in BACKENDS]
    for o in outs[1:]:
        for f in ("ts", "zs", "ps", "n_surf", "n_bott", "death_code", "alive_save"):
            assert torch.equal(getattr(outs[0], f), getattr(o, f))
    with pytest.raises(ValueError, match="unsupported"):
        trace(te64, 1300.0, p0, 0.0, 10e3, 3, SolverSettings(dx=500.0, backend="kernel"))
    with pytest.raises(ValueError, match="unsupported"):
        trace(te32, 1300.0, p0, 0.0, 10e3, 3,
              SolverSettings(dx=500.0, backend="kernel", interp="table"))
    with pytest.raises(ValueError, match="unknown backend"):
        trace(te32, 1300.0, p0, 0.0, 10e3, 3, SolverSettings(backend="pallas"))
    with pytest.raises(ValueError, match="x1 > x0"):
        trace(te32, 1300.0, p0, 10e3, 0.0, 3)
    # scalar p0 and per-ray source depths
    one = trace(te64, 1300.0, float(p0[0]), 0.0, 10e3, 3, SolverSettings(dx=500.0))
    many = trace(te64, np.full(8, 1300.0), p0, 0.0, 10e3, 3, SolverSettings(dx=500.0))
    assert one.ts.shape == (1, 3)
    torch.testing.assert_close(one.ts[0], many.ts[0], rtol=0, atol=0)


def test_death_codes_are_the_reference_subset():
    from pygenray_tpu.integrate import DEATH_CODES as J

    assert DEATH_CODES == {k: v for k, v in J.items() if k != 5}
    fields = {f.name for f in dataclasses.fields(SolverSettings)}
    assert {"dx", "interp", "terminate_backwards", "vertical_limit_deg", "bbox_tol",
            "kahan", "backend"} <= fields
