"""The forward-tangent trace on CPU: the plain version of the CUDA tangent
kernel (``integrate._trace_tangent_impl``), its wrapper and the dual-number
rules it is built from.

* Against the JAX package's tangent kernel (``trace_pallas_tangent`` in
  interpret mode) at float32, range-independent and range-dependent, with
  ``tests/test_pallas.py``'s bounds: counters and death codes exact, T
  within 1e-4 s, z within 0.1 m, dz and dT within 2e-3 relative (to
  |value| + 1e3) on live rays.  As there, the monomial (Horner) path is off
  (the interpreter contracts fused multiply-adds where torch does not).
* Against central differences of the port's float64 forward trace.
* Its primal is the forward trace without Kahan compensation, bit for bit.
* The wrapper on CPU tensors is the plain version.
* Each dual-number rule against ``jax.jvp`` of the same function.

The kernel itself (``csrc/trace_tangent.cu``) runs only on a card;
``chip_smoke.py`` holds it to this plain version there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.integrate import SolverSettings as JSettings
from pygenray_tpu.ops.pallas_stepper import trace_pallas_tangent
from pygenray_tpu_torch.integrate import (
    SolverSettings,
    _plan,
    _trace_impl,
    _trace_tangent_impl,
)
from pygenray_tpu_torch.ops import dual as D
from pygenray_tpu_torch.ops import stepper

X1, DX = 20e3, 1000.0
ANGLES = np.linspace(-16.0, 16.0, 48)
NR = 6


def _tables(kind):
    # nz = 1024 fits Munk with 16 Chebyshev terms (512 needs 24): the
    # Pallas interpreter's cost grows with the terms it unrolls
    z = np.linspace(0.0, 6000.0, 1024)
    r = np.linspace(0.0, X1, NR)
    c = np.outer(np.ones(NR), jp.munk_ssp(z))
    bathy = np.full(NR, 4600.0)
    if kind.startswith("rd"):
        c = np.array([jp.munk_ssp(z, sofar_depth=1300 + 0.01 * ri) for ri in r])
    if kind.endswith("curved"):
        bathy = 4300.0 + 400.0 * np.sin(r / 5e3)
    return c, r, z, bathy, r


def _geom():
    h, sps, nseg = _plan(0.0, X1, 2, DX)
    return (0.0, X1, h, sps, nseg)


def _p0():
    return np.sin(np.radians(-ANGLES)) / 1500.0


@pytest.fixture(scope="module")
def tangents():
    """Per kind: the port's plain tangent and the JAX interpret kernel's,
    both at float32 on the same numpy inputs."""
    out = {}
    for kind in ("ri", "rd"):
        args = _tables(kind)
        je = dataclasses.replace(jp.make_env_data(*args, dtype=jnp.float32), poly_ok=False)
        te = dataclasses.replace(tp.make_env_data(*args, dtype=torch.float32, device="cpu"),
                                 poly_ok=False)
        assert te.range_dependent == (kind == "rd")
        ref = trace_pallas_tangent(je, 1300.0, jnp.asarray(_p0(), jnp.float32), 1.0, _geom(),
                                   JSettings(dx=DX, kahan=False), interpret=True)
        got = _trace_tangent_impl(te, 1300.0, _p0(), 1.0, _geom(), SolverSettings(dx=DX))
        out[kind] = (te, [np.asarray(a) for a in ref], got)
    return out


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_plain_tangent_matches_pallas_interpret(kind, tangents):
    _, ref, got = tangents[kind]
    T, z, p, dT, dz, dp, ns, nb, dc = (a.numpy() for a in got)
    assert T.dtype == np.float32 and T.shape == ANGLES.shape
    np.testing.assert_array_equal(ns, ref[6])
    np.testing.assert_array_equal(nb, ref[7])
    np.testing.assert_array_equal(dc, ref[8])
    assert (ns + nb).sum() > 0  # the crossing fix and its tangent ran
    np.testing.assert_allclose(T, ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z, ref[1], rtol=0, atol=0.1)
    live = dc == 0
    for mine, theirs in ((dz, ref[4]), (dT, ref[3])):
        rel = np.abs(mine - theirs) / (np.abs(theirs) + 1e3)
        assert rel[live].max() < 2e-3


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_tangent_primal_is_the_forward_trace_without_kahan(kind, tangents):
    te, _, got = tangents[kind]
    res = _trace_impl(te, 1300.0, _p0(), _geom(), SolverSettings(dx=DX, kahan=False))
    for mine, f in zip(got[:3], ("ts", "zs", "ps")):
        assert torch.equal(mine, getattr(res, f)[:, -1]), f
    for mine, f in zip(got[6:], ("n_surf", "n_bott", "death_code")):
        assert torch.equal(mine, getattr(res, f)), f


@pytest.mark.parametrize("kind", ["ri_curved", "rd"])
def test_plain_tangent_matches_central_differences(kind):
    """float64: dz/dp0 and dT/dp0 within 1e-4 relative (to |value| + 1e3)
    of central differences with step 1e-12 s/m, on rays whose bounce counts
    the two shifted shots share.  The relative step is ~1e-9, so rounding
    stays near 1e-9; most rays agree to 1e-6, and near-grazing crossings,
    whose higher derivatives are large, reach ~1e-5."""
    te = tp.make_env_data(*_tables(kind), dtype=torch.float64, device="cpu")
    s = SolverSettings(dx=DX)
    p0 = _p0()
    T, z, p, dT, dz, dp, ns, nb, dc = _trace_tangent_impl(te, 1300.0, p0, 1.0, _geom(), s)
    eps = 1e-12
    s_off = dataclasses.replace(s, kahan=False)
    hi = _trace_impl(te, 1300.0, p0 + eps, _geom(), s_off)
    lo = _trace_impl(te, 1300.0, p0 - eps, _geom(), s_off)
    same = ((hi.n_surf == lo.n_surf) & (hi.n_bott == lo.n_bott) & (hi.n_bott == nb)
            & hi.alive & lo.alive)
    assert int(same.sum()) >= 0.9 * len(p0) and int(nb[same].sum()) > 0
    for mine, f in ((dz, "zs"), (dT, "ts")):
        fd = (getattr(hi, f)[:, -1] - getattr(lo, f)[:, -1]) / (2 * eps)
        rel = (fd - mine).abs() / (mine.abs() + 1e3)
        assert float(rel[same].max()) < 1e-4, f


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_tangent_kernel_cpu_is_the_plain_version(kind, tangents):
    te, _, got = tangents[kind]
    s = SolverSettings(dx=DX)
    assert stepper.tangent_supported(te, s)
    n0 = stepper.TANGENT_LAUNCHES
    out = stepper.trace_tangent_kernel(te, 1300.0, _p0(), 1.0, _geom(), s)
    assert stepper.TANGENT_LAUNCHES == n0  # CPU tensors: the plain version, no launch
    for a, b in zip(out, got):
        assert torch.equal(a, b)


def _jax_fn(name):
    return {
        "add": lambda x: x + 3.0 * x * x,
        "div": lambda x: (x * x + 1.0) / (x + 2.0),
        "rdiv": lambda x: 1.0 / (x + 2.0),
        "rsqrt": lambda x: jax.lax.rsqrt(x + 2.0),
        "sqrt": lambda x: jnp.sqrt(x + 2.0),
        "sin": lambda x: jnp.sin(x),
        "cos": lambda x: jnp.cos(x),
        "clip": lambda x: jnp.clip(x, -0.5, 0.25),
        "maximum": lambda x: jnp.maximum(x, 0.25),
        "where": lambda x: jnp.where(x > 0.0, x * x, -x),
    }[name]


def _dual_fn(name):
    return {
        "add": lambda x: x + 3.0 * x * x,
        "div": lambda x: (x * x + 1.0) / (x + 2.0),
        "rdiv": lambda x: 1.0 / (x + 2.0),
        "rsqrt": lambda x: D.rsqrt(x + 2.0),
        "sqrt": lambda x: D.sqrt(x + 2.0),
        "sin": lambda x: D.sincos(x)[0],
        "cos": lambda x: D.sincos(x)[1],
        "clip": lambda x: D.clamp(x, -0.5, 0.25),
        "maximum": lambda x: D.maximum(x, 0.25),
        "where": lambda x: D.where(D.value(x) > 0.0, x * x, -x),
    }[name]


@pytest.mark.parametrize(
    "name", ["add", "div", "rdiv", "rsqrt", "sqrt", "sin", "cos", "clip", "maximum", "where"]
)
def test_dual_rules_match_jax_jvp(name):
    """Points inside, outside and ON the clip/max bounds: at a tie JAX's
    maximum/minimum split the tangent 0.5/0.5, and so does the port."""
    x = np.array([-1.0, -0.5, -0.3, 0.0, 0.1, 0.25, 0.7, 1.3])
    t = np.linspace(0.5, 2.0, x.size)
    jv, jt = jax.jvp(_jax_fn(name), (jnp.asarray(x),), (jnp.asarray(t),))  # float64
    jv, jt = np.asarray(jv), np.asarray(jt)
    got = _dual_fn(name)(D.Dual(torch.tensor(x), torch.tensor(t)))
    np.testing.assert_allclose(got.v.numpy(), jv, rtol=1e-14, atol=0)
    np.testing.assert_allclose(got.t.numpy(), jt, rtol=1e-14, atol=0)
    if name in ("clip", "maximum"):
        tie = x == 0.25
        np.testing.assert_array_equal(got.t.numpy()[tie], 0.5 * t[tie])


@pytest.mark.parametrize("poly", ["horner", "clenshaw"])
def test_dual_series_match_jax_jvp(poly):
    """The tangent of a series comes from its own recurrence (not from a
    derivative series)."""
    from pygenray_tpu.ops.cheb import clenshaw as j_clenshaw, horner as j_horner

    coef = np.random.default_rng(3).normal(size=9)
    u = np.linspace(-0.9, 0.9, 7)
    t = np.linspace(1.0, 2.0, 7)
    jf = {"horner": j_horner, "clenshaw": j_clenshaw}[poly]
    jv, jt = jax.jvp(lambda v: jf(v, jnp.asarray(coef)), (jnp.asarray(u),),
                     (jnp.asarray(t),))
    got = getattr(D, poly)(D.Dual(torch.tensor(u), torch.tensor(t)), torch.tensor(coef))
    np.testing.assert_allclose(got.v.numpy(), np.asarray(jv), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(jt), rtol=1e-13, atol=1e-13)
