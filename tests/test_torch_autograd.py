"""Autograd through ``trace()`` over the launch parameters.

Counterparts of ``tests/test_custom_jvp.py``: reverse mode
(``torch.autograd.grad``), forward mode (``torch.autograd.forward_ad``,
``torch.func.jvp`` / ``jacfwd``) and ``torch.func.vmap`` over ``p0`` and
``z0`` must ride the save-grid tangent trace (``integrate._TraceLaunchAD``
calling ``ops.stepper.trace_tangent_save_kernel``: on CPU tensors its plain
version, on a card the CUDA kernel), one trace per seeded direction, and
must match ``jax.jvp`` through the JAX package's scan without Kahan, the
reference ``tests/test_custom_jvp.py`` itself uses.  A derivative over a
tensor of the environment has no kernel and goes through the torch-op loop
by plain autograd.

Tolerances, float32 on the same numpy inputs: primal within 5e-6 s as there;
tangents within 2e-4 of the largest tangent (there 3e-5 between two JAX
graphs; the port rounds its Horner steps apart from XLA's fused ones, which
shows up to 7e-5), 1e-3 on the bouncing fan as there.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu_torch.integrate import SolverSettings, trace
from pygenray_tpu_torch.ops import stepper
from torch_scan_reference import B, DX, NUM_SAVE, X1, jax_env, port_env, scan_jvp
from torch_fixtures import one_blas_thread  # noqa: F401

# short and coarse: the plain Dual loop costs ~20 ms a step on a CPU.  The
# case is torch_scan_reference.py's (a range-dependent Munk field over a
# flat bottom at 4600 m), whose compiled reference test_torch_tangent_save.py
# shares
Z0 = 1300.0
S = SolverSettings(dx=DX)
ANGLES = np.linspace(-8.0, 8.0, B)  # refracted: no boundary touched
BOUNCING = np.linspace(24.0, 30.0, B)  # up to the surface, then down to the bottom


def _p0(angles):
    return np.sin(np.radians(-np.asarray(angles))) / 1500.0


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def envs():
    """(JAX environment, the same one carried into the port)"""
    je = jax_env("rd")
    return je, port_env(je)


@pytest.fixture(scope="module")
def jax_jvp():
    """``jax.jvp`` of the JAX package's scan (no Kahan) over ``(z0, p0)``:
    returns ``(ts, dts)``, each (B, NUM_SAVE), as numpy."""

    def run(env, angles, dp0=0.0, dz0=0.0):
        out = scan_jvp(env, Z0, _p0(angles), dp0, dz0)
        return out[0], out[3]

    return run


@pytest.fixture
def launches(monkeypatch):
    """Counts the calls of the save-grid tangent wrapper."""
    calls = []
    real = stepper.trace_tangent_save_kernel

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(stepper, "trace_tangent_save_kernel", counting)
    return calls


def test_grad_reverse_mode_rides_the_tangent_trace(envs, jax_jvp, launches):
    je, te = envs
    p0 = _t(_p0(ANGLES), requires_grad=True)
    res = trace(te, Z0, p0, 0.0, X1, NUM_SAVE, S)
    (g,) = torch.autograd.grad(res.ts[:, -1].sum(), p0)
    assert len(launches) == 1
    # each ray depends on its own p0 only: the gradient of the sum is the
    # diagonal, the scan's tangent for a unit seed
    ts_x, dts_x = jax_jvp(je, ANGLES, dp0=1.0)
    np.testing.assert_allclose(res.ts.detach().numpy(), ts_x, atol=5e-6)
    scale = np.abs(dts_x[:, -1]).max()
    np.testing.assert_allclose(g.numpy(), dts_x[:, -1], atol=2e-4 * scale)
    assert not res.n_bott.requires_grad and not res.alive_save.requires_grad


def test_forward_mode_matches_scan_jvp(envs, jax_jvp, launches):
    je, te = envs
    v = np.linspace(0.5, 1.5, B)
    with fwAD.dual_level():
        res = trace(te, Z0, fwAD.make_dual(_t(_p0(ANGLES)), _t(v)), 0.0, X1, NUM_SAVE, S)
        ts, dts = fwAD.unpack_dual(res.ts)
    assert len(launches) == 1
    ts_x, dts_x = jax_jvp(je, ANGLES, dp0=v)
    np.testing.assert_allclose(ts.numpy(), ts_x, atol=5e-6)
    np.testing.assert_allclose(dts.numpy(), dts_x, atol=2e-4 * np.abs(dts_x).max())
    # torch.func.jvp rides the same rule
    ts_f, dts_f = torch.func.jvp(lambda p: trace(te, Z0, p, 0.0, X1, NUM_SAVE, S).ts,
                                 (_t(_p0(ANGLES)),), (_t(v),))
    assert len(launches) == 2
    assert torch.equal(ts_f, ts) and torch.equal(dts_f, dts)


def test_full_trace_result_tangent_structure(envs, launches):
    """The tangent covers the whole save grid; the integer and boolean
    outputs carry none; the primal is the forward trace without Kahan."""
    _, te = envs
    p0 = _t(_p0(ANGLES))
    with fwAD.dual_level():
        res = trace(te, Z0, fwAD.make_dual(p0, torch.ones(B)), 0.0, X1, 7, S)
        prim = {f: fwAD.unpack_dual(getattr(res, f)) for f in ("ts", "zs", "ps", "n_bott", "alive")}
    assert prim["ts"].primal.shape == (B, 7) == prim["ts"].tangent.shape
    # t(x0) = 0 whatever p0; interior and final tangents nonzero
    assert torch.equal(prim["ts"].tangent[:, 0], torch.zeros(B))
    assert bool((prim["ts"].tangent[:, 1:].abs() > 0).all())
    assert torch.equal(prim["ps"].tangent[:, 0], torch.ones(B))
    assert prim["n_bott"].tangent is None and prim["alive"].tangent is None
    ref = trace(te, Z0, p0, 0.0, X1, 7, dataclasses.replace(S, kahan=False))
    for f in ("ts", "zs", "ps"):
        assert torch.equal(prim[f].primal, getattr(ref, f)), f
    for f in ("n_bott", "n_surf", "death_code", "alive_save", "alive", "rs"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert bool(res.alive.all())


def test_jacfwd_single_launch(envs, launches):
    """jacfwd maps the linear rule over tangent directions: the trace still
    runs once (the diagonal trick); vmap over the launch tensors joins the
    mapped dimension to the rays of one launch."""
    _, te = envs
    p0 = _t(_p0(ANGLES))
    J = torch.func.jacfwd(lambda p: trace(te, Z0, p, 0.0, X1, NUM_SAVE, S).ts[:, -1])(p0)
    assert len(launches) == 1
    off = J - torch.diag(torch.diagonal(J))
    assert torch.equal(off, torch.zeros(B, B))  # per-ray dependence is diagonal
    assert bool((torch.diagonal(J).abs() > 0).all())
    ts = torch.func.vmap(lambda p: trace(te, Z0, p, 0.0, X1, NUM_SAVE, S).ts)(
        torch.stack([p0, -p0]))
    assert len(launches) == 2 and ts.shape == (2, B, NUM_SAVE)
    ref = trace(te, Z0, p0, 0.0, X1, NUM_SAVE, dataclasses.replace(S, kahan=False)).ts
    assert torch.equal(ts[0], ref) and torch.equal(ts[1].flip(0), ref)  # a symmetric fan


def test_bouncing_rays_tangent_matches_scan(envs, jax_jvp):
    """Steep rays reflecting off surface and bottom: the crossing fix's
    tangent tracks the scan's (tests/test_custom_jvp.py's 1e-3)."""
    je, te = envs
    ts_k, dts_k = torch.func.jvp(lambda p: trace(te, Z0, p, 0.0, X1, NUM_SAVE, S).ts[:, -1],
                                 (_t(_p0(BOUNCING)),), (torch.ones(B),))
    ts_x, dts_x = jax_jvp(je, BOUNCING, dp0=1.0)
    np.testing.assert_allclose(ts_k.numpy(), ts_x[:, -1], atol=5e-6)
    np.testing.assert_allclose(dts_k.numpy(), dts_x[:, -1], atol=1e-3 * np.abs(dts_x[:, -1]).max())
    res = trace(te, Z0, _p0(BOUNCING), 0.0, X1, NUM_SAVE, S)
    assert int(res.n_bott.min()) >= 1 and int(res.n_surf.min()) >= 1


def test_env_gradient_falls_back_to_the_torch_op_loop(envs, monkeypatch):
    """A gradient on a tensor of the environment has no kernel: the trace
    goes through the torch-op loop under plain autograd and never calls the
    tangent wrapper."""
    _, te = envs

    def boom(*a, **k):
        raise AssertionError("tangent trace dispatched for an environment gradient")

    monkeypatch.setattr(stepper, "trace_tangent_save_kernel", boom)
    c_cheb = te.c_cheb.clone().requires_grad_(True)
    env = dataclasses.replace(te, c_cheb=c_cheb, poly_ok=False)
    res = trace(env, Z0, _p0(ANGLES[:5]), 0.0, 5e3, 2, S)
    (g,) = torch.autograd.grad(res.ts[:, -1].sum(), c_cheb)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    # so does backend="ops", over p0
    p0 = _t(_p0(ANGLES[:5]), requires_grad=True)
    res = trace(te, Z0, p0, 0.0, 5e3, 2, dataclasses.replace(S, backend="ops"))
    (g,) = torch.autograd.grad(res.ts[:, -1].sum(), p0)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())


def test_z0_tangent_rides_the_trace_and_matches_scan(envs, jax_jvp, launches):
    """Source-depth sensitivity (localization): a z0 tangent seeds the same
    trace through its dz0 operand."""
    je, te = envs
    ts_k, dts_k = torch.func.jvp(lambda z: trace(te, z, _p0(ANGLES), 0.0, X1, NUM_SAVE, S).ts,
                                 (_t(Z0),), (_t(1.0),))
    assert len(launches) == 1  # one launch for the one seeded direction
    ts_x, dts_x = jax_jvp(je, ANGLES, dz0=1.0)
    np.testing.assert_allclose(ts_k.numpy(), ts_x, atol=5e-6)
    np.testing.assert_allclose(dts_k.numpy(), dts_x, atol=2e-4 * np.abs(dts_x).max())


def test_joint_p0_z0_tangent_two_launches(envs, launches):
    """Seeding both launch parameters costs exactly two traces and the
    tangents add linearly."""
    _, te = envs
    p0, z0, v = _t(_p0(ANGLES)), _t(Z0), _t(np.linspace(0.5, 1.5, B))
    f = lambda z, p: trace(te, z, p, 0.0, X1, NUM_SAVE, S).ts[:, -1]
    _, d_joint = torch.func.jvp(f, (z0, p0), (_t(0.7), v))
    assert len(launches) == 2
    _, d_z = torch.func.jvp(lambda z: f(z, p0), (z0,), (_t(0.7),))
    _, d_p = torch.func.jvp(lambda p: f(z0, p), (p0,), (v,))
    assert len(launches) == 4
    np.testing.assert_allclose(d_joint.numpy(), (d_z + d_p).numpy(), rtol=1e-6, atol=1e-12)


def test_grad_over_z0(envs, jax_jvp, launches):
    """Reverse mode over a scalar source depth sums the per-ray dT/dz0
    against the cotangent; over a (B,) depth it gives them one by one."""
    je, te = envs
    z0 = _t(Z0, requires_grad=True)
    (g,) = torch.autograd.grad(trace(te, z0, _p0(ANGLES), 0.0, X1, NUM_SAVE, S).ts[:, -1].sum(), z0)
    assert len(launches) == 1 and g.shape == ()
    _, dts_x = jax_jvp(je, ANGLES, dz0=1.0)
    np.testing.assert_allclose(float(g), dts_x[:, -1].sum(), rtol=3e-4)
    zb = torch.full((B,), Z0, requires_grad=True)
    (gb,) = torch.autograd.grad(trace(te, zb, _p0(ANGLES), 0.0, X1, NUM_SAVE, S).ts[:, -1].sum(), zb)
    np.testing.assert_allclose(gb.numpy(), dts_x[:, -1], atol=2e-4 * np.abs(dts_x[:, -1]).max())


def _env64():
    """A float64 Munk field over a flat bottom at 4500 m: outside the
    kernel's coverage."""
    z = np.linspace(0.0, 6000.0, 1024)  # 16 Chebyshev terms
    r = np.linspace(0.0, X1, 8)
    return tp.make_env_data(np.outer(np.ones(8), jp.munk_ssp(z)), r, z, np.full(8, 4500.0), r,
                            dtype=torch.float64, device="cpu")


def test_backend_kernel_raises_under_differentiation(envs):
    """``backend="kernel"`` raises on what the kernel does not cover, with a
    derivative asked for as without one: float64, an environment gradient."""
    s_k = dataclasses.replace(S, backend="kernel")
    p64 = torch.tensor(_p0(ANGLES[:3]), dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="unsupported"):
        trace(_env64(), Z0, p64, 0.0, 2e3, 3, s_k)
    with pytest.raises(ValueError, match="unsupported"):
        trace(_env64(), Z0, p64.detach(), 0.0, 2e3, 3, s_k)
    te = envs[1]
    env = dataclasses.replace(te, c_cheb=te.c_cheb.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="unsupported"):
        trace(env, Z0, _p0(ANGLES[:3]), 0.0, 2e3, 3, s_k)
    # float32 on CPU tensors: the wrapper's plain version, as without a derivative
    p0 = _t(_p0(ANGLES), requires_grad=True)
    res = trace(te, Z0, p0, 0.0, 2e3, 3, s_k)
    assert res.ts.requires_grad


def test_gradcheck_float64():
    """``torch.autograd.gradcheck`` (reverse and forward mode, its fast mode:
    random projections of the Jacobian instead of every column) in float64 on
    three rays over a short range (one off the bottom, one off the surface):
    float64 is outside the kernel's coverage, so the rule runs the plain Dual
    loop."""
    te = _env64()
    s = SolverSettings(dx=DX)
    # gradcheck perturbs every input by one eps: p0 ~ 1e-4 s/m enters in
    # micro-units so that 1e-5 suits it and the depth [m] alike
    q0 = torch.tensor(1e6 * _p0([-30.0, 2.0, 28.0]), dtype=torch.float64, requires_grad=True)
    z0 = torch.tensor([4200.0, 900.0, 300.0], dtype=torch.float64, requires_grad=True)

    def f(z, q):
        r = trace(te, z, 1e-6 * q, 0.0, 2e3, 3, s)
        return r.ts, r.zs, 1e6 * r.ps

    r = trace(te, z0, 1e-6 * q0, 0.0, 2e3, 3, s)
    assert int(r.n_bott.sum()) >= 1 and int(r.n_surf.sum()) >= 1 and bool(r.alive.all())
    assert torch.autograd.gradcheck(f, (z0, q0), eps=1e-5, atol=1e-6, rtol=1e-5,
                                    check_forward_ad=True, fast_mode=True)
