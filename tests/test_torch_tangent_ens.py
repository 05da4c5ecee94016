"""The ensemble forward-tangent trace (B4) on CPU: the plain version of the
CUDA kernel (``integrate._trace_tangent_ens_impl``), its wrapper
(``ops.stepper.trace_tangent_ensemble_kernel``) and the operands the
wrapper hands the kernel.

* Against the JAX package's ensemble tangent kernel itself
  (``trace_pallas_tangent_ensemble`` in interpret mode, the one
  interpreter run of this file) at float32 with the bounds
  ``tests/test_torch_tangent.py`` holds B2's plain version to: counters and
  death codes exact, T within 1e-4 s, z within 0.1 m, dz and dT within
  2e-3 relative (to |value| + 1e3) on live rays.  Two realizations × 8
  candidates, 10 km, dx = 500 m; as there the monomial (Horner) path is off
  (the interpreter contracts fused multiply-adds where torch does not).
* Row e is the final-state tangent trace (B2's plain version) on
  realization e alone, bit for bit.
* The wrapper on CPU tensors is the plain version; it raises on what the
  kernel does not take.

The kernel itself (``csrc/trace_tangent_ens.cu``) runs only on a card;
``chip_smoke.py`` holds it to this plain version there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu.montecarlo as jmc
import pygenray_tpu_torch.montecarlo as tmc
from pygenray_tpu.integrate import SolverSettings as JSettings
from pygenray_tpu.ops.pallas_stepper import trace_pallas_tangent_ensemble
from pygenray_tpu_torch.envdata import env_member, stack_env_data
from pygenray_tpu_torch.integrate import (
    SolverSettings, _ens_step_data, _plan, _step_data, _trace_tangent_ens_impl,
    _trace_tangent_impl,
)
from pygenray_tpu_torch.ops import stepper
from torch_fixtures import one_blas_thread  # noqa: F401

X1, DX = 10e3, 500.0
ANGLES = np.array([[-20.0, -15.0, -9.0, -3.0, 2.0, 8.0, 14.5, 19.0],
                   [-19.0, -14.5, -8.0, -2.0, 3.0, 9.0, 15.0, 20.0]])


def _geom():
    h, sps, nseg = _plan(0.0, X1, 2, DX)
    return (0.0, X1, h, sps, nseg)


def _p0():
    return np.sin(np.radians(-ANGLES)) / 1500.0


def _tables():
    """Two realizations of a Munk field whose axis slopes in range (16
    Chebyshev terms: the interpreter's cost grows with the terms it
    unrolls)."""
    z, r = np.linspace(0.0, 6000.0, 1024), np.linspace(0.0, X1, 6)
    c = np.array([[jp.munk_ssp(z, sofar_depth=1500 + s * ri) for ri in r] for s in (-0.02, 0.03)])
    return c, r, z, np.full(6, 4600.0), r


@pytest.fixture(scope="module")
def ens_run():
    je = dataclasses.replace(jmc.make_env_ensemble(*_tables(), dtype=jnp.float32), poly_ok=False)
    te = dataclasses.replace(tmc.make_env_ensemble(*_tables(), dtype=torch.float32, device="cpu"),
                             poly_ok=False)
    assert te.has_cheb and te.range_dependent and te.c_cheb.shape == (2, 6, 16)
    ref = trace_pallas_tangent_ensemble(je, 1300.0, jnp.asarray(_p0(), jnp.float32), 1.0, _geom(),
                                        JSettings(dx=DX, kahan=False), interpret=True)
    got = _trace_tangent_ens_impl(te, 1300.0, _p0(), 1.0, _geom(), SolverSettings(dx=DX))
    return te, [np.asarray(a) for a in ref], got


def test_plain_ensemble_tangent_matches_pallas_interpret(ens_run):
    _, ref, got = ens_run
    T, z, p, dT, dz, dp, ns, nb, dc = (a.numpy() for a in got)
    assert T.dtype == np.float32 and T.shape == ANGLES.shape
    for mine, theirs in ((ns, ref[6]), (nb, ref[7]), (dc, ref[8])):
        np.testing.assert_array_equal(mine, theirs)
    assert (ns + nb).sum() > 0  # the crossing fix and its tangent ran
    np.testing.assert_allclose(T, ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z, ref[1], rtol=0, atol=0.1)
    live = dc == 0
    for mine, theirs in ((dz, ref[4]), (dT, ref[3])):
        rel = np.abs(mine - theirs) / (np.abs(theirs) + 1e3)
        assert rel[live].max() < 2e-3


def test_rows_are_the_tangent_trace_on_each_realization(ens_run):
    te, _, got = ens_run
    for e in range(2):
        b2 = _trace_tangent_impl(env_member(te, e), 1300.0, _p0()[e], 1.0, _geom(),
                                 SolverSettings(dx=DX))
        for mine, theirs in zip(got, b2):
            assert torch.equal(mine[e], theirs)


def test_ensemble_wrapper_on_cpu_and_its_operands(ens_run):
    te, _, got = ens_run
    s = SolverSettings(dx=DX)
    n0 = stepper.TANGENT_ENS_LAUNCHES
    out = stepper.trace_tangent_ensemble_kernel(te, 1300.0, _p0(), 1.0, _geom(), s)
    assert stepper.TANGENT_ENS_LAUNCHES == n0
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    # the kernel's operands: each realization's own step rows, stacked
    # (E, nsteps, K); the wrapper takes them from a caller that holds them
    sd = _ens_step_data(te, _geom(), s)
    nsteps, K = _geom()[3] * _geom()[4], te.c_cheb.shape[-1]
    assert all(t.shape == (2, K) and t.is_contiguous() for t in sd.prof0)
    assert all(t.shape == (2, nsteps, K) and t.is_contiguous() for t in (*sd.prof_ms, *sd.prof_1s))
    for e in range(2):
        plain = _step_data(env_member(te, e), _geom(), True, False, False, s.bbox_tol)
        for mine, theirs in zip((*sd.prof0, *sd.prof_ms, *sd.prof_1s),
                                (*plain.prof0, *plain.prof_ms, *plain.prof_1s)):
            assert torch.equal(mine[e], theirs)
        for f in ("b0s", "b1s", "oob_step"):
            assert torch.equal(getattr(sd, f), getattr(plain, f))
    out = stepper.trace_tangent_ensemble_kernel(te, 1300.0, _p0(), 1.0, _geom(), s, sd)
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    # what the kernel does not take
    with pytest.raises(ValueError, match="scalar source depth"):
        stepper.trace_tangent_ensemble_kernel(te, np.full(8, 1300.0), _p0(), 1.0, _geom(), s)
    ri = stack_env_data([dataclasses.replace(env_member(te, e), range_dependent=False)
                         for e in range(2)])
    with pytest.raises(ValueError, match="range-dependent"):
        stepper.trace_tangent_ensemble_kernel(ri, 1300.0, _p0(), 1.0, _geom(), s)
    with pytest.raises(ValueError, match="not covered"):
        stepper.trace_tangent_ensemble_kernel(te.to(dtype=torch.float64), 1300.0, _p0(), 1.0,
                                              _geom(), s)
    deeper = dataclasses.replace(te, bathy=te.bathy + torch.tensor([[0.0], [10.0]]))
    with pytest.raises(ValueError, match="bathymetry"):
        stepper.trace_tangent_ensemble_kernel(deeper, 1300.0, _p0(), 1.0, _geom(), s)


def test_ens_layout_mirrors_the_launcher(ens_run):
    """``stepper.ens_layout`` is the launcher's choice
    (``trace_tangent_ens_layout`` and ``launch_k`` in
    ``csrc/trace_tangent_ens.cu``): K compiled fixed for the spectral fit
    ladder's lengths up to 96, at run time otherwise; 16-byte copies of the
    step rows when K is a multiple of 4 and every table is 16-byte aligned,
    else 4-byte ones.  The step rows ``_ens_step_data`` builds are aligned."""
    import re
    from pathlib import Path

    src = (Path(stepper.__file__).parent.parent / "csrc" / "trace_tangent_ens.cu").read_text()
    cases = [int(k) for k in re.findall(r"case (\d+): return launch<POW, \1>", src)]
    assert tuple(cases) == stepper.ENS_FIXED_K
    assert stepper.ENS_FIXED_K == tuple(o + 1 for o in (15, 23, 31, 47, 63, 95))
    te, _, _ = ens_run
    sd = _ens_step_data(te, _geom(), SolverSettings(dx=DX))
    tables = (*sd.prof_ms, *sd.prof_1s)
    assert stepper.ens_layout(te.c_cheb.shape[-1], tables) == ("fixed", 16)
    flat = torch.zeros(65)
    for K, want in ((64, ("fixed", 16)), (96, ("fixed", 16)), (128, ("run-time", 16)),
                    (31, ("run-time", 4)), (20, ("run-time", 16))):
        assert stepper.ens_layout(K, [flat[:64]] * 4) == want, K
    assert stepper.ens_layout(64, [flat[:64]] * 3 + [flat[1:]]) == ("fixed", 4)
