"""The fan kernel's segment mode (B1d) on CPU: its plain version, its
wrapper and the station rows the wrapper hands the kernel.

The kernel itself (``csrc/trace_fan.cu``, template ``SEG``) runs only on a
card; ``chip_smoke.py`` holds it to its plain version there.  Here the
plain version (``integrate._trace_impl`` on a segment fit) is held to the
JAX package at float32 with ``tests/test_pallas.py``'s bounds (counters,
death codes and ``alive_save`` exact; travel times within 5e-6 s, depths
within 1e-2 m):

* basis "pow" (local Horner) on a smooth Munk profile, range-independent,
  against the JAX segment kernel itself (``trace_pallas`` in interpret
  mode, the one interpreter run of this file: 7 s at 8 terms);
* basis "cheb" (local Clenshaw) on the same profile at the same order,
  against the JAX package's XLA scan.

The range-dependent case, one realization of ``bench.py``'s rough field
(nz = 400, four stations blended per step, basis "cheb", 32 terms), is held
to the JAX package's XLA scan in ``test_torch_montecarlo.py``
(``trace_ensemble`` on the rough ensemble); here its wrapper and the
station rows the kernel blends with.
"""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.integrate import SolverSettings as JSettings, _trace_impl as j_trace_impl
from pygenray_tpu.ops.pallas_stepper import _launch_consts as j_launch_consts, trace_pallas
from pygenray_tpu_torch.envdata import SEG_CHEB_LADDER, SEG_ORDER_LADDER
from pygenray_tpu_torch.integrate import SolverSettings, _plan, _step_data, _trace_impl, trace
from pygenray_tpu_torch.ops import stepper

sys.path.insert(0, str(pathlib.Path(__file__).parent / "fixtures"))
from rough_field import rough_tables  # noqa: E402
from torch_fixtures import one_blas_thread  # noqa: E402, F401

X1, DX = 20e3, 500.0
ANGLES = np.linspace(-16.0, 16.0, 24)


def _geom():
    h, sps, nseg = _plan(0.0, X1, 3, DX)
    return (0.0, X1, h, sps, nseg)


def _rd_args():
    c, r, z = rough_tables(jp.munk_ssp, 1, 400, 4, X1)
    return c[0], r, z, np.full(len(r), 4600.0), r


def _env_pair(kind):
    z = np.linspace(0.0, 6000.0, 400)
    kw = {"interp": "seg"}
    if kind == "rd":
        c, r, z = _rd_args()[:3]
    else:  # Munk, range-independent; "cheb" at the same 8 terms
        r, c = np.array([0.0, X1]), np.outer(np.ones(2), jp.munk_ssp(z))
        if kind == "cheb":
            kw.update(seg_basis="cheb", seg_order=7, seg_exact_order=True)
    args = (c, r, z, np.full(len(r), 4600.0), r)
    je = None if kind == "rd" else jp.make_env_data(*args, dtype=jnp.float32, **kw)
    te = tp.make_env_data(*args, dtype=torch.float32, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def seg_runs():
    out = {}
    p0 = np.sin(np.radians(-ANGLES)) / 1500.0
    for kind in ("pow", "cheb", "rd"):
        je, te = _env_pair(kind)
        assert te.has_seg and not te.has_cheb and te.range_dependent == (kind == "rd")
        assert te.seg_basis == ("pow" if kind == "pow" else "cheb")
        ref = None
        if kind == "pow":
            ref = trace_pallas(je, 1300.0, jnp.asarray(p0, jnp.float32), _geom(), JSettings(dx=DX),
                               interpret=True)
        elif kind == "cheb":
            ref = j_trace_impl(je, 1300.0, jnp.asarray(p0, jnp.float32), _geom(),
                               JSettings(dx=DX, backend="xla"))
        got = _trace_impl(te, 1300.0, p0, _geom(), SolverSettings(dx=DX))
        out[kind] = (je, te, ref, got)
    return out


@pytest.mark.parametrize("kind", ["pow", "cheb"])
def test_plain_segment_trace_matches_jax(kind, seg_runs):
    _, _, ref, got = seg_runs[kind]
    for f in ("n_surf", "n_bott", "death_code", "alive_save"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert int((got.n_surf + got.n_bott).sum()) > 0  # the crossing fix ran
    for f, tol in (("ts", 5e-6), ("zs", 1e-2)):
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f)))
        assert d.max() <= tol, (f, d.max())
    # the launch constants: the segment mode and its domain flags, as the JAX kernel's
    je, te = seg_runs[kind][:2]
    nsteps = _geom()[3] * _geom()[4]
    consts, xoob = stepper._launch_consts(te, SolverSettings(dx=DX), 0.0, _geom()[2], nsteps)
    jc, jx = j_launch_consts(je, JSettings(dx=DX), 0.0, _geom()[2], nsteps, False, False, True)
    np.testing.assert_array_equal(xoob, jx)
    assert consts.seg == jc[18] == (1 if kind == "pow" else 2)


@pytest.mark.parametrize("kind", ["pow", "rd"])
def test_segment_wrapper_on_cpu_is_the_plain_version(kind, seg_runs):
    _, te, _, got = seg_runs[kind]
    s = SolverSettings(dx=DX)
    assert stepper.kernel_supported(te, s) and not stepper.tangent_supported(te, s)
    n0 = stepper.LAUNCHES
    for res in (stepper.trace_kernel(te, 1300.0, np.sin(np.radians(-ANGLES)) / 1500.0, _geom(), s),
                trace(te, 1300.0, np.sin(np.radians(-ANGLES)) / 1500.0, 0.0, X1, 3,
                      dataclasses.replace(s, backend="kernel"))):
        for f in ("ts", "zs", "ps", "n_surf", "n_bott", "death_code", "alive_save", "rs"):
            assert torch.equal(getattr(res, f), getattr(got, f)), f
    assert stepper.LAUNCHES == n0
    # the launch constants: the segment mode and its pick, as the JAX kernel's
    consts, xoob = stepper._launch_consts(te, s, 0.0, _geom()[2], _geom()[3] * _geom()[4])
    assert consts.seg == (1 if kind == "pow" else 2)
    assert consts.seg_zlo == te.z_dom[0] and consts.seg_hinv == 128.0 / (te.z_dom[1] - te.z_dom[0])


def test_segment_station_rows_reproduce_the_plain_blend(seg_runs):
    """Range-dependent: the kernel gets the resident (nr, Ks, S) tables and
    per-step (i, w); blending at a pick, (1 - w) T[i] + w T[i+1], gives the
    plain version's blended tables bit for bit, at the launch range and at
    every step's middle and end."""
    _, te, _, _ = seg_runs["rd"]
    s = SolverSettings(dx=DX)
    inp = stepper._inputs(te, 1300.0, np.zeros(3), _geom(), s)
    assert inp.rd and inp.rows == () and inp.ccoef.shape == te.c_seg.shape
    assert inp.st_i.dtype == torch.int32 and inp.st_i.shape == (2 * _geom()[3] * _geom()[4] + 1,)
    sd = _step_data(te, _geom(), False, False, True, s.bbox_tol)
    i, w = inp.st_i.long(), inp.st_w
    for tab, blended in ((te.c_seg, (sd.prof0[0], sd.prof_ms[0], sd.prof_1s[0])),
                         (te.dcdz_seg, (sd.prof0[1], sd.prof_ms[1], sd.prof_1s[1]))):
        picks = (1.0 - w)[:, None, None] * tab[i] + w[:, None, None] * tab[i + 1]
        assert torch.equal(picks[0], blended[0])
        assert torch.equal(picks[1::2], blended[1]) and torch.equal(picks[2::2], blended[2])


_CSRC = pathlib.Path(stepper.__file__).resolve().parent.parent / "csrc" / "trace_fan.cu"


def _c_define(name):
    """The value of ``#define name`` in the fan kernel's source."""
    line = next(ln for ln in _CSRC.read_text().splitlines() if ln.startswith(f"#define {name} "))
    return eval(line.split(None, 2)[2].split("//")[0])  # an integer expression


def _with_terms(env, K):
    """``env`` with zero (nr, K, S) segment tables: the fan kernel's support
    and layout depend on the tables' shape, not their values."""
    z = torch.zeros(env.c_seg.shape[0], K, env.c_seg.shape[-1])
    return dataclasses.replace(env, c_seg=z, dcdz_seg=z.clone(),
                               seg_basis="pow" if K <= max(SEG_ORDER_LADDER) + 1 else "cheb")


def test_segment_layout_mirrors_the_launcher():
    """``stepper.seg_layout`` is the launcher's choice (``seg_layout`` in
    ``csrc/trace_fan.cu``) with the C limits: two buffers of a step's four
    (K, S) float32 tables in shared memory when they fit the limit, else one,
    else none (each pick blends from device memory); S other than 128 takes
    none.  At S = 128 the ladders' K up to 48 take two, 64 and 96 one."""
    assert stepper.MAX_SEG_SMEM == _c_define("TF_MAX_SEG_SMEM")
    assert stepper.SEG_SMEM_S == _c_define("TF_SEG_S")
    assert [_c_define(f"TF_SEG_{n.upper()}") for n in stepper.SEG_LAYOUTS] == [0, 1, 2]
    for K in [o + 1 for o in SEG_ORDER_LADDER + SEG_CHEB_LADDER] + [128, 256]:
        step = 4 * K * 128 * 4
        want = ("double" if 2 * step <= stepper.MAX_SEG_SMEM else
                "single" if step <= stepper.MAX_SEG_SMEM else "pick")
        assert stepper.seg_layout(K, 128) == want, K
        assert stepper.seg_layout(K, 64) == "pick"
    assert [stepper.seg_layout(K, 128) for K in (8, 12, 16, 24, 32, 48, 64, 96, 128)] == (
        ["double"] * 6 + ["single"] * 2 + ["pick"])


def test_kernel_supported_takes_every_segment_rung():
    """Every rung of both fit ladders, range-dependent, and an exact-order
    fit above them go to the fan kernel (``seg_layout`` finds each a
    place); what no layout takes is refused and the wrapper raises on it: a
    range-independent fit whose two tables pass ``MAX_SEG_SMEM`` (256
    terms), and a float64 fit."""
    _, te = _env_pair("rd")
    s = SolverSettings(dx=DX)
    assert te.range_dependent and te.has_seg
    for K in [o + 1 for o in SEG_ORDER_LADDER + SEG_CHEB_LADDER] + [256]:
        env = _with_terms(te, K)
        assert stepper.kernel_supported(env, s) and not stepper.tangent_supported(env, s), K
    _, te_ri = _env_pair("pow")
    assert stepper.kernel_supported(_with_terms(te_ri, 96), s)
    te64 = tp.make_env_data(*_rd_args(), dtype=torch.float64, device="cpu", interp="seg")
    assert te64.has_seg
    for env in (_with_terms(te_ri, 256), te64):
        assert not stepper.kernel_supported(env, s)
        with pytest.raises(ValueError, match="not covered"):
            stepper.trace_kernel(env, 1300.0, np.zeros(2), _geom(), s)
