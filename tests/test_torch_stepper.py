"""The CUDA trace kernel's wrapper, support test and plain version, on CPU.

The kernel itself (``pygenray_tpu_torch/csrc/trace_fan.cu``) runs only on a
CUDA card; ``chip_smoke.py`` holds it against its plain version there.  Here
the wrapper, on CPU tensors, runs that plain version, which must reproduce
the JAX package at float32 with ``tests/test_pallas.py``'s tolerances:
counters, death codes and ``alive_save`` exact, travel times within 5e-6 s
(1e-5 s with a Chebyshev bottom angle).  The flat-bottom case runs the JAX
package's Pallas kernel itself (``trace_pallas`` in interpret mode, one run:
the interpreter is slow); the curved-bottom case runs the JAX package's
scan, the plain reference its own kernel tests use.  As there, the
monomial (Horner) path is disabled (``poly_ok=False``): the interpreter
contracts fused multiply-adds where torch does not, and the ulp-level
difference grows along multi-bounce rays.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.integrate import (
    SolverSettings as JSettings,
    _trace_impl as j_trace_impl,
    _use_cheb as j_use_cheb,
)
from pygenray_tpu.ops.pallas_stepper import (
    _launch_consts as j_launch_consts,
    pallas_supported,
    tangent_supported as j_tangent_supported,
    trace_pallas,
)
from pygenray_tpu_torch.integrate import SolverSettings, _plan, _trace_impl, trace
from pygenray_tpu_torch.ops import _build, stepper
from pygenray_tpu_torch.ops.stepper import (
    _launch_consts,
    kernel_supported,
    tangent_supported,
    trace_kernel,
    trace_tangent_kernel,
)
from torch_fixtures import one_blas_thread  # noqa: F401


def _tables(kind):
    rng = np.random.default_rng(5)
    nr = 8
    r = np.linspace(0.0, 100e3, nr)
    z = np.linspace(0.0, 6000.0, 512)
    c = np.outer(np.ones(nr), jp.munk_ssp(z))
    bathy, bathy_r = np.full(nr, 4600.0), r
    kw = {}
    if kind == "curved":
        bathy = 4400.0 + 300.0 * np.sin(r / 12e3)
    elif kind == "rd":
        c = np.array([jp.munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r])
    elif kind == "table":
        kw["interp"] = "table"
    elif kind == "seg":
        c, r, bathy, bathy_r = c[:2], r[[0, -1]], bathy[:2], r[[0, -1]]
        kw["interp"] = "seg"
    elif kind == "spline":
        bathy_r = np.linspace(0.0, 100e3, 40)
        bathy = 4400.0 + rng.uniform(0.0, 400.0, 40)
    return (c, r, z, bathy, bathy_r), kw


def env_pair(kind, dtype="float32", no_pow=False):
    args, kw = _tables(kind)
    je = jp.make_env_data(*args, dtype=jnp.dtype(dtype), **kw)
    te = tp.make_env_data(*args, dtype=getattr(torch, dtype), device="cpu", **kw)
    if no_pow:
        je = dataclasses.replace(je, poly_ok=False)
        te = dataclasses.replace(te, poly_ok=False)
    return je, te


@pytest.mark.parametrize(
    "kind,angles,kahan,ts_atol",
    [
        # bouncing fan plus test_pallas.py's death angles (code 1) and a
        # source below the domain (code 2)
        ("flat", np.concatenate([np.linspace(-18, 18, 92), [-90.0, -89.0, -45.0, 0.0]]),
         True, 5e-6),
        # Chebyshev bottom angle, Kahan off; test_pallas.py's sloped-bottom
        # tolerance (sin/cos of the bottom angle round differently)
        ("curved", np.linspace(-20, 20, 64), False, 1e-5),
    ],
)
def test_plain_version_matches_pallas_interpret(kind, angles, kahan, ts_atol):
    je, te = env_pair(kind, no_pow=True)
    x1, num_save, dx = 20e3, 5, 200.0
    h, sps, nseg = _plan(0.0, x1, num_save, dx)
    geom = (0.0, x1, h, sps, nseg)
    z0 = np.full(len(angles), 1300.0)
    z0[-1] = 6500.0  # below z_dom: dead at launch
    c_src = np.interp(1300.0, np.asarray(je.z), np.asarray(je.c[0]))
    p0 = np.sin(np.radians(-angles)) / c_src
    jz0, jp0 = jnp.asarray(z0, jnp.float32), jnp.asarray(p0, jnp.float32)
    if kind == "flat":
        ref = trace_pallas(je, jz0, jp0, geom, JSettings(dx=dx, kahan=kahan), interpret=True)
    else:
        ref = j_trace_impl(je, jz0, jp0, geom, JSettings(dx=dx, kahan=kahan, backend="xla"))
    n0 = stepper.LAUNCHES
    out = trace_kernel(te, z0, p0, geom, SolverSettings(dx=dx, kahan=kahan))
    assert stepper.LAUNCHES == n0  # CPU tensors: the plain version, no launch
    assert out.ts.dtype == torch.float32 and out.ts.shape == (len(angles), num_save)
    for f in ("n_surf", "n_bott", "death_code", "alive", "alive_save"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(out, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(ref.ts), out.ts.numpy(), rtol=0, atol=ts_atol)
    np.testing.assert_allclose(np.asarray(ref.zs), out.zs.numpy(), rtol=0, atol=1e-2)
    np.testing.assert_allclose(np.asarray(ref.rs), out.rs.numpy(), rtol=0, atol=0)
    codes = set(out.death_code.tolist())
    assert 5 not in codes  # no calm blocks in the port
    if kind == "flat":
        assert {1, 2} <= codes and int(out.n_bott.sum()) > 0
    else:
        assert te.bangle_mode == "cheb" and int(out.n_bott.sum()) > 0


def test_trace_kernel_cpu_is_the_torch_op_loop():
    _, te = env_pair("flat")
    assert te.poly_ok  # the Horner variant
    h, sps, nseg = _plan(0.0, 10e3, 3, 500.0)
    geom = (0.0, 10e3, h, sps, nseg)
    p0 = np.sin(np.radians(np.linspace(-15, 15, 10))) / 1500.0
    s = SolverSettings(dx=500.0)
    a = trace_kernel(te, 1300.0, p0, geom, s)
    b = trace(te, 1300.0, p0, 0.0, 10e3, 3, dataclasses.replace(s, backend="ops"))
    c = _trace_impl(te, 1300.0, p0, geom, s)
    for f in ("ts", "zs", "ps", "n_surf", "n_bott", "death_code", "alive_save", "rs"):
        assert torch.equal(getattr(a, f), getattr(b, f)) and torch.equal(getattr(a, f), getattr(c, f))


def test_trace_kernel_cpu_range_dependent_is_the_torch_op_loop():
    """The range-dependent fan (per-step station rows) on CPU tensors: the
    wrapper runs the plain version, which reads the same rows the kernel
    is given (``integrate._step_data``)."""
    _, te = env_pair("rd")
    assert te.range_dependent
    s = SolverSettings(dx=500.0, kahan=False)
    assert kernel_supported(te, s)
    h, sps, nseg = _plan(0.0, 10e3, 3, 500.0)
    geom = (0.0, 10e3, h, sps, nseg)
    p0 = np.sin(np.radians(np.linspace(-15, 15, 10))) / 1500.0
    n0 = stepper.LAUNCHES
    a = trace_kernel(te, 1300.0, p0, geom, s)
    assert stepper.LAUNCHES == n0
    b = _trace_impl(te, 1300.0, p0, geom, s)
    for f in ("ts", "zs", "ps", "n_surf", "n_bott", "death_code", "alive_save", "rs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    inp = stepper._inputs(te, 1300.0, p0, geom, s)
    assert len(inp.rows) == 4 and all(r.shape == (sps * nseg, te.c_cheb.shape[-1])
                                      for r in inp.rows)


def test_fan_result_reads_the_kernels_layout():
    """The CUDA branch's result assembly (``stepper._fan_result``), given the
    plain version's arrays as the range-independent fan kernel writes them —
    (B, nseg+1) save grids, the (B,) counters and death codes, and each
    ray's first dead save index — is the plain version's ``TraceResult``,
    field for field."""
    _, te = env_pair("flat")
    x0, x1 = 1234.5, 20e3
    h, sps, nseg = _plan(x0, x1, 5, 500.0)
    geom = (x0, x1, h, sps, nseg)
    angles = np.array([-89.0, -45.0, -12.0, 0.0, 12.0, 30.0, 0.0])
    z0 = np.full(len(angles), 1300.0)
    z0[-1] = 6500.0  # below z_dom: dead at launch
    p0 = np.sin(np.radians(-angles)) / 1500.0
    ref = _trace_impl(te, z0, p0, geom, SolverSettings(dx=500.0))
    dseg = ref.alive_save.sum(1, dtype=torch.int32)  # alive_save: alive, then dead
    assert {0, 1, nseg + 1} <= set(dseg.tolist()) and {1, 2} <= set(ref.death_code.tolist())
    got = stepper._fan_result(x0, x1, ref.ts.clone(), ref.zs.clone(), ref.ps.clone(), ref.n_surf,
                              ref.n_bott, ref.death_code, dseg)
    assert got.ts.shape == (len(angles), nseg + 1)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_fan_saves_in_rows_mirrors_the_kernel():
    """``stepper.fan_saves_in_rows`` is the kernel's choice of save layout
    (``ROWS`` in ``csrc/trace_fan.cu``): (B, nseg+1) rows in the
    range-independent spectral mode, (nseg+1, B) columns in the block-wide
    ones (range-dependent, segment fits)."""
    import re
    from pathlib import Path

    src = (Path(stepper.__file__).parent.parent / "csrc" / "trace_fan.cu").read_text()
    assert re.findall(r"constexpr bool ROWS = (.*);", src) == ["SEG == 0 && !RD"]
    for seg in (0, 1, 2):
        for rd in (False, True):
            assert stepper.fan_saves_in_rows(seg, rd) == (seg == 0 and not rd), (seg, rd)


def _settings(**kw):
    return JSettings(**kw), SolverSettings(**kw)


@pytest.mark.parametrize(
    "kind,dtype,skw,expect",
    [
        ("flat", "float32", {}, (True, True)),  # Horner, constant bottom angle
        ("curved", "float32", {}, (True, True)),  # Chebyshev bottom angle
        ("flat", "float32", {"kahan": False, "terminate_backwards": False}, (True, True)),
        ("flat", "float64", {}, (False, False)),  # f64: the torch-op loop
        ("flat", "float32", {"interp": "table"}, (False, False)),
        ("rd", "float32", {}, (True, True)),  # range-dependent: per-step rows (B1c)
        ("seg", "float32", {}, (True, False)),  # segment mode: the fan kernel only (B1d)
        ("table", "float32", {}, (False, False)),
        ("spline", "float32", {}, (False, False)),  # spline bottom angle
    ],
)
def test_kernel_supported_truth_table(kind, dtype, skw, expect):
    """``kernel_supported`` (the fan kernel) is the JAX package's
    ``pallas_supported`` and ``tangent_supported`` (the tangent kernels,
    spectral only) its ``tangent_supported``.  For a range-dependent
    segment fit ``pallas_supported`` also asks ``seg_kernel_ok`` whether
    the station tables fit the TPU's vector memory (2 nr Ks S floats under
    6 MB); the CUDA kernel reads them from device memory, so the port
    admits the larger fits that cap refuses."""
    je, te = env_pair(kind, dtype)
    js, ts = _settings(**skw)
    use_cheb = j_use_cheb(je, js)
    assert kernel_supported(te, ts) == pallas_supported(je, js, use_cheb) == expect[0]
    assert tangent_supported(te, ts) == j_tangent_supported(je, js, use_cheb) == expect[1]
    if not expect[0]:
        with pytest.raises(ValueError):
            trace_kernel(te, 1300.0, np.zeros(2), (0.0, 1e3, 500.0, 1, 2), ts)
        with pytest.raises(ValueError, match="unsupported"):
            trace(te, 1300.0, np.zeros(2), 0.0, 1e3, 2, dataclasses.replace(ts, backend="kernel"))
    if not expect[1]:
        with pytest.raises(ValueError):
            trace_tangent_kernel(te, 1300.0, np.zeros(2), 1.0, (0.0, 1e3, 500.0, 1, 2), ts)


def test_kernel_supported_needs_the_fit_it_is_asked_for():
    _, te = env_pair("table")
    with pytest.raises(ValueError, match="no Chebyshev fit"):
        kernel_supported(te, SolverSettings(interp="cheb"))


@pytest.mark.parametrize("kind,x1", [("flat", 100e3), ("curved", 120e3)])
def test_launch_consts_match_pallas(kind, x1):
    je, te = env_pair(kind)
    js, ts = _settings(dx=200.0, bbox_tol=1e-5)
    h, sps, nseg = _plan(0.0, x1, 12, 200.0)
    jc, jx = j_launch_consts(je, js, 0.0, h, sps * nseg, False, bool(je.poly_ok))
    tc, tx = _launch_consts(te, ts, 0.0, h, sps * nseg)
    np.testing.assert_array_equal(jx, tx)
    (zlo, zhi, sc, off, sin_lim, btol, _, _, s2b, c2b, mode, b_rlo, b_rhi, term_back,
     any_x_oob, _, use_pow, kahan, _) = jc
    assert (tc.zlo_m, tc.zhi_p) == (zlo - btol, zhi + btol)
    assert (tc.sc, tc.off, tc.sin_lim, tc.s2b, tc.c2b) == (sc, off, sin_lim, s2b, c2b)
    assert (tc.b_sum, tc.b_span) == (b_rlo + b_rhi, b_rhi - b_rlo)
    assert tc.bangle_cheb == (mode == "cheb")
    assert (tc.term_back, tc.any_x_oob, tc.use_pow, tc.kahan) == (
        term_back, any_x_oob, use_pow, kahan)
    assert tc.any_x_oob == (x1 > 100e3)


def test_build_requires_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_flags_and_source_hash(monkeypatch):
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert not any("fast_math" in f for f in flags)
    assert _build.sources() == ["trace_coef_tangent", "trace_fan", "trace_tangent",
                                "trace_tangent_ens", "trace_tangent_save"]
    for name in _build.sources():
        src = (_build.CSRC / f"{name}.cu").read_text()
        entry = f'extern "C" int {name}_f32('
        assert entry in src
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path == _build.library_path(name)
        monkeypatch.setattr(_build, "NVCC_FLAGS", flags + ("-lineinfo",))
        assert _build.library_path(name) != path
        monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
        # one ctypes argument type per C parameter
        params = src.split(entry)[1].split(")")[0].split(",")
        assert len(params) == len(stepper._ARGTYPES[f"{name}_f32"])
    # the shared headers: the step (tangent_step.cuh over dual.cuh), the
    # step rows staged by asynchronous copies (stage_rows.cuh, B2-B4) and the
    # body of the final-state and save-grid tangent kernels
    # (tangent_trace.cuh, B2 and B3); each is in every library's hash
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == [
        "dual.cuh", "stage_rows.cuh", "tangent_step.cuh", "tangent_trace.cuh"]
    for name in ("trace_tangent", "trace_tangent_ens", "trace_tangent_save"):
        assert '#include "stage_rows.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    for name in ("trace_tangent", "trace_tangent_save"):
        assert '#include "tangent_trace.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    for header in sorted(p.name for p in _build.CSRC.glob("*.cuh")):
        before = {name: _build.library_path(name) for name in _build.sources()}
        read = _build.Path.read_bytes
        monkeypatch.setattr(_build.Path, "read_bytes",
                            lambda self, h=header: read(self) + (b"//" if self.name == h else b""))
        assert all(_build.library_path(name) != path for name, path in before.items()), header
        monkeypatch.setattr(_build.Path, "read_bytes", read)


def test_step_geometry_is_the_plain_versions():
    """The fan and coefficient-tangent kernels' per-step inputs (bathymetry
    at each step's ends, station intervals) are the numbers of the plain
    version's per-range evaluations, and a field with new coefficients on
    the same stations (an inversion's iterate, which reuses them) has the
    same ones."""
    from pygenray_tpu_torch.integrate import _station_iw, _step_ranges
    from pygenray_tpu_torch.ops.interp import linear_interp

    _, te = env_pair("rd")
    h, sps, nseg = _plan(1234.5, 60e3, 3, 500.0)
    geom = (1234.5, 60e3, h, sps, nseg)

    xs0, xsm, xs1 = _step_ranges(te, geom)
    bathy = lambda x: linear_interp(x, te.bathy_r, te.bathy, te.uniform_bathy_r)
    iw = [_station_iw(te, x) for x in (torch.full((), geom[0]), xsm, xs1)]
    st_i = torch.cat([iw[0][0].reshape(1), torch.stack([iw[1][0], iw[2][0]], 1).reshape(-1)])
    st_w = torch.cat([iw[0][1].reshape(1), torch.stack([iw[1][1], iw[2][1]], 1).reshape(-1)])

    got = stepper.step_geometry(te, geom)
    for a, b in zip(got, (bathy(xs0), bathy(xs1), st_i.to(torch.int32), st_w)):
        assert a.is_contiguous() and torch.equal(a, b)
    iterate = dataclasses.replace(te, c_cheb=te.c_cheb + 1.0)
    assert all(torch.equal(a, b) for a, b in zip(stepper.step_geometry(iterate, geom), got))
