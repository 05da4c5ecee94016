"""The port's example demos (``examples/torch_port/``).

* Structure (every demo): the file exists, imports nothing of JAX or of the
  JAX package (an AST scan), and has ``run(smoke=False, device="cuda")``
  and ``main(smoke=False, outdir=None, device="cuda")``; one subprocess
  imports all ten and finds no ``jax`` in ``sys.modules``; without a card
  the default device raises.
* The two demos rewritten for torch, against the JAX package on small
  float64 cases: the localization demo's ``torch.func.jvp`` columns and
  endpoints (``jvp_columns``) against ``jax.jvp`` through the JAX
  package's ``trace`` (and, in float32, where rays die, against its
  kernel path), and the gradient inversion's misfit and
  ``torch.autograd`` gradient (``misfit_and_grad``) against
  ``jax.value_and_grad`` through its ``travel_times_of_coef``.  The JAX
  answers come from ``fixtures/examples_jax.npz`` (written by
  ``fixtures/make_examples_fixture.py``: the JAX compiles cost more than
  the rest of the file).
* Smoke runs (``slow``, outside Tier-1's ``-m 'not slow'``): each demo's
  ``main(smoke=True, device="cpu")`` with its own asserts, writing at least
  one figure; from seconds to several minutes each.  ``tl_demo``
  fails its axis-insonification assert as the JAX demo does (ROADMAP C1).
"""

import ast
import importlib.util
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_fixtures import _plain, one_blas_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "examples" / "torch_port"
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "examples_jax.npz"

DEMOS = [
    "timefront_demo",
    "amplitude_demo",
    "impulse_response_demo",
    "tl_demo",
    "sensitivity_kernel_demo",
    "inversion_demo",
    "monte_carlo_demo",
    "rough_field_sensitivity_demo",
    "gradient_inversion_demo",
    "localization_demo",
]
FORBIDDEN = ("jax", "jaxlib", "pygenray_tpu")

# the localization demo's field (Munk, 63-term exact fit, 8 stations over
# the demo's 50 km) in float64, 8 rays from the demo's initial depth over 6
# km (30 steps: the tangent trace's plain loop is slow on a CPU at 64 terms)
LOC = {"nz": 500, "x1": 6e3, "z0": 1150.0, "angles": np.linspace(-10.0, 10.0, 8).tolist()}
# the localization demo's Jacobian where rays die, in float32 as the demo
# runs: its field as in LOC, 5 rays over 2 km (10 steps), their launch
# slownesses given as c(z0) p0: two alive (-8 and 5 degrees), two past
# vertical (|c p0| > 1, where a Gauss-Newton step across the caustic can
# take a ray) and one launched at 89.999 degrees
LOC_DEAD = {"nz": 500, "x1": 2e3, "z0": 1150.0,
            "c_p0": [float(np.sin(np.radians(-8.0))), 1.01, -1.02,
                     float(np.sin(np.radians(89.999))), float(np.sin(np.radians(5.0)))]}
# the gradient inversion's fields (Munk, and Munk plus its warm lens) at 3
# stations, K = 24 (the smoke size's: the lens fails the fit gate at 16
# terms), float64; 8 rays over 10 km; cc moved off cc0 by a seeded normal
# draw
GINV = {"nz": 300, "r_max": 10e3, "nr": 3, "K": 24, "B": 8, "dx": 300.0, "lam": 1e-10,
        "seed": 5, "shift_m_s": 0.3}


def _load(name):
    """The port demo ``name`` as a module of its own name (``test_examples``
    registers the JAX demos under their bare names)."""
    spec = importlib.util.spec_from_file_location(f"torch_port_{name}", PORT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _imports(path):
    """Top-level names of every module ``path`` imports."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


@pytest.mark.parametrize("name", DEMOS)
def test_demo_structure(name):
    path = PORT / f"{name}.py"
    assert path.is_file()
    bad = [n for n in _imports(path) if n in FORBIDDEN]
    assert not bad, f"{name} imports {bad}"
    assert "pygenray_tpu_torch" in _imports(path)
    mod = _load(name)
    run, main = inspect.signature(mod.run), inspect.signature(mod.main)
    assert [(p.name, p.default) for p in run.parameters.values()] == [
        ("smoke", False), ("device", "cuda")]
    assert [(p.name, p.default) for p in main.parameters.values()] == [
        ("smoke", False), ("outdir", None), ("device", "cuda")]


def test_demos_import_no_jax():
    """Importing all ten demos in a fresh interpreter loads neither jax nor
    the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"for n in {DEMOS!r}:\n"
        f"    s = importlib.util.spec_from_file_location(n, {str(PORT)!r} + '/' + n + '.py')\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pygenray_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_default_device_raises_without_a_card():
    """The demos default to the card and have no CPU fallback."""
    with pytest.raises((RuntimeError, AssertionError)):
        _load("sensitivity_kernel_demo").run(smoke=True)


# ---------------------------------------------------------------------------
# the two rewrites against the JAX package
# ---------------------------------------------------------------------------


def jax_answers(section, params):
    """``{name: array}`` of ``section/`` in ``fixtures/examples_jax.npz``,
    after checking that it was written for ``params``."""
    fx = np.load(FIXTURE)
    assert json.loads(str(fx["params"]))[section] == _plain(params), (
        f"{FIXTURE.name} was written for other {section} parameters; run "
        "tests/fixtures/make_examples_fixture.py")
    head = f"{section}/"
    return {k[len(head):]: fx[k] for k in fx.files if k.startswith(head)}


def loc_tables():
    """``(z, c1d, p0)`` of the localization case (numpy float64)."""
    from pygenray_tpu_torch import munk_ssp

    z = np.linspace(0.0, 6000.0, LOC["nz"])
    c1d = munk_ssp(z)
    c_src = float(np.interp(LOC["z0"], z, c1d))
    return z, c1d, np.sin(np.radians(-np.asarray(LOC["angles"]))) / c_src


def ginv_tables():
    """``(z, r, dc_true, angles, shift)`` of the gradient-inversion case:
    the demo's lens on the case's grids, its fan, and the (nr, K) move of
    the coefficients off the background."""
    z = np.linspace(0.0, 6000.0, GINV["nz"])
    r = np.linspace(0.0, GINV["r_max"], GINV["nr"])
    r_max = GINV["r_max"]
    dc_true = (3.0 * np.exp(-(((z - 900.0) / 700.0) ** 2))[None, :]
               * np.exp(-(((r - 0.4 * r_max) / (0.18 * r_max)) ** 2))[:, None])
    angles = np.linspace(-11.0, 11.0, GINV["B"])
    shift = GINV["shift_m_s"] * np.random.default_rng(GINV["seed"]).standard_normal(
        (GINV["nr"], GINV["K"]))
    return z, r, dc_true, angles, shift


def test_localization_jvp_matches_jax():
    """``jvp_columns`` (two ``torch.func.jvp`` evaluations through
    ``trace``, one seeded in z0, one in p0) against ``jax.jvp`` through the
    JAX package's ``trace``, both float64 over the same 30 steps: the
    endpoints within 1e-9 s and 1e-6 m, each column within 1e-8 of its
    largest entry."""
    loc = _load("localization_demo")
    jx = jax_answers("localization", LOC)
    z, c1d, p0 = loc_tables()
    env = loc.build_env(z, c1d, "cpu", dtype=torch.float64)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    cols = loc.jvp_columns(env, f64(LOC["z0"]), f64(p0), r_max=LOC["x1"])
    names = ("t_end", "z_end", "dt_dz0", "dz_dz0", "dt_dp0", "dz_dp0")
    got = {n: c.numpy() for n, c in zip(names, cols)}
    np.testing.assert_allclose(got["t_end"], jx["t_end"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["z_end"], jx["z_end"], rtol=0, atol=1e-6)
    for n in names[2:]:
        np.testing.assert_allclose(got[n], jx[n], rtol=0, atol=1e-8 * np.abs(jx[n]).max(),
                                   err_msg=n)


def test_localization_jvp_dead_rays_match_jax():
    """``jvp_columns`` where three of five rays die, float32 on the CPU (the
    save-grid tangent kernel's plain version), against the JAX demo's two
    ``jax.jvp`` calls (seeds (1, 0) and (0, ones)) through the JAX
    package's ``trace`` on its kernel path (``backend="pallas"``, the
    tangent kernel in interpret mode, as on its TPU): the same death codes,
    NaN at the same entries of every output (each dead ray's four tangents:
    the Gauss-Newton step that meets one fails alike in both demos), and the
    finite entries within 3e-6 of their size (measured 1.0e-6, a dead
    ray's frozen depth; 3.2e-7 on the live rays)."""
    from pygenray_tpu_torch import munk_ssp
    from pygenray_tpu_torch.integrate import trace

    loc = _load("localization_demo")
    jx = jax_answers("localization_dead", LOC_DEAD)
    z = np.linspace(0.0, 6000.0, LOC_DEAD["nz"])
    c1d = munk_ssp(z)
    c_src = float(np.interp(LOC_DEAD["z0"], z, c1d))
    env = loc.build_env(z, c1d, "cpu", dtype=torch.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    z0, p0 = f32(LOC_DEAD["z0"]), f32(np.asarray(LOC_DEAD["c_p0"]) / c_src)
    death = trace(env, z0, p0, 0.0, LOC_DEAD["x1"], 2, loc.SETTINGS).death_code.numpy()
    np.testing.assert_array_equal(death, jx["death_code"])
    assert (death != 0).sum() == 3
    cols = loc.jvp_columns(env, z0, p0, r_max=LOC_DEAD["x1"])
    names = ("t_end", "z_end", "dt_dz0", "dz_dz0", "dt_dp0", "dz_dp0")
    for n, c in zip(names, cols):
        got, want = c.numpy().astype(np.float64), jx[n].astype(np.float64)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=n)
        if n not in ("t_end", "z_end"):
            assert np.isnan(got[death != 0]).all(), n
        np.testing.assert_allclose(got, want, rtol=3e-6, atol=0, err_msg=n)


def test_gradient_inversion_misfit_and_grad_match_jax():
    """``misfit_and_grad`` (``torch.autograd.grad`` through
    ``travel_times_of_coef``) against ``jax.value_and_grad`` of the JAX
    demo's misfit, float64, at coefficients moved off the background: the
    background fits equal, the value within 1e-10 relative, the gradient
    within 1e-6 of its largest entry."""
    gi = _load("gradient_inversion_demo")
    jx = jax_answers("gradient_inversion", GINV)
    z, r, dc_true, angles, shift = ginv_tables()
    K = GINV["K"]
    env_true = gi.build(z, r, dc_true, torch.float64, K - 1, "cpu")
    env0 = gi.build(z, r, 0.0 * dc_true, torch.float64, K - 1, "cpu")
    np.testing.assert_allclose(env0.c_cheb.numpy(), jx["cc0"], rtol=1e-12, atol=1e-9)
    s = gi.SolverSettings(dx=GINV["dx"], interp="cheb", kahan=False)
    c_src = np.interp(gi.SRC, z, env0.c[0].numpy())
    p0 = np.sin(np.radians(-angles)) / c_src
    T_obs = gi.travel_times_of_coef(env_true, gi.SRC, p0, 0.0, GINV["r_max"], s)(
        env_true.c_cheb)
    f = gi.travel_times_of_coef(env0, gi.SRC, p0, 0.0, GINV["r_max"], s)
    cc = env0.c_cheb + torch.as_tensor(shift)
    val, g = gi.misfit_and_grad(f, cc, T_obs, env0.c_cheb, GINV["lam"])
    np.testing.assert_allclose(float(val), float(jx["value"]), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), jx["grad"], rtol=0,
                               atol=1e-6 * np.abs(jx["grad"]).max())


# ---------------------------------------------------------------------------
# smoke runs
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.xfail(
        strict=True, raises=AssertionError,
        reason="ROADMAP C1: the incoherent TL leaves NaN holes on the Munk axis, as in the "
               "JAX demo")) if n == "tl_demo" else n
    for n in DEMOS])
def test_demo_smoke(name, tmp_path):
    _load(name).main(smoke=True, outdir=tmp_path, device="cpu")
    assert list(tmp_path.glob("*.png")), f"{name} wrote no figure"
