"""The save-grid forward-tangent trace on CPU: the plain version of the CUDA
kernel ``csrc/trace_tangent_save.cu`` (``integrate._trace_tangent_save_impl``)
and its wrapper (``ops.stepper.trace_tangent_save_kernel``).

* Against the JAX package's kernel (``trace_pallas_tangent_save`` in
  interpret mode), one small float32 case, with ``tests/test_pallas.py``'s
  bounds: counters, death codes and ``alive_save`` exact, T within 1e-4 s,
  z within 0.1 m, tangents within 2e-3 relative (to |value| + a floor).
* Against ``jax.jvp`` through the JAX package's scan without Kahan (the
  plain reference its own kernel tests use, ``tests/test_custom_jvp.py``;
  here ``torch_scan_reference.py``, shared with ``test_torch_autograd.py``),
  on a range-dependent field: a unit p0 seed, a source-depth seed on a
  bouncing fan that holds a surface-launched and a bottom-launched ray, a
  mixed seed, and a fan with deaths.  Same bounds;
  the tangent floor scales with the seed (a unit depth seed gives tangents
  about 1e-8 of a unit p0 seed's).
* Bit for bit: the last row is ``_trace_tangent_impl``, the primal is
  ``_trace_impl`` without Kahan, the wrapper on CPU tensors is the plain
  version.
* ``alive_save`` and row 0; float64 against central differences; a launch
  without a card or a compiler raises.

The kernel itself runs only on a card; ``chip_smoke.py`` holds it to this
plain version there.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygenray_tpu.integrate import SolverSettings as JSettings
from pygenray_tpu.ops.pallas_stepper import trace_pallas_tangent_save
from pygenray_tpu_torch.envdata import DATA_FIELDS
from pygenray_tpu_torch.integrate import (
    SolverSettings,
    _trace_impl,
    _trace_tangent_impl,
    _trace_tangent_save_impl,
)
from pygenray_tpu_torch.ops import _build, stepper
from torch_scan_reference import B, DX, GEOM, NUM_SAVE, jax_env, port_env, scan_jvp
from torch_fixtures import one_blas_thread  # noqa: F401

S = SolverSettings(dx=DX)
GRIDS = ("ts", "zs", "ps")
INTS = ("n_surf", "n_bott", "death_code", "alive_save")


def _fan(kind):
    """(z0, p0): a fan that bounces off both boundaries; "deaths" adds
    vertical rays (code 1) and a source below the domain (code 2);
    "surface" launches one ray from the surface and one from the bottom."""
    angles = np.linspace(-18.0, 18.0, B)
    z0 = np.full(B, 1300.0)
    if kind == "deaths":
        angles = np.concatenate([np.linspace(-18.0, 18.0, B - 4), [-90.0, -89.0, 60.0, 0.0]])
        z0[-1] = 6500.0
    elif kind == "surface":
        z0[0], z0[1] = 0.0, 4600.0
    return z0, np.sin(np.radians(-angles)) / 1500.0


# (environment, fan, dp0, dz0); all on the range-dependent field, so that the
# JAX reference compiles once
CASES = {
    "rd/dp0": ("rd", "plain", 1.0, 0.0),
    "rd/dz0_surface_launched": ("rd", "surface", 0.0, 1.0),
    "rd/mixed": ("rd", "plain", np.linspace(0.5, 1.5, B), -0.7),
    "rd/deaths": ("rd", "deaths", 1.0, 0.0),
}


@pytest.fixture(scope="module")
def envs():
    return {kind: (jax_env(kind), port_env(jax_env(kind))) for kind in ("ri", "rd")}


@pytest.fixture(scope="module")
def plain(envs):
    """The port's plain save-grid tangent for every case."""
    out = {}
    for name, (kind, fan, dp0, dz0) in CASES.items():
        z0, p0 = _fan(fan)
        out[name] = _trace_tangent_save_impl(envs[kind][1], z0, p0, dp0, GEOM, S, dz0=dz0)
    return out


def _same(a, b):
    """Bit for bit, a NaN (a dead ray's frozen tangent) equal to a NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _hold(res, tang, ref, seed_scale):
    """``ref``: ts zs ps dts dzs dps n_surf n_bott death alive_save."""
    for f, want in zip(INTS, ref[6:]):
        np.testing.assert_array_equal(getattr(res, f).numpy(), want, err_msg=f)
    # at live save points: a dead ray's frozen state can be astronomically
    # large (the last step before a vertical turn)
    live = ref[9]
    assert live.sum() > 2 * NUM_SAVE
    np.testing.assert_allclose(res.ts.numpy()[live], ref[0][live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.zs.numpy()[live], ref[1][live], rtol=0, atol=0.1)
    # floors: dT ~ 1e3, dz ~ 1e3 (tests/test_pallas.py), dp ~ 1e-2 for a unit
    # p0 seed
    for mine, theirs, floor in zip(tang, ref[3:6], (1e3, 1e3, 1e-2)):
        rel = np.abs(mine.numpy() - theirs) / (np.abs(theirs) + floor * seed_scale)
        assert rel[live].max() < 2e-3


def test_plain_matches_pallas_interpret(envs):
    """The one Pallas-interpreter run: range-independent, unit p0 seed."""
    je, te = envs["ri"]
    z0, p0 = _fan("plain")
    jres, jtang = trace_pallas_tangent_save(
        je, jnp.asarray(z0, jnp.float32), jnp.asarray(p0, jnp.float32), 1.0, GEOM,
        JSettings(dx=DX, kahan=False), interpret=True)
    res, tang = _trace_tangent_save_impl(te, z0, p0, 1.0, GEOM, S)
    assert res.ts.dtype == torch.float32 and res.ts.shape == (B, NUM_SAVE) == tang[1].shape
    assert int((res.n_surf + res.n_bott).sum()) > 0  # the crossing fix and its tangent ran
    ref = [np.asarray(a) for a in (jres.ts, jres.zs, jres.ps, *jtang, jres.n_surf, jres.n_bott,
                                   jres.death_code, jres.alive_save)]
    _hold(res, tang, ref, 1.0)
    np.testing.assert_array_equal(res.rs.numpy(), np.asarray(jres.rs))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_scan_jvp(name, envs, plain):
    kind, fan, dp0, dz0 = CASES[name]
    z0, p0 = _fan(fan)
    ref = scan_jvp(envs[kind][0], z0, p0, dp0, dz0)
    res, tang = plain[name]
    _hold(res, tang, ref, float(np.max(np.abs(dp0)) + 1e-8 * abs(dz0)))
    if fan == "deaths":
        assert {1, 2} <= set(res.death_code.tolist())
    else:
        assert bool(res.alive.all()) and int(res.n_bott.sum()) > 0


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_last_row_is_the_final_state_tangent(kind, envs):
    te = envs[kind][1]
    z0, p0 = _fan("deaths")
    res, tang = _trace_tangent_save_impl(te, z0, p0, 1.0, GEOM, S)
    out = _trace_tangent_impl(te, z0, p0, 1.0, GEOM, S)
    last = (res.ts, res.zs, res.ps, *tang)
    for a, b in zip(last, out[:6]):
        assert _same(a[:, -1], b)
    for a, b in zip((res.n_surf, res.n_bott, res.death_code), out[6:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_primal_is_the_forward_trace_without_kahan(name, envs, plain):
    """Whatever ``settings.kahan`` says, and whatever the seed."""
    kind, fan, _, _ = CASES[name]
    z0, p0 = _fan(fan)
    want = _trace_impl(envs[kind][1], z0, p0, GEOM, dataclasses.replace(S, kahan=False))
    res = plain[name][0]
    for f in (*GRIDS, *INTS, "alive", "rs"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f


def test_alive_save_and_row_0(plain):
    """Row 0 is the launch state and its seed; ``alive_save`` is monotone,
    False from the first save row at which the ray is dead, and all False
    for a ray launched outside the domain; a dead ray's rows stay frozen
    and finite-or-not as they were."""
    res, (dts, dzs, dps) = plain["rd/deaths"]
    z0, p0 = _fan("deaths")
    assert torch.equal(res.ts[:, 0], torch.zeros(B))
    assert torch.equal(res.zs[:, 0], torch.tensor(z0, dtype=torch.float32))
    assert torch.equal(res.ps[:, 0], torch.tensor(p0, dtype=torch.float32))
    assert torch.equal(dts[:, 0], torch.zeros(B)) and torch.equal(dzs[:, 0], torch.zeros(B))
    assert torch.equal(dps[:, 0], torch.ones(B))
    a = res.alive_save
    assert not bool((a[:, 1:] & ~a[:, :-1]).any())  # never back to life
    assert torch.equal(a[:, -1], res.alive) and torch.equal(res.alive, res.death_code == 0)
    assert not bool(a[-1].any()) and int(res.death_code[-1]) == 2  # dead at launch
    dead = ~res.alive
    assert int(dead.sum()) >= 3
    k = int(a[-4].sum())  # the vertical ray dies before the first save
    assert k <= 1 and torch.equal(res.zs[-4, k:], res.zs[-4, k].expand(NUM_SAVE - k))
    # the mixed seed's row 0
    _, (_, dzs_m, dps_m) = plain["rd/mixed"]
    assert torch.equal(dzs_m[:, 0], torch.full((B,), -0.7))
    assert torch.equal(dps_m[:, 0], torch.tensor(np.linspace(0.5, 1.5, B), dtype=torch.float32))


@pytest.mark.parametrize("name", ["rd/dp0", "rd/mixed"])
def test_wrapper_on_cpu_tensors_is_the_plain_version(name, envs, plain):
    kind, fan, dp0, dz0 = CASES[name]
    z0, p0 = _fan(fan)
    assert stepper.tangent_supported(envs[kind][1], S)
    n0 = stepper.TANGENT_SAVE_LAUNCHES
    res, tang = stepper.trace_tangent_save_kernel(envs[kind][1], z0, p0, dp0, GEOM, S, dz0=dz0)
    assert stepper.TANGENT_SAVE_LAUNCHES == n0  # CPU tensors: no launch
    for f in (*GRIDS, *INTS, "alive", "rs"):
        assert torch.equal(getattr(res, f), getattr(plain[name][0], f)), f
    for a, b in zip(tang, plain[name][1]):
        assert _same(a, b)


@pytest.mark.parametrize("seed", ["dp0", "dz0"])
def test_float64_matches_central_differences(seed, envs):
    """float64, curved-free flat bottom: the save grids' tangents within
    1e-4 relative (to |value| + a floor) of central differences of the
    forward trace, at every save point, on rays whose bounce counts the
    shifted shots share (steps 1e-12 s/m and 1e-4 m)."""
    te = port_env(envs["ri"][0], torch.float64)
    z0, p0 = _fan("plain")
    dp0, dz0 = (1.0, 0.0) if seed == "dp0" else (0.0, 1.0)
    res, tang = _trace_tangent_save_impl(te, z0, p0, dp0, GEOM, S, dz0=dz0)
    eps = 1e-12 if seed == "dp0" else 1e-4
    s_off = dataclasses.replace(S, kahan=False)
    hi = _trace_impl(te, z0 + eps * dz0, p0 + eps * dp0, GEOM, s_off)
    lo = _trace_impl(te, z0 - eps * dz0, p0 - eps * dp0, GEOM, s_off)
    same = ((hi.n_surf == lo.n_surf) & (hi.n_bott == lo.n_bott) & (hi.n_bott == res.n_bott)
            & hi.alive & lo.alive)
    assert int(same.sum()) >= 0.8 * B and int(res.n_bott[same].sum()) > 0
    scale = 1.0 if seed == "dp0" else 1e-8
    for mine, f, floor in zip(tang, GRIDS, (1e3, 1e3, 1e-2)):
        fd = (getattr(hi, f) - getattr(lo, f)) / (2 * eps)
        rel = (fd - mine).abs() / (mine.abs() + floor * scale)
        assert float(rel[same].max()) < 1e-4, f


def test_configurations_the_kernel_does_not_cover_raise(envs):
    je = envs["ri"][0]
    z0, p0 = _fan("plain")
    te64 = port_env(je, torch.float64)
    with pytest.raises(ValueError, match="not covered"):
        stepper.trace_tangent_save_kernel(te64, z0, p0, 1.0, GEOM, S)
    table = dataclasses.replace(S, interp="table")
    with pytest.raises(ValueError, match="spectral"):
        _trace_tangent_save_impl(envs["ri"][1], z0, p0, 1.0, GEOM, table)
    # a device that is neither CPU nor CUDA
    meta = dataclasses.replace(envs["ri"][1], **{
        f: getattr(envs["ri"][1], f).to("meta") for f in DATA_FIELDS})
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stepper.trace_tangent_save_kernel(meta, z0, p0, 1.0, GEOM, S)


def test_a_launch_without_a_compiler_raises(monkeypatch):
    """The kernel's entry point is built at first use; with no ``nvcc`` (and
    no library built) asking for it raises, it never falls back."""
    # the entry point's name maps to its source, which shares the step with
    # the final-state tangent kernel through a header
    assert "trace_tangent_save_f32".rsplit("_", 1)[0] in _build.sources()
    assert (_build.CSRC / "tangent_step.cuh").is_file()
    for name in ("trace_tangent", "trace_tangent_save"):
        assert '#include "tangent_step.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    monkeypatch.setattr(stepper, "_FNS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        stepper._kernel_fn("trace_tangent_save_f32")


def test_fixed_k_list_mirrors_the_launcher():
    """The K the kernel is compiled for with K fixed (``with_fixed_k`` in
    ``csrc/tangent_trace.cuh``, the body it shares with the final-state
    tangent kernel) are ``stepper.SAVE_FIXED_K``: the spectral fit ladder's
    lengths (envdata.py, orders + 1) up to 96; the range-dependent step
    rows come through the ensemble kernel's header."""
    src = (_build.CSRC / "tangent_trace.cuh").read_text()
    cases = [int(k) for k in re.findall(r"case (\d+): return L::template run<\1>", src)]
    assert tuple(cases) == stepper.SAVE_FIXED_K
    assert stepper.SAVE_FIXED_K == tuple(o + 1 for o in (15, 23, 31, 47, 63, 95))
    assert '#include "stage_rows.cuh"' in src
    for name in ("trace_tangent", "trace_tangent_save"):
        assert '#include "tangent_trace.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
