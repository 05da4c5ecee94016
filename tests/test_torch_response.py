"""Signals, waveform synthesis and the end-to-end receiver calls in the port
(``pygenray_tpu_torch.signals``, ``.response``).

* ``signals.py`` and the numpy half of ``response.py`` are copies: on the
  same inputs and the same ``Arrivals`` they give the JAX package's outputs
  exactly (bit for bit; both are the same numpy code).
* ``array_response`` and ``impulse_response`` against the JAX package on one
  small isovelocity case in float64 (fan, eigenray solve, amplitude launch,
  synthesis; the JAX package's array response from
  ``fixtures/port_tests_jax.npz``): the same eigenrays, amplitudes within 1e-6 relative and
  travel times within 1e-9 s (two float64 traces of straight rays), the
  waveforms within 1e-5 of the largest sample; and the closed forms (direct
  slant time, 1/s amplitude) as ``tests/test_response.py`` holds them.
* The new names are in ``__all__`` and the no-JAX guard covers the modules.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.amplitudes import Arrivals as JArrivals
from torch_fixtures import jax_answers, one_blas_thread  # noqa: F401

FC, BW = 100.0, 40.0


def arrivals(cls):
    """Four arrivals (a direct path, a surface bounce, a dead ray, a
    caustic with a bottom bounce) in either package's container."""
    f = lambda *v: np.asarray(v, float)
    return cls(
        theta0=f(0.0, 4.0, 9.0, -3.0), amplitude=f(2e-4, 1.5e-4, np.nan, 3e-4),
        tl_db=f(74.0, 76.5, np.nan, 70.5), phase=f(0.0, np.pi, 0.0, -np.pi / 2),
        kmah=np.array([0, 0, 0, 1]), travel_time=f(3.3, 3.34, 3.5, 3.41),
        z_r=f(-1000.0, -1000.2, -900.0, -999.9), theta_r=f(1.0, 4.0, 9.0, 3.0),
        n_surf=np.array([0, 1, 0, 0]), n_bott=np.array([0, 0, 0, 1]),
        alive=np.array([True, True, False, True]), death_code=np.array([0, 0, 1, 0]),
        path_length=f(5000.0, 5012.0, 5100.0, 5007.0))


def chirp(fs, dur=0.25):
    ts = np.arange(int(dur * fs)) / fs
    return np.sin(2 * np.pi * (0.5 * FC * ts + 0.5 * FC / dur * ts ** 2))


def same_response(a, b):
    np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(a.analytic, b.analytic)
    np.testing.assert_array_equal(a.waveform, b.waveform)
    assert (a.center_frequency, a.bandwidth) == (b.center_frequency, b.bandwidth)


@pytest.mark.parametrize("order", [3, 7, 10])
def test_msequence_code_is_the_jax_packages(order):
    np.testing.assert_array_equal(tp.msequence_code(order), jp.msequence_code(order))
    np.testing.assert_array_equal(tp.msequence_code(order, seed=5), jp.msequence_code(order, seed=5))
    code = tp.msequence_code(order)
    L = 2 ** order - 1
    assert code.shape == (L,) and set(code.tolist()) == {-1.0, 1.0}
    acf = np.array([np.dot(code, np.roll(code, k)) for k in range(1, 4)])
    np.testing.assert_array_equal(acf, -1.0)  # two-valued autocorrelation


def test_msequence_signal_is_the_jax_packages():
    for args, kw in (((5, FC, 8 * FC), {}),
                     ((6, 75.0, 600.0), dict(cycles_per_digit=3, modulation_angle=0.5, seed=3))):
        sig = tp.msequence_signal(*args, **kw)
        np.testing.assert_array_equal(sig, jp.msequence_signal(*args, **kw))
        L, cycles = 2 ** args[0] - 1, kw.get("cycles_per_digit", 2)
        assert sig.shape == (int(round(L * cycles / args[1] * args[2])),)
    with pytest.raises(ValueError):
        tp.msequence_code(99)
    with pytest.raises(ValueError):
        tp.msequence_signal(5, FC, fs=FC)  # under-sampled carrier


@pytest.mark.parametrize("kw", [
    {}, {"fs": 1000.0}, {"attenuation": "thorp"}, {"attenuation": 1e-4},
    {"attenuation": lambda f: 2e-4 + 0.0 * f}, {"bottom_loss_db": 3.0},
    {"attenuation": "thorp", "bottom_loss_db": 1.5, "bandwidth": 25.0},
], ids=["default", "fs", "thorp", "float", "callable", "bottom_loss", "all"])
def test_synthesize_response_is_the_jax_packages(kw):
    kw = {"bandwidth": BW, **kw}
    same_response(tp.synthesize_response(arrivals(tp.Arrivals), FC, **kw),
                  jp.synthesize_response(arrivals(JArrivals), FC, **kw))


def test_synthesize_response_on_a_given_grid_and_all_dead():
    t = 3.2 + np.arange(400) / 1200.0
    same_response(tp.synthesize_response(arrivals(tp.Arrivals), FC, bandwidth=BW, t=t),
                  jp.synthesize_response(arrivals(JArrivals), FC, bandwidth=BW, t=t))
    dead = arrivals(tp.Arrivals)[2]
    with pytest.raises(ValueError):
        tp.synthesize_response(dead, FC, bandwidth=BW)
    no_path = dataclasses.replace(arrivals(tp.Arrivals), path_length=None)
    with pytest.raises(ValueError, match="path_length"):
        tp.synthesize_response(no_path, FC, bandwidth=BW, attenuation="thorp")


@pytest.mark.parametrize("kw", [{}, {"attenuation": "thorp"}, {"bottom_loss_db": 2.0}],
                         ids=["plain", "thorp", "bottom_loss"])
def test_received_waveform_and_correlate_are_the_jax_packages(kw):
    fs = 8 * FC
    src = chirp(fs)
    rt = tp.received_waveform(arrivals(tp.Arrivals), src, fs, **kw)
    rj = jp.received_waveform(arrivals(JArrivals), src, fs, **kw)
    same_response(rt, rj)
    same_response(rt.correlate(src, fs), rj.correlate(src, fs))
    np.testing.assert_array_equal(rt.envelope(), rj.envelope())
    with pytest.raises(ValueError, match="sample rate"):
        rt.correlate(src, fs * 1.5)


def test_thorp_attenuation_is_the_jax_packages():
    f = [10.0, 75.0, 250.0, 1e3, 1e4]
    got = [tp.thorp_attenuation(x) for x in f]
    assert got == [jp.thorp_attenuation(x) for x in f]
    assert np.all(np.diff(got) > 0)


def test_response_npz_round_trips(tmp_path):
    resp = tp.synthesize_response(arrivals(tp.Arrivals), FC, bandwidth=BW)
    resp.save_npz(tmp_path / "r.npz")
    back = tp.Response.load_npz(tmp_path / "r.npz")
    same_response(back, resp)
    np.testing.assert_array_equal(back.arrivals.kmah, resp.arrivals.kmah)
    ar = tp.ArrayResponse(receiver_depths=np.array([900.0, 1100.0]), t=resp.t,
                          waveform=np.stack([resp.waveform, -resp.waveform]),
                          responses=[resp, resp])
    ar.save_npz(tmp_path / "ar.npz")
    back = tp.ArrayResponse.load_npz(tmp_path / "ar.npz")
    np.testing.assert_array_equal(back.waveform, ar.waveform)
    np.testing.assert_array_equal(back.receiver_depths, ar.receiver_depths)
    assert len(back.responses) == 2
    same_response(back.responses[1], resp)


# ---- end to end against the JAX package ------------------------------------

C0, RANGE, ZD = 1500.0, 5e3, np.asarray([900.0, 1100.0, 1950.0])  # 1950 m: outside the fan
E2E = dict(center_frequency=50.0, bandwidth=25.0, num_rays=33, max_angle=8.0, num_save=11,
           dx=500.0, flatearth=False)


def _slab():
    z = np.linspace(0.0, 2000.0, 64)
    r = np.linspace(0.0, 10e3, 8)
    return np.full((r.size, z.size), C0), r, z, np.full(r.size, 2000.0), r


def _jax_array_response():
    """The JAX package's ``array_response(1000.0, 0.0, ZD, RANGE, ...)`` on
    the slab in float64 (its ``t``, ``waveform`` and each receiver's
    ``Arrivals``), from ``fixtures/port_tests_jax.npz``: computed live it
    costs a JAX compile of about 15 s in every test process
    (``fixtures/make_port_tests_fixture.py`` writes it)."""
    fx = jax_answers("response", c0=C0, range=RANGE, zd=ZD, e2e=E2E)
    fields = [f.name for f in dataclasses.fields(JArrivals)]
    responses = [types.SimpleNamespace(arrivals=JArrivals(
        **{f: fx[f"d{d}/{f}"] for f in fields if f"d{d}/{f}" in fx})) for d in range(len(ZD))]
    return types.SimpleNamespace(t=fx["t"], waveform=fx["waveform"], responses=responses)


@pytest.fixture(scope="module")
def end_to_end():
    """(JAX array response, port array response, port impulse response at
    the first depth), float64, the same tables."""
    te = tp.make_env_data(*_slab(), dtype=torch.float64, device="cpu")
    return (_jax_array_response(),
            tp.array_response(1000.0, 0.0, ZD, RANGE, te, **E2E),
            tp.impulse_response(1000.0, 0.0, ZD[0], RANGE, te, **E2E))


def test_array_response_matches_jax(end_to_end):
    ja, ta, _ = end_to_end
    assert ta.waveform.shape == ja.waveform.shape == (3, ta.t.size)
    np.testing.assert_allclose(ta.t, ja.t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ta.waveform, ja.waveform, rtol=0,
                               atol=1e-5 * np.abs(ja.waveform).max())
    for rt, rj in zip(ta.responses, ja.responses):
        np.testing.assert_array_equal(rt.t, ta.t)  # one shared grid
        assert len(rt.arrivals) == len(rj.arrivals)
        np.testing.assert_array_equal(rt.arrivals.n_surf, rj.arrivals.n_surf)
        np.testing.assert_array_equal(rt.arrivals.kmah, rj.arrivals.kmah)
        np.testing.assert_allclose(rt.arrivals.amplitude, rj.arrivals.amplitude, rtol=1e-6)
        np.testing.assert_allclose(rt.arrivals.travel_time, rj.arrivals.travel_time, rtol=0,
                                   atol=1e-9)
    # the unreachable element: a zero row and an empty container
    assert not ta.waveform[2].any() and len(ta.responses[2].arrivals) == 0


def test_array_response_closed_forms(end_to_end):
    _, ta, _ = end_to_end
    for d, z_r in enumerate(ZD[:2]):
        s = np.hypot(RANGE, z_r - 1000.0)
        env = ta.responses[d].envelope()
        i = np.argmax(env)
        assert abs(ta.t[i] - s / C0) < 2e-3
        np.testing.assert_allclose(env[i], 1.0 / s, rtol=0.05)


def test_impulse_response_matches_jax(end_to_end):
    """The one-receiver call against the JAX package's arrivals at that
    depth, synthesized by the JAX package on the port's own time grid."""
    ja, _, ti = end_to_end
    want = jp.synthesize_response(ja.responses[0].arrivals, E2E["center_frequency"],
                                  bandwidth=E2E["bandwidth"], t=ti.t)
    np.testing.assert_allclose(ti.waveform, want.waveform, rtol=0,
                               atol=1e-5 * np.abs(want.waveform).max())
    assert ti.arrivals.alive.all() and np.isfinite(ti.waveform).all()
    s = np.hypot(RANGE, ZD[0] - 1000.0)
    i = np.argmax(ti.envelope())
    assert abs(ti.t[i] - s / C0) < 2e-3
    np.testing.assert_allclose(ti.envelope()[i], 1.0 / s, rtol=0.05)


def test_no_eigenrays_raises_and_default_device():
    te = tp.make_env_data(*_slab(), dtype=torch.float64, device="cpu")
    kw = dict(center_frequency=50.0, launch_angles=np.asarray([7.9, 8.0]), num_save=4, dx=1250.0,
              flatearth=False)
    with pytest.raises(ValueError, match="no eigenrays"):
        # a 2-ray steep fan cannot bracket the shallow receiver
        tp.impulse_response(1000.0, 0.0, 10.0, RANGE, te, **kw)
    with pytest.raises(ValueError, match="no eigenrays"):
        tp.array_response(1000.0, 0.0, [10.0, 20.0], RANGE, te, **kw)
    from pygenray_tpu_torch.models import munk_env

    ocean = munk_env(r_max=10e3, nr=4, nz=200)
    if not torch.cuda.is_available():
        # without device= the environment is built on the CUDA device
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tp.impulse_response(1000.0, 0.0, 900.0, RANGE, ocean, **kw)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tp.array_response(1000.0, 0.0, [900.0], RANGE, ocean, **kw)


NEW_NAMES = ("Arrivals", "arrival_amplitudes", "Response", "ArrayResponse", "synthesize_response",
             "impulse_response", "array_response", "received_waveform", "thorp_attenuation",
             "msequence_code", "msequence_signal", "TLField", "transmission_loss_field")


def test_new_names_are_exported_in_the_jax_packages_order():
    assert all(name in tp.__all__ and hasattr(tp, name) for name in NEW_NAMES)
    order = [n for n in jp.__all__ if n in NEW_NAMES]
    assert [n for n in tp.__all__ if n in NEW_NAMES] == order == list(NEW_NAMES)


def test_jax_guard_covers_the_receiver_modules():
    """``test_torch_shoot.py::test_port_never_imports_jax`` scans every
    module of the package, these included; none names jax."""
    pkg = pathlib.Path(tp.__file__).parent
    for mod in ("amplitudes.py", "tlfield.py", "signals.py", "response.py"):
        text = (pkg / mod).read_text()
        assert "import jax" not in text and "pygenray_tpu " not in text, mod
        assert "from pygenray_tpu." not in text and "import pygenray_tpu\n" not in text, mod
