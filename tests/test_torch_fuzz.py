"""The port's torch-op trace against the JAX package's on a random smooth
range-dependent field (the recipe of ``tests/test_fuzz_parity.py``, shared
through ``tests/fixtures/random_field.py``): seed 0, its eight launch
angles, the spectral profile path the CUDA kernels reproduce, float64.

``chip_smoke.py`` holds the kernels to this torch-op path bit for bit on
three such seeds, and to the scipy oracle."""

import pathlib
import sys

import numpy as np
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.envdata import make_env_data as j_make_env_data
from pygenray_tpu.integrate import SolverSettings as JSettings, trace as j_trace

sys.path.insert(0, str(pathlib.Path(__file__).parent / "fixtures"))
import random_field  # noqa: E402

# Both packages evaluate the same float64 Chebyshev series step for step;
# XLA may fuse a multiply and an add that torch rounds apart (about 1e-16
# of a step's 0.13 s), so over 200 steps the final travel times may part by
# a few 1e-14 s (3.4e-13 s measured at dx = 100 m).  1e-9 s is far below the
# 0.1 ms budget and far above that rounding.
TIME_S = 1e-9
DEPTH_M = 1e-6


def test_random_field_trace_matches_jax():
    rng = np.random.default_rng(0)
    c2d, r, z, bathy = random_field.random_env(jp.munk_ssp, rng)
    z_src, angles = random_field.source_and_angles(rng)
    env_j = j_make_env_data(c2d, r, z, bathy, r, dtype="float64")
    env_t = tp.make_env_data(c2d, r, z, bathy, r, dtype=torch.float64, device="cpu")
    assert env_t.range_dependent and env_t.has_cheb and env_t.bangle_mode == "cheb"
    c_src = float(tp.bilinear_np(0.0, z_src, r, z, c2d))
    p0 = np.sin(np.radians(angles)) / c_src
    x1 = float(r[-1])
    res_j = j_trace(env_j, z_src, p0, 0.0, x1, 2, JSettings(dx=200.0, interp="cheb"))
    res_t = tp.trace(env_t, z_src, p0, 0.0, x1, 2,
                     tp.SolverSettings(dx=200.0, interp="cheb", backend="ops"))
    for f in ("n_bott", "n_surf", "death_code", "alive"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)))
    assert int((res_t.n_bott + res_t.n_surf).sum()) > 0  # the fan reflects
    np.testing.assert_allclose(res_t.ts.numpy(), np.asarray(res_j.ts), rtol=0, atol=TIME_S)
    np.testing.assert_allclose(res_t.zs.numpy(), np.asarray(res_j.zs), rtol=0, atol=DEPTH_M)
