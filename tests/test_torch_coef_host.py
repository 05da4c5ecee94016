"""The range-independent coefficient-tangent kernel (B5,
``csrc/trace_coef_tangent.cu``) built for the host and held to its plain
version, ``integrate._trace_coef_tangent_impl``.

The CUDA source is compiled by g++ against the stand-in ``cuda_runtime.h``
of ``tools/host_tangent_rehearsal.py`` (a block's threads as
``std::thread``s, ``__shfl_xor_sync`` an exchange between the lanes its mask
names, ``-ffp-contract=off`` as nvcc's ``-fmad=false``) and its C entry
point called through ctypes on the CPU operands the wrapper builds.  The
kernel carries a direction of a ray on a lane pair, the c series on the
even lane and dc/dz on the odd one, so the host build runs the pair's
exchange as the card does.  Every output equals the plain version's bit
for bit: the case's series need no libm function (constant bottom angle),
and the host's 1/sqrt is the plain version's.  24 rays over 12 km (60
steps of 200 m) on a Munk fit with K = 16, one ray bouncing, along 3 and 16
coefficient directions (pairs of a warp on several rays; one ray a warp).
Skipped where g++ is missing; ``chip_smoke.py`` holds the kernel on the
card.
"""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

import pygenray_tpu_torch as pt
from pygenray_tpu_torch.integrate import SolverSettings, _plan, _trace_coef_tangent_impl
from torch_fixtures import one_blas_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
X1, DX, SRC = 12e3, 200.0, 1300.0


def _rehearsal():
    spec = importlib.util.spec_from_file_location(
        "host_tangent_rehearsal", ROOT / "tools" / "host_tangent_rehearsal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def host_b5(tmp_path_factory):
    """(the rehearsal module, the host build's C entry point)"""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's CUDA source for the host")
    hr = _rehearsal()
    lib = hr.build(ROOT, tmp_path_factory.mktemp("coef_host"), ("trace_coef_tangent",))
    return hr, hr.entry(lib["trace_coef_tangent"], "trace_coef_tangent")


@pytest.fixture(scope="module")
def field():
    z, r = np.linspace(0.0, 6000.0, 1024), np.linspace(0.0, 100e3, 4)
    env = pt.make_env_data(np.outer(np.ones(4), pt.munk_ssp(z)), r, z, np.full(4, 5000.0), r,
                           dtype=torch.float32, device="cpu")
    assert env.c_cheb.shape[-1] == 16 and not env.range_dependent
    angles = np.r_[np.linspace(-12.0, 12.0, 23), 25.0]  # the last one reaches the surface
    c0 = float(np.interp(SRC, z, env.c[0].numpy()))
    p0 = torch.as_tensor(np.sin(np.radians(-angles)) / c0, dtype=torch.float32)
    return env, p0


@pytest.mark.parametrize("D", [3, 16])
def test_host_build_equals_plain_version(host_b5, field, D):
    hr, fn = host_b5
    env, p0 = field
    s = SolverSettings(dx=DX)
    geom = (0.0, X1, *_plan(0.0, X1, 2, DX))
    z0 = torch.full_like(p0, SRC)
    dc, dcp = hr.directions(env, D, D)
    out_k = hr.run_coef(fn, env, z0, p0, dc, dcp, geom, s)
    out_p = _trace_coef_tangent_impl(env, z0, p0, dc, dcp, geom, s)
    assert out_k[3].shape == (D, p0.shape[0])
    assert int((out_p[6] + out_p[7]).sum()) > 0  # a ray bounced
    assert hr.same(out_k, out_p)
