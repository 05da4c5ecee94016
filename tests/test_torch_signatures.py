"""The port's public API against the JAX package's: every public callable
the two flat namespaces share takes the reference's parameters, in the
reference's order, with only ``device`` added, and the reference's
defaults; ``SolverSettings`` has the reference's fields and defaults; and
what the port has not ported (the TPU block classifiers) raises a named
error, and a mesh that is not a ``parallel.Mesh`` a ``TypeError`` naming
it."""

import dataclasses
import inspect

import numpy as np
import pytest

import pygenray_tpu as pr
import pygenray_tpu_torch as pt
from torch_fixtures import one_blas_thread  # noqa: F401

SHARED = sorted(set(pr.__all__) & set(pt.__all__))
CALLABLES = [n for n in SHARED if callable(getattr(pr, n)) and n != "SolverSettings"]
# The one parameter the port adds: where its tensors live.
ADDED = {"device"}
# Defaults that differ by design, with the reason.  (The backend *values*
# differ too, "xla"/"pallas" there and "ops"/"kernel" here, each naming its
# package's own paths; the default, "auto", is the same.)
ALLOWED = {}


def _same_default(a, b):
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        # a SolverSettings() default: one class in each package
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    try:
        return bool(np.all(a == b)) and type(a) is type(b)
    except (TypeError, ValueError):
        return a is b


@pytest.mark.parametrize("name", CALLABLES)
def test_parameters_match_the_reference(name):
    ref = inspect.signature(getattr(pr, name)).parameters
    got = {k: p for k, p in inspect.signature(getattr(pt, name)).parameters.items()
           if k not in ADDED}
    assert list(got) == list(ref), f"{name}: {list(got)} != {list(ref)}"
    for k, p in ref.items():
        assert got[k].kind == p.kind, f"{name}({k}): {got[k].kind} != {p.kind}"
        if (name, k) in ALLOWED:
            continue
        assert _same_default(got[k].default, p.default), (
            f"{name}({k}): default {got[k].default!r} != {p.default!r}")


def test_solver_settings_fields_match_the_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(pr.SolverSettings)]
    got = [(f.name, f.default) for f in dataclasses.fields(pt.SolverSettings)]
    assert got == ref
    assert pt.SolverSettings().backend == pr.SolverSettings().backend == "auto"


def test_unported_keywords_raise_named_errors():
    # a table profile (low fit orders keep the fits, unused here, quick)
    z, r = np.linspace(0, 5000, 32), np.array([0.0, 10e3])
    env = pt.make_env_data(np.outer(np.ones(2), pt.munk_ssp(z)), r, z, np.full(2, 5000.0), r,
                           dtype="float64", device="cpu", interp="table", cheb_order=3,
                           seg_order=3)
    with pytest.raises(TypeError, match="Mesh"):
        pt.shoot_rays(1000.0, 0.0, [0.0], 5e3, 2, env, mesh=object(), device="cpu")
    for kw in ({"calm": (0, 1)}, {"dyn": np.zeros(3)}, {"hot": True}):
        with pytest.raises(ValueError, match="not ported"):
            pt.trace(env, 1000.0, [1e-4], 0.0, 5e3, 2, pt.SolverSettings(dx=500.0), **kw)
    # the reference's four TPU-only settings fields are taken at any value
    # and ignored: the trace is the default settings' bit for bit
    s = pt.SolverSettings(dx=500.0, max_bounces=3, calm=False, dyn_calm=False, hot="auto")
    a = pt.trace(env, 1000.0, [1e-4, -2e-4], 0.0, 5e3, 2, s)
    b = pt.trace(env, 1000.0, [1e-4, -2e-4], 0.0, 5e3, 2, pt.SolverSettings(dx=500.0))
    assert all(bool((x == y).all()) for x, y in zip(dataclasses.astuple(a),
                                                    dataclasses.astuple(b)))
