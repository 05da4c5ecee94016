"""Shared helpers of the port's test files (``tests/test_torch_*.py``).

* ``one_blas_thread``: an autouse, module-scoped fixture that a test file
  imports to run its tests with one BLAS thread.  pytest-xdist runs several
  test processes on the machine's cores, and each process's BLAS pool
  spins as many threads as there are cores: the host fits the port's
  environments make (thousands of small least-squares solves) ran several
  times slower oversubscribed than on one thread.  The limit lasts for the
  module only.
* ``jax_answers``: the JAX package's answers for one section of
  ``fixtures/port_tests_jax.npz`` (written by
  ``fixtures/make_port_tests_fixture.py``), after checking that the
  parameters they were computed at are the test's own.
"""

import json
import pathlib

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "port_tests_jax.npz"


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _plain(v):
    """JSON's view of a parameter (tuples and arrays as lists)."""
    return json.loads(json.dumps(v, default=lambda a: np.asarray(a).tolist()))


def jax_answers(section, **params):
    """``{name: array}`` of ``section/`` in the fixture, with the section
    prefix dropped; ``params`` must equal the parameters stored for it."""
    fx = np.load(FIXTURE)
    stored = json.loads(str(fx["params"]))[section]
    assert stored == _plain(params), (
        f"{FIXTURE.name} was written for other {section} parameters; run "
        "tests/fixtures/make_port_tests_fixture.py")
    head = f"{section}/"
    return {k[len(head):]: fx[k] for k in fx.files if k.startswith(head)}
