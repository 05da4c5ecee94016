"""Write ``port_tests_jax.npz``: JAX-package answers that the port's CPU
tests hold the port to, where computing them live costs a JAX compile of
many seconds in every test process.

Run from the repository root on a CPU (about half a minute):

    JAX_PLATFORMS=cpu python tests/fixtures/make_port_tests_fixture.py

The cases are the tests' own (imported from the test modules, so the two
cannot drift apart):

* ``tangent_rd/0`` ... ``/8`` — ``tests/test_torch_tangent.py``'s
  range-dependent reference: the final state, its tangent for a unit seed
  in p0 and the counters, by ``jax.jvp`` through the JAX package's scan
  without Kahan (float32, the monomial path off);
* ``response/*`` — ``tests/test_torch_response.py``'s end-to-end case: the
  JAX package's ``array_response`` on the float64 isovelocity slab (``t``,
  ``waveform``, and for receiver d every field of its ``Arrivals`` under
  ``response/d<d>/``).

The tests' parameters are stored beside the results (``params``, JSON), and
each test checks them against its own before it reads the answers.  The
Pallas kernels stay live in the tests (one interpreter run each).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
sys.path.insert(0, str(HERE.parent))  # the tests
OUT = HERE / "port_tests_jax.npz"


def params():
    """The test parameters the answers depend on, as the tests define them."""
    import test_torch_response as rsp
    import test_torch_tangent as tan

    return {
        "tangent_rd": {"x1": tan.X1, "dx": tan.DX, "angles": tan.ANGLES.tolist(), "nr": tan.NR},
        "response": {"c0": rsp.C0, "range": rsp.RANGE, "zd": rsp.ZD.tolist(), "e2e": rsp.E2E},
    }


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import test_torch_response as rsp
    import test_torch_tangent as tan

    out = {"params": np.array(json.dumps(params()))}

    je = dataclasses.replace(jp.make_env_data(*tan._tables("rd"), dtype=jnp.float32),
                             poly_ok=False)
    for j, a in enumerate(tan._jax_scan_tangent(je, jnp.asarray(tan._p0(), jnp.float32))):
        out[f"tangent_rd/{j}"] = np.asarray(a)

    env = jp.make_env_data(*rsp._slab(), dtype=np.float64)
    ar = jp.array_response(1000.0, 0.0, rsp.ZD, rsp.RANGE, env, **rsp.E2E)
    out["response/t"] = np.asarray(ar.t)
    out["response/waveform"] = np.asarray(ar.waveform)
    for d, resp in enumerate(ar.responses):
        for f in dataclasses.fields(resp.arrivals):
            v = getattr(resp.arrivals, f.name)
            if v is not None:
                out[f"response/d{d}/{f.name}"] = np.asarray(v)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
