#!/usr/bin/env python3
"""How often the ported localization demo converges on the card, over the
clock-noise seed.

The demo (``examples/torch_port/localization_demo.py``) draws its 0.2 ms
picking noise from ``np.random.default_rng(7)``.  In float32 its
Gauss-Newton iteration is sensitive to rounding (one arrival sits near a
caustic), so whether it meets its 10 m assert depends on the last bits of
the residuals.  This runs the demo's ``run(device="cuda")`` with the
noise drawn from each of ``--seeds`` seeds instead, in two forms:

* ``shipped``: the demo as it is (the iterate's residual from the
  compensated trace, like its trial steps');
* ``jvp_primal``: the iterate's residual from the primal that
  ``torch.func.jvp`` returns with the Jacobian columns (uncompensated).

One JSON line a form: the seeds that converged, those that failed, and the
error of seed 7.  Run from the repository root on a machine with a card:

    python3 tools/localization_seed_probe.py [--seeds 40]

``--jax`` runs the JAX package's demo (``examples/localization_demo.py``,
float32, its XLA scan) over the same seeds on the CPU instead, its compile
cache and figures in a temporary directory:

    JAX_PLATFORMS=cpu python3 tools/localization_seed_probe.py --jax --seeds 20
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEMO = ROOT / "examples" / "torch_port" / "localization_demo.py"


def load(path=DEMO):
    spec = importlib.util.spec_from_file_location("localization_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jvp_primal_form(mod):
    """Make ``endpoints`` of the iterate that ``jvp_columns`` was just called
    on return that call's primal (the trial steps, new tensors, still
    trace)."""
    cols, ends, last = mod.jvp_columns, mod.endpoints, {}

    def jvp_columns(env, z0, p0, *a, **k):
        out = cols(env, z0, p0, *a, **k)
        last[(id(z0), id(p0))] = out[:2]
        return out

    def endpoints(env, z0, p0, *a, **k):
        return last.pop((id(z0), id(p0)), None) or ends(env, z0, p0, *a, **k)

    mod.jvp_columns, mod.endpoints = jvp_columns, endpoints


def seeded(seed):
    """``np.random.default_rng`` drawing from ``seed`` whatever it is asked
    for, until ``restore``."""
    rng = np.random.default_rng
    np.random.default_rng = lambda s: rng(seed)
    return lambda: setattr(np.random, "default_rng", rng)


def jax_main(seeds) -> int:
    """The JAX demo's ``main`` on the CPU over ``seeds``."""
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PYGENRAY_JAX_CACHE"] = tmp
        import jax

        jax.config.update("jax_platforms", "cpu")
        ok, failed = [], {}
        for seed in range(seeds):
            mod = load(ROOT / "examples" / "localization_demo.py")
            restore = seeded(seed)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    mod.main(outdir=tmp)
                ok.append(seed)
            except (AssertionError, np.linalg.LinAlgError) as e:
                failed[seed] = f"{type(e).__name__}: {e}"[:80]
            finally:
                restore()
    print(json.dumps({"form": "jax_cpu", "seeds": seeds, "converged": len(ok),
                      "failed": failed}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--jax", action="store_true", help="the JAX demo on the CPU")
    args = ap.parse_args()
    if args.jax:
        return jax_main(args.seeds)
    import torch

    if not torch.cuda.is_available():
        print("localization_seed_probe: no CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for form in ("shipped", "jvp_primal"):
        ok, failed, err7 = [], {}, None
        for seed in range(args.seeds):
            mod = load()
            if form == "jvp_primal":
                jvp_primal_form(mod)
            restore = seeded(seed)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    res = mod.run(smoke=False, device="cuda")
                ok.append(seed)
                err7 = res["error_m"] if seed == 7 else err7
            except (AssertionError, np.linalg.LinAlgError) as e:
                failed[seed] = f"{type(e).__name__}: {e}"[:80]
            finally:
                restore()
        print(json.dumps({"form": form, "card": smi, "seeds": args.seeds, "converged": len(ok),
                          "failed": failed, "seed7_error_m": err7}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
