#!/usr/bin/env python3
"""First card run of a kernel candidate: build a checkout's kernels, print
the ptxas report of each kernel family named, and hold the family's
kernels to their plain versions.

    python3 tools/kernel_check.py ROOT FAMILY [FAMILY ...]

ROOT holds a ``pygenray_tpu_torch`` package (this repository's root, an
unpacked ``git archive`` of another commit, a candidate's copy); the
comparisons are ``chip_smoke.py``'s from this repository.  The families:

``fan``  the fan kernel (``csrc/trace_fan.cu``): the headline fan (102,400
    rays over ±15°, 100 km, 50 saves), its Clenshaw and curved-bottom
    variants (8,192 rays, 100 km), Kahan and ``terminate_backwards`` off
    (30 km), the seamount with death codes 1-3 (20 km, both settings), 156
    rays with 2 saves, the range-independent fits of ``ri_k_phase`` (K =
    32, 64, 41, Horner and Clenshaw), BASELINE config 1's field (B1c, 8,192
    rays, 30 km) and the rough field's realization 0 (B1d, 65,536 rays,
    10 km); about two minutes on an H100.
``coef`` the range-independent coefficient-tangent kernel (B5,
    ``csrc/trace_coef_tangent.cu``): ``b5_fans_phase`` (bench.py's spectral
    Jacobian: 512 rays over ±14° and a bottom-bouncing 512 over ±30°, the
    16 unit directions, 100 km) and ``coef_lanes_phase`` (128 rays to
    30 km; K = 16 along 3 and 24 random directions, K = 32, 64 and 41 along
    their unit directions), each primal against the final-state tangent
    kernel; about three minutes on an H100.

Most of the time is the plain loops.  One JSON line a comparison or part;
exits 1 if any failed.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time
import traceback

# the build log's source names of each family's kernels
SOURCES = {"fan": "trace_fan", "coef": "coef_tangent"}


def fan_checks(cs, cx, pt, torch, stepper):
    """The fan kernel's comparisons: (name, thunk) pairs."""
    import numpy as np

    from pygenray_tpu_torch.integrate import _plan

    dev = cx.dev

    def fan(env, ang, z0, x1, s, nsave=cs.NUM_SAVE):
        def run():
            h, sps, nseg = _plan(0.0, x1, nsave, s.dx)
            p0 = torch.as_tensor(cs.launch_p0(pt, env, ang), dtype=torch.float32, device=dev)
            z = torch.as_tensor(z0, dtype=torch.float32, device=dev)
            res_k = stepper.trace_kernel(env, z, p0, (0.0, x1, h, sps, nseg), s)
            res_p = pt.trace(env, z, p0, 0.0, x1, nsave, dataclasses.replace(s, backend="ops"))
            torch.cuda.synchronize()
            return res_k, res_p
        return run

    def rough():
        c, rr, zr = cs.rough_field().rough_tables(pt.munk_ssp, 1)
        env_r = pt.make_env_data(c[0], rr, zr, np.full(len(rr), 5000.0), rr, dtype=torch.float32,
                                 device=dev, interp="seg", seg_basis="cheb", seg_order=31,
                                 seg_exact_order=True)
        return fan(env_r, np.linspace(-15, 15, 65_536), 1300.0, 10e3,
                   pt.SolverSettings(dx=100.0), 2)()

    s = cx.settings
    s_off = dataclasses.replace(s, kahan=False, terminate_backwards=False)
    fans = {
        "headline": fan(cx.env_h, np.linspace(-15, 15, 102_400), 1300.0, 100e3, s),
        "clenshaw": fan(cx.env_c, cx.eq_angles, 1300.0, 100e3, s),
        "curved_bottom": fan(cx.env_b, cx.eq_angles, 1300.0, 100e3, s),
        "kahan_off_no_term_back": fan(cx.env_h, cx.eq_angles, 1300.0, 30e3, s_off),
        "seamount_deaths": fan(cx.env_s, cx.death_angles, cx.z0_death, 20e3, s),
        "seamount_off": fan(cx.env_s, cx.death_angles, cx.z0_death, 20e3, s_off),
        "eigen_like_2saves": fan(cx.env_h, np.linspace(-14, 14, 156), 1300.0, 100e3, s, 2),
    }
    checks = [(name, lambda n=name, f=f: cs.compare(n, *f())) for name, f in fans.items()]
    checks.append(("ri_k", lambda: cs.ri_k_phase(cx)))
    checks.append(("config1_b1c", lambda: cs.compare(
        "config1_b1c", *fan(cx.env_rd, cx.eq_angles, 1300.0, 30e3, cx.s_rd)())))
    checks.append(("rough_b1d", lambda: cs.compare("rough_b1d", *rough())))
    return checks


def coef_checks(cs, cx, pt, torch, stepper):
    """B5's comparisons: (name, thunk) pairs."""
    cs.adjoint_context(cx)
    return [("b5_jacobian", lambda: cs.b5_fans_phase(cx)),
            ("coef_lanes", lambda: cs.coef_lanes_phase(cx))]


CHECKS = {"fan": fan_checks, "coef": coef_checks}


def main():
    families = sys.argv[2:]
    if len(sys.argv) < 3 or any(f not in CHECKS for f in families):
        print(__doc__, file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path.insert(0, root)
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parent.parent))
    import torch

    import chip_smoke as cs
    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.ops import _build, stepper

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(json.dumps({"root": root, "package": pt.__file__}), flush=True)
    t0 = time.time()
    _build.build()
    for name in stepper._ARGTYPES:
        stepper._kernel_fn(name)
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    src = None
    for ln in _build.BUILD_LOG.splitlines():
        src = ln if ln.startswith("==") else src
        if src and any(SOURCES[f] in src for f in families) and (
                "Compiling entry" in ln or "registers" in ln or "spill" in ln):
            print(ln.strip())
    cx = cs.build_context(torch, pt, dev)
    cx.stepper = stepper
    failed = []
    for family in families:
        for name, check in CHECKS[family](cs, cx, pt, torch, stepper):
            t0 = time.time()
            try:
                check()
            except Exception:
                traceback.print_exc()
                failed.append(name)
            print(json.dumps({"check": name, "s": time.time() - t0}), flush=True)
    print(json.dumps({"root": root, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
