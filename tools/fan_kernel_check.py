#!/usr/bin/env python3
"""First card run of a fan-kernel candidate: build a checkout's kernels,
print the fan kernel's ptxas report, and hold its range-independent path
(and one range-dependent and one segment launch) to the plain version.

    python3 tools/fan_kernel_check.py ROOT

ROOT holds a ``pygenray_tpu_torch`` package (this repository's root, an
unpacked ``git archive`` of another commit, a candidate's copy); the
comparisons are ``chip_smoke.py``'s (``build_context``, ``compare``,
``ri_k_phase``) from this repository.  The fans: the headline fan (102,400
rays over ±15°, 100 km, 50 saves), its Clenshaw and curved-bottom variants
(8,192 rays, 100 km), Kahan and ``terminate_backwards`` off (30 km), the
seamount with death codes 1-3 (20 km, both settings), 156 rays with 2
saves, the range-independent fits of ``ri_k_phase`` (K = 32, 64, 41, Horner
and Clenshaw), BASELINE config 1's field (B1c, 8,192 rays, 30 km) and the
rough field's realization 0 (B1d, 65,536 rays, 10 km).  One JSON line a
comparison; exits 1 if any failed.  About two minutes on an H100, most of
it the plain loops.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time
import traceback


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path.insert(0, root)
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch

    import chip_smoke as cs
    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
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
        if src and "trace_fan" in src and ("Compiling entry" in ln or "registers" in ln
                                           or "spill" in ln):
            print(ln.strip())
    cx = cs.build_context(torch, pt, dev)
    cx.stepper = stepper
    failed = []

    def fan(name, env, ang, z0, x1, s, nsave=cs.NUM_SAVE):
        try:
            h, sps, nseg = _plan(0.0, x1, nsave, s.dx)
            p0 = torch.as_tensor(cs.launch_p0(pt, env, ang), dtype=torch.float32, device=dev)
            z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
            res_k = stepper.trace_kernel(env, z0, p0, (0.0, x1, h, sps, nseg), s)
            res_p = pt.trace(env, z0, p0, 0.0, x1, nsave, dataclasses.replace(s, backend="ops"))
            torch.cuda.synchronize()
            cs.compare(name, res_k, res_p)
        except Exception:
            traceback.print_exc()
            failed.append(name)

    s = cx.settings
    s_off = dataclasses.replace(s, kahan=False, terminate_backwards=False)
    fan("headline", cx.env_h, np.linspace(-15, 15, 102_400), 1300.0, 100e3, s)
    fan("clenshaw", cx.env_c, cx.eq_angles, 1300.0, 100e3, s)
    fan("curved_bottom", cx.env_b, cx.eq_angles, 1300.0, 100e3, s)
    fan("kahan_off_no_term_back", cx.env_h, cx.eq_angles, 1300.0, 30e3, s_off)
    fan("seamount_deaths", cx.env_s, cx.death_angles, cx.z0_death, 20e3, s)
    fan("seamount_off", cx.env_s, cx.death_angles, cx.z0_death, 20e3, s_off)
    fan("eigen_like_2saves", cx.env_h, np.linspace(-14, 14, 156), 1300.0, 100e3, s, 2)
    try:
        cs.ri_k_phase(cx)
    except Exception:
        traceback.print_exc()
        failed.append("ri_k")
    fan("config1_b1c", cx.env_rd, cx.eq_angles, 1300.0, 30e3, cx.s_rd)
    c, rr, zr = cs.rough_field().rough_tables(pt.munk_ssp, 1)
    env_r = pt.make_env_data(c[0], rr, zr, np.full(len(rr), 5000.0), rr, dtype=torch.float32,
                             device=dev, interp="seg", seg_basis="cheb", seg_order=31,
                             seg_exact_order=True)
    fan("rough_b1d", env_r, np.linspace(-15, 15, 65_536), 1300.0, 10e3,
        pt.SolverSettings(dx=100.0), 2)
    print(json.dumps({"root": root, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
