#!/usr/bin/env python3
"""Device time of the coefficient-tangent kernels of several checkouts of
the port, on one card.

    python3 tools/coef_tangent_probe.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``pygenray_tpu_torch`` package (this
repository's root, an unpacked ``git archive`` of another commit).  Every
ROOT is measured in a process of its own, in the order given (pass them as
A B B A to spread drift of the machine evenly), and prints one JSON line of
CUDA-event times, wrapper included (the mean of 20 launches after a
warm-up, taken 5 times: the median and the least, in ms):

* ``b5_bench``: ``trace_coef_tangent_kernel`` at ``bench.py``'s spectral
  Jacobian (the headline Munk field, K = 16; 512 rays over ±14°, 100 km,
  dx = 200 m; the 16 unit directions);
* ``b6_2d``: ``trace_coef_tangent_rd_kernel`` at ``bench.py``'s 2D Jacobian
  (32 stations, axis deepening 2 m/km, nz = 2000, K = 16; 64 rays over
  ±12°, dx = 100 m);
* ``b6_inversion``: the same at ``examples/gradient_inversion_demo.py``'s
  step (9 stations, K = 32, dc/dz consistent; 128 rays over ±11°, 60 km,
  dx = 200 m) on its starting field;
* ``b2_fan8192``: ``trace_tangent_kernel`` over 8,192 rays of the headline
  field, a kernel the coefficient-tangent sources do not build, as a
  control for the machine.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np

SRC = 1300.0


def child(root):
    sys.path.insert(0, root)
    import torch

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.adjoint import _CoefTimes, _deriv_matrix, _directions
    from pygenray_tpu_torch.integrate import _plan
    from pygenray_tpu_torch.ops import stepper

    dev = torch.device("cuda", 0)

    def events(fn, n=20, reps=5):
        fn()
        runs = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            torch.cuda.synchronize()
            runs.append(e0.elapsed_time(e1) / n)
        return {"median": statistics.median(runs), "min": min(runs)}

    def geom(x1, dx):
        h, sps, nseg = _plan(0.0, x1, 2, dx)
        return (0.0, x1, h, sps, nseg)

    def p0_of(env_c, angles):
        return torch.as_tensor(np.sin(np.radians(-angles)) / env_c, dtype=torch.float32,
                               device=dev)

    out = {"root": root, "package": pt.__file__}
    # the headline field: B5 at bench.py's Jacobian, B2 at 8,192 rays
    z = np.linspace(0.0, 6000.0, 2048)
    r = np.linspace(0.0, 100e3, 32)
    env = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z, np.full(32, 5000.0), r,
                           dtype=torch.float32, device=dev)
    c_src = float(np.interp(SRC, z, pt.munk_ssp(z)))
    s, g = pt.SolverSettings(dx=200.0), geom(100e3, 200.0)
    dcs, dcps = _directions(_deriv_matrix(env))
    p0 = p0_of(c_src, np.linspace(-14.0, 14.0, 512))
    out["b5_bench"] = events(lambda: stepper.trace_coef_tangent_kernel(env, SRC, p0, dcs, dcps,
                                                                       g, s))
    p8 = p0_of(c_src, np.linspace(-18.0, 18.0, 8192))
    out["b2_fan8192"] = events(lambda: stepper.trace_tangent_kernel(env, SRC, p8, 1.0, g, s))

    # bench.py's 2D Jacobian field
    z2 = np.linspace(0.0, 6000.0, 2000)
    r2 = np.linspace(0.0, 100e3, 32)
    c2 = np.array([pt.munk_ssp(z2, sofar_depth=1300 + 0.002 * ri) for ri in r2])
    env2 = pt.make_env_data(c2, r2, z2, np.full(32, 5500.0), r2, dtype=torch.float32,
                            device=dev, cheb_order=15)
    s2, g2 = pt.SolverSettings(dx=100.0, interp="cheb", kahan=False), geom(100e3, 100.0)
    d2, dp2 = _directions(_deriv_matrix(env2))
    p2 = p0_of(float(pt.bilinear_np(0.0, SRC, r2, z2, c2)), np.linspace(-12.0, 12.0, 64))
    out["b6_2d"] = events(lambda: stepper.trace_coef_tangent_rd_kernel(env2, SRC, p2, d2, dp2, g2,
                                                                       s2))

    # the gradient-inversion demo's step, on its starting field
    z3 = np.linspace(0.0, 6000.0, 1200)
    r3 = np.linspace(0.0, 60e3, 9)
    env3 = pt.make_env_data(np.outer(np.ones(9), pt.munk_ssp(z3)), r3, z3, np.full(9, 5500.0), r3,
                            dtype=torch.float32, device=dev, cheb_order=31,
                            cheb_exact_order=True, force_range_dependent=True,
                            dcdz="consistent")
    s3 = pt.SolverSettings(dx=200.0, interp="cheb", kahan=False)
    c3 = np.interp(SRC, z3, env3.c[0].cpu().numpy())
    op = _CoefTimes(env3, SRC, np.sin(np.radians(-np.linspace(-11.0, 11.0, 128))) / c3, 0.0,
                    60e3, s3)
    env3k = op.env_with(env3.c_cheb)
    d3, dp3 = _directions(op.Dm)
    out["b6_inversion"] = events(lambda: stepper.trace_coef_tangent_rd_kernel(
        env3k, SRC, op.p0, d3, dp3, op.geom, s3))
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--child", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
