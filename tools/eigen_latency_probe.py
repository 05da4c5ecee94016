#!/usr/bin/env python3
"""Eigenray-search latency of several checkouts of the port, on one card.

    python3 tools/eigen_latency_probe.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``pygenray_tpu_torch`` package (this
repository's root, an unpacked ``git archive`` of another commit).  Every
ROOT is measured in a process of its own, in the order given (pass them as
A B B A to spread drift of the machine evenly), and prints one JSON line:

* ``config2`` / ``config3``: wall time of ``find_eigenrays`` on the headline
  Munk field (100 km, dx = 200 m, a 1,024-ray fan, one receiver depth and 64
  receiver depths; BASELINE configs 2 and 3): median and least of 30 calls
  after 5 warm-up calls, in ms;
* ``stages_ms``: the mean share of a config 2 call spent in the solver's
  tangent launches with its host synchronisations (``newton``), in the
  full-save ``trace`` call, in the rest of ``_device_solve`` (packing, the
  device→host copy) and in the host assembly of the ``EigenRays`` object,
  taken in a second pass with wall-clock timers around those functions;
* ``kernel_event_ms``: CUDA-event time of the tangent kernel's wrapper and of
  the fan kernel's wrapper alone at config 2's batch (its candidate count);
* ``trace_checks_us``: host time of one ``trace`` call's dispatch up to the
  kernel wrapper (the wrapper replaced by a stub).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

R_MAX, SRC, DX, NUM_SAVE = 100e3, 1300.0, 200.0, 50


def wall_ms(fn, sync, warm=5, n=30):
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(runs), "min": min(runs)}


def child(root):
    sys.path.insert(0, root)
    import torch

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch import eigenrays, integrate
    from pygenray_tpu_torch.ops import stepper

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    z = np.linspace(0.0, 6000.0, 2048)
    r = np.linspace(0.0, R_MAX, 32)
    env = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z, np.full(32, 5000.0), r,
                           dtype=torch.float32, device=dev)
    fan = pt.shoot_rays(SRC, 0.0, np.linspace(-14.0, 14.0, 1024), R_MAX, 2, env,
                        flatearth=False, dx=DX)

    def find(rds):
        return pt.find_eigenrays(fan, rds, SRC, 0.0, R_MAX, NUM_SAVE, env, ztol=1.0,
                                 flatearth=False, dx=DX)

    out = {"root": root}
    for name, rds in (("config2", [1300.0]), ("config3", np.linspace(500.0, 2100.0, 64))):
        out[name] = wall_ms(lambda: find(rds), sync)

    # second pass: wall-clock timers around the stages of a config 2 call
    acc = {"newton": 0.0, "full_save_trace": 0.0, "device_solve": 0.0}

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapper

    eigenrays._final_tangent = timed(eigenrays._final_tangent, "newton")
    eigenrays.trace = timed(eigenrays.trace, "full_save_trace")
    eigenrays._device_solve = timed(eigenrays._device_solve, "device_solve")
    for _ in range(5):
        er = find([1300.0])
    acc = dict.fromkeys(acc, 0.0)
    n = 30
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        find([1300.0])
    sync()
    total = (time.perf_counter() - t0) / n * 1e3
    st = {k: v / n * 1e3 for k, v in acc.items()}
    out["stages_ms"] = {
        "total": total, "newton": st["newton"], "full_save_trace": st["full_save_trace"],
        "device_solve_rest": st["device_solve"] - st["newton"] - st["full_save_trace"],
        "host_assembly_and_brackets": total - st["device_solve"]}
    nb = int(len(er.diagnostics["iterations"]))
    out["candidates"] = nb
    out["newton_iterations"] = int(er.diagnostics["iterations"].max(initial=0))

    # the two kernels' wrappers alone at config 2's batch
    p0 = torch.linspace(-1e-4, 1e-4, nb, device=dev)
    h, sps, nseg = integrate._plan(0.0, R_MAX, 2, DX)
    g2 = (0.0, R_MAX, h, sps, nseg)
    h, sps, nseg = integrate._plan(0.0, R_MAX, NUM_SAVE, DX)
    g50 = (0.0, R_MAX, h, sps, nseg)
    s = pt.SolverSettings(dx=DX)

    def events(fn, n=50):
        fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / n

    out["kernel_event_ms"] = {
        "trace_tangent": events(lambda: stepper.trace_tangent_kernel(env, SRC, p0, 1.0, g2, s)),
        "trace_fan": events(lambda: stepper.trace_kernel(env, SRC, p0, g50, s))}

    # trace()'s host dispatch alone
    real = stepper.trace_kernel
    stepper.trace_kernel = lambda *a, **k: None
    t0 = time.perf_counter()
    for _ in range(200):
        pt.trace(env, SRC, p0, 0.0, R_MAX, NUM_SAVE, s)
    out["trace_checks_us"] = (time.perf_counter() - t0) / 200 * 1e6
    stepper.trace_kernel = real
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
