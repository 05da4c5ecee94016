#!/usr/bin/env python3
"""Device time of the inversion's kernels (B6 and the range-dependent fan,
B1c), of the other coefficient-tangent launches, of the fan kernel's
segment mode (B1d) and of the ensemble tangent kernel (B4), for several
checkouts of the port on one card, with the wrapper's share split off.

    python3 tools/coef_tangent_probe.py [--cases A,B,...] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``pygenray_tpu_torch`` package (this
repository's root, an unpacked ``git archive`` of another commit).  Every
ROOT is measured in a process of its own, in the order given (pass them as
A B B A to spread drift of the machine evenly), and prints one JSON line.
For each case it gives, in ms a launch:

* ``event``: CUDA-event time of back-to-back wrapper calls, wrapper
  included (the mean of 20 launches after a warm-up, taken 5 times: the
  median and the least);
* ``kernel``: the kernel's own device time from ``torch.profiler``'s rows
  over 20 launches (the rows whose name holds the kernel's), and
  ``device_other``: every other device row of the same window (the
  wrapper's torch operations and copies);
* ``host``: the wrapper's host time, one call at a time on an idle card
  (median of 20; a wrapper that waits for the card inside is charged that
  wait).

The cases:

* ``b5_bench``: ``trace_coef_tangent_kernel`` at ``bench.py``'s spectral
  Jacobian (the headline Munk field, K = 16; 512 rays over ±14°, 100 km,
  dx = 200 m; the 16 unit directions);
* ``b6_2d``: ``trace_coef_tangent_rd_kernel`` at ``bench.py``'s 2D Jacobian
  (32 stations, axis deepening 2 m/km, nz = 2000, K = 16; 64 rays over
  ±12°, dx = 100 m);
* ``b6_inversion``: the same at ``examples/gradient_inversion_demo.py``'s
  step (9 stations, K = 32, dc/dz consistent; 128 rays over ±11°, 60 km,
  dx = 200 m) on its starting field;
* ``b1c_inversion``: ``trace_kernel`` on that field and fan, the step's
  2-save forward (Kahan off);
* ``b1c_config1``: ``trace_kernel`` at BASELINE config 1 (64 stations,
  axis deepening 2 m/km, bottom 4400 to 4900 m; 102,400 rays over ±15°,
  100 km, 50 saves, dx = 100 m);
* ``b1d_rough``: ``trace_kernel`` in its segment mode on realization 0 of
  ``bench.py``'s rough field (``tests/fixtures/rough_field.py``: Munk plus
  eight sines, nz = 2001, 16 stations, flat 5000 m; the Chebyshev segment
  fit of 32 terms the rough ensemble takes) at the shape the rough
  ``trace_ensemble`` gives each launch: 65,536 rays over ±15°, 100 km,
  dx = 100 m, 2 saves;
* ``b1d_rough_narrow``: the same launch with every ray within ±0.01°, so
  that a warp's rays pick the same segment column at each term (a
  diagnostic: the shared-memory gathers of ``b1d_rough`` scatter over the
  128 columns, and a scattered gather costs more wavefronts);
* ``b1d_ri_pow``, ``b1d_ri_cheb``: the segment mode on a range-independent
  Munk fit (nz = 2048; basis "pow", 8 terms, and "cheb", 32 terms), 8,192
  rays over ±18° to 30 km, dx = 200 m, 10 saves (``chip_smoke.py``'s
  ``seg_kernel_phase`` cases);
* ``mc_config4b``: BASELINE config 4b's ``mc_eigenray_times`` (config
  4's 16 internal-wave realizations of Munk, 64 Chebyshev terms; 512-angle
  fans over ±14°, receiver at 1300 m, 100 km, dx = 200 m, ztol = 1 m):
  its wall time, synchronized, the median of 5 after a warm call, and the
  launch counts of that warm call;
* ``b4_fan``, ``b4_newton``: ``trace_tangent_ensemble_kernel`` at the two
  shapes that call gives it, with the step rows built once
  (``integrate._ens_step_data``) as the call builds them: the fan, 16 x
  512 angles over ±14°, and a Newton batch, 16 x ``MC_BRACKET_CAP``
  candidates (each realization's arrivals from the warm call, the fan's
  last angle in the unused lanes, as ``chip_smoke.ens_tangent_phase``);
* ``b2_fan8192``: ``trace_tangent_kernel`` over 8,192 rays of the headline
  field, a kernel whose code these redesigns do not touch, as a control for
  the machine;
* ``inversion_solve``: ``examples/gradient_inversion_demo.py``'s 150 Adam
  steps at full size through ``travel_times_of_coef`` (one B1c and one B6
  launch a step), as ``chip_smoke.inversion_phase`` runs them: the wall
  time a step (synchronized at the end) and the misfit's drop.

The wrappers are called as a user calls them, without the per-step
geometry an inversion builds once (``stepper.step_geometry``), so that one
script times checkouts from before and after that argument.

``--cases``: only the named cases (comma-separated), each field built only
when a case needs it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np

SRC = 1300.0
N_LAUNCH = 20
# every case, in the order they run; --cases picks some of them
CASES = ("b5_bench", "b1d_rough", "b1d_rough_narrow", "b1d_ri_pow", "b1d_ri_cheb", "b6_2d",
         "b6_inversion", "b1c_inversion", "b1c_config1", "mc_config4b", "b4_fan", "b4_newton",
         "b2_fan8192", "inversion_solve")


def child(root, only=CASES):
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
    from pygenray_tpu_torch.ops import stepper

    dev = torch.device("cuda", 0)

    def events(fn, n=N_LAUNCH, reps=5):
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

    def host(fn, n=N_LAUNCH):
        import time

        runs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(runs)

    def split(fn, kernel, n=N_LAUNCH):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        mine = other = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if not t:
                continue
            if kernel in e.key:
                mine += t
            else:
                other += t
        return mine / n / 1e3, other / n / 1e3

    def measure(fn, kernel):
        ev = events(fn)
        k, o = split(fn, kernel)
        return {"event": ev, "kernel": k, "device_other": o, "host": host(fn)}

    def geom(x1, dx, nsave=2):
        h, sps, nseg = _plan(0.0, x1, nsave, dx)
        return (0.0, x1, h, sps, nseg)

    def p0_of(env_c, angles):
        return torch.as_tensor(np.sin(np.radians(-angles)) / env_c, dtype=torch.float32,
                               device=dev)

    # each field is built once, by the first case that needs it
    fields = {}

    def field(name):
        if name not in fields:
            fields[name] = FIELDS[name]()
        return fields[name]

    def f_headline():
        """the headline field: B5 at bench.py's Jacobian, B2 at 8,192 rays"""
        from pygenray_tpu_torch.adjoint import _deriv_matrix, _directions

        z = np.linspace(0.0, 6000.0, 2048)
        r = np.linspace(0.0, 100e3, 32)
        env = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z, np.full(32, 5000.0),
                               r, dtype=torch.float32, device=dev)
        c_src = float(np.interp(SRC, z, pt.munk_ssp(z)))
        dcs, dcps = _directions(_deriv_matrix(env))
        return {"z": z, "r": r, "env": env, "c_src": c_src, "s": pt.SolverSettings(dx=200.0),
                "g": geom(100e3, 200.0), "dcs": dcs, "dcps": dcps,
                "p0": p0_of(c_src, np.linspace(-14.0, 14.0, 512)),
                "p8": p0_of(c_src, np.linspace(-18.0, 18.0, 8192))}

    def f_jac2d():
        """bench.py's 2D Jacobian field"""
        from pygenray_tpu_torch.adjoint import _deriv_matrix, _directions

        z2 = np.linspace(0.0, 6000.0, 2000)
        r2 = np.linspace(0.0, 100e3, 32)
        c2 = np.array([pt.munk_ssp(z2, sofar_depth=1300 + 0.002 * ri) for ri in r2])
        env2 = pt.make_env_data(c2, r2, z2, np.full(32, 5500.0), r2, dtype=torch.float32,
                                device=dev, cheb_order=15)
        d2, dp2 = _directions(_deriv_matrix(env2))
        return {"env": env2, "s": pt.SolverSettings(dx=100.0, interp="cheb", kahan=False),
                "g": geom(100e3, 100.0), "d": d2, "dp": dp2,
                "p0": p0_of(float(pt.bilinear_np(0.0, SRC, r2, z2, c2)),
                            np.linspace(-12.0, 12.0, 64))}

    def f_inversion():
        """the gradient-inversion demo's step, on its starting field"""
        from pygenray_tpu_torch.adjoint import _CoefTimes, _directions

        z3 = np.linspace(0.0, 6000.0, 1200)
        r3 = np.linspace(0.0, 60e3, 9)
        env3 = pt.make_env_data(np.outer(np.ones(9), pt.munk_ssp(z3)), r3, z3,
                                np.full(9, 5500.0), r3, dtype=torch.float32, device=dev,
                                cheb_order=31, cheb_exact_order=True,
                                force_range_dependent=True, dcdz="consistent")
        s3 = pt.SolverSettings(dx=200.0, interp="cheb", kahan=False)
        c3 = np.interp(SRC, z3, env3.c[0].cpu().numpy())
        op = _CoefTimes(env3, SRC, np.sin(np.radians(-np.linspace(-11.0, 11.0, 128))) / c3,
                        0.0, 60e3, s3)
        d3, dp3 = _directions(op.Dm)
        return {"z": z3, "r": r3, "env": env3, "s": s3, "op": op, "envk": op.env_with(env3.c_cheb),
                "d": d3, "dp": dp3}

    def f_config1():
        """BASELINE config 1"""
        z = np.linspace(0.0, 6000.0, 2048)
        r1 = np.linspace(0.0, 100e3, 64)
        c1 = np.array([pt.munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r1])
        env1 = pt.make_env_data(c1, r1, z, np.linspace(4400.0, 4900.0, 64), r1,
                                dtype=torch.float32, device=dev)
        return {"env": env1, "s": pt.SolverSettings(dx=100.0), "g": geom(100e3, 100.0, 50),
                "p0": p0_of(float(pt.bilinear_np(0.0, SRC, r1, z, c1)),
                            np.linspace(-15.0, 15.0, 102_400))}

    def f_rough():
        """bench.py's rough field, realization 0 (tests/fixtures/rough_field.py)"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "rough_field", f"{root}/tests/fixtures/rough_field.py")
        rough = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rough)
        cr, rr, zr = rough.rough_tables(pt.munk_ssp, 1)
        env_r = pt.make_env_data(cr[0], rr, zr, np.full(len(rr), 5000.0), rr,
                                 dtype=torch.float32, device=dev, interp="seg",
                                 seg_basis="cheb", seg_order=31, seg_exact_order=True)
        c_r = float(pt.munk_ssp(np.asarray([SRC]))[0])
        return {"env": env_r, "s": pt.SolverSettings(dx=100.0), "g": geom(100e3, 100.0),
                "p0": p0_of(c_r, np.linspace(-15.0, 15.0, 65_536)),
                "p0_narrow": p0_of(c_r, np.linspace(-0.01, 0.01, 65_536))}

    def f_seg_ri():
        """range-independent segment fits of Munk, as chip_smoke's seg_kernel_phase"""
        h = field("headline")
        z, r = h["z"], h["r"]
        out = {"g": geom(30e3, 200.0, 10)}
        for basis in ("pow", "cheb"):
            e = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z, np.full(32, 5000.0),
                                 r, interp="seg", seg_basis=basis, dtype=torch.float32,
                                 device=dev)
            out[basis] = (e, p0_of(h["c_src"], np.linspace(-18.0, 18.0, 8192)))
        return out

    def f_config4b():
        """BASELINE config 4's ensemble (16 internal-wave realizations of
        Munk, nz = 1024, 32 stations over 100 km, flat 5000 m, 64 Chebyshev
        terms) and config 4b's call on it, as chip_smoke's mc_paths_phase
        and ens_tangent_phase run them: the B4 shapes of that call (the
        512-angle fan; 16 x MC_BRACKET_CAP Newton candidates, each
        realization's arrivals and the fan's last angle in the unused lanes)
        with the step rows built once, as the main path builds them"""
        from pygenray_tpu_torch.integrate import _ens_step_data
        from pygenray_tpu_torch.models import perturbed_munk_tables
        from pygenray_tpu_torch.montecarlo import MC_BRACKET_CAP

        c, r, z = perturbed_munk_tables(16, r_max=100e3, nr=32, nz=1024, seed=0)
        env = pt.make_env_ensemble(c, r, z, np.full(32, 5000.0), r, dtype=torch.float32,
                                   device=dev)
        s, g = pt.SolverSettings(dx=200.0), geom(100e3, 200.0)
        fan = np.linspace(-14.0, 14.0, 512)
        call = lambda: pt.mc_eigenray_times(env, fan, 1300.0, SRC, 0.0, 100e3, ztol=1.0,
                                            settings=s)
        mc = call()
        newton = np.full((16, MC_BRACKET_CAP), 14.0)
        newton[:, :mc["valid"].shape[1]] = np.where(mc["valid"], mc["theta"], 14.0)
        c_src = float(pt.munk_ssp(np.asarray([SRC]))[0])
        return {"env": env, "s": s, "g": g, "sd": _ens_step_data(env, g, s), "call": call,
                "path": mc["path"], "arrivals": int(mc["valid"].sum()),
                "fan": p0_of(c_src, np.broadcast_to(fan, (16, 512))),
                "newton": p0_of(c_src, newton)}

    FIELDS = {"headline": f_headline, "jac2d": f_jac2d, "inversion": f_inversion,
              "config1": f_config1, "rough": f_rough, "seg_ri": f_seg_ri, "config4b": f_config4b}

    def b4(shape):
        f = field("config4b")
        return lambda: stepper.trace_tangent_ensemble_kernel(f["env"], SRC, f[shape], 1.0, f["g"],
                                                             f["s"], f["sd"])

    def mc_config4b():
        """the wall time of config 4b's mc_eigenray_times (synchronized,
        median of 5 after the field's warm call), and its launch counts"""
        import time

        f = field("config4b")
        names = ("LAUNCHES", "TANGENT_ENS_LAUNCHES", "TANGENT_LAUNCHES")
        for n in names:
            setattr(stepper, n, 0)
        torch.cuda.synchronize()
        f["call"]()
        torch.cuda.synchronize()
        launches = {n: getattr(stepper, n) for n in names}
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f["call"]()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return {"median_ms": statistics.median(runs), "runs_ms": runs, "launches": launches,
                "path": f["path"], "arrivals": f["arrivals"]}

    # name: (what a launch runs, the kernel's name in the profiler's rows)
    cases = {
        "b5_bench": lambda: (lambda h=field("headline"): stepper.trace_coef_tangent_kernel(
            h["env"], SRC, h["p0"], h["dcs"], h["dcps"], h["g"], h["s"]), "coef_tangent"),
        "b1d_rough": lambda: (lambda f=field("rough"): stepper.trace_kernel(
            f["env"], SRC, f["p0"], f["g"], f["s"]), "trace_fan"),
        "b1d_rough_narrow": lambda: (lambda f=field("rough"): stepper.trace_kernel(
            f["env"], SRC, f["p0_narrow"], f["g"], f["s"]), "trace_fan"),
        "b1d_ri_pow": lambda: (lambda f=field("seg_ri"), s=field("headline")["s"]:
                               stepper.trace_kernel(f["pow"][0], SRC, f["pow"][1], f["g"], s),
                               "trace_fan"),
        "b1d_ri_cheb": lambda: (lambda f=field("seg_ri"), s=field("headline")["s"]:
                                stepper.trace_kernel(f["cheb"][0], SRC, f["cheb"][1], f["g"], s),
                                "trace_fan"),
        "b6_2d": lambda: (lambda f=field("jac2d"): stepper.trace_coef_tangent_rd_kernel(
            f["env"], SRC, f["p0"], f["d"], f["dp"], f["g"], f["s"]), "coef_tangent"),
        "b6_inversion": lambda: (lambda f=field("inversion"): stepper.trace_coef_tangent_rd_kernel(
            f["envk"], SRC, f["op"].p0, f["d"], f["dp"], f["op"].geom, f["s"]), "coef_tangent"),
        "b1c_inversion": lambda: (lambda f=field("inversion"): stepper.trace_kernel(
            f["envk"], SRC, f["op"].p0, f["op"].geom, f["s"]), "trace_fan"),
        "b1c_config1": lambda: (lambda f=field("config1"): stepper.trace_kernel(
            f["env"], SRC, f["p0"], f["g"], f["s"]), "trace_fan"),
        "b4_fan": lambda: (b4("fan"), "tangent_ens"),
        "b4_newton": lambda: (b4("newton"), "tangent_ens"),
        "b2_fan8192": lambda: (lambda h=field("headline"): stepper.trace_tangent_kernel(
            h["env"], SRC, h["p8"], 1.0, h["g"], h["s"]), "trace_tangent"),
    }

    out = {"root": root, "package": pt.__file__, "card": torch.cuda.get_device_name(0)}
    for name in CASES:
        if name not in only:
            continue
        if name == "mc_config4b":
            out[name] = mc_config4b()
        elif name == "inversion_solve":
            f = field("inversion")
            out[name] = inversion_solve(torch, pt, dev, f["z"], f["r"], f["env"], f["s"])
        else:
            fn, kernel = cases[name]()
            out[name] = measure(fn, kernel)
    if "b1d_rough" in out:
        out["b1d_rough"]["seg_terms"] = int(field("rough")["env"].c_seg.shape[-2])
    print(json.dumps(out), flush=True)


def inversion_solve(torch, pt, dev, z, r, env0, s, iters=150, lr=0.03, lam=1e-10):
    """The demo's inversion (a +3 m/s lens at 900 m and 40 % range; 128
    rays over ±11°, 60 km): ms a step over ``iters`` Adam steps after one
    warm-up step, and the misfit's drop."""
    import time

    from pygenray_tpu_torch.adjoint import travel_times_of_coef

    dc_true = (3.0 * np.exp(-(((z - 900.0) / 700.0) ** 2))[None, :]
               * np.exp(-(((r - 0.4 * r[-1]) / (0.18 * r[-1])) ** 2))[:, None])
    env_true = pt.make_env_data(np.outer(np.ones(len(r)), pt.munk_ssp(z)) + dc_true, r, z,
                                np.full(len(r), 5500.0), r, dtype=torch.float32, device=dev,
                                cheb_order=31, cheb_exact_order=True,
                                force_range_dependent=True, dcdz="consistent")
    c_src = np.interp(SRC, z, env0.c[0].cpu().numpy())
    p0 = (np.sin(np.radians(-np.linspace(-11.0, 11.0, 128))) / c_src).astype(np.float32)
    T_obs = travel_times_of_coef(env_true, SRC, p0, 0.0, float(r[-1]), s)(env_true.c_cheb)
    f = travel_times_of_coef(env0, SRC, p0, 0.0, float(r[-1]), s)
    cc0 = env0.c_cheb

    def value_and_grad(cc):
        c = cc.detach().requires_grad_(True)
        d = f(c) - T_obs
        val = 0.5 * (d * d).sum() + lam * ((c - cc0) ** 2).sum()
        (g,) = torch.autograd.grad(val, c)
        return val.detach(), g

    value_and_grad(cc0)
    cc, m, v = cc0.clone(), torch.zeros_like(cc0), torch.zeros_like(cc0)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(iters):
        val, g = value_and_grad(cc)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        cc = cc - lr * (m / (1 - 0.9 ** (it + 1))) / (torch.sqrt(v / (1 - 0.999 ** (it + 1)))
                                                       + 1e-12)
        hist.append(val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"ms_per_step": wall / iters * 1e3, "misfit_drop": float(hist[0]) / float(hist[-1])}


def main():
    args = sys.argv[1:]
    only = CASES
    if "--cases" in args:
        i = args.index("--cases")
        only = tuple(args[i + 1].split(","))
        del args[i:i + 2]
        unknown = set(only) - set(CASES)
        if unknown:
            print(f"unknown cases: {sorted(unknown)}", file=sys.stderr)
            return 2
    if len(args) == 2 and args[0] == "--child":
        child(args[1], only)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for root in args:
        rc = subprocess.run([sys.executable, __file__, "--child", root, "--cases",
                             ",".join(only)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
