#!/usr/bin/env python3
"""Device time of the inversion's kernels (B6 and the range-dependent fan,
B1c), of the other coefficient-tangent launches, of the fan kernel's
segment mode (B1d) and at the headline fan (B1a), of the ensemble tangent
kernel (B4), of the save-grid tangent kernel (B3) at the receiver side's
shapes and of the final-state tangent kernel (B2) at the eigenray solver's,
for several checkouts of the port on one card, with the wrapper's share
split off.

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
* ``b5_bounce``: the same on a bottom-bouncing fan, 512 rays over ±30°
  (``chip_smoke.py``'s ``JAC_BOUNCE_SPAN``);
* ``b5_d4``, ``b5_d8``: ``b5_bench`` along the first 4 and 8 unit
  directions only (a direction sweep: at 16 the card holds twice the warps
  of 8);
* ``b5_k32``, ``b5_k64``: the kernel on exact-order fits of the headline's
  Munk profile with K = 32 and 64 (compiled fixed), 128 rays over ±18°
  along the K unit directions, 30 km (``chip_smoke.RI_K_X1``), dx = 200 m;
* ``b2_clenshaw_8192``: ``trace_tangent_kernel`` on the headline field's
  Clenshaw series (as B5 reads it), 8,192 rays over ±14°, 100 km: the
  thread count of ``b5_bench`` (512 rays x 16 directions), one plain
  tangent a thread;
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
* ``b3_tl``, ``b3_array``, ``b3_headline``: ``trace_tangent_save_kernel``
  at the three shapes the receiver side gives it (``chip_smoke.py``'s
  ``save_tangent_times_phase``): ``examples/tl_demo.py``'s field and fan
  (``munk_env(r_max=120e3, nr=50, nz=1200)``, 2,001 angles over ±13°, source
  at 1000 m, 120 km, 301 saves, dx = 50 m: 2,400 steps); the eigenrays of
  ``examples/impulse_response_demo.py``'s ``array_response`` (100 km, 16
  receivers at 1100-1500 m, source at 1300 m, 400 saves, dx = 50 m: 1,995
  steps), taken from one warm call; and ``arrival_amplitudes`` over the
  headline fan (102,400 rays over ±15°, 100 km, 50 saves, dx = 200 m).  The
  device rows other than the kernel's are the wrapper's, among them its six
  save-grid transposes;
* ``receiver_walls``: the wall times of the two calls behind ``b3_tl`` and
  ``b3_array``, ``transmission_loss_field`` at ``examples/tl_demo.py``'s
  parameters (75 Hz, 251 depths x 300 ranges) and ``array_response`` at
  ``examples/impulse_response_demo.py``'s (2,048-ray fan, 75 Hz, bandwidth
  37.5 Hz), synchronized, the median of 5 after a warm call;
* ``b1a_headline``: ``trace_kernel`` at the headline fan (BASELINE config
  0: 102,400 rays over ±15°, 100 km, 50 saves, dx = 200 m: 490 steps);
  ``b1a_clenshaw``: the same fan on the field's Clenshaw series;
  ``b1a_eigen3``: the full-save fan of ``find_eigenrays`` at BASELINE
  config 3 (its 156 eigenray angles on the headline field, 50 saves);
  ``b1a_impulse``: the first fan of ``impulse_response`` at
  ``examples/impulse_response_demo.py``'s parameters
  (``munk_env(r_max=100e3, nr=50, nz=1200)``, 2,048 rays over ±14°, 400
  saves, dx = 50 m: 1,995 steps);
* ``b1a_host_split``: the wrapper's host time at the headline fan, split:
  ``stepper.step_geometry`` alone, ``trace_kernel`` given that geometry
  (the rest of the wrapper), and the whole call (medians of 20, each call
  on an idle card, none waiting for it);
* ``b2_config3``, ``b2_fan8192``: ``trace_tangent_kernel`` on the headline
  field at the eigenray solver's 2-save plan (100 km, dx = 200 m: 500
  steps), over BASELINE config 3's eigenray angles (the 156 that
  ``find_eigenrays`` finds from the 1,024-ray fan over ±14° for 64
  receivers at 500-2100 m, as ``chip_smoke.py`` phase 9 takes them) and
  over 8,192 rays over ±18°;
* ``eigen_walls``: the wall time of ``find_eigenrays`` at BASELINE configs
  2 (one receiver at 1300 m) and 3 (those 64), from that fan
  (synchronized, the median of 5 after a warm call, as ``chip_smoke.py``
  phase 9 times them), with the warm call's Newton iterations (the most any
  receiver took) and launch counts;
* ``inversion_solve``: ``examples/gradient_inversion_demo.py``'s 150 Adam
  steps at full size through ``travel_times_of_coef`` (one B1c and one B6
  launch a step), as ``chip_smoke.inversion_phase`` runs them: the wall
  time a step (synchronized at the end) and the misfit's drop.

``b3_tl`` and ``b6_2d`` run kernels whose code a B5 redesign does not
touch (B6 shares B5's source): they are the controls for the machine's
drift when B5 changes, as ``b5_bench`` is when another kernel changes.
Beside the cases,
``ptxas`` gives each kernel's registers and spill stores and loads from the
build's ``-Xptxas -v`` report, for the checkout that built its libraries
(the first of its runs).

The wrappers are called as a user calls them, without the per-step
geometry an inversion builds once (``stepper.step_geometry``), so that one
script times checkouts from before and after that argument.

``--cases``: only the named cases (comma-separated), each field built only
when a case needs it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np

SRC = 1300.0
N_LAUNCH = 20
# every case, in the order they run; --cases picks some of them
CASES = ("b5_bench", "b5_bounce", "b5_d4", "b5_d8", "b5_k32", "b5_k64", "b1d_rough", "b1d_rough_narrow", "b1d_ri_pow", "b1d_ri_cheb", "b6_2d",
         "b6_inversion", "b1c_inversion", "b1c_config1", "mc_config4b", "b4_fan", "b4_newton",
         "b3_tl", "b3_array", "b3_headline", "receiver_walls", "b1a_headline", "b1a_clenshaw",
         "b1a_eigen3", "b1a_impulse", "b1a_host_split", "b2_config3",
         "b2_fan8192", "b2_clenshaw_8192", "eigen_walls", "inversion_solve")
B3_CASES = ("b3_tl", "b3_array", "b3_headline")


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
        """the headline field: B5 at bench.py's Jacobian, B2 at 8,192 rays, B1a
        at the headline fan"""
        from pygenray_tpu_torch.adjoint import _deriv_matrix, _directions

        z = np.linspace(0.0, 6000.0, 2048)
        r = np.linspace(0.0, 100e3, 32)
        env = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z, np.full(32, 5000.0),
                               r, dtype=torch.float32, device=dev)
        c_src = float(np.interp(SRC, z, pt.munk_ssp(z)))
        dcs, dcps = _directions(_deriv_matrix(env))
        return {"z": z, "r": r, "env": env, "c_src": c_src, "s": pt.SolverSettings(dx=200.0),
                "env_c": dataclasses.replace(env, poly_ok=False),
                "g": geom(100e3, 200.0), "dcs": dcs, "dcps": dcps,
                "p0": p0_of(c_src, np.linspace(-14.0, 14.0, 512)),
                "p_bounce": p0_of(c_src, np.linspace(-30.0, 30.0, 512)),
                "p8": p0_of(c_src, np.linspace(-18.0, 18.0, 8192)),
                "p8_14": p0_of(c_src, np.linspace(-14.0, 14.0, 8192)),
                "p_head": p0_of(c_src, np.linspace(-15.0, 15.0, 102_400)),
                "g50": geom(100e3, 200.0, 50)}

    def f_coef_k():
        """exact-order fits of the headline's Munk profile, K = 32 and 64,
        with their K unit directions and a 128-ray fan over ±18° to 30 km"""
        from pygenray_tpu_torch.adjoint import _deriv_matrix, _directions

        h = field("headline")
        z, r = h["z"], h["r"]
        out = {"g": geom(30e3, 200.0), "p0": p0_of(h["c_src"], np.linspace(-18.0, 18.0, 128))}
        for order in (31, 63):
            env = pt.make_env_data(np.outer(np.ones(32), pt.munk_ssp(z)), r, z,
                                   np.full(32, 5000.0), r, dtype=torch.float32, device=dev,
                                   cheb_order=order, cheb_exact_order=True)
            out[order + 1] = (env, *_directions(_deriv_matrix(env)))
        return out

    def b5_k(K):
        f, s = field("coef_k"), field("headline")["s"]
        env, d, dp = f[K]
        return lambda: stepper.trace_coef_tangent_kernel(env, SRC, f["p0"], d, dp, f["g"], s)

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

    def f_receiver():
        """the receiver side's save-grid tangent launches (chip_smoke.py's
        save_tangent_times_phase): the TL demo's, the array response's
        eigenrays and the headline fan's, each (env, z0, p0, geom, settings)"""
        from pygenray_tpu_torch.envdata import host_profile_tables
        from pygenray_tpu_torch.models import munk_env

        def launch(env, src, angles, x1, num_save, s):
            c_src = float(pt.bilinear_np(0.0, src, *host_profile_tables(env)))
            return (env, src, p0_of(c_src, angles), (0.0, x1, *_plan(0.0, x1, num_save, s.dx)),
                    s)

        s50 = pt.SolverSettings(dx=50.0)
        ir = munk_env(r_max=100e3, nr=50, nz=1200)
        ar = pt.array_response(SRC, 0.0, np.linspace(1100.0, 1500.0, 16), 100e3, ir,
                               center_frequency=75.0, bandwidth=37.5, num_rays=2048,
                               max_angle=14.0, num_save=400, flatearth=False)
        eig = np.concatenate([r.arrivals.theta0 for r in ar.responses])
        h = field("headline")
        return {
            "b3_tl": launch(munk_env(r_max=120e3, nr=50, nz=1200).env_data(flatearth=False),
                            1000.0, np.linspace(-13.0, 13.0, 2001), 120e3, 301, s50),
            "b3_array": launch(ir.env_data(flatearth=False), SRC, eig, 100e3, 400, s50),
            "b3_headline": launch(h["env"], SRC, np.linspace(-15.0, 15.0, 102_400), 100e3, 50,
                                  h["s"]),
        }

    def f_eigen():
        """BASELINE configs 2 and 3 on the headline field: the solver's fan
        (1,024 rays over ±14°, 2 saves), the two calls, and config 3's
        eigenray angles as B2's launch on the solver's 2-save plan"""
        h = field("headline")
        env = h["env"]
        fan = pt.shoot_rays(SRC, 0.0, np.linspace(-14.0, 14.0, 1024), 100e3, 2, env,
                            flatearth=False, dx=200.0)
        calls = {name: (lambda rds=rds: pt.find_eigenrays(fan, rds, SRC, 0.0, 100e3, 50, env,
                                                          ztol=1.0, flatearth=False, dx=200.0))
                 for name, rds in (("config2", [1300.0]),
                                   ("config3", np.linspace(500.0, 2100.0, 64)))}
        er = calls["config3"]()
        th3 = np.concatenate([er.launch_angles[i] for i in range(64)
                              if len(er.launch_angles[i])])
        return {"calls": calls, "p0_3": p0_of(h["c_src"], th3)}

    def f_impulse():
        """impulse_response's first fan at the demo's parameters"""
        from pygenray_tpu_torch.envdata import host_profile_tables
        from pygenray_tpu_torch.models import munk_env

        env = munk_env(r_max=100e3, nr=50, nz=1200).env_data(flatearth=False)
        c_src = float(pt.bilinear_np(0.0, SRC, *host_profile_tables(env)))
        return {"env": env, "s": pt.SolverSettings(dx=50.0), "g": geom(100e3, 50.0, 400),
                "p0": p0_of(c_src, np.linspace(-14.0, 14.0, 2048))}

    def host_split():
        """the wrapper's host time at the headline fan: step_geometry, the
        rest given it, the whole call (ms, medians of N_LAUNCH)"""
        h = field("headline")
        geo = stepper.step_geometry(h["env"], h["g50"])
        call = lambda g=None: stepper.trace_kernel(h["env"], SRC, h["p_head"], h["g50"], h["s"],
                                                   g)
        return {"step_geometry_ms": host(lambda: stepper.step_geometry(h["env"], h["g50"])),
                "rest_ms": host(lambda: call(geo)), "whole_ms": host(call)}

    FIELDS = {"headline": f_headline, "impulse": f_impulse, "jac2d": f_jac2d, "coef_k": f_coef_k,
              "inversion": f_inversion,
              "config1": f_config1, "rough": f_rough, "seg_ri": f_seg_ri, "config4b": f_config4b,
              "receiver": f_receiver, "eigen": f_eigen}

    def b3(name):
        env, src, p0, g, s = field("receiver")[name]
        return lambda: stepper.trace_tangent_save_kernel(env, src, p0, 1.0, g, s)

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

    def eigen_walls():
        """the wall times of find_eigenrays at configs 2 and 3 (synchronized,
        median of 5 after a warm call), the warm call's Newton iterations
        and launch counts"""
        import time

        out = {}
        for name, call in field("eigen")["calls"].items():
            stepper.LAUNCHES = stepper.TANGENT_LAUNCHES = 0
            er = call()
            torch.cuda.synchronize()
            warm = {"iterations": int(er.diagnostics["iterations"].max(initial=0)),
                    "eigenrays": int(sum(er.num_eigenrays_found.values())),
                    "launches": {"trace_fan_f32": stepper.LAUNCHES,
                                 "trace_tangent_f32": stepper.TANGENT_LAUNCHES}}
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"median_ms": statistics.median(runs), "runs_ms": runs, **warm}
        return out

    def receiver_walls():
        """the wall times of transmission_loss_field and array_response at
        the demos' parameters (synchronized, median of 5 after a warm call)"""
        import time

        from pygenray_tpu_torch.models import munk_env

        tl_env, ir_env = munk_env(r_max=120e3, nr=50, nz=1200), munk_env(r_max=100e3, nr=50,
                                                                         nz=1200)
        calls = {
            "transmission_loss_field": lambda: pt.transmission_loss_field(
                1000.0, 0.0, np.linspace(-13.0, 13.0, 2001), 120e3, tl_env, frequency=75.0,
                depths=np.linspace(0.0, 5000.0, 251), num_range=301, flatearth=False),
            "array_response": lambda: pt.array_response(
                SRC, 0.0, np.linspace(1100.0, 1500.0, 16), 100e3, ir_env, center_frequency=75.0,
                bandwidth=37.5, num_rays=2048, max_angle=14.0, num_save=400, flatearth=False),
        }
        out = {}
        for name, call in calls.items():
            call()
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"median_ms": statistics.median(runs), "runs_ms": runs}
        return out

    # name: (what a launch runs, the kernel's name in the profiler's rows)
    cases = {
        "b5_bench": lambda: (lambda h=field("headline"): stepper.trace_coef_tangent_kernel(
            h["env"], SRC, h["p0"], h["dcs"], h["dcps"], h["g"], h["s"]), "coef_tangent"),
        "b5_bounce": lambda: (lambda h=field("headline"): stepper.trace_coef_tangent_kernel(
            h["env"], SRC, h["p_bounce"], h["dcs"], h["dcps"], h["g"], h["s"]), "coef_tangent"),
        **{f"b5_d{n}": (lambda n=n: (lambda h=field("headline"): stepper.trace_coef_tangent_kernel(
            h["env"], SRC, h["p0"], h["dcs"][:n], h["dcps"][:n], h["g"], h["s"]), "coef_tangent"))
           for n in (4, 8)},
        **{f"b5_k{K}": (lambda K=K: (b5_k(K), "coef_tangent")) for K in (32, 64)},
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
        "b1a_headline": lambda: (lambda h=field("headline"): stepper.trace_kernel(
            h["env"], SRC, h["p_head"], h["g50"], h["s"]), "trace_fan"),
        "b1a_clenshaw": lambda: (lambda h=field("headline"): stepper.trace_kernel(
            h["env_c"], SRC, h["p_head"], h["g50"], h["s"]), "trace_fan"),
        "b1a_eigen3": lambda: (lambda h=field("headline"), p=field("eigen")["p0_3"]:
                               stepper.trace_kernel(h["env"], SRC, p, h["g50"], h["s"]),
                               "trace_fan"),
        "b1a_impulse": lambda: (lambda f=field("impulse"): stepper.trace_kernel(
            f["env"], SRC, f["p0"], f["g"], f["s"]), "trace_fan"),
        "b2_config3": lambda: (lambda h=field("headline"), p=field("eigen")["p0_3"]:
                               stepper.trace_tangent_kernel(h["env"], SRC, p, 1.0, h["g"],
                                                            h["s"]), "trace_tangent"),
        "b2_fan8192": lambda: (lambda h=field("headline"): stepper.trace_tangent_kernel(
            h["env"], SRC, h["p8"], 1.0, h["g"], h["s"]), "trace_tangent"),
        "b2_clenshaw_8192": lambda: (lambda h=field("headline"): stepper.trace_tangent_kernel(
            h["env_c"], SRC, h["p8_14"], 1.0, h["g"], h["s"]), "trace_tangent"),
        **{name: (lambda name=name: (b3(name), "tangent_save")) for name in B3_CASES},
    }

    out = {"root": root, "package": pt.__file__, "card": torch.cuda.get_device_name(0)}
    for name in CASES:
        if name not in only:
            continue
        if name == "mc_config4b":
            out[name] = mc_config4b()
        elif name == "receiver_walls":
            out[name] = receiver_walls()
        elif name == "eigen_walls":
            out[name] = eigen_walls()
        elif name == "b1a_host_split":
            out[name] = host_split()
        elif name == "inversion_solve":
            f = field("inversion")
            out[name] = inversion_solve(torch, pt, dev, f["z"], f["r"], f["env"], f["s"])
        else:
            fn, kernel = cases[name]()
            out[name] = measure(fn, kernel)
            if name in B3_CASES:
                env, _, p0, g, _ = field("receiver")[name]
                out[name].update(rays=len(p0), steps=g[3] * g[4], saves=g[4] + 1,
                                 K=int(env.c_cheb.shape[-1]), horner=bool(env.poly_ok))
    if "b1d_rough" in out:
        out["b1d_rough"]["seg_terms"] = int(field("rough")["env"].c_seg.shape[-2])
    if "b1a_eigen3" in out:
        out["b1a_eigen3"]["rays"] = len(field("eigen")["p0_3"])
    if "b2_config3" in out:
        out["b2_config3"]["rays"] = len(field("eigen")["p0_3"])
    from pygenray_tpu_torch.ops import _build

    out["ptxas"] = ptxas_report(_build.BUILD_LOG)
    print(json.dumps(out), flush=True)


def ptxas_report(log):
    """{source: {kernel: [registers, spill store bytes, spill load bytes]}}
    from nvcc's ``-Xptxas -v`` output (``ops/_build.BUILD_LOG``; empty when
    this process found its libraries built), the names demangled by
    ``c++filt`` where it is installed and cut at their argument list."""
    import re
    import shutil

    rows, src, fn = {}, None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
            rows[src] = {}
        elif m := re.search(r"Compiling entry function '(\S+)'", ln):
            fn = m.group(1)
            rows[src][fn] = [None, None, None]
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            rows[src][fn][1:] = [int(m.group(1)), int(m.group(2))]
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            rows[src][fn][0] = int(m.group(1))
    names = [fn for r in rows.values() for fn in r]
    if names and shutil.which("c++filt"):
        dem = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(dem) == len(names):
            cut = dict(zip(names, (d.replace("(anonymous namespace)::", "").split("(")[0]
                                   for d in dem)))
            rows = {s: {cut[f]: v for f, v in r.items()} for s, r in rows.items()}
    return rows


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
