#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pygenray_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pygenray_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel) and holds each against its plain PyTorch
version on the card: the forward fan kernel (``trace_fan.cu``,
range-independent and range-dependent) and the forward-tangent kernel
(``trace_tangent.cu``).  It drives the main paths through them: the
headline 102,400-ray Munk fan (``shoot_rays``), BASELINE config 1's
range-dependent fan at full width, and the eigenray search
(``find_eigenrays`` / ``find_eigenrays_batch``) on BASELINE configs 2 and 3
and three more cases, held against the JAX package's answers
(``tests/fixtures/eigen_jax_f32.npz``, written on a CPU by
``tests/fixtures/make_eigen_fixture.py``) and the scipy oracle fixtures.
It times kernels, plain versions and eigenray latencies.  Each phase prints
one line; the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero without that line.  It needs no network and
imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
ORACLE = FIXTURES / "bench_oracle_100km.npz"
ORACLE_RD = FIXTURES / "bench_oracle_rd.npz"
EIGEN_JAX = FIXTURES / "eigen_jax_f32.npz"

# the headline fan (BASELINE config 0; the JAX package's bench.py)
R_MAX = 100e3
NUM_RAYS = 102_400
ANGLE_SPAN = 15.0
SRC_DEPTH = 1300.0
NUM_SAVE = 50
NZ = 2048
NR = 32
DX = 200.0

# kernel vs plain version on the card.  Both round every operation to
# float32 in the same order (the kernel is built with -fmad=false), and
# every run so far agreed bit for bit, so counters, death codes and
# alive_save must agree on every ray, and every saved value within a few
# float32 ulp of its size: (bound, magnitude) = travel time 1e-5 s per 67 s
# (about one ulp), depth 2e-3 m per 5000 m (4 ulp), ray parameter 2.5e-10
# s/m per 1/1500 s/m (4 ulp).  Smaller values get the bound itself, larger
# ones (a dead ray's frozen state: the last step before a vertical turn can
# take T past 1e6 s) the bound scaled by value / magnitude.
TOLS = {"ts": (1e-5, 67.0), "zs": (2e-3, 5000.0), "ps": (2.5e-10, 1.0 / 1500.0)}
# tangent kernel vs its plain version: the final state within TOLS, and its
# tangent with respect to p0 within 4 float32 ulp of a stated magnitude,
# scaled the same way: dz/dp0 ~ 1e8 m per (s/m) (ulp 8), dT/dp0 ~ 1e4 s
# per (s/m) (Fermat: p_end dz/dp0; ulp 1e-3), dp/dp0 ~ 1 (ulp 1.2e-7).
TAN_TOLS = {"T": (1e-5, 67.0), "z": (2e-3, 5000.0), "p": (2.5e-10, 1.0 / 1500.0),
            "dT": (4e-3, 1e4), "dz": (32.0, 1e8), "dp": (5e-7, 1.0)}
TAN_FIELDS = ("T", "z", "p", "dT", "dz", "dp")
# eigenrays vs the JAX package (tests/test_eigenray_newton.py's bounds)
EIG_ANGLE_DEG = 5e-3
EIG_TIME_S = 1e-5

# bounds: FP32 operations a ray-step, counted from the sources (one op per
# add, multiply, divide, compare-select or special function), over the
# card's published peaks (NVIDIA's H100 SXM data sheet, 700 W: 67 TFLOP/s
# FP32 outside the tensor cores, 3.35 TB/s HBM)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# a Dual operation costs 2.5 plain ones (a Horner term: 5 against 2)
DUAL_FACTOR = 2.5
ORACLE_BUDGET_MS = 0.1  # BASELINE.json travel-time budget
# final depth vs the oracle: the depth a 15-degree ray crosses within the
# travel-time budget, 0.1 ms * 1500 m/s / sin(15 deg) = 0.58 m, rounded down
ORACLE_DEPTH_M = 0.5


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def headline_env(torch, pt, device, bathy=None):
    """bench.py's build_env, inside the port (optionally with another
    bottom)."""
    z = np.linspace(0.0, 6000.0, NZ)
    r = np.linspace(0.0, R_MAX, NR)
    c = np.outer(np.ones(NR), pt.munk_ssp(z))
    bathy = np.full(NR, 5000.0) if bathy is None else bathy
    return pt.make_env_data(c, r, z, bathy, r, dtype=torch.float32, device=device)


def launch_p0(pt, env, angles):
    """ODE-convention ray parameters for user launch angles, as shoot_rays
    computes them."""
    from pygenray_tpu_torch.envdata import host_profile_tables

    r_h, z_h, c_h = host_profile_tables(env)
    c_src = float(pt.bilinear_np(0.0, SRC_DEPTH, r_h, z_h, c_h))
    return np.sin(np.radians(-np.asarray(angles, float))) / c_src


def diff_ratio(a, b, tol, mag):
    """``(|a - b|, its largest ratio to the bound)``: the bound is ``tol``
    below ``mag`` and ``tol * |b| / mag`` above it.  Equal values
    (infinities included) and NaN in both agree; NaN or an infinity in one
    only gives a NaN ratio, which fails any ``<= 1`` check."""
    import torch

    d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
    r = torch.where(d == 0, 0.0, d / (tol * (b.abs() / mag).clamp_min(1.0)))
    return d, float(r.max())


def compare(name, res_k, res_p):
    """Hold a kernel result to its plain version (see TOLS); print the
    phase line and return the max absolute errors at live save points."""
    import torch

    same = ((res_k.n_surf == res_p.n_surf) & (res_k.n_bott == res_p.n_bott)
            & (res_k.death_code == res_p.death_code))
    live = res_p.alive_save
    errs, ratios = {}, {}
    for f, (tol, mag) in TOLS.items():
        d, ratios[f] = diff_ratio(getattr(res_k, f), getattr(res_p, f), tol, mag)
        errs[f] = float(d[live].max()) if bool(live.any()) else 0.0
    codes = torch.bincount(res_p.death_code.long(), minlength=4).tolist()
    as_eq = bool(torch.equal(res_k.alive_save, res_p.alive_save))
    emit("kernel_vs_plain", case=name, rays=res_p.ts.shape[0],
         bounces=int((res_p.n_surf + res_p.n_bott).sum()), death_codes=codes,
         rays_differing=int((~same).sum()), alive_save_equal=as_eq,
         max_abs_err_live=errs, max_err_over_bound=ratios)
    require(bool(same.all()), f"{name}: counters or death codes differ on "
            f"{int((~same).sum())} rays")
    require(as_eq, f"{name}: alive_save differs")
    for f, r in ratios.items():
        require(r <= 1.0, f"{name}: {f} differ by {r:.3g} times the bound {TOLS[f]}")
    require(bool(torch.isfinite(res_k.ts[live]).all()), f"{name}: non-finite kernel ts")
    return errs


def worst(errs_list):
    return {f: max(e[f] for e in errs_list) for f in TOLS}


def rd_env(torch, pt, device):
    """BASELINE config 1 (bench.py's range-dependent field): 64 stations of
    a Munk profile whose axis deepens 2 m per km, over a bottom sloping
    from 4400 m to 4900 m."""
    z = np.linspace(0.0, 6000.0, NZ)
    r = np.linspace(0.0, R_MAX, 64)
    c = np.array([pt.munk_ssp(z, sofar_depth=1300 + 0.002 * ri) for ri in r])
    return pt.make_env_data(c, r, z, np.linspace(4400.0, 4900.0, 64), r,
                            dtype=torch.float32, device=device)


def step_ops(env):
    """FP32 operations of one forward ray-step without a crossing, counted
    from csrc/trace_fan.cu: four right-hand sides (two K-term series each,
    Horner 2 ops a term or Clenshaw 4, plus 18 around them) and about 50
    for the RK4 sums, the crossing tests, the accumulation and the death
    checks."""
    K = env.c_cheb.shape[-1]
    poly = (K - 1) * 2 + 1 if env.poly_ok else (K - 1) * 4 + 3
    return 4 * (2 * poly + 18) + 50


def bound(ops, nbytes):
    """(least time in ms, what bounds it) for this many operations and
    bytes at the card's published peaks."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def step_input_bytes(env, nsteps):
    """Per-step inputs: bathymetry at both ends and the domain flag, plus
    four coefficient rows for a range-dependent field."""
    K = env.c_cheb.shape[-1]
    return nsteps * (9 + (16 * K if env.range_dependent else 0))


def fan_bound(res, env, sps):
    """Bound of one forward launch for this result: the ray-steps its rays
    lived (a dead ray stops), each input read and each output written
    once."""
    B, S = res.ts.shape
    ray_steps = float((res.alive_save.sum(1) - 1).clamp(min=0).sum()) * sps
    nbytes = B * (8 + 12 * S + 16) + step_input_bytes(env, (S - 1) * sps)
    return bound(ray_steps * step_ops(env), nbytes)


def tangent_bound(out, env, nsteps):
    """Bound of one tangent launch: live rays' steps at DUAL_FACTOR times
    the forward operations (dead rays counted as none), 12 B in and 36 B
    out per ray."""
    B = out[0].shape[0]
    live = int((out[8] == 0).sum())
    return bound(live * nsteps * step_ops(env) * DUAL_FACTOR,
                 B * 48 + step_input_bytes(env, nsteps))


def compare_tangent(name, out_k, out_p, finite=True):
    """Hold the tangent kernel to its plain version (TAN_TOLS); print the
    phase line and return the max absolute errors on live rays.  With
    ``finite``, every live ray's tangent must be finite (a ray that grazes
    a steep bottom can have an infinite one, in both versions alike)."""
    import torch

    differing = int(sum((a != b) for a, b in zip(out_k[6:], out_p[6:])).bool().sum())
    live = out_p[8] == 0
    errs, ratios = {}, {}
    for f, a, b in zip(TAN_FIELDS, out_k[:6], out_p[:6]):
        d, ratios[f] = diff_ratio(a, b, *TAN_TOLS[f])
        errs[f] = float(d[live].max()) if bool(live.any()) else 0.0
    codes = torch.bincount(out_p[8].long(), minlength=4).tolist()
    nonfinite = int((live & ~(torch.isfinite(out_k[3]) & torch.isfinite(out_k[4]))).sum())
    emit("tangent_vs_plain", case=name, rays=int(out_p[0].shape[0]),
         bounces=int((out_p[6] + out_p[7]).sum()), death_codes=codes,
         rays_differing=differing, live_rays_with_infinite_tangent=nonfinite,
         max_abs_err_live=errs, max_err_over_bound=ratios)
    require(differing == 0, f"{name}: tangent counters or death codes differ on {differing} rays")
    for f, r in ratios.items():
        require(r <= 1.0, f"{name}: {f} differ by {r:.3g} times the bound {TAN_TOLS[f]}")
    require(nonfinite == 0 or not finite, f"{name}: non-finite tangents on {nonfinite} live rays")
    return errs


def lockstep(name, out_t, res_f):
    """The tangent kernel's primal is the forward kernel's final state
    without Kahan compensation, within TOLS."""
    import torch

    same = bool(torch.equal(out_t[6], res_f.n_surf) and torch.equal(out_t[7], res_f.n_bott)
                and torch.equal(out_t[8], res_f.death_code))
    ratios = {f: diff_ratio(a, b, *TOLS[f])[1] for f, a, b in
              zip(TOLS, out_t[:3], (res_f.ts[:, -1], res_f.zs[:, -1], res_f.ps[:, -1]))}
    emit("tangent_primal_vs_fan_kahan_off", case=name, counters_equal=same,
         max_err_over_bound=ratios)
    require(same, f"{name}: tangent and fan kernels disagree on counters or death codes")
    for f, r in ratios.items():
        require(r <= 1.0, f"{name}: tangent primal {f} off the fan kernel by {r:.3g} bounds")


def eigen_case(torch, pt, dev, stepper, case, envs):
    """Run one fixture case through the port; check it against the JAX
    package's answers and the launch counts; return the EigenRays list and
    the launches (fan kernel, tangent kernel) of the eigenray call."""
    from pygenray_tpu_torch.models import munk_env

    ref = np.load(EIGEN_JAX)
    name = case["name"]
    angles = np.linspace(case["fan"][0], case["fan"][1], int(case["fan"][2]))
    kw = dict(ztol=case["ztol"], flatearth=False, dx=case["dx"], method=case["method"])
    batch = case["env"] == "munk_env"
    if batch:
        env = munk_env(r_max=R_MAX, nr=8, nz=2000)  # an OceanEnvironment2D
        stepper.LAUNCHES = stepper.TANGENT_LAUNCHES = 0
        ers = pt.find_eigenrays_batch(angles, case["receivers"], case["sources"], 0.0, R_MAX,
                                      NUM_SAVE, env, dtype="float32", **kw)
    else:
        env = envs[case["env"]]
        src = case["sources"][0]
        fan = pt.shoot_rays(src, 0.0, angles, R_MAX, 2, env, flatearth=False,
                            dx=case["fan_dx"])
        stepper.LAUNCHES = stepper.TANGENT_LAUNCHES = 0
        ers = [pt.find_eigenrays(fan, case["receivers"], src, 0.0, R_MAX, NUM_SAVE, env, **kw)]
    torch.cuda.synchronize()
    launches = (stepper.LAUNCHES, stepper.TANGENT_LAUNCHES)
    counts, angs, tss, it_max, zmiss, resid = [], [], [], 0, 0.0, 0.0
    for er in ers:
        for i, rd in enumerate(case["receivers"]):
            n = int(er.num_eigenrays_found[i])
            counts.append(n)
            if n:
                order = np.argsort(er.launch_angles[i])
                angs.append(np.asarray(er.launch_angles[i], float)[order])
                tss.append(np.asarray(er.ts[i], float)[order, -1])
                zmiss = max(zmiss, float(np.max(np.abs(er.zs[i][:, -1] + rd))))
        d = er.diagnostics
        it_max = max(it_max, int(d["iterations"].max(initial=0)))
        resid = max(resid, float(d["depth_residual"][d["converged"]].max(initial=0.0)))
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0)
    angs, tss = cat(angs), cat(tss)
    counts_eq = bool(np.array_equal(counts, ref[f"{name}/counts"]))
    err_a = float(np.max(np.abs(angs - ref[f"{name}/angles"]), initial=0.0)) if counts_eq else None
    err_t = float(np.max(np.abs(tss - ref[f"{name}/ts"]), initial=0.0)) if counts_eq else None
    # one full-save fan launch (plus the batched fan); Newton iterates on
    # the tangent kernel, regula falsi on the fan kernel
    fans = 2 if batch else 1
    want = (fans, it_max) if case["method"] == "newton" else (fans + it_max, 0)
    emit("eigenrays_vs_jax", case=name, method=case["method"], eigenrays=int(sum(counts)),
         counts_equal=counts_eq, max_angle_err_deg=err_a, max_time_err_s=err_t,
         max_residual_m=resid, max_full_save_depth_miss_m=zmiss, ztol_m=case["ztol"],
         iterations=it_max,
         jax_iterations=int(ref[f"{name}/iterations"]),
         launches={"trace_fan_f32": launches[0], "trace_tangent_f32": launches[1]})
    require(counts_eq, f"eigenrays {name}: counts {counts} differ from the JAX package's")
    require(sum(counts) > 0, f"eigenrays {name}: none found")
    require(err_a <= EIG_ANGLE_DEG, f"eigenrays {name}: angles off by {err_a:.3g} deg")
    require(err_t <= EIG_TIME_S, f"eigenrays {name}: times off by {err_t:.3g} s")
    # every found ray ends within ztol of its receiver in the solver's own
    # final-state shot (the full-save trace, on the save plan's step and
    # with Kahan, may end a few centimetres further off in float32)
    require(resid < case["ztol"], f"eigenrays {name}: a ray misses its receiver by {resid} m")
    require(launches == want, f"eigenrays {name}: launches {launches}, expected {want}")
    return ers, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan, _trace_tangent_impl
    from pygenray_tpu_torch.ops import _build, stepper

    require("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    # ---- phase 1: the card ------------------------------------------------
    emit("card", nvidia_smi=smi, torch_device=kind, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- phase 2: build the kernels (one nvcc per source, in parallel) -----
    t0 = time.perf_counter()
    libs = _build.build()
    for name in stepper._ARGTYPES:
        stepper._kernel_fn(name)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("==")]
    emit("build", seconds=round(build_s, 3), libraries=[p.name for p in libs.values()],
         ptxas=ptxas)

    # ---- phase 3: kernel vs plain on the card -----------------------------
    settings = pt.SolverSettings(dx=DX)
    env_h = headline_env(torch, pt, dev)
    require(env_h.has_cheb and env_h.poly_ok and env_h.bangle_mode == "const"
            and not env_h.range_dependent, "headline env is not the Horner variant")
    env_c = dataclasses.replace(env_h, poly_ok=False)
    # curved bottom: the Chebyshev bottom-angle series
    env_b = headline_env(torch, pt, dev,
                         4400.0 + 300.0 * np.sin(np.linspace(0.0, R_MAX, NR) / 30e3))
    require(env_b.bangle_mode == "cheb", "curved-bottom env has no Chebyshev bottom angle")
    # a 26-degree seamount flank over 20 km (one period of a cosine, which
    # the bottom-angle series fits): steep rays reflect off it backwards
    r_s = np.linspace(0.0, 20e3, NR)
    env_s = pt.make_env_data(np.outer(np.ones(NR), pt.munk_ssp(np.linspace(0.0, 6000.0, NZ))),
                             r_s, np.linspace(0.0, 6000.0, NZ),
                             3200.0 + 1600.0 * np.cos(2 * np.pi * r_s / 20e3), r_s,
                             dtype=torch.float32, device=dev)
    require(env_s.bangle_mode == "cheb", "seamount env has no Chebyshev bottom angle")
    n_eq = 8192
    eq_angles = np.linspace(-18.0, 18.0, n_eq)
    # steep fan, vertical rays (death code 1), backwards reflections (code
    # 3) and a source below the domain (code 2), as in the CPU tests
    death_angles = np.concatenate([np.linspace(-60.0, 60.0, n_eq - 4),
                                   [-90.0, -89.999, 89.999, 0.0]])
    z0_death = np.full(n_eq, SRC_DEPTH)
    z0_death[-1] = 6500.0
    s_off = dataclasses.replace(settings, kahan=False, terminate_backwards=False)
    cases = (
        ("horner", env_h, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("clenshaw", env_c, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("horner_curved_bottom", env_b, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("horner_kahan_off_no_term_back", env_h, eq_angles, SRC_DEPTH, R_MAX, s_off),
        ("seamount_deaths", env_s, death_angles, z0_death, 20e3, settings),
        ("seamount_kahan_off_no_term_back", env_s, death_angles, z0_death, 20e3, s_off),
    )
    errs_all = []
    for name, env, ang, z0, x1, s in cases:
        h, sps, nseg = _plan(0.0, x1, NUM_SAVE, DX)
        p0 = torch.as_tensor(launch_p0(pt, env, ang), dtype=torch.float32, device=dev)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
        res_k = stepper.trace_kernel(env, z0, p0, (0.0, x1, h, sps, nseg), s)
        res_p = pt.trace(env, z0, p0, 0.0, x1, NUM_SAVE, dataclasses.replace(s, backend="ops"))
        torch.cuda.synchronize()
        errs_all.append(compare(name, res_k, res_p))
        if name == "seamount_deaths":
            codes = set(res_p.death_code.tolist())
            require({1, 2, 3} <= codes, f"{name}: death codes {sorted(codes)} lack 1, 2 or 3")
    h, sps, nseg = _plan(0.0, R_MAX, NUM_SAVE, DX)
    geom = (0.0, R_MAX, h, sps, nseg)

    # ---- phase 4: the main path at full size -------------------------------
    angles = np.linspace(-ANGLE_SPAN, ANGLE_SPAN, NUM_RAYS)
    stepper.LAUNCHES = 0
    t0 = time.perf_counter()
    fan = pt.shoot_rays(SRC_DEPTH, 0.0, angles, R_MAX, NUM_SAVE, env_h, dx=DX,
                        flatearth=False)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = stepper.LAUNCHES
    require(launches == 1, f"main path launched the kernel {launches} times, not once")
    # shoot_rays drops dead rays like the reference; on this fan the JAX
    # package drops 13 near-grazing surface reflectors (death code 2) too
    kept = fan.ts.shape[0]
    require(kept >= 0.999 * NUM_RAYS and fan.ts.shape[1] == NUM_SAVE,
            f"headline fan kept {kept} of {NUM_RAYS} rays")
    require(np.isfinite(fan.ts).all() and np.isfinite(fan.zs).all(),
            "headline fan has non-finite values")

    oracle = np.load(ORACLE)
    fan_o = pt.shoot_rays(SRC_DEPTH, 0.0, oracle["angles"], R_MAX, NUM_SAVE, env_h,
                          dx=DX, flatearth=False)
    require(len(fan_o.ts) == len(oracle["angles"]), "oracle rays were dropped")
    err_ms = float(np.max(np.abs(fan_o.ts[:, -1] - oracle["ts"])) * 1e3)
    err_z = float(np.max(np.abs(fan_o.zs[:, -1] - oracle["zs"])))
    emit("main_path", rays=NUM_RAYS, kept=kept, saves=NUM_SAVE, seconds=main_s,
         launches=launches,
         max_travel_time_err_ms=err_ms, max_final_depth_err_m=err_z,
         budget_ms=ORACLE_BUDGET_MS, depth_limit_m=ORACLE_DEPTH_M)
    require(err_ms <= ORACLE_BUDGET_MS, f"travel-time error {err_ms:.4f} ms over budget")
    require(err_z <= ORACLE_DEPTH_M, f"final-depth error {err_z:.4f} m over {ORACLE_DEPTH_M} m")

    # README quick start: default environment (flat-earth Munk, sloping
    # bottom), 1024 rays, 200 saves; no device= — the default is the card
    n0 = stepper.LAUNCHES
    quick_env = pt.OceanEnvironment2D()
    quick = pt.shoot_rays(1300.0, 0.0, np.linspace(-15, 15, 1024), 100e3, 200, quick_env)
    on_card = [e.device.type == "cuda" for e in quick_env._envdata_cache.values()]
    require(quick.ts.shape[1] == 200 and len(quick.ts) > 0
            and np.isfinite(quick.ts).all() and np.isfinite(quick.zs).all(),
            "README quick start gave non-finite or empty results")
    require(on_card and all(on_card), "README quick start did not build its tensors on the card")
    emit("quick_start", rays=int(quick.ts.shape[0]), saves=200, default_device="cuda",
         launches=stepper.LAUNCHES - n0)

    # ---- phase 5: times at the headline shape ------------------------------
    p0_h = torch.as_tensor(launch_p0(pt, env_h, angles), dtype=torch.float32, device=dev)
    s_plain = dataclasses.replace(settings, backend="ops")

    def run(s, env=env_h, p0=p0_h):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = pt.trace(env, SRC_DEPTH, p0, 0.0, R_MAX, NUM_SAVE, s)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    res_k, _ = run(settings)  # warm-up
    res_p, _ = run(s_plain)
    errs_all.append(compare("headline", res_k, res_p))
    t_k, t_p = [], []
    for i in range(5):  # in turns: kernel, plain, plain, kernel, ...
        order = (settings, s_plain) if i % 2 == 0 else (s_plain, settings)
        for s in order:
            (t_k if s is settings else t_p).append(run(s)[1])
    ms_k = statistics.median(t_k) * 1e3
    ms_p = statistics.median(t_p) * 1e3
    # device-side time of the kernel wrapper alone (CUDA events, 20 launches)
    event_ms = events_ms(lambda: stepper.trace_kernel(env_h, SRC_DEPTH, p0_h, geom, settings))
    fan_bound_ms, fan_bound_by = fan_bound(res_k, env_h, sps)
    emit("times", card=smi, rays=NUM_RAYS, steps=sps * nseg, kernel_ms=ms_k, plain_ms=ms_p,
         kernel_event_ms=event_ms, bound_ms=fan_bound_ms, bound_by=fan_bound_by,
         kernel_rays_per_s=NUM_RAYS / (ms_k / 1e3), plain_rays_per_s=NUM_RAYS / (ms_p / 1e3),
         kernel_runs_ms=[t * 1e3 for t in t_k], plain_runs_ms=[t * 1e3 for t in t_p])

    # ---- phase 6: the tangent kernel vs its plain version ------------------
    # final state only, on the eigenray solver's plan (2 saves); the same
    # fans as phase 3 plus BASELINE config 1's range-dependent field
    env_rd = rd_env(torch, pt, dev)
    require(env_rd.range_dependent and stepper.tangent_supported(env_rd, settings),
            "config 1 env is not range-dependent spectral")
    s_rd = pt.SolverSettings(dx=100.0)  # bench.py's config 1 step
    tan_cases = (
        ("horner", env_h, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("clenshaw", env_c, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("horner_curved_bottom", env_b, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("seamount_deaths", env_s, death_angles, z0_death, 20e3, settings),
        ("range_dependent_config1", env_rd, eq_angles, SRC_DEPTH, R_MAX, s_rd),
    )
    tan_errs, tan_plain_ms = [], {}
    for name, env, ang, z0, x1, s in tan_cases:
        h2, sps2, nseg2 = _plan(0.0, x1, 2, s.dx)
        g2 = (0.0, x1, h2, sps2, nseg2)
        p0 = torch.as_tensor(launch_p0(pt, env, ang), dtype=torch.float32, device=dev)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
        out_k = stepper.trace_tangent_kernel(env, z0, p0, 1.0, g2, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = _trace_tangent_impl(env, z0, p0, 1.0, g2, s)
        torch.cuda.synchronize()
        tan_plain_ms[name] = (time.perf_counter() - t0) * 1e3
        tan_errs.append(compare_tangent(name, out_k, out_p, finite=name != "seamount_deaths"))
        if name == "seamount_deaths":
            codes = set(out_p[8].tolist())
            require({1, 2, 3} <= codes, f"tangent {name}: death codes {sorted(codes)} lack 1, 2 or 3")
        if name in ("horner", "range_dependent_config1"):
            res_f = stepper.trace_kernel(env, z0, p0, g2, dataclasses.replace(s, kahan=False))
            lockstep(name, out_k, res_f)
    tan_err = {f: max(e[f] for e in tan_errs) for f in TAN_FIELDS}

    # ---- phase 7: the range-dependent fan (B1c) ----------------------------
    h_rd, sps_rd, nseg_rd = _plan(0.0, R_MAX, NUM_SAVE, s_rd.dx)
    for kahan in (True, False):
        s = dataclasses.replace(s_rd, kahan=kahan)
        p0 = torch.as_tensor(launch_p0(pt, env_rd, eq_angles), dtype=torch.float32, device=dev)
        res_k = stepper.trace_kernel(env_rd, SRC_DEPTH, p0, (0.0, R_MAX, h_rd, sps_rd, nseg_rd), s)
        res_p = pt.trace(env_rd, SRC_DEPTH, p0, 0.0, R_MAX, NUM_SAVE,
                         dataclasses.replace(s, backend="ops"))
        torch.cuda.synchronize()
        errs_all.append(compare(f"range_dependent_config1_kahan_{kahan}", res_k, res_p))
    # config 1 at full width through the user API: one fan launch
    stepper.LAUNCHES = 0
    t0 = time.perf_counter()
    fan_rd = pt.shoot_rays(SRC_DEPTH, 0.0, angles, R_MAX, NUM_SAVE, env_rd, dx=s_rd.dx,
                           flatearth=False)
    torch.cuda.synchronize()
    rd_s = time.perf_counter() - t0
    launches_rd = stepper.LAUNCHES
    require(launches_rd == 1, f"config 1 launched the fan kernel {launches_rd} times, not once")
    require(len(fan_rd.ts) >= 0.999 * NUM_RAYS and np.isfinite(fan_rd.ts).all(),
            f"config 1 kept {len(fan_rd.ts)} of {NUM_RAYS} rays or gave non-finite times")
    oracle_rd = np.load(ORACLE_RD)
    fan_ro = pt.shoot_rays(SRC_DEPTH, 0.0, oracle_rd["angles"], R_MAX, NUM_SAVE, env_rd,
                           dx=s_rd.dx, flatearth=False)
    require(len(fan_ro.ts) == len(oracle_rd["angles"]), "config 1 oracle rays were dropped")
    err_rd_ms = float(np.max(np.abs(fan_ro.ts[:, -1] - oracle_rd["ts"])) * 1e3)
    emit("config1_path", rays=NUM_RAYS, kept=len(fan_rd.ts), saves=NUM_SAVE, seconds=rd_s,
         launches=launches_rd, max_travel_time_err_ms=err_rd_ms, budget_ms=ORACLE_BUDGET_MS)
    require(err_rd_ms <= ORACLE_BUDGET_MS, f"config 1 travel-time error {err_rd_ms:.4f} ms")

    # ---- phase 8: eigenrays at full width vs the JAX package ----------------
    cases = json.loads(str(np.load(EIGEN_JAX)["cases"]))
    envs = {"headline": env_h, "range_dependent": env_rd}
    eig = {}
    for case in cases:
        eig[case["name"]] = eigen_case(torch, pt, dev, stepper, case, envs)
    # BASELINE config 2 against the scipy oracle (at the JAX angles)
    pair = eig["pair"][0][0]
    oracle_pair = np.load(EIGEN_JAX)["pair/oracle_ts"]
    err_pair_ms = float(np.max(np.abs(np.sort(pair.ts[0][:, -1])
                                      - np.sort(oracle_pair))) * 1e3)
    emit("config2_vs_oracle", eigenrays=len(oracle_pair), max_travel_time_err_ms=err_pair_ms,
         budget_ms=ORACLE_BUDGET_MS)
    require(err_pair_ms <= ORACLE_BUDGET_MS, f"config 2 travel-time error {err_pair_ms:.4f} ms")

    # ---- phase 9: times of the new paths ------------------------------------
    # the tangent kernel at config 3's batch (its eigenray angles, the
    # solver's 2-save plan) and at the 8,192-ray fan
    tf = eig["timefront"][0][0]
    th3 = np.concatenate([tf.launch_angles[i] for i in range(64) if len(tf.launch_angles[i])])
    p0_3 = torch.as_tensor(launch_p0(pt, env_h, th3), dtype=torch.float32, device=dev)
    h2, sps2, nseg2 = _plan(0.0, R_MAX, 2, DX)
    g2 = (0.0, R_MAX, h2, sps2, nseg2)
    out3 = stepper.trace_tangent_kernel(env_h, SRC_DEPTH, p0_3, 1.0, g2, settings)
    tan3_ms = events_ms(lambda: stepper.trace_tangent_kernel(env_h, SRC_DEPTH, p0_3, 1.0, g2,
                                                             settings))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _trace_tangent_impl(env_h, SRC_DEPTH, p0_3, 1.0, g2, settings)
    torch.cuda.synchronize()
    tan3_plain_ms = (time.perf_counter() - t0) * 1e3
    tan3_bound_ms, tan3_bound_by = tangent_bound(out3, env_h, sps2 * nseg2)
    p0_e = torch.as_tensor(launch_p0(pt, env_h, eq_angles), dtype=torch.float32, device=dev)
    out_e = stepper.trace_tangent_kernel(env_h, SRC_DEPTH, p0_e, 1.0, g2, settings)
    tan_e_ms = events_ms(lambda: stepper.trace_tangent_kernel(env_h, SRC_DEPTH, p0_e, 1.0, g2,
                                                              settings))
    tan_e_bound_ms, _ = tangent_bound(out_e, env_h, sps2 * nseg2)
    # the fan kernel at config 1 (102,400 rays, dx = 100 m, 50 saves)
    p0_rd = torch.as_tensor(launch_p0(pt, env_rd, angles), dtype=torch.float32, device=dev)
    geom_rd = (0.0, R_MAX, h_rd, sps_rd, nseg_rd)
    res_rd = stepper.trace_kernel(env_rd, SRC_DEPTH, p0_rd, geom_rd, s_rd)
    rd_ms = events_ms(lambda: stepper.trace_kernel(env_rd, SRC_DEPTH, p0_rd, geom_rd, s_rd))
    _, rd_plain_s = run(dataclasses.replace(s_rd, backend="ops"), env_rd, p0_rd)
    rd_bound_ms, rd_bound_by = fan_bound(res_rd, env_rd, sps_rd)
    # wall latency of BASELINE configs 2 and 3 (median of 5 after a warm-up)
    fan_e = pt.shoot_rays(SRC_DEPTH, 0.0, np.linspace(-14.0, 14.0, 1024), R_MAX, 2, env_h,
                          flatearth=False, dx=DX)
    latency = {}
    for name, rds in (("config2", [1300.0]), ("config3", np.linspace(500.0, 2100.0, 64))):
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt.find_eigenrays(fan_e, rds, SRC_DEPTH, 0.0, R_MAX, NUM_SAVE, env_h, ztol=1.0,
                              flatearth=False, dx=DX)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        latency[name] = {"median_ms": statistics.median(runs[1:]), "runs_ms": runs[1:]}
    emit("times_eigenrays", card=smi,
         tangent_config3={"rays": len(th3), "steps": sps2 * nseg2, "kernel_event_ms": tan3_ms,
                          "plain_ms": tan3_plain_ms, "bound_ms": tan3_bound_ms,
                          "bound_by": tan3_bound_by},
         tangent_fan8192={"rays": len(eq_angles), "steps": sps2 * nseg2,
                          "kernel_event_ms": tan_e_ms, "plain_ms": tan_plain_ms["horner"],
                          "bound_ms": tan_e_bound_ms},
         fan_config1={"rays": NUM_RAYS, "steps": sps_rd * nseg_rd, "kernel_event_ms": rd_ms,
                      "plain_ms": rd_plain_s * 1e3, "bound_ms": rd_bound_ms,
                      "bound_by": rd_bound_by},
         eigenray_latency=latency)

    err = worst(errs_all)
    launches_tan = eig["timefront"][1][1]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "trace_fan_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_fan.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:228",
        "launches": launches,  # the headline fan's shoot_rays
        "launches_config1": launches_rd,
        "max_abs_err": err["ts"],  # travel time [s]; zs [m] and ps [s/m] below
        "max_abs_err_zs": err["zs"],
        "max_abs_err_ps": err["ps"],
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": fan_bound_ms,
        "bound_by": fan_bound_by,
        "library_ms": None,  # no single PyTorch call traces a ray fan
        "ms_config1": rd_ms,
        "plain_ms_config1": rd_plain_s * 1e3,
        "bound_ms_config1": rd_bound_ms,
    }, {
        "name": "trace_tangent_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_tangent.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:1161",
        "launches": launches_tan,  # BASELINE config 3's find_eigenrays
        "max_abs_err": tan_err["T"],  # travel time [s]; the rest below
        "max_abs_err_z": tan_err["z"],
        "max_abs_err_dT": tan_err["dT"],
        "max_abs_err_dz": tan_err["dz"],
        "max_abs_err_dp": tan_err["dp"],
        "ms": tan3_ms,
        "plain_ms": tan3_plain_ms,
        "bound_ms": tan3_bound_ms,
        "bound_by": tan3_bound_by,
        "library_ms": None,  # no single PyTorch call computes a ray tangent
        "ms_fan8192": tan_e_ms,
        "plain_ms_fan8192": tan_plain_ms["horner"],
        "bound_ms_fan8192": tan_e_bound_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def events_ms(fn, n=20):
    """Mean device time of ``fn`` over ``n`` calls, by CUDA events after one
    warm-up call."""
    import torch

    fn()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(n):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / n


if __name__ == "__main__":
    sys.exit(main())
