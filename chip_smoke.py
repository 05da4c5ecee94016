#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pygenray_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``pygenray_tpu_torch/csrc``, holds it
against its plain PyTorch version on the card, drives the main path
(``shoot_rays`` on the headline 102,400-ray Munk fan) through the kernel,
checks travel times against the scipy oracle fixture, and times the kernel
and the plain torch-op loop.  Each phase prints one line; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that line.  It needs no network and imports no JAX.
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
ORACLE = ROOT / "tests" / "fixtures" / "bench_oracle_100km.npz"

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


def compare(name, res_k, res_p):
    """Hold a kernel result to its plain version (see TOLS); print the
    phase line and return the max absolute errors at live save points."""
    import torch

    same = ((res_k.n_surf == res_p.n_surf) & (res_k.n_bott == res_p.n_bott)
            & (res_k.death_code == res_p.death_code))
    live = res_p.alive_save
    errs, ratios = {}, {}
    for f, (tol, mag) in TOLS.items():
        a, b = getattr(res_k, f), getattr(res_p, f)
        # equal values (infinities included) and NaN in both agree; NaN in
        # one of them gives a NaN ratio, which fails the check below
        d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
        errs[f] = float(d[live].max()) if bool(live.any()) else 0.0
        ratios[f] = float((d / (tol * (b.abs() / mag).clamp_min(1.0))).max())
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    import pygenray_tpu_torch as pt
    from pygenray_tpu_torch.integrate import _plan
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

    # ---- phase 2: build the kernel ----------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    stepper._kernel_fn()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(build_s, 3), library=so.name, ptxas=ptxas)

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
    # bottom), 1024 rays, 200 saves
    n0 = stepper.LAUNCHES
    quick = pt.shoot_rays(1300.0, 0.0, np.linspace(-15, 15, 1024), 100e3, 200,
                          pt.OceanEnvironment2D(), device=dev)
    require(quick.ts.shape[1] == 200 and len(quick.ts) > 0
            and np.isfinite(quick.ts).all() and np.isfinite(quick.zs).all(),
            "README quick start gave non-finite or empty results")
    emit("quick_start", rays=int(quick.ts.shape[0]), saves=200,
         launches=stepper.LAUNCHES - n0)

    # ---- phase 5: times at the headline shape ------------------------------
    p0_h = torch.as_tensor(launch_p0(pt, env_h, angles), dtype=torch.float32, device=dev)
    s_plain = dataclasses.replace(settings, backend="ops")

    def run(s):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = pt.trace(env_h, SRC_DEPTH, p0_h, 0.0, R_MAX, NUM_SAVE, s)
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
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(20):
        stepper.trace_kernel(env_h, SRC_DEPTH, p0_h, geom, settings)
    ev1.record()
    torch.cuda.synchronize()
    event_ms = ev0.elapsed_time(ev1) / 20
    emit("times", card=smi, rays=NUM_RAYS, steps=sps * nseg, kernel_ms=ms_k, plain_ms=ms_p,
         kernel_event_ms=event_ms,
         kernel_rays_per_s=NUM_RAYS / (ms_k / 1e3), plain_rays_per_s=NUM_RAYS / (ms_p / 1e3),
         kernel_runs_ms=[t * 1e3 for t in t_k], plain_runs_ms=[t * 1e3 for t in t_p])

    err = worst(errs_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "trace_fan_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_fan.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:228",
        "launches": launches,
        "max_abs_err": err["ts"],  # travel time [s]; zs [m] and ps [s/m] below
        "max_abs_err_zs": err["zs"],
        "max_abs_err_ps": err["ps"],
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
