#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pygenray_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pygenray_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel) and holds each against its plain PyTorch
version on the card: the forward fan kernel (``trace_fan.cu``,
range-independent and range-dependent), the forward-tangent kernel
(``trace_tangent.cu``) and the save-grid forward-tangent kernel
(``trace_tangent_save.cu``).  It drives the main paths through them: the
headline 102,400-ray Munk fan (``shoot_rays``), BASELINE config 1's
range-dependent fan at full width, the eigenray search
(``find_eigenrays`` / ``find_eigenrays_batch``) on BASELINE configs 2 and 3
and three more cases, held against the JAX package's answers
(``tests/fixtures/eigen_jax_f32.npz``, written on a CPU by
``tests/fixtures/make_eigen_fixture.py``) and the scipy oracle fixtures,
and the receiver side: autograd through ``trace``, ``arrival_amplitudes``
over the headline fan, ``transmission_loss_field`` and ``impulse_response``
/ ``array_response`` at the parameters of ``examples/tl_demo.py`` and
``examples/impulse_response_demo.py``, held against spherical spreading,
central differences and the JAX package's answers
(``tests/fixtures/receiver_jax_f32.npz``, written by
``tests/fixtures/make_receiver_fixture.py``).  It times kernels, plain
versions, eigenray latencies and the receiver-side calls, and holds the
save-grid tangent kernel to its plain version once more at the shapes
those calls gave it (the TL demo's and the array response's over about
30 km: ``cut_plan``).  Monte Carlo: it holds the fan kernel's segment mode
(rough fields) to its plain version at the shape the rough ensemble gives
it and at the step-table layouts of 96- and 128-term fits, and the
ensemble forward-tangent kernel (``trace_tangent_ens.cu``) with config
4b's every candidate over 30 km, drives
``trace_ensemble`` over BASELINE config 4's 16 internal-wave realizations
× 65,536 rays and over ``bench.py``'s 16-realization rough field at full
width, and ``mc_eigenray_times`` at config 4b, and holds the Monte-Carlo
answers to the JAX package's (``tests/fixtures/mc_jax_f32.npz``, written by
``tests/fixtures/make_mc_fixture.py``).  Adjoint: it holds the
coefficient-tangent kernels (``trace_coef_tangent.cu``, range-independent
and range-dependent) to their plain versions at ``bench.py``'s two Jacobian
shapes, on a bottom-bouncing fan and at the inversion's shapes, drives
``travel_time_jacobian`` / ``travel_time_jacobian_2d`` and
``examples/gradient_inversion_demo.py``'s 150-step inversion through
``travel_times_of_coef`` at full size, and holds every adjoint operator to
the JAX package's answers (``tests/fixtures/adjoint_jax_f32.npz``, written
by ``tests/fixtures/make_adjoint_fixture.py``).  Each phase prints
one line; a ``phase_seconds`` line gives each phase's seconds and the
script's total; the last line is ``{"ok": true, "device": {...}}``.  Any failure
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
import types

import numpy as np

T_START = time.perf_counter()

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
ORACLE = FIXTURES / "bench_oracle_100km.npz"
ORACLE_RD = FIXTURES / "bench_oracle_rd.npz"
EIGEN_JAX = FIXTURES / "eigen_jax_f32.npz"
RECEIVER_JAX = FIXTURES / "receiver_jax_f32.npz"
MC_JAX = FIXTURES / "mc_jax_f32.npz"
ADJOINT_JAX = FIXTURES / "adjoint_jax_f32.npz"

# the headline fan (BASELINE config 0; the JAX package's bench.py)
R_MAX = 100e3
NUM_RAYS = 102_400
N_EQ = 8192  # rays of the kernel-vs-plain fans
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
KERNEL_NAMES = ("trace_fan_f32", "trace_tangent_f32", "trace_tangent_save_f32")
# The save-grid tangent kernel takes a seed (dp0, dz0).  A unit depth seed
# gives tangents about 1e-8 of a unit p0 seed's (dz/dz0 ~ 1 against dz/dp0 ~
# 1e8 m per (s/m), dT/dz0 ~ 1e-4 s/m against 1e4), so the tangent bounds and
# magnitudes of TAN_TOLS are scaled by max|dp0| + Z0_SEED_SCALE * max|dz0|.
Z0_SEED_SCALE = 1e-8
# the receiver side vs the JAX package (float32 on a CPU, its tangent by
# jax.jvp through its scan): both sum travel time without compensation, in
# different orders, so times differ by a few float32 ulp of 67 s a step over
# 490 steps (6e-5 s between the port on a CPU and the fixture), depths by a
# few mm, amplitudes by < 1e-4 relative away from caustics; the bounds are
# about three times what the port on a CPU shows.
RCV_TIME_S = 2e-4
RCV_DEPTH_M = 0.05
RCV_AMP_REL = 1e-3
RCV_TL_INC_DB = 1e-3
# coherent pressure, relative to the field's largest: the phase omega * t
# moves by 2 pi 75 Hz * 6e-5 s = 0.03 rad (CPU: 1.6e-3 of the largest)
RCV_COH_REL = 1e-2
# eigenrays vs the JAX package (tests/test_eigenray_newton.py's bounds)
EIG_ANGLE_DEG = 5e-3
EIG_TIME_S = 1e-5

# bounds: FP32 operations a ray-step, counted from the sources (one op per
# add, multiply, divide, compare-select or special function), over the
# card's published peaks (NVIDIA's H100 SXM data sheet, 700 W: 67 TFLOP/s
# FP32 outside the tensor cores, 3.35 TB/s HBM).  The 67 TFLOP/s count a
# fused multiply-add as two operations: it is 33.5e12 FFMA instructions a
# second.  The kernels are built with -fmad=false, so each counted add or
# multiply issues as an instruction of its own, at most 33.5e12 FADD/FMUL a
# second: their own floor is twice the bound, which is that of a kernel
# fusing every multiply with an add.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# a Dual operation costs 2.5 plain ones (a Horner term: 5 against 2)
DUAL_FACTOR = 2.5
# Monte Carlo: BASELINE config 4 (bench.py:479-509) and the rough field
# (:558-595) at full width, 16 realizations each
MC_E = 16
MC_RAYS = 65_536
ROUGH_DX = 100.0
SEG_X1 = 30e3  # range of the segment-mode comparisons other than the rough shape
# about the range of the plain comparisons that run shorter than the main
# path's shape (B3 at the TL demo and the array response, B1d at the rough
# ensemble's)
CMP_X1 = 30e3
# range of the save-grid tangent kernel's comparisons on the tangent fans
# with three seeds: no main path runs these fans
SAVE_FANS_X1 = 10e3
# the fan and tangent kernels' fans compared over CMP_X1: no main path
# launches them at 100 km (the headline fan and the eigenray solves run the
# Horner and config 1 fields)
TAN_SHORT = ("clenshaw", "horner_curved_bottom")
SEG_S = 128  # segments of a segment fit (ops/seg.py SEG_S)
# terms of the rough exact-order fits whose step tables take the layouts the
# main path's 32 does not (stepper.seg_layout): one buffer, none
SEG_OTHER_K = (96, 128)
SEG_SMALL_RAYS = 4096
SEG_OTHER_X1 = 10e3  # their range: across the rough field's first station
# terms of config 4's exact-order fits on which the ensemble tangent kernel
# is held at a K other than the main path's 64: one compiled fixed, one at
# run time (stepper.ens_layout); compared with every Newton candidate over
# ENS_OTHER_X1
ENS_OTHER_K = (96, 128)
ENS_OTHER_X1 = 10e3
# Monte-Carlo eigenrays, the port's one-shot Newton against the JAX
# package's regula falsi (tests/test_montecarlo.py:331-337)
MC_ANGLE_DEG = 0.05
MC_TIME_S = 5e-4
# the rough field's fan against the JAX package: a segment fit jumps by up
# to its residual (0.1 m/s) at each segment boundary, so where rounding
# puts a ray's depth on either side of one, its path parts, and after 30 km
# of this field float32 itself is not reproducible: the port's float32
# against its float64 on a CPU (the fixture's 2 x 1,024 rays) differ by a
# median 3.2e-6 s, by more than 1e-4 s on 13 % of the rays, by up to 0.06 s;
# the port's float32 against the JAX package's alike (2.6e-6 s, 15 %, 0.05
# s).  Held: counters equal on 99.9 % of rays and, on those, a median time
# error within 1e-5 s and 80 % of the times within 1e-4 s
ROUGH_RAY_SHARE = 0.999
ROUGH_TIME_MEDIAN_S = 1e-5
ROUGH_TIME_S = 1e-4
ROUGH_TIME_SHARE = 0.8
ORACLE_BUDGET_MS = 0.1  # BASELINE.json travel-time budget
# adjoint: bench.py's spectral Jacobian (:511-535, the headline field, 512
# rays over ±14°, 100 km, dx = 200 m) and a bottom-bouncing fan on the same
# field; its range-dependent Jacobian (:638-664: 32 stations of a Munk
# profile whose axis deepens 2 m/km, nz = 2000, flat 5500 m bottom, 16
# terms, 64 rays over ±12°, dx = 100 m); examples/gradient_inversion_demo.py
# at its full parameters
JAC_RAYS, JAC_SPAN, JAC_BOUNCE_SPAN = 512, 14.0, 30.0
JAC2 = {"nz": 2000, "nr": 32, "rays": 64, "span": 12.0, "dx": 100.0, "order": 15}
INV = {"r_max": 60e3, "nr": 9, "K": 32, "B": 128, "iters": 150, "nz": 1200, "dx": 200.0,
       "lr": 0.03, "lam": 1e-10, "drop": 0.05}
# Σ_j of the range-dependent Jacobian against the range-independent one on
# the same field in the range-dependent layout: the blended rows
# (1 - w) c + w c round away from c, so the two traces part by float32
# rounding, bounded at 1e-4 of the largest entry
STATION_SUM_REL = 1e-4
# the adjoint operators against the JAX package (tests/test_adjoint.py's
# bounds: T within 1e-4 s, Jacobians within 2e-3 (range-independent) and
# 3e-3 (range-dependent) of the largest entry, the vjp within 3e-3); the
# spectral Fermat operators within 1e-4 of the largest entry, the segment
# one within 1e-3 (a rough field's float32 paths part where rounding moves
# a save point across a segment boundary: ROADMAP C), the endpoint
# gradients within 1e-9 s/m (the port's CPU tests' bounds)
ADJ_T_S = 1e-4
ADJ_J_REL = {"ri": 2e-3, "rd": 3e-3, "vjp": 3e-3, "fermat": 1e-4, "fermat_seg": 1e-3}
ADJ_GRAD = 1e-9
# the Fermat operators and endpoint gradients on the default fit (poly_ok,
# the Horner series): in float32 the two packages round it apart near the
# top of the depth domain (ROADMAP C), held at the bounds that gap reads on
# a CPU (tests/test_torch_adjoint.py: T 1.3e-4 s, G 3.2e-4 of its largest
# entry, the endpoint gradients 1.3e-8 s/m)
ADJ_HORNER = {"T": 2e-4, "G": 5e-4, "grad": 5e-8}
# random fields (tests/fixtures/random_field.py, the recipe of
# tests/test_fuzz_parity.py): seeds, the kernel-vs-plain fans (rays over
# ±RF_SPAN° in the ODE convention to RF_X1 at RF_DX; B6 on RF_B6_RAYS of
# them, evenly spaced, along RF_B6_DIRS unit directions), and the step of the
# fan held to the scipy oracle on the JAX test's eight angles a seed
RF_SEEDS = (0, 1, 2)
RF_RAYS, RF_SPAN, RF_X1, RF_DX = 256, 25.0, 20e3, 200.0
RF_B6_RAYS, RF_B6_DIRS = 64, 8
RF_ORACLE_DX = 50.0
COUNTERS = ("LAUNCHES", "SEG_LAUNCHES", "TANGENT_LAUNCHES", "TANGENT_SAVE_LAUNCHES",
            "TANGENT_ENS_LAUNCHES", "COEF_TANGENT_LAUNCHES", "COEF_TANGENT_RD_LAUNCHES")
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


PHASE_S = {}  # seconds of each phase of main(), in order


def phase_done(name, _last=[T_START]):
    """Charge the seconds since the last phase ended (or the script
    started) to phase ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = round(now - _last[0], 2)
    _last[0] = now


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


def step_input_bytes(env, nsteps, stations=False):
    """Per-step inputs: bathymetry at both ends and the domain flag, plus,
    for a range-dependent field, four coefficient rows a step (the tangent
    kernels B2-B4) or, with ``stations`` (the fan kernel and B5/B6, which
    blend the stations themselves), the stations' two (nr, K) tables and
    the station interval and weight at each step's middle and end."""
    K = env.c_cheb.shape[-1]
    if not env.range_dependent:
        return nsteps * 9
    if stations:
        return nsteps * 9 + 8 * env.c_cheb.shape[0] * K + 8 * (2 * nsteps + 1)
    return nsteps * (9 + 16 * K)


def fan_bound(res, env, sps):
    """Bound of one forward launch for this result: the ray-steps its rays
    lived (a dead ray stops), and for a range-dependent field each step's
    four rows blended once (3 operations an entry), each input read and
    each output written once."""
    B, S = res.ts.shape
    nsteps = (S - 1) * sps
    ray_steps = float((res.alive_save.sum(1) - 1).clamp(min=0).sum()) * sps
    blend = 12 * env.c_cheb.shape[-1] * nsteps if env.range_dependent else 0
    nbytes = B * (8 + 12 * S + 16) + step_input_bytes(env, nsteps, stations=True)
    return bound(ray_steps * step_ops(env) + blend, nbytes)


def seg_step_ops(env):
    """FP32 operations of one forward ray-step in the segment mode, counted
    from csrc/trace_fan.cu as ``step_ops`` does: four right-hand sides of
    two Ks-term series each (Horner 2 ops a term, Clenshaw 4) plus 8 for
    each segment pick, 18 around them, and about 50 for the rest.  A
    range-dependent field's blend is a step's work, not a pick's
    (``seg_fan_bound``)."""
    Ks = env.c_seg.shape[-2]
    term = 2 if env.seg_basis == "pow" else 4
    return 4 * (2 * ((Ks - 1) * term + 3) + 8 + 18) + 50


def seg_fan_bound(res, env, sps):
    """Bound of one segment-mode launch: the ray-steps its rays lived, and
    for a range-dependent field each step's four (Ks, S) tables blended once
    (3 operations an entry: 12 Ks S a step, as ``fan_bound`` counts a
    spectral field's rows), each input read once (the (nr, Ks, S) tables,
    the per-step station indices and weights) and each output written
    once."""
    B, S = res.ts.shape
    ray_steps = float((res.alive_save.sum(1) - 1).clamp(min=0).sum()) * sps
    nsteps = (S - 1) * sps
    blend = 12 * env.c_seg[0].numel() * nsteps if env.range_dependent else 0
    tables = 8 * (env.c_seg.numel() if env.range_dependent else env.c_seg[0].numel())
    nbytes = B * (8 + 12 * S + 16) + nsteps * (9 + 16) + tables
    return bound(ray_steps * seg_step_ops(env) + blend, nbytes)


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


# ---------------------------------------------------------------------------
# the save-grid tangent kernel and the receiver side
# ---------------------------------------------------------------------------


def on_card(cx, a):
    return cx.torch.as_tensor(a, dtype=cx.torch.float32, device=cx.dev)


def save_tangent_bound(res, env, sps):
    """Bound of one save-grid tangent launch: the ray-steps its rays lived
    at DUAL_FACTOR times the forward operations, 16 B in and six save grids
    plus 16 B out per ray."""
    B, S = res.ts.shape
    ray_steps = float((res.alive_save.sum(1) - 1).clamp(min=0).sum()) * sps
    nbytes = B * (16 + 24 * S + 16) + step_input_bytes(env, (S - 1) * sps)
    return bound(ray_steps * step_ops(env) * DUAL_FACTOR, nbytes)


def compare_save_tangent(name, seed_scale, out_k, out_p):
    """Hold the save-grid tangent kernel to its plain version: the primal
    save grids, counters, death codes and alive_save as ``compare`` does,
    the three tangent grids at every save point within TAN_TOLS scaled by
    the seed (see Z0_SEED_SCALE).  A value that is the same infinity or NaN
    in both agrees; their count is reported.  Returns the max absolute
    errors at live save points."""
    import torch

    res_k, tan_k = out_k
    res_p, tan_p = out_p
    errs = compare(name, res_k, res_p)
    live = res_p.alive_save
    ratios, nonfinite = {}, 0
    for f, a, b in zip(("dT", "dz", "dp"), tan_k, tan_p):
        tol, mag = TAN_TOLS[f]
        d, ratios[f] = diff_ratio(a, b, tol * seed_scale, mag * seed_scale)
        errs[f] = float(d[live].max()) if bool(live.any()) else 0.0
        nonfinite += int((live & ~torch.isfinite(b)).sum())
    emit("save_tangent_vs_plain", case=name, seed_scale=seed_scale,
         live_save_points_with_nonfinite_tangent=nonfinite,
         max_abs_err_live={f: errs[f] for f in ("dT", "dz", "dp")}, max_err_over_bound=ratios)
    for f, r in ratios.items():
        require(r <= 1.0, f"{name}: tangent grid {f} differs by {r:.3g} times its bound")
    return errs


def save_tangent_phase(cx):
    """The save-grid tangent kernel against its plain version on every
    tangent fan with three seeds (all at full width, over about
    ``SAVE_FANS_X1`` at the fan's step and save spacing, ``cut_plan``: no
    main path runs these fans, and the plain loop takes 25-45 ms a step on
    the card's host, whatever the fan's width; the seamount fan's death
    codes 1, 2 and 3 all occur by then), and in lockstep with the other
    kernels: its last row is the final-state tangent kernel's output, its
    primal the fan kernel's save grid without Kahan.  Returns (worst
    errors, plain ms of the first case)."""
    from pygenray_tpu_torch.integrate import _trace_tangent_save_impl

    torch, stepper = cx.torch, cx.stepper
    errs_all, plain_ms = [], None
    for name, env, ang, z0, x1, s in cx.tan_cases:
        p0, z0 = on_card(cx, launch_p0(cx.pt, env, ang)), on_card(cx, z0)
        mixed = on_card(cx, np.linspace(0.5, 1.5, len(ang)))
        geom = cut_plan(x1, NUM_SAVE, s.dx, SAVE_FANS_X1)[0]
        for label, dp0, dz0, scale in (("dp0", 1.0, 0.0, 1.0),
                                       ("dz0", 0.0, 1.0, Z0_SEED_SCALE),
                                       ("mixed", mixed, -0.7, 1.5 + 0.7 * Z0_SEED_SCALE)):
            out_k = stepper.trace_tangent_save_kernel(env, z0, p0, dp0, geom, s, dz0=dz0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = _trace_tangent_save_impl(env, z0, p0, dp0, geom, s, dz0=dz0)
            torch.cuda.synchronize()
            if plain_ms is None:
                plain_ms = (time.perf_counter() - t0) * 1e3
            errs_all.append(compare_save_tangent(f"{name}/{label}", scale, out_k, out_p))
            if label != "dp0":
                continue
            # lockstep: the last row is the final-state tangent kernel's
            # output on the same plan, the primal the fan kernel's save grid
            res_k, tan_k = out_k
            out_t = stepper.trace_tangent_kernel(env, z0, p0, 1.0, geom, s)
            last = (res_k.ts[:, -1], res_k.zs[:, -1], res_k.ps[:, -1],
                    tan_k[0][:, -1], tan_k[1][:, -1], tan_k[2][:, -1])
            ratios = {f: diff_ratio(a, b, *TAN_TOLS[f])[1]
                      for f, a, b in zip(TAN_FIELDS, last, out_t[:6])}
            res_f = stepper.trace_kernel(env, z0, p0, geom, dataclasses.replace(s, kahan=False))
            ratios_f = {f: diff_ratio(getattr(res_k, f), getattr(res_f, f), *TOLS[f])[1]
                        for f in TOLS}
            same = bool(torch.equal(out_t[6], res_k.n_surf) and torch.equal(out_t[7], res_k.n_bott)
                        and torch.equal(out_t[8], res_k.death_code)
                        and torch.equal(res_f.alive_save, res_k.alive_save))
            emit("save_tangent_lockstep", case=name, counters_equal=same,
                 last_row_vs_tangent_kernel=ratios, primal_vs_fan_kahan_off=ratios_f)
            require(same, f"{name}: the three kernels disagree on counters, death codes or "
                    "alive_save")
            for f, r in {**ratios, **ratios_f}.items():
                require(r <= 1.0, f"{name}: save-grid tangent {f} off its sibling kernel by "
                        f"{r:.3g} bounds")
        if name == "seamount_deaths":
            codes = set(out_p[0].death_code.tolist())
            require({1, 2, 3} <= codes, f"save tangent {name}: death codes {sorted(codes)} "
                    "lack 1, 2 or 3")
    keys = ("ts", "zs", "ps", "dT", "dz", "dp")
    return {f: max(e[f] for e in errs_all) for f in keys}, plain_ms


def autograd_phase(cx):
    """torch.autograd.grad of the summed final travel time over p0 and over
    z0 on the 8,192-ray fan: one save-grid tangent launch each, no fan
    launch; equal to the plain version's tangent, and within central
    differences of the fan kernel (float32: the median over rays whose
    bounce counts the shifted shots share, relative to the largest
    tangent; the p0 step 1e-6 s/m moves T by ~1e-2 s against 1e-5 s of
    rounding, median bound 1e-3; the z0 step 5 m moves T by ~4e-4 s, median
    bound 5e-2)."""
    from pygenray_tpu_torch.integrate import _trace_tangent_save_impl

    torch, stepper, pt, env, s = cx.torch, cx.stepper, cx.pt, cx.env_h, cx.settings
    h, sps, nseg = cx.plan(0.0, R_MAX, NUM_SAVE, DX)
    geom = (0.0, R_MAX, h, sps, nseg)
    s_off = dataclasses.replace(s, kahan=False)
    p0 = on_card(cx, launch_p0(pt, env, cx.eq_angles))
    z0 = torch.full_like(p0, SRC_DEPTH)
    out = {}
    for wrt, eps, med_bound in (("p0", 1e-6, 1e-3), ("z0", 5.0, 5e-2)):
        leaf = (p0 if wrt == "p0" else z0).clone().requires_grad_(True)
        args = (z0, leaf) if wrt == "p0" else (leaf, p0)
        stepper.LAUNCHES = stepper.TANGENT_SAVE_LAUNCHES = 0
        res = pt.trace(env, *args, 0.0, R_MAX, NUM_SAVE, s)
        (g,) = torch.autograd.grad(res.ts[:, -1].sum(), leaf)
        torch.cuda.synchronize()
        launches = (stepper.LAUNCHES, stepper.TANGENT_SAVE_LAUNCHES)
        seed = (1.0, 0.0) if wrt == "p0" else (0.0, 1.0)
        _, (dts, _, _) = _trace_tangent_save_impl(env, z0, p0, seed[0], geom, s, dz0=seed[1])
        scale = 1.0 if wrt == "p0" else Z0_SEED_SCALE
        tol, mag = TAN_TOLS["dT"]
        _, ratio = diff_ratio(g, dts[:, -1], tol * scale, mag * scale)
        shots = []
        for sign in (1.0, -1.0):
            a = (z0, p0 + sign * eps) if wrt == "p0" else (z0 + sign * eps, p0)
            shots.append(stepper.trace_kernel(env, *a, geom, s_off))
        hi, lo = shots
        same = ((hi.n_surf == lo.n_surf) & (hi.n_bott == lo.n_bott) & (hi.n_surf == res.n_surf)
                & (hi.n_bott == res.n_bott) & hi.alive & lo.alive)
        fd = (hi.ts[:, -1] - lo.ts[:, -1]) / (2 * eps)
        rel = ((fd - g).abs() / g[same].abs().max())[same]
        out[wrt] = {"launches": {"trace_fan_f32": launches[0],
                                 "trace_tangent_save_f32": launches[1]},
                    "vs_plain_over_bound": ratio, "rays_compared": int(same.sum()),
                    "fd_rel_err_median": float(rel.median()), "fd_rel_err_max": float(rel.max()),
                    "fd_median_bound": med_bound}
        require(launches == (0, 1), f"grad over {wrt}: launches {launches}, expected (0, 1)")
        require(ratio <= 1.0, f"grad over {wrt} off the plain tangent by {ratio:.3g} bounds")
        require(int(same.sum()) >= 0.8 * len(p0), f"grad over {wrt}: too few comparable rays")
        require(float(rel.median()) <= med_bound,
                f"grad over {wrt}: median error vs central differences {float(rel.median()):.3g}")
    emit("autograd", rays=len(p0), **out)


def timed_call(cx, fn):
    """``(result, wall seconds, launches of (fan, tangent, save-grid tangent)
    kernels)`` of one synchronized call, the counts set to 0 just before."""
    st = cx.stepper
    cx.torch.cuda.synchronize()
    st.LAUNCHES = st.TANGENT_LAUNCHES = st.TANGENT_SAVE_LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    cx.torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (st.LAUNCHES, st.TANGENT_LAUNCHES,
                                           st.TANGENT_SAVE_LAUNCHES)


def receiver_paths_phase(cx):
    """The receiver side at full width through the user API, launch counts
    asserted: ``arrival_amplitudes`` over the headline fan,
    ``transmission_loss_field`` at examples/tl_demo.py's parameters,
    ``impulse_response`` and ``array_response`` at
    examples/impulse_response_demo.py's.  Returns what the times phase and
    the kernels line need."""
    from pygenray_tpu_torch.models import munk_env

    pt = cx.pt
    angles = np.linspace(-ANGLE_SPAN, ANGLE_SPAN, NUM_RAYS)
    arr, arr_s, n = timed_call(cx, lambda: pt.arrival_amplitudes(
        SRC_DEPTH, 0.0, angles, R_MAX, cx.env_h, num_save=NUM_SAVE, dx=DX, flatearth=False))
    launches_main = n[2]
    ok = arr.alive
    emit("arrival_amplitudes_headline", rays=NUM_RAYS, saves=NUM_SAVE, alive=int(ok.sum()),
         seconds=arr_s, launches=dict(zip(KERNEL_NAMES, n)),
         kmah_histogram=np.bincount(arr.kmah[ok]).tolist(),
         tl_db_median=float(np.median(arr.tl_db[ok])))
    require(n == (0, 0, 1), f"arrival_amplitudes launched {n}, expected one save-grid tangent")
    require(ok.sum() >= 0.999 * NUM_RAYS, f"arrival_amplitudes kept {int(ok.sum())} rays")
    require(np.isfinite(arr.amplitude[ok]).all() and (arr.amplitude[ok] > 0).all()
            and np.isfinite(arr.travel_time[ok]).all() and np.isnan(arr.amplitude[~ok]).all(),
            "arrival_amplitudes: live rays need finite positive amplitudes, dead rays NaN")

    # examples/tl_demo.py at its full parameters
    tl_env = munk_env(r_max=120e3, nr=50, nz=1200)
    tl_angles, tl_depths = np.linspace(-13.0, 13.0, 2001), np.linspace(0.0, 5000.0, 251)
    fld, tl_s, n = timed_call(cx, lambda: pt.transmission_loss_field(
        1000.0, 0.0, tl_angles, 120e3, tl_env, frequency=75.0, depths=tl_depths, num_range=301,
        flatearth=False))
    on_axis = fld.tl_incoherent[np.argmin(np.abs(tl_depths - 1000.0))]
    finite = np.isfinite(on_axis)
    q = max(int(finite.sum()) // 4, 1)
    demo = {"axis_insonified": float(finite.mean()),
            "tl_grows_with_range": bool(on_axis[finite][-q:].mean() > on_axis[finite][:q].mean()),
            "coherent_cells": int(np.isfinite(fld.tl_coherent).sum())}
    emit("transmission_loss_field_demo", rays=len(tl_angles), depths=len(tl_depths), ranges=300,
         seconds=tl_s, launches=dict(zip(KERNEL_NAMES, n)),
         insonified_cells=int(np.isfinite(fld.tl_incoherent).sum()), demo_assertions=demo)
    require(n == (0, 0, 1), f"transmission_loss_field launched {n}, expected one save-grid "
            "tangent")
    require(fld.tl_incoherent.shape == (251, 300) and fld.tl_coherent.shape == (251, 300)
            and np.isfinite(fld.tl_incoherent).mean() > 0.5 and demo["coherent_cells"] > 0,
            "transmission_loss_field: wrong shape or an empty field")

    # examples/impulse_response_demo.py at its full parameters; the Newton
    # iterations are read off a separate eigenray solve of the same case
    ir_env = munk_env(r_max=100e3, nr=50, nz=1200)
    kw = dict(num_rays=2048, max_angle=14.0, num_save=400, flatearth=False)
    fan = pt.shoot_rays(1300.0, 0.0, np.linspace(-14.0, 14.0, 2048), 100e3, 400, ir_env,
                        flatearth=False)
    zd = np.linspace(1100.0, 1500.0, 16)
    iters = {}
    for label, rds in (("impulse_response", [1000.0]), ("array_response", zd)):
        er = pt.find_eigenrays(fan, np.asarray(rds), 1300.0, 0.0, 100e3, 400, ir_env,
                               flatearth=False)
        iters[label] = int(er.diagnostics["iterations"].max(initial=0))
    resp, ir_s, n_ir = timed_call(cx, lambda: pt.impulse_response(
        1300.0, 0.0, 1000.0, 100e3, ir_env, center_frequency=75.0, bandwidth=37.5, **kw))
    ar, ar_s, n_ar = timed_call(cx, lambda: pt.array_response(
        1300.0, 0.0, zd, 100e3, ir_env, center_frequency=75.0, bandwidth=37.5, **kw))
    rows = int((np.abs(ar.waveform) > 0).any(axis=1).sum())
    peak = float(resp.envelope().max())
    emit("impulse_response_demo", arrivals=int(resp.arrivals.alive.sum()), samples=len(resp.t),
         peak_envelope=peak, seconds=ir_s, launches=dict(zip(KERNEL_NAMES, n_ir)),
         newton_iterations=iters["impulse_response"])
    emit("array_response_demo", depths=len(zd), depths_with_arrivals=rows,
         arrivals=int(sum(r.arrivals.alive.sum() for r in ar.responses)), samples=len(ar.t),
         seconds=ar_s, launches=dict(zip(KERNEL_NAMES, n_ar)),
         newton_iterations=iters["array_response"])
    require(n_ir == (2, iters["impulse_response"], 1),
            f"impulse_response launched {n_ir}, expected (2, {iters['impulse_response']}, 1)")
    require(n_ar == (2, iters["array_response"], 1),
            f"array_response launched {n_ar}, expected (2, {iters['array_response']}, 1)")
    require(np.isfinite(resp.waveform).all() and peak > 0 and resp.arrivals.alive.all(),
            "impulse_response: non-finite or empty waveform")
    require(np.isfinite(ar.waveform).all() and rows == len(zd),
            f"array_response: {rows} of {len(zd)} depths received arrivals")
    return types.SimpleNamespace(
        arr_s=arr_s, tl_s=tl_s, ir_s=ir_s, ar_s=ar_s, tl_env=tl_env, tl_angles=tl_angles,
        eig_angles=np.concatenate([r.arrivals.theta0 for r in ar.responses]), ir_env=ir_env,
        launches_main=launches_main)


def receiver_physics_phase(cx):
    """Physics that needs no reference, in float32 on the card
    (tests/test_amplitudes.py's cases): spherical spreading A = 1/s in an
    unbounded isovelocity medium within 1e-3 relative, a surface bounce's
    phase pi, and the spreading Jacobian behind the amplitudes against
    central differences of two fan-kernel shots (launch angle step 0.01
    degrees: the final depth moves by metres against millimetres of
    float32 rounding) within 1e-2 relative."""
    torch, pt = cx.torch, cx.pt
    z = np.linspace(0.0, 20000.0, 64)
    r = np.linspace(0.0, 300e3, 8)
    iso = pt.make_env_data(np.full((8, 64), 1500.0), r, z, np.full(8, 20000.0), r,
                           dtype=torch.float32, device=cx.dev)
    angles = np.array([-10.0, -5.0, -1.0, 2.0, 8.0])
    arr = pt.arrival_amplitudes(10000.0, 0.0, angles, 20e3, iso, num_save=64)
    slant = 20e3 / np.cos(np.radians(angles))
    err_iso = float(np.max(np.abs(arr.amplitude * slant - 1.0)))
    bounce = pt.arrival_amplitudes(100.0, 0.0, np.array([20.0]), 10e3, iso, num_save=64)
    err_bounce = float(abs(bounce.amplitude[0] * 10e3 / np.cos(np.radians(20.0)) - 1.0))

    env, R = cx.env_h, 50e3
    th = np.array([-8.0, -4.0, 0.5, 3.0, 7.0])
    a = pt.arrival_amplitudes(SRC_DEPTH, 0.0, th, R, env, num_save=128, dx=DX, flatearth=False)
    c0 = float(pt.munk_ssp(np.asarray([SRC_DEPTH]))[0])
    from pygenray_tpu_torch.envdata import host_profile_tables

    cr = pt.bilinear_np(np.full_like(a.z_r, R), -a.z_r, *host_profile_tables(env))
    jac_ad = (cr * np.cos(np.radians(th))) / (c0 * R * np.cos(np.radians(a.theta_r))
                                               * a.amplitude ** 2)
    d = 1e-2
    shot = lambda t: pt.shoot_rays(SRC_DEPTH, 0.0, t, R, 128, env, dx=DX, flatearth=False).zs[:, -1]
    jac_fd = np.abs(shot(th + d) - shot(th - d)) / (2 * np.radians(d))
    err_fd = float(np.max(np.abs(jac_ad / jac_fd - 1.0)))
    emit("receiver_physics", spherical_spreading_rel_err=err_iso, bound=1e-3,
         surface_bounce={"n_surf": int(bounce.n_surf[0]), "kmah": int(bounce.kmah[0]),
                         "phase": float(bounce.phase[0]), "amplitude_rel_err": err_bounce},
         jacobian_vs_central_differences_rel_err=err_fd, fd_bound=1e-2)
    require(arr.alive.all() and (arr.kmah == 0).all() and (arr.n_surf == 0).all()
            and err_iso <= 1e-3, f"spherical spreading off by {err_iso:.3g}")
    require(int(bounce.n_surf[0]) == 1 and int(bounce.kmah[0]) == 0
            and abs(float(bounce.phase[0]) - np.pi) < 1e-6 and err_bounce <= 1e-3,
            "surface bounce: wrong phase or amplitude")
    require(a.alive.all() and err_fd <= 1e-2,
            f"spreading Jacobian off central differences by {err_fd:.3g}")


def receiver_vs_jax_phase(cx):
    """The port's arrivals and transmission-loss field against the JAX
    package's (tests/fixtures/receiver_jax_f32.npz; bounds RCV_*).
    Amplitudes are held away from caustics: where the JAX package's
    spreading Jacobian is not within a factor 100 of vanishing next to the
    fan's median."""
    pt = cx.pt
    fx = np.load(RECEIVER_JAX)
    P = json.loads(str(fx["params"]))
    lin = lambda k: np.linspace(P[k][0], P[k][1], int(P[k][2]))
    arr = pt.arrival_amplitudes(P["src"], 0.0, lin("arr_angles"), P["r_max"], cx.env_h,
                                num_save=P["arr_num_save"], dx=P["dx"], flatearth=False)
    exact = ("kmah", "n_surf", "n_bott", "alive", "death_code")
    same = {f: bool(np.array_equal(getattr(arr, f), fx[f"arr/{f}"])) for f in exact}
    amp_ref = fx["arr/amplitude"]
    away = amp_ref < 100.0 * np.nanmedian(amp_ref)
    errs = {
        "amplitude_rel": float(np.nanmax(np.abs(arr.amplitude / amp_ref - 1.0)[away])),
        "phase": float(np.max(np.abs(arr.phase - fx["arr/phase"]))),
        "travel_time_s": float(np.max(np.abs(arr.travel_time - fx["arr/travel_time"]))),
        "z_r_m": float(np.max(np.abs(arr.z_r - fx["arr/z_r"]))),
    }
    fld = pt.transmission_loss_field(
        P["src"], 0.0, lin("tl_angles"), P["r_max"], cx.env_h, frequency=P["tl_frequency"],
        depths=lin("tl_depths"), num_range=P["tl_num_range"], dx=P["dx"], flatearth=False)
    inc_ref, coh_ref = fx["tl/tl_incoherent"].astype(float), fx["tl/tl_coherent"].astype(float)
    masks = bool(np.array_equal(np.isnan(fld.tl_incoherent), np.isnan(inc_ref))
                 and np.array_equal(np.isnan(fld.tl_coherent), np.isnan(coh_ref)))
    press = lambda tl: 10.0 ** (-tl / 20.0)
    errs["tl_incoherent_db"] = float(np.nanmax(np.abs(fld.tl_incoherent - inc_ref)))
    errs["tl_coherent_pressure_rel"] = float(
        np.nanmax(np.abs(press(fld.tl_coherent) - press(coh_ref))) / np.nanmax(press(coh_ref)))
    emit("receiver_vs_jax", arrivals=len(arr), away_from_caustics=int(away.sum()),
         exact_fields_equal=same, nan_masks_equal=masks, max_err=errs,
         bounds={"amplitude_rel": RCV_AMP_REL, "travel_time_s": RCV_TIME_S, "z_r_m": RCV_DEPTH_M,
                 "tl_incoherent_db": RCV_TL_INC_DB, "tl_coherent_pressure_rel": RCV_COH_REL})
    require(all(same.values()), f"arrivals differ from the JAX package's in {same}")
    require(masks, "the TL fields' empty cells differ from the JAX package's")
    require(errs["amplitude_rel"] <= RCV_AMP_REL and errs["phase"] == 0.0
            and errs["travel_time_s"] <= RCV_TIME_S and errs["z_r_m"] <= RCV_DEPTH_M
            and errs["tl_incoherent_db"] <= RCV_TL_INC_DB
            and errs["tl_coherent_pressure_rel"] <= RCV_COH_REL,
            f"receiver side off the JAX package: {errs}")


def cut_plan(x1, num_save, dx, to=None):
    """The plan of a comparison cut to about ``to`` (``CMP_X1`` by default;
    no longer than ``x1``) at the same step and save spacing as the plan of
    ``(x1, num_save, dx)``: ``(geom, saves)``."""
    from pygenray_tpu_torch.integrate import _plan

    seg_len = x1 / (num_save - 1)
    nseg = max(1, round((CMP_X1 if to is None else to) / seg_len))
    if nseg >= num_save - 1:
        return (0.0, x1, *_plan(0.0, x1, num_save, dx)), num_save
    return (0.0, nseg * seg_len, *_plan(0.0, nseg * seg_len, nseg + 1, dx)), nseg + 1


def save_tangent_times_phase(cx, rcv, plain_8192_ms):
    """The save-grid tangent kernel at the shapes the receiver side gives
    it: the headline fan's (102,400 rays, 490 steps, 50 saves), the TL
    demo's (2,001 rays, 2,400 steps of 50 m, 301 saves) and the array
    response's (its eigenrays, 2,000 steps of 50 m, 400 saves), with device
    times (CUDA events, wrapper included) and bounds at each full shape, and
    the host share of each full-width call.  Each is held to the plain
    version as ``save_tangent_phase`` holds the 8,192-ray fans: the headline
    fan at its full shape; the TL demo and the array response with every ray
    but cut to about ``CMP_X1`` at the same step and save spacing
    (``cut_plan``), where the plain loop, whose time goes with its steps and
    not its rays, takes a quarter of the time.  Returns (the rows by shape,
    the worst errors)."""
    from pygenray_tpu_torch.envdata import host_profile_tables
    from pygenray_tpu_torch.integrate import _trace_tangent_save_impl

    torch, pt, stepper, s = cx.torch, cx.pt, cx.stepper, cx.settings
    rows, errs_all = {}, []

    def shape(label, env, src, angles, x1, num_save, st, plain=True, cut=False):
        h, sps, nseg = cx.plan(0.0, x1, num_save, st.dx)
        geom = (0.0, x1, h, sps, nseg)
        c_src = float(pt.bilinear_np(0.0, src, *host_profile_tables(env)))
        p0 = on_card(cx, np.sin(np.radians(-angles)) / c_src)
        run = lambda: stepper.trace_tangent_save_kernel(env, src, p0, 1.0, geom, st)
        out_k = run()
        ms = events_ms(run)
        b_ms, b_by = save_tangent_bound(out_k[0], env, sps)
        rows[label] = {"rays": len(angles), "steps": sps * nseg, "saves": num_save,
                       "kernel_event_ms": ms, "bound_ms": b_ms, "bound_by": b_by}
        if plain:
            if cut:
                geom, saves = cut_plan(x1, num_save, st.dx)
                out_k = stepper.trace_tangent_save_kernel(env, src, p0, 1.0, geom, st)
                rows[label]["compared_at"] = {"range_m": geom[1], "steps": geom[3] * geom[4],
                                              "saves": saves}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = _trace_tangent_save_impl(env, src, p0, 1.0, geom, st)
            torch.cuda.synchronize()
            rows[label]["plain_ms"] = (time.perf_counter() - t0) * 1e3
            errs_all.append(compare_save_tangent(f"{label}_shape", 1.0, out_k, out_p))

    shape("headline", cx.env_h, SRC_DEPTH, np.linspace(-ANGLE_SPAN, ANGLE_SPAN, NUM_RAYS),
          R_MAX, NUM_SAVE, s)
    shape("fan8192", cx.env_h, SRC_DEPTH, cx.eq_angles, R_MAX, NUM_SAVE, s, plain=False)
    rows["fan8192"]["plain_ms"] = plain_8192_ms  # compared in save_tangent_phase
    s50 = pt.SolverSettings(dx=50.0)  # the demos' default step
    shape("tl_demo", rcv.tl_env.env_data(flatearth=False), 1000.0, rcv.tl_angles, 120e3, 301, s50,
          cut=True)
    shape("array_response_eigenrays", rcv.ir_env.env_data(flatearth=False), 1300.0,
          rcv.eig_angles, 100e3, 400, s50, cut=True)
    # the host share of each full-width call: its wall time less the device
    # time of its one save-grid tangent launch
    calls = {"arrival_amplitudes_headline": (rcv.arr_s, rows["headline"]["kernel_event_ms"]),
             "transmission_loss_field_demo": (rcv.tl_s, rows["tl_demo"]["kernel_event_ms"])}
    emit("times_save_tangent", card=cx.smi, **rows,
         calls={k: {"wall_ms": w * 1e3, "save_tangent_ms": d, "host_and_copies_ms": w * 1e3 - d}
                for k, (w, d) in calls.items()},
         impulse_response_wall_ms=rcv.ir_s * 1e3, array_response_wall_ms=rcv.ar_s * 1e3)
    return rows, {f: max(e[f] for e in errs_all) for f in errs_all[0]}


# ---------------------------------------------------------------------------
# Monte Carlo: the segment mode, the ensemble tangent kernel, config 4
# ---------------------------------------------------------------------------


def mc_context(cx):
    """BASELINE config 4's ensemble (bench.py:480-482: 16 internal-wave
    realizations of Munk, nz = 1024, 32 stations over 100 km, flat 5000 m
    bottom; Chebyshev, 64 terms) and bench.py's rough field (16
    realizations, nz = 2001, 16 stations; segment fits), built on the card
    by the port's make_env_ensemble."""
    from pygenray_tpu_torch.models import perturbed_munk_tables

    torch, pt = cx.torch, cx.pt
    t0 = time.perf_counter()
    c, r, z = perturbed_munk_tables(MC_E, r_max=R_MAX, nr=32, nz=1024, seed=0)
    cx.mc_tables = (c, r, z)
    cx.env_mc = pt.make_env_ensemble(c, r, z, np.full(32, 5000.0), r, dtype=torch.float32,
                                     device=cx.dev)
    t1 = time.perf_counter()
    c, r, z = rough_field().rough_tables(pt.munk_ssp, MC_E)
    cx.env_sg = pt.make_env_ensemble(c, r, z, np.full(16, 5000.0), r, dtype=torch.float32,
                                     device=cx.dev)
    t2 = time.perf_counter()
    # bench.py converts launch angles with the unperturbed Munk speed
    cx.c_src_mc = float(pt.munk_ssp(np.asarray([SRC_DEPTH]))[0])
    env_mc, env_sg = cx.env_mc, cx.env_sg
    emit("mc_ensembles", config4={"realizations": int(env_mc.c.shape[0]),
                                  "terms": int(env_mc.c_cheb.shape[-1]), "poly_ok": env_mc.poly_ok,
                                  "fit_seconds": t1 - t0},
         rough={"realizations": int(env_sg.c.shape[0]), "basis": env_sg.seg_basis,
                "terms": int(env_sg.c_seg.shape[-2]), "segments": int(env_sg.c_seg.shape[-1]),
                "fit_seconds": t2 - t1})
    require(env_mc.has_cheb and env_mc.range_dependent, "config 4 ensemble is not Chebyshev")
    require(env_sg.has_seg and not env_sg.has_cheb and env_sg.range_dependent,
            "the rough ensemble did not take the segment fit")


def rough_field():
    """tests/fixtures/rough_field.py (numpy only), imported by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("rough_field", FIXTURES / "rough_field.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seg_kernel_phase(cx):
    """The fan kernel's segment mode against its plain version: a
    range-independent Munk fit in each basis ("pow", Horner: 8 terms;
    "cheb", Clenshaw: 32), 8,192 rays to 30 km; realization 0 of the rough
    field (range-dependent, 32 terms: the block blends each step's tables
    into two buffers in shared memory) at the shape the rough trace_ensemble
    gives each launch: 65,536 rays to 100 km, dx = 100 m, 2 saves; and the
    layouts the main path does not take, on exact-order fits of the same
    realization: 96 terms (one buffer) and 128 (no buffer: each pick blends
    from device memory), 4,096 rays to 10 km.  The rough shape is held to
    the plain version with every ray over ``CMP_X1`` at the same step (2
    saves), where the plain loop, whose time goes with its steps, takes
    under a third of the time, and timed and bounded in full.  First a
    line of the layout the launcher (``trace_fan_seg_layout``) takes for
    each K of both fit ladders and for 128, which must be
    ``stepper.seg_layout``'s.  Returns
    (worst errors, the rough case's row for the times: kernel and plain ms,
    bound)."""
    from pygenray_tpu_torch.envdata import SEG_CHEB_LADDER, SEG_ORDER_LADDER, env_member
    from pygenray_tpu_torch.ops import _build

    torch, pt, stepper = cx.torch, cx.pt, cx.stepper
    lay = _build.load("trace_fan").trace_fan_seg_layout
    layouts = {}
    for K in [o + 1 for o in SEG_ORDER_LADDER + SEG_CHEB_LADDER] + [128]:
        got = stepper.SEG_LAYOUTS[lay(K, SEG_S)]
        require(got == stepper.seg_layout(K, SEG_S),
                f"K = {K}: the launcher takes {got}, stepper.seg_layout says "
                f"{stepper.seg_layout(K, SEG_S)}")
        layouts[K] = got
    z, r = np.linspace(0.0, 6000.0, NZ), np.linspace(0.0, R_MAX, NR)
    errs, out = [], {}
    cases = []
    p0_eq = lambda env: on_card(cx, launch_p0(pt, env, cx.eq_angles))
    for basis in ("pow", "cheb"):
        env = pt.make_env_data(np.outer(np.ones(NR), pt.munk_ssp(z)), r, z, np.full(NR, 5000.0),
                               r, interp="seg", seg_basis=basis, dtype=torch.float32,
                               device=cx.dev)
        require(env.has_seg and env.seg_basis == basis and not env.range_dependent,
                f"the {basis} segment fit is not range-independent")
        cases.append((f"segment_{basis}", env, cx.settings, p0_eq(env), SEG_X1, 10))
    s_rough = pt.SolverSettings(dx=ROUGH_DX)
    rough0 = env_member(cx.env_sg, 0)
    cases.append(("segment_rough_rd", rough0, s_rough, on_card(cx, mc_launch_p0(cx)), CMP_X1, 2))
    c, r_s, z_s = rough_field().rough_tables(pt.munk_ssp, 1)
    p0_small = on_card(cx, np.sin(np.radians(-np.linspace(-ANGLE_SPAN, ANGLE_SPAN, SEG_SMALL_RAYS)))
                       / cx.c_src_mc)
    for K in SEG_OTHER_K:
        env = pt.make_env_data(c[0], r_s, z_s, np.full(len(r_s), 5000.0), r_s, interp="seg",
                               seg_basis="cheb", seg_order=K - 1, seg_exact_order=True,
                               dtype=torch.float32, device=cx.dev)
        require(env.c_seg.shape[-2:] == (K, SEG_S)
                and layouts[K] != layouts[int(rough0.c_seg.shape[-2])],
                f"the rough K = {K} fit does not take another layout")
        cases.append((f"segment_rough_rd_{layouts[K]}", env, s_rough, p0_small, SEG_OTHER_X1,
                      2))
    emit("seg_layouts", layouts=layouts, main_path=layouts[int(rough0.c_seg.shape[-2])],
         compared=[int(e.c_seg.shape[-2]) for _, e, *_ in cases])
    k_main = int(rough0.c_seg.shape[-2])
    for name, env, s, p0, x1, num_save in cases:
        h, sps, nseg = cx.plan(0.0, x1, num_save, s.dx)
        geom = (0.0, x1, h, sps, nseg)
        require(stepper.kernel_supported(env, s) and not stepper.tangent_supported(env, s),
                f"{name}: not the fan kernel's segment mode")
        n0 = stepper.SEG_LAUNCHES
        res_k = stepper.trace_kernel(env, SRC_DEPTH, p0, geom, s)
        require(stepper.SEG_LAUNCHES == n0 + 1, f"{name}: the segment mode did not launch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_p = pt.trace(env, SRC_DEPTH, p0, 0.0, x1, num_save,
                         dataclasses.replace(s, backend="ops"))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs.append(compare(f"{name}_K{int(env.c_seg.shape[-2])}", res_k, res_p))
        if name == "segment_rough_rd":
            h, sps, nseg = cx.plan(0.0, R_MAX, num_save, s.dx)
            g_full = (0.0, R_MAX, h, sps, nseg)
            b_ms, b_by = seg_fan_bound(stepper.trace_kernel(env, SRC_DEPTH, p0, g_full, s), env,
                                       sps)
            out = {"rays": int(p0.shape[0]), "steps": sps * nseg, "plain_ms": plain_ms,
                   "compared_at": {"range_m": x1, "steps": geom[3] * geom[4]},
                   "bound_ms": b_ms, "bound_by": b_by, "layout": layouts[k_main],
                   "kernel_event_ms": events_ms(
                       lambda: stepper.trace_kernel(env, SRC_DEPTH, p0, g_full, s), n=5)}
    return worst(errs), out


def mc_launch_p0(cx):
    """The launch parameters of the Monte-Carlo fans: 65,536 rays over
    ±15°, converted with the unperturbed Munk speed at the source as
    bench.py does."""
    return np.sin(np.radians(-np.linspace(-ANGLE_SPAN, ANGLE_SPAN, MC_RAYS))) / cx.c_src_mc


def config4b_call(cx):
    """BASELINE config 4b's ``mc_eigenray_times`` (bench.py:537-556):
    512-angle ±14° fans over config 4's ensemble, receiver at 1300 m, 100
    km, ztol = 1 m."""
    return cx.pt.mc_eigenray_times(cx.env_mc, np.linspace(-14.0, 14.0, 512), 1300.0, SRC_DEPTH,
                                   0.0, R_MAX, ztol=1.0, settings=cx.pt.SolverSettings(dx=DX))


def ens_shapes(cx, mc):
    """The launch parameters of the two shapes config 4b's call gives the
    ensemble tangent kernel, 16 realizations each: the fan (512 angles over
    ±14°) and the Newton batch (MC_BRACKET_CAP candidates: each
    realization's arrivals in ``mc`` and, in the unused lanes, the fan's
    last angle, where the compaction's sentinel points them)."""
    from pygenray_tpu_torch.montecarlo import MC_BRACKET_CAP

    newton = np.full((MC_E, MC_BRACKET_CAP), 14.0)
    M = mc["valid"].shape[1]
    newton[:, :M] = np.where(mc["valid"], mc["theta"], 14.0)
    shapes = (("config4b_fan", np.broadcast_to(np.linspace(-14.0, 14.0, 512), (MC_E, 512))),
              ("config4b_newton", newton))
    return {label: on_card(cx, np.sin(np.radians(-np.asarray(ang))) / cx.c_src_mc)
            for label, ang in shapes}


def ens_rows_equal(cx, label, env, P, geom, out_k):
    """Each (realization) row of an ensemble launch against the final-state
    tangent kernel on that realization alone, bit for bit."""
    from pygenray_tpu_torch.envdata import env_member

    rows_equal = []
    for e in range(env.c.shape[0]):
        b2 = cx.stepper.trace_tangent_kernel(env_member(env, e), SRC_DEPTH, P[e], 1.0, geom,
                                             cx.settings)
        rows_equal.append(all(bool(cx.torch.equal(a[e], b)) for a, b in zip(out_k, b2)))
    emit("ens_tangent_rows_vs_tangent_kernel", case=label, rows_equal=rows_equal)
    require(all(rows_equal), f"{label}: an ensemble row differs from the tangent kernel on its "
            "realization")


def ens_tangent_phase(cx, mc):
    """The ensemble tangent kernel at the two shapes config 4b's
    mc_eigenray_times gives it (``ens_shapes``, from the main path's run),
    over all 16 realizations (100 km, dx = 200 m, the solver's 2-save plan:
    500 steps), timed, bounded and compared at that full shape: each launch
    held to the plain version, and each row to the final-state tangent
    kernel on its realization alone, bit for bit.  The plain version runs
    once over both shapes' candidates side by side (16 × 536): its
    arithmetic is elementwise over candidates, so each one's numbers do not
    depend on its neighbours, and the loop costs the same at any width
    (launch-bound).  Then the kernel at two other K, on exact-order fits of
    config 4's tables (``ENS_OTHER_K``: one compiled fixed, one at run time)
    with every Newton candidate over ``ENS_OTHER_X1``, held alike; first a
    line of the layout the launcher (``trace_tangent_ens_layout``) takes
    for each K of the spectral ladder and these, which must be
    ``stepper.ens_layout``'s.  Returns (worst errors, the rows for the
    times)."""
    import ctypes

    from pygenray_tpu_torch.envdata import env_member
    from pygenray_tpu_torch.integrate import _ens_step_data, _trace_tangent_ens_impl
    from pygenray_tpu_torch.ops import _build

    torch, pt, stepper, env, s = cx.torch, cx.pt, cx.stepper, cx.env_mc, cx.settings
    h, sps, nseg = cx.plan(0.0, R_MAX, 2, DX)
    geom = (0.0, R_MAX, h, sps, nseg)
    sd = _ens_step_data(env, geom, s)  # the rows, built once per call as the main path does
    tables = (*sd.prof_ms, *sd.prof_1s)
    lay = _build.load("trace_tangent_ens").trace_tangent_ens_layout
    lay.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    layouts = {}
    for K in stepper.ENS_FIXED_K + ENS_OTHER_K + (31,):
        for label, ts in (("aligned", tables), ("offset", [t.view(-1)[1:] for t in tables])):
            bits = lay(K, *(t.data_ptr() for t in ts))
            got = ("fixed" if bits & 1 else "run-time", 16 if bits & 2 else 4)
            require(got == stepper.ens_layout(K, ts),
                    f"K = {K} ({label}): the launcher takes {got}, stepper.ens_layout says "
                    f"{stepper.ens_layout(K, ts)}")
            layouts[f"{K}_{label}"] = got
    k_main = int(env.c_cheb.shape[-1])
    emit("ens_layouts", layouts=layouts, main_path=stepper.ens_layout(k_main, tables))
    P = ens_shapes(cx, mc)
    outs = {}
    for label in P:
        n0 = stepper.TANGENT_ENS_LAUNCHES
        outs[label] = stepper.trace_tangent_ensemble_kernel(env, SRC_DEPTH, P[label], 1.0, geom, s,
                                                            sd)
        require(stepper.TANGENT_ENS_LAUNCHES == n0 + 1,
                "the ensemble tangent kernel did not launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    both = _trace_tangent_ens_impl(env, SRC_DEPTH, torch.cat(list(P.values()), 1), 1.0, geom, s,
                                   sd)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs, rows, lo = [], {}, 0
    for label in P:
        out_k, m = outs[label], P[label].shape[1]
        out_p = [a[:, lo:lo + m] for a in both]
        lo += m
        errs.append(compare_tangent(label, [a.reshape(-1) for a in out_k],
                                    [a.reshape(-1) for a in out_p]))
        ens_rows_equal(cx, label, env, P[label], geom, out_k)
        b_ms, b_by = ens_tangent_bound(out_k, env_member(env, 0), sps * nseg)
        rows[label] = {"realizations": MC_E, "candidates": m, "steps": sps * nseg,
                       "bound_ms": b_ms, "bound_by": b_by, "kernel_event_ms": events_ms(
                           lambda: stepper.trace_tangent_ensemble_kernel(
                               env, SRC_DEPTH, P[label], 1.0, geom, s, sd), n=10)}
    rows["plain_both"] = {"realizations": MC_E, "candidates": int(both[0].shape[1]),
                          "steps": sps * nseg, "range_m": R_MAX, "plain_ms": plain_ms}
    rows["k_layout"] = stepper.ens_layout(k_main, tables)
    # the other K: every Newton candidate over ENS_OTHER_X1
    c, r, z = cx.mc_tables
    h10, sps10, nseg10 = cx.plan(0.0, ENS_OTHER_X1, 2, DX)
    g10 = (0.0, ENS_OTHER_X1, h10, sps10, nseg10)
    Pn = P["config4b_newton"]
    for K in ENS_OTHER_K:
        env_k = pt.make_env_ensemble(c, r, z, np.full(32, 5000.0), r, dtype=torch.float32,
                                     device=cx.dev, cheb_order=K - 1, cheb_exact_order=True)
        require(env_k.has_cheb and env_k.c_cheb.shape[-1] == K
                and stepper.tangent_supported(env_member(env_k, 0), s),
                f"config 4's K = {K} fit is not a tangent-kernel field")
        sd_k = _ens_step_data(env_k, g10, s)
        label = f"config4b_newton_K{K}"
        n0 = stepper.TANGENT_ENS_LAUNCHES
        out_k = stepper.trace_tangent_ensemble_kernel(env_k, SRC_DEPTH, Pn, 1.0, g10, s, sd_k)
        require(stepper.TANGENT_ENS_LAUNCHES == n0 + 1, f"{label}: the kernel did not launch")
        out_p = _trace_tangent_ens_impl(env_k, SRC_DEPTH, Pn, 1.0, g10, s, sd_k)
        errs.append(compare_tangent(label, [a.reshape(-1) for a in out_k],
                                    [a.reshape(-1) for a in out_p]))
        ens_rows_equal(cx, label, env_k, Pn, g10, out_k)
        rows[label] = {"realizations": MC_E, "candidates": int(Pn.shape[1]),
                       "steps": sps10 * nseg10, "range_m": ENS_OTHER_X1,
                       "layout": stepper.ens_layout(K, (*sd_k.prof_ms, *sd_k.prof_1s))}
    return {f: max(e[f] for e in errs) for f in TAN_FIELDS}, rows


def ens_tangent_bound(out, env0, nsteps):
    """``tangent_bound`` over an (E, M) launch: every realization reads its
    own per-step rows."""
    E = out[0].shape[0]
    live = int((out[8] == 0).sum())
    return bound(live * nsteps * step_ops(env0) * DUAL_FACTOR,
                 out[0].numel() * 48 + E * step_input_bytes(env0, nsteps))


def mc_paths_phase(cx):
    """The Monte-Carlo main paths at full width through the user API, the
    launch counts set to 0 just before each and read just after:
    ``trace_ensemble`` over config 4's 16 realizations × 65,536 rays (100
    km, dx = 200 m, 2 saves; 16 fan-kernel launches, spectral);
    ``mc_eigenray_times`` at config 4b (512-angle ±14° fans, receiver at
    1300 m, ztol = 1 m: the one-shot path, the ensemble tangent kernel for
    the fan and every Newton iteration, 16 fan-kernel launches for the
    final evaluation); ``trace_ensemble`` over the rough field's 16
    realizations × 65,536 rays (dx = 100 m; 16 segment-mode launches)."""
    torch, pt, stepper = cx.torch, cx.pt, cx.stepper
    p0 = on_card(cx, mc_launch_p0(cx))
    s4, s_sg = pt.SolverSettings(dx=DX), pt.SolverSettings(dx=ROUGH_DX)
    counts = lambda: {"trace_fan_f32": stepper.LAUNCHES, "segment_mode": stepper.SEG_LAUNCHES,
                      "trace_tangent_ens_f32": stepper.TANGENT_ENS_LAUNCHES,
                      "trace_tangent_f32": stepper.TANGENT_LAUNCHES}
    out = {}

    def drive(name, fn, runs=3):
        """One synchronized call with the counts set to 0 just before it
        and read just after, then ``runs`` more for the wall time."""
        torch.cuda.synchronize()
        stepper.LAUNCHES = stepper.SEG_LAUNCHES = 0
        stepper.TANGENT_ENS_LAUNCHES = stepper.TANGENT_LAUNCHES = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        n = counts()
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"launches": n, "first_call_s": first, "median_s": statistics.median(walls),
                     "runs_s": walls}
        return res, n

    res, n = drive("config4", lambda: pt.trace_ensemble(cx.env_mc, SRC_DEPTH, p0, 0.0, R_MAX, 2, s4))
    alive = res.alive
    emit("config4_trace_ensemble", card=cx.smi, rays=MC_E * MC_RAYS, alive=int(alive.sum()),
         rays_per_s=MC_E * MC_RAYS / out["config4"]["median_s"], **out["config4"])
    require(n["trace_fan_f32"] == MC_E and n["segment_mode"] == 0,
            f"config 4 launched {n}, expected {MC_E} spectral fan launches")
    require(res.ts.shape == (MC_E, MC_RAYS, 2) and bool(torch.isfinite(res.ts[alive]).all())
            and int(alive.sum()) >= 0.999 * MC_E * MC_RAYS, "config 4: non-finite or lost rays")

    mc, n = drive("config4b", lambda: config4b_call(cx), runs=5)
    v = mc["valid"]
    emit("config4b_mc_eigenray_times", card=cx.smi, path=mc["path"], arrivals=int(v.sum()),
         arrivals_per_realization=v.sum(axis=1).tolist(),
         max_residual_m=float(np.max(mc["z_resid"][v], initial=0.0)),
         t_spread_ms=float(np.nanmax(np.nanstd(np.where(v, mc["t"], np.nan), axis=0)) * 1e3),
         **out["config4b"])
    require(mc["path"] == "one-shot", f"config 4b took the {mc['path']} path")
    require(n["trace_tangent_ens_f32"] >= 2 and n["trace_fan_f32"] == MC_E
            and n["trace_tangent_f32"] == 0,
            f"config 4b launched {n}: expected the ensemble kernel for the fan and each "
            f"iteration and {MC_E} fan launches")
    require(v.sum(axis=1).min() >= 1 and np.isfinite(mc["t"][v]).all()
            and (mc["z_resid"][v] < 1.0).all(), "config 4b: missing or unconverged arrivals")

    res, n = drive("rough", lambda: pt.trace_ensemble(cx.env_sg, SRC_DEPTH, p0, 0.0, R_MAX, 2,
                                                      s_sg))
    alive = res.alive
    emit("rough_trace_ensemble", card=cx.smi, rays=MC_E * MC_RAYS, alive=int(alive.sum()),
         rays_per_s=MC_E * MC_RAYS / out["rough"]["median_s"], **out["rough"])
    require(n["trace_fan_f32"] == MC_E and n["segment_mode"] == MC_E,
            f"the rough field launched {n}, expected {MC_E} segment-mode launches")
    require(bool(torch.isfinite(res.ts[alive]).all())
            and int(alive.sum()) >= 0.999 * MC_E * MC_RAYS, "rough field: non-finite or lost rays")
    return out, mc


def mc_vs_jax_phase(cx):
    """The Monte-Carlo answers against the JAX package's
    (tests/fixtures/mc_jax_f32.npz): config 4's demo-size eigenrays (the
    port's one-shot Newton against its regula falsi, MC_ANGLE_DEG and
    MC_TIME_S) and the rough field's fan (ROUGH_*), rebuilt here from the
    stored parameters."""
    from pygenray_tpu_torch.models import perturbed_munk_tables

    torch, pt = cx.torch, cx.pt
    fx = np.load(MC_JAX)
    P = json.loads(str(fx["params"]))
    lin = lambda f: np.linspace(f[0], f[1], int(f[2]))
    m = P["mc"]
    c, r, z = perturbed_munk_tables(m["E"], r_max=m["r_max"], nr=m["nr"], nz=m["nz"],
                                    mu_rms=m["mu_rms"], seed=m["seed"])
    env = pt.make_env_ensemble(c, r, z, np.full(len(r), m["bathy"]), r, dtype=torch.float32,
                               device=cx.dev)
    mc = pt.mc_eigenray_times(env, lin(m["fan"]), m["receiver_depth"], m["source_depth"], 0.0,
                              m["r_max"], ztol=m["ztol"], settings=pt.SolverSettings(dx=m["dx"]))
    valid_eq = bool(np.array_equal(mc["valid"], fx["mc/valid"]))
    v = fx["mc/valid"]
    err_a = float(np.max(np.abs(mc["theta"][v] - fx["mc/theta"][v]), initial=0.0))
    err_t = float(np.max(np.abs(mc["t"][v] - fx["mc/t"][v]), initial=0.0))
    nb_eq = bool(np.array_equal(mc["n_bott"][v], fx["mc/n_bott"][v]))
    r_ = P["rough"]
    c, r, z = rough_field().rough_tables(pt.munk_ssp, r_["E"], r_["nz"], r_["nr"], r_["r_max"],
                                         r_["seed"])
    env_r = pt.make_env_ensemble(c, r, z, np.full(len(r), r_["bathy"]), r, dtype=torch.float32,
                                 device=cx.dev)
    p0 = np.sin(np.radians(-lin(r_["fan"]))) / r_["c_src"]
    fan = pt.trace_ensemble(env_r, r_["source_depth"], p0, 0.0, r_["x1"], 2,
                            pt.SolverSettings(dx=r_["dx"]))
    host = lambda t: t.cpu().numpy()
    same = ((host(fan.n_surf) == fx["rough/n_surf"]) & (host(fan.n_bott) == fx["rough/n_bott"])
            & (host(fan.death_code) == fx["rough/death_code"]))
    dt = np.abs(host(fan.ts[..., -1]) - fx["rough/ts"])[same]
    emit("mc_vs_jax", eigenrays={"valid_equal": valid_eq, "arrivals": int(v.sum()),
                                 "path": mc["path"], "max_angle_err_deg": err_a,
                                 "max_time_err_s": err_t, "n_bott_equal": nb_eq,
                                 "max_residual_m": float(np.max(mc["z_resid"][v], initial=0.0))},
         rough_fan={"basis": env_r.seg_basis, "terms": int(env_r.c_seg.shape[-2]),
                    "rays": int(same.size), "rays_counters_equal": int(same.sum()),
                    "rays_time_over_bound": int((dt > ROUGH_TIME_S).sum()),
                    "max_time_err_s": float(dt.max(initial=0.0)),
                    "time_err_median_s": float(np.median(dt)) if dt.size else 0.0},
         bounds={"angle_deg": MC_ANGLE_DEG, "time_s": MC_TIME_S,
                 "rough_ray_share": ROUGH_RAY_SHARE, "rough_time_median_s": ROUGH_TIME_MEDIAN_S,
                 "rough_time_s": ROUGH_TIME_S, "rough_time_share": ROUGH_TIME_SHARE})
    require(mc["path"] == "one-shot" and valid_eq and nb_eq and int(v.sum()) > 0,
            "Monte-Carlo eigenrays: arrivals differ from the JAX package's")
    require(err_a <= MC_ANGLE_DEG and err_t <= MC_TIME_S
            and (mc["z_resid"][v] < m["ztol"]).all(),
            f"Monte-Carlo eigenrays off the JAX package's by {err_a:.3g} deg, {err_t:.3g} s")
    require(same.mean() >= ROUGH_RAY_SHARE and float(np.median(dt)) <= ROUGH_TIME_MEDIAN_S
            and (dt <= ROUGH_TIME_S).mean() >= ROUGH_TIME_SHARE,
            f"rough fan off the JAX package's: {same.mean():.4f} of rays with equal counters, "
            f"median {float(np.median(dt)):.3g} s, {(dt <= ROUGH_TIME_S).mean():.4f} of those "
            f"within {ROUGH_TIME_S} s")


def counted(cx, fn):
    """``(result, wall seconds, {counter: launches})`` of one synchronized
    call, every launch count set to 0 just before."""
    st = cx.stepper
    cx.torch.cuda.synchronize()
    for c in COUNTERS:
        setattr(st, c, 0)
    t0 = time.perf_counter()
    out = fn()
    cx.torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {c: getattr(st, c) for c in COUNTERS}


def require_counts(name, got, **want):
    """Every launch count is 0 but those named."""
    full = {c: want.get(c, 0) for c in COUNTERS}
    require(got == full, f"{name}: launches {got}, expected {full}")


def unit_directions(cx, env):
    """The K unit coefficient directions (dc = e_k, dc/dz chained through
    the Chebyshev derivative matrix), float32 on the card."""
    from pygenray_tpu_torch.adjoint import cheb_derivative_matrix

    K = env.c_cheb.shape[-1]
    Dm = cheb_derivative_matrix(K, *env.z_dom)
    return (cx.torch.eye(K, dtype=cx.torch.float32, device=cx.dev), on_card(cx, Dm.T))


def coef_step_ops(env):
    """FP32 operations of one coefficient-tangent ray-step, counted from
    tangent_step.cuh and dual.cuh as the compiled loop runs them, split
    into the primal's, which every direction and station of a ray shares,
    and one tangent's: ``(primal, tangent)``.  Four right-hand sides of two
    K-term Clenshaw series on Duals with Dual coefficients: a series forms
    2u once (1 + 1); each of its K - 1 terms and its close is a Dual product
    (1 + 3), a Dual sum with the coefficient (1 + 1) and a Dual difference
    (1 + 1), and range-dependent the hat product of the coefficient's
    tangent (0 + 1; range-independent the hat is the constant 1 and folds
    away).  The rest of the step is the forward step's (18 a right-hand
    side, 50 for the rest) for the primal and DUAL_FACTOR - 1 times it for
    a tangent."""
    K = env.c_cheb.shape[-1]
    primal = 4 * (2 * (1 + 3 * K) + 18) + 50
    tangent = (4 * (2 * (1 + K * (5 + int(bool(env.range_dependent)))) + 18 * (DUAL_FACTOR - 1))
               + 50 * (DUAL_FACTOR - 1))
    return primal, tangent


def coef_bound(out, env, nsteps):
    """Bound of one coefficient-tangent launch: live rays' steps, each the
    primal once and the tangent for every direction (and station); each
    input read once (launch parameters, the direction tables, per-step
    inputs; range-dependent: the station tables and the station rows),
    each output written once."""
    B = out[0].shape[0]
    dirs = out[3].numel() // max(B, 1)
    live = int((out[8] == 0).sum())
    K = env.c_cheb.shape[-1]
    nbytes = (B * (8 + 24) + out[3].numel() * 12 + 8 * K * out[3].shape[-2]
              + step_input_bytes(env, nsteps, stations=True))
    primal, tangent = coef_step_ops(env)
    return bound(live * nsteps * (primal + dirs * tangent), nbytes)


def nan_equal(a, b):
    """Elementwise equality in which NaN equals NaN."""
    eq = a == b
    return eq | (a.isnan() & b.isnan()) if a.is_floating_point() else eq


COEF_FIELDS = ("T", "z", "p", "dT", "dz", "dp", "n_surf", "n_bott", "death")


def compare_coef(name, out_k, out_p):
    """Hold a coefficient-tangent kernel to its plain version: every output
    equal, bit for bit (NaN in both agrees); print the phase line and
    return the largest |Δ| of each float output (0 when equal)."""
    import torch

    differing, errs = {}, {}
    for f, a, b in zip(COEF_FIELDS, out_k, out_p):
        bad = ~nan_equal(a, b)
        differing[f] = int(bad.sum())
        if a.is_floating_point():
            errs[f] = float((a - b).abs()[bad].max()) if differing[f] else 0.0
    codes = torch.bincount(out_p[8].long(), minlength=4).tolist()
    emit("coef_tangent_vs_plain", case=name, rays=int(out_p[0].shape[0]),
         tangent_shape=list(out_p[3].shape), bounces=int((out_p[6] + out_p[7]).sum()),
         rays_bouncing=int(((out_p[6] + out_p[7]) > 0).sum()), death_codes=codes,
         values_differing=differing, max_abs_err=errs)
    require(sum(differing.values()) == 0, f"{name}: kernel and plain version differ: {differing}")
    return errs


def coef_lockstep(name, out_c, out_b2):
    """The coefficient-tangent kernel's primal and counters are the
    final-state tangent kernel's on the same Clenshaw environment, bit for
    bit."""
    same = all(bool(nan_equal(out_c[i], out_b2[i]).all()) for i in (0, 1, 2, 6, 7, 8))
    emit("coef_tangent_primal_vs_tangent_kernel", case=name, equal=same)
    require(same, f"{name}: coefficient-tangent primal differs from the tangent kernel's")


def adjoint_context(cx):
    """The fields of the adjoint phases: bench.py's two Jacobian fields, the
    headline field in the range-dependent layout, and their fans."""
    torch, pt = cx.torch, cx.pt
    z = np.linspace(0.0, 6000.0, NZ)
    r = np.linspace(0.0, R_MAX, NR)
    cx.env_hrd = pt.make_env_data(np.outer(np.ones(NR), pt.munk_ssp(z)), r, z,
                                  np.full(NR, 5000.0), r, dtype=torch.float32, device=cx.dev,
                                  force_range_dependent=True)
    require(cx.env_hrd.range_dependent and torch.equal(cx.env_hrd.c_cheb[-1], cx.env_h.c_cheb[0]),
            "the range-dependent copy of the headline field has other coefficients")
    z2 = np.linspace(0.0, 6000.0, JAC2["nz"])
    r2 = np.linspace(0.0, R_MAX, JAC2["nr"])
    c2 = np.array([pt.munk_ssp(z2, sofar_depth=1300 + 0.002 * ri) for ri in r2])
    cx.env_j2 = pt.make_env_data(c2, r2, z2, np.full(JAC2["nr"], 5500.0), r2,
                                 dtype=torch.float32, device=cx.dev, cheb_order=JAC2["order"])
    require(cx.env_j2.range_dependent and cx.env_j2.c_cheb.shape == (JAC2["nr"], 16),
            "bench.py's 2D Jacobian field is not a 32 x 16 range-dependent fit")
    cx.s_j2 = pt.SolverSettings(dx=JAC2["dx"], interp="cheb", kahan=False)
    # bench.py converts angles with the table's speed at the source
    c_src2 = float(pt.bilinear_np(0.0, SRC_DEPTH, r2, z2, c2))
    cx.p0_j2 = on_card(cx, np.sin(np.radians(-np.linspace(-JAC2["span"], JAC2["span"],
                                                          JAC2["rays"]))) / c_src2)
    cx.p0_jac = {label: on_card(cx, launch_p0(pt, cx.env_h, np.linspace(-span, span, JAC_RAYS)))
                 for label, span in (("bench", JAC_SPAN), ("bounce", JAC_BOUNCE_SPAN))}


def coef_tangent_phase(cx):
    """B5 and B6 against their plain versions at bench.py's shapes: B5 on
    the headline field over 512 rays at ±14° and over a bottom-bouncing 512
    at ±30° (one plain run over both fans side by side: its arithmetic is
    elementwise over rays), 16 unit directions, 100 km at dx = 200 m; B6 on
    bench.py's 2D field, 64 rays × 16 directions × 32 stations, 1,000 steps.
    Each primal against the final-state tangent kernel (B2) on the same
    Clenshaw environment; Σ_j of B6 over stations against B5 on the
    headline field in the range-dependent layout.  Returns (worst errors,
    times)."""
    import dataclasses as dc

    from pygenray_tpu_torch.integrate import _trace_coef_tangent_impl, _trace_coef_tangent_rd_impl

    torch, st = cx.torch, cx.stepper
    env, s = cx.env_h, cx.settings
    h, sps, nseg = cx.plan(0.0, R_MAX, 2, DX)
    geom = (0.0, R_MAX, h, sps, nseg)
    dcs, dcps = unit_directions(cx, env)
    outs, errs = {}, []
    for label, p0 in cx.p0_jac.items():
        n0 = st.COEF_TANGENT_LAUNCHES
        outs[label] = st.trace_coef_tangent_kernel(env, SRC_DEPTH, p0, dcs, dcps, geom, s)
        require(st.COEF_TANGENT_LAUNCHES == n0 + 1, "the coefficient-tangent kernel did not launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    both = _trace_coef_tangent_impl(env, SRC_DEPTH, torch.cat(list(cx.p0_jac.values())), dcs,
                                    dcps, geom, s)
    torch.cuda.synchronize()
    plain5_ms = (time.perf_counter() - t0) * 1e3
    env_c = dc.replace(env, poly_ok=False)
    lo = 0
    for label, p0 in cx.p0_jac.items():
        m = p0.shape[0]
        out_p = [a[..., lo:lo + m] for a in both]
        lo += m
        errs.append(compare_coef(f"b5_{label}", outs[label], out_p))
        coef_lockstep(f"b5_{label}", outs[label],
                      st.trace_tangent_kernel(env_c, SRC_DEPTH, p0, 0.0, geom, s))
    require(int((outs["bounce"][7] > 0).sum()) > 0, "the ±30° fan does not reach the bottom")
    b5_ms = events_ms(lambda: st.trace_coef_tangent_kernel(env, SRC_DEPTH, cx.p0_jac["bench"],
                                                           dcs, dcps, geom, s), n=10)
    b5_bound, b5_by = coef_bound(outs["bench"], env, sps * nseg)

    env2, s2 = cx.env_j2, cx.s_j2
    h2, sps2, nseg2 = cx.plan(0.0, R_MAX, 2, s2.dx)
    geom2 = (0.0, R_MAX, h2, sps2, nseg2)
    d2, dp2 = unit_directions(cx, env2)
    n0 = st.COEF_TANGENT_RD_LAUNCHES
    out6 = st.trace_coef_tangent_rd_kernel(env2, SRC_DEPTH, cx.p0_j2, d2, dp2, geom2, s2)
    require(st.COEF_TANGENT_RD_LAUNCHES == n0 + 1, "the RD coefficient-tangent kernel did not launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out6_p = _trace_coef_tangent_rd_impl(env2, SRC_DEPTH, cx.p0_j2, d2, dp2, geom2, s2)
    torch.cuda.synchronize()
    plain6_ms = (time.perf_counter() - t0) * 1e3
    errs.append(compare_coef("b6_bench_2d", out6, out6_p))
    coef_lockstep("b6_bench_2d", out6, st.trace_tangent_kernel(dc.replace(env2, poly_ok=False),
                                                              SRC_DEPTH, cx.p0_j2, 0.0, geom2,
                                                              s2))
    b6_ms = events_ms(lambda: st.trace_coef_tangent_rd_kernel(env2, SRC_DEPTH, cx.p0_j2, d2, dp2,
                                                              geom2, s2), n=10)
    b6_bound, b6_by = coef_bound(out6, env2, sps2 * nseg2)

    # the hats of a station sum to one: Σ_j of B6 is B5 on the same field
    out_hrd = st.trace_coef_tangent_rd_kernel(cx.env_hrd, SRC_DEPTH, cx.p0_jac["bench"], dcs, dcps,
                                              geom, s)
    J5 = outs["bench"][3]
    dev_ = float((out_hrd[3].sum(0) - J5).abs().max())
    scale = float(J5.abs().max())
    emit("station_sum_identity", stations=NR, max_abs_err=dev_, largest_entry=scale,
         bound=STATION_SUM_REL * scale)
    require(dev_ <= STATION_SUM_REL * scale, f"Σ_j of B6 differs from B5 by {dev_:.3g}")
    worst_err = {"b5": {f: max(e[f] for e in errs[:-1]) for f in COEF_FIELDS[:6]},
                 "b6": errs[-1]}
    times = {
        "b5": {"rays": JAC_RAYS, "directions": int(dcs.shape[0]), "steps": sps * nseg,
               "kernel_event_ms": b5_ms, "bound_ms": b5_bound, "bound_by": b5_by,
               "plain_ms_both_fans": plain5_ms},
        "b6": {"rays": JAC2["rays"], "directions": int(d2.shape[0]), "stations": JAC2["nr"],
               "steps": sps2 * nseg2, "kernel_event_ms": b6_ms,
               "kernel_ms": cx.splits["b6_2d"]["kernel_ms"], "bound_ms": b6_bound,
               "bound_by": b6_by,
               "plain_ms": plain6_ms},
    }
    emit("times_coef_tangent", card=cx.smi, **times)
    return worst_err, times, outs["bench"]


def adjoint_paths_phase(cx, b5_bench):
    """bench.py's two Jacobian calls through the user API, the launch
    counts set to 0 just before each: ``travel_time_jacobian`` (one B5
    launch and nothing else; its Jacobian is the kernel phase's, bit for
    bit) and ``travel_time_jacobian_2d`` (one B6 launch); wall medians of 5
    after a warm-up."""
    pt = cx.pt
    out = {}
    calls = {
        "jacobian": (lambda: pt.travel_time_jacobian(cx.env_h, SRC_DEPTH, cx.p0_jac["bench"], 0.0,
                                                     R_MAX, pt.SolverSettings(dx=DX)),
                     {"COEF_TANGENT_LAUNCHES": 1}, (JAC_RAYS, 16)),
        "jacobian_2d": (lambda: pt.travel_time_jacobian_2d(cx.env_j2, SRC_DEPTH, cx.p0_j2, 0.0,
                                                           R_MAX, cx.s_j2),
                        {"COEF_TANGENT_RD_LAUNCHES": 1}, (JAC2["rays"], JAC2["nr"], 16)),
    }
    for name, (fn, want, shape) in calls.items():
        (T, J), _, n = counted(cx, fn)
        require_counts(name, n, **want)
        require(tuple(J.shape) == shape and bool(cx.torch.isfinite(J).all())
                and bool(cx.torch.isfinite(T).all()), f"{name}: shape {tuple(J.shape)} or "
                "non-finite values")
        if name == "jacobian":
            require(cx.torch.equal(J, b5_bench[3].T) and cx.torch.equal(T, b5_bench[0]),
                    "travel_time_jacobian differs from the kernel phase's B5 launch")
        runs = [counted(cx, fn)[1] * 1e3 for _ in range(5)]
        out[name] = {"launches": {k: v for k, v in n.items() if v}, "shape": list(J.shape),
                     "median_ms": statistics.median(runs), "runs_ms": runs}
    emit("adjoint_paths", card=cx.smi, **out)
    return out


def inversion_grid():
    """The inversion demo's depth and range grids."""
    return np.linspace(0.0, 6000.0, INV["nz"]), np.linspace(0.0, INV["r_max"], INV["nr"])


def inversion_field(cx, dc_rz):
    """The inversion demo's field: Munk plus ``dc_rz`` on its grids, 32
    Chebyshev terms, dc/dz consistent, range-dependent layout."""
    z, r = inversion_grid()
    c = np.outer(np.ones(len(r)), cx.pt.munk_ssp(z)) + dc_rz
    return cx.pt.make_env_data(c, r, z, np.full(len(r), 5500.0), r, dtype=cx.torch.float32,
                               device=cx.dev, cheb_order=INV["K"] - 1, cheb_exact_order=True,
                               force_range_dependent=True, dcdz="consistent")


def inversion_start(cx):
    """``(env0, settings, p0, c_src)``: the inversion's starting field, its
    settings and its fan's launch parameters."""
    z, r = inversion_grid()
    env0 = inversion_field(cx, 0.0)
    require(env0.range_dependent and env0.c_cheb.shape == (INV["nr"], INV["K"]),
            "the inversion's field is not a 9 x 32 range-dependent fit")
    s = cx.pt.SolverSettings(dx=INV["dx"], interp="cheb", kahan=False)
    c_src = np.interp(SRC_DEPTH, z, env0.c[0].cpu().numpy())
    p0 = (np.sin(np.radians(-np.linspace(-11.0, 11.0, INV["B"]))) / c_src).astype(np.float32)
    return env0, s, p0, c_src


def profiler_split_phase(cx):
    """Where the range-dependent launches' time goes (``split_ms``): the
    fan kernel at BASELINE config 1, B6 at bench.py's 2D Jacobian, B6 and
    the 2-save fan launch at the inversion step's shapes (on the
    inversion's starting field), and the ensemble tangent kernel at config
    4b's two shapes (``ens_shapes``, from one config 4b call; the step rows
    built once, as the call builds them), early in the run: late in a long
    run a profiling session has come back without the kernel's rows.  Sets
    ``cx.splits``."""
    from pygenray_tpu_torch.adjoint import _CoefTimes, _directions
    from pygenray_tpu_torch.integrate import _ens_step_data

    torch, st = cx.torch, cx.stepper
    h, sps, nseg = cx.plan(0.0, R_MAX, NUM_SAVE, cx.s_rd.dx)
    p0_rd = on_card(cx, launch_p0(cx.pt, cx.env_rd, np.linspace(-ANGLE_SPAN, ANGLE_SPAN,
                                                                NUM_RAYS)))
    h2, sps2, nseg2 = cx.plan(0.0, R_MAX, 2, cx.s_j2.dx)
    d2, dp2 = unit_directions(cx, cx.env_j2)
    env0, s, p0, _ = inversion_start(cx)
    op = _CoefTimes(env0, SRC_DEPTH, p0, 0.0, INV["r_max"], s)
    env_k, geo = op.env_with(env0.c_cheb), op.geo()  # the step's wrappers get the geometry
    d_inv, dp_inv = _directions(op.Dm)
    cx.splits = {
        "config1_fan": split_ms(lambda: st.trace_kernel(cx.env_rd, SRC_DEPTH, p0_rd,
                                                        (0.0, R_MAX, h, sps, nseg), cx.s_rd),
                                "trace_fan"),
        "b6_2d": split_ms(lambda: st.trace_coef_tangent_rd_kernel(
            cx.env_j2, SRC_DEPTH, cx.p0_j2, d2, dp2, (0.0, R_MAX, h2, sps2, nseg2), cx.s_j2),
            "coef_tangent"),
        "b6_inversion": split_ms(lambda: st.trace_coef_tangent_rd_kernel(
            env_k, SRC_DEPTH, op.p0, d_inv, dp_inv, op.geom, s, geo), "coef_tangent"),
        "fan_inversion": split_ms(lambda: st.trace_kernel(env_k, SRC_DEPTH, op.p0, op.geom, s,
                                                          geo), "trace_fan"),
    }
    g4 = (0.0, R_MAX, *cx.plan(0.0, R_MAX, 2, DX))
    sd4 = _ens_step_data(cx.env_mc, g4, cx.settings)
    for label, p0_4 in ens_shapes(cx, config4b_call(cx)).items():
        cx.splits[label] = split_ms(lambda p=p0_4: st.trace_tangent_ensemble_kernel(
            cx.env_mc, SRC_DEPTH, p, 1.0, g4, cx.settings, sd4), "tangent_ens")
    emit("profiler_split", card=cx.smi, **cx.splits)


def inversion_phase(cx):
    """examples/gradient_inversion_demo.py at its full parameters through
    the port: a +3 m/s warm lens at 900 m and 40 % range in a 60 km,
    9-station Munk field (32 Chebyshev terms, dc/dz consistent, range-
    dependent layout), 128 rays over ±11°, dx = 200 m, Kahan off, float32;
    150 Adam steps (lr 0.03) on 0.5 ||f(cc) - T_obs||² + 1e-10 ||cc -
    cc0||² through ``travel_times_of_coef``.  One step's launches: one fan
    launch forward, ceil(K / chunk) B6 launches backward.  The misfit must
    drop 20 times (the demo's 0.05); the held-out correlation the demo
    prints is reported.  B6 and the fan kernel are then held to their plain
    versions at the shapes a step gives them (``inversion_kernels``)."""
    torch, pt, P = cx.torch, cx.pt, INV
    from pygenray_tpu_torch.adjoint import _COEF_VJP_CHUNK_ELEMS, travel_times_of_coef

    z, r = inversion_grid()
    dc_true = (3.0 * np.exp(-(((z - 900.0) / 700.0) ** 2))[None, :]
               * np.exp(-(((r - 0.4 * P["r_max"]) / (0.18 * P["r_max"])) ** 2))[:, None])
    env_true = inversion_field(cx, dc_true)
    env0, s, p0, c_src = inversion_start(cx)
    T_obs = travel_times_of_coef(env_true, SRC_DEPTH, p0, 0.0, P["r_max"], s)(env_true.c_cheb)
    f = travel_times_of_coef(env0, SRC_DEPTH, p0, 0.0, P["r_max"], s)
    cc0 = env0.c_cheb

    def value_and_grad(cc):
        c = cc.detach().requires_grad_(True)
        d = f(c) - T_obs
        val = 0.5 * (d * d).sum() + P["lam"] * ((c - cc0) ** 2).sum()
        (g,) = torch.autograd.grad(val, c)
        return val.detach(), g

    chunks = -(-P["K"] // max(1, min(P["K"], _COEF_VJP_CHUNK_ELEMS // (P["nr"] * P["B"]))))
    _, _, n = counted(cx, lambda: value_and_grad(cc0))
    require_counts("inversion step", n, LAUNCHES=1, COEF_TANGENT_RD_LAUNCHES=chunks)
    cc, m, v = cc0.clone(), torch.zeros_like(cc0), torch.zeros_like(cc0)
    b1, b2, eps = 0.9, 0.999, 1e-12
    hist = []

    def adam():
        nonlocal cc, m, v
        for it in range(P["iters"]):
            val, g = value_and_grad(cc)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (it + 1))
            vh = v / (1 - b2 ** (it + 1))
            cc = cc - P["lr"] * mh / (torch.sqrt(vh) + eps)
            hist.append(val)

    _, wall, n = counted(cx, adam)
    hist = [float(x) for x in hist]
    kern = inversion_kernels(cx, env0, p0, cc, s)
    require_counts("inversion", n, LAUNCHES=P["iters"], COEF_TANGENT_RD_LAUNCHES=chunks * P["iters"])
    drop = hist[0] / max(hist[-1], 1e-300)
    # the demo's held-out skill: travel-time anomalies of an offset fan
    p0_val = (np.sin(np.radians(-np.linspace(-10.3, 10.3, P["B"] + 7))) / c_src).astype(np.float32)
    f_val = travel_times_of_coef(env0, SRC_DEPTH, p0_val, 0.0, P["r_max"], s)
    f_val_true = travel_times_of_coef(env_true, SRC_DEPTH, p0_val, 0.0, P["r_max"], s)
    with torch.no_grad():
        base = f_val(cc0)
        dT_pred = (f_val(cc) - base).double().cpu().numpy()
        dT_true = (f_val_true(env_true.c_cheb) - base).double().cpu().numpy()
    cor = float(np.corrcoef(dT_pred, dT_true)[0, 1])
    rms_res = float(np.sqrt(np.mean((dT_pred - dT_true) ** 2)))
    rms_sig = float(np.sqrt(np.mean(dT_true ** 2)))
    out = {"iterations": P["iters"], "misfit_first": hist[0], "misfit_last": hist[-1],
           "drop": drop, "required_drop": 1.0 / P["drop"], "heldout_corr": cor,
           "heldout_residual_rms_ms": rms_res * 1e3, "heldout_signal_rms_ms": rms_sig * 1e3,
           "launches": {k: v for k, v in n.items() if v}, "wall_s": wall,
           "ms_per_step": wall / P["iters"] * 1e3, "b6_launches_per_step": chunks, **kern}
    emit("gradient_inversion", card=cx.smi, **out)
    require(all(np.isfinite(hist)), "non-finite misfit")
    require(hist[-1] < hist[0] * P["drop"], f"the misfit dropped {drop:.3g}x, not 20x")
    return out


def inversion_kernels(cx, env0, p0, cc, s):
    """B6 and the fan kernel at the shapes an inversion step gives them (9
    stations x 32 directions x 128 rays x 300 steps; 128 rays, 2 saves), on
    the field of the inversion's last coefficients as ``travel_times_of_coef``
    builds it (dc/dz consistent, Clenshaw), with the step's own unit
    directions: each against its plain version, B6's primal against B2's on
    the same field, event times, plain times and bounds."""
    import dataclasses as dc

    from pygenray_tpu_torch.adjoint import _CoefTimes, _directions
    from pygenray_tpu_torch.integrate import _trace_coef_tangent_rd_impl

    torch, pt, st, P = cx.torch, cx.pt, cx.stepper, INV
    op = _CoefTimes(env0, SRC_DEPTH, p0, 0.0, P["r_max"], s)
    env_k, geom, geo = op.env_with(cc), op.geom, op.geo()
    require(env_k.range_dependent and not env_k.poly_ok, "the inversion's field is not the "
            "range-dependent Clenshaw fit its kernels see")
    d_inv, dp_inv = _directions(op.Dm)
    b6 = st.trace_coef_tangent_rd_kernel(env_k, SRC_DEPTH, op.p0, d_inv, dp_inv, geom, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b6_p = _trace_coef_tangent_rd_impl(env_k, SRC_DEPTH, op.p0, d_inv, dp_inv, geom, s)
    torch.cuda.synchronize()
    b6_plain_ms = (time.perf_counter() - t0) * 1e3
    b6_err = compare_coef("b6_inversion", b6, b6_p)
    coef_lockstep("b6_inversion", b6, st.trace_tangent_kernel(env_k, SRC_DEPTH, op.p0, 0.0,
                                                               geom, s))
    b6_ms = events_ms(lambda: st.trace_coef_tangent_rd_kernel(env_k, SRC_DEPTH, op.p0, d_inv,
                                                              dp_inv, geom, s, geo), n=10)
    b6_bound, b6_by = coef_bound(b6, env_k, geom[3] * geom[4])

    fan = st.trace_kernel(env_k, SRC_DEPTH, op.p0, geom, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fan_p = pt.trace(env_k, SRC_DEPTH, op.p0, 0.0, P["r_max"], 2, dc.replace(s, backend="ops"))
    torch.cuda.synchronize()
    fan_plain_ms = (time.perf_counter() - t0) * 1e3
    fan_err = compare("fan_inversion", fan, fan_p)
    fan_ms = events_ms(lambda: st.trace_kernel(env_k, SRC_DEPTH, op.p0, geom, s, geo), n=10)
    fan_bound_ms, fan_by = fan_bound(fan, env_k, geom[3])
    return {"b6_event_ms": b6_ms, "b6_kernel_ms": cx.splits["b6_inversion"]["kernel_ms"],
            "b6_split": cx.splits["b6_inversion"], "b6_plain_ms": b6_plain_ms,
            "b6_bound_ms": b6_bound, "b6_bound_by": b6_by, "b6_max_abs_err": b6_err,
            "fan_event_ms": fan_ms, "fan_kernel_ms": cx.splits["fan_inversion"]["kernel_ms"],
            "fan_split": cx.splits["fan_inversion"], "fan_plain_ms": fan_plain_ms,
            "fan_bound_ms": fan_bound_ms, "fan_bound_by": fan_by,
            "fan_max_abs_err_live": fan_err}


def random_field_phase(cx):
    """The kernels on random smooth range-dependent fields (the recipe of
    tests/test_fuzz_parity.py, tests/fixtures/random_field.py: Munk plus a
    random 8-term Chebyshev structure, a range ramp, a wavy sloped bottom),
    three seeds, float32 on the card.  On each seed's default fit: the fan
    kernel (B1c, Kahan on), the final-state and save-grid tangent kernels
    (B2, B3) and B6 bit for bit against their plain versions, B6's primal
    against B2's.  Then the fan kernel's times of the JAX test's eight
    angles against the scipy oracle (tests/reference_impl.py) over the
    field's 40 km, within the 0.1 ms budget where the bounce counts agree,
    on the field fitted at its full order (48 Chebyshev terms); the default
    fit's error is reported beside it: on seed 0 its adaptive order leaves
    the field itself 0.13 ms off the oracle in float64 (ROADMAP C9)."""
    import dataclasses as dc

    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(FIXTURES))
    import reference_impl as oracle
    from random_field import random_env, source_and_angles

    from pygenray_tpu_torch.integrate import (
        _trace_coef_tangent_rd_impl, _trace_tangent_impl, _trace_tangent_save_impl)

    torch, pt, st = cx.torch, cx.pt, cx.stepper
    t_phase = time.perf_counter()
    out = {}
    for seed in RF_SEEDS:
        rng = np.random.default_rng(seed)
        c2d, r, z, bathy = random_env(pt.munk_ssp, rng)
        z_src, angles = source_and_angles(rng)
        env = pt.make_env_data(c2d, r, z, bathy, r, dtype=torch.float32, device=cx.dev)
        s = pt.SolverSettings(dx=RF_DX)
        require(env.range_dependent and st.tangent_supported(env, s),
                f"random field {seed} is not a range-dependent field the kernels cover")
        c_src = float(pt.bilinear_np(0.0, z_src, r, z, c2d))
        p0 = on_card(cx, np.sin(np.radians(np.linspace(-RF_SPAN, RF_SPAN, RF_RAYS))) / c_src)
        z0 = on_card(cx, z_src)
        h, sps, nseg = cx.plan(0.0, RF_X1, 5, RF_DX)
        g5 = (0.0, RF_X1, h, sps, nseg)
        res_k = st.trace_kernel(env, z0, p0, g5, s)
        res_p = pt.trace(env, z0, p0, 0.0, RF_X1, 5, dc.replace(s, backend="ops"))
        compare(f"random_field_{seed}_fan", res_k, res_p)
        h2, sps2, nseg2 = cx.plan(0.0, RF_X1, 2, RF_DX)
        g2 = (0.0, RF_X1, h2, sps2, nseg2)
        out_b2 = st.trace_tangent_kernel(env, z0, p0, 1.0, g2, s)
        compare_tangent(f"random_field_{seed}_tangent", out_b2,
                        _trace_tangent_impl(env, z0, p0, 1.0, g2, s))
        compare_save_tangent(f"random_field_{seed}_save_tangent", 1.0,
                             st.trace_tangent_save_kernel(env, z0, p0, 1.0, g5, s),
                             _trace_tangent_save_impl(env, z0, p0, 1.0, g5, s))
        env_c = dc.replace(env, poly_ok=False)
        s_c = dc.replace(s, kahan=False)
        d, dp = (t[:RF_B6_DIRS] for t in unit_directions(cx, env))
        p6 = p0[:: RF_RAYS // RF_B6_RAYS]
        b6 = st.trace_coef_tangent_rd_kernel(env, z0, p6, d, dp, g2, s_c)
        compare_coef(f"random_field_{seed}_b6", b6,
                     _trace_coef_tangent_rd_impl(env_c, z0, p6, d, dp, g2, s_c))
        coef_lockstep(f"random_field_{seed}_b6", b6,
                      st.trace_tangent_kernel(env_c, z0, p6, 0.0, g2, s_c))

        # the JAX test's eight angles against the scipy oracle
        oenv = oracle.OracleEnv.from_tables(c2d, r, z, bathy, r)
        ref = [oracle.trace_ray_oracle(oenv, z_src, 0.0, float(a), float(r[-1]), 2, rtol=1e-11,
                                       atol=1e-11) for a in angles]
        p8 = on_card(cx, np.sin(np.radians(angles)) / c_src)
        errs = {}
        for fit, e in (("full_order", pt.make_env_data(c2d, r, z, bathy, r, dtype=torch.float32,
                                                       device=cx.dev, cheb_order=47,
                                                       cheb_exact_order=True)),
                       ("default", env)):
            n0 = st.LAUNCHES
            fan = pt.trace(e, z0, p8, 0.0, float(r[-1]), 2, pt.SolverSettings(dx=RF_ORACLE_DX))
            require(st.LAUNCHES == n0 + 1, "the oracle fan did not run the fan kernel")
            nb, ns = fan.n_bott.tolist(), fan.n_surf.tolist()
            t_end, alive = fan.ts[:, -1].double().tolist(), fan.alive.tolist()
            d_ms = [abs(t_end[i] - o[1][0, -1]) * 1e3 for i, o in enumerate(ref)
                    if o is not None and alive[i] and (nb[i], ns[i]) == (o[2], o[3])]
            errs[fit] = {"terms": int(e.c_cheb.shape[-1]), "compared": len(d_ms),
                         "max_travel_time_err_ms": max(d_ms, default=0.0)}
        out[seed] = {"bounces_fan": int((res_p.n_surf + res_p.n_bott).sum()),
                     "bottom_angle": env.bangle_mode, "terms": int(env.c_cheb.shape[-1]),
                     "horner": bool(env.poly_ok), "oracle": errs}
        full = errs["full_order"]
        require(full["compared"] >= 5, f"random field {seed}: {full['compared']} of 8 oracle rays "
                "comparable")
        require(full["max_travel_time_err_ms"] <= ORACLE_BUDGET_MS,
                f"random field {seed}: travel-time error {full['max_travel_time_err_ms']:.4f} ms")
    emit("random_fields", card=cx.smi, seeds=out, budget_ms=ORACLE_BUDGET_MS,
         seconds=time.perf_counter() - t_phase)


def adjoint_vs_jax_phase(cx):
    """The adjoint operators on the card against the JAX package's answers
    (``adjoint_jax_f32.npz``, ``tests/fixtures/make_adjoint_fixture.py``):
    the coefficient-tangent kernels (B5, B6) and the ``torch.func.jacfwd``
    fallback against its Pallas kernels and jacfwd, the vjp through the
    kernels, the Fermat operators (spectral and segment), the perturbation
    response and the endpoint gradients (the spectral ones on the Clenshaw
    series and on the default Horner fit); errors stated, bounds
    ``ADJ_*``."""
    import dataclasses as dc
    import importlib.util

    torch, pt = cx.torch, cx.pt
    import pygenray_tpu_torch.adjoint as adj

    spec = importlib.util.spec_from_file_location("make_adjoint_fixture",
                                                  FIXTURES / "make_adjoint_fixture.py")
    F = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(F)
    fx = np.load(ADJOINT_JAX)
    P = json.loads(str(fx["params"]))
    require(P == F.PARAMS, "the fixture was written with other parameters")
    p0, x1, zs = on_card(cx, F.launch_p0(P)), P["r_max"], P["source_depth"]
    s = pt.SolverSettings(dx=P["dx"])
    errs = {}

    def rel(name, got, want, bound_rel):
        got = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else got
        scale = float(np.abs(want).max())
        e = float(np.abs(np.asarray(got) - want).max())
        errs[name] = {"max_abs_err": e, "largest": scale, "bound": bound_rel * scale}
        require(np.shape(got) == want.shape, f"{name}: shape {np.shape(got)} vs {want.shape}")
        require(e <= bound_rel * scale, f"{name}: off the JAX package by {e:.3g} ({scale:.3g})")

    def absol(name, got, want, bound_abs):
        got = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else got
        e = float(np.abs(np.asarray(got) - want).max())
        errs[name] = {"max_abs_err": e, "bound": bound_abs}
        require(e <= bound_abs, f"{name}: off the JAX package by {e:.3g}")

    for kind in ("ri", "rd"):
        env = pt.make_env_data(*F.tables(P, pt.munk_ssp, kind == "rd"), dtype=torch.float32,
                               device=cx.dev)
        jac = adj.travel_time_jacobian_2d if kind == "rd" else adj.travel_time_jacobian
        name = "COEF_TANGENT_RD_LAUNCHES" if kind == "rd" else "COEF_TANGENT_LAUNCHES"
        (T, J), _, n = counted(cx, lambda: jac(env, zs, p0, 0.0, x1, s))
        require(n[name] == 1, f"{kind}: the Jacobian did not launch its kernel")
        (Tf, Jf), fwd_s, _ = counted(cx, lambda: jac(env, zs, p0, 0.0, x1, s, mode="fwd"))
        errs[f"{kind}_fwd_seconds"] = fwd_s
        for ref in ("kernel", "fwd"):
            absol(f"{kind}_kernel_T_vs_{ref}", T, fx[f"{kind}/{ref}/T"], ADJ_T_S)
            rel(f"{kind}_kernel_J_vs_{ref}", J, fx[f"{kind}/{ref}/J"], ADJ_J_REL[kind])
            rel(f"{kind}_torch_func_fwd_J_vs_{ref}", Jf, fx[f"{kind}/{ref}/J"], ADJ_J_REL[kind])
        absol(f"{kind}_torch_func_fwd_T", Tf, fx[f"{kind}/fwd/T"], ADJ_T_S)
        (Tv, g), _, n = counted(cx, lambda: adj.travel_time_coef_vjp(
            env, zs, p0, 0.0, x1, np.asarray(P["v"], np.float32), s))
        require(n[name] >= 1 and n["LAUNCHES"] == 1, f"{kind}: the vjp launched {n}")
        absol(f"vjp_{kind}_T", Tv, fx[f"vjp_{kind}/T"], ADJ_T_S)
        rel(f"vjp_{kind}_g", g, fx[f"vjp_{kind}/g"], ADJ_J_REL["vjp"])
        # the Fermat and endpoint traces on the Clenshaw series, as the
        # Jacobians, within the JAX tests' bounds
        env_c = dc.replace(env, poly_ok=False)
        Tq, G = adj.fermat_jacobian(env_c, zs, p0, 0.0, x1, s, num_save=P["fermat_saves"])
        absol(f"fermat_{kind}_T", Tq, fx[f"fermat_{kind}/T"], ADJ_T_S)
        rel(f"fermat_{kind}_G", G, fx[f"fermat_{kind}/G"], ADJ_J_REL["fermat"])
        if kind == "ri":
            dT = adj.perturbation_response(G, env_c, F.perturbation(P, env.z.cpu().numpy()))
            rel("perturbation_response", dT, fx["pert/dT"], ADJ_J_REL["fermat"])
        else:
            Te, d_src, d_rcv = adj.endpoint_time_gradients(env_c, zs, p0, 0.0, x1, s)
            absol("endpoint_T", Te, fx["endpoint/T"], ADJ_T_S)
            absol("endpoint_dT_dz_src", d_src, fx["endpoint/dT_dz_src"], ADJ_GRAD)
            absol("endpoint_dT_dz_rcv", d_rcv, fx["endpoint/dT_dz_rcv"], ADJ_GRAD)
        # the same on the default fit, at the bounds its float32 gap reads
        require(env.poly_ok, f"{kind}: the default fit is not the Horner variant")
        Tq, G = adj.fermat_jacobian(env, zs, p0, 0.0, x1, s, num_save=P["fermat_saves"])
        absol(f"fermat_{kind}_horner_T", Tq, fx[f"fermat_{kind}_horner/T"], ADJ_HORNER["T"])
        rel(f"fermat_{kind}_horner_G", G, fx[f"fermat_{kind}_horner/G"], ADJ_HORNER["G"])
        if kind == "ri":
            dT = adj.perturbation_response(G, env, F.perturbation(P, env.z.cpu().numpy()))
            rel("perturbation_response_horner", dT, fx["pert_horner/dT"], ADJ_J_REL["fermat"])
        else:
            Te, d_src, d_rcv = adj.endpoint_time_gradients(env, zs, p0, 0.0, x1, s)
            absol("endpoint_horner_T", Te, fx["endpoint_horner/T"], ADJ_HORNER["T"])
            absol("endpoint_horner_dT_dz_src", d_src, fx["endpoint_horner/dT_dz_src"],
                  ADJ_HORNER["grad"])
            absol("endpoint_horner_dT_dz_rcv", d_rcv, fx["endpoint_horner/dT_dz_rcv"],
                  ADJ_HORNER["grad"])
    S = P["seg"]
    env_s = pt.make_env_data(*F.rough_tables(P, pt.munk_ssp), interp="seg", dtype=torch.float32,
                             device=cx.dev)
    require(env_s.has_seg and not env_s.has_cheb, "the rough field did not take the segment fit")
    p0s = on_card(cx, np.sin(np.radians(-np.asarray(S["fan"]))) / P["c_src"])
    Tq, G = adj.fermat_jacobian(env_s, zs, p0s, 0.0, x1, pt.SolverSettings(dx=S["dx"], interp="seg"),
                                num_save=P["fermat_saves"])
    absol("fermat_seg_T", Tq, fx["fermat_seg/T"], ADJ_T_S)
    rel("fermat_seg_G", G, fx["fermat_seg/G"], ADJ_J_REL["fermat_seg"])
    emit("adjoint_vs_jax", **errs)
    return errs


def build_context(torch, pt, dev):
    """The environments, fans and settings the kernel comparisons share."""
    from pygenray_tpu_torch.integrate import _plan

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
    eq_angles = np.linspace(-18.0, 18.0, N_EQ)
    # steep fan, vertical rays (death code 1), backwards reflections (code
    # 3) and a source below the domain (code 2), as in the CPU tests
    death_angles = np.concatenate([np.linspace(-60.0, 60.0, N_EQ - 4),
                                   [-90.0, -89.999, 89.999, 0.0]])
    z0_death = np.full(N_EQ, SRC_DEPTH)
    z0_death[-1] = 6500.0
    env_rd = rd_env(torch, pt, dev)
    require(env_rd.range_dependent, "config 1 env is not range-dependent")
    s_rd = pt.SolverSettings(dx=100.0)  # bench.py's config 1 step
    # the tangent kernels' fans: phase 3's plus BASELINE config 1's field
    tan_cases = (
        ("horner", env_h, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("clenshaw", env_c, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("horner_curved_bottom", env_b, eq_angles, SRC_DEPTH, R_MAX, settings),
        ("seamount_deaths", env_s, death_angles, z0_death, 20e3, settings),
        ("range_dependent_config1", env_rd, eq_angles, SRC_DEPTH, R_MAX, s_rd),
    )
    return types.SimpleNamespace(
        torch=torch, pt=pt, dev=dev, plan=_plan, settings=settings, env_h=env_h, env_c=env_c,
        env_b=env_b, env_s=env_s, env_rd=env_rd, s_rd=s_rd, eq_angles=eq_angles,
        death_angles=death_angles, z0_death=z0_death, tan_cases=tan_cases)


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
    phase_done("1-2 card and build")

    # ---- phase 3: kernel vs plain on the card -----------------------------
    cx = build_context(torch, pt, dev)
    cx.stepper, cx.smi = stepper, smi
    adjoint_context(cx)
    mc_context(cx)
    phase_done("contexts and Monte-Carlo ensembles")
    profiler_split_phase(cx)
    phase_done("profiler_split")
    settings, env_h, env_c, env_b, env_s = cx.settings, cx.env_h, cx.env_c, cx.env_b, cx.env_s
    eq_angles, death_angles, z0_death = cx.eq_angles, cx.death_angles, cx.z0_death
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
        if name in TAN_SHORT:
            x1 = CMP_X1
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
    phase_done("3 fan kernel vs plain")

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

    phase_done("4 main path")

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

    phase_done("5 headline times")

    # ---- phase 6: the tangent kernel vs its plain version ------------------
    # final state only, on the eigenray solver's plan (2 saves); the same
    # fans as phase 3 plus BASELINE config 1's range-dependent field
    env_rd, s_rd, tan_cases = cx.env_rd, cx.s_rd, cx.tan_cases
    require(stepper.tangent_supported(env_rd, settings),
            "config 1 env is not covered by the tangent kernels")
    tan_errs, tan_plain_ms = [], {}
    for name, env, ang, z0, x1, s in tan_cases:
        if name in TAN_SHORT:
            x1 = CMP_X1
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

    phase_done("6 tangent kernel vs plain")

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

    phase_done("7 config 1")

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

    phase_done("8 eigenrays")

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
    rd_split = cx.splits["config1_fan"]
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
                      "kernel_ms": rd_split["kernel_ms"],
                      "plain_ms": rd_plain_s * 1e3, "bound_ms": rd_bound_ms,
                      "bound_by": rd_bound_by},
         eigenray_latency=latency)

    phase_done("9 times")

    # ---- phases 10-15: the save-grid tangent kernel and the receiver side ----
    sv_err, sv_plain_8192_ms = save_tangent_phase(cx)
    phase_done("10 save-grid tangent vs plain")
    autograd_phase(cx)
    phase_done("11 autograd")
    rcv = receiver_paths_phase(cx)
    phase_done("12 receiver paths")
    receiver_physics_phase(cx)
    receiver_vs_jax_phase(cx)
    phase_done("13-14 receiver physics and vs JAX")
    sv, sv_err_full = save_tangent_times_phase(cx, rcv, sv_plain_8192_ms)
    sv_err = {f: max(e, sv_err_full[f]) for f, e in sv_err.items()}
    phase_done("15 save-grid tangent times")

    # ---- phases 16-21: Monte Carlo --------------------------------------------
    seg_err, seg_row = seg_kernel_phase(cx)
    phase_done("17 segment mode vs plain")
    mc_paths, mc = mc_paths_phase(cx)
    phase_done("18 Monte-Carlo paths")
    ens_err, ens_rows = ens_tangent_phase(cx, mc)
    phase_done("19 ensemble tangent vs plain")
    mc_vs_jax_phase(cx)
    emit("times_mc", card=smi, segment_rough=seg_row, **ens_rows)
    phase_done("20-21 Monte Carlo vs JAX")

    # ---- phases 22-26: the adjoint operators ---------------------------------
    coef_err, coef_times, b5_bench = coef_tangent_phase(cx)
    phase_done("22 coefficient tangents vs plain")
    adj_paths = adjoint_paths_phase(cx, b5_bench)
    phase_done("23 Jacobians")
    inv = inversion_phase(cx)
    phase_done("24-25 inversion")
    adjoint_vs_jax_phase(cx)
    phase_done("26 adjoint vs JAX")

    # ---- phase 27: random fields ----------------------------------------------
    random_field_phase(cx)
    phase_done("27 random fields")

    err = worst(errs_all)
    launches_tan = eig["timefront"][1][1]
    emit("phase_seconds", seconds=PHASE_S, total_s=round(time.perf_counter() - T_START, 2))
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
        "kernel_ms_config1": rd_split["kernel_ms"],  # torch.profiler's kernel row
        "plain_ms_config1": rd_plain_s * 1e3,
        "bound_ms_config1": rd_bound_ms,
        "launches_inversion": inv["launches"]["LAUNCHES"],  # one a step, forward
        "max_abs_err_inversion": inv["fan_max_abs_err_live"]["ts"],
        "ms_inversion": inv["fan_event_ms"],
        "kernel_ms_inversion": inv["fan_kernel_ms"],
        "plain_ms_inversion": inv["fan_plain_ms"],
        "bound_ms_inversion": inv["fan_bound_ms"],
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
    }, {
        "name": "trace_tangent_save_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_tangent_save.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:1194",
        "launches": rcv.launches_main,  # the headline fan's arrival_amplitudes
        "max_abs_err": sv_err["ts"],  # travel time [s]; the rest below
        "max_abs_err_zs": sv_err["zs"],
        "max_abs_err_dT": sv_err["dT"],
        "max_abs_err_dz": sv_err["dz"],
        "max_abs_err_dp": sv_err["dp"],
        "ms": sv["headline"]["kernel_event_ms"],
        "plain_ms": sv["headline"]["plain_ms"],
        "bound_ms": sv["headline"]["bound_ms"],
        "bound_by": sv["headline"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a ray tangent
        "ms_fan8192": sv["fan8192"]["kernel_event_ms"],
        "plain_ms_fan8192": sv["fan8192"]["plain_ms"],  # compared over about SAVE_FANS_X1
        "plain_range_m_fan8192": cut_plan(R_MAX, NUM_SAVE, DX, SAVE_FANS_X1)[0][1],
        "bound_ms_fan8192": sv["fan8192"]["bound_ms"],
        "ms_tl_demo": sv["tl_demo"]["kernel_event_ms"],
        # the TL demo's and the array response's plain comparisons run at
        # every ray over about CMP_X1 (compared_at_*)
        "plain_ms_tl_demo": sv["tl_demo"]["plain_ms"],
        "compared_at_tl_demo": sv["tl_demo"]["compared_at"],
        "bound_ms_tl_demo": sv["tl_demo"]["bound_ms"],
        "ms_array_response_eigenrays": sv["array_response_eigenrays"]["kernel_event_ms"],
        "plain_ms_array_response_eigenrays": sv["array_response_eigenrays"]["plain_ms"],
        "compared_at_array_response_eigenrays": sv["array_response_eigenrays"]["compared_at"],
        "bound_ms_array_response_eigenrays": sv["array_response_eigenrays"]["bound_ms"],
    }, {
        # the fan kernel's segment mode at the rough trace_ensemble's shape
        "name": "trace_fan_f32_segment",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_fan.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:254",
        "launches": mc_paths["rough"]["launches"]["segment_mode"],  # the rough trace_ensemble
        "max_abs_err": seg_err["ts"],  # travel time [s]; zs [m] and ps [s/m] below
        "max_abs_err_zs": seg_err["zs"],
        "max_abs_err_ps": seg_err["ps"],
        "ms": seg_row["kernel_event_ms"],
        "plain_ms": seg_row["plain_ms"],
        "bound_ms": seg_row["bound_ms"],
        "bound_by": seg_row["bound_by"],
        "library_ms": None,  # no single PyTorch call traces a ray fan
        "shape": f"{seg_row['rays']} rays x {seg_row['steps']} steps",
        "layout": seg_row["layout"],  # where the step tables went (stepper.seg_layout)
    }, {
        # ms and bound at config 4b's Newton batch (the fan's below); the
        # plain version once over both shapes' candidates
        "name": "trace_tangent_ens_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_tangent_ens.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:1258",
        "launches": mc_paths["config4b"]["launches"]["trace_tangent_ens_f32"],  # mc_eigenray_times
        "max_abs_err": ens_err["T"],  # travel time [s]; the rest below
        "max_abs_err_z": ens_err["z"],
        "max_abs_err_dT": ens_err["dT"],
        "max_abs_err_dz": ens_err["dz"],
        "max_abs_err_dp": ens_err["dp"],
        "ms": ens_rows["config4b_newton"]["kernel_event_ms"],
        "plain_ms": ens_rows["plain_both"]["plain_ms"],
        "bound_ms": ens_rows["config4b_newton"]["bound_ms"],
        "bound_by": ens_rows["config4b_newton"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a ray tangent
        "shape": f"{MC_E} x {ens_rows['config4b_newton']['candidates']} candidates x "
                 f"{ens_rows['config4b_newton']['steps']} steps",
        "plain_shape": f"{MC_E} x {ens_rows['plain_both']['candidates']} candidates x "
                       f"{ens_rows['plain_both']['steps']} steps",
        "kernel_ms": cx.splits["config4b_newton"]["kernel_ms"],  # torch.profiler's kernel row
        "ms_fan": ens_rows["config4b_fan"]["kernel_event_ms"],
        "kernel_ms_fan": cx.splits["config4b_fan"]["kernel_ms"],
        "bound_ms_fan": ens_rows["config4b_fan"]["bound_ms"],
        "bound_by_fan": ens_rows["config4b_fan"]["bound_by"],
        "layout": "a lane pair a ray",  # csrc/trace_tangent_ens.cu
        # K fixed or at run time and the rows' copy width at the main path's
        # K (stepper.ens_layout)
        "k_layout": list(ens_rows["k_layout"]),
        "compared_k": [int(cx.env_mc.c_cheb.shape[-1]), *ENS_OTHER_K],
    }, {
        # bench.py's spectral Jacobian: 512 rays x 16 directions x 500 steps;
        # the plain version once over that fan and the ±30° one
        "name": "trace_coef_tangent_f32",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_coef_tangent.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:1366",
        "launches": adj_paths["jacobian"]["launches"]["COEF_TANGENT_LAUNCHES"],
        "max_abs_err": coef_err["b5"]["dT"],  # the Jacobian [s per unit coefficient]; T below
        "max_abs_err_T": coef_err["b5"]["T"],
        "max_abs_err_dz": coef_err["b5"]["dz"],
        "ms": coef_times["b5"]["kernel_event_ms"],
        "plain_ms": coef_times["b5"]["plain_ms_both_fans"],
        "bound_ms": coef_times["b5"]["bound_ms"],
        "bound_by": coef_times["b5"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a ray tangent
        "shape": f"{JAC_RAYS} rays x 16 directions x {coef_times['b5']['steps']} steps",
        "plain_shape": f"{2 * JAC_RAYS} rays x 16 directions",
        "wall_ms_travel_time_jacobian": adj_paths["jacobian"]["median_ms"],
    }, {
        # trace_coef_tangent_f32's range-dependent kernel (B6) at bench.py's
        # 2D Jacobian: 64 rays x 16 directions x 32 stations x 1,000 steps;
        # launches: one per travel_time_jacobian_2d, and one per step of the
        # inversion, whose shape (9 x 32 x 128 x 300 steps) the *_inversion
        # keys give
        "name": "trace_coef_tangent_f32_rd",
        "route": "cuda",
        "source": "pygenray_tpu_torch/csrc/trace_coef_tangent.cu",
        "replaces": "pygenray_tpu/ops/pallas_stepper.py:1619",
        "launches": adj_paths["jacobian_2d"]["launches"]["COEF_TANGENT_RD_LAUNCHES"],
        "launches_inversion": inv["launches"]["COEF_TANGENT_RD_LAUNCHES"],
        "max_abs_err": coef_err["b6"]["dT"],
        "max_abs_err_T": coef_err["b6"]["T"],
        "max_abs_err_dz": coef_err["b6"]["dz"],
        "ms": coef_times["b6"]["kernel_event_ms"],
        "kernel_ms": coef_times["b6"]["kernel_ms"],
        "plain_ms": coef_times["b6"]["plain_ms"],
        "bound_ms": coef_times["b6"]["bound_ms"],
        "bound_by": coef_times["b6"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a ray tangent
        "shape": f"{JAC2['rays']} rays x 16 directions x {JAC2['nr']} stations x "
                 f"{coef_times['b6']['steps']} steps",
        "wall_ms_travel_time_jacobian_2d": adj_paths["jacobian_2d"]["median_ms"],
        "inversion_ms_per_step": inv["ms_per_step"],
        "max_abs_err_inversion": inv["b6_max_abs_err"]["dT"],
        "ms_inversion": inv["b6_event_ms"],
        "kernel_ms_inversion": inv["b6_kernel_ms"],
        "plain_ms_inversion": inv["b6_plain_ms"],
        "bound_ms_inversion": inv["b6_bound_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def split_ms(fn, kernel, n=10):
    """Where a launch's time goes: ``kernel_ms``, the kernel's own device
    time from ``torch.profiler``'s rows (those whose name holds ``kernel``)
    over ``n`` back-to-back calls, through the port's
    ``utils.profiling.device_trace`` (its Chrome trace goes to
    ``pygenray_tpu_torch/_build/traces/``); ``other_device_ms``, every other
    device row of that window (the wrapper's torch operations); ``event_ms``,
    the CUDA-event time of ``n`` back-to-back calls (``events_ms``);
    ``host_ms``, the wrapper's host time, the median of ``n`` calls, each on
    an idle card.  All per launch."""
    import torch

    from pygenray_tpu_torch.utils.profiling import device_trace

    event = events_ms(fn, n=n)
    torch.cuda.synchronize()
    # late in a long run a profiling session on the H100's machine has
    # come back without the kernel's rows (``profiler_split_phase`` runs
    # early): up to three sessions
    for sessions in range(1, 4):
        with device_trace(str(ROOT / "pygenray_tpu_torch" / "_build" / "traces" / kernel)) as prof:
            for _ in range(n):
                fn()
        mine = other = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0)
            if t and kernel in e.key:
                mine += t
            elif t:
                other += t
        if mine > 0:
            break
    host = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    require(mine > 0, f"the profiler saw no device time of {kernel} in {sessions} sessions")
    return {"kernel_ms": mine / n / 1e3, "other_device_ms": other / n / 1e3, "event_ms": event,
            "host_ms": statistics.median(host), "profiler_sessions": sessions}


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
