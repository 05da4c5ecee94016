# Copied from pygenray_tpu/rootfind.py; the array module is numpy or torch.
"""The one safeguarded root-finding update shared by the eigenray solvers.

``find_eigenrays`` (the solver loop on the environment's device AND the
verbose host loop) iterates the same bracket-maintenance + safeguarded-Newton
update on a batch of (angle, bracket) candidates.  It lives here exactly
once, written against an array-module parameter ``xp`` (numpy for the host
loop, torch for the device loop — identical expressions either way), so
the two paths cannot drift apart.

Reference algorithm: regula falsi per bracket
(the reference ``pygenray``'s ``eigenrays.py:206-268``); the Newton variant
adds an exact-derivative step safeguarded by the bracket (falls back to the
false-position candidate whenever Newton leaves it).
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["rootfind_update"]


def rootfind_update(
    xp,
    theta,
    th1,
    th2,
    z1,
    z2,
    conv,
    dead,
    th_hit,
    z_end,
    alive,
    dz_dth,
    rd,
    ztol,
    use_newton: bool,
):
    """One iteration of the batched eigenray root-finder.

    Inputs are the candidate state BEFORE the update (all broadcastable
    arrays or tensors in user depth/angle conventions): current angles
    ``theta``, bracket angles/final-depths ``th1/th2/z1/z2``,
    converged/dead masks, recorded hit angles ``th_hit``; and this
    iteration's shot results: final depth ``z_end`` (user convention,
    NaN/garbage on dead lanes), aliveness, and (when ``use_newton``) the
    exact derivative ``dz_dth = d z_end / d theta``.  With ``xp`` torch,
    every tensor shares one dtype and device.

    Returns ``(theta, th1, th2, z1, z2, conv, dead, th_hit, act, hit)``:
    the updated state plus this iteration's active-and-alive and
    newly-converged masks (for iteration/residual bookkeeping).
    """
    active = ~(conv | dead)
    dead = dead | (active & ~alive)
    act = active & alive
    hit = act & (xp.abs(z_end + rd) < ztol)
    conv = conv | hit
    th_hit = xp.where(hit, theta, th_hit)

    upd = act & ~hit
    side1 = xp.sign(z_end + rd) == xp.sign(z1 + rd)
    z1 = xp.where(upd & side1, z_end, z1)
    th1 = xp.where(upd & side1, theta, th1)
    z2 = xp.where(upd & ~side1, z_end, z2)
    th2 = xp.where(upd & ~side1, theta, th2)
    denom = xp.where(xp.abs(z2 - z1) > 0, z2 - z1, 1.0)
    th_fp = th1 - (z1 + rd) * (th2 - th1) / denom
    if use_newton:
        # numpy warns on the masked-lane 0/0s that torch silently NaNs;
        # the `bad` filter discards them identically in both backends
        ctx = (
            np.errstate(divide="ignore", invalid="ignore")
            if xp is np
            else contextlib.nullcontext()
        )
        with ctx:
            th_nw = theta - (z_end + rd) / dz_dth
        lo = xp.minimum(th1, th2)
        hi = xp.maximum(th1, th2)
        bad = ~xp.isfinite(th_nw) | (th_nw <= lo) | (th_nw >= hi)
        th_new = xp.where(bad, th_fp, th_nw)
    else:
        th_new = th_fp
    theta = xp.where(upd, th_new, theta)
    return theta, th1, th2, z1, z2, conv, dead, th_hit, act, hit
