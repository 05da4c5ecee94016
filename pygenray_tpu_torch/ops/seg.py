# Copied from pygenray_tpu/ops/seg.py (host-only numpy); tests pin it equal to the original.
"""Piecewise-segment spectral profiles — the TPU fast path for ROUGH fields.

The global Chebyshev representation (``ops.cheb``) covers smooth profiles;
fields with fine vertical structure (measured/perturbed profiles, the
Monte-Carlo tomography use case) fail its fit guard and used to fall back
to exact table interpolation — gather-bound, ~50x slower on TPU and
chip-faulting above ~131k vmapped rays (reference semantics:
`pygenray/integration_processes.py:101-174`).

This module fits each profile column with an independent low-order
polynomial per depth SEGMENT: the domain [z0, z1] is split into
``SEG_S = 128`` uniform segments — exactly one TPU vector lane per segment
— so the coefficient table of one station is a (K, 128) tile and the
in-kernel evaluation is pure lane arithmetic:

    seg  = floor((z - z0) / h_seg)             (per-lane integer)
    u    = local coordinate in [-1, 1]
    c(z) = Horner_k( coef[k][seg], u )         (K lane-gathers + K fmas)

The per-lane coefficient pick uses Mosaic's single-tile ``take_along_axis``
(dynamic_gather) — measured at the same throughput as the scalar-broadcast
Horner of the global spectral path, so rough fields trace at full kernel
speed.  Effective vertical resolution is 128 x K.

Fits are per-segment least squares against the table's piecewise-LINEAR
interpolant (what the reference actually integrates through), sampled at
dense local Chebyshev nodes PLUS the segment's own table grid points —
including the kink locations in the sample set is what lets high orders
keep converging on tables rough at their own grid scale.  Acceptance is
gated on the travel-time-relevant error: the residual's MEAN over each
table grid interval (what accumulates into travel times along a ray) must
meet the same tolerance as the global spectral guard, while the pointwise
oscillatory part — the unavoidable within-interval difference between any
smooth interpolant and the piecewise-linear one, which cancels along a ray
crossing many intervals — gets a looser cap.  An end-to-end rough-field
parity test against the f64 table path pins the resulting travel-time
agreement.

Data-adequacy limit: a continuous field passes the gates when the table
samples its finest vertical structure at >= ~4 points per wavelength
(measured threshold).  Below that, the table's own piecewise-linear
interpolant systematically misrepresents the structure at amplitudes the
window-mean gate (correctly) refuses — those tables keep the exact-table
gather path, which is the only representation faithful to such data.

Two coefficient BASES, escalated in order (``envdata.SEG_ORDER_LADDER`` /
``SEG_CHEB_LADDER``):
- ``"pow"``: local monomials (1 fma/term on device).  f32-catastrophic
  above K≈24 (2^k coefficient growth), so only the low rungs use it.
- ``"cheb"``: local Chebyshev evaluated by Clenshaw (2 ops/term) — stable
  at any order; K up to 96 recovers fields with multi-m/s structure at the
  table's own grid scale that no monomial rung can hold.
The audit evaluates exactly like the device (f32 Horner/Clenshaw on f32
coefficients), so acceptance covers device conditioning too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SEG_S", "fit_profile_seg", "seg_eval_np", "seg_derivative"]

SEG_S = 128  # depth segments per profile == TPU lane count


def _local_nodes(n: int) -> np.ndarray:
    """Dense local sample pattern in [0, 1]: Chebyshev points plus the
    endpoints (shared by every segment; each segment appends its own table
    grid points on top)."""
    k = np.arange(n)
    cheb = 0.5 * (1.0 - np.cos(np.pi * (k + 0.5) / n))
    return np.unique(np.concatenate([cheb, [0.0, 1.0]]))


def fit_profile_seg(c, z, order: int, n_audit: int = 24, basis: str = "pow"):
    """Per-segment polynomial fit of every range-station column of c(r, z).

    Parameters
    ----------
    c : (nr, nz) table (sound speed or dc/dz)
    z : (nz,) increasing depth grid
    order : per-segment polynomial order (K - 1)
    n_audit : uniform audit points per segment for the residual
    basis : "pow" (local monomial, Horner on device) or "cheb" (local
        Chebyshev, Clenshaw on device — stable at high order)

    Returns
    -------
    coef : (nr, K, SEG_S) float64 — coefficients in the chosen basis of
        the local coordinate u in [-1, 1] of each segment (lane = segment)
    mean_resid : worst magnitude of the residual averaged over any table
        grid interval — the systematic component that accumulates into
        travel times (gate this against the spectral-fit tolerance)
    max_resid : worst pointwise residual on the audit grid — the
        oscillatory component (cancels along rays; gate loosely).  Both
        residuals use the f32 device evaluation, so acceptance covers
        evaluation conditioning, not just the f64 fit.
    """
    import numpy.polynomial.chebyshev as ncheb

    c = np.atleast_2d(np.asarray(c, np.float64))
    z = np.asarray(z, np.float64)
    nr, nz = c.shape
    K = order + 1
    zlo, zhi = z[0], z[-1]
    h_seg = (zhi - zlo) / SEG_S

    tloc = _local_nodes(max(3 * K, 16))  # (nd,) in [0, 1]
    cheb_coef = np.empty((nr, K, SEG_S))
    for s in range(SEG_S):
        lo = zlo + s * h_seg
        # the segment's own table grid points join the sample set: kink
        # locations must be sampled for the least squares to keep
        # converging on tables rough at their own grid scale
        in_seg = z[(z >= lo - 1e-9 * h_seg) & (z <= lo + h_seg * (1 + 1e-9))]
        tq = np.concatenate([tloc, (in_seg - lo) / h_seg])
        A = ncheb.chebvander(2.0 * tq - 1.0, K - 1)  # (nq, K)
        zq = lo + h_seg * tq
        ys = np.empty((nr, tq.shape[0]))
        for i in range(nr):
            ys[i] = np.interp(zq, z, c[i])
        cheb_coef[:, :, s] = np.linalg.lstsq(A, ys.T, rcond=None)[0].T

    if basis == "pow":
        M = _cheb2poly_matrix(K)  # poly = M @ cheb
        coef = np.einsum("jk,rks->rjs", M, cheb_coef)
    elif basis == "cheb":
        coef = cheb_coef
    else:
        raise ValueError(f"unknown segment basis {basis!r}")

    # audit on a dense uniform grid, evaluated exactly the way the device
    # will: f32 Horner/Clenshaw on f32 coefficients
    ta = (np.arange(SEG_S * n_audit) + 0.5) / (n_audit * SEG_S)  # in (0,1)
    za = zlo + (zhi - zlo) * ta
    ref = np.empty((nr, za.shape[0]))
    for i in range(nr):
        ref[i] = np.interp(za, z, c[i])
    got32 = seg_eval_np(coef.astype(np.float32), za.astype(np.float32),
                        zlo, zhi, np.float32, basis=basis)
    resid = got32.astype(np.float64) - ref  # (nr, nq)
    max_resid = float(np.max(np.abs(resid)))

    # segment-window mean residual: what a ray crossing (or lingering in)
    # a ~h_seg depth window accumulates into its travel time.  The
    # sub-window oscillatory part — any smooth interpolant vs the
    # piecewise-linear one — cancels along rays and is gated only by
    # max_resid.
    mean_resid = float(
        np.max(np.abs(resid.reshape(nr, SEG_S, n_audit).mean(axis=2)))
    )
    return coef, mean_resid, max_resid


def seg_derivative(coef, zlo, zhi, basis: str = "pow"):
    """d/dz of a per-segment fit, in the same basis and the same
    ``(..., K, S)`` shape (top coefficient row zero).

    The local coordinate u spans [-1, 1] over one segment of width
    (zhi - zlo)/S, so du/dz = 2 S / (zhi - zlo); differentiating each
    segment's series and rescaling gives the exact derivative of the
    evaluated field — the Hamiltonian-consistent dc/dz for
    ``make_env_data(..., dcdz="consistent")`` on segment-backed fields.
    """
    import numpy.polynomial.chebyshev as ncheb
    import numpy.polynomial.polynomial as npoly

    coef = np.asarray(coef, np.float64)
    K, S = coef.shape[-2], coef.shape[-1]
    out = np.zeros_like(coef)
    if K > 1:
        scl = 2.0 * S / (zhi - zlo)
        der = ncheb.chebder if basis == "cheb" else npoly.polyder
        out[..., : K - 1, :] = der(coef, scl=scl, axis=-2)
    return out


def _cheb2poly_matrix(K: int) -> np.ndarray:
    import numpy.polynomial.chebyshev as ncheb

    M = np.zeros((K, K))
    for k in range(K):
        e = np.zeros(K)
        e[k] = 1.0
        p = ncheb.cheb2poly(e)
        M[: len(p), k] = p
    return M


def seg_coords_np(zq, zlo, zhi, S, dtype=np.float64):
    """(segment index, local u) of depths ``zq`` — the device arithmetic."""
    zq = np.asarray(zq, dtype)
    hinv = dtype(S / (zhi - zlo))
    t = np.clip((zq - dtype(zlo)) * hinv, dtype(0.0), dtype(S))
    segf = np.minimum(np.floor(t), dtype(S - 1))
    u = dtype(2.0) * (t - segf) - dtype(1.0)
    return segf.astype(np.int32), u


def seg_eval_np(coef, zq, zlo, zhi, dtype=np.float64, basis: str = "pow"):
    """Host evaluation of a segment fit — mirrors the device arithmetic
    (clamped segment pick, local-u Horner or Clenshaw).  ``coef`` is
    (..., K, S)."""
    coef = np.asarray(coef, dtype)
    S = coef.shape[-1]
    K = coef.shape[-2]
    seg, u = seg_coords_np(zq, zlo, zhi, S, dtype)
    if basis == "pow":
        acc = coef[..., K - 1, :][..., seg].astype(dtype)
        for k in range(K - 2, -1, -1):
            acc = acc * u + coef[..., k, :][..., seg]
        return acc
    b1 = np.zeros(coef.shape[:-2] + u.shape, dtype)
    b2 = np.zeros_like(b1)
    for k in range(K - 1, 0, -1):
        b1, b2 = coef[..., k, :][..., seg] + dtype(2.0) * u * b1 - b2, b1
    return coef[..., 0, :][..., seg] + u * b1 - b2
