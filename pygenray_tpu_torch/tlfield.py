"""Transmission-loss fields over the (range, depth) plane.

Counterpart of ``pygenray_tpu/tlfield.py``.  The reference package
(pygenray) carries arrival kinematics only and has no
field/transmission-loss product; this module extends the amplitude layer
(`amplitudes.py`) from per-arrival factors to the classic ray-model
TL(r, z) map.  One traced fan with a forward tangent (the same single
save-grid tangent kernel launch `arrival_amplitudes` uses) yields depth, slowness, time, and the spreading Jacobian dz/dtheta0
at EVERY save column; the field estimators then run on the host over the
(B, S) save grids.

Two estimators (both standard ray-acoustics constructions, e.g. Jensen,
Kuperman, Porter & Schmidt, *Computational Ocean Acoustics* ch. 3.5–3.6):

- **Incoherent** (flux method): the eigenray sum of |A|^2 at a cell is
  estimated by depositing, for each fan ray crossing the cell's range
  column, ``dtheta * c cos(theta0) / (c_src R cos(theta_r)) / dz_bin``.
  The spreading Jacobian cancels analytically between the per-eigenray
  intensity ``A^2 = c cos0 / (c_src R |dz/dtheta0| cos_r)`` and the local
  fan-ray density ``dz_bin / (|dz/dtheta0| dtheta)`` — so the estimator
  is finite at caustics and needs no beam bookkeeping.  It reduces
  exactly to spherical spreading ``1/s^2`` in an unbounded isovelocity
  medium (pinned by a unit test).

- **Coherent** (geometric hat beams, the Bellhop construction): each fan
  ray carries a complex pressure ``A * exp(i(w t + pi n_surf - pi/2
  KMAH))`` and deposits it over a triangular hat of half-width
  ``|dz/dtheta0| * dtheta`` (floored at one depth bin) centred on the
  ray's depth.  Adjacent rays' hats tile unity across an eigenray, so
  the binned sum converges to the eigenray sum as the fan refines.
  Per-column bounce counts are not stored by the engine (only totals),
  so each sign flip of the spreading Jacobian along the save grid is
  classified on the host: a flip whose save interval approaches the
  surface (resp. bathymetry) within the ray's own local vertical
  excursion is a boundary fold (surface flips add pi; bottom folds are
  lossless and phase-free, matching `amplitudes.py`); all other flips
  are caustics (KMAH, -pi/2 each).  The classification is exact when
  save intervals separate events — use a few hundred columns.

Conventions: user convention throughout (depths positive down in the
returned grids, launch angles in degrees positive up).  Dead rays stop
contributing at their death column (``alive_save``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .amplitudes import _host, fan_with_angle_tangent
from .envdata import host_profile_tables
from .ops.host import bilinear_np, linear_np
from .shoot import _resolve_env, settings_for

__all__ = ["TLField", "transmission_loss_field"]


@dataclasses.dataclass(frozen=True)
class TLField:
    """Transmission loss re 1 m on a (depth, range) grid.

    ``tl_incoherent`` is always present; ``tl_coherent`` requires a
    ``frequency`` at construction.  Cells no fan ray crossed are NaN.
    """

    ranges: np.ndarray          # (nr,) m, strictly > source_range
    depths: np.ndarray          # (nz,) m positive down (bin centres)
    tl_incoherent: np.ndarray   # (nz, nr) dB re 1 m; NaN where empty
    tl_coherent: np.ndarray | None  # (nz, nr) dB re 1 m, or None
    frequency: float | None     # Hz used for the coherent field
    source_depth: float
    source_range: float

    def save_npz(self, path):
        np.savez(
            path,
            ranges=self.ranges,
            depths=self.depths,
            tl_incoherent=self.tl_incoherent,
            tl_coherent=(self.tl_coherent if self.tl_coherent is not None
                         else np.array([])),
            frequency=np.float64(self.frequency if self.frequency is not None
                                 else np.nan),
            source_depth=np.float64(self.source_depth),
            source_range=np.float64(self.source_range),
        )

    @classmethod
    def load_npz(cls, path):
        with np.load(path) as d:
            freq = float(d["frequency"])
            coh = d["tl_coherent"]
            return cls(
                ranges=d["ranges"],
                depths=d["depths"],
                tl_incoherent=d["tl_incoherent"],
                tl_coherent=(None if coh.size == 0 else coh),
                frequency=(None if np.isnan(freq) else freq),
                source_depth=float(d["source_depth"]),
                source_range=float(d["source_range"]),
            )

    def plot(self, which: str = "incoherent", ax=None, vmin=None, vmax=None,
             cmap="viridis_r"):
        """Pcolormesh of the TL field (depth increasing downward)."""
        import matplotlib.pyplot as plt

        tl = self.tl_coherent if which == "coherent" else self.tl_incoherent
        if tl is None:
            raise ValueError("no coherent field: pass frequency= at build")
        if ax is None:
            _, ax = plt.subplots(figsize=(9, 4))
        pc = ax.pcolormesh(self.ranges / 1e3, self.depths, tl,
                           vmin=vmin, vmax=vmax, cmap=cmap, shading="auto")
        ax.invert_yaxis()
        ax.set_xlabel("range [km]")
        ax.set_ylabel("depth [m]")
        ax.set_title(f"{which} TL [dB re 1 m]")
        plt.colorbar(pc, ax=ax, label="TL [dB]")
        return ax


def _classified_flip_counts(dzs, depth, bathy_at, alive, slope, dr_save):
    """Cumulative (n_surf, n_bott, kmah) along the save grid, (B, S).

    Sign flips of the spreading Jacobian are boundary folds when the
    flip's save interval approaches a boundary within the ray's local
    vertical excursion (a ray cannot reflect without getting there), and
    caustics otherwise.  Zeros forward-fill so a tangent touching zero
    without crossing does not count (same rule as `amplitudes.py`).

    The excursion bound is ``|tan theta| * dr`` from the ray's own local
    slope — NOT the net save-to-save depth difference, which collapses
    toward zero exactly at a bounce (down-and-back inside one interval).
    A true caustic within that band of a boundary would be misread as a
    fold; events that close together need more save columns anyway.
    """
    B, S = dzs.shape
    sgn = np.sign(dzs)
    idx = np.where(sgn != 0, np.arange(S)[None, :], 0)
    ff = np.maximum.accumulate(idx, axis=1)
    last = np.take_along_axis(sgn, ff, axis=1)
    prev = np.concatenate([np.zeros((B, 1)), last[:, :-1]], axis=1)
    flip = (sgn != 0) & (prev != 0) & (sgn != prev) & alive

    # widest local slope of the flip interval + a metre of slack
    sl = np.maximum(slope, np.concatenate([slope[:, :1], slope[:, :-1]],
                                          axis=1))
    exc = (sl * dr_save + 1.0) * 1.5

    near_surf = depth <= exc
    near_bott = depth >= bathy_at - exc
    surf_flip = flip & near_surf
    bott_flip = flip & near_bott & ~near_surf
    caus_flip = flip & ~near_surf & ~near_bott

    n_surf = np.cumsum(surf_flip, axis=1)
    n_bott = np.cumsum(bott_flip, axis=1)
    kmah = np.cumsum(caus_flip, axis=1)
    return n_surf, n_bott, kmah


def transmission_loss_field(
    source_depth: float,
    source_range: float,
    launch_angles,
    receiver_range: float,
    environment,
    *,
    frequency: float | None = None,
    depths=None,
    num_range: int = 256,
    rtol: float = 1e-9,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    flatearth: bool = True,
    device="cuda",
    backend: str = "auto",
) -> TLField:
    """Ray-binned transmission-loss field from one traced fan.

    ``launch_angles`` (>= 2 values) defines the fan; denser fans give
    smoother fields.  ``depths`` is the receiver-depth bin-centre grid
    (positive down); default 200 bins over the water column at the
    receiver range.  ``num_range`` sets the save/range columns.  Pass
    ``frequency`` (Hz) to also build the coherent (interference) field.

    Requires ``receiver_range > source_range`` (mirror the environment
    for backwards shots, as `trace` itself requires).  ``device``: where an
    ``OceanEnvironment2D``'s tensors are built (the CUDA device unless the
    caller asks for another, e.g. ``"cpu"``); an ``EnvData`` keeps its own.
    """
    if not receiver_range > source_range:
        raise ValueError(
            "transmission_loss_field requires receiver_range > source_range")
    theta0 = np.unique(np.atleast_1d(np.asarray(launch_angles, float)))
    if theta0.size < 2:
        raise ValueError("need at least 2 launch angles to define ray tubes")
    settings = settings_for(rtol, dx, interp, True, backend)
    env = _resolve_env(environment, flatearth, False, settings.interp, dtype, device)

    x0, x1 = float(source_range), float(receiver_range)
    z0 = float(source_depth)
    r_h, z_h, c_h = host_profile_tables(env)
    c_src = float(bilinear_np(np.asarray(x0), np.asarray(z0), r_h, z_h, c_h))

    res, dzs = fan_with_angle_tangent(env, z0, theta0, c_src, x0, x1, int(num_range), settings)
    zs = -_host(res.zs)                 # (B, S) user z, negative down
    ps = -_host(res.ps)
    ts = _host(res.ts)
    dzs = dzs * (180.0 / np.pi)         # dz/dtheta0 per radian
    alive_save = res.alive_save.cpu().numpy().astype(bool)
    B, S = zs.shape

    r_save = np.linspace(x0, x1, S)
    depth = -zs                          # positive down
    bathy_at = linear_np(r_save, _host(env.bathy_r), _host(env.bathy))[None, :]

    if depths is None:
        depths = np.linspace(0.0, float(bathy_at[0, -1]), 200)
    depths = np.asarray(depths, float)
    if depths.size < 2 or np.any(np.diff(depths) <= 0):
        raise ValueError("depths must be an increasing grid of >= 2 values")
    dz_bin = float(depths[1] - depths[0])
    nz = depths.size

    dtheta = np.gradient(np.radians(theta0))         # (B,) rad per ray tube
    cos0 = np.cos(np.radians(theta0))[:, None]

    c_at = bilinear_np(np.broadcast_to(r_save, (B, S)), depth, r_h, z_h, c_h)
    sin_r = np.clip(np.abs(ps) * c_at, 0.0, 1.0)
    cos_r = np.sqrt(np.maximum(1.0 - sin_r * sin_r, 1e-12))

    R = r_save[None, 1:] - x0                         # columns 1..S-1
    ok = alive_save[:, 1:]
    dep = depth[:, 1:]
    jbin = np.rint((dep - depths[0]) / dz_bin).astype(np.int64)
    inside = ok & (jbin >= 0) & (jbin < nz)

    # --- incoherent: flux deposit, Jacobian-free ---
    w_inc = (dtheta[:, None] * c_at[:, 1:] * cos0
             / (c_src * R * cos_r[:, 1:] * dz_bin))
    I = np.zeros((nz, S - 1))
    np.add.at(I, (jbin[inside], np.broadcast_to(
        np.arange(S - 1)[None, :], jbin.shape)[inside]), w_inc[inside])
    with np.errstate(divide="ignore"):
        tl_inc = np.where(I > 0, -10.0 * np.log10(np.maximum(I, 1e-300)),
                          np.nan)

    tl_coh = None
    if frequency is not None:
        omega = 2.0 * np.pi * float(frequency)
        n_surf, _, kmah = _classified_flip_counts(
            dzs, depth, bathy_at, alive_save, sin_r / cos_r,
            float(r_save[1] - r_save[0]))
        jac = np.abs(dzs[:, 1:]) * cos_r[:, 1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            amp = np.sqrt(c_at[:, 1:] * cos0
                          / (c_src * R * np.maximum(jac, 1e-300)))
        phase = (omega * ts[:, 1:] + np.pi * n_surf[:, 1:]
                 - 0.5 * np.pi * kmah[:, 1:])
        # hat half-width: the tube's own footprint |dz/dtheta0|*dtheta,
        # floored at one bin and capped at 64 bins.  Adjacent tubes are
        # spaced exactly one footprint apart in depth, so hats at the raw
        # footprint tile unity across an eigenray; whenever the width is
        # floored (or capped) the deposit is weighted by footprint/h to
        # keep that tiling — which also regularizes caustics (A*footprint
        # stays finite as the Jacobian -> 0: the Airy peak is smoothed
        # over one bin instead of diverging)
        fp = np.abs(dzs[:, 1:]) * dtheta[:, None]
        h = np.clip(fp, dz_bin, 64.0 * dz_bin)
        pr = amp * (np.minimum(fp, h) / h) * np.exp(1j * phase)
        M = int(np.ceil(np.nanmax(np.where(inside, h, 0.0)) / dz_bin))
        P = np.zeros((nz, S - 1), complex)
        cols = np.broadcast_to(np.arange(S - 1)[None, :], jbin.shape)
        # ramp the phase from the ray's depth to the cell's with the local
        # vertical slowness (user p = sin(theta)/c, theta positive up, so
        # dtau/d(depth) = -p): each hat is a local plane wave, not a
        # constant-phase blob — without this the floored hats smear up to
        # omega*p*h radians and bias |P| low
        psr = ps[:, 1:]
        for m in range(-M, M + 1):
            j = jbin + m
            d_cell = depths[0] + j * dz_bin
            w = np.maximum(0.0, 1.0 - np.abs(d_cell - dep) / h)
            sel = inside & (j >= 0) & (j < nz) & (w > 0)
            dep_w = (pr * w * np.exp(-1j * omega * psr * (d_cell - dep)))
            np.add.at(P, (j[sel], cols[sel]), dep_w[sel])
        with np.errstate(divide="ignore"):
            mag = np.abs(P)
            tl_coh = np.where(mag > 0,
                              -20.0 * np.log10(np.maximum(mag, 1e-300)),
                              np.nan)

    return TLField(
        ranges=r_save[1:],
        depths=depths,
        tl_incoherent=tl_inc,
        tl_coherent=tl_coh,
        frequency=(float(frequency) if frequency is not None else None),
        source_depth=z0,
        source_range=x0,
    )
