"""Arrival amplitudes from ray-tube geometric spreading.

Counterpart of ``pygenray_tpu/amplitudes.py``.  The reference package
(pygenray) carries arrival kinematics only (travel time, depth, angle,
bounce counts); it has no amplitude/transmission-loss surface.  This module
adds one, and it costs almost nothing here because the engine is
differentiable: the ray-tube spreading Jacobian IS the derivative of
arrival depth with respect to launch angle, which the save-grid
forward-tangent CUDA kernel (`ops.stepper.trace_tangent_save_kernel`)
produces for a whole fan in a single launch — exact AD, no
finite-difference fan pairs.

Physics (standard geometric ray theory, e.g. Jensen, Kuperman, Porter &
Schmidt, *Computational Ocean Acoustics*, ch. 3.3): energy launched into
the tube [theta0, theta0+dtheta] with azimuthal symmetry spreads over a
ring of area ``2*pi*R * |dz/dtheta0| cos(theta_r) dtheta``, giving the
pressure amplitude relative to 1 m from the source

    A = sqrt( c_r cos(theta0) / (c_0 R cos(theta_r) |dz_r/dtheta0|) )

which reduces exactly to spherical spreading ``A = 1/s`` (slant range
``s = R/cos(theta0)``) in an unbounded isovelocity medium — the unit
test pins that limit.  Each surface reflection flips the sign of the
pressure (pressure-release surface, phase ``pi``); each caustic touch —
the spreading Jacobian passing through zero along the path, counted on
the save grid (the KMAH index) — contributes ``-pi/2``.  Boundary
reflections also flip the Jacobian's sign (the tube folds, |J|
continuous) without a caustic, so the count subtracts one flip per
recorded bounce.  Bottom reflections are perfect (no loss, no phase),
matching the reference's reflection model; volume attenuation is out of
scope for both.

Conventions: user convention throughout (depths positive down, launch
angle in degrees, positive up — `docs/ray_physics.md`).  The KMAH count
is resolved on the ``num_save`` grid: caustics closer together than one
save interval merge, so use a few hundred save points for long ranges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from .envdata import host_profile_tables
from .integrate import _plan, _rides_tangent_trace, _tangent_grids, trace
from .ops.host import bilinear_np
from .shoot import _resolve_env, settings_for

__all__ = ["Arrivals", "arrival_amplitudes"]


@dataclasses.dataclass(frozen=True)
class Arrivals:
    """Per-launch-angle arrival data (all arrays shape ``(B,)``).

    ``amplitude`` is the geometric-spreading pressure amplitude relative
    to 1 m from the source; ``tl_db = -20 log10(amplitude)`` is the
    transmission loss re 1 m.  ``phase`` is the non-kinematic phase
    (``pi * n_surf - pi/2 * kmah``) to add to the travel-time phase
    ``-omega * t``; the complex arrival factor is
    ``amplitude * exp(1j * phase)``.  Dead rays carry NaN amplitude and
    their ``death_code``.
    """

    theta0: np.ndarray          # launch angle (deg, user convention)
    amplitude: np.ndarray       # |p(R)| / |p(1 m)|
    tl_db: np.ndarray           # -20 log10(amplitude)
    phase: np.ndarray           # surface + KMAH phase (rad)
    kmah: np.ndarray            # caustic count along the path
    travel_time: np.ndarray     # s
    z_r: np.ndarray             # arrival z (m; RayFan convention, negative below surface)
    theta_r: np.ndarray         # arrival angle magnitude (deg)
    n_surf: np.ndarray
    n_bott: np.ndarray
    alive: np.ndarray
    death_code: np.ndarray
    # arc length along the ray path (m), summed over the save grid —
    # what frequency-dependent volume absorption multiplies.  None on
    # archives written before the field existed.
    path_length: np.ndarray = None

    def pressure(self) -> np.ndarray:
        """Complex arrival factor ``A exp(i phase)`` (travel-time phase
        ``exp(-i omega t)`` is the caller's, it needs a frequency)."""
        return self.amplitude * np.exp(1j * self.phase)

    def __len__(self):
        return self.theta0.shape[0]

    def __getitem__(self, idx):
        """Field-wise selection (int, slice, or index/boolean array);
        always returns an ``Arrivals`` with 1-D fields."""
        sel = np.atleast_1d(np.arange(len(self))[idx])
        return Arrivals(**{
            f.name: (None if getattr(self, f.name) is None
                     else np.asarray(getattr(self, f.name))[sel])
            for f in dataclasses.fields(self)
        })

    def save_npz(self, filename):
        """Numpy-native export (round-trips with ``Arrivals.load_npz``)."""
        np.savez(filename, **{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        })

    def save_mat(self, filename):
        """MATLAB export, one ``arrivals`` struct — the same convention as
        ``RayFan.save_mat`` (reference `ray_objects.py:262-288`)."""
        from scipy import io

        io.savemat(filename, {"arrivals": {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }})

    @classmethod
    def load_npz(cls, filename):
        d = np.load(filename)
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(float)


def fan_with_angle_tangent(env, z0, theta0, c_src, x0, x1, num_save, settings):
    """One traced fan with the forward tangent over the user launch angle
    [deg]: returns ``(TraceResult, dzs)``, the result in the ODE convention
    on the environment's device and ``dzs = d(user z)/d(user theta)`` per
    degree on the host, (B, num_save).

    The user angle is minus the ODE angle, ``p0 = sin(-theta)/c_src``, so
    the seed is ``dp0 = -cos(theta) (pi/180) / c_src`` per ray and the
    depth tangent is negated back to the user convention.  Where the
    save-grid tangent trace covers the configuration the seed goes straight
    to it: on a CUDA environment one save-grid tangent kernel launch and no
    forward-fan launch.  Other configurations (table or segment profile,
    spline bottom angle, ``backend="ops"``) take ``trace``'s forward-mode
    fallback through the torch-op loop.
    """
    th = np.radians(np.asarray(theta0, float))
    p0 = torch.as_tensor(np.sin(-th) / c_src, dtype=env.dtype, device=env.device)
    dp0 = torch.as_tensor(-np.cos(th) * (np.pi / 180.0) / c_src, dtype=env.dtype,
                          device=env.device)
    if _rides_tangent_trace(env, settings):
        h, sps, nseg = _plan(float(x0), float(x1), int(num_save), settings.dx)
        geom = (float(x0), float(x1), float(h), int(sps), int(nseg))
        res, (_, dzs, _) = _tangent_grids(env, z0, p0, dp0, None, geom, settings)
        return res, -_host(dzs)
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        res = trace(env, z0, fwAD.make_dual(p0, dp0), x0, x1, num_save, settings)
        dzs = -_host(fwAD.unpack_dual(res.zs).tangent)
        res = dataclasses.replace(res, **{f: fwAD.unpack_dual(getattr(res, f)).primal
                                          for f in ("ts", "zs", "ps")})
    return res, dzs


def arrival_amplitudes(
    source_depth: float,
    source_range: float,
    launch_angles,
    receiver_range: float,
    environment,
    num_save: int = 512,
    rtol: float = 1e-9,
    *,
    dx: float = None,
    interp: str = "auto",
    dtype=None,
    flatearth: bool = True,
    device="cuda",
    backend: str = "auto",
) -> Arrivals:
    """Geometric ray-tube amplitudes for a fan of launch angles.

    Same launch conventions as `shoot.shoot_rays`; one traced fan with a
    forward tangent gives every arrival's amplitude, caustic (KMAH)
    count, and reflection phase.  Typical use: feed the converged launch
    angles from `eigenrays.find_eigenrays` to get the complex arrival
    factors at a receiver.

    Requires ``receiver_range > source_range`` (mirror the environment
    for backwards shots, as `trace` itself requires).  ``device``: where an
    ``OceanEnvironment2D``'s tensors are built (the CUDA device unless the
    caller asks for another, e.g. ``"cpu"``); an ``EnvData`` keeps its own.
    """
    if not receiver_range > source_range:
        raise ValueError("arrival_amplitudes requires receiver_range > source_range")
    theta0 = np.atleast_1d(np.asarray(launch_angles, float))
    settings = settings_for(rtol, dx, interp, True, backend)
    env = _resolve_env(environment, flatearth, False, settings.interp, dtype, device)

    x0, x1 = float(source_range), float(receiver_range)
    z0 = float(source_depth)
    r_h, z_h, c_h = host_profile_tables(env)
    c_src = float(bilinear_np(np.asarray(x0), np.asarray(z0), r_h, z_h, c_h))

    # one forward tangent seeded with d(theta)=1 per ray: on a CUDA
    # environment a single save-grid tangent kernel launch.  dzs has shape
    # (B, S) — the spreading Jacobian along the whole save grid, which the
    # KMAH count needs (a caustic is a sign change of dz/dtheta0 along the
    # path).
    res, dzs = fan_with_angle_tangent(env, z0, theta0, c_src, x0, x1, int(num_save), settings)
    zs, ps, ts = -_host(res.zs), -_host(res.ps), _host(res.ts)
    dzs = dzs * (180.0 / np.pi)  # per radian
    alive = res.alive.cpu().numpy().astype(bool)
    n_surf = res.n_surf.cpu().numpy()
    n_bott = res.n_bott.cpu().numpy()
    death = res.death_code.cpu().numpy()

    th_rad = np.radians(theta0)
    cos0 = np.cos(th_rad)
    z_r = zs[:, -1]
    t_r = ts[:, -1]
    # user-convention z is NEGATIVE below the surface (`docs/ray_physics.md`,
    # RayFan.zs semantics); the profile tables are depth-positive
    c_r = bilinear_np(np.full_like(z_r, x1), -z_r, r_h, z_h, c_h)
    # user p is sin(theta)/c with theta positive up; magnitude is all the
    # spreading formula needs
    sin_r = np.clip(np.abs(ps[:, -1]) * c_r, 0.0, 1.0)
    cos_r = np.sqrt(1.0 - sin_r * sin_r)
    theta_r = np.degrees(np.arcsin(sin_r))

    R = x1 - x0
    # arc length over the save grid (volume-absorption input; dead rays'
    # frozen post-death saves contribute level segments, but their
    # amplitude is NaN anyway)
    dr_save = R / max(zs.shape[1] - 1, 1)
    path_len = np.hypot(dr_save, np.diff(zs, axis=1)).sum(axis=1)
    jac = np.abs(dzs[:, -1]) * cos_r
    with np.errstate(divide="ignore", invalid="ignore"):
        amp = np.sqrt((c_r * cos0) / (c_src * R * np.maximum(jac, 1e-300)))
        tl = -20.0 * np.log10(amp)

    # KMAH index: sign changes of the spreading Jacobian along the save
    # grid, MINUS the boundary reflections.  A caustic is J passing
    # through zero; a surface/bottom reflection FOLDS the tube — the sign
    # of dz/dtheta0 flips discontinuously with |J| continuous (image-source
    # geometry: -z0/(sin t cos t) -> +z0/(sin t cos t)) and carries no
    # -pi/2 — each recorded reflection cancels exactly one flip.  The
    # source point has dz/dtheta = 0 identically; forward-fill the last
    # NONZERO sign so a tangent touching zero at a turning point without
    # crossing does not count.  Resolution caveat: a caustic and a bounce
    # inside the SAME save interval cancel on the grid and undercount by
    # one — use enough save points that events land in separate intervals.
    sgn = np.sign(dzs)
    idx = np.where(sgn != 0, np.arange(sgn.shape[1])[None, :], 0)
    ff = np.maximum.accumulate(idx, axis=1)
    last = np.take_along_axis(sgn, ff, axis=1)
    prev = np.concatenate([np.zeros((sgn.shape[0], 1)), last[:, :-1]], axis=1)
    flips = (((sgn != 0) & (prev != 0) & (sgn != prev)).sum(axis=1)
             .astype(np.int64))
    kmah = np.maximum(flips - n_surf.astype(np.int64)
                      - n_bott.astype(np.int64), 0)

    phase = np.pi * n_surf.astype(float) - 0.5 * np.pi * kmah.astype(float)
    amp = np.where(alive, amp, np.nan)
    tl = np.where(alive, tl, np.nan)

    return Arrivals(
        theta0=theta0,
        amplitude=amp,
        tl_db=tl,
        phase=phase,
        kmah=kmah,
        travel_time=t_r,
        z_r=z_r,
        theta_r=theta_r,
        n_surf=n_surf,
        n_bott=n_bott,
        alive=alive,
        death_code=death,
        path_length=path_len,
    )
