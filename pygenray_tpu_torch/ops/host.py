# Copied from pygenray_tpu/ops/host.py (host-only numpy); tests pin it equal to the original.
"""Host-side (numpy) kernels for API parity and light bookkeeping.

The reference exports its Numba kernels publicly
(`pygenray/integration_processes.py:337-346`); these are
numpy equivalents with identical clamped-interpolation semantics, usable on
scalars or arrays.  The hot path does NOT go through these — on device the
integrator uses ``pygenray_tpu.ops.interp`` / ``ops.cheb``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bilinear_np",
    "linear_np",
    "derivs_np",
    "ray_angle_np",
    "surface_bounce",
    "bottom_bounce",
    "vertical_ray",
    "ray_bounding_box_event",
]


def bilinear_np(x, y, x_grid, y_grid, values):
    """Clamped bilinear interpolation (scalar or array x/y)."""
    x = np.asarray(x)
    y = np.asarray(y)
    i = np.clip(np.searchsorted(x_grid, x, side="right") - 1, 0, len(x_grid) - 2)
    j = np.clip(np.searchsorted(y_grid, y, side="right") - 1, 0, len(y_grid) - 2)
    wx = (x - x_grid[i]) / (x_grid[i + 1] - x_grid[i])
    wy = (y - y_grid[j]) / (y_grid[j + 1] - y_grid[j])
    out = (
        (1 - wx) * (1 - wy) * values[i, j]
        + wx * (1 - wy) * values[i + 1, j]
        + (1 - wx) * wy * values[i, j + 1]
        + wx * wy * values[i + 1, j + 1]
    )
    return out


def linear_np(x, xin, yin):
    """Clamped 1D linear interpolation (scalar or array x)."""
    x = np.asarray(x)
    i = np.clip(np.searchsorted(xin, x, side="right") - 1, 0, len(xin) - 2)
    w = (x - xin[i]) / (xin[i + 1] - xin[i])
    return (1 - w) * yin[i] + w * yin[i + 1]


def derivs_np(x, y, cin, cpin, rin, zin, depths=None, depth_ranges=None):
    """Ray-equation right-hand side [dT/dx, dz/dx, dp/dx] (ODE convention).

    Signature mirrors the reference ``derivsrd``
    (`integration_processes.py:26-98`) including the s^2 clamp that keeps
    vertical rays finite.
    """
    z, pz = y[1], y[2]
    c = bilinear_np(x, z, rin, zin, cin)
    cp = bilinear_np(x, z, rin, zin, cpin)
    arg = 1.0 - (c**2) * (pz**2)
    arg = np.where(arg <= 0.0, 1e-30, arg)
    fact = 1.0 / np.sqrt(arg)
    return np.array([fact / c, c * pz * fact, -fact * cp / (c**2)])


def ray_angle_np(x, y, cin, rin, zin):
    """Ray angle [deg] and local sound speed at a ray state
    (reference `integration_processes.py:306-334`)."""
    c = bilinear_np(x, y[1], rin, zin, cin)
    theta = np.degrees(np.arcsin(np.clip(y[2] * c, -1.0, 1.0)))
    return theta, c


# ---------------------------------------------------------------------------
# Event indicator functions (reference public API parity)
# ---------------------------------------------------------------------------
#
# The reference exposes its scipy terminal-event indicators publicly
# (`integration_processes.py:238-303`): ±1 step functions whose sign change
# the adaptive solver localizes.  The TPU engine handles events as signed
# boundary crossings inside the scan instead, but these host equivalents are
# provided for API compatibility and for driving external scipy solvers.


def surface_bounce(x, y, cin, cpin, rin, zin, depths=None, depth_ranges=None):
    """+1 when the ray is above the surface and travelling upward."""
    theta, _ = ray_angle_np(x, y, cin, rin, zin)
    return 1.0 if (y[1] < 0 and theta < 0) else -1.0


def bottom_bounce(x, y, cin, cpin, rin, zin, depths, depth_ranges):
    """+1 when the ray is below the bathymetry and travelling downward."""
    bottom_depth = linear_np(x, depth_ranges, depths)
    theta, _ = ray_angle_np(x, y, cin, rin, zin)
    return 1.0 if (y[1] > bottom_depth and theta > 0) else -1.0


def vertical_ray(x, y, cin, cpin, rin, zin, depths=None, depth_ranges=None):
    """+1 when the ray is within 1e-3 degrees of vertical."""
    theta, _ = ray_angle_np(x, y, cin, rin, zin)
    return 1.0 if abs(theta) > (90 - 1e-3) else -1.0


def ray_bounding_box_event(x, y, cin, cpin, rin, zin, depths=None, depth_ranges=None):
    """+1 when the ray state leaves the sound-speed grid (±1e-6 m tol)."""
    tol = 1e-6
    z = y[1]
    out = (
        (z > zin[-1] + tol)
        or (z < zin[0] - tol)
        or (x < rin[0] - tol)
        or (x > rin[-1] + tol)
    )
    return 1.0 if out else -1.0
