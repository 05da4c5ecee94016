"""Interpolation helpers on torch tensors (batched).

Counterpart of ``pygenray_tpu/ops/interp.py``: ``searchsorted - 1`` interval
lookup, index clamping to ``[0, n-2]`` (constant-slope extrapolation at the
edges) and the same blend formulas, evaluated for a whole batch of query
points at once.  Uniform grids replace ``searchsorted`` with direct index
arithmetic.  ``cubic_spline_coeffs`` is the host numpy precompute, copied
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bilinear_interp",
    "linear_interp",
    "interval_index",
    "cubic_spline_coeffs",
    "cubic_spline_eval",
]


def interval_index(x: torch.Tensor, grid: torch.Tensor, uniform: bool = False) -> torch.Tensor:
    """Index i such that grid[i] <= x < grid[i+1], clamped to [0, n-2]."""
    n = grid.shape[0]
    if uniform:
        # divide by a tensor: a Python divisor becomes a reciprocal multiply
        # on CUDA devices, which rounds differently from the CPU
        step = (grid[-1] - grid[0]) / torch.full((), float(n - 1), dtype=grid.dtype,
                                                 device=grid.device)
        # clamp before the integer cast: the cast of an out-of-range float
        # is undefined, the clamped index is the same either way
        f = torch.clamp(torch.floor((x - grid[0]) / step), -1.0, float(n))
        i = f.to(torch.int64)
    else:
        i = torch.searchsorted(grid, x.contiguous(), right=True) - 1
    return torch.clamp(i, 0, n - 2)


def linear_interp(x, xg: torch.Tensor, yg: torch.Tensor, uniform: bool = False) -> torch.Tensor:
    """Clamped 1D linear interpolation; ``x`` may be any shape."""
    x = torch.as_tensor(x, dtype=xg.dtype, device=xg.device)
    i = interval_index(x, xg, uniform)
    x0 = xg[i]
    x1 = xg[i + 1]
    w = (x - x0) / (x1 - x0)
    return (1.0 - w) * yg[i] + w * yg[i + 1]


def bilinear_interp(x, y, xg: torch.Tensor, yg: torch.Tensor, values: torch.Tensor,
                    uniform_x: bool = False, uniform_y: bool = False) -> torch.Tensor:
    """Clamped bilinear interpolation on a rectilinear grid.

    ``values`` has shape (len(xg), len(yg)); ``x``/``y`` broadcast together.
    """
    x = torch.as_tensor(x, dtype=xg.dtype, device=xg.device)
    y = torch.as_tensor(y, dtype=yg.dtype, device=yg.device)
    x, y = torch.broadcast_tensors(x, y)
    i = interval_index(x, xg, uniform_x)
    j = interval_index(y, yg, uniform_y)
    wx = (x - xg[i]) / (xg[i + 1] - xg[i])
    wy = (y - yg[j]) / (yg[j + 1] - yg[j])
    v00 = values[i, j]
    v10 = values[i + 1, j]
    v01 = values[i, j + 1]
    v11 = values[i + 1, j + 1]
    return (
        (1 - wx) * (1 - wy) * v00
        + wx * (1 - wy) * v10
        + (1 - wx) * wy * v01
        + wx * wy * v11
    )


# ---------------------------------------------------------------------------
# Not-a-knot cubic spline (host-side precompute, device-side eval)
# ---------------------------------------------------------------------------


def cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Coefficients of the not-a-knot interpolating cubic spline.

    Returns ``coef`` of shape (n-1, 4): on interval [x[i], x[i+1]],
    ``s(t) = c0 + c1*dt + c2*dt^2 + c3*dt^3`` with ``dt = t - x[i]``.
    Falls back to linear for n < 4.
    """
    from scipy.interpolate import CubicSpline

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n == 2:
        c1 = (y[1] - y[0]) / (x[1] - x[0])
        return np.array([[y[0], c1, 0.0, 0.0]])
    if n == 3:
        # single quadratic through three points
        cs = np.polyfit(x - x[0], y, 2)
        # convert to per-interval form (same quadratic on both intervals)
        out = np.zeros((2, 4))
        for i in range(2):
            dx = x[i] - x[0]
            a, b, c = cs  # a t^2 + b t + c  with t measured from x[0]
            out[i] = [a * dx**2 + b * dx + c, 2 * a * dx + b, a, 0.0]
        return out
    cs = CubicSpline(x, y, bc_type="not-a-knot")
    # cs.c is (4, n-1) with highest power first
    return cs.c[::-1].T.copy()


def cubic_spline_eval(t: torch.Tensor, knots: torch.Tensor, coef: torch.Tensor,
                      uniform: bool = False) -> torch.Tensor:
    """Evaluate a precomputed cubic spline at ``t`` (any shape)."""
    i = interval_index(t, knots, uniform)
    dt = t - knots[i]
    c = coef[i]
    return c[..., 0] + dt * (c[..., 1] + dt * (c[..., 2] + dt * c[..., 3]))
