# Fitting half copied from pygenray_tpu/ops/cheb.py (host numpy); clenshaw/horner ported to torch.
"""Chebyshev "spectral profile" representation.

At environment construction each sound-speed column c(z) (and the tabulated
dc/dz column) is fitted with a Chebyshev series (host numpy, float64); the
integrator evaluates the series with the Clenshaw recurrence or, when the
monomial re-expression is well conditioned (``poly_ok``), with Horner.  Both
evaluators are plain torch ops here; the CUDA kernel
(``csrc/trace_fan.cu``) carries the same recurrences per thread.

The fit is guarded: ``fit_profile_cheb`` reports the max residual against the
table, and the engine falls back to exact table interpolation when the
residual exceeds tolerance.  Range dependence: coefficients are fitted per
range station and blended linearly in range.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "fit_profile_cheb", "fit_series_cheb", "clenshaw", "cheb_mirror",
    "cheb2poly_matrix", "horner", "poly_ok",
]


def fit_series_cheb(x: np.ndarray, y: np.ndarray, order: int, lo=None, hi=None):
    """Least-squares Chebyshev fit of samples y(x) on domain [lo, hi].

    Returns (coef (order+1,), max_abs_residual).
    """
    import numpy.polynomial.chebyshev as ncheb

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    lo = x[0] if lo is None else lo
    hi = x[-1] if hi is None else hi
    order = min(order, len(x) - 1)
    f = ncheb.Chebyshev.fit(x, y, order, domain=[lo, hi])
    resid = float(np.max(np.abs(f(x) - y)))
    coef = np.zeros(order + 1)
    coef[: len(f.coef)] = f.coef
    return coef, resid


def fit_profile_cheb(c: np.ndarray, z: np.ndarray, order: int = 47):
    """Fit every range-station column of c(r, z) with a Chebyshev series.

    Parameters
    ----------
    c : (nr, nz) sound-speed (or dc/dz) table
    z : (nz,) depth grid
    order : polynomial order (K-1)

    Returns
    -------
    coef : (nr, K) per-station coefficients on domain [z[0], z[-1]]
    max_resid : worst-case absolute fit residual over the whole table
    """
    import numpy.polynomial.chebyshev as ncheb

    c = np.atleast_2d(np.asarray(c, np.float64))
    z = np.asarray(z, np.float64)
    order = min(order, len(z) - 1)
    K = order + 1
    nr = c.shape[0]
    coef = np.zeros((nr, K))
    max_resid = 0.0
    # vectorized fit: chebfit supports 2D rhs (columns = separate fits)
    u = (2.0 * z - (z[0] + z[-1])) / (z[-1] - z[0])
    cf = ncheb.chebfit(u, c.T, order)  # (K, nr)
    coef[:, : cf.shape[0]] = cf.T
    fitted = ncheb.chebval(u, cf)  # (nr, nz)
    max_resid = float(np.max(np.abs(fitted - c)))
    return coef, max_resid


def clenshaw(u: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Evaluate a Chebyshev series at u in [-1, 1].

    ``u`` is a tensor (any shape); ``coef`` has shape (K,) or (..., K) with
    leading dims broadcasting against u.
    """
    K = coef.shape[-1]
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for k in range(K - 1, 0, -1):
        b1, b2 = coef[..., k] + 2.0 * u * b1 - b2, b1
    return coef[..., 0] + u * b1 - b2


@functools.lru_cache(maxsize=32)
def cheb2poly_matrix(K: int) -> np.ndarray:
    """M with poly_coef = cheb_coef @ M.T (power basis in the same u).

    A degree-(K-1) Chebyshev series can be re-expressed in the monomial
    basis; Horner evaluation then costs ONE fma per term where Clenshaw
    costs two.  The conversion is exact linear algebra done in float64; its
    f32 *evaluation* conditioning depends on the profile and is guarded per
    environment by ``poly_ok``.
    """
    import numpy.polynomial.chebyshev as ncheb

    M = np.zeros((K, K))
    for k in range(K):
        e = np.zeros(K)
        e[k] = 1.0
        p = ncheb.cheb2poly(e)
        M[: len(p), k] = p
    return M


def horner(u: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Evaluate a power-basis polynomial at u (monomial Horner).

    Same calling convention as ``clenshaw``: ``coef`` (K,) or (..., K).
    """
    K = coef.shape[-1]
    acc = torch.zeros_like(u) + coef[..., K - 1]
    for k in range(K - 2, -1, -1):
        acc = acc * u + coef[..., k]
    return acc


def poly_ok(coef: np.ndarray, tol: float, nu: int = 2049) -> bool:
    """True when the monomial form of every Chebyshev row in ``coef``
    evaluates (in float32 Horner) within ``tol`` of the float64 Chebyshev
    value across u in [-1, 1].

    Smooth analytic profiles (Munk-class, K≈16) pass easily — their power
    coefficients stay O(c) and f32 Horner is as accurate as f32 Clenshaw.
    Rough high-order fits (internal-wave ensembles at K≈64+) fail the
    2^k coefficient growth and keep the Clenshaw path.
    """
    import numpy.polynomial.chebyshev as ncheb

    coef = np.atleast_2d(np.asarray(coef, np.float64))
    K = coef.shape[-1]
    with np.errstate(over="ignore", invalid="ignore"):
        M = cheb2poly_matrix(K)
        pcoef = coef @ M.T
    if not np.all(np.isfinite(pcoef)):
        return False
    # quick reject: monomial coefficients far beyond f32 range cannot pass
    # the dense check — skip the 2049-point evaluation
    if np.abs(pcoef).max() > 1e8:
        return False
    u64 = np.linspace(-1.0, 1.0, nu)
    ref = ncheb.chebval(u64, coef.T)  # (nr, nu)
    u32 = u64.astype(np.float32)
    p32 = pcoef.astype(np.float32)
    acc = np.broadcast_to(p32[:, K - 1 : K], (p32.shape[0], nu)).astype(np.float32)
    for k in range(K - 2, -1, -1):
        acc = (acc * u32 + p32[:, k : k + 1]).astype(np.float32)
    return bool(np.max(np.abs(acc - ref)) <= tol)


def cheb_mirror(coef):
    """Coefficients of f(-u) given those of f(u): negate odd terms.

    Used when mirroring the environment about the range axis for backwards
    shots.  Works for numpy arrays or torch tensors, any leading batch dims.
    """
    K = coef.shape[-1]
    sign = (-1.0) ** np.arange(K)
    if isinstance(coef, torch.Tensor):
        sign = torch.as_tensor(sign, dtype=coef.dtype, device=coef.device)
    return coef * sign
