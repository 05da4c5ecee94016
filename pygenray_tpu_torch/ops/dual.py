"""Forward-mode dual numbers over torch tensors.

A ``Dual`` carries a value and one forward tangent.  The step arithmetic of
``integrate`` is written once over these helpers, so the same code runs on
plain tensors (the forward trace, ``_trace_impl``) and on ``Dual``\\ s (the
forward-tangent trace, ``_trace_tangent_impl``).  On plain tensors every
helper is the one torch call the forward trace always made, so its values
do not change.

Each rule below is written in the order of ``csrc/dual.cuh``, its CUDA
counterpart, so the tangent kernel reproduces this plain version
operation for operation.  The rules differentiate what ``jax.jvp``
differentiates in the JAX package's tangent kernel (``_make_step_math``):
``where`` takes the tangent of the branch it selects, and ``clamp`` /
``maximum`` pass the tangent inside their range, none outside it, and half
of it at a tie with a bound (JAX's ``maximum`` splits a tie 0.5/0.5).
"""

from __future__ import annotations

import torch

from .cheb import clenshaw as _clenshaw, horner as _horner

__all__ = [
    "Dual", "value", "zeros_like", "where", "clamp", "maximum", "rsqrt", "sqrt",
    "sincos", "horner", "clenshaw",
]


class Dual:
    """A value ``v`` and its forward tangent ``t`` (tensors of one shape).
    Anything that is not a ``Dual`` is a constant with tangent 0."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v = v
        self.t = t

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.t + o.t)
        return Dual(self.v + o, self.t)

    def __radd__(self, o):
        return Dual(o + self.v, self.t)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.t - o.t)
        return Dual(self.v - o, self.t)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.t * o.v + self.v * o.t)
        return Dual(self.v * o, self.t * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.t)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.v / o.v
            return Dual(q, (self.t - q * o.t) / o.v)
        return Dual(self.v / o, self.t / o)

    def __rtruediv__(self, o):
        q = o / self.v
        return Dual(q, -(q * self.t) / self.v)

    def __neg__(self):
        return Dual(-self.v, -self.t)

    # comparisons decide branches: they read the value only
    def __lt__(self, o):
        return self.v < value(o)

    def __le__(self, o):
        return self.v <= value(o)

    def __gt__(self, o):
        return self.v > value(o)

    def __ge__(self, o):
        return self.v >= value(o)


def value(x):
    return x.v if isinstance(x, Dual) else x


def _tangent(x):
    return x.t if isinstance(x, Dual) else 0.0


def zeros_like(x):
    if isinstance(x, Dual):
        return Dual(torch.zeros_like(x.v), torch.zeros_like(x.v))
    return torch.zeros_like(x)


def where(cond, a, b):
    if isinstance(a, Dual) or isinstance(b, Dual):
        return Dual(torch.where(cond, value(a), value(b)),
                    torch.where(cond, _tangent(a), _tangent(b)))
    return torch.where(cond, a, b)


def clamp(x, lo, hi):
    if not isinstance(x, Dual):
        return torch.clamp(x, lo, hi)
    v = x.v
    inside = (v > lo) & (v < hi)
    tie = (v == lo) | (v == hi)
    return Dual(torch.clamp(v, lo, hi),
                torch.where(inside, x.t, torch.where(tie, 0.5 * x.t, 0.0)))


def maximum(x, lo):
    """``max(x, lo)`` for a constant ``lo`` (torch.clamp(x, min=lo))."""
    if not isinstance(x, Dual):
        return torch.clamp(x, min=lo)
    v = x.v
    return Dual(torch.clamp(v, min=lo),
                torch.where(v > lo, x.t, torch.where(v == lo, 0.5 * x.t, 0.0)))


def rsqrt(x):
    if not isinstance(x, Dual):
        return torch.rsqrt(x)
    r = torch.rsqrt(x.v)
    return Dual(r, x.t * (-0.5 * (r / x.v)))


def sqrt(x):
    if not isinstance(x, Dual):
        return torch.sqrt(x)
    s = torch.sqrt(x.v)
    return Dual(s, 0.5 * x.t / s)


def sincos(x):
    """``(sin x, cos x)``."""
    if not isinstance(x, Dual):
        return torch.sin(x), torch.cos(x)
    s, c = torch.sin(x.v), torch.cos(x.v)
    return Dual(s, c * x.t), Dual(c, -s * x.t)


def horner(u, coef):
    """``ops.cheb.horner``; on a ``Dual`` the tangent follows the same
    recurrence (d acc = d acc * u + acc * du)."""
    if not isinstance(u, Dual):
        return _horner(u, coef)
    K = coef.shape[-1]
    acc = Dual(torch.zeros_like(u.v) + coef[..., K - 1], torch.zeros_like(u.v))
    for k in range(K - 2, -1, -1):
        acc = acc * u + coef[..., k]
    return acc


def clenshaw(u, coef):
    """``ops.cheb.clenshaw``; on a ``Dual`` the tangent follows the same
    recurrence."""
    if not isinstance(u, Dual):
        return _clenshaw(u, coef)
    K = coef.shape[-1]
    b1 = zeros_like(u)
    b2 = zeros_like(u)
    for k in range(K - 1, 0, -1):
        b1, b2 = coef[..., k] + 2.0 * u * b1 - b2, b1
    return coef[..., 0] + u * b1 - b2
