"""Differentiable travel times: sensitivity kernels for tomography inversion.

Counterpart of ``pygenray_tpu/adjoint.py``.  Ocean acoustic tomography
inverts eigenray travel-time anomalies δT for sound-speed anomalies δc(r, z).
The operators here give the exact discrete derivatives of the traced travel
times with respect to the spectral (Chebyshev) sound-speed coefficients,
with the dc/dz field chained consistently through the Chebyshev derivative
operator, and the first-order (Fermat) path-integral kernel:

- ``travel_time_jacobian``: exact discrete dT/dcoef, range-independent
- ``travel_time_jacobian_2d``: exact discrete dT/dcoef per range station
- ``travel_times_of_coef`` / ``travel_time_coef_vjp``: the coefficient →
  travel-time map with a reverse-mode rule (Jᵀv without the Jacobian)
- ``fermat_jacobian``: first-order path-integral kernel from one fast
  trace (any basis size; the production inversion operator)
- ``endpoint_time_gradients``: analytic eikonal dT/d(endpoint depths)

On a CUDA environment the exact derivatives run as the coefficient-tangent
kernels (``ops/stepper.py``: ``csrc/trace_coef_tangent.cu``, for a
range-independent fit or per station of a range-dependent one), one launch
for a whole Jacobian.  Elsewhere they are
``torch.func.jacfwd`` / ``jacrev`` through the torch-op loop
(``integrate._trace_impl``), or plain autograd through it for a
vector-Jacobian product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .envdata import EnvData
from .integrate import SolverSettings, _plan, _trace_impl, _use_cheb

__all__ = [
    "cheb_derivative_matrix",
    "travel_time_jacobian",
    "travel_time_jacobian_2d",
    "travel_times_of_coef",
    "travel_time_coef_vjp",
    "fermat_jacobian",
    "perturbation_response",
    "endpoint_time_gradients",
]

# per-chunk transient cap for the direction-chunked cotangent contraction:
# each kernel launch materializes (nr, Dk, B) tangents on the device before
# the contraction reduces them to (nr, Dk)
_COEF_VJP_CHUNK_ELEMS = 1 << 26


def cheb_derivative_matrix(K: int, zlo: float, zhi: float) -> np.ndarray:
    """Matrix D with (d/dz) [Σ_k a_k T_k(u(z))] = Σ_j (D a)_j T_j(u(z)).

    u(z) maps [zlo, zhi] to [-1, 1], so D includes the 2/(zhi-zlo) scale.
    """
    import numpy.polynomial.chebyshev as ncheb

    D = np.zeros((K, K))
    for k in range(K):
        e = np.zeros(K)
        e[k] = 1.0
        d = ncheb.chebder(e)
        D[: len(d), k] = d
    return D * (2.0 / (zhi - zlo))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _geom(x0, x1, settings):
    """The final-state plan (2 saves) as ``(x0, x1, h, sps, nseg)``."""
    h, sps, nseg = _plan(float(x0), float(x1), 2, settings.dx)
    return (float(x0), float(x1), float(h), int(sps), int(nseg))


def _deriv_matrix(env: EnvData) -> torch.Tensor:
    K = env.c_cheb.shape[1]
    return torch.as_tensor(cheb_derivative_matrix(K, *env.z_dom), dtype=env.c_cheb.dtype,
                           device=env.device)


def _directions(Dm: torch.Tensor):
    """The K unit directions: dc = e_k with dc/dz chained through D, as
    float32 (K, K) tables (row k of the second is D @ e_k)."""
    K = Dm.shape[0]
    return (torch.eye(K, dtype=torch.float32, device=Dm.device),
            Dm.T.to(torch.float32).contiguous())


def _kernel_ok(env: EnvData, settings: SolverSettings, kernel_asked: bool) -> bool:
    """The coefficient-tangent kernel takes the configuration and the call
    asks for it: not ``backend="ops"``, covered by ``tangent_supported``,
    and a CUDA environment, ``backend="kernel"`` or ``kernel_asked``."""
    from .ops.stepper import tangent_supported

    return (
        settings.backend != "ops"
        and tangent_supported(env, dataclasses.replace(settings, kahan=False))
        and (env.device.type == "cuda" or settings.backend == "kernel" or kernel_asked)
    )


def _launch_batch(env: EnvData, p0) -> torch.Tensor:
    return torch.as_tensor(p0, dtype=env.dtype, device=env.device).reshape(-1)


def travel_time_jacobian(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    settings: SolverSettings = SolverSettings(),
    mode: str = "auto",
):
    """∂T_end/∂(c Chebyshev coefficients) for each ray.

    Returns ``(T_end (B,), jac (B, K))`` where ``jac[b, k]`` is the exact
    discrete derivative of ray b's receiver travel time with respect to the
    k-th Chebyshev coefficient of the (range-independent) sound-speed
    profile, with the dc/dz field perturbed consistently (chained through
    the spectral derivative operator).

    ``mode``: "auto" (default) runs the whole (B, K) Jacobian as ONE
    coefficient-tangent kernel launch on supported configurations (float32
    spectral fits on a CUDA device, or ``backend="kernel"``) — thread (k, b)
    advances ray b's forward tangent along coefficient direction k — and
    otherwise falls back to "fwd" (``torch.func.jacfwd`` through the
    torch-op loop; K tangents).  "kernel" insists on the kernel's wrapper
    (its plain version on a CPU tensor) and raises where it does not apply.
    "rev" uses ``torch.func.jacrev``.  Kahan compensation is off, as in the
    forward-AD convention of the tangent traces; the Clenshaw series are
    differentiated whatever ``env.poly_ok`` says.
    """
    if not _use_cheb(env, settings):
        raise ValueError("travel_time_jacobian requires a spectral (cheb) environment")
    if env.range_dependent:
        raise ValueError("travel_time_jacobian supports range-independent environments")

    geom = _geom(x0, x1, settings)
    # the torch-op loop for the autodiff fallback, without Kahan compensation
    # (the forward-AD convention; the kernel path matches it)
    settings_x = dataclasses.replace(settings, backend="ops", kahan=False)
    Dm = _deriv_matrix(env)
    p0 = _launch_batch(env, p0)
    ccoef0 = env.c_cheb[0]
    cp_offset = env.dcdz_cheb[0] - Dm @ ccoef0  # fitted-vs-analytic residual

    if mode in ("auto", "kernel"):
        if _kernel_ok(env, settings, mode == "kernel"):
            from .ops.stepper import trace_coef_tangent_kernel

            out = trace_coef_tangent_kernel(env, z0, p0, *_directions(Dm), geom,
                                            dataclasses.replace(settings, kahan=False))
            return out[0], out[3].T  # (B,), (B, K)
        if mode == "kernel":
            raise ValueError("coefficient-tangent kernel unsupported here")
        mode = "fwd"

    def T_of(ccoef):
        cc = ccoef.expand(env.c_cheb.shape)
        cp = (cp_offset + Dm @ ccoef).expand(env.dcdz_cheb.shape)
        env2 = dataclasses.replace(env, c_cheb=cc, dcdz_cheb=cp, poly_ok=False)
        return _trace_impl(env2, z0, p0, geom, settings_x).ts[:, -1]

    T_end = T_of(ccoef0)
    jac_fn = torch.func.jacfwd(T_of) if mode == "fwd" else torch.func.jacrev(T_of)
    return T_end, jac_fn(ccoef0)  # (B,), (B, K)


def travel_time_jacobian_2d(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    settings: SolverSettings = SolverSettings(),
    mode: str = "auto",
):
    """∂T_end/∂(c coefficients) for a *range-dependent* field: (B, nr, K).

    Differentiates through the per-range-station spectral coefficients —
    the full 2D tomography forward operator, with the dc/dz coefficients
    chained consistently per station.

    ``mode``: "auto" (default) runs the whole (B, nr, K) Jacobian as ONE
    range-dependent coefficient-tangent kernel launch on supported
    configurations (range-dependent float32 spectral fits on a CUDA device,
    or ``backend="kernel"``) — thread (j, k, b) advances ray b's forward
    tangent along station j's coefficient direction k, the tangent station
    rows formed in the kernel from the stations' hat weights — and
    otherwise falls back to "fwd" (``torch.func.jacfwd`` through the
    torch-op loop; nr·K tangents).  "kernel" insists on the kernel's
    wrapper and raises where it does not apply.
    """
    if not _use_cheb(env, settings):
        raise ValueError("travel_time_jacobian_2d requires a spectral environment")

    geom = _geom(x0, x1, settings)
    settings_x = dataclasses.replace(settings, backend="ops", kahan=False)
    Dm = _deriv_matrix(env)
    p0 = _launch_batch(env, p0)
    cc0 = env.c_cheb
    cp_offset = env.dcdz_cheb - cc0 @ Dm.T

    if mode in ("auto", "kernel"):
        if env.range_dependent and _kernel_ok(env, settings, mode == "kernel"):
            from .ops.stepper import trace_coef_tangent_rd_kernel

            out = trace_coef_tangent_rd_kernel(env, z0, p0, *_directions(Dm), geom,
                                               dataclasses.replace(settings, kahan=False))
            return out[0], torch.movedim(out[3], -1, 0)  # (B,), (B, nr, K)
        if mode == "kernel":
            raise ValueError("RD coefficient-tangent kernel unsupported here")

    def T_of(cc):
        env2 = dataclasses.replace(env, c_cheb=cc, dcdz_cheb=cp_offset + cc @ Dm.T,
                                   poly_ok=False)
        return _trace_impl(env2, z0, p0, geom, settings_x).ts[:, -1]

    T_end = T_of(cc0)
    return T_end, torch.func.jacfwd(T_of)(cc0)  # (B,), (B, nr, K)


class _CoefTimes:
    """The coefficient → travel-time map of ``travel_times_of_coef``: the
    environment with a coefficient table put in, its forward trace and its
    vector-Jacobian product."""

    def __init__(self, env: EnvData, z0, p0, x0, x1, settings: SolverSettings):
        self.env, self.z0, self.x0, self.x1 = env, z0, float(x0), float(x1)
        self.p0 = _launch_batch(env, p0)
        self.settings = settings
        self.geom = _geom(x0, x1, settings)
        self.rd = bool(env.range_dependent)
        self.Dm = _deriv_matrix(env)
        if self.rd:
            self.cp_offset = env.dcdz_cheb - env.c_cheb @ self.Dm.T  # (nr, K)
        else:
            self.cp_offset = env.dcdz_cheb[0] - self.Dm @ env.c_cheb[0]  # (K,)

    def env_with(self, cc) -> EnvData:
        env = self.env
        if self.rd:
            cc2, cp2 = cc, self.cp_offset + cc @ self.Dm.T
        else:
            cc2 = cc.expand(env.c_cheb.shape)
            cp2 = (self.cp_offset + self.Dm @ cc).expand(env.dcdz_cheb.shape)
        return dataclasses.replace(env, c_cheb=cc2, dcdz_cheb=cp2, poly_ok=False)

    def times(self, cc) -> torch.Tensor:
        """The receiver travel times: one ``trace`` under the caller's
        backend (the fan kernel on the card), without Kahan compensation."""
        from .integrate import trace

        s = dataclasses.replace(self.settings, kahan=False)
        return trace(self.env_with(cc), self.z0, self.p0, self.x0, self.x1, 2, s).ts[:, -1]

    def vjp(self, cc, v) -> torch.Tensor:
        """Jᵀv for the cotangent ``v`` (B,): the coefficient-tangent
        kernel's unit-direction launches, chunked over directions
        (``_COEF_VJP_CHUNK_ELEMS``) and contracted on the device, where it
        applies; else autograd through the torch-op loop."""
        env2 = self.env_with(cc)
        s = self.settings
        if _kernel_ok(env2, s, False):
            from .ops.stepper import trace_coef_tangent_kernel, trace_coef_tangent_rd_kernel

            dc, dcp = _directions(self.Dm)
            vv = v.to(torch.float32)
            s_k = dataclasses.replace(s, kahan=False)
            K, B = dc.shape[0], self.p0.shape[0]
            nr = env2.c_cheb.shape[0] if self.rd else 1
            Dk = max(1, min(K, _COEF_VJP_CHUNK_ELEMS // max(1, nr * B)))
            gs = []
            for lo in range(0, K, Dk):
                hi = min(lo + Dk, K)
                if self.rd:
                    out = trace_coef_tangent_rd_kernel(env2, self.z0, self.p0, dc[lo:hi],
                                                       dcp[lo:hi], self.geom, s_k)
                    gs.append(torch.einsum("jdb,b->jd", out[3], vv))
                else:
                    out = trace_coef_tangent_kernel(env2, self.z0, self.p0, dc[lo:hi],
                                                    dcp[lo:hi], self.geom, s_k)
                    gs.append(out[3] @ vv)
            return torch.cat(gs, dim=-1).to(cc.dtype)
        settings_x = dataclasses.replace(s, backend="ops", kahan=False)
        with torch.enable_grad():
            c = cc.detach().requires_grad_(True)
            T = _trace_impl(self.env_with(c), self.z0, self.p0, self.geom, settings_x).ts[:, -1]
            (g,) = torch.autograd.grad(T, c, v)
        return g


class _TimesOfCoef(torch.autograd.Function):
    """``travel_times_of_coef``'s map with its reverse-mode rule."""

    @staticmethod
    def forward(ctx, cc, op):
        ctx.op = op
        ctx.save_for_backward(cc)
        return op.times(cc.detach())

    @staticmethod
    def backward(ctx, v):
        (cc,) = ctx.saved_tensors
        return ctx.op.vjp(cc.detach(), v), None


def travel_times_of_coef(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    settings: SolverSettings = SolverSettings(),
):
    """Differentiable map from spectral coefficients to receiver travel
    times, with a reverse-mode rule at kernel speed.

    Returns ``f`` with ``f(cc) -> T_end (B,)``, where ``cc`` is the c
    Chebyshev table — ``(K,)`` for a range-independent environment
    (``travel_time_jacobian`` convention), ``(nr, K)`` for a
    range-dependent one (``travel_time_jacobian_2d``) — and the dc/dz
    field is chained consistently through the spectral derivative
    operator.  ``torch.autograd`` of any misfit through ``f`` contracts the
    cotangent in a ``torch.autograd.Function``'s backward: the tangent map
    is LINEAR in the coefficient direction, so its transpose is assembled
    from the coefficient-tangent kernel's unit-direction launches and
    contracted with the cotangent on the device, chunked over direction
    rows so no (B, nr, K) Jacobian is ever materialized beyond a bounded
    per-chunk transient.  Falls back to autograd through the torch-op loop
    where the kernel does not apply (float64, table interpolation, a CPU
    environment without ``backend="kernel"``).  The forward is one
    ``trace`` without Kahan compensation under the caller's backend.

    This is the vjp companion to ``travel_time_jacobian``/``_2d``: use
    those when the full Jacobian is the product; use this inside
    gradient-based inversion loops where only Jᵀv is needed.
    """
    if not _use_cheb(env, settings):
        raise ValueError("travel_times_of_coef requires a spectral environment")
    op = _CoefTimes(env, z0, p0, x0, x1, settings)

    def f(cc):
        return _TimesOfCoef.apply(cc, op)

    return f


def travel_time_coef_vjp(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    v,
    settings: SolverSettings = SolverSettings(),
):
    """Convenience Jᵀv: contract a travel-time cotangent ``v (B,)`` against
    the coefficient Jacobian without materializing it.  Returns
    ``(T_end (B,), g)`` with ``g (K,)`` (range-independent) or ``(nr, K)``
    (range-dependent).  See ``travel_times_of_coef``."""
    f = travel_times_of_coef(env, z0, p0, x0, x1, settings)
    cc = (env.c_cheb if env.range_dependent else env.c_cheb[0]).detach().requires_grad_(True)
    T_end = f(cc)
    (g,) = torch.autograd.grad(T_end, cc, torch.as_tensor(v, dtype=T_end.dtype,
                                                          device=T_end.device))
    return T_end.detach(), g


def fermat_jacobian(
    env: EnvData,
    z0,
    p0,
    x0: float,
    x1: float,
    settings: SolverSettings = SolverSettings(),
    num_save: int = 512,
    range_dependent: bool = None,
):
    """First-order travel-time Jacobian from the Fermat path integral.

    By ray-path stationarity, the first-order travel-time response to a
    sound-speed perturbation is an integral along the *unperturbed* path:

        δT = -∫ δc / (c² cos θ) dx

    so the Jacobian with respect to the spectral coefficients is just a
    quadrature of basis functions over the saved trajectory — one fast
    trace (the fan kernel on the card) for any basis size, no autodiff.
    Agrees with ``travel_time_jacobian`` (the exact discrete derivative) to
    first order; use the AD version when exact discrete gradients matter
    (optimization), this one for assembling large inversion operators.

    Returns ``(T_end (B,), G)`` as numpy float64 arrays, with ``G`` of shape
    (B, K) for range-independent environments or (B, nr, K) when
    ``range_dependent`` (default: follows the environment); (B, K, S) or
    (B, nr, K, S) in the piecewise-segment basis of a segment-backed
    (rough) field.
    """
    import numpy.polynomial.chebyshev as ncheb

    from .integrate import _use_seg, trace

    res = trace(env, z0, p0, float(x0), float(x1), num_save, settings)
    zs = _np(res.zs).astype(np.float64)  # (B, S) ODE convention
    ps = _np(res.ps).astype(np.float64)
    xs = _np(res.rs).astype(np.float64)  # (S,)
    T_end = _np(res.ts).astype(np.float64)[:, -1]

    if range_dependent is None:
        range_dependent = env.range_dependent

    if _use_seg(env, settings):
        # rough (segment-backed) fields: same Fermat integral, sensitivity
        # expressed in the piecewise-segment basis the engine integrates
        return T_end, _fermat_jacobian_seg(env, zs, ps, xs, range_dependent)
    if not _use_cheb(env, settings):
        raise ValueError(
            "fermat_jacobian needs a spectral (cheb) or segment fit; "
            "exact-table environments have no basis to express dT/dc in"
        )

    K = env.c_cheb.shape[1]
    zlo, zhi = env.z_dom
    u = np.clip((2.0 * zs - (zlo + zhi)) / (zhi - zlo), -1.0, 1.0)

    # local sound speed along the path from the spectral representation
    rg = _np(env.r).astype(np.float64)
    if env.range_dependent:
        cc = _np(env.c_cheb).astype(np.float64)  # (nr, K)
        i = np.clip(np.searchsorted(rg, xs, side="right") - 1, 0, len(rg) - 2)
        w = (xs - rg[i]) / (rg[i + 1] - rg[i])
        coef_x = (1 - w)[:, None] * cc[i] + w[:, None] * cc[i + 1]  # (S, K)
        Tb = ncheb.chebvander(u, K - 1)  # (B, S, K)
        c_path = np.einsum("bsk,sk->bs", Tb, coef_x)
    else:
        coef = _np(env.c_cheb[0]).astype(np.float64)
        Tb = ncheb.chebvander(u, K - 1)
        c_path = Tb @ coef

    s2 = np.maximum(1.0 - (c_path * ps) ** 2, 1e-12)
    kern = -1.0 / (c_path**2 * np.sqrt(s2))  # dδT/dδc per unit range
    wq = _trapezoid_weights(xs)

    if not range_dependent:
        G = np.einsum("bs,bsk->bk", kern * wq[None, :], Tb)
        return T_end, G

    # range-dependent: coefficients live on linear hats over the r grid
    nr = rg.shape[0]
    i = np.clip(np.searchsorted(rg, xs, side="right") - 1, 0, nr - 2)
    w = (xs - rg[i]) / (rg[i + 1] - rg[i])
    hats = np.zeros((xs.shape[0], nr))
    hats[np.arange(xs.shape[0]), i] = 1 - w
    hats[np.arange(xs.shape[0]), i + 1] = w
    G = np.einsum("bs,sj,bsk->bjk", kern * wq[None, :], hats, Tb)
    return T_end, G


def _trapezoid_weights(xs):
    wq = np.empty_like(xs)
    wq[1:-1] = 0.5 * (xs[2:] - xs[:-2])
    wq[0] = 0.5 * (xs[1] - xs[0])
    wq[-1] = 0.5 * (xs[-1] - xs[-2])
    return wq


def _fermat_jacobian_seg(env, zs, ps, xs, range_dependent):
    """Fermat path-integral Jacobian in the piecewise-SEGMENT basis.

    Perturbing segment-monomial coefficient (k, s) of a station perturbs
    c(z) by u_loc(z)^k inside depth segment s (see ``ops/seg.py``), so the
    sensitivity is the kernel-weighted path integral of u^k scattered into
    each point's segment (and, for range-dependent fields, split over the
    two bracketing stations' linear hats).  Returns (B, K, S) or, when
    ``range_dependent``, (B, nr, K, S) — the rough-field tomography
    forward operator the spectral Jacobians cannot express."""
    from .ops.seg import SEG_S

    zlo, zhi = env.z_dom
    cseg = _np(env.c_seg).astype(np.float64)  # (nr, K, S)
    K, S = cseg.shape[1], cseg.shape[2]
    assert S == SEG_S
    B, Sn = zs.shape
    rg = _np(env.r).astype(np.float64)

    if env.range_dependent and rg.shape[0] > 1:
        i = np.clip(np.searchsorted(rg, xs, side="right") - 1, 0, len(rg) - 2)
        w = (xs - rg[i]) / (rg[i + 1] - rg[i])
        coef_x = (
            (1 - w)[:, None, None] * cseg[i] + w[:, None, None] * cseg[i + 1]
        )  # (Sn, K, S)
    else:
        i = np.zeros(Sn, np.int64)
        w = np.zeros(Sn)
        coef_x = np.broadcast_to(cseg[0], (Sn, K, S))

    # per-point segment pick + local coordinate (device arithmetic,
    # ops/seg.seg_eval_np)
    t = np.clip((zs - zlo) * (S / (zhi - zlo)), 0.0, float(S))
    segf = np.minimum(np.floor(t), float(S - 1))
    u = 2.0 * (t - segf) - 1.0  # (B, Sn)
    seg = segf.astype(np.int64)

    # sound speed along the path with the per-point station blend, and the
    # per-point basis functions φ_k(u): local monomials u^k ("pow") or
    # Chebyshev T_k(u) ("cheb" — the high-order rungs)
    cpk = coef_x[np.arange(Sn)[None, :], :, seg]  # (B, Sn, K)
    basis = getattr(env, "seg_basis", "pow")
    phi = np.empty((K, B, Sn))
    phi[0] = 1.0
    if K > 1:
        phi[1] = u
    if basis == "pow":
        for k in range(2, K):
            phi[k] = phi[k - 1] * u
        c_path = cpk[..., K - 1]
        for k in range(K - 2, -1, -1):
            c_path = c_path * u + cpk[..., k]
    else:
        for k in range(2, K):
            phi[k] = 2.0 * u * phi[k - 1] - phi[k - 2]
        b1 = np.zeros((B, Sn))
        b2 = np.zeros((B, Sn))
        for k in range(K - 1, 0, -1):
            b1, b2 = cpk[..., k] + 2.0 * u * b1 - b2, b1
        c_path = cpk[..., 0] + u * b1 - b2

    s2 = np.maximum(1.0 - (c_path * ps) ** 2, 1e-12)
    kern = -1.0 / (c_path**2 * np.sqrt(s2))
    contrib = kern * _trapezoid_weights(xs)[None, :]  # (B, Sn)

    b_idx = np.arange(B)[:, None]
    if not range_dependent:
        G = np.zeros((B, K, S))
        for k in range(K):
            np.add.at(G[:, k, :], (b_idx, seg), contrib * phi[k])
        return G

    nr = rg.shape[0]
    G = np.zeros((B, nr, K, S))
    i_b = np.broadcast_to(i[None, :], (B, Sn))
    for k in range(K):
        Gk = G[:, :, k, :]  # (B, nr, S) view
        np.add.at(Gk, (b_idx, i_b, seg), contrib * phi[k] * (1 - w)[None, :])
        if nr > 1:
            np.add.at(Gk, (b_idx, i_b + 1, seg), contrib * phi[k] * w[None, :])
    return G


def perturbation_response(jac, env: EnvData, delta_c, z_samples=None):
    """First-order travel-time anomaly δT for a profile perturbation δc(z).

    ``delta_c`` is sampled on ``z_samples`` (default: the environment's
    depth grid); it is projected onto the Jacobian's basis — spectral for
    a (B, K) ``jac``, piecewise-segment for a (B, K, S) one (rough fields,
    ``fermat_jacobian`` on a seg-backed environment) — and contracted:
    δT_b = Σ jac[b, ...] δcoef[...].  Returns a numpy array.
    """
    z_samples = _np(env.z) if z_samples is None else np.asarray(z_samples)
    jac = _np(jac)
    zlo, zhi = env.z_dom

    if jac.ndim == 3:  # (B, K, S): segment basis
        from .ops.seg import SEG_S, fit_profile_seg

        K, S = jac.shape[1], jac.shape[2]
        if S != SEG_S:
            raise ValueError("segment-basis Jacobian must have S == SEG_S")
        if not (np.isclose(z_samples[0], zlo) and np.isclose(z_samples[-1], zhi)):
            raise ValueError(
                "segment-basis projection needs delta_c sampled over the "
                f"environment depth domain [{zlo}, {zhi}] (the segment "
                "boundaries are tied to it)"
            )
        dcoef, _, _ = fit_profile_seg(
            np.asarray(delta_c)[None, :], z_samples, order=K - 1,
            basis=getattr(env, "seg_basis", "pow"),
        )
        return np.einsum("bks,ks->b", jac, dcoef[0])

    from .ops.cheb import fit_series_cheb

    K = jac.shape[1]
    dcoef, _ = fit_series_cheb(z_samples, np.asarray(delta_c), K - 1, lo=zlo, hi=zhi)
    # a coarsely sampled perturbation yields fewer than K coefficients
    # (fit order is clamped to len(z_samples)-1); pad with zeros
    if dcoef.shape[0] < K:
        dcoef = np.pad(dcoef, (0, K - dcoef.shape[0]))
    return jac @ dcoef[:K]


def endpoint_time_gradients(env, z0, p0, x0, x1, settings=SolverSettings(),
                            num_save=2):
    """Analytic eigenray travel-time gradients w.r.t. the endpoint depths.

    For a ray regarded as the eigenray connecting its own endpoints, the
    eikonal equation makes the travel time's endpoint derivatives local:

        ∂T/∂z_src (receiver fixed) = −p_src
        ∂T/∂z_rcv (source fixed)   = +p_end

    in ``trace()`` conventions (depths positive down, p = sin(θ_ODE)/c —
    ``TraceResult.ps`` columns 0 and −1).  One plain trace, no tangent
    launches: this is the closed form of the constrained combination of
    launch-parameter jvps, ``∂T/∂z0 − (∂T/∂p0)(∂z_end/∂z0)/(∂z_end/∂p0)``.

    Accuracy: exact (~1e-10 relative vs the constrained AD) when the
    integrated field is Hamiltonian-consistent, i.e. ``dcdz_cheb`` is the
    exact derivative of ``c_cheb`` — build one with
    ``make_env_data(..., dcdz="consistent")``.  On a standard env the dcdz
    fit reproduces the table's central differences (reference parity)
    rather than the c-fit's derivative, which floors the identity at
    ~1e-3 relative worst case.

    Returns ``(T, dT_dz_src, dT_dz_rcv)``, each ``(B,)``.
    """
    from .integrate import trace

    res = trace(env, z0, p0, x0, x1, max(int(num_save), 2), settings)
    return res.ts[:, -1], -res.ps[:, 0], res.ps[:, -1]
