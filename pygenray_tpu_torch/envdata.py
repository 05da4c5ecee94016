"""Environment data for the ray engine, as torch tensors.

Counterpart of ``pygenray_tpu/envdata.py``.  ``EnvData`` is a frozen
dataclass of tensors: sound speed and its depth-derivative as 2D tables,
bathymetry and bottom angles, plus the optional Chebyshev "spectral
profile" coefficients, their guarded monomial re-expression
(``c_pow``/``dcdz_pow``, evaluated with Horner when ``poly_ok``) and the
piecewise-segment tables.  Static metadata (uniform-grid flags, fit
availability, domain bounds) rides as plain Python fields, so the
integrator picks its code path without reading a tensor.

``make_env_data`` is the same host numpy build as the JAX package's, ending
in ``torch.as_tensor(..., dtype, device)``.  It holds data, not trainable
parameters, so it is not an ``nn.Module``; ``EnvData.to(device)`` moves it.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .ops.cheb import fit_profile_cheb, fit_series_cheb
from .ops.interp import cubic_spline_coeffs
from .ops.seg import SEG_S, fit_profile_seg

__all__ = ["EnvData", "make_env_data", "with_spectral", "mirror_env_arrays",
           "mirror_env_data", "host_profile_tables", "env_from_reference",
           "DATA_FIELDS", "META_FIELDS", "resolve_dtype"]

# fit-acceptance tolerances for the spectral fast path; exceeded → the engine
# falls back to the piecewise-SEGMENT fast path (rough fields), and only
# then to exact table interpolation
C_FIT_TOL = 2e-3  # [m/s] systematic sound-speed error << 0.1 ms travel-time budget
CP_FIT_TOL = 5e-4  # [1/s]
BANGLE_FIT_TOL = 1e-3  # [deg]
# segment-fit gates (see ops/seg.py)
C_SEG_MAX_TOL = 0.1  # [m/s]
CP_SEG_MAX_TOL = 0.05  # [1/s]
# escalation rungs: local-monomial (Horner) first, then local-Chebyshev
SEG_ORDER_LADDER = (7, 11, 15, 23)
SEG_CHEB_LADDER = (31, 47, 63, 95)

DATA_FIELDS = (
    "c", "dcdz", "r", "z", "bathy", "bathy_r", "bottom_angle", "bangle_coef",
    "c_cheb", "dcdz_cheb", "bangle_cheb", "c_pow", "dcdz_pow", "c_seg",
    "dcdz_seg",
)
META_FIELDS = (
    "range_dependent", "uniform_z", "uniform_r", "uniform_bathy_r", "has_cheb",
    "bangle_mode", "bangle_const", "z_dom", "r_dom", "bathy_r_dom", "poly_ok",
    "has_seg", "seg_basis",
)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch dtype, a numpy dtype or a name.
    ``None`` means float32: float64 only when the caller asks for it."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}; use float32 or float64")
        return dtype
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name}; use float32 or float64")
    return _DTYPES[name]


def _is_uniform(g: np.ndarray) -> bool:
    if g.shape[0] < 2:
        return False
    d = np.diff(g)
    return bool(np.all(np.abs(d - d[0]) <= 1e-9 * max(abs(g[0]), abs(g[-1]), 1.0)))


def _cheb_dz(coef, zlo, zhi):
    """Exact d/dz of per-station Chebyshev series: (nr, K) -> (nr, K),
    top coefficient zero."""
    import numpy.polynomial.chebyshev as ncheb

    coef = np.asarray(coef, np.float64)
    out = np.zeros_like(coef)
    if coef.shape[-1] > 1:
        out[:, :-1] = ncheb.chebder(coef, scl=2.0 / (zhi - zlo), axis=1)
    return out


def _cheb_table(coef, z):
    """Evaluate per-station series (nr, K) on the depth grid -> (nr, nz)."""
    import numpy.polynomial.chebyshev as ncheb

    u = (2.0 * z - (z[0] + z[-1])) / (z[-1] - z[0])
    return ncheb.chebval(u, np.asarray(coef, np.float64).T)


@dataclasses.dataclass(frozen=True)
class EnvData:
    # canonical tables
    c: torch.Tensor  # (nr, nz) sound speed [m/s]
    dcdz: torch.Tensor  # (nr, nz) [1/s]
    r: torch.Tensor  # (nr,) range grid [m]
    z: torch.Tensor  # (nz,) depth grid [m], increasing
    bathy: torch.Tensor  # (nb,) bottom depth [m]
    bathy_r: torch.Tensor  # (nb,) bathymetry range grid [m]
    bottom_angle: torch.Tensor  # (nb,) bottom slope angle [deg]
    bangle_coef: torch.Tensor  # (nb-1, 4) not-a-knot cubic spline coefficients
    # spectral representation (zeros when has_cheb is False)
    c_cheb: torch.Tensor  # (nr, K)
    dcdz_cheb: torch.Tensor  # (nr, K)
    bangle_cheb: torch.Tensor  # (Kb,)
    # monomial re-expression of the spectral fits (zeros unless poly_ok)
    c_pow: torch.Tensor  # (nr, K)
    dcdz_pow: torch.Tensor  # (nr, K)
    # piecewise-segment representation for rough fields (ops/seg.py)
    c_seg: torch.Tensor  # (nr, Ks, SEG_S)
    dcdz_seg: torch.Tensor  # (nr, Ks, SEG_S)
    # static metadata
    range_dependent: bool
    uniform_z: bool
    uniform_r: bool
    uniform_bathy_r: bool
    has_cheb: bool
    bangle_mode: str  # "const" | "cheb" | "spline"
    bangle_const: float
    z_dom: tuple  # (z[0], z[-1]) as python floats
    r_dom: tuple  # (r[0], r[-1]) as python floats
    bathy_r_dom: tuple  # (bathy_r[0], bathy_r[-1]) as python floats
    poly_ok: bool = False
    has_seg: bool = False
    seg_basis: str = "pow"

    @property
    def nz(self):
        return self.z.shape[0]

    @property
    def nr(self):
        return self.r.shape[0]

    @property
    def device(self) -> torch.device:
        return self.c.device

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    def to(self, device=None, dtype=None) -> "EnvData":
        """A copy with every tensor moved to ``device`` (and cast to
        ``dtype`` when given); metadata is unchanged."""
        dtype = None if dtype is None else resolve_dtype(dtype)
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device=device, dtype=dtype) for f in DATA_FIELDS
        })


def make_env_data(
    c,
    r,
    z,
    bathy,
    bathy_r,
    bottom_angle=None,
    dcdz=None,
    interp: str = "auto",
    cheb_order: int = 47,
    cheb_exact_order: bool = False,
    seg_order: int = 95,
    seg_exact_order: bool = False,
    seg_basis: str = "auto",
    force_range_dependent: bool = False,
    dtype=None,
    device="cuda",
) -> EnvData:
    """Build an ``EnvData`` from host tables.

    Same parameters and host build as ``pygenray_tpu.envdata.make_env_data``
    (``c`` is (nr, nz) or (nz,); ``dcdz`` defaults to ``np.gradient`` along
    depth or ``"consistent"``; ``bottom_angle`` defaults to
    ``degrees(arctan(gradient(bathy)))``; ``interp`` is "table", "cheb",
    "seg" or "auto"), plus ``device``: the tensors are created there (the
    CUDA device unless the caller asks for another, e.g. ``"cpu"``; with no
    card, torch raises).  ``dtype`` defaults to float32.
    """
    c = np.asarray(c, np.float64)
    if c.ndim == 1:
        if r is None:
            raise ValueError(
                "1D c requires an explicit range grid (e.g. two points "
                "spanning the domain, r=[0.0, max_range])"
            )
        r = np.atleast_1d(np.asarray(r, np.float64))
        if r.shape[0] < 2:
            raise ValueError("1D c needs a range grid with at least 2 points")
        c = np.broadcast_to(c, (r.shape[0], c.shape[0])).copy()
    z = np.asarray(z, np.float64)
    r = np.asarray(r, np.float64)
    bathy = np.asarray(bathy, np.float64)
    bathy_r = np.asarray(bathy_r, np.float64)

    # strictly increasing: a duplicated coordinate would later divide by a
    # zero interval and NaN the trace
    if r.shape[0] > 1 and not np.all(np.diff(r) > 0):
        raise ValueError("Sound speed range coordinates must be monotonically increasing.")
    if not np.all(np.diff(z) > 0):
        raise ValueError("Sound speed depth coordinates must be monotonically increasing.")
    if bathy_r.shape[0] > 1 and not np.all(np.diff(bathy_r) > 0):
        raise ValueError("Bathymetry range coordinates must be monotonically increasing.")

    consistent = isinstance(dcdz, str)
    if consistent:
        if dcdz != "consistent":
            raise ValueError(
                f"unknown dcdz mode {dcdz!r}; pass an array, None, or "
                "'consistent'"
            )
        if interp == "table":
            raise ValueError(
                "dcdz='consistent' derives dc/dz from the fitted c "
                "representation; the exact-table path has no smooth c fit "
                "to differentiate — use interp 'auto', 'cheb', or 'seg'."
            )
        # placeholder for shape bookkeeping; replaced by d/dz of the c fit
        dcdz = np.gradient(c, z, axis=1)
    elif dcdz is None:
        dcdz = np.gradient(c, z, axis=1)
    else:
        dcdz = np.asarray(dcdz, np.float64)
    if bottom_angle is None:
        slope = np.gradient(bathy, bathy_r)
        bottom_angle = np.degrees(np.arctan(slope))
    else:
        bottom_angle = np.asarray(bottom_angle, np.float64)

    range_dependent = force_range_dependent or not bool(np.all(c == c[:1]))
    if interp == "seg":
        force_seg = True
        interp = "auto"
    else:
        force_seg = False

    # spectral fit: pick the smallest order meeting tolerance
    has_cheb = False
    c_cheb = np.zeros((c.shape[0], 8))
    dcdz_cheb = np.zeros((c.shape[0], 8))
    if interp in ("auto", "cheb") and not force_seg:
        c_res = cp_res = np.inf
        if cheb_exact_order:
            orders = [cheb_order]
        else:
            ladder = (15, 23, 31, 47, 63, 95, 127, 191, 255)
            orders = [o for o in ladder if o <= cheb_order] or [cheb_order]
        for order in orders:
            order = min(order, len(z) - 1)
            c_cheb_f, c_res = fit_profile_cheb(c, z, order=order)
            if consistent:
                cp_res = 0.0
                if c_res < C_FIT_TOL:
                    has_cheb = True
                    c_cheb = c_cheb_f
                    dcdz_cheb = _cheb_dz(c_cheb, z[0], z[-1])
                    dcdz = _cheb_table(dcdz_cheb, z)
                    break
                continue
            cp_cheb_f, cp_res = fit_profile_cheb(dcdz, z, order=order)
            if c_res < C_FIT_TOL and cp_res < CP_FIT_TOL:
                has_cheb = True
                c_cheb, dcdz_cheb = c_cheb_f, cp_cheb_f
                break
        if interp == "cheb" and not has_cheb:
            raise ValueError(
                f"Chebyshev profile fit residuals too large (c: {c_res:.2e} m/s, "
                f"dc/dz: {cp_res:.2e} 1/s); use interp='table' or 'auto'."
            )

    # monomial-basis guard: Horner halves the hot-path cost but its f32
    # conditioning must be checked per profile
    pow_ok = False
    c_pow = np.zeros_like(c_cheb)
    dcdz_pow = np.zeros_like(dcdz_cheb)
    if has_cheb:
        from .ops.cheb import cheb2poly_matrix, poly_ok as _poly_ok

        pow_ok = (_poly_ok(c_cheb, 0.5 * C_FIT_TOL)
                  and _poly_ok(dcdz_cheb, 0.5 * CP_FIT_TOL))
        if pow_ok:
            M = cheb2poly_matrix(c_cheb.shape[1])
            c_pow = c_cheb @ M.T
            dcdz_pow = dcdz_cheb @ M.T

    # piecewise-segment fit: tried only when the global fit is absent
    has_seg = False
    seg_basis_used = "pow"
    c_seg = np.zeros((c.shape[0], 1, SEG_S))
    dcdz_seg = np.zeros((c.shape[0], 1, SEG_S))
    if not has_cheb and (interp == "auto" or force_seg):
        if seg_exact_order:
            b = seg_basis if seg_basis != "auto" else (
                "pow" if seg_order <= max(SEG_ORDER_LADDER) else "cheb"
            )
            rungs = [(seg_order, b)]
        else:
            rungs = []
            if seg_basis in ("auto", "pow"):
                rungs += [(o, "pow") for o in SEG_ORDER_LADDER if o <= seg_order]
            if seg_basis in ("auto", "cheb"):
                rungs += [(o, "cheb") for o in SEG_CHEB_LADDER if o <= seg_order]
            if not rungs:
                rungs = [(seg_order, "pow" if seg_basis == "pow" else "cheb")]
        c_mr = cp_mr = c_xr = cp_xr = np.inf
        for order, b in rungs:
            c_seg_f, c_mr, c_xr = fit_profile_seg(c, z, order=order, basis=b)
            if consistent:
                cp_mr = cp_xr = 0.0
                if c_mr < C_FIT_TOL and c_xr < C_SEG_MAX_TOL:
                    from .ops.seg import seg_derivative, seg_eval_np

                    has_seg = True
                    seg_basis_used = b
                    c_seg = c_seg_f
                    dcdz_seg = seg_derivative(c_seg, z[0], z[-1], basis=b)
                    dcdz = seg_eval_np(dcdz_seg, z, z[0], z[-1], basis=b)
                    break
                continue
            cp_seg_f, cp_mr, cp_xr = fit_profile_seg(dcdz, z, order=order, basis=b)
            if (c_mr < C_FIT_TOL and cp_mr < CP_FIT_TOL
                    and c_xr < C_SEG_MAX_TOL and cp_xr < CP_SEG_MAX_TOL):
                has_seg = True
                seg_basis_used = b
                c_seg, dcdz_seg = c_seg_f, cp_seg_f
                break
        if force_seg and not has_seg:
            raise ValueError(
                f"segment profile fit residuals too large (c: mean "
                f"{c_mr:.2e}/max {c_xr:.2e} m/s, dc/dz: mean {cp_mr:.2e}/"
                f"max {cp_xr:.2e} 1/s) — this table carries more "
                f"information at its own grid scale than a 128-segment "
                f"order-{rungs[-1][0]} fit can hold within the travel-time "
                f"budget; use interp='table' or 'auto'."
            )

    if consistent and not (has_cheb or has_seg):
        raise ValueError(
            "dcdz='consistent' requires the field to fit the spectral or "
            "segment representation (this table fits neither, so only the "
            "exact-table path remains, which has no smooth c to "
            "differentiate); use the default table-parity dcdz."
        )

    # bottom angle representation
    if bathy_r.shape[0] >= 2:
        bangle_coef = cubic_spline_coeffs(bathy_r, bottom_angle)
    else:
        bangle_coef = np.zeros((1, 4))
    # near-constant detection with tolerance: np.gradient of a flat bottom
    # produces O(1e-15) degree floating-point noise
    if np.ptp(bottom_angle) < 1e-9:
        bangle_mode = "const"
        bangle_const = float(np.mean(bottom_angle))
        bangle_cheb = np.zeros(8)
    else:
        # fit the cubic-spline interpolant with a Chebyshev series; fall back
        # to the spline evaluation if the fit is poor
        from scipy.interpolate import CubicSpline

        cs = CubicSpline(bathy_r, bottom_angle, bc_type="not-a-knot")
        rr = np.linspace(bathy_r[0], bathy_r[-1], max(4 * len(bathy_r), 256))
        kb = min(64, len(rr) - 1)
        bangle_cheb, b_res = fit_series_cheb(rr, cs(rr), kb)
        bangle_const = 0.0
        if b_res < BANGLE_FIT_TOL:
            bangle_mode = "cheb"
        else:
            bangle_mode = "spline"
            bangle_cheb = np.zeros(8)

    dtype = resolve_dtype(dtype)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return EnvData(
        c=dev(c),
        dcdz=dev(dcdz),
        r=dev(r),
        z=dev(z),
        bathy=dev(bathy),
        bathy_r=dev(bathy_r),
        bottom_angle=dev(bottom_angle),
        bangle_coef=dev(bangle_coef),
        c_cheb=dev(c_cheb),
        dcdz_cheb=dev(dcdz_cheb),
        bangle_cheb=dev(bangle_cheb),
        c_pow=dev(c_pow),
        dcdz_pow=dev(dcdz_pow),
        c_seg=dev(c_seg),
        dcdz_seg=dev(dcdz_seg),
        range_dependent=range_dependent,
        uniform_z=_is_uniform(z),
        uniform_r=_is_uniform(r),
        uniform_bathy_r=_is_uniform(bathy_r),
        has_cheb=has_cheb,
        bangle_mode=bangle_mode,
        bangle_const=bangle_const,
        z_dom=(float(z[0]), float(z[-1])),
        r_dom=(float(r[0]), float(r[-1])),
        bathy_r_dom=(float(bathy_r[0]), float(bathy_r[-1])),
        poly_ok=pow_ok,
        has_seg=has_seg,
        seg_basis=seg_basis_used,
    )


def env_from_reference(fields: dict, meta: dict, device="cuda", dtype=None) -> EnvData:
    """Build an ``EnvData`` from another ``EnvData``'s arrays and metadata.

    ``fields`` maps every name in ``DATA_FIELDS`` to an array (for example a
    ``pygenray_tpu`` environment's leaves converted with ``np.asarray``);
    ``meta`` maps every name in ``META_FIELDS`` to its value.  This carries a
    reference environment's exact state across without importing its
    framework.  ``device`` defaults to the CUDA device, ``dtype`` to
    float32.
    """
    missing = [f for f in DATA_FIELDS if f not in fields]
    missing += [m for m in META_FIELDS if m not in meta]
    if missing:
        raise ValueError(f"env_from_reference: missing {missing}")
    dtype = resolve_dtype(dtype)
    tensors = {
        f: torch.tensor(np.ascontiguousarray(fields[f]), dtype=dtype, device=device)
        for f in DATA_FIELDS
    }
    statics = {m: meta[m] for m in META_FIELDS}
    for m in ("z_dom", "r_dom", "bathy_r_dom"):
        statics[m] = tuple(float(v) for v in statics[m])
    statics["bangle_const"] = float(statics["bangle_const"])
    return EnvData(**tensors, **statics)


def with_spectral(env: EnvData, c_cheb, dcdz_cheb) -> EnvData:
    """Replace the spectral coefficients of an environment SAFELY.

    ``dataclasses.replace(env, c_cheb=...)`` alone leaves the derived
    monomial tables (``c_pow``/``dcdz_pow``) stale.  This helper re-runs the
    monomial guard/conversion (host float64) for the new coefficients.
    """
    from .ops.cheb import cheb2poly_matrix, poly_ok as _poly_ok

    to_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    cc = np.asarray(to_np(c_cheb), np.float64)
    cp = np.asarray(to_np(dcdz_cheb), np.float64)
    ok = bool(env.has_cheb) and (_poly_ok(cc.reshape(-1, cc.shape[-1]), 0.5 * C_FIT_TOL)
                                 and _poly_ok(cp.reshape(-1, cp.shape[-1]), 0.5 * CP_FIT_TOL))
    if ok:
        M = cheb2poly_matrix(cc.shape[-1])
        c_pow, dcdz_pow = cc @ M.T, cp @ M.T
    else:
        c_pow, dcdz_pow = np.zeros_like(cc), np.zeros_like(cp)
    dev = lambda a: torch.as_tensor(a, dtype=env.dtype, device=env.device)
    return dataclasses.replace(
        env,
        c_cheb=dev(cc), dcdz_cheb=dev(cp),
        c_pow=dev(c_pow), dcdz_pow=dev(dcdz_pow),
        poly_ok=ok,
    )


def mirror_env_arrays(c, dcdz, r, bathy, bathy_r, bottom_angle):
    """Reflect host environment arrays about the range axis (x' = -x):
    coordinates are negated and reversed so they stay increasing, fields
    are reversed along range, and bottom angles flip sign."""
    return (
        c[::-1, :],
        dcdz[::-1, :],
        -r[::-1],
        bathy[::-1],
        -bathy_r[::-1],
        -bottom_angle[::-1],
    )


_MIRROR_CACHE = {}  # id(env) -> mirrored EnvData; evicted when env is GC'd


def mirror_env_data(env: EnvData) -> EnvData:
    """Mirror an ``EnvData`` about the range axis (x' = -x) so a backwards
    shot integrates forward in the mirrored frame.

    Coordinates negate and reverse, fields reverse along range, bottom
    angles flip sign.  The spectral/segment tables are DEPTH representations
    — mirroring only reverses their station order — while the bottom-angle
    Chebyshev series transforms as β'(u) = -β(-u) (``cheb_mirror``) and the
    spline coefficients are re-expanded about the mirrored knots.  Torch
    has no negative-step slicing, so every reversal is ``torch.flip``.
    Memoized per environment object (weakref-evicted).
    """
    k = id(env)
    got = _MIRROR_CACHE.get(k)
    if got is not None:
        return got

    from .ops.cheb import cheb_mirror

    flip_r = lambda a: torch.flip(a, dims=(0,))
    # not-a-knot spline coefficients about mirrored knots: with
    # L_i = x_{i+1} - x_i and s'(dt') = -s(L_i - dt'), per interval
    # c0' = -(c0 + c1 L + c2 L^2 + c3 L^3), c1' = c1 + 2 c2 L + 3 c3 L^2,
    # c2' = -(c2 + 3 c3 L), c3' = c3 — then reverse the interval order.
    coef = env.bangle_coef
    if env.bathy_r.shape[0] >= 2 and coef.shape[0] == env.bathy_r.shape[0] - 1:
        L = env.bathy_r[1:] - env.bathy_r[:-1]
        c0, c1, c2, c3 = coef[:, 0], coef[:, 1], coef[:, 2], coef[:, 3]
        mirrored_coef = flip_r(torch.stack(
            [
                -(c0 + c1 * L + c2 * L * L + c3 * L * L * L),
                c1 + 2.0 * c2 * L + 3.0 * c3 * L * L,
                -(c2 + 3.0 * c3 * L),
                c3,
            ],
            dim=1,
        ))
    else:
        mirrored_coef = -coef

    got = dataclasses.replace(
        env,
        c=flip_r(env.c),
        dcdz=flip_r(env.dcdz),
        r=-flip_r(env.r),
        bathy=flip_r(env.bathy),
        bathy_r=-flip_r(env.bathy_r),
        bottom_angle=-flip_r(env.bottom_angle),
        bangle_coef=mirrored_coef,
        c_cheb=flip_r(env.c_cheb),
        dcdz_cheb=flip_r(env.dcdz_cheb),
        bangle_cheb=-cheb_mirror(env.bangle_cheb),
        c_pow=flip_r(env.c_pow),
        dcdz_pow=flip_r(env.dcdz_pow),
        c_seg=flip_r(env.c_seg),
        dcdz_seg=flip_r(env.dcdz_seg),
        bangle_const=-env.bangle_const,
        r_dom=(-env.r_dom[1], -env.r_dom[0]),
        bathy_r_dom=(-env.bathy_r_dom[1], -env.bathy_r_dom[0]),
    )
    _MIRROR_CACHE[k] = got
    weakref.finalize(env, _MIRROR_CACHE.pop, k, None)
    return got


_HOST_TABLE_CACHE = {}  # id(env) -> (r, z, c); evicted when the env is GC'd


def host_profile_tables(env) -> tuple:
    """Host float64 numpy copies of ``(r, z, c)`` for launch-angle
    conversions and received-angle bookkeeping, memoized per environment
    object.  The entry holds no reference to the env; a weakref finalizer
    evicts it when the env is garbage-collected, so the id() key can never
    alias a new object."""
    k = id(env)
    got = _HOST_TABLE_CACHE.get(k)
    if got is None:
        got = tuple(
            getattr(env, f).detach().to("cpu", torch.float64).numpy()
            for f in ("r", "z", "c")
        )
        _HOST_TABLE_CACHE[k] = got
        weakref.finalize(env, _HOST_TABLE_CACHE.pop, k, None)
    return got
