# Copied from pygenray_tpu/environment.py (host numpy); env_data ported to torch.
"""Ocean environment specification (2D).

API-parity layer over the ray engine, mirroring the reference's
``OceanEnvironment2D`` (`pygenray/environment.py:14-215`): an xarray-style
constructor with validation, Munk default profile, WGS-84 flat-earth
transforms, bottom-slope precompute, and plotting.  Works with real xarray
DataArrays when available, else with the bundled
``pygenray_tpu_torch.utils.xrlite.LiteDataArray``.

The tensor-side data (the ``EnvData`` consumed by the integrator) is built
lazily and cached per (flatearth, mirrored, interp, dtype, device) key.
"""

from __future__ import annotations

import numpy as np

import torch

from .envdata import EnvData, make_env_data, mirror_env_arrays, resolve_dtype
from .utils.xrlite import DataArray, is_dataarray

__all__ = [
    "OceanEnvironment2D",
    "munk_ssp",
    "eflat",
    "eflatinv",
    "flat_earth_c",
]


class OceanEnvironment2D:
    """2D ocean acoustic environment: sound speed c(range, depth) + bathymetry.

    Parameters mirror the reference (`environment.py:20-47`): ``sound_speed``
    is a 1D (depth,) or 2D (range, depth) DataArray in m/s; ``bathymetry`` a
    1D (range,) DataArray in m.  Defaults are the reference's code-behavior
    defaults: a range-replicated Munk profile to 100 km, and a bottom sloping
    from 4500 m to 4900 m (the reference docstring claims a flat 5000 m
    bottom but the code slopes — we match the code,
    `environment.py:84-90`).
    """

    def __init__(
        self,
        sound_speed=None,
        bathymetry=None,
        lat=35,
        flat_earth_transform=True,
        verbose=False,
    ):
        self.latitude = lat

        if sound_speed is None:
            z = np.arange(0, 6000, 1)
            c_munk = munk_ssp(z)
            sound_speed = DataArray(
                np.array([c_munk] * 100),
                dims=["range", "depth"],
                coords={"depth": z, "range": np.linspace(0, 100e3, 100)},
            )
        else:
            if not is_dataarray(sound_speed):
                raise TypeError("sound_speed must be an xarray DataArray.")
            if sound_speed.ndim not in (1, 2):
                raise ValueError("sound_speed must be 1D or 2D.")
            if "depth" not in sound_speed.dims:
                raise ValueError("sound_speed must have a 'depth' dimension.")
            if sound_speed.ndim == 2 and "range" not in sound_speed.dims:
                raise ValueError("2D sound_speed must have a 'range' dimension.")

        if bathymetry is None:
            bathymetry = DataArray(
                np.linspace(4500, 4900, 100),
                dims=["range"],
                coords={"range": np.linspace(0, 100e3, 100)},
            )
        else:
            if not is_dataarray(bathymetry):
                raise TypeError("bathymetry must be an xarray DataArray.")
            if bathymetry.ndim != 1:
                raise ValueError("bathymetry must be 1D.")
            if "range" not in bathymetry.dims:
                raise ValueError("bathymetry must have a 'range' dimension.")

        self.sound_speed = sound_speed
        self.dcdz = sound_speed.differentiate("depth").values
        self.bathymetry = bathymetry

        if flat_earth_transform:
            self.flat_earth_transform(lat=lat)

        # bottom slope angle from the (untransformed) bathymetry
        bottom_slope = np.gradient(
            self.bathymetry.values, self.bathymetry.range.values
        )
        bottom_angle_vector = np.degrees(np.arctan(bottom_slope))
        self.bottom_angle = bottom_angle_vector

        import scipy.interpolate

        self.bottom_angle_interp = scipy.interpolate.interp1d(
            self.bathymetry.range.values, bottom_angle_vector, kind="cubic"
        )

        self._envdata_cache = {}

    # ------------------------------------------------------------------
    def flat_earth_transform(self, lat):
        """WGS-84 earth-flattening at a single latitude.

        Stretches depths and scales sound speeds so the spherical-shell
        problem becomes a flat x-z slice (reference `environment.py:121-154`).
        """
        depth = self.sound_speed.depth.values
        depf, _ = eflat(depth, lat)
        c = np.atleast_2d(self.sound_speed.values)
        if self.sound_speed.ndim == 1:
            _, cf = eflat(depth, lat, self.sound_speed.values)
            self.sound_speed_fe = DataArray(
                cf, dims=["depth"], coords={"depth": depf}
            )
        else:
            # dims may be (range, depth) or (depth, range); normalize
            if self.sound_speed.dims[0] == "depth":
                c = self.sound_speed.values.T
            rr = self.sound_speed.range.values
            cf = np.stack([eflat(depth, lat, c[i])[1] for i in range(c.shape[0])])
            self.sound_speed_fe = DataArray(
                cf, dims=["range", "depth"], coords={"range": rr, "depth": depf}
            )

        bathy_flat, _ = eflat(self.bathymetry.values, lat)
        self.bathymetry_fe = DataArray(
            bathy_flat,
            dims=["range"],
            coords={"range": self.bathymetry.range.values},
        )
        # the device-side EnvData cache is keyed on (flatearth, mirrored,
        # interp, dtype) only — re-transforming must drop stale entries
        self._envdata_cache = {}

    def flat_earth_transform_rd(self):
        """Range-dependent earth flattening: per-range latitude coordinate.

        Requires a ``lat`` coordinate on ``sound_speed`` (reference
        `environment.py:156-173`).
        """
        c_fe = flat_earth_c(self.sound_speed, verbose=False)
        self.sound_speed_fe = c_fe
        # .values: __init__ stores dcdz as a plain ndarray; keep the public
        # attribute's type consistent across the transform
        self.dcdz = c_fe.differentiate("depth").values
        self.bathymetry_fe = self.bathymetry.copy(deep=True)
        self._envdata_cache = {}

    # ------------------------------------------------------------------
    def plot(self, ax=None, add_colorbar=True, **kwargs):
        """Sound-speed section with the seafloor masked out in grey.

        Depth increases downward (inverted y axis). Extra keywords style the
        pcolormesh. Returns the axes.
        """
        from matplotlib import pyplot as plt

        ax = plt.gca() if ax is None else ax
        zv = np.asarray(self.sound_speed.depth.values, float)
        if self.sound_speed.ndim == 1:
            # depth-only profile: draw it over the bathymetry's range span
            br = np.asarray(self.bathymetry.range.values, float)
            rv = np.array([br[0], br[-1]])
            field = np.tile(np.asarray(self.sound_speed.values, float), (2, 1)).T
        else:
            rv = np.asarray(self.sound_speed.range.values, float)
            field = np.asarray(self.sound_speed.values, float)
            if self.sound_speed.dims[0] == "range":
                field = field.T  # pcolormesh wants (depth, range)
        mesh = ax.pcolormesh(rv, zv, field, **{"cmap": "viridis", **kwargs})
        if add_colorbar:
            ax.figure.colorbar(mesh, ax=ax, label="sound speed [m/s]")

        # opaque grey from the seafloor down to below the deepest grid point
        seafloor_r = np.asarray(self.bathymetry.range.values, float)
        seafloor_z = np.asarray(self.bathymetry.values, float)
        ax.fill_between(seafloor_r, seafloor_z, zv.max() * 1.1 + 1.0,
                        color="0.65", lw=0)

        ax.set_xlabel("range [m]")
        ax.set_ylabel("depth [m]")
        ax.set_ylim(zv.max(), zv.min())
        return ax

    # ------------------------------------------------------------------
    # device-side data
    # ------------------------------------------------------------------
    def unpack(self, flatearth: bool = True):
        """Plain numpy environment arrays (reference `_unpack_envi` parity,
        `pygenray/launch_rays.py:717-742`).

        Note: like the reference, ``bottom_angles`` always comes from the
        *untransformed* bathymetry.
        """
        if flatearth:
            if not hasattr(self, "sound_speed_fe"):
                raise Exception(
                    "Flat earth transformation has not been applied. Set "
                    "`flat_earth_transform=True` when creating the "
                    "OceanEnvironment2D object."
                )
            ss = self.sound_speed_fe
            bathy = self.bathymetry_fe
        else:
            ss = self.sound_speed
            bathy = self.bathymetry

        cin = np.atleast_2d(np.asarray(ss.values, float))
        zin = np.asarray(ss.depth.values, float)
        if ss.ndim == 1:
            # 1D profile: broadcast over the bathymetry's range span (the
            # reference accepts 1D at construction but cannot shoot with it)
            br = np.asarray(bathy.range.values, float)
            rin = np.array([br[0], br[-1]])
            cin = np.broadcast_to(cin, (2, len(zin))).copy()
        else:
            rin = np.asarray(ss.range.values, float)
            if ss.dims[0] == "depth":
                cin = cin.T
        cpin = np.gradient(cin, zin, axis=1)
        depths = np.asarray(bathy.values, float)
        depth_ranges = np.asarray(bathy.range.values, float)
        bottom_angles = np.asarray(self.bottom_angle, float)
        return cin, cpin, rin, zin, depths, depth_ranges, bottom_angles

    def env_data(
        self, flatearth: bool = True, mirrored: bool = False,
        interp: str = "auto", dtype=None, device="cpu",
    ) -> EnvData:
        """Cached ``EnvData`` for the integrator, with its tensors on
        ``device``.  ``dtype`` defaults to float32 (float64 only when asked
        for)."""
        dtype = resolve_dtype(dtype)
        key = (flatearth, mirrored, interp, str(dtype), str(torch.device(device)))
        if key not in self._envdata_cache:
            cin, cpin, rin, zin, depths, depth_ranges, bottom_angles = self.unpack(flatearth)
            if mirrored:
                cin, cpin, rin, depths, depth_ranges, bottom_angles = mirror_env_arrays(
                    cin, cpin, rin, depths, depth_ranges, bottom_angles
                )
            self._envdata_cache[key] = make_env_data(
                cin,
                rin,
                zin,
                depths,
                depth_ranges,
                bottom_angle=bottom_angles,
                dcdz=cpin,
                interp=interp,
                dtype=dtype,
                device=device,
            )
        return self._envdata_cache[key]


# ---------------------------------------------------------------------------
# profiles and transforms
# ---------------------------------------------------------------------------


def munk_ssp(z, sofar_depth=1300, eps=0.00737):
    """Canonical Munk sound-speed profile (reference `environment.py:218-236`)."""
    zh = 2 * (np.asarray(z) - sofar_depth) / sofar_depth
    return 1500 * (1 + eps * (zh - 1 + np.exp(-zh)))


def _wgs84_radius(lat):
    """Local earth radius used by the flat-earth transform (WGS-84)."""
    wgsa = 6378137.0
    wgsb = 6356752.314
    wgsfact = (wgsb / wgsa) ** 4
    a2 = wgsa * wgsa
    b2 = wgsb * wgsb
    ll = np.pi * np.asarray(lat, float) / 180.0
    cos2 = np.cos(ll) ** 2
    sin2 = np.sin(ll) ** 2
    ree1 = a2 / np.sqrt(a2 * cos2 + b2 * sin2)
    return ree1 * np.sqrt(cos2 + wgsfact * sin2)


def eflat(dep, lat, cs=None):
    """Flat-earth transform: stretched depth + scaled sound speed.

    ``depf = dep (1 + E(1/2 + E/3))``, ``csf = cs (1 + E(1 + E))`` with
    ``E = dep / re(lat)`` (reference `environment.py:371-401`).
    """
    dep = np.asarray(dep, float)
    if cs is None:
        cs = np.zeros_like(dep)
    cs = np.asarray(cs, float)
    re = _wgs84_radius(lat)
    E = dep / re
    depf = dep * (1.0 + E * (0.5 + E / 3.0))
    csf = cs * (1.0 + E * (1.0 + E))
    return depf, csf


def eflatinv(depf, lat, csf=None):
    """Inverse flat-earth transform via vectorized Ridder root-finding.

    Solves ``eflat(dep) = depf`` elementwise with a bracket fallback and a
    series approximation if bracketing fails (reference
    `environment.py:404-470`).
    """
    depf = np.reshape(np.asarray(depf, float), (-1,))
    lat = np.reshape(np.asarray(lat, float), (-1,))
    if csf is None:
        csf = np.zeros(depf.shape)
    csf = np.reshape(np.asarray(csf, float), (-1,))

    re = _wgs84_radius(lat)
    zacc = 0.001 * np.ones(depf.shape)

    def f(x, latv):
        return eflat(x, latv)[0]

    try:
        dep = _ridder(f, depf * 0.5, depf.copy(), depf, zacc, lat)[0]
    except ValueError:
        try:
            dep = _ridder(f, depf * 0.1, depf.copy(), depf, zacc, lat)[0]
        except ValueError:
            dep = depf / (1.0 + 0.5 * (depf / re) + (depf / re) ** 2 / 3.0)

    E = dep / re
    cs = csf / (1.0 + E * (1.0 + E))
    return dep, cs


def _ridder(fhdl, xl, xh, xrhs, xacc, *args):
    """Vectorized (elementwise) Ridder's method solving ``f(x) = xrhs``."""
    xl = np.array(xl, float)
    xh = np.array(xh, float)
    fl = fhdl(xl, *args) - xrhs
    fh = fhdl(xh, *args) - xrhs
    if np.any(fl * fh > 0):
        raise ValueError("root must be bracketed")

    x = (xl + xh) / 2
    fx = fhdl(x, *args) - xrhs
    for _ in range(200):
        xm = (xl + xh) / 2
        fm = fhdl(xm, *args) - xrhs
        dnm = np.sqrt(np.maximum(fm * fm - fl * fh, 0.0))
        # elements with a vanishing denominator have converged (fm == 0 or
        # the bracket collapsed): FREEZE them and keep iterating the rest —
        # an early return here would hand every other element its current
        # mid-bracket guess (verified: a single exact element corrupted the
        # whole batch by up to 25%)
        done = dnm == 0
        x = np.where(fm == 0, xm, x)  # exact midpoint root
        if np.all(done):
            return x, fhdl(x, *args) - xrhs
        safe_dnm = np.where(done, 1.0, dnm)
        xnew = np.where(
            done, x, xm + (xm - xl) * np.sign(fl - fh) * fm / safe_dnm
        )
        if np.all(np.abs(xnew - x) <= xacc):
            return xnew, fhdl(xnew, *args) - xrhs
        x = xnew
        fnew = fhdl(x, *args) - xrhs
        fx = fnew
        if np.all(fnew == 0):
            return x, fx

        ind = fnew * fm < 0
        xl = np.where(ind, xm, xl)
        fl = np.where(ind, fm, fl)
        xh = np.where(ind, xnew, xh)
        fh = np.where(ind, fnew, fh)

        ind = fnew * fh < 0
        xl = np.where(ind, xnew, xl)
        fl = np.where(ind, fnew, fl)

        ind = fnew * fl < 0
        xh = np.where(ind, xnew, xh)
        fh = np.where(ind, fnew, fh)

        if np.all(np.abs(xh - xl) <= xacc):
            return x, fx
    return x, fx


def flat_earth_c(c, verbose: bool = False, n_cpus: int = None, chunk_size: int = None):
    """Range-dependent flat-earth transform of a 2D sound-speed field.

    The reference chunks range columns across a process pool
    (`environment.py:239-368`); the per-column work is pure array math, so
    here it is simply vectorized — ``n_cpus``/``chunk_size`` are accepted
    for API compatibility and ignored.

    ``c`` must have dims (depth, range) or (range, depth) and 1D coords
    ``depth``, ``range`` and a per-range ``lat`` coordinate.
    """
    depth = np.asarray(c.depth.values, float)
    lats = np.asarray(c.lat.values, float)
    rr = np.asarray(c.range.values, float)
    vals = np.asarray(c.values, float)
    if c.dims[0] == "depth":
        vals = vals.T  # (range, depth)

    out = np.empty_like(vals)
    for k in range(vals.shape[0]):
        depf, cf = eflat(depth, lats[k], vals[k])
        out[k] = np.interp(depth, depf, cf)

    dims = ("range", "depth") if c.dims[0] != "depth" else ("depth", "range")
    data = out if dims == ("range", "depth") else out.T
    return DataArray(
        data,
        dims=dims,
        coords={"range": rr, "depth": depth, "lat": lats},
    )
