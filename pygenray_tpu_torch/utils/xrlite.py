# Copied from pygenray_tpu/utils/xrlite.py (host-only numpy); tests pin it equal to the original.
"""Minimal labeled-array shim standing in for ``xarray.DataArray``.

The reference package builds its environment API around xarray
(``pygenray/environment.py:14-119``).  xarray is not
available in this environment, so this module provides the small subset of
``DataArray`` behavior the environment layer needs: named dims, 1D
coordinates, ``differentiate`` (second-order central differences via
``np.gradient``), ``isel``, and attribute access to coordinates.

If real xarray is installed it is used instead (see ``DataArray`` export at
the bottom); everything in the package duck-types against the common subset.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LiteDataArray", "DataArray", "is_dataarray"]


class _SizesView(dict):
    pass


class LiteDataArray:
    """A tiny, numpy-backed stand-in for ``xarray.DataArray`` (1D/2D)."""

    def __init__(self, data, dims=None, coords=None, name=None):
        self.values = np.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.values.ndim))
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                f"dims {self.dims} does not match data ndim {self.values.ndim}"
            )
        self.coords = {}
        coords = coords or {}
        for k, v in coords.items():
            arr = v.values if hasattr(v, "values") else np.asarray(v)
            self.coords[k] = LiteCoord(k, arr)
        for d in self.dims:
            if d not in self.coords:
                ax = self.dims.index(d)
                self.coords[d] = LiteCoord(d, np.arange(self.values.shape[ax]))
        self.name = name

    # -- basic protocol -------------------------------------------------
    @property
    def ndim(self):
        return self.values.ndim

    @property
    def shape(self):
        return self.values.shape

    @property
    def sizes(self):
        return _SizesView({d: s for d, s in zip(self.dims, self.values.shape)})

    def __getattr__(self, name):
        coords = self.__dict__.get("coords", {})
        if name in coords:
            return coords[name]
        raise AttributeError(name)

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def __repr__(self):
        return (
            f"LiteDataArray{self.dims} shape={self.values.shape} "
            f"dtype={self.values.dtype}"
        )

    # -- xarray-compatible operations ----------------------------------
    def differentiate(self, coord):
        """Second-order-accurate derivative along ``coord`` (np.gradient)."""
        ax = self.dims.index(coord)
        grad = np.gradient(self.values, self.coords[coord].values, axis=ax)
        return LiteDataArray(grad, dims=self.dims, coords=dict(self.coords))

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        data = self.values
        dims = list(self.dims)
        coords = {k: v.values for k, v in self.coords.items()}
        for dim, idx in indexers.items():
            ax = dims.index(dim)
            if isinstance(idx, slice):  # np.take rejects slices
                sel = [slice(None)] * data.ndim
                sel[ax] = idx
                data = data[tuple(sel)]
                coords[dim] = coords[dim][idx]
                continue
            data = np.take(data, idx, axis=ax)
            if np.isscalar(idx) or np.ndim(idx) == 0:
                dims.pop(ax)
                coords.pop(dim, None)
            else:
                coords[dim] = coords[dim][idx]
        return LiteDataArray(data, dims=tuple(dims), coords=coords)

    def copy(self, deep=True):
        return LiteDataArray(
            self.values.copy() if deep else self.values,
            dims=self.dims,
            coords={k: v.values for k, v in self.coords.items()},
        )

    def plot(self, x=None, y=None, add_colorbar=True, cbar_kwargs=None, **kwargs):
        """Minimal pcolormesh plot matching xarray's plotting call signature."""
        from matplotlib import pyplot as plt

        if self.ndim != 2:
            xs = self.coords[self.dims[0]].values
            return plt.plot(xs, self.values, **kwargs)
        xdim = x or self.dims[0]
        ydim = y or self.dims[1]
        xv = self.coords[xdim].values
        yv = self.coords[ydim].values
        vals = self.values if self.dims == (ydim, xdim) else self.values.T
        kwargs.pop("cmap_label", None)
        mesh = plt.pcolormesh(xv, yv, vals, **kwargs)
        if add_colorbar:
            cbar_kwargs = cbar_kwargs or {}
            plt.colorbar(mesh, **cbar_kwargs)
        return mesh


class LiteCoord:
    """1D coordinate with ``.values`` like an xarray coordinate variable."""

    def __init__(self, name, values):
        self.name = name
        self.values = np.asarray(values)

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def __len__(self):
        return len(self.values)

    def __getitem__(self, k):
        return self.values[k]

    def max(self):
        return self.values.max()

    def min(self):
        return self.values.min()

    def __repr__(self):
        return f"LiteCoord({self.name}, n={len(self.values)})"


def is_dataarray(obj):
    """True for real xarray DataArrays (including subclasses) and for
    LiteDataArray."""
    if isinstance(obj, LiteDataArray):
        return True
    try:
        import xarray

        return isinstance(obj, xarray.DataArray)
    except ImportError:
        # no xarray installed: accept duck-typed lookalikes by name
        return any(
            c.__module__.startswith("xarray") and c.__name__ == "DataArray"
            for c in type(obj).__mro__
        )


try:  # prefer real xarray when present
    from xarray import DataArray  # type: ignore  # noqa: F401
except ImportError:  # pragma: no cover - depends on environment
    DataArray = LiteDataArray
