# Copied from pygenray_tpu/models/ssp.py (host numpy); tests pin it equal to the original.
"""Sound-speed profile models and environment builders.

Convenience constructors for the standard test/benchmark environments used
throughout the reference's test suite
(`pygenray/tests/test_physics.py:25-64`): constant-c, linear
gradient, and Munk profiles, returned as ``OceanEnvironment2D`` objects.
"""

from __future__ import annotations

import numpy as np

from ..environment import OceanEnvironment2D, munk_ssp
from ..utils.xrlite import DataArray

__all__ = ["munk_ssp", "const_env", "linear_gradient_env", "munk_env"]


def _build(c_2d, r, z, bathy_vals):
    ssp = DataArray(c_2d, dims=["range", "depth"], coords={"range": r, "depth": z})
    bathy = DataArray(bathy_vals, dims=["range"], coords={"range": r})
    return OceanEnvironment2D(
        sound_speed=ssp, bathymetry=bathy, flat_earth_transform=False
    )


def const_env(c0=1500.0, z_max=5000.0, r_max=100e3, bathy_depth=4500.0, nz=200, nr=20):
    """Range-independent constant sound-speed environment."""
    z = np.linspace(0.0, z_max, nz)
    r = np.linspace(0.0, r_max, nr)
    return _build(np.full((nr, nz), c0), r, z, np.full(nr, bathy_depth))


def linear_gradient_env(
    c0=1500.0, g=0.05, z_max=5000.0, r_max=100e3, bathy_depth=4500.0, nz=500, nr=50
):
    """Range-independent linear-gradient environment c(z) = c0 + g z."""
    z = np.linspace(0.0, z_max, nz)
    r = np.linspace(0.0, r_max, nr)
    return _build(np.outer(np.ones(nr), c0 + g * z), r, z, np.full(nr, bathy_depth))


def munk_env(r_max=100e3, nr=50, nz=600, bathy_depth=5000.0, sofar_depth=1300.0):
    """Range-independent Munk-profile environment."""
    z = np.linspace(0.0, 6000.0, nz)
    r = np.linspace(0.0, r_max, nr)
    c = munk_ssp(z, sofar_depth=sofar_depth)
    return _build(np.outer(np.ones(nr), c), r, z, np.full(nr, bathy_depth))
