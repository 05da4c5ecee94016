"""pygenray_tpu_torch — 2D ocean-acoustic ray tracing in PyTorch and CUDA.

The PyTorch port of ``pygenray_tpu``: the same public API, conventions and
numbers.  On a CUDA device the forward ray-fan trace runs as a hand-written
CUDA kernel (``csrc/trace_fan.cu``) and the eigenray search's Newton
iterations as a forward-tangent kernel (``csrc/trace_tangent.cu``); on the
CPU both run as torch-op step loops.  The entry points build their tensors
on the CUDA device unless the caller passes ``device="cpu"``.  This package
imports torch, numpy and scipy, never jax.

Flat public namespace: the subset of ``pygenray_tpu``'s that this port
provides so far.
"""

from .environment import (
    OceanEnvironment2D,
    eflat,
    eflatinv,
    flat_earth_c,
    munk_ssp,
)
from .envdata import EnvData, env_from_reference, make_env_data, with_spectral
from .integrate import DEATH_CODES, SolverSettings, TraceResult, trace
from .shoot import shoot_ray, shoot_rays, settings_for
from .eigenrays import find_eigenrays, find_eigenrays_batch
from .ray_objects import EigenRays, Ray, RayFan
from .ops.host import (
    bilinear_np,
    bottom_bounce,
    derivs_np,
    linear_np,
    ray_angle_np,
    ray_bounding_box_event,
    surface_bounce,
    vertical_ray,
)
from .ops.interp import bilinear_interp, linear_interp
from .utils.xrlite import DataArray, LiteDataArray

# reference-compatible kernel aliases
derivsrd = derivs_np
ray_angle = ray_angle_np

__version__ = "0.1.0"

__all__ = [
    "OceanEnvironment2D",
    "munk_ssp",
    "eflat",
    "eflatinv",
    "flat_earth_c",
    "EnvData",
    "make_env_data",
    "with_spectral",
    "env_from_reference",
    "SolverSettings",
    "TraceResult",
    "DEATH_CODES",
    "trace",
    "shoot_ray",
    "shoot_rays",
    "settings_for",
    "find_eigenrays",
    "find_eigenrays_batch",
    "Ray",
    "RayFan",
    "EigenRays",
    "bilinear_interp",
    "linear_interp",
    "bilinear_np",
    "linear_np",
    "derivs_np",
    "derivsrd",
    "ray_angle",
    "surface_bounce",
    "bottom_bounce",
    "vertical_ray",
    "ray_bounding_box_event",
    "ray_angle_np",
    "DataArray",
    "LiteDataArray",
]
