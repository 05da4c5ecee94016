"""pygenray_tpu_torch — 2D ocean-acoustic ray tracing in PyTorch and CUDA.

The PyTorch port of ``pygenray_tpu``: the same public API, conventions and
numbers.  On a CUDA device the forward ray-fan trace runs as a hand-written
CUDA kernel (``csrc/trace_fan.cu``, spectral and segment profiles), the
eigenray search's Newton iterations as a forward-tangent kernel
(``csrc/trace_tangent.cu``), derivatives over the launch parameters
(autograd through ``trace``, arrival amplitudes, impulse responses,
transmission-loss fields) as a save-grid forward-tangent kernel
(``csrc/trace_tangent_save.cu``), and the Monte-Carlo eigenray search over
an ensemble of environments as an ensemble forward-tangent kernel
(``csrc/trace_tangent_ens.cu``), and the travel-time Jacobians and
coefficient gradients of tomography (``adjoint.py``) as coefficient-tangent
kernels (``csrc/trace_coef_tangent.cu``, range-independent and per station);
on the CPU all six run as torch-op step loops.  The entry points build their tensors
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
from .montecarlo import make_env_ensemble, mc_eigenray_times, trace_ensemble
from .adjoint import (
    endpoint_time_gradients,
    fermat_jacobian,
    perturbation_response,
    travel_time_jacobian,
    travel_time_jacobian_2d,
)
from .amplitudes import Arrivals, arrival_amplitudes
from .response import (
    ArrayResponse,
    Response,
    array_response,
    impulse_response,
    received_waveform,
    synthesize_response,
    thorp_attenuation,
)
from .signals import msequence_code, msequence_signal
from .tlfield import TLField, transmission_loss_field
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
from . import models

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
    "make_env_ensemble",
    "trace_ensemble",
    "mc_eigenray_times",
    "travel_time_jacobian",
    "travel_time_jacobian_2d",
    "fermat_jacobian",
    "endpoint_time_gradients",
    "perturbation_response",
    "Arrivals",
    "arrival_amplitudes",
    "Response",
    "ArrayResponse",
    "synthesize_response",
    "impulse_response",
    "array_response",
    "received_waveform",
    "thorp_attenuation",
    "msequence_code",
    "msequence_signal",
    "TLField",
    "transmission_loss_field",
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
