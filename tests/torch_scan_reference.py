"""The JAX package's plain reference for the port's tangent tests
(``test_torch_tangent_save.py``, ``test_torch_autograd.py``): ``jax.jvp``
through its scan without Kahan, on one small case, so that in one process
the reference is compiled once for both files.

The case: 32 rays over 20 km of a Munk field (range-independent, or with an
axis that deepens with range) above a flat bottom at 4600 m, dx = 1000 m, 5
save points, float32, the monomial path off (Clenshaw), as in
``tests/test_pallas.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pygenray_tpu as jp
import pygenray_tpu_torch as tp
from pygenray_tpu.integrate import SolverSettings as JSettings, _trace_impl as j_trace_impl
from pygenray_tpu_torch.envdata import DATA_FIELDS, META_FIELDS
from pygenray_tpu_torch.integrate import _plan

X1, DX, NUM_SAVE = 20e3, 1000.0, 5
NR, B = 6, 32
GEOM = (0.0, X1, *_plan(0.0, X1, NUM_SAVE, DX))


@functools.lru_cache(maxsize=None)
def jax_env(kind):
    """The JAX package's environment: ``"ri"`` range-independent, ``"rd"``
    range-dependent."""
    # nz = 1024 fits Munk with 16 Chebyshev terms: the Pallas interpreter's
    # cost grows with the terms it unrolls
    z = np.linspace(0.0, 6000.0, 1024)
    r = np.linspace(0.0, X1, NR)
    c = np.outer(np.ones(NR), jp.munk_ssp(z))
    if kind == "rd":
        c = np.array([jp.munk_ssp(z, sofar_depth=1300 + 0.01 * ri) for ri in r])
    je = jp.make_env_data(c, r, z, np.full(NR, 4600.0), r, dtype=jnp.float32)
    return dataclasses.replace(je, poly_ok=False)


def port_env(je, dtype=torch.float32):
    """The JAX package's environment carried into the port."""
    return tp.env_from_reference({f: np.asarray(getattr(je, f)) for f in DATA_FIELDS},
                                 {m: getattr(je, m) for m in META_FIELDS},
                                 device="cpu", dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jitted():
    s = JSettings(dx=DX, backend="xla", kahan=False)

    @jax.jit
    def f(env, z0, p0, dz0, dp0):
        def g(z, p):
            r = j_trace_impl(env, z, p, GEOM, s)
            return (r.ts, r.zs, r.ps), (r.n_surf, r.n_bott, r.death_code, r.alive_save)

        return jax.jvp(g, (z0, p0), (dz0, dp0), has_aux=True)

    return f


def scan_jvp(env, z0, p0, dp0, dz0):
    """``ts zs ps dts dzs dps n_surf n_bott death_code alive_save`` as numpy:
    the save grids of the JAX package's scan, their tangents for the seed
    ``(dp0, dz0)`` and the integer outputs.  Jitted once per environment
    structure."""
    f32 = lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float32), (B,))
    prim, tang, ints = _jitted()(env, f32(z0), f32(p0), f32(dz0), f32(dp0))
    return [np.asarray(a) for a in (*prim, *tang, *ints)]
