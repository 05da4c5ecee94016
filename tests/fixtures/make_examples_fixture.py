"""Write ``examples_jax.npz``: the JAX package's answers that
``tests/test_torch_examples.py`` holds the port's two rewritten demos to
(their JAX compiles cost more than the rest of that file).

Run from the repository root on a CPU (a few minutes: the JAX compiles):

    JAX_PLATFORMS=cpu python tests/fixtures/make_examples_fixture.py

The cases are the test's own (``LOC``, ``LOC_DEAD``, ``GINV`` and the
tables built from them, imported from the test module, so the two cannot
drift apart), in float64 but for ``localization_dead``:

* ``localization/*`` — ``examples/localization_demo.py``'s Gauss-Newton
  Jacobian: the endpoints ``t_end``, ``z_end`` of ``trace`` and the columns
  ``dt_dz0``, ``dz_dz0`` (``jax.jvp`` seeded in z0) and ``dt_dp0``,
  ``dz_dp0`` (seeded with ones in p0), on the demo's field;
* ``localization_dead/*`` — the same where rays die, float32 on the JAX
  package's kernel path (``backend="pallas"``, in interpret mode): the
  endpoints, the four columns by the JAX demo's two seeded ``jax.jvp``
  calls, and the rays' death codes;
* ``gradient_inversion/*`` — ``examples/gradient_inversion_demo.py``'s
  misfit ``value`` and ``grad`` by ``jax.value_and_grad`` through
  ``travel_times_of_coef``, at the background fit ``cc0`` moved by the
  test's seeded shift, and ``cc0`` itself.

The parameters are stored beside the results (``params``, JSON), and each
test checks them against its own before it reads the answers.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
sys.path.insert(0, str(HERE.parent))  # the tests
OUT = HERE / "examples_jax.npz"


def params():
    """The test parameters the answers depend on, as the test defines them."""
    from torch_fixtures import _plain

    import test_torch_examples as ex

    return {"localization": _plain(ex.LOC), "localization_dead": _plain(ex.LOC_DEAD),
            "gradient_inversion": _plain(ex.GINV)}


def localization():
    import jax
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import test_torch_examples as ex
    from pygenray_tpu.integrate import SolverSettings, trace

    P = ex.LOC
    z, c1d, p0 = ex.loc_tables()
    nr, r_max = 8, 50e3  # the demo's build_env
    r = np.linspace(0.0, r_max, nr)
    env = jp.make_env_data(np.outer(np.ones(nr), c1d), r, z, np.full(nr, 5500.0), r,
                           cheb_order=63, cheb_exact_order=True, dtype=jnp.float64)
    s = SolverSettings(dx=200.0, interp="cheb")

    def endpoints(z0, p0):
        res = trace(env, z0, p0, 0.0, P["x1"], 2, s)
        return res.ts[:, -1], res.zs[:, -1]

    z0, p0 = jnp.float64(P["z0"]), jnp.asarray(p0, jnp.float64)
    (t_end, z_end), (dt_dz0, dz_dz0) = jax.jvp(endpoints, (z0, p0),
                                               (jnp.float64(1.0), jnp.zeros_like(p0)))
    _, (dt_dp0, dz_dp0) = jax.jvp(endpoints, (z0, p0), (jnp.float64(0.0), jnp.ones_like(p0)))
    cols = dict(t_end=t_end, z_end=z_end, dt_dz0=dt_dz0, dz_dz0=dz_dz0, dt_dp0=dt_dp0,
                dz_dp0=dz_dp0)
    return {f"localization/{k}": np.asarray(v) for k, v in cols.items()}


def localization_dead():
    import jax
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import test_torch_examples as ex
    from pygenray_tpu.integrate import SolverSettings, trace

    P = ex.LOC_DEAD
    z = np.linspace(0.0, 6000.0, P["nz"])
    c1d = jp.munk_ssp(z)
    c_src = float(np.interp(P["z0"], z, c1d))
    nr, r_max = 8, 50e3  # the demo's build_env
    r = np.linspace(0.0, r_max, nr)
    env = jp.make_env_data(np.outer(np.ones(nr), c1d), r, z, np.full(nr, 5500.0), r,
                           cheb_order=63, cheb_exact_order=True, dtype=jnp.float32)
    s = SolverSettings(dx=200.0, interp="cheb", backend="pallas")

    def endpoints(z0, p0):
        res = trace(env, z0, p0, 0.0, P["x1"], 2, s)
        return res.ts[:, -1], res.zs[:, -1]

    z0 = jnp.float32(P["z0"])
    p0 = jnp.asarray(np.asarray(P["c_p0"]) / c_src, jnp.float32)
    # the JAX demo's two seeded calls
    (t_end, z_end), (dt_dz0, dz_dz0) = jax.jvp(endpoints, (z0, p0),
                                               (jnp.float32(1.0), jnp.zeros_like(p0)))
    _, (dt_dp0, dz_dp0) = jax.jvp(endpoints, (z0, p0), (jnp.float32(0.0), jnp.ones_like(p0)))
    death = trace(env, z0, p0, 0.0, P["x1"], 2, s).death_code
    cols = dict(t_end=t_end, z_end=z_end, dt_dz0=dt_dz0, dz_dz0=dz_dz0, dt_dp0=dt_dp0,
                dz_dp0=dz_dp0, death_code=death)
    return {f"localization_dead/{k}": np.asarray(v) for k, v in cols.items()}


def gradient_inversion():
    import jax
    import jax.numpy as jnp

    import pygenray_tpu as jp
    import test_torch_examples as ex
    from pygenray_tpu.adjoint import travel_times_of_coef
    from pygenray_tpu.integrate import SolverSettings

    P = ex.GINV
    z, r, dc_true, angles, shift = ex.ginv_tables()
    src = 1300.0  # the demo's SRC

    def build(dc_rz):  # the demo's build, float64
        c = np.outer(np.ones(len(r)), jp.munk_ssp(z)) + dc_rz
        return jp.make_env_data(c, r, z, np.full(len(r), 5500.0), r, dtype=jnp.float64,
                                cheb_order=P["K"] - 1, cheb_exact_order=True,
                                force_range_dependent=True, dcdz="consistent")

    env_true, env0 = build(dc_true), build(0.0 * dc_true)
    s = SolverSettings(dx=P["dx"], interp="cheb", kahan=False)
    c_src = np.interp(src, z, np.asarray(env0.c[0]))
    p0 = np.sin(np.radians(-angles)) / c_src
    T_obs = travel_times_of_coef(env_true, src, p0, 0.0, P["r_max"], s)(env_true.c_cheb)
    f = travel_times_of_coef(env0, src, p0, 0.0, P["r_max"], s)
    cc0 = env0.c_cheb

    def misfit(cc):
        d = f(cc) - T_obs
        return 0.5 * jnp.sum(d * d) + P["lam"] * jnp.sum((cc - cc0) ** 2)

    val, g = jax.value_and_grad(misfit)(cc0 + jnp.asarray(shift))
    return {"gradient_inversion/value": np.asarray(val), "gradient_inversion/grad": np.asarray(g),
            "gradient_inversion/cc0": np.asarray(cc0)}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    out = {"params": np.array(json.dumps(params())), **localization(), **localization_dead(),
           **gradient_inversion()}
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
