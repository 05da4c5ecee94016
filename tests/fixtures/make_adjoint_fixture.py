"""Write ``adjoint_jax_f32.npz``: the JAX package's adjoint answers, for the
PyTorch port's tests (``tests/test_torch_adjoint.py``) and for
``chip_smoke.py`` to hold the port to on a CUDA card (that machine has no
JAX).

Run from the repository root on a CPU (about ten minutes; the two Pallas
kernels run in interpret mode):

    JAX_PLATFORMS=cpu python tests/fixtures/make_adjoint_fixture.py

Every environment is rebuilt from the stored parameters by each package's
own ``make_env_data``, float32.  The fan is 8 rays over ±24° from 1300 m to
20 km at dx = 1 km (20 steps), over a flat 4600 m bottom, so the steep rays
bounce off the surface and the bottom:

* ``ri`` — a range-independent Munk profile (nz = 400, 4 stations, the
  default fit: 24 Chebyshev terms): ``travel_time_jacobian`` with
  ``mode="kernel"`` (the coefficient-tangent kernel, B5, interpreted) and
  ``mode="fwd"`` (``jax.jacfwd`` through the scan), T (B,) and J (B, K);
* ``rd`` — a range-dependent Munk field (its axis deepens 10 m per km, 4
  stations): ``travel_time_jacobian_2d`` with ``mode="kernel"`` (B6) and
  ``mode="fwd"``, J (B, nr, K);
* ``vjp_ri`` / ``vjp_rd`` — ``travel_time_coef_vjp`` with the cotangent
  ``V`` (``jax.vjp`` through the scan on a CPU);
* ``fermat_ri`` / ``fermat_rd`` — ``fermat_jacobian`` (41 saves), and
  ``perturbation_response`` of the ``ri`` operator to a Gaussian
  perturbation; ``fermat_seg`` — on a rough field's segment fit (the JAX
  tests' ripple recipe, nz = 1500, range-independent, dx = 250 m);
* ``endpoint`` — ``endpoint_time_gradients`` on the ``rd`` field.

The Fermat and endpoint traces run twice: on the Chebyshev (Clenshaw)
series, ``poly_ok`` off, as the Jacobians do, and on the default fit as
``make_env_data`` gives it (``poly_ok``: the monomial, Horner, series; the
``*_horner`` keys).  In float32 the Horner series of these fits rounds
differently in the two packages near the top of the depth domain (XLA
contracts multiply-adds, the port does not), and the surface-reflected
rays' travel times part by about 1e-4 s there (ROADMAP §C); the port's
tests and ``chip_smoke.py`` hold the ``*_horner`` answers at the bounds
that gap reads: the default series, the one users get, is held to the
reference, and the gap cannot grow unseen.

``--probe-f32`` prints, instead of writing the fixture, each package's
|T_f32 - T_f64| per ray on the ``ri`` field with either series (Kahan
off), the measurement behind that gap, and the port's Fermat and endpoint
answers on the default fit against the JAX package's (float32), what those
bounds were read from:

    JAX_PLATFORMS=cpu python tests/fixtures/make_adjoint_fixture.py --probe-f32
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))  # the repository root
OUT = HERE / "adjoint_jax_f32.npz"

PARAMS = {
    "nz": 400, "nr": 4, "r_max": 20e3, "bathy": 4600.0, "rd_slope": 0.01,
    "fan": [-24.0, 24.0, 8], "source_depth": 1300.0, "c_src": 1500.0, "dx": 1000.0,
    "fermat_saves": 41, "v": [1.0, -0.5, 0.25, 2.0, -1.0, 0.5, -2.0, 1.5],
    "pert": {"depth": 1000.0, "width": 300.0, "amp": 2.0},
    "seg": {"nz": 1500, "seed": 7, "bathy": 5500.0, "dx": 250.0, "fan": [-9.0, 5.0]},
}


def tables(P, munk_ssp, rd):
    """(c, r, z, bathy, bathy_r) of the ``ri`` or ``rd`` field."""
    z = np.linspace(0.0, 6000.0, P["nz"])
    r = np.linspace(0.0, P["r_max"], P["nr"])
    if rd:
        c = np.array([munk_ssp(z, sofar_depth=1300.0 + P["rd_slope"] * ri) for ri in r])
    else:
        c = np.outer(np.ones(P["nr"]), munk_ssp(z))
    return c, r, z, np.full(P["nr"], P["bathy"]), r


def rough_tables(P, munk_ssp):
    """The JAX tests' rough profile (``tests/test_adjoint.py``'s
    ``_rough_env``): Munk plus a ripple of four wavelengths decaying with
    depth, range-independent over 6 stations."""
    S = P["seg"]
    rng = np.random.default_rng(S["seed"])
    z = np.linspace(0.0, 6000.0, S["nz"])
    ripple = np.zeros_like(z)
    for lam in (30.0, 55.0, 90.0, 160.0):
        ripple += rng.normal(0, 0.8) * np.sin(2 * np.pi * z / lam + rng.uniform(0, 2 * np.pi))
    c1 = munk_ssp(z) + ripple * np.exp(-z / 2500.0)
    r = np.linspace(0.0, P["r_max"], 6)
    return np.outer(np.ones(6), c1), r, z, np.full(6, S["bathy"]), r


def launch_p0(P):
    return (np.sin(np.radians(-np.linspace(*P["fan"][:2], int(P["fan"][2])))) / P["c_src"]
            ).astype(np.float32)


def perturbation(P, z):
    g = P["pert"]
    return g["amp"] * np.exp(-(((z - g["depth"]) / g["width"]) ** 2))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pygenray_tpu import adjoint as adj
    from pygenray_tpu.envdata import make_env_data
    from pygenray_tpu.environment import munk_ssp
    from pygenray_tpu.integrate import SolverSettings

    P = PARAMS
    out = {"params": np.array(json.dumps(P))}
    p0 = launch_p0(P)
    zs, x1 = P["source_depth"], P["r_max"]
    s_k = SolverSettings(dx=P["dx"], backend="pallas", kahan=False)
    s = SolverSettings(dx=P["dx"])
    v = np.asarray(P["v"], np.float32)
    for name, rd in (("ri", False), ("rd", True)):
        env_h = make_env_data(*tables(P, munk_ssp, rd), dtype=jnp.float32)  # the default fit
        env = dataclasses.replace(env_h, poly_ok=False)
        assert env.range_dependent == rd and env.has_cheb and env_h.poly_ok
        jac = adj.travel_time_jacobian_2d if rd else adj.travel_time_jacobian
        for mode in ("kernel", "fwd"):
            T, J = jac(env, zs, p0, 0.0, x1, s_k, mode=mode)
            out[f"{name}/{mode}/T"] = np.asarray(T)
            out[f"{name}/{mode}/J"] = np.asarray(J)
            print(name, mode, np.asarray(J).shape, flush=True)
        T, g = adj.travel_time_coef_vjp(env, zs, p0, 0.0, x1, v, s)
        out[f"vjp_{name}/T"], out[f"vjp_{name}/g"] = np.asarray(T), np.asarray(g)
        for series, e in (("", env), ("_horner", env_h)):
            T, G = adj.fermat_jacobian(e, zs, p0, 0.0, x1, s, num_save=P["fermat_saves"])
            out[f"fermat_{name}{series}/T"] = np.asarray(T)
            out[f"fermat_{name}{series}/G"] = np.asarray(G)
            if not rd:
                out[f"pert{series}/dT"] = np.asarray(adj.perturbation_response(
                    G, e, perturbation(P, np.asarray(e.z))))
            else:
                T, d_src, d_rcv = adj.endpoint_time_gradients(e, zs, p0, 0.0, x1, s)
                for k, a in (("T", T), ("dT_dz_src", d_src), ("dT_dz_rcv", d_rcv)):
                    out[f"endpoint{series}/{k}"] = np.asarray(a)
    S = P["seg"]
    env = make_env_data(*rough_tables(P, munk_ssp), interp="seg", dtype=jnp.float32)
    assert env.has_seg and not env.has_cheb
    p0s = (np.sin(np.radians(-np.asarray(S["fan"]))) / P["c_src"]).astype(np.float32)
    T, G = adj.fermat_jacobian(env, zs, p0s, 0.0, x1, SolverSettings(dx=S["dx"], interp="seg"),
                               num_save=P["fermat_saves"])
    out["fermat_seg/T"], out["fermat_seg/G"] = np.asarray(T), np.asarray(G)
    print("fermat_seg", np.asarray(G).shape, flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


def probe_f32():
    """|T_f32 - T_f64| per ray on the ``ri`` field, by package and series."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import pygenray_tpu as jpkg
    import pygenray_tpu_torch as tpkg

    P = PARAMS

    def end_times(pkg, dtype, poly_ok, **kw):
        f64 = dtype in (jnp.float64, torch.float64)
        env = pkg.make_env_data(*tables(P, pkg.munk_ssp, False), dtype=dtype, **kw)
        env = dataclasses.replace(env, poly_ok=poly_ok and env.poly_ok)
        p0 = launch_p0(P).astype(np.float64 if f64 else np.float32)
        res = pkg.trace(env, P["source_depth"], p0, 0.0, P["r_max"], 2,
                        pkg.SolverSettings(dx=P["dx"], kahan=False))
        ts = res.ts[:, -1]
        return np.asarray(ts.cpu() if hasattr(ts, "cpu") else ts, np.float64)

    for name, pkg, f32, f64, kw in (
        ("pygenray_tpu", jpkg, jnp.float32, jnp.float64, {}),
        ("pygenray_tpu_torch", tpkg, torch.float32, torch.float64, {"device": "cpu"}),
    ):
        for series, poly in (("horner", True), ("clenshaw", False)):
            err = np.abs(end_times(pkg, f32, poly, **kw) - end_times(pkg, f64, poly, **kw))
            print(f"{name} {series}: |T_f32 - T_f64| per ray [s]:",
                  np.array2string(err, precision=2))

    # the port against the JAX package on the default (Horner) fit, float32:
    # the gap the port's tests hold at their TOL_*_HORNER bounds
    from pygenray_tpu import adjoint as jadj
    from pygenray_tpu_torch import adjoint as tadj

    p0, n = launch_p0(P), P["fermat_saves"]
    for name, rd in (("ri", False), ("rd", True)):
        e_t = tpkg.make_env_data(*tables(P, tpkg.munk_ssp, rd), dtype=torch.float32, device="cpu")
        e_j = jpkg.make_env_data(*tables(P, jpkg.munk_ssp, rd), dtype=jnp.float32)
        args = (P["source_depth"], p0, 0.0, P["r_max"])
        T, G = tadj.fermat_jacobian(e_t, *args, tpkg.SolverSettings(dx=P["dx"]), num_save=n)
        Tj, Gj = (np.asarray(a) for a in jadj.fermat_jacobian(
            e_j, *args, jpkg.SolverSettings(dx=P["dx"]), num_save=n))
        print(f"horner {name}: fermat |dT| per ray [s]:",
              np.array2string(np.abs(np.asarray(T) - Tj), precision=2),
              f"max |dG| / max |G|: {np.abs(np.asarray(G) - Gj).max() / np.abs(Gj).max():.2e}")
        if rd:
            got = tadj.endpoint_time_gradients(e_t, *args, tpkg.SolverSettings(dx=P["dx"]),
                                               num_save=n)
            want = jadj.endpoint_time_gradients(e_j, *args, jpkg.SolverSettings(dx=P["dx"]),
                                                num_save=n)
            print("horner rd: endpoint max |dT| [s], |d dT/dz_src|, |d dT/dz_rcv| [s/m]:",
                  *(f"{np.abs(a.numpy() - np.asarray(b)).max():.2e}" for a, b in zip(got, want)))


if __name__ == "__main__":
    probe_f32() if "--probe-f32" in sys.argv[1:] else main()
