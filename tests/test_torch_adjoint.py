"""The adjoint operators of the port (``pygenray_tpu_torch/adjoint.py``) and
the plain versions of its two coefficient-tangent kernels, on a CPU.

* The coefficient-tangent traces (B5 ``integrate._trace_coef_tangent_impl``
  and B6 ``_trace_coef_tangent_rd_impl``, through ``travel_time_jacobian`` /
  ``_2d`` with ``mode="kernel"``) against the JAX package's Pallas kernels
  in interpret mode and its ``jax.jacfwd`` Jacobians, stored by
  ``tests/fixtures/make_adjoint_fixture.py`` in ``adjoint_jax_f32.npz``
  (float32; 8 rays over ±24° to 20 km at dx = 1 km, some bouncing): T
  within 1e-4 s, J within 2e-3 (range-independent) and 3e-3
  (range-dependent) of its largest entry, the JAX tests' own bounds
  (``tests/test_adjoint.py``).
* The ``torch.func`` fallback (``mode="fwd"`` / ``"rev"``: ``jacfwd`` /
  ``jacrev`` over the torch-op loop with respect to the coefficient table)
  against the same fixture and the plain versions.
* In float64, the plain versions against central differences of the
  torch-op loop on a bottom-bouncing fan (rtol 1e-5, the JAX test's).
* The wrappers on CPU tensors (plain version, no launch counted), the
  Clenshaw guard for ``poly_ok`` environments, the primal's lockstep with
  the final-state tangent trace, the station-sum identity, the
  vector-Jacobian product (chunked through the kernel wrappers, and the
  float64 autograd fallback), the Fermat operator, the perturbation
  response and the endpoint gradients live against the JAX package (on the
  Clenshaw series, and on the default Horner series at the bounds its
  float32 gap reads), and the errors.

The kernels themselves (``csrc/trace_coef_tangent.cu``) run only on a card;
``chip_smoke.py`` holds them to these plain versions there.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import pygenray_tpu as jp
import pygenray_tpu.adjoint as jadj
import pygenray_tpu_torch as pt
import pygenray_tpu_torch.adjoint as adj
from pygenray_tpu_torch.integrate import (
    SolverSettings, _plan, _trace_coef_tangent_impl, _trace_coef_tangent_rd_impl, _trace_impl,
    _trace_tangent_impl,
)
from pygenray_tpu_torch.ops import stepper
from torch_fixtures import one_blas_thread  # noqa: F401

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
_spec = importlib.util.spec_from_file_location("make_adjoint_fixture",
                                               FIXTURES / "make_adjoint_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)
P = F.PARAMS
X1, Z0 = P["r_max"], P["source_depth"]
TOL_T = 1e-4  # s
TOL_J = {"ri": 2e-3, "rd": 3e-3}  # of the largest entry
# a bottom-bouncing fan for the float64 finite differences
BOUNCE_ANGLES = np.linspace(-30.0, 30.0, 7)
# The default fit (poly_ok: the monomial, Horner, series) in float32: the two
# packages round it apart near the top of the depth domain, and this fan's
# surface-reflected rays part by up to 1.3e-4 s (range-independent) and
# 7.5e-5 s (range-dependent) on a CPU (ROADMAP §C).  Held at the bounds that
# gap reads, so the default series is held to the reference and the gap
# cannot grow unseen.
TOL_T_HORNER = 2e-4  # s
TOL_G_HORNER = 5e-4  # of the largest entry (3.2e-4 read, range-dependent)
TOL_GRAD_HORNER = 5e-8  # s/m (1.3e-8 read)


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURES / "adjoint_jax_f32.npz"))


def _env(kind, dtype=torch.float32, **kw):
    return pt.make_env_data(*F.tables(P, pt.munk_ssp, kind == "rd"), dtype=dtype, device="cpu",
                            **kw)


@pytest.fixture(scope="module")
def envs():
    return {"ri": _env("ri"), "rd": _env("rd")}


def _s(**kw):
    return SolverSettings(dx=P["dx"], **kw)


def _geom():
    h, sps, nseg = _plan(0.0, X1, 2, P["dx"])
    return (0.0, X1, h, sps, nseg)


def _jac(env, kind, mode, settings=None):
    fn = adj.travel_time_jacobian_2d if kind == "rd" else adj.travel_time_jacobian
    return fn(env, Z0, F.launch_p0(P), 0.0, X1, settings or _s(), mode=mode)


def _dirs(env):
    K = env.c_cheb.shape[1]
    Dm = adj.cheb_derivative_matrix(K, *env.z_dom)
    return torch.eye(K, dtype=env.dtype), torch.as_tensor(Dm.T, dtype=env.dtype)


def _close_jac(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_J[kind] * np.abs(want).max())


@pytest.fixture(scope="module")
def plain(envs):
    """The plain coefficient-tangent Jacobians (the kernel wrappers on CPU
    tensors), once per field."""
    return {k: _jac(envs[k], k, "kernel") for k in ("ri", "rd")}


@pytest.fixture(scope="module")
def fallback(envs):
    """The torch.func fallbacks: jacfwd per field, jacrev range-independent."""
    out = {(k, "fwd"): _jac(envs[k], k, "fwd") for k in ("ri", "rd")}
    out[("ri", "rev")] = _jac(envs["ri"], "ri", "rev")
    return out


@pytest.mark.parametrize("kind", ["ri", "rd"])
@pytest.mark.parametrize("ref", ["kernel", "fwd"])
def test_plain_coef_tangent_matches_jax(plain, fx, kind, ref):
    """B5 / B6's plain versions against the JAX package's kernel (Pallas
    interpreter) and its jacfwd, float32."""
    T, J = plain[kind]
    assert T.dtype == J.dtype == torch.float32
    np.testing.assert_allclose(T.numpy(), fx[f"{kind}/{ref}/T"], rtol=0, atol=TOL_T)
    _close_jac(J, fx[f"{kind}/{ref}/J"], kind)


@pytest.mark.parametrize("kind,mode", [("ri", "fwd"), ("ri", "rev"), ("rd", "fwd")])
def test_torch_func_fallback_matches_jax_and_plain(fallback, plain, fx, kind, mode):
    """``torch.func`` transforms over an environment tensor (the
    coefficient table through ``_trace_impl``) give the JAX package's
    jacfwd Jacobian and the plain coefficient-tangent trace's."""
    T, J = fallback[(kind, mode)]
    np.testing.assert_allclose(T.numpy(), fx[f"{kind}/fwd/T"], rtol=0, atol=TOL_T)
    _close_jac(J.detach(), fx[f"{kind}/fwd/J"], kind)
    _close_jac(J.detach(), plain[kind][1], kind)
    # the uncompensated travel times of the fallback are the plain primal's
    np.testing.assert_allclose(T.numpy(), plain[kind][0].numpy(), rtol=0, atol=1e-6)


def test_jacobians_see_the_bounces(envs):
    """The fixture's fan bounces: the crossing fix (and its coefficient
    tangent) runs on several rays."""
    out = _trace_coef_tangent_impl(envs["ri"], Z0, F.launch_p0(P), *_dirs(envs["ri"]), _geom(),
                                   _s())
    assert int((out[6] + out[7] > 0).sum()) >= 4
    assert bool((out[8] == 0).all())


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_plain_coef_tangent_matches_central_differences_f64(kind):
    """float64 plain versions against central differences of the torch-op
    loop along a random direction (with dc/dz chained through the
    Chebyshev derivative operator), over a bottom-bouncing fan."""
    env = _env(kind, torch.float64)
    nr, K = env.c_cheb.shape
    dc, dcp = _dirs(env)
    p0 = np.sin(np.radians(-BOUNCE_ANGLES)) / 1500.0
    rng = np.random.default_rng(1)
    v = rng.normal(size=(nr, K) if kind == "rd" else K)
    v /= np.linalg.norm(v)
    impl = _trace_coef_tangent_rd_impl if kind == "rd" else _trace_coef_tangent_impl
    out = impl(env, Z0, p0, dc, dcp, _geom(), _s())
    assert int((out[6] + out[7] > 0).sum()) >= 4  # bounces
    ad = np.tensordot(out[3].numpy(), v, axes=(list(range(v.ndim)), list(range(v.ndim))))
    Dm = adj.cheb_derivative_matrix(K, *env.z_dom)
    s_ops = _s(backend="ops", kahan=False)

    def T_at(shift):
        sh = np.broadcast_to(shift, (nr, K))
        env2 = dataclasses.replace(env, c_cheb=env.c_cheb + torch.as_tensor(sh),
                                   dcdz_cheb=env.dcdz_cheb + torch.as_tensor(sh @ Dm.T),
                                   poly_ok=False)
        return _trace_impl(env2, Z0, p0, _geom(), s_ops).ts[:, -1].numpy()

    eps = 1e-3
    fd = (T_at(eps * v) - T_at(-eps * v)) / (2 * eps)
    np.testing.assert_allclose(ad, fd, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_wrapper_on_cpu_is_the_plain_version(envs, kind):
    """On CPU tensors the wrappers run the plain version and count no
    launch; the primal is the final-state tangent trace on the Clenshaw
    environment, bit for bit."""
    env = envs[kind]
    p0 = F.launch_p0(P)
    dc, dcp = _dirs(env)
    n = (stepper.COEF_TANGENT_LAUNCHES, stepper.COEF_TANGENT_RD_LAUNCHES)
    if kind == "rd":
        got = stepper.trace_coef_tangent_rd_kernel(env, Z0, p0, dc, dcp, _geom(), _s())
        want = _trace_coef_tangent_rd_impl(env, Z0, p0, dc, dcp, _geom(), _s())
        assert got[3].shape == (P["nr"], env.c_cheb.shape[1], p0.shape[0])
    else:
        got = stepper.trace_coef_tangent_kernel(env, Z0, p0, dc, dcp, _geom(), _s())
        want = _trace_coef_tangent_impl(env, Z0, p0, dc, dcp, _geom(), _s())
        assert got[3].shape == (env.c_cheb.shape[1], p0.shape[0])
    assert (stepper.COEF_TANGENT_LAUNCHES, stepper.COEF_TANGENT_RD_LAUNCHES) == n
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    b2 = _trace_tangent_impl(dataclasses.replace(env, poly_ok=False), Z0, p0, 1.0, _geom(), _s())
    for i in (0, 1, 2, 6, 7, 8):
        assert torch.equal(got[i], b2[i])


def test_poly_ok_environment_still_gives_the_clenshaw_jacobian(envs):
    """The JAX test's guard: a poly_ok environment is differentiated in the
    Chebyshev representation (a unit direction in monomials is float32-
    catastrophic)."""
    env = envs["ri"]
    assert env.poly_ok
    T, J = _jac(env, "ri", "kernel")
    T2, J2 = _jac(dataclasses.replace(env, poly_ok=False), "ri", "kernel")
    assert torch.equal(T, T2) and torch.equal(J, J2)


def test_station_sum_is_the_range_independent_jacobian():
    """Σ_j of B6's Jacobian over stations is B5's on a range-independent
    field forced into the range-dependent layout (the hats sum to one),
    within float32 rounding: 1e-5 of the largest entry."""
    ri = _env("ri")
    rd = _env("ri", force_range_dependent=True)
    assert rd.range_dependent and torch.equal(rd.c_cheb[0], ri.c_cheb[0])
    _, J5 = _jac(ri, "ri", "kernel")
    _, J6 = _jac(rd, "rd", "kernel")
    np.testing.assert_allclose(J6.sum(1).numpy(), J5.numpy(), rtol=0,
                               atol=1e-5 * float(J5.abs().max()))


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_vjp_chunked_through_the_kernel_wrappers(envs, plain, fx, kind, monkeypatch):
    """travel_time_coef_vjp with ``backend="kernel"`` (the wrappers' plain
    versions on CPU tensors).  Chunked over directions, with the transient
    cap forced to 16 elements per station (eight directions a launch, three
    launches, for the fan's two steepest, bouncing rays):
    Jᵀv of the plain Jacobian's rows, and of the JAX kernel's within 3e-3 of
    the largest entry.  Unchunked over the whole fan: the JAX package's vjp
    within 3e-3."""
    env, v = envs[kind], np.asarray(P["v"], np.float32)
    rays = [0, v.shape[0] - 1]
    nr = P["nr"] if kind == "rd" else 1
    name = "COEF_TANGENT_RD_LAUNCHES" if kind == "rd" else "COEF_TANGENT_LAUNCHES"
    n0 = getattr(stepper, name)
    with monkeypatch.context() as m:
        m.setattr(adj, "_COEF_VJP_CHUNK_ELEMS", 16 * nr)
        T, g = adj.travel_time_coef_vjp(env, Z0, F.launch_p0(P)[rays], 0.0, X1, v[rays],
                                        _s(backend="kernel"))
    assert getattr(stepper, name) == n0  # CPU tensors: the plain version, no launch
    T_j, J = plain[kind]
    g_ref = np.tensordot(v[rays], J.numpy()[rays], axes=(0, 0))
    assert g.shape == g_ref.shape == (env.c_cheb.shape if kind == "rd" else env.c_cheb.shape[1:])
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-5 * np.abs(g_ref).max())
    np.testing.assert_allclose(T.numpy(), T_j.numpy()[rays], rtol=0, atol=1e-6)
    g_jax = np.tensordot(v[rays], fx[f"{kind}/kernel/J"][rays], axes=(0, 0))
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=0, atol=3e-3 * np.abs(g_jax).max())
    T, g = adj.travel_time_coef_vjp(env, Z0, F.launch_p0(P), 0.0, X1, v, _s(backend="kernel"))
    np.testing.assert_allclose(g.numpy(), fx[f"vjp_{kind}/g"], rtol=0,
                               atol=3e-3 * np.abs(fx[f"vjp_{kind}/g"]).max())
    np.testing.assert_allclose(T.numpy(), fx[f"vjp_{kind}/T"], rtol=0, atol=TOL_T)


@pytest.mark.parametrize("kind", ["ri", "rd"])
def test_vjp_float64_autograd_fallback(kind):
    """float64 (no kernel): the backward is autograd through the torch-op
    loop, and still Jᵀv of the plain Jacobian."""
    env = _env(kind, torch.float64)
    p0 = np.sin(np.radians(-BOUNCE_ANGLES)) / 1500.0
    v = np.linspace(-1.0, 1.0, p0.shape[0])
    T, g = adj.travel_time_coef_vjp(env, Z0, p0, 0.0, X1, v, _s())
    impl = _trace_coef_tangent_rd_impl if kind == "rd" else _trace_coef_tangent_impl
    out = impl(env, Z0, p0, *_dirs(env), _geom(), _s())
    g_ref = np.tensordot(out[3].numpy(), v, axes=(-1, 0))
    assert g.dtype == torch.float64 and g.shape == g_ref.shape
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(T.numpy(), out[0].numpy(), rtol=0, atol=1e-9)


def test_grad_of_a_misfit_through_times_of_coef(envs):
    """torch.autograd of a misfit through ``travel_times_of_coef`` on a
    range-dependent field is Jᵀ(T - T_obs), as the JAX test
    ``test_grad_matches_jacfwd_rd`` holds it."""
    env = envs["rd"]
    f = adj.travel_times_of_coef(env, Z0, F.launch_p0(P), 0.0, X1, _s(backend="kernel"))
    cc = env.c_cheb.clone().requires_grad_(True)
    T = f(cc)
    T_obs = T.detach() + torch.linspace(-2e-3, 2e-3, T.shape[0])
    misfit = 0.5 * ((T - T_obs) ** 2).sum()
    (g,) = torch.autograd.grad(misfit, cc)
    _, J = _jac(env, "rd", "kernel")
    g_ref = torch.einsum("b,bjk->jk", (T - T_obs).detach(), J)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0,
                               atol=1e-5 * float(g_ref.abs().max()))


@pytest.fixture(scope="module")
def jenvs():
    """The JAX package's fields, keyed (kind, series): the default fit as
    ``make_env_data`` gives it (poly_ok, Horner) and its Clenshaw copy."""
    import jax.numpy as jnp

    from pygenray_tpu.envdata import make_env_data

    out = {}
    for k in ("ri", "rd"):
        env = make_env_data(*F.tables(P, jp.munk_ssp, k == "rd"), dtype=jnp.float32)
        out[(k, "horner")], out[(k, "clenshaw")] = env, dataclasses.replace(env, poly_ok=False)
    return out


def _series(env, series):
    """The Fermat and endpoint comparisons run on the Clenshaw series at the
    JAX tests' bounds, and on the default fit (poly_ok, Horner) at the
    bounds its float32 gap reads (``TOL_*_HORNER``): the two packages round
    the fits' monomial series differently near the top of the depth
    domain, and this fan's surface-reflected rays part there (ROADMAP §C;
    ``make_adjoint_fixture.py --probe-f32``)."""
    assert env.poly_ok
    return env if series == "horner" else dataclasses.replace(env, poly_ok=False)


# (T [s], G of its largest entry, endpoint gradients [s/m]) by series
TOL_FERMAT = {"clenshaw": (TOL_T, 1e-4, 1e-9),
              "horner": (TOL_T_HORNER, TOL_G_HORNER, TOL_GRAD_HORNER)}


@pytest.mark.parametrize("kind,series", [
    pytest.param("ri", "clenshaw", id="ri"), pytest.param("rd", "clenshaw", id="rd"),
    pytest.param("ri", "horner", id="ri-horner"), pytest.param("rd", "horner", id="rd-horner"),
])
def test_fermat_jacobian_matches_jax(envs, jenvs, kind, series):
    """One trace each, both packages: the Fermat path-integral operator (on
    Clenshaw T within 1e-4 s, G within 1e-4 of its largest entry; on the
    default Horner fit ``TOL_*_HORNER``) and, range-independent, the
    perturbation response it gives."""
    from pygenray_tpu.integrate import SolverSettings as JSettings

    tol_t, tol_g, _ = TOL_FERMAT[series]
    p0, env, jenv = F.launch_p0(P), _series(envs[kind], series), jenvs[(kind, series)]
    T, G = adj.fermat_jacobian(env, Z0, p0, 0.0, X1, _s(), num_save=P["fermat_saves"])
    Tj, Gj = jadj.fermat_jacobian(jenv, Z0, p0, 0.0, X1, JSettings(dx=P["dx"]),
                                  num_save=P["fermat_saves"])
    assert G.shape == np.asarray(Gj).shape
    np.testing.assert_allclose(T, np.asarray(Tj), rtol=0, atol=tol_t)
    np.testing.assert_allclose(G, np.asarray(Gj), rtol=0, atol=tol_g * np.abs(Gj).max())
    if kind == "ri":
        dc = F.perturbation(P, env.z.numpy())
        np.testing.assert_allclose(adj.perturbation_response(G, env, dc),
                                   jadj.perturbation_response(Gj, jenv, dc),
                                   rtol=1e-4, atol=1e-9)


def test_fermat_jacobian_segment_basis_matches_jax(fx):
    """The segment-basis Fermat operator of a rough field against the
    fixture (the JAX package's: its segment fit at nz = 1500 is dear to
    build live), and its response to a uniform +1 m/s."""
    S = P["seg"]
    env = pt.make_env_data(*F.rough_tables(P, pt.munk_ssp), interp="seg", dtype=torch.float32,
                           device="cpu")
    assert env.has_seg and not env.has_cheb
    p0s = (np.sin(np.radians(-np.asarray(S["fan"]))) / P["c_src"]).astype(np.float32)
    T, G = adj.fermat_jacobian(env, Z0, p0s, 0.0, X1, SolverSettings(dx=S["dx"], interp="seg"),
                               num_save=P["fermat_saves"])
    Gj = fx["fermat_seg/G"]
    assert G.shape == Gj.shape
    np.testing.assert_allclose(T, fx["fermat_seg/T"], rtol=0, atol=TOL_T)
    # 1e-3 of the largest entry, not the spectral 1e-4: a rough field's
    # float32 paths part where rounding moves a save point across a segment
    # boundary (ROADMAP C; 7e-5 measured here)
    np.testing.assert_allclose(G, Gj, rtol=0, atol=1e-3 * np.abs(Gj).max())
    # δT of a uniform +1 m/s is about -T/c
    dT = adj.perturbation_response(G, env, np.ones(env.z.shape[0]))
    np.testing.assert_allclose(-dT, T / 1500.0, rtol=0.05)


def _endpoint_vs_jax(envs, jenvs, series):
    """On the Fermat operator's save plan, so the JAX side reuses its
    compiled trace."""
    from pygenray_tpu.integrate import SolverSettings as JSettings

    tol_t, _, tol_grad = TOL_FERMAT[series]
    p0, n = F.launch_p0(P), P["fermat_saves"]
    got = adj.endpoint_time_gradients(_series(envs["rd"], series), Z0, p0, 0.0, X1, _s(),
                                      num_save=n)
    want = jadj.endpoint_time_gradients(jenvs[("rd", series)], Z0, p0, 0.0, X1,
                                        JSettings(dx=P["dx"]), num_save=n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=tol_t)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol_grad)


def test_endpoint_time_gradients_match_jax(envs, jenvs):
    _endpoint_vs_jax(envs, jenvs, "clenshaw")


def test_endpoint_time_gradients_default_series_match_jax(envs, jenvs):
    _endpoint_vs_jax(envs, jenvs, "horner")


def test_cheb_derivative_matrix_and_exports():
    np.testing.assert_array_equal(adj.cheb_derivative_matrix(12, 0.0, 6000.0),
                                  jadj.cheb_derivative_matrix(12, 0.0, 6000.0))
    assert adj.__all__ == jadj.__all__
    for name in ("travel_time_jacobian", "travel_time_jacobian_2d", "fermat_jacobian",
                 "endpoint_time_gradients", "perturbation_response"):
        assert getattr(pt, name) is getattr(adj, name) and name in pt.__all__


@pytest.mark.parametrize("case", [
    "table_jacobian", "table_jacobian_2d", "table_times_of_coef", "table_fermat",
    "rd_to_range_independent", "kernel_float64", "kernel_ops_backend", "kernel_2d_on_ri",
])
def test_errors(envs, case):
    """The JAX module's guards: table environments, a range-dependent field
    for the range-independent Jacobian, and ``mode="kernel"`` where the
    coefficient-tangent kernel does not apply."""
    p0 = F.launch_p0(P)
    table = _s(interp="table")
    calls = {
        "table_jacobian": lambda: adj.travel_time_jacobian(envs["ri"], Z0, p0, 0.0, X1, table),
        "table_jacobian_2d": lambda: adj.travel_time_jacobian_2d(envs["rd"], Z0, p0, 0.0, X1,
                                                                 table),
        "table_times_of_coef": lambda: adj.travel_times_of_coef(envs["ri"], Z0, p0, 0.0, X1,
                                                                table),
        "table_fermat": lambda: adj.fermat_jacobian(envs["ri"], Z0, p0, 0.0, X1, table,
                                                    num_save=5),
        "rd_to_range_independent": lambda: adj.travel_time_jacobian(envs["rd"], Z0, p0, 0.0, X1),
        "kernel_float64": lambda: adj.travel_time_jacobian(_env("ri", torch.float64), Z0, p0,
                                                           0.0, X1, _s(), mode="kernel"),
        "kernel_ops_backend": lambda: adj.travel_time_jacobian(envs["ri"], Z0, p0, 0.0, X1,
                                                               _s(backend="ops"), mode="kernel"),
        "kernel_2d_on_ri": lambda: adj.travel_time_jacobian_2d(envs["ri"], Z0, p0, 0.0, X1,
                                                               _s(), mode="kernel"),
    }
    with pytest.raises(ValueError):
        calls[case]()
