"""Port 3D hex estimator pipeline (ops/oswald3d, ops/fluxreco3d,
ops/products3d and the 3D branch of EllipticEstimator) against the JAX
package on CPU float64.

* Oswald3D: a conforming zero-boundary nodal function is a fixed point
  (1e-13), the interpolant is a projection (1e-13), and the witness equals
  JAX's on random input (1e-13), with JAX's vertex table;
* FluxReconstructor3D: the constant-gradient face moments (1e-13) and the
  reconstruction of random DG functions against JAX's (1e-12);
* the estimator, matrix form and positive form, equals JAX's (1e-10 on the
  local quantities, 1e-12 on eta); batched equals single lanes (1e-12);
* the 3D golden triples (Q1 nref 1 and Q2 nref 0 at mu = 0.5, paper
  convention) reproduce ``GOLDEN3`` of tests/test_scripts.py to rel 1e-5
  and the JAX values to 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops.oswald3d import Oswald3D as JaxOswald3D  # noqa: E402
from pylrbms_tpu.ops.fluxreco3d import FluxReconstructor3D as JaxFlux3D  # noqa: E402

from pylrbms_tpu_torch.grid3d import make_grid3d  # noqa: E402
from pylrbms_tpu_torch.ops.spaces3d import BlockDGSpace3D  # noqa: E402
from pylrbms_tpu_torch.ops.oswald3d import Oswald3D  # noqa: E402
from pylrbms_tpu_torch.ops.fluxreco3d import FluxReconstructor3D  # noqa: E402
from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402

f64 = torch.float64
CFG = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
# tests/test_scripts.py::test_academic3d_golden_triples
GOLDEN3 = {
    1: {"eta": 2.669043e+00, "nc": 8.099561e-02, "r": 1.546472e+00,
        "df": 1.041575e+00, "nref": 1},
    2: {"eta": 1.010787e+00, "nc": 1.879885e-02, "r": 6.276844e-01,
        "df": 3.643033e-01, "nref": 0},
}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _space(ns, nref=1, order=1):
    g = make_grid3d(num_subdomains=list(ns), half_num_fine_elements_per_subdomain_and_dim=1,
                    num_refinements=nref)
    return g, BlockDGSpace3D(g, order=order)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, JAX U, port U) at mu = 0.5 on CFG."""
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    mu = {"diffusion": 0.5}
    return dj, dt, dj.solve(dj.parse_parameter(mu)), dt.solve(mu)


@pytest.mark.parametrize("order", [1, 2])
def test_oswald3d_fixed_point_projection_and_jax(order):
    ns = (2, 1, 2)
    g, sp = _space(ns, nref=1 if order == 1 else 0, order=order)
    osw = Oswald3D(sp)
    xn = sp.node_coords_phys().reshape(sp.K, sp.N, 3)
    gfun = np.sin(np.pi * xn[..., 0]) * np.sin(np.pi * xn[..., 1]) * np.sin(np.pi * xn[..., 2])
    assert float(osw.apply(torch.tensor(gfun)).abs().max()) < 1e-13
    rng = np.random.default_rng(3)
    V = torch.tensor(rng.standard_normal((2, sp.K, sp.N)))
    I1 = osw.interpolate(V)
    assert float((osw.interpolate(I1) - I1).abs().max()) < 1e-13
    from pylrbms_tpu.grid3d import make_grid3d as jax_grid3d
    from pylrbms_tpu.ops.spaces3d import BlockDGSpace3D as JaxSpace3D
    gj = jax_grid3d(num_subdomains=list(ns), half_num_fine_elements_per_subdomain_and_dim=1,
                    num_refinements=1 if order == 1 else 0)
    oj = JaxOswald3D(JaxSpace3D(gj, order=order))
    assert rel(osw.apply(V), oj.apply(jnp.asarray(V.numpy()))) <= 1e-13
    np.testing.assert_array_equal(osw.vertex_ids_block.numpy(), oj.vertex_ids_block)


def test_fluxreco3d_constant_gradient_inner_faces():
    """For u = x and lambda = 1 the numerical flux on every inner face is
    -grad(u).n: inner X dofs = -hy*hz, inner Y/Z dofs = 0."""
    g, sp = _space((2, 2, 1))
    fr = FluxReconstructor3D(sp)
    xn = sp.node_coords_phys().reshape(sp.K, sp.N, 3)
    t = fr.apply_global(lambda x: torch.ones(x.shape[:-1], dtype=x.dtype),
                        torch.tensor(xn[..., 0])).numpy()
    Sx, Sy, Sz = fr.Sx, fr.Sy, fr.Sz
    nX, nY = Sz * Sy * (Sx + 1), Sz * (Sy + 1) * Sx
    dofX = t[:nX].reshape(Sz, Sy, Sx + 1)
    dofY = t[nX:nX + nY].reshape(Sz, Sy + 1, Sx)
    dofZ = t[nX + nY:].reshape(Sz + 1, Sy, Sx)
    assert np.abs(dofX[:, :, 1:Sx] + g.hy * g.hz).max() < 1e-13
    assert np.abs(dofY[:, 1:Sy, :]).max() < 1e-13
    assert np.abs(dofZ[1:Sz, :, :]).max() < 1e-13


def test_fluxreco3d_against_jax(models):
    """Global and local RT0 hex reconstructions of random DG functions, per
    affine diffusion component, against JAX's (1e-12)."""
    dj, dt, _, _ = models
    rng = np.random.default_rng(4)
    U = rng.normal(size=(2, dt.space.K, dt.space.N))
    fj = JaxFlux3D(dj.space, None)
    ft = dt.estimator.data.flux
    for lj, lt in zip(dj.estimator.data.lambda_funcs, dt.estimator.data.lambda_funcs):
        assert rel(ft.apply_global(lt, torch.tensor(U)), fj.apply_global(lj, jnp.asarray(U))) <= 1e-12
        assert rel(ft.apply(lt, torch.tensor(U)), fj.apply(lj, jnp.asarray(U))) <= 1e-12


def test_estimator_against_jax(models):
    """Matrix-form and positive-form local quantities, eta and the
    indicators against JAX's."""
    dj, dt, Uj, Ut = models
    assert rel(Ut, Uj) <= 1e-12
    mu_j, mu_t = dj.parse_parameter(0.5), dt.parse_parameter(0.5)
    for fn in ("local_quantities", "local_quantities_positive"):
        qj = getattr(dj.estimator, fn)(Uj[None], mu_j)
        qt = getattr(dt.estimator, fn)(Ut[None], mu_t)
        for a, b in zip(qt, qj):
            assert rel(a, b) <= 1e-10, fn
    ej, _, ind_j = dj.estimate(Uj, mu_j, decompose=True)
    et, _, ind_t = dt.estimate(Ut, mu_t, decompose=True)
    assert rel(et, ej) <= 1e-12
    assert rel(ind_t, ind_j) <= 1e-10
    # the matrix and the positive forms agree on the port
    for a, b in zip(dt.estimator.local_quantities(Ut[None], mu_t),
                    dt.estimator.local_quantities_positive(Ut[None], mu_t)):
        assert rel(a, b) <= 1e-9


def test_estimator_batched_equals_single(models):
    """Lane-batched local quantities equal the single-lane ones; the batched
    estimate aggregates over the lanes."""
    _, dt, _, _ = models
    mus = [0.3, 1.0]
    Us = torch.stack([dt.solve(m) for m in mus])
    mu = dt.parse_parameter(0.3)
    qb = dt.estimator.local_quantities_positive(Us, mu)
    for i in range(2):
        qs = dt.estimator.local_quantities_positive(Us[i][None], mu)
        for a, b in zip(qb, qs):
            assert rel(a[i], b[0]) <= 1e-12
    for i, m in enumerate(mus):
        e1 = float(dt.estimate(Us[i], {"diffusion": m}))
        eb = float(dt.estimate(Us, {"diffusion": m}))
        assert np.isfinite(e1) and e1 > 0 and eb >= e1 - 1e-12


@pytest.mark.parametrize("order", [1, 2])
def test_golden_triples(models, order):
    """The academic3d golden triples at mu = 0.5 (paper convention) to rel
    1e-5 of GOLDEN3 and to 1e-9 of the JAX package's."""
    g = GOLDEN3[order]
    mu = {"diffusion": 0.5}
    c = dict(CFG, num_refinements=g["nref"])
    d, _ = discretize(init_grid_and_problem(c), device="cpu", order=order)
    U = d.solve(mu)
    eta, (nc, r, df), _ = d.estimate(U, mu, decompose=True, paper_convention=True)
    vals = {"eta": float(eta), "nc": float(torch.linalg.norm(nc)),
            "r": float(torch.linalg.norm(r)), "df": float(torch.linalg.norm(df))}
    for k in ("eta", "nc", "r", "df"):
        assert vals[k] == pytest.approx(g[k], rel=1e-5), (order, k, vals[k])
    dj = models[0] if order == 1 else jax_discretize(jax_problem(c), order=order)[0]
    etaj, (ncj, rj, dfj), _ = dj.estimate(dj.solve(mu), mu, decompose=True,
                                          paper_convention=True)
    ref = {"eta": float(etaj), "nc": float(np.linalg.norm(np.asarray(ncj))),
           "r": float(np.linalg.norm(np.asarray(rj))),
           "df": float(np.linalg.norm(np.asarray(dfj)))}
    for k in ref:
        assert vals[k] == pytest.approx(ref[k], rel=1e-9), (order, k)
