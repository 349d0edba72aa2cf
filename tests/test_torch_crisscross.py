"""The crisscross family (the ALU-conform bisection mesh, where the
reference's golden triple lives) in the port, against the JAX package and
the unstructured oracle on CPU float64.

Mirrors tests/test_crisscross.py: the operator equals
``scripts/crisscross_oracle.py``'s up to a dof permutation (1e-12); the
assembly, the stencil, the Oswald interpolation, the flux reconstruction
and the divergence equal JAX entry by entry (1e-12 relative to the field's
max |.|: float64 einsums that differ in summation order); the matrix-form
and positive-form local quantities agree (1e-9, the matrix form's
cancellation); the golden config reproduces 1.656117e-01 / 1.446952e-01 /
3.548075e-01 (rel 1e-4); enrichment, the MOR round trip and the stencil
apply run on the family.  One JAX model (2x2 subdomains, s = 2).
"""
import sys
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.la.block import to_scipy_csr  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))

TOL = 1e-12
MU = 0.7


def cfg(subs, half, nref):
    return {"num_subdomains": subs, "half_num_fine_elements_per_subdomain_and_dim": half,
            "num_refinements": nref, "grid_type": "crisscross"}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cc_model(subs, half, nref):
    gpd = init_grid_and_problem(cfg(subs, half, nref))
    d, data = discretize(gpd, device="cpu")
    return gpd, d, data


@pytest.fixture(scope="module")
def models():
    dj, _ = jax_discretize(jax_problem(cfg([2, 2], 1, 1)))
    _, dt, _ = cc_model([2, 2], 1, 1)
    U = np.asarray(dj.solve(dj.parse_parameter(MU), {"type": "dense"}))
    U = U + 0.05 * np.random.default_rng(0).normal(size=U.shape)
    return dj, dt, U


def oracle_perm(space, n):
    """Flat permutation: the port's (K, N) dof -> the oracle's tri*3+j
    (its cells enumerated per 2x2 block; parity-1 lower elements list
    their first two vertices swapped)."""
    g = space.grid
    s, nb, T = space.s, space.nb, space.T
    perm = np.zeros(space.K * space.N, dtype=np.int64)
    for k in range(space.K):
        sx, sy = g.subdomain_coords(k)
        for cy in range(s):
            for cx in range(s):
                gy, gx = sy * s + cy, sx * s + cx
                ocell = ((gy // 2) * (n // 2) + gx // 2) * 4 + (gy % 2) * 2 + (gx % 2)
                for t in range(T):
                    for i in range(nb):
                        j = {0: 1, 1: 0}.get(i, i) if (gy + gx) % 2 == 1 and t == 0 else i
                        perm[k * space.N + space.dof_index(cy, cx, t, i)] = (ocell * 2 + t) * 3 + j
    return perm


def test_operator_matches_unstructured_oracle():
    import crisscross_oracle as oracle
    n = 8
    _, d, data = cc_model([2, 2], 1, 2)              # s = 4, 8x8 global cells
    V, T = oracle.crisscross_mesh(n)
    A_o, b_o, _ = oracle.assemble_swipdg(V, T)
    A_ours = to_scipy_csr(d.assemble(d.parse_parameter(1.))).toarray()
    perm = oracle_perm(data["space"], n)
    A_perm = np.zeros_like(A_ours)
    A_perm[np.ix_(perm, perm)] = A_ours
    np.testing.assert_allclose(A_perm, A_o.toarray(), atol=1e-12 * np.abs(A_o).max())


@pytest.mark.parametrize("field", ["A_diag", "C_R_io", "C_R_oi", "C_U_io", "C_U_oi"])
def test_operator_components_equal_jax(models, field):
    dj, dt, _ = models
    assert rel(getattr(dt.op, field), getattr(dj.op, field)) <= TOL


@pytest.mark.parametrize("field", ["E_bar", "L2", "M_aa", "BB", "M_ab", "A_div", "R_dd",
                                   "d_vec", "rf_qq", "min_ev"])
def test_estimator_tensors_equal_jax(models, field):
    """The per-cell volume einsums, the per-cell RT0 tables and the
    per-cell divergence (A_div)."""
    dj, dt, _ = models
    assert rel(getattr(dt.estimator.data, field), getattr(dj.estimator.data, field)) <= TOL


def test_rhs_and_products_equal_jax(models):
    dj, dt, _ = models
    assert rel(dt.rhs_q, dj.rhs_q) <= TOL
    for k in ("l2", "energy_mu_bar", "elliptic_bar"):
        assert rel(dt.products[k], dj.products[k]) <= TOL


def test_stencil_equals_jax(models):
    """The parity-split face families in stencil layout, the apply's
    parity masks (one lane and three), and the cell-Jacobi factors."""
    dj, dt, U = models
    for st_t, st_j in zip(dt.mf_operator().stencils, dj.mf_operator().stencils):
        assert rel(st_t.vol, st_j.vol) <= TOL
        for fam in ("D", "V", "H", "R", "U"):
            for a, b in zip(getattr(st_t, fam), getattr(st_j, fam)):
                assert rel(a, b) <= TOL
        for side in st_j.D_side:
            assert rel(st_t.D_side[side], st_j.D_side[side]) <= TOL
    At = dt.mf_operator().assemble(dt.theta(dt.parse_parameter(MU)))
    Aj = dj.mf_operator().assemble(dj.theta(dj.parse_parameter(MU)))
    X = np.random.default_rng(1).normal(size=(3,) + U.shape)
    assert rel(At.apply(torch.tensor(X)), Aj.apply(jnp.asarray(X))) <= TOL
    assert rel(At.apply(torch.tensor(U)), Aj.apply(jnp.asarray(U))) <= TOL
    assert rel(At.cell_jacobi_factors(), Aj.cell_jacobi_factors()) <= 1e-10


def test_oswald_and_flux_reconstruction_equal_jax(models):
    dj, dt, U = models
    ej, et = dj.estimator, dt.estimator
    assert rel(et.data.oswald.apply(torch.tensor(U)), ej.data.oswald.apply(jnp.asarray(U))) <= TOL
    mu_t, mu_j = dt.parse_parameter(MU), dj.parse_parameter(MU)
    assert rel(et.reconstruct_flux(torch.tensor(U), mu_t, per_component=True),
               ej.reconstruct_flux(jnp.asarray(U), mu_j, per_component=True)) <= TOL


@pytest.mark.parametrize("form", ["local_quantities", "local_quantities_positive"])
def test_local_quantities_equal_jax(models, form):
    dj, dt, U = models
    qt = getattr(dt.estimator, form)(torch.tensor(U)[None], dt.parse_parameter(MU))
    qj = getattr(dj.estimator, form)(jnp.asarray(U)[None], dj.parse_parameter(MU))
    for a, b in zip(qt, qj):
        assert rel(a, b) <= 1e-10


def test_solve_equals_jax(models):
    dj, dt, _ = models
    assert rel(dt.solve(dt.parse_parameter(MU)), dj.solve(dj.parse_parameter(MU))) <= 1e-10


def test_matrix_form_equals_positive_form(models):
    """Matrix-form locals = positive-form locals (f64): a cross-check of the
    per-cell chi, divergence and Oswald tables."""
    _, d, _ = models
    mu = d.parse_parameter(1.)
    U = d.solve(mu)[None]
    for a, b in zip(d.estimator.local_quantities(U, mu),
                    d.estimator.local_quantities_positive(U, mu)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-9, atol=1e-14)


def test_reproduces_reference_golden_triple():
    """The reference's golden config on the crisscross family, paper
    convention: 1.66e-01 / 1.45e-01 / 3.55e-01."""
    _, d, _ = cc_model([4, 4], 1, 1)                 # s = 2, 8x8 global cells
    mu = d.parse_parameter(1.)
    nc_sq, r_sq, df_sq = (v[0].numpy() for v in
                          d.estimator.local_quantities(d.solve(mu)[None], mu))
    paper = {k: float(np.sqrt(np.maximum(v, 0.0).sum()))
             for k, v in (("nc", nc_sq), ("r", r_sq), ("df", df_sq))}
    assert paper["nc"] == pytest.approx(1.656117e-01, rel=1e-4)
    assert paper["r"] == pytest.approx(1.446952e-01, rel=1e-4)
    assert paper["df"] == pytest.approx(3.548075e-01, rel=1e-4)


def test_online_enrichment_reduces_eta():
    from pylrbms_tpu_torch.reductor import LRBMSReductor
    from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment
    gpd, d, _ = cc_model([2, 2], 1, 1)
    red = LRBMSReductor(d, order=0)
    rd = red.reduce()
    loop = AdaptiveEnrichment(gpd, d, d.space, red, rd, target_error=1e-12,
                              marking_doerfler_theta=0.5, marking_max_age=100)
    etas = []
    loop.solve(d.parse_parameter(0.3), enrichment_steps=3,
               callback=lambda rd_, u, mu_, info: etas.append(info["eta"]))
    assert etas[-1] < 0.6 * etas[0], f"no reduction: {etas}"


def test_mor_roundtrip(models):
    """The ROM estimate equals the FOM estimate of the reconstruction
    (1e-8) and the JAX FOM estimate at the ROM's own snapshot (1e-6)."""
    from pylrbms_tpu_torch.reductor import LRBMSReductor, ExtensionError
    dj, d, _ = models
    red = LRBMSReductor(d)
    for mu_i in d.parameter_space.sample_uniformly(2)[:3]:
        try:
            red.extend_basis(d.solve(mu_i))
        except ExtensionError:
            pass
    rd = red.reduce()
    mu = d.parse_parameter(1.)
    c = rd.solve(mu)
    eta_rom = float(rd.estimate(c, mu))
    assert eta_rom == pytest.approx(float(d.estimate(red.reconstruct(c), mu)), rel=1e-8)
    eta_fom = float(d.estimate(d.solve(mu), mu))
    eta_jax = float(dj.estimate(dj.solve(dj.parse_parameter(1.)), dj.parse_parameter(1.)))
    assert eta_fom == pytest.approx(eta_jax, rel=1e-9)
    assert eta_rom == pytest.approx(eta_fom, rel=1e-6)


def test_stencil_apply_and_solve_equal_dense(models):
    """The stencil apply equals the block apply, and the matrix-free
    two-level solve the dense one (1e-9)."""
    _, d, _ = models
    mu = d.parse_parameter(0.4)
    A = d.assemble(mu)
    Amf = d.mf_operator().assemble(d.theta(mu))
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, d.space.K, d.space.N)))
    assert rel(Amf.apply(x), A.apply(x)) <= TOL
    b = d.rhs(mu)
    assert rel(Amf.solve_pcg(b, tol=1e-12, maxiter=3000), A.solve_dense(b)) <= 1e-9
    assert rel(d.solve(mu, {"type": "mf_pcg", "precision": 1e-12}), A.solve_dense(b)) <= 1e-9
