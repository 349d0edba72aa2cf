"""Order 2 in the port: the RT1 flux space, P2/Q2 Oswald, the order-2
estimator and the MOR layer on P2, on CPU float64.

Mirrors the non-slow cases of tests/test_p2_estimator.py (duality and
layout of the moment-dual RT1 basis 1e-12; exactness of the reconstruction
for a conforming quadratic on tri, crisscross and quad 1e-11; H(div)
conformity 1e-10; Oswald at order 2 1e-12; matrix form = positive form
1e-9; P2 MOR and enrichment; lean reduce = standard 1e-12; the P2
parabolic estimate), plus parity with the JAX package: the RT1 tables,
``df_bb_rt1``, ``df_ab_rt1``, ``divergence_matrix_rt1``, the RT1
reconstruction and the Oswald operator on all three families (1e-12), and
one JAX P2 tri model (the estimator tensors 1e-12, the local quantities
1e-10).  Blocks stay at N <= 144 (P2 s = 2, Q2 s = 4): torch's CPU batched
LU has hung on stacks of larger blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.grid import make_grid as jax_make_grid  # noqa: E402
from pylrbms_tpu.ops.spaces import BlockDGSpace as JaxSpace  # noqa: E402
from pylrbms_tpu.ops import rt1 as jrt1  # noqa: E402
from pylrbms_tpu.ops.oswald import OswaldOperator as JaxOswald  # noqa: E402
from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402

from pylrbms_tpu_torch import basis as B  # noqa: E402
from pylrbms_tpu_torch.grid import make_grid  # noqa: E402
from pylrbms_tpu_torch.ops.spaces import BlockDGSpace  # noqa: E402
from pylrbms_tpu_torch.ops import rt1, assembly as asm  # noqa: E402
from pylrbms_tpu_torch.ops.oswald import OswaldOperator  # noqa: E402
from pylrbms_tpu_torch.quadrature import edge_rule  # noqa: E402
from pylrbms_tpu_torch.problems.non_parametric import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402

FAMILIES = ("tri", "crisscross", "quad")
CFG = dict(num_subdomains=[2, 2], half_num_fine_elements_per_subdomain_and_dim=1,
           num_refinements=1)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def grid_args(gt, nsub=2, half=1, nref=1):
    return dict(num_subdomains=[nsub, nsub], half_num_fine_elements_per_subdomain_and_dim=half,
                num_refinements=nref, grid_type=gt)


def spaces(gt, order=2, **kw):
    a = grid_args(gt, **kw)
    return BlockDGSpace(make_grid(**a), order=order), JaxSpace(jax_make_grid(**a), order=order)


def ONE(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype)


def JONE(x):
    return jnp.ones(x.shape[:-1], x.dtype)


def test_rt1_duality_and_layout():
    sp = spaces("tri")[0]
    chi1, idx1, _div1 = rt1.rt1_cell_tab(sp)
    assert chi1.shape[-2:] == (8, 2) and idx1.shape[-1] == 8
    tau, wf = edge_rule(sp._face_quad)
    scale = np.array([sp.hx, sp.hy])
    slots = rt1._tri_edge_slots(sp)
    for ti, name in enumerate(("A", "B")):
        M = np.zeros((8, 8))
        for k, (geom, n, ell) in enumerate(slots[name]):
            Vn = rt1._coeff_basis_vals(geom.points(tau) * scale) @ n
            M[2 * k] = ell * np.einsum("q,qc->c", wf, Vn)
            M[2 * k + 1] = ell * np.einsum("q,q,qc->c", wf, 2 * tau - 1, Vn)
        Vq = rt1._coeff_basis_vals(sp.vol_qp[ti] * scale)
        M[6] = sp.hx * sp.hy * np.einsum("q,qc->c", sp.vol_w[ti], Vq[..., 0])
        M[7] = sp.hx * sp.hy * np.einsum("q,qc->c", sp.vol_w[ti], Vq[..., 1])
        assert np.abs(M @ sp._rt1_minv[ti] - np.eye(8)).max() < 1e-12
    l2g = rt1.rt1_local_to_global(sp)
    assert len(np.unique(l2g)) == rt1.N_rt1_global(sp)
    assert l2g.max() == rt1.N_rt1_global(sp) - 1


@pytest.mark.parametrize("gt", FAMILIES)
def test_rt1_tables_and_products_equal_jax(gt):
    sp, spj = spaces(gt)
    for a, b in zip(rt1.rt1_cell_tab(sp), jrt1.rt1_cell_tab(spj)):
        assert rel(a, b) <= 1e-12
    assert np.array_equal(rt1.rt1_local_to_global(sp), jrt1.rt1_local_to_global(spj))
    assert rt1.N_rt1(sp) == jrt1.N_rt1(spj)
    lam_hat = lambda x: 1.0 + 0.25 * torch.sin(x[..., 0]) * torch.cos(x[..., 1])  # noqa: E731
    lam_hat_j = lambda x: 1.0 + 0.25 * jnp.sin(x[..., 0]) * jnp.cos(x[..., 1])  # noqa: E731
    lam_v = lambda x: 2.0 + x[..., 0] * x[..., 1]  # noqa: E731
    assert rel(rt1.df_bb_rt1(sp, lam_hat), jrt1.df_bb_rt1(spj, lam_hat_j)) <= 1e-12
    assert rel(rt1.df_ab_rt1(sp, lam_v, lam_hat), jrt1.df_ab_rt1(spj, lam_v, lam_hat_j)) <= 1e-12
    assert rel(rt1.divergence_matrix_rt1(sp), jrt1.divergence_matrix_rt1(spj)) <= 1e-12


@pytest.mark.parametrize("gt", FAMILIES)
def test_rt1_reconstruction_and_oswald_equal_jax(gt):
    sp, spj = spaces(gt)
    U = np.random.default_rng(3).normal(size=(2, sp.K, sp.N))
    lam = lambda x: 1.0 + x[..., 0] ** 2  # noqa: E731
    t = rt1.FluxReconstructorRT1(sp, None).apply(lam, torch.tensor(U))
    tj = jrt1.FluxReconstructorRT1(spj, None).apply(lam, jnp.asarray(U))
    assert rel(t, tj) <= 1e-12
    assert rel(OswaldOperator(sp).apply(torch.tensor(U)),
               JaxOswald(spj).apply(jnp.asarray(U))) <= 1e-12


def _exact_reconstruction_error(gt, u_ex, gu_ex):
    sp = BlockDGSpace(make_grid(**grid_args(gt, nsub=1, half=2, nref=1)), order=2)
    coords = sp.node_coords_phys()
    U = torch.tensor(u_ex(coords[..., 0], coords[..., 1]).reshape(sp.K, sp.N))
    t = rt1.FluxReconstructorRT1(sp, None).apply(ONE, U).numpy()
    chi1, idx1, _ = rt1.rt1_cell_tab(sp)
    nf = idx1.shape[-1]
    t_cell = t[..., idx1.reshape(-1)].reshape(sp.K, sp.s, sp.s, sp.T, nf)
    t_q = np.einsum(asm.vol_ein(sp, "kyxte,tqea->kyxtqa"), t_cell, chi1)
    xq = asm.vol_points(sp)
    exact = -gu_ex(xq[..., 0], xq[..., 1])
    # interior cells: all incident edges are interior -> t == -grad u
    return np.abs((t_q - exact)[:, 1:-1, 1:-1]).max()


@pytest.mark.parametrize("gt", ["tri", "crisscross"])
def test_rt1_reconstruction_exact_for_conforming_quadratic(gt):
    err = _exact_reconstruction_error(
        gt, lambda x, y: x * x + 2 * x * y - 3 * y * y + 0.5 * x - 0.25 * y + 0.125,
        lambda x, y: np.stack([2 * x + 2 * y + 0.5, 2 * x - 6 * y - 0.25], -1))
    assert err < 1e-11


def test_q2_quad_reconstruction_exact():
    """RT_[1] = Q_{2,1} x Q_{1,2} reproduces -grad(u) for a conforming
    quadratic whose gradient lies in the space."""
    err = _exact_reconstruction_error(
        "quad", lambda x, y: x * x + 3 * x * y - 2 * y * y + x - y,
        lambda x, y: np.stack([2 * x + 3 * y + 1, 3 * x - 4 * y - 1], -1))
    assert err < 1e-11


def test_rt1_hdiv_conformity_random():
    sp = BlockDGSpace(make_grid(**grid_args("tri", nsub=1, half=2, nref=1)), order=2)
    U = torch.tensor(np.random.default_rng(0).standard_normal((sp.K, sp.N)))
    t = rt1.FluxReconstructorRT1(sp, None).apply(ONE, U).numpy()
    _, idx1, _ = rt1.rt1_cell_tab(sp)
    t_cell = t[..., idx1.reshape(-1)].reshape(sp.K, sp.s, sp.s, sp.T, 8)
    Minv = sp._rt1_minv
    scale = np.array([sp.hx, sp.hy])
    tau = np.linspace(0.1, 0.9, 5)

    def eval_t(coeff8, ti, xpts):
        chi = np.einsum("pca,cj->pja", rt1._coeff_basis_vals(xpts), Minv[ti])
        return np.einsum("e,pea->pa", coeff8, chi)

    (_, emA), (_, epB) = B.EDGES_UNIT["D"]
    nD = sp.face_tabs["D"].normal
    xeA, xeB = emA.points(tau) * scale, epB.points(tau) * scale
    for cy in range(sp.s):
        for cx in range(sp.s):
            jump = eval_t(t_cell[0, cy, cx, 0], 0, xeA) - eval_t(t_cell[0, cy, cx, 1], 1, xeB)
            assert np.abs(jump @ nD).max() < 1e-10
    (_, emV), (_, epV) = B.EDGES_UNIT["V"]
    nV = sp.face_tabs["V"].normal
    xm, xp = emV.points(tau) * scale, epV.points(tau) * scale
    for cy in range(sp.s):
        for cx in range(sp.s - 1):
            jump = (eval_t(t_cell[0, cy, cx, 0], 0, xm)
                    - eval_t(t_cell[0, cy, cx + 1, 1], 1, xp))
            assert np.abs(jump @ nV).max() < 1e-10


@pytest.mark.parametrize("gt", FAMILIES)
def test_oswald_order2(gt):
    """Idempotent, continuous (nodes on one lattice point carry one value)
    and zero on the boundary; at order 1 the lattice tables reproduce the
    hand-built P1/Q1 tables."""
    sp = spaces(gt)[0]
    osw = OswaldOperator(sp)
    rng = np.random.default_rng(1)
    I1 = osw.interpolate(torch.tensor(rng.standard_normal((sp.K, sp.N))))
    assert float((osw.interpolate(I1) - I1).abs().max()) < 1e-12
    vid = osw.vertex_ids_block.numpy()
    vals = I1.numpy().reshape(-1)
    high = np.full(osw.n_vertices, -np.inf)
    np.maximum.at(high, vid, vals)
    low = np.full(osw.n_vertices, np.inf)
    np.minimum.at(low, vid, vals)
    used = np.isfinite(low)
    assert np.abs(high[used] - low[used]).max() < 1e-12
    boundary = used & (osw.interior_mask.numpy() == 0)
    assert np.abs(low[boundary]).max() < 1e-12
    sp1 = spaces(gt, order=1)[0]
    ids_p1 = OswaldOperator._vertex_ids_p1(sp1)
    ids_lat = OswaldOperator._vertex_ids_lattice(sp1)
    # the same partition of the nodes
    _, a = np.unique(ids_p1, return_inverse=True)
    _, b = np.unique(ids_lat, return_inverse=True)
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def p2_models():
    mj, _ = jax_discretize(jax_os2015(CFG), order=2)
    gpd = os2015(CFG)
    m, data = discretize(gpd, order=2, device="cpu")
    return mj, gpd, m, data


@pytest.mark.parametrize("field", ["E_bar", "L2", "M_aa", "BB", "M_ab", "A_div", "R_dd",
                                   "d_vec", "rf_qq"])
def test_p2_estimator_tensors_equal_jax(p2_models, field):
    mj, _, m, _ = p2_models
    assert rel(getattr(m.estimator.data, field), getattr(mj.estimator.data, field)) <= 1e-12


def test_p2_operator_solve_and_estimate_equal_jax(p2_models):
    mj, _, m, _ = p2_models
    assert rel(m.op.A_diag, mj.op.A_diag) <= 1e-12
    mu, muj = m.parse_parameter(0.4), mj.parse_parameter(0.4)
    U = m.solve(mu)
    assert rel(U, mj.solve(muj)) <= 1e-10
    for form in ("local_quantities", "local_quantities_positive"):
        for a, b in zip(getattr(m.estimator, form)(U[None], mu),
                        getattr(mj.estimator, form)(jnp.asarray(U.numpy())[None], muj)):
            assert rel(a, b) <= 1e-10


@pytest.mark.parametrize("gt", FAMILIES)
def test_p2_stencil_apply_equals_block_apply(p2_models, gt):
    """The stencil at nb = 6 (P2 tri, crisscross) and nb = 9 (Q2 quad):
    apply = block apply, cell-Jacobi PCG = dense solve; on tri the
    cell-Jacobi factors equal JAX's (1e-10: batched inverses)."""
    mj, _, m, _ = p2_models
    if gt != "tri":
        m, _ = discretize(os2015(dict(CFG, grid_type=gt)), order=2, device="cpu")
    mu = m.parse_parameter(0.3)
    A = m.assemble(mu)
    Amf = m.mf_operator().assemble(m.theta(mu))
    x = torch.tensor(np.random.default_rng(4).normal(size=(3, m.space.K, m.space.N)))
    assert rel(Amf.apply(x), A.apply(x)) <= 1e-12
    b = m.rhs(mu)
    assert rel(Amf.solve_pcg(b, tol=1e-12, maxiter=3000), A.solve_dense(b)) <= 1e-9
    if gt == "tri":
        Aj = mj.mf_operator().assemble(mj.theta(mj.parse_parameter(0.3)))
        assert rel(Amf.cell_jacobi_factors(), Aj.cell_jacobi_factors()) <= 1e-10


def test_p2_matrix_vs_positive_paths():
    m, _ = discretize(init_grid_and_problem(CFG), order=2, device="cpu")
    U = m.solve({})[None]
    for a, b in zip(m.estimator.local_quantities(U, {}),
                    m.estimator.local_quantities_positive(U, {})):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-9, atol=1e-14)


def test_p2_mor_and_online_enrichment(p2_models):
    """reduce / ROM solve / online estimate / online enrichment on the P2
    model; the ROM estimate equals the FOM estimate of the reconstruction."""
    from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment
    _, gpd, m, data = p2_models
    red = LRBMSReductor(m, order=1)
    for v in (0.1, 1.0):
        red.extend_basis(m.solve(m.parse_parameter(v)))
    rom = red.reduce()
    mu = m.parse_parameter(0.4)
    u_r = rom.solve(mu)
    eta_rom = float(rom.estimate(u_r, mu))
    assert abs(eta_rom - float(m.estimator.estimate(red.reconstruct(u_r), mu))) < 1e-8 * eta_rom
    red2 = LRBMSReductor(m, order=1)
    red2.extend_basis(m.solve(m.parse_parameter(1.0)))
    loop = AdaptiveEnrichment(gpd, m, data["block_space"], red2, red2.reduce(),
                              target_error=1e-12, marking_doerfler_theta=0.5,
                              marking_max_age=100)
    etas = []
    loop.solve(m.parse_parameter(0.27), enrichment_steps=3,
               callback=lambda rd_, u, mu_, info: etas.append(info["eta"]))
    assert etas[-1] < 0.2 * etas[0], etas


def test_p2_lean_reduce_matches_standard(p2_models):
    """The lean reduce sizes its flux-image stack from the reconstructor
    (the RT1 width); its tensors equal the standard path's."""
    _, _, m, _ = p2_models
    red = LRBMSReductor(m, order=1)
    for v in (0.1, 1.0):
        red.extend_basis(m.solve(m.parse_parameter(v)))
    rd_ref = red.reduce()
    red._img_cache = None
    red.force_lean = True
    red.force_chunk = 4
    rd_lean = red.reduce()
    for name in ("A_red", "b_red", "G_nc", "AA", "ABT", "BBT", "DV", "RD"):
        np.testing.assert_allclose(getattr(rd_lean, name).numpy(),
                                   getattr(rd_ref, name).numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    mu = m.parse_parameter(0.55)
    e1 = float(rd_ref.estimate(rd_ref.solve(mu), mu))
    assert abs(float(rd_lean.estimate(rd_lean.solve(mu), mu)) - e1) <= 1e-9 * abs(e1)


def test_p2_parabolic_estimate_runs():
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as dpar
    im, _ = dpar(os2015(CFG), T=1.0, nt=4, order=2, device="cpu")
    mu = im.parse_parameter(0.5)
    U = im.solve(mu)
    assert U.shape[0] == 5
    est, _parts = im.estimate(U, mu)
    assert np.isfinite(float(est)) and float(est) > 0
