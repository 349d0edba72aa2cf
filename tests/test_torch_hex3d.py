"""Port 3D hex family (grid3d, ops/spaces3d, ops/assembly3d, ops/swipdg3d,
la/block's z-coupling family, ops/matrixfree3d and the model's mf_pcg solve
on it) against the JAX package on CPU float64.

Configurations: [1, 1, 1] nref 1 (subdomain-interior faces only), [2, 2, 2]
nref 0 (one cell per subdomain: interface couplings only) and [2, 1, 2]
nref 1 (the y-coupling family is empty).  Tolerances:

* the assembled components, fold_diag3 and the estimator tensors equal
  JAX's to 1e-12 (relative to the largest entry);
* the block apply with the C_W couplings, the affine apply, the dense
  global matrix and the coarse matrices to 1e-12; the halo-dense form of
  the operator applies it to 1e-13;
* the stencil fields to 1e-12, the stencil apply equals the port's block
  apply to 1e-13 (one lane and three lanes), the mass stencil the L2
  block apply, ``stencil_diag_blocks`` the folded diagonal blocks and
  ``stencil_coarse_matrix`` the block coarse matrix to 1e-13;
* the mf_pcg model solve on the carried-over stencils and frozen
  preconditioner: equal iteration counts and U to 1e-10, at precisions
  chosen clear of a step of the residual history (MF_PRECISION, held at
  0.85x and 1.15x as in tests/test_torch_matrixfree.py);
* ``AssembledBlockOp.solve`` with a type outside auto/dense/direct/pcg
  falls through to block PCG like JAX's (U to 1e-9).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops.swipdg3d import fold_diag3 as jax_fold_diag3  # noqa: E402
from pylrbms_tpu.ops.matrixfree3d import (assemble_swipdg_stencil3 as jax_stencil3,  # noqa: E402
                                          stencil_coarse_matrix as jax_coarse_matrix,
                                          stencil_diag_blocks as jax_diag_blocks)
from pylrbms_tpu.la.block import AffineBlockApply as JaxAffineBlockApply  # noqa: E402

from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402
from pylrbms_tpu_torch.ops.swipdg3d import fold_diag3  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree3d import (StencilOperator3, assemble_swipdg_stencil3,  # noqa: E402
                                                mass_stencil3, stencil_coarse_matrix,
                                                stencil_diag_blocks)
from pylrbms_tpu_torch.la.block import AffineBlockApply, AssembledBlockOp  # noqa: E402
from pylrbms_tpu_torch.convert import precond_from_numpy, stencils_from_numpy  # noqa: E402
from pylrbms_tpu_torch.ops.halodense import halo_from_assembled  # noqa: E402

f64 = torch.float64
QUADS = ("in_in", "in_out", "out_in", "out_out")
CONFIGS = {"interior": ([1, 1, 1], 1), "couplings": ([2, 2, 2], 0), "empty-y": ([2, 1, 2], 1)}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cfg(ns, nref):
    return {"num_subdomains": list(ns),
            "half_num_fine_elements_per_subdomain_and_dim": 1,
            "num_refinements": nref}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX model, port model) per configuration."""
    c = cfg(*CONFIGS[request.param])
    dj, _ = jax_discretize(jax_problem(c))
    dt, _ = discretize(init_grid_and_problem(c), device="cpu")
    return dj, dt


def test_grid_space_and_rt0_tables(pair):
    """Grid sizes and neighbourhoods, the dof and RT0 hex layouts, and the
    local-to-global RT0 map (every global face hit, interfaces twice)."""
    dj, dt = pair
    gj, gt = dj.grid, dt.grid
    assert (gt.num_subdomains, gt.num_elements, gt.max_entity_diameter(),
            gt.subdomain_diameter()) == (gj.num_subdomains, gj.num_elements,
                                         gj.max_entity_diameter(), gj.subdomain_diameter())
    sj, st = dj.space, dt.space
    assert (st.K, st.N, st.N_rt, st.N_rt_global, st.volume) == \
        (sj.K, sj.N, sj.N_rt, sj.N_rt_global, sj.volume)
    l2g = st.rt_local_to_global()
    np.testing.assert_array_equal(l2g, sj.rt_local_to_global())
    counts = np.bincount(l2g.reshape(-1), minlength=st.N_rt_global)
    assert counts.min() >= 1 and counts.max() <= 2
    chi, idx, div = st.rt_cell_tab()
    for a, b in zip((chi, idx, div), sj.rt_cell_tab()):
        np.testing.assert_array_equal(a, b)
    # chi_e carries a unit face moment on its own face: div integrates to +-1
    assert np.allclose(np.abs(div * st.volume), 1.0)


def test_assembled_components_and_fold_diag3(pair):
    """Per affine component: A_loc, the six Dirichlet strips, the X/Y/Z
    quadruples and fold_diag3 equal JAX's; the affine operator's stacks
    too."""
    dj, dt = pair
    for cj, ct in zip(dj.components, dt.components):
        assert rel(ct.A_loc, cj.A_loc) <= 1e-12
        for side in ct.D_side:
            assert rel(ct.D_side[side], cj.D_side[side]) <= 1e-12, side
        for fam in "XYZ":
            for q in QUADS:
                a, b = getattr(ct, f"{fam}_{q}"), getattr(cj, f"{fam}_{q}")
                assert rel(a, b) <= 1e-12, (fam, q)
        assert rel(fold_diag3(dt.space, ct), jax_fold_diag3(dj.space, cj)) <= 1e-12
    for name in ("A_diag", "C_R_io", "C_R_oi", "C_U_io", "C_U_oi", "C_W_io", "C_W_oi"):
        assert rel(getattr(dt.op, name), getattr(dj.op, name)) <= 1e-12, name
    assert dt.op.static.names()[-2:] == ("C_W_io", "C_W_oi")
    for name in ("E_bar", "L2", "M_aa", "BB", "M_ab", "A_div", "R_dd", "d_vec", "rf_qq",
                 "min_ev"):
        assert rel(getattr(dt.estimator.data, name), getattr(dj.estimator.data, name)) <= 1e-12


def test_block_apply_with_z_couplings(pair):
    """The assembled and the affine block apply (with the C_W family), the
    dense global matrix and the coarse matrices against JAX's."""
    dj, dt = pair
    rng = np.random.default_rng(0)
    K, N = dt.space.K, dt.space.N
    x = rng.normal(size=(3, K, N))
    theta = np.array([1.0, 0.35])
    Aj, At = dj.op.assemble(jnp.asarray(theta)), dt.op.assemble(torch.tensor(theta))
    assert rel(At.apply(torch.tensor(x)), Aj.apply(jnp.asarray(x))) <= 1e-12
    assert rel(At.apply(torch.tensor(x[0])), Aj.apply(jnp.asarray(x[0]))) <= 1e-12
    assert rel(At.to_dense(), Aj.to_dense()) <= 1e-12
    assert rel(At.coarse_matrix(), Aj.coarse_matrix()) <= 1e-12
    C = AssembledBlockOp.coarse_modes_basis(dt.space, 4)
    np.testing.assert_array_equal(C, type(Aj).coarse_modes_basis(dj.space, 4))
    assert rel(At.coarse_matrix_general(torch.tensor(C)),
               Aj.coarse_matrix_general(jnp.asarray(C))) <= 1e-12
    op_j = dj.op
    Bj = JaxAffineBlockApply(op_j.static, op_j.A_diag, op_j.C_R_io, op_j.C_R_oi,
                             op_j.C_U_io, op_j.C_U_oi, jnp.asarray(theta),
                             op_j.C_W_io, op_j.C_W_oi)
    def affine(th):
        return AffineBlockApply(dt.op.static, dt.op.A_diag, theta=th,
                                **{n + "_q": C for n, C in dt.op.couplings().items()})

    assert rel(affine(torch.tensor(theta)).apply(torch.tensor(x)),
               Bj.apply(jnp.asarray(x))) <= 1e-12
    # per-lane thetas: lane b equals the single-theta apply at theta[b]
    thetas = torch.tensor([[1.0, 0.2], [1.0, 0.9], [0.5, 0.5]], dtype=f64)
    yb = affine(thetas).apply(torch.tensor(x))
    for b in range(3):
        assert rel(yb[b], dt.op.assemble(thetas[b]).apply(torch.tensor(x[b]))) <= 1e-13
    # the halo-dense form carries the z pairs too
    assert rel(halo_from_assembled(At).apply(torch.tensor(x)), At.apply(torch.tensor(x))) <= 1e-13


def test_stencil_apply_equals_block_apply(pair):
    """Stencil fields equal JAX's; the stencil apply equals the port's block
    apply for one and three lanes (per-lane thetas too); the cell-Jacobi
    factors equal JAX's."""
    dj, dt = pair
    sj = [jax_stencil3(dj.space, lf, None) for lf in dj.estimator.data.lambda_funcs]
    st = [assemble_swipdg_stencil3(dt.space, lf, None)
          for lf in dt.estimator.data.lambda_funcs]
    for a, b in zip(st, sj):
        assert rel(a.vol, b.vol) <= 1e-12
        for fam in ("X", "Y", "Z", "IX", "IY", "IZ"):
            for u, v in zip(getattr(a, fam), getattr(b, fam)):
                assert rel(u, v) <= 1e-12, fam
        for side in a.D_side:
            assert rel(a.D_side[side], b.D_side[side]) <= 1e-12, side
    sop = StencilOperator3(dt.space, tuple(st))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(3, dt.space.K, dt.space.N)))
    theta = torch.tensor([1.0, 0.35], dtype=f64)
    A_mf, A_blk = sop.assemble(theta), dt.op.assemble(theta)
    assert rel(A_mf.apply(x), A_blk.apply(x)) <= 1e-13
    assert rel(A_mf.apply(x[0]), A_blk.apply(x[0])) <= 1e-13
    thetas = torch.tensor([[1.0, 0.2], [1.0, 0.9], [0.5, 0.5]], dtype=f64)
    yb = sop.assemble(thetas).apply(x)
    for b in range(3):
        assert rel(yb[b], dt.op.assemble(thetas[b]).apply(x[b])) <= 1e-13
    A_mf_j = type(dj.mf_operator())(dj.space, tuple(sj)).assemble(jnp.asarray(theta.numpy()))
    assert rel(A_mf.cell_jacobi_factors(), A_mf_j.cell_jacobi_factors()) <= 1e-12
    assert rel(A_mf.apply(x), A_mf_j.apply(jnp.asarray(x.numpy()))) <= 1e-13


def test_mass_stencil_diag_blocks_and_coarse_matrix(pair):
    """mass_stencil3 applies the L2 blocks; stencil_diag_blocks gives the
    folded diagonal blocks (and JAX's); stencil_coarse_matrix gives the
    block operator's coarse matrix (and JAX's)."""
    dj, dt = pair
    sop = dt.mf_operator()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(dt.space.K, dt.space.N)))
    m_st = mass_stencil3(dt.space, sop.stencils[0])
    M_op = StencilOperator3(dt.space, (m_st,)).assemble(torch.ones(1, dtype=f64))
    L2x = torch.einsum("knm,km->kn", dt.products["l2"], x)
    assert rel(M_op.apply(x), L2x) <= 1e-13
    theta = torch.tensor([1.0, 0.6], dtype=f64)
    A_mf, A_blk = sop.assemble(theta), dt.op.assemble(theta)
    D = stencil_diag_blocks(A_mf, dtype=f64)
    assert rel(D, A_blk.A_diag) <= 1e-13
    A_mf_j = dj.mf_operator().assemble(jnp.asarray(theta.numpy()))
    assert rel(D, jax_diag_blocks(A_mf_j, dtype=jnp.float64)) <= 1e-12
    A0 = stencil_coarse_matrix(A_mf, chunk=3)
    assert rel(A0, A_blk.coarse_matrix()) <= 1e-13
    assert rel(A0, jax_coarse_matrix(A_mf_j)) <= 1e-12


def _falls_through_to_pcg(dj, dt, kind):
    mu = {"diffusion": 0.4}
    b = dt.rhs(dt.parse_parameter(mu))
    opts = {"type": kind, "precision": 1e-12}
    At = dt.assemble(dt.parse_parameter(mu))
    Ut = At.solve(b, opts)
    Uj = dj.assemble(dj.parse_parameter(mu)).solve(jnp.asarray(b.numpy()), opts)
    assert rel(Ut, Uj) <= 1e-9
    assert rel(Ut, At.solve_dense(b)) <= 1e-9


def test_block_solve_falls_through_to_pcg(pair):
    """``AssembledBlockOp.solve`` runs block PCG for a type outside
    auto/dense/direct/pcg ('mf_pcg' handed straight to the block
    operator), as JAX's does."""
    _falls_through_to_pcg(*pair, "mf_pcg")


@pytest.mark.parametrize("kind", ["mf_pcg", "unknown-type"])
def test_block_solve_falls_through_to_pcg_2d(kind):
    """The same fall-through on a 2D operator."""
    from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015
    from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_disc2
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize as disc2

    c2 = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
          "num_refinements": 1}
    _falls_through_to_pcg(jax_disc2(jax_os2015(c2))[0], disc2(os2015(c2), device="cpu")[0],
                          kind)


# ---------------------------------------------------------------------------
# StationaryBlockModel.solve 'mf_pcg' on the 3D stencil
# ---------------------------------------------------------------------------

MF_CFG = cfg([2, 2, 2], 1)
# clear of a step of the residual history at 0.85x, 1x and 1.15x
MF_PRECISION = {"modal": 1e-11, "harvested": 1e-11}


@pytest.fixture(scope="module")
def jax_mf_model():
    return jax_discretize(jax_problem(MF_CFG))[0]


@pytest.mark.parametrize("scale", [0.85, 1.0, 1.15])
@pytest.mark.parametrize("coarse_space", sorted(MF_PRECISION))
def test_mf_pcg_model_solve_carried_against_jax(jax_mf_model, coarse_space, scale):
    """The JAX model's 3D stencil operator and its preconditioner frozen at
    mu=0.7 go into a fresh port model; both solve at 0.7 and then 0.5 with
    equal iteration counts and U to 1e-10; the port's post-check residual
    holds."""
    dj = jax_mf_model
    opts = {"type": "mf_pcg", "precision": scale * MF_PRECISION[coarse_space],
            "coarse_space": coarse_space, "coarse_modes": 4}
    getattr(dj, "_mf_jit_cache", {}).clear()          # freeze afresh at mu=0.7
    ref = [(dj.solve(dj.parse_parameter(m), inverse_options=opts), int(dj.last_solve_iters))
           for m in (0.7, 0.5)]
    dt = discretize(init_grid_and_problem(MF_CFG), device="cpu")[0]
    pkey = ("precond", True, coarse_space, 4)
    dt._mf_sop = StencilOperator3(dt.space, stencils_from_numpy(dj.mf_operator().stencils))
    dt._mf_cache[pkey] = precond_from_numpy(dj._mf_jit_cache[pkey])
    for m, (U_ref, it_ref) in zip((0.7, 0.5), ref):
        U = dt.solve(m, inverse_options=opts)
        assert rel(U, U_ref) <= 1e-10
        assert int(dt.last_solve_iters) == it_ref
    assert [k for k in dt._mf_cache if k[0] == "precond"] == [pkey]


def test_mf_pcg_model_solve_builds_its_own_preconditioner():
    """Without carried state the port builds the 3D stencil and the frozen
    two-level preconditioner itself ('auto' resolves to mf_pcg above the
    threshold); mixed=True reaches the f64 solution too."""
    from pylrbms_tpu_torch import model as model_mod
    dt = discretize(init_grid_and_problem(MF_CFG), device="cpu")[0]
    mu = dt.parse_parameter(0.6)
    ref = dt.assemble(mu).solve_dense(dt.rhs(mu))
    U = dt.solve(mu, {"type": "mf_pcg", "precision": 1e-11})
    assert rel(U, ref) <= 1e-9 and int(dt.last_solve_iters) > 0
    Um = dt.solve(mu, {"type": "mf_pcg", "precision": 1e-11, "mixed": True})
    assert rel(Um, ref) <= 1e-9
    old = model_mod.MF_SOLVE_MIN_DOFS
    try:
        model_mod.MF_SOLVE_MIN_DOFS = 0
        assert dt._solver_kind({}) == "mf_pcg"
    finally:
        model_mod.MF_SOLVE_MIN_DOFS = old
