"""Port 3D hex MOR (reductor's z-coupling family and 27-patches, the 3D
corrector, online enrichment, weak greedy, the online step's 3D paths,
thermalblock3d and the 3D parabolic path) on CPU float64, mirrored from
tests/test_hex3d_mor.py and held against the JAX package.

Tolerances, each beside its assert: reduced tensors 1e-10 relative to the
field's largest entry (float64 contractions in another summation order);
ROM solve, estimate and indicators 1e-9; ROM = FOM of the reconstruction
1e-10; snapshots reproduced to 1e-8; correctors 1e-8 (dense patch LU
against masked PCG at 1e-12); greedy max estimates 1e-6 with equal
selections; online steps 1e-9 against JAX's (PCG at 1e-10); trajectories
1e-10 (dense LU) and 1e-8 (solve_batch's PCG against the per-mu LU).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.reductor import LRBMSReductor as JaxReductor  # noqa: E402
from pylrbms_tpu.reductor import ReducedModel as JaxReducedModel  # noqa: E402

from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402
from pylrbms_tpu_torch.convert import bases_from_numpy  # noqa: E402

CFG = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
FIELDS = JaxReducedModel._ARRAY_FIELDS


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def model3d():
    gpd = init_grid_and_problem(CFG)
    return gpd, discretize(gpd, device="cpu")[0]


@pytest.fixture(scope="module")
def jax_model3d():
    return jax_discretize(jax_problem(CFG))[0]


@pytest.fixture(scope="module")
def both(model3d, jax_model3d):
    """The JAX reductor with two snapshots, the port's with the same bases,
    and both reductions."""
    dj, dt = jax_model3d, model3d[1]
    red_j = JaxReductor(dj, order=0)
    for m in (0.3, 1.0):
        red_j.extend_basis(np.asarray(dj.solve({"diffusion": m}), np.float64))
    red_t = bases_from_numpy(dt, [np.asarray(b) for b in red_j.bases])
    return red_j.reduce(), red_t.reduce()


def test_reduced_tensors_equal_jax(both):
    """Every reduced field (27-neighbourhood padded) against JAX's."""
    rd_j, rd_t = both
    np.testing.assert_array_equal(rd_t.nbhd_idx, np.asarray(rd_j.nbhd_idx))
    assert rd_t.nbhd_idx.shape[1] == 27
    for name in FIELDS:
        a, b = getattr(rd_t, name), getattr(rd_j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert rel(a, b) < 1e-10, name


@pytest.mark.parametrize("m", [0.25, 0.6])
def test_rom_estimator_parity(model3d, both, m):
    """ROM solve and estimate equal JAX's (1e-9); the ROM estimator equals
    the FOM estimator of the reconstruction (1e-10)."""
    _, d = model3d
    rd_j, rd_t = both
    mu = {"diffusion": m}
    cj, ct = rd_j.solve(mu), rd_t.solve(mu)
    assert rel(ct, cj) < 1e-9
    eta_j, _, ind_j = rd_j.estimate(cj, mu, decompose=True)
    eta_t, _, ind_t = rd_t.estimate(ct, mu, decompose=True)
    assert rel(eta_t, eta_j) < 1e-9 and rel(ind_t, ind_j) < 1e-9
    eta_f, _, ind_f = d.estimate(rd_t.reconstruct(ct), mu, decompose=True)
    assert rel(eta_t, eta_f) < 1e-10 and rel(ind_t, ind_f) < 1e-10


def test_snapshot_reproduction(model3d):
    _, d = model3d
    red = LRBMSReductor(d, order=0)
    mus = (0.25, 0.7, 1.0)
    snaps = {m: d.solve({"diffusion": m}) for m in mus}
    for m in mus:
        red.extend_basis(snaps[m])
    rd = red.reduce()
    for m in mus:
        assert rel(rd.reconstruct(rd.solve({"diffusion": m})), snaps[m]) < 1e-8


def test_patch_corrector_residual_zero_at_fom(model3d, jax_model3d):
    """The 3x3x3-patch residual corrector vanishes at the FOM solution; the
    dense patch systems equal JAX's (1e-12) and so do the correctors of a
    non-solution (1e-10)."""
    _, d = model3d
    mu = {"diffusion": 0.8}
    U = d.solve(mu)
    w = d.solve_for_local_correction(4, mu=mu, current_solution=U, mode="residual")
    assert float(w.abs().max()) < 1e-9 * float(U.abs().max())
    dj = jax_model3d
    members, mats, b = d.assemble_patch(4, d.parse_parameter(mu))
    mj, matsj, bj = dj.assemble_patch(4, dj.parse_parameter(mu))
    assert members == list(mj) and len(members) == 8
    for a, c in zip(mats, matsj):
        assert rel(a, c) < 1e-12
    assert rel(b, bj) < 1e-12
    U0 = 0.3 * U
    wt = d.solve_for_local_correction(2, mu=mu, current_solution=U0)
    wj = dj.solve_for_local_correction(2, mu=mu, current_solution=jnp.asarray(U0.numpy()))
    assert rel(wt, wj) < 1e-10


@pytest.mark.parametrize("stencil", [False, True], ids=["dense", "stencil"])
def test_batched_corrector_matches_dense_patch(model3d, stencil):
    """One masked-PCG solve over the marked patches equals the host dense
    3x3x3-patch solver, with the dense and the stencil patch apply."""
    from pylrbms_tpu_torch.ops.corrector import BatchedCorrector
    _, d = model3d
    mu = {"diffusion": 0.55}
    U0 = 0.3 * d.solve({"diffusion": 1.0})
    corr = BatchedCorrector(d)
    assert corr.sides[-2:] == ("near", "far") and [a[0] for a in corr.axes] == list("XYZ")
    if stencil:
        corr.enable_stencil()
    marked = [0, 3, 7]
    W = corr.solve(marked, mu, current_solution=U0, tol=1e-12, maxiter=2000)
    for i, ii in enumerate(marked):
        w_ref = d.solve_for_local_correction(ii, mu=mu, current_solution=U0)
        assert rel(W[i], w_ref) < 1e-8, ii


def test_online_adaptive_enrichment(model3d):
    """From order-0 local bases, batched-corrector enrichment drives the
    ROM estimate to the FOM floor."""
    from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment
    gpd, d = model3d
    red = LRBMSReductor(d, order=0)
    rd = red.reduce()
    mu = {"diffusion": 0.55}
    eta_fom = float(d.estimate(d.solve(mu), mu))
    eta0 = float(rd.estimate(rd.solve(mu), mu))
    assert eta0 > 1.2 * eta_fom
    ae = AdaptiveEnrichment(gpd, d, d.space, red, rd, target_error=eta_fom * 1.05,
                            marking_doerfler_theta=0.5)
    out = ae.solve(mu, enrichment_steps=10)
    u = out[0] if isinstance(out, tuple) else out
    assert float(ae.rd.estimate(u, mu)) < 1.1 * eta_fom


def test_weak_greedy_against_jax(model3d, jax_model3d):
    """The weak greedy picks JAX's parameters with its max estimates (1e-6)
    and drops them 20x in three extensions; the direct FOM-residual sweep
    (through the 3D stencil) equals the Gramian form (1e-8)."""
    from pylrbms_tpu.greedy import weak_greedy as jax_weak_greedy
    from pylrbms_tpu_torch.greedy import weak_greedy, batched_estimates, _stack_mus
    _, d = model3d
    train = np.linspace(0.1, 1.0, 6)
    res = weak_greedy(d, [{"diffusion": m} for m in train], target_error=1e-8,
                      max_extensions=3)
    res_j = jax_weak_greedy(jax_model3d, [{"diffusion": m} for m in train],
                            target_error=1e-8, max_extensions=3)
    assert res.max_etas[-1] < 0.05 * res.max_etas[0], res.max_etas
    np.testing.assert_allclose(res.max_etas, res_j.max_etas, rtol=1e-6)
    assert [float(m["diffusion"]) for m in res.chosen_mus] == \
        [float(np.asarray(m["diffusion"]).ravel()[0]) for m in res_j.chosen_mus]
    red = LRBMSReductor(d, order=0)
    red.extend_basis(d.solve({"diffusion": 1.0}))
    rd = red.reduce()
    st = _stack_mus([d.parse_parameter(m) for m in (0.2, 0.6)])
    direct = batched_estimates(rd, st, criterion="residual_fom")
    gram = batched_estimates(rd, st, criterion="residual")
    assert rel(direct, gram) < 1e-8


@pytest.mark.parametrize("mf", [False, True, "affine"], ids=["dense", "stencil", "affine"])
def test_online_step_paths(model3d, jax_model3d, mf):
    """make_online_step on 3D reproduces the model solve and the local
    quantities (1e-8 / 1e-9) and JAX's step (1e-9); a batched call equals
    the single queries (1e-11; 1e-9 with the stencil's f32 factors)."""
    from pylrbms_tpu.model import make_online_step as jax_online_step
    from pylrbms_tpu_torch.model import make_online_step
    _, d = model3d
    m = 0.6
    U2 = d.solve({"diffusion": m})
    nc, r, df = d.estimator.local_quantities(U2[None], {"diffusion": m})
    ref_ind = (nc + r + df)[0]
    fn = make_online_step(d, tol=1e-10, maxiter=500, coarse_modes=4, matrix_free=mf)
    f64 = torch.float64
    U, ind = fn(torch.tensor([1.0, m], dtype=f64), torch.tensor([1.0], dtype=f64),
                {"diffusion": torch.tensor([m], dtype=f64)})
    assert rel(U, U2) < 1e-8 and rel(ind, ref_ind) < 1e-9
    fj = jax_online_step(jax_model3d, tol=1e-10, maxiter=500, coarse_modes=4,
                         matrix_free=mf)
    Uj, indj = fj(jnp.asarray([1.0, m]), jnp.asarray([1.0]), {"diffusion": jnp.asarray([m])})
    assert rel(U, Uj) < 1e-9 and rel(ind, indj) < 1e-9
    mus = np.asarray([0.3, 0.6, 1.0])
    thetas = torch.tensor(np.stack([np.ones(3), mus], 1))
    Ub, indb = fn(thetas, torch.ones((3, 1), dtype=f64),
                  {"diffusion": torch.tensor(mus[:, None])})
    # the stencil form applies its frozen block factors in f32, so the lane
    # equals the single query to the solve tolerance only (1e-9)
    tol = 1e-9 if mf is True else 1e-11
    assert rel(Ub[1], U) < tol and rel(indb[1], ind) < tol


def test_thermalblock3d_multiparameter():
    """3D thermal block (8 parameters, Q = 8): the diffusion components
    equal JAX's pointwise, the solve holds its residual, and the ROM
    estimate equals the FOM estimate of the reconstruction."""
    from pylrbms_tpu.problems.thermalblock3d import init_grid_and_problem as jax_tb3
    from pylrbms_tpu_torch.problems.thermalblock3d import init_grid_and_problem as tb3
    gpd = tb3(CFG)
    gj = jax_tb3(CFG)
    x = np.random.default_rng(0).uniform(-1, 1, size=(50, 3))
    for ft, fj in zip(gpd["lambda"]["functions"], gj["lambda"]["functions"]):
        np.testing.assert_array_equal(ft(torch.tensor(x)).numpy(),
                                      np.asarray(fj(jnp.asarray(x))))
    for key in ("lambda_bar", "lambda_hat", "f"):
        np.testing.assert_allclose(gpd[key](torch.tensor(x)).numpy(),
                                   np.asarray(gj[key](jnp.asarray(x))), rtol=1e-15)
    d, _ = discretize(gpd, device="cpu")
    assert d.op.A_diag.shape[0] == 8
    rng = np.random.default_rng(0)
    mu = {"diffusion": 0.1 + 0.9 * rng.random(8)}
    U = d.solve(mu)
    A, b = d.assemble(d.parse_parameter(mu)), d.rhs(d.parse_parameter(mu))
    assert rel(A.apply(U), b) < 1e-9
    red = LRBMSReductor(d, order=0)
    for _ in range(3):
        red.extend_basis(d.solve({"diffusion": 0.1 + 0.9 * rng.random(8)}))
    rd = red.reduce()
    mu_t = {"diffusion": 0.1 + 0.9 * rng.random(8)}
    c = rd.solve(mu_t)
    e_rom, e_fom = float(rd.estimate(c, mu_t)), float(d.estimate(rd.reconstruct(c), mu_t))
    assert abs(e_rom - e_fom) / e_fom < 1e-9


@pytest.fixture(scope="module")
def parabolic3d():
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg3d import discretize as disc_par
    return disc_par(init_grid_and_problem(CFG), T=1.0, nt=5, device="cpu")[0]


def test_parabolic_against_jax(parabolic3d):
    """The 3D implicit-Euler trajectory (dense G = M + dt A with the z
    couplings) and its parabolic estimate against JAX's (1e-10 / 1e-9);
    the block-PCG route gives the same trajectory (1e-9)."""
    from pylrbms_tpu.discretize_parabolic_block_swipdg3d import discretize as jax_disc_par
    from pylrbms_tpu_torch import model as model_mod
    im = parabolic3d
    imj, _ = jax_disc_par(jax_problem(CFG), T=1.0, nt=5)
    mu = {"diffusion": 0.7}
    traj = im.solve(mu)
    traj_j = imj.solve(imj.parse_parameter(mu))
    assert rel(traj, traj_j) < 1e-10
    est, parts = im.estimate(traj, mu)
    est_j, parts_j = imj.estimate(traj_j, imj.parse_parameter(mu))
    assert rel(est, est_j) < 1e-9
    for a, b in zip(parts, parts_j):
        assert rel(a, b) < 1e-9
    old = model_mod.TRAJ_DENSE_MAX_DOFS
    try:
        model_mod.TRAJ_DENSE_MAX_DOFS = 0
        assert rel(im.solve(mu), traj) < 1e-9
        assert im.last_solve_iters.shape == (5,)
    finally:
        model_mod.TRAJ_DENSE_MAX_DOFS = old


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "exact"])
def test_parabolic_solve_batch_matches_per_mu(parabolic3d, shared):
    """B trajectories through the lane-batched 3D stencil of G (the mass
    as the family's first component) equal the per-mu solves."""
    im = parabolic3d
    mus = [im.parse_parameter({"diffusion": s}) for s in (0.3, 0.7, 1.0)]
    batch = im.solve_batch(mus, shared_preconditioner=shared)
    assert batch.shape[:2] == (3, 6)
    for i, mu in enumerate(mus):
        assert rel(batch[i], im.solve(mu)) < 1e-8, i


def test_spe10_3d_lean_solve_and_estimate():
    """SPE10 model 2 in 3D (synthetic block, contrast 1e4): the lean
    discretization solves with block PCG and estimates in positive form,
    equal to JAX's (1e-9)."""
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d as jax_spe10_3d
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    gpd = init_grid_and_problem_3d(CFG, max_contrast=1e4)
    d, _ = discretize(gpd, device="cpu", lean=True)
    dj, _ = jax_discretize(jax_spe10_3d(CFG, max_contrast=1e4), lean=True)
    mu = {"switch": 1.0}
    opts = {"type": "pcg", "precision": 1e-12}
    U = d.solve(mu, opts)
    Uj = dj.solve(dj.parse_parameter(mu), opts)
    assert rel(U, Uj) < 1e-9
    assert rel(d.estimate(U, mu), dj.estimate(Uj, dj.parse_parameter(mu))) < 1e-9
    Um = d.solve(mu, {"type": "mf_pcg", "precision": 1e-9, "mixed": True,
                      "coarse_space": "modal", "coarse_modes": 4})
    A, b = d.assemble(d.parse_parameter(mu)), d.rhs(d.parse_parameter(mu))
    assert float((A.apply(Um) - b).abs().max() / b.abs().max()) < 1e-7
