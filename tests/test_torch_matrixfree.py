"""Port matrix-free stencil solve (pylrbms_tpu_torch.ops.matrixfree,
ops/ir.py, StationaryBlockModel.solve 'mf_pcg', make_online_step's stencil
form) against the JAX package on CPU float64.

* stencil fields equal the JAX assembly to 1e-12, the apply equals JAX's
  stencil apply and the port's own block apply to 1e-13 (single and 3
  lanes), the cell-Jacobi factors equal JAX's to 1e-12 (tri and quad);
* ``solve_pcg`` with each preconditioner (cell Jacobi, subdomain blocks,
  blocks + coarse basis, cell Jacobi + subdomain constants) on carried-over
  arrays: equal PCG iteration counts and U to 1e-10;
* ``d.solve`` 'mf_pcg' (modal / harvested) on the carried-over stencil
  operator and frozen preconditioner: equal ``last_solve_iters``, U to
  1e-10; the freeze happens at the first theta, as in JAX;
* the model's contract around it: background freeze, options-keyed cache,
  divergence guard, post-check fallback, 'auto' resolution, mixed
  precision (``mixed=True``) to 1e-8 of the dense solve;
* the online step: ``matrix_free=None`` resolves to the stencil at
  >= 16384 dofs; ``certify`` on an f32 model recovers the f64 solution of
  the f32 operator (1e-8) and matches JAX's certified step (1e-6).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.model import make_online_step as jax_online_step  # noqa: E402
from pylrbms_tpu.ops.matrixfree import (assemble_swipdg_stencil as jax_stencil,  # noqa: E402
                                        StencilOperator as JaxStencilOperator)
from pylrbms_tpu.la.block import prepare_coarse as jax_prepare_coarse  # noqa: E402

from pylrbms_tpu_torch import model as model_mod  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.model import SolverError, make_online_step  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree import (StencilOperator,  # noqa: E402
                                              assemble_swipdg_stencil, cast)
from pylrbms_tpu_torch.ops.ir import solve_ir, diag_of_blocks  # noqa: E402
from pylrbms_tpu_torch.convert import (arrays_from_numpy, precond_from_numpy,  # noqa: E402
                                       stencils_from_numpy)
from pylrbms_tpu_torch.la.block import AffineBlockApply  # noqa: E402

f64 = torch.float64
CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 2}
THETA = [1.0, 0.4]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cfg(kx, ky, grid_type="tri", nref=1):
    return {"num_subdomains": [kx, ky],
            "half_num_fine_elements_per_subdomain_and_dim": 1,
            "num_refinements": nref, "grid_type": grid_type}


@pytest.fixture(scope="module", params=[(2, 2, "tri"), (3, 2, "tri"), (2, 2, "quad")],
                ids=lambda p: "-".join(map(str, p)))
def stencil_pair(request):
    """(JAX model, port model, JAX stencils, port stencils) per family."""
    c = cfg(*request.param)
    dj, _ = jax_discretize(jax_problem(c))
    dt, _ = discretize(init_grid_and_problem(c), device="cpu")
    sj = tuple(jax_stencil(dj.space, lf, None) for lf in dj.estimator.data.lambda_funcs)
    st = tuple(assemble_swipdg_stencil(dt.space, lf, None)
               for lf in dt.estimator.data.lambda_funcs)
    return dj, dt, sj, st


def _leaves(s):
    return [s.vol, *s.D, *s.V, *s.H, *s.R, *s.U, *(s.D_side[k] for k in sorted(s.D_side))]


def test_stencil_fields_match_jax(stencil_pair):
    _, _, sj, st = stencil_pair
    for a, b in zip(st, sj):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert tuple(x.shape) == tuple(y.shape)
            if x.numel():
                assert rel(x, y) <= 1e-12


def test_apply_matches_jax_and_block_apply(stencil_pair):
    dj, dt, sj, st = stencil_pair
    A = StencilOperator(dt.space, st).assemble(torch.tensor(THETA, dtype=f64))
    Aj = JaxStencilOperator(dj.space, sj).assemble(jnp.asarray(THETA))
    Ab = dt.op.assemble(torch.tensor(THETA, dtype=f64))
    rng = np.random.default_rng(9)
    for shape in ((dt.space.K, dt.space.N), (3, dt.space.K, dt.space.N)):
        x = rng.normal(size=shape)
        y = A.apply(torch.tensor(x))
        assert rel(y, Aj.apply(jnp.asarray(x))) <= 1e-13
        assert rel(y, Ab.apply(torch.tensor(x))) <= 1e-13


def test_cell_jacobi_factors_match_jax(stencil_pair):
    dj, dt, sj, st = stencil_pair
    F = StencilOperator(dt.space, st).assemble(torch.tensor(THETA, dtype=f64)).cell_jacobi_factors()
    Fj = JaxStencilOperator(dj.space, sj).assemble(jnp.asarray(THETA)).cell_jacobi_factors()
    assert rel(F, Fj) <= 1e-12


def test_lane_batched_assemble_equals_single_thetas(stencil_pair):
    """theta [B, Q] gives every field a lane axis; lane b of the apply is
    the apply at theta[b]."""
    _, dt, _, st = stencil_pair
    op = StencilOperator(dt.space, st)
    th = torch.tensor([[1.0, 0.2], [1.0, 0.6], [1.0, 0.9]], dtype=f64)
    x = torch.tensor(np.random.default_rng(4).normal(size=(3, dt.space.K, dt.space.N)))
    y = op.assemble(th).apply(x)
    for i in range(3):
        assert rel(y[i], op.assemble(th[i]).apply(x[i])) <= 1e-14


# ---------------------------------------------------------------------------
# solve_pcg on carried-over arrays
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried_pcg():
    """JAX model with its stencil operator, block factors, conditioned modal
    coarse space and subdomain-constant coarse inverse, and the port's
    assembled stencil built from the same (carried) tensors."""
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    sj = tuple(jax_stencil(dj.space, lf, None) for lf in dj.estimator.data.lambda_funcs)
    Aj = JaxStencilOperator(dj.space, sj).assemble(jnp.asarray(THETA))
    Ad = dj.op.assemble(jnp.asarray(THETA))
    bf = Ad.block_jacobi_factors()
    C, ci = jax_prepare_coarse(Ad, Ad.coarse_modes_basis(dj.space, 3))
    ci0 = jnp.asarray(np.linalg.inv(np.asarray(Ad.coarse_matrix())))
    A = StencilOperator(dt.space, stencils_from_numpy(sj)).assemble(torch.tensor(THETA, dtype=f64))
    b = np.random.default_rng(2).normal(size=(3, dt.space.K, dt.space.N))
    return Aj, A, b, {"bf": bf, "C": C, "ci": ci, "ci0": ci0}


PRECONDS = {
    "cell_jacobi": {},
    "block_factors": {"block_factors": "bf"},
    "block_coarse_basis": {"block_factors": "bf", "coarse_inv": "ci", "coarse_basis": "C"},
    "cell_subdomain_constants": {"coarse_inv": "ci0"},
}


@pytest.mark.parametrize("kind", sorted(PRECONDS))
def test_solve_pcg_preconditioners_against_jax(carried_pcg, kind):
    """Equal iteration counts and U to 1e-10, single rhs and per lane of a
    3-lane solve (each lane frozen at its own convergence), at solve
    tolerance 1e-12: the block factors are applied in f32, whose summation
    order differs between einsums, so two solves stopped at 1e-10 may differ
    by that tolerance times the conditioning.  For the same reason a lane
    of the 3-lane f32 apply (another reduction than the single lane's) may
    stop one iteration apart from the single solve."""
    Aj, A, b, pre = carried_pcg
    lane_slack = 1 if "block_factors" in PRECONDS[kind] else 0
    kj = {k: pre[v] for k, v in PRECONDS[kind].items()}
    kt = {k: torch.tensor(np.asarray(pre[v])) for k, v in PRECONDS[kind].items()}
    xt, itt = A.solve_pcg(torch.tensor(b), tol=1e-12, maxiter=2000, return_iters=True, **kt)
    for i in range(b.shape[0]):
        xj, itj = Aj.solve_pcg(jnp.asarray(b[i]), tol=1e-12, maxiter=2000,
                               return_iters=True, **kj)
        x1, it1 = A.solve_pcg(torch.tensor(b[i]), tol=1e-12, maxiter=2000,
                              return_iters=True, **kt)
        assert int(it1) == int(itj)
        assert abs(int(itt[i]) - int(itj)) <= lane_slack
        assert rel(x1, xj) <= 1e-10
        assert rel(xt[i], xj) <= 1e-10


def test_solve_pcg_coarse_f32_and_x0(carried_pcg):
    """The model solve's options: the coarse level applied in f32 on an f64
    Krylov space, and a warm start."""
    Aj, A, b, pre = carried_pcg
    kw = dict(block_factors="bf", coarse_inv="ci", coarse_basis="C")
    kj = {k: pre[v] for k, v in kw.items()}
    kt = {k: torch.tensor(np.asarray(pre[v])) for k, v in kw.items()}
    x0 = 0.5 * b[0]
    xj, itj = Aj.solve_pcg(jnp.asarray(b[0]), tol=1e-10, return_iters=True,
                           coarse_f32=True, x0=jnp.asarray(x0), **kj)
    xt, itt = A.solve_pcg(torch.tensor(b[0]), tol=1e-10, return_iters=True,
                          coarse_f32=True, x0=torch.tensor(x0), **kt)
    assert int(itt) == int(itj)
    assert rel(xt, xj) <= 1e-10


# ---------------------------------------------------------------------------
# StationaryBlockModel.solve 'mf_pcg'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return dj, dt


def fresh_port_model():
    return discretize(init_grid_and_problem(CFG), device="cpu")[0]


def dense_solution(d, mu):
    mu = d.parse_parameter(mu)
    return d.assemble(mu).solve_dense(d.rhs(mu))


# Solve precision per coarse space, chosen where the stopping test is not
# decided by rounding.  The preconditioner is applied in f32 while the
# residual falls far below f32 resolution, so the late residual history is
# driven by the f32 rounding of each library's einsums and the two
# histories drift apart by tens of percent; where the residual stays close
# to precision * |b| for two iterations, the counts differ by one.  The
# counts must also agree at precisions 15% tighter and looser
# (MF_PRECISION_SCALES): a choice that sits on a step of the residual
# history fails there, so the equality does not hang on one rounding.
MF_PRECISION = {"modal": 2.5e-12, "harvested": 5e-10}
MF_PRECISION_SCALES = (0.85, 1.0, 1.15)


def _carried_mf_solves(dj, coarse_space, precision):
    """The JAX model's stencil operator and its preconditioner frozen at
    mu=0.7 go into a fresh port model; both solve at mu=0.7 and then 0.5.
    Returns [(port U, JAX U, port iterations, JAX iterations)] and the
    port model."""
    dt = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": precision,
            "coarse_space": coarse_space, "coarse_modes": 4}
    ref = []
    for m in (0.7, 0.5):
        ref.append((dj.solve(dj.parse_parameter(m), inverse_options=opts),
                    int(dj.last_solve_iters)))
    pkey = ("precond", True, coarse_space, 4)
    dt._mf_sop = StencilOperator(dt.space, stencils_from_numpy(dj.mf_operator().stencils))
    dt._mf_cache[pkey] = precond_from_numpy(dj._mf_jit_cache[pkey])
    out = []
    for m, (U_ref, it_ref) in zip((0.7, 0.5), ref):
        U = dt.solve(m, inverse_options=opts)
        out.append((U, U_ref, int(dt.last_solve_iters), it_ref))
    return out, dt


@pytest.mark.parametrize("coarse_space", sorted(MF_PRECISION))
def test_mf_solve_carried_against_jax(models, coarse_space):
    """On the carried-over stencil operator and frozen preconditioner the
    port's solves at 0.7 and then 0.5 take the JAX iteration counts and
    match its U to 1e-10; the freeze leaves one preconditioner key."""
    out, dt = _carried_mf_solves(models[0], coarse_space, MF_PRECISION[coarse_space])
    for U, U_ref, it, it_ref in out:
        assert rel(U, U_ref) <= 1e-10
        assert it == it_ref
    assert [k for k in dt._mf_cache if k[0] == "precond"] == [("precond", True, coarse_space, 4)]


@pytest.mark.parametrize("scale", [s for s in MF_PRECISION_SCALES if s != 1.0])
@pytest.mark.parametrize("coarse_space", sorted(MF_PRECISION))
def test_mf_solve_carried_counts_hold_near_precision(models, coarse_space, scale):
    """The equal counts of the carried solves hold at precisions 15%
    tighter and looser than MF_PRECISION, with U to 1e-10."""
    out, _ = _carried_mf_solves(models[0], coarse_space, scale * MF_PRECISION[coarse_space])
    for U, U_ref, it, it_ref in out:
        assert rel(U, U_ref) <= 1e-10
        assert it == it_ref


@pytest.mark.parametrize("coarse_space", ["modal", "harvested"])
def test_mf_solve_freezes_at_first_theta_like_jax(coarse_space):
    """End to end (each side builds its own preconditioner): both freeze it
    at the first theta seen (mu=0.7), so the block factors are those of
    A(0.7) on both sides, and the solutions agree to 1e-9."""
    dj, _ = jax_discretize(jax_problem(CFG))
    dt = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": 1e-12, "coarse_space": coarse_space,
            "coarse_modes": 4}
    for m in (0.7, 0.5):
        Uj = dj.solve(dj.parse_parameter(m), inverse_options=opts)
        U = dt.solve(m, inverse_options=opts)
        assert rel(U, Uj) <= 1e-9
        assert rel(U, dense_solution(dt, m)) <= 1e-9
    pkey = ("precond", True, coarse_space, 4)
    bf = dt._mf_cache[pkey][0]
    assert rel(bf, dj._mf_jit_cache[pkey][0]) <= 1e-12
    assert rel(bf, dt.assemble(dt.parse_parameter(0.7)).block_jacobi_factors()) <= 1e-14


def test_prepare_solver_background_freeze():
    """A background freeze raced by a foreground solve builds exactly one
    preconditioner, and the solve matches the dense solve."""
    d = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": 1e-12, "coarse_space": "modal", "coarse_modes": 3}
    t = d.prepare_solver(mu=0.5, inverse_options=opts, background=True)
    assert isinstance(t, threading.Thread)
    U = d.solve(0.7, inverse_options=opts)
    t.join(timeout=60)
    assert not t.is_alive()
    assert rel(U, dense_solution(d, 0.7)) <= 1e-8
    assert len([k for k in d._mf_cache if k[0] == "precond"]) == 1
    assert d.prepare_solver(inverse_options={"type": "dense"}) is None


def test_solution_cache_keyed_by_options():
    d = fresh_port_model().enable_caching()
    o = {"type": "mf_pcg", "coarse_modes": 3}
    U1 = d.solve(0.7, inverse_options=dict(o, precision=1e-2))
    U2 = d.solve(0.7, inverse_options=dict(o, precision=1e-12))
    assert float((U1 - U2).abs().max()) > 0.0      # distinct solves
    assert d.solve(0.7, inverse_options=dict(o, precision=1e-12)) is U2
    assert d.last_solve_iters is None               # a cache hit has no count
    d.disable_caching()
    assert d.solve(0.7, inverse_options=dict(o, precision=1e-12)) is not U2


def test_mf_solve_divergence_guard():
    d = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": 1e-12, "max_iter": 1, "two_level": False}
    with pytest.raises(SolverError, match="diverged or stalled"):
        d.solve(0.7, inverse_options=opts)
    U = d.solve(0.7, inverse_options=dict(opts, post_check=False))
    assert bool(torch.isfinite(U).all())


def test_post_check_solves_system_falls_back_to_dense():
    """A stalled mf solve under post_check_solves_system is repaired by the
    dense fallback; with fallback=False it raises."""
    d = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": 1e-12, "max_iter": 1, "two_level": False,
            "post_check_solves_system": 1e-10}
    U = d.solve(0.7, inverse_options=opts)
    assert rel(U, dense_solution(d, 0.7)) <= 1e-12
    with pytest.raises(SolverError, match="post-check failed"):
        d.solve(0.7, inverse_options=dict(opts, fallback=False))


def test_auto_takes_mf_pcg_above_threshold(monkeypatch):
    """'auto' resolves to mf_pcg above MF_SOLVE_MIN_DOFS (lowered here to
    the test model's size), and below it to the assembled solvers."""
    d = fresh_port_model()
    U = d.solve(0.6)
    assert d.last_solve_iters is None
    monkeypatch.setattr(model_mod, "MF_SOLVE_MIN_DOFS", d.space.K * d.space.N - 1)
    Umf = d.solve(0.6)
    assert int(d.last_solve_iters) > 0
    assert rel(Umf, U) <= 1e-8


def test_mixed_precision_solve_matches_dense():
    d = fresh_port_model()
    opts = {"type": "mf_pcg", "precision": 1e-10, "mixed": True, "coarse_modes": 4}
    U = d.solve(0.3, inverse_options=opts)
    assert rel(U, dense_solution(d, 0.3)) <= 1e-8
    assert int(d.last_solve_iters) > 0
    assert d._mf_cache["sop32"].stencils[0].vol.dtype == torch.float32


def test_solve_ir_starved_inner_falls_back(models):
    """A starved inner solve (1 iteration, 2 rounds) stalls; the f64 polish
    still meets the tolerance (cell-Jacobi factors path of the f32 M)."""
    _, d = models
    theta = d.theta(d.parse_parameter(0.8))
    A = d.mf_operator().assemble(theta)
    b = d.rhs(d.parse_parameter(0.8))
    dvec = torch.einsum("q,qkn->kn", theta, diag_of_blocks(d.op.A_diag))
    sp = d.space
    x, it32, rounds, it64 = solve_ir(
        A, cast(A, torch.float32), b, dvec, tol=1e-11, maxiter=4000,
        factors=A.cell_jacobi_factors(), cell_shape=(sp.K, sp.s, sp.s, sp.T * sp.nb),
        inner_maxiter=1, max_rounds=2, return_info=True)
    assert rounds <= 2 and int(it64) > 0
    r = torch.linalg.norm((b - A.apply(x)).reshape(-1)) / torch.linalg.norm(b.reshape(-1))
    assert float(r) <= 1e-11


def test_model_contract_helpers(models):
    dj, dt = models
    assert "local_energy_dg_product_2" in dt.operators and "nope_1" not in dt.operators
    assert rel(dt.operators["r_ud_1"], dj.operators["r_ud_1"]) <= 1e-12
    assert rel(dt.operators["nc_0"], dj.operators["nc_0"]) <= 1e-12
    V = torch.tensor(np.random.default_rng(5).normal(size=(2, dt.space.K, dt.space.N)))
    assert rel(dt.l2_solve(V), dj.l2_solve(jnp.asarray(V.numpy()))) <= 1e-10
    assert rel(dt.operator_apply(V[0], dt.parse_parameter(0.4)), dj.operator_apply(jnp.asarray(V[0].numpy()),
                                                               dj.parse_parameter(0.4))) <= 1e-13
    assert dt.solution_shape == dj.solution_shape
    assert torch.equal(dt.reblock(dt.unblock(V)), V)
    for order in (0, 1):
        assert rel(dt.shape_functions(3, order), dj.shape_functions(3, order)) <= 1e-15


# ---------------------------------------------------------------------------
# online step
# ---------------------------------------------------------------------------

def test_matrix_free_none_resolves_to_stencil_at_scale():
    """>= 16384 dofs (16x12 subdomains, s=4: 18432): the reference's default
    online step is the stencil form; it answers a query to the tolerance
    and its iteration probe reports that solve.  (Small blocks, N=96: with
    torch.set_num_threads(2) the CPU build's batched LU of 384x384 blocks
    can hang.)"""
    c = {"num_subdomains": [16, 12], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 2}
    d, _ = discretize(init_grid_and_problem(c), device="cpu", lean=True)
    assert d.space.K * d.space.N == 18432
    step = make_online_step(d, tol=1e-8, with_estimate=False)
    assert "stencils" in step.arrays
    th, tf = torch.tensor([1.0, 0.5], dtype=f64), torch.tensor([1.0], dtype=f64)
    U = step(th, tf)
    mu = d.parse_parameter(0.5)
    b = d.rhs(mu)
    r = torch.linalg.norm((b - d.assemble(mu).apply(U)).reshape(-1)) / torch.linalg.norm(b.reshape(-1))
    assert float(r) <= 1e-7
    assert 0 < step.iters_probe(th, tf) <= 400
    small, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    assert "stencils" not in make_online_step(small, with_estimate=False).arrays


@pytest.fixture(scope="module")
def f32_models():
    gpd = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 2,
           "num_refinements": 1}
    dj, _ = jax_discretize(jax_problem(gpd), dtype=jnp.float32)
    dt, _ = discretize(init_grid_and_problem(gpd), device="cpu", dtype=torch.float32)
    return dj, dt


def _step_operator_dense(d, step, matrix_free, theta):
    """The certified step's operator at theta (f32, as the step builds it),
    widened to f64, as a dense [K*N, K*N] matrix."""
    a = step.arrays
    if matrix_free is True:
        A = StencilOperator(d.space, a["stencils"]).assemble(theta)
    else:
        A = AffineBlockApply(d.op.static, a["A_diag"], a["C_R_io"], a["C_R_oi"],
                             a["C_U_io"], a["C_U_oi"], theta)
    KN = d.space.K * d.space.N
    E = torch.eye(KN, dtype=f64).reshape(KN, d.space.K, d.space.N)
    return cast(A, f64).apply(E).reshape(KN, KN).T


@pytest.mark.parametrize("matrix_free", [True, "affine"])
def test_certify_on_f32_model(f32_models, matrix_free):
    """certify polishes the f32 solve to the f64 solution of the step's own
    f32 operator (widened): the returned U, f32 as in JAX, is that solution
    to f32 resolution (1e-7; the plain f32 step at tol 1e-6 is not), and
    the indicators, evaluated in f64 on the polished U, equal the f64
    estimator on that solution to 1e-8.  Single and 2 lanes (the lanes'
    operator is the lane form's: on tri P1 the f32 components mixed by
    theta in f64, the f32 mix elsewhere); against JAX's certified step on
    the same (carried) arrays to 1e-6."""
    dj, dt = f32_models
    kw = dict(tol=1e-6, maxiter=500, matrix_free=matrix_free, certify=True)
    st = make_online_step(dt, **kw)
    sj = jax_online_step(dj, **kw)
    # both steps polish to the same f32 operator: carry JAX's arrays over
    st.arrays.update(arrays_from_numpy({k: np.asarray(v) for k, v in sj.arrays.items()
                                        if k != "stencils"}, dtype=torch.float32))
    if matrix_free is True:
        st.arrays["stencils"] = stencils_from_numpy(sj.arrays["stencils"], dtype=torch.float32)
    est64 = model_mod._wide_estimator(dt.estimator, f64)
    mus = np.array([0.3, 0.9])
    th = np.stack([np.ones(2), mus], 1).astype(np.float32)
    tf = np.ones((2, 1), np.float32)
    Ub, indb = st(torch.tensor(th), torch.tensor(tf), {"diffusion": torch.tensor(mus[:, None])})
    assert indb.dtype == f64
    for i, m in enumerate(mus):
        mu = {"diffusion": torch.tensor([m])}
        b64 = dt.rhs(dt.parse_parameter(m)).double()

        def certified(theta):
            """(U, indicators) of the f64 solve with the step's operator at theta."""
            A64 = _step_operator_dense(dt, st, matrix_free, theta)
            U_ref = torch.linalg.solve(A64, b64.reshape(-1)).reshape(b64.shape)
            return U_ref, sum(est64.local_quantities_positive(
                U_ref[None], mu, tensors={"E_bar": st.arrays["E_bar"].double()}))[0]
        U_ref, ind_ref = certified(torch.tensor(th[i]))
        # the lanes' operator: lane i alone (a one-lane stencil broadcasts)
        Ub_ref, indb_ref = certified(torch.tensor(th[i:i + 1] if matrix_free is True else th[i]))
        U1, ind1 = st(torch.tensor(th[i]), torch.tensor(tf[i]), mu)
        Uj, indj = sj(jnp.asarray(th[i]), jnp.asarray(tf[i]), {"diffusion": jnp.asarray([m])})
        assert U1.dtype == torch.float32
        assert rel(U1, U_ref) <= 1e-7 and rel(Ub[i], Ub_ref) <= 1e-7
        assert rel(ind1, ind_ref) <= 1e-8 and rel(indb[i], indb_ref) <= 1e-8
        assert rel(U1, Uj) <= 1e-6
        assert rel(ind1, indj) <= 1e-6
