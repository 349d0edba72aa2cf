"""The port's parabolic FOM (implicit-Euler trajectories, the mass stencil,
the parabolic estimator) and the remaining 2D problems' time switch,
against the JAX package on CPU float64.

Inputs: the artificial-channels problem (the parabolic showcase) on 3x2
subdomains, half 1, nref 1 (N = 24) unless said, nt 3-6, parameters from a
numpy seed.  Tolerances, each stated beside its assert: the mass stencil
1e-12 relative to the field's max |.|; the dense-LU and block-PCG
trajectories 1e-10 with equal PCG iteration counts (f64 throughout); the
matrix-free trajectory 1e-10 with equal counts at a solve tolerance clear
of a residual step (its block factors are applied in f32, so the late
residual history follows each library's f32 rounding, see
tests/test_torch_matrixfree.py::MF_PRECISION); the estimator's five groups
1e-9.  Blocks stay at N <= 96: torch's CPU batched LU (MKL, two threads)
has hung on stacks of larger blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems.artificial_channels import init_grid_and_problem as jax_channels  # noqa: E402
from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize as jax_parabolic  # noqa: E402
from pylrbms_tpu.discretize_parabolic_swipdg import discretize as jax_parabolic_mono  # noqa: E402
from pylrbms_tpu.la.block import AssembledBlockOp as JaxAssembledBlockOp  # noqa: E402
from pylrbms_tpu.ops.matrixfree import mass_stencil as jax_mass_stencil  # noqa: E402
from pylrbms_tpu.parameters import evaluate_coefficients as jax_coefficients  # noqa: E402

import pylrbms_tpu_torch.model as port_model  # noqa: E402
from pylrbms_tpu_torch.problems.artificial_channels import init_grid_and_problem as channels  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_parabolic_swipdg import discretize as discretize_mono  # noqa: E402
from pylrbms_tpu_torch.convert import instationary_from_numpy  # noqa: E402
from pylrbms_tpu_torch.estimators import EllipticEstimator  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree import mass_stencil  # noqa: E402

CFG = {"num_subdomains": [3, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
# 9x8 subdomains of N = 96: 6912 dofs, past the dense-LU limit (6144), so
# both packages take the block-Jacobi PCG trajectory
CFG_PCG = {"num_subdomains": [9, 8],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 2}
T, NT = 1.0, 5
RNG = np.random.default_rng(5)
SWITCHES = RNG.uniform(0.01, 1.0, 3)
# solve tolerance of the matrix-free trajectory comparisons (see the header)
MF_TOL = 1e-10


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def mu_of(s):
    return {"switch": float(s)}


@pytest.fixture(scope="module")
def models():
    imj, _ = jax_parabolic(jax_channels(CFG), T=T, nt=NT)
    imt, _ = discretize(channels(CFG), T=T, nt=NT, device="cpu")
    return imj, imt


def fresh(nt=NT):
    return discretize(channels(CFG), T=T, nt=nt, device="cpu")[0]


def unfrozen(imj):
    """The module's JAX model with its parabolic coarse freezes dropped (its
    compiled functions stay cached)."""
    cache = imj.stationary._mf_jit_cache
    for k in [k for k in cache if isinstance(k, tuple) and k[0] == "parab_precond"]:
        del cache[k]
    return imj


def test_discretize_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        discretize(channels(CFG), T=T, nt=NT)


@pytest.mark.parametrize("nt", [4, 5, 6, 8, 10, 20])
def test_time_switch_equals_jax_and_numpy(nt):
    """theta_f(mu, t_n) at every step of the channels' f: the 0/1 switch
    sin(4 pi t) > 0 decided on the host in float64 as in JAX and numpy."""
    imt = fresh(nt)
    f_j = jax_channels(CFG)["f"]["coefficients"]
    dt = T / nt
    steps = imt._theta_f_steps(imt.parse_parameter(mu_of(0.5)), dt).numpy()
    assert steps.shape == (nt, 2)
    for n in range(nt):
        t = (n + 1.0) * dt
        th = steps[n]
        thj = np.asarray(jax_coefficients(f_j, {"switch": np.array([0.5]), "_t": t}))
        assert np.array_equal(th, thj)
        assert th[0] == float(np.sin(2 * 2 * np.pi * t) > 0) and th[1] == -1.0


def test_mass_stencil_equals_jax(models):
    """mass_stencil: the volume mass blocks, zero face families shaped like
    the operator's stencils, entry by entry to 1e-12."""
    imj, imt = models
    st_j = jax_mass_stencil(imj.stationary.space, imj.stationary.mf_operator().stencils[0])
    st_t = mass_stencil(imt.stationary.space, imt.stationary.mf_operator().stencils[0])
    assert rel(st_t.vol, st_j.vol) <= 1e-12
    for fam in ("D", "V", "H", "R", "U"):
        for a, b in zip(getattr(st_t, fam), getattr(st_j, fam)):
            assert tuple(a.shape) == tuple(b.shape) and not a.any()
    assert {k: tuple(v.shape) for k, v in st_t.D_side.items()} == \
        {k: tuple(v.shape) for k, v in st_j.D_side.items()}
    # the stencil mass applies the block-diagonal L2 product
    x = torch.as_tensor(RNG.standard_normal((imt.stationary.space.K, imt.stationary.space.N)))
    _, M_op = imt._mf_parab_setup()
    y = torch.einsum("knm,km->kn", imt.mass, x)
    assert rel(M_op.apply(x), y) <= 1e-12


@pytest.mark.parametrize("s", SWITCHES[:2])
def test_dense_trajectory_equals_jax(models, s):
    imj, imt = models
    U = imt.solve(mu_of(s))
    Uj = imj.solve(imj.parse_parameter(mu_of(s)))
    assert tuple(U.shape) == (NT + 1,) + imt.stationary.solution_shape
    assert rel(U, Uj) <= 1e-10
    assert imt.last_solve_iters is None


def test_block_pcg_trajectory_equals_jax():
    """6912 dofs: block-Jacobi PCG on M + dt A, U to 1e-10 and per step the
    iteration counts of the JAX block operator's PCG on the same rhs."""
    nt = 3
    imj, _ = jax_parabolic(jax_channels(CFG_PCG), T=T, nt=nt, lean=True)
    imt, _ = discretize(channels(CFG_PCG), T=T, nt=nt, device="cpu", lean=True)
    mu = mu_of(SWITCHES[0])
    U = imt.solve(mu)
    muj = imj.parse_parameter(mu)
    Uj = np.asarray(imj.solve(muj))
    assert rel(U, Uj) <= 1e-10
    st = imj.stationary
    dt = T / nt
    A = st.assemble(muj)
    G = JaxAssembledBlockOp(A.static, imj.mass + dt * A.A_diag, dt * A.C_R_io, dt * A.C_R_oi,
                            dt * A.C_U_io, dt * A.C_U_oi, None, None)
    factors = G.block_jacobi_factors()
    its = []
    for n in range(nt):
        mu_t = dict(muj, _t=(n + 1.0) * dt)
        rhs = (np.einsum("knm,km->kn", np.asarray(imj.mass), Uj[n])
               + dt * np.einsum("q,qkn->kn", np.asarray(st.theta_f(mu_t)), np.asarray(st.rhs_q)))
        _, it = G.solve_pcg(rhs, tol=1e-10, maxiter=500, factors=factors, return_iters=True)
        its.append(int(it))
    assert imt.last_solve_iters.tolist() == its


@pytest.mark.parametrize("two_level,extrapolate", [(False, True), (True, True), (True, False)])
def test_mf_trajectory_equals_jax(models, two_level, extrapolate):
    """The matrix-free route: U to 1e-10 and the JAX iteration counts per
    step, with and without the frozen coarse level and the linear
    warm-start extrapolation (at n = 0, u_prev = u = 0)."""
    imj = unfrozen(models[0])
    imt = fresh()
    dt = T / NT
    kw = dict(tol=MF_TOL, two_level=two_level, coarse_modes=4, extrapolate=extrapolate,
              return_iters=True)
    for s in SWITCHES[:2]:
        U, its = imt._solve_mf(imt.parse_parameter(mu_of(s)), dt, **kw)
        Uj, itsj = imj._solve_mf(imj.parse_parameter(mu_of(s)), dt, **kw)
        assert rel(U, Uj) <= 1e-10
        assert its.tolist() == np.asarray(itsj).tolist()


def test_mf_route_forced_by_the_size_threshold(models, monkeypatch):
    """With the threshold at 0, solve() takes the stencil trajectory with
    its defaults (two-level above the threshold, 16 harvested modes), equal
    to JAX's _solve_mf with those defaults and to the dense trajectory."""
    imj = unfrozen(models[0])
    imt = fresh()
    monkeypatch.setattr(port_model, "MF_SOLVE_MIN_DOFS", 0)
    mu = mu_of(SWITCHES[1])
    U = imt.solve(mu)
    its = imt.last_solve_iters
    Uj, itsj = imj._solve_mf(imj.parse_parameter(mu), T / NT, two_level=True,
                             return_iters=True)
    assert rel(U, Uj) <= 1e-10
    assert its.tolist() == np.asarray(itsj).tolist()
    assert ("parab_precond", T / NT, "harvested", 16) in imt.stationary._mf_cache
    assert rel(U, imj.solve(imj.parse_parameter(mu))) <= 1e-8


def test_mixed_precision_trajectory_matches_f64(models):
    """precision='mixed' (f32 iterative refinement, ops/ir.py): the
    trajectory of the f64 route and of JAX's mixed route to 1e-8."""
    imj, imt = models
    dt = T / NT
    mu = mu_of(SWITCHES[2])
    U = imt._solve_mf(imt.parse_parameter(mu), dt, precision="mixed", tol=1e-10)
    Uj = imj._solve_mf(imj.parse_parameter(mu), dt, precision="mixed", tol=1e-10)
    assert rel(U, Uj) <= 1e-8
    assert rel(U, imt.solve(mu)) <= 1e-8


def test_unported_and_unknown_options_raise(models):
    """inner='halo' is ported (the halo-dense f32 inner operator gives the
    stencil-inner trajectory to 1e-8); it needs precision='mixed', and
    unknown precisions and inner forms raise."""
    _, imt = models
    mu = imt.parse_parameter(mu_of(0.5))
    U_halo = imt._solve_mf(mu, T / NT, precision="mixed", inner="halo")
    assert rel(U_halo, imt._solve_mf(mu, T / NT, precision="mixed")) <= 1e-8
    with pytest.raises(ValueError, match="mixed"):
        imt._solve_mf(mu, T / NT, inner="halo")
    with pytest.raises(ValueError):
        imt._solve_mf(mu, T / NT, precision="mixed", inner="banded")
    with pytest.raises(ValueError):
        imt._solve_mf(mu, T / NT, precision="bf16")


def test_coarse_freeze_is_keyed_by_dt(models):
    """The coarse space on G is frozen at the first theta per (dt, space,
    modes): a second mu reuses it, another dt builds its own; each freeze
    equals the JAX one built by the same call sequence (1e-10)."""
    imj = unfrozen(models[0])
    imt = fresh()
    calls = [(SWITCHES[0], 0.2), (SWITCHES[1], 0.2), (SWITCHES[1], 0.1)]
    for s, dt in calls:
        imt._solve_mf(imt.parse_parameter(mu_of(s)), dt, two_level=True, coarse_modes=4)
        imj._solve_mf(imj.parse_parameter(mu_of(s)), dt, two_level=True, coarse_modes=4)
    keys = sorted(k for k in imt.stationary._mf_cache
                  if isinstance(k, tuple) and k[0] == "parab_precond")
    assert keys == [("parab_precond", 0.1, "harvested", 4), ("parab_precond", 0.2, "harvested", 4)]
    for key in keys:
        C, ci = imt.stationary._mf_cache[key]
        Cj, cij = imj.stationary._mf_jit_cache[key]
        assert rel(C, Cj) <= 1e-10 and rel(ci, cij) <= 1e-10
    C02 = imt.stationary._mf_cache[keys[1]][0]
    ref = imt._euler_operator(imt.stationary.assemble(mu_of(SWITCHES[0])), 0.2)
    from pylrbms_tpu_torch.la.block import harvested_coarse_basis, prepare_coarse
    C_first = prepare_coarse(ref, harvested_coarse_basis(
        ref, ref.block_jacobi_factors(), imt.stationary.space, n_harvest=4, extra_modal=3))[0]
    assert rel(C02, C_first) <= 1e-12


@pytest.mark.parametrize("shared", [True, False])
def test_solve_batch_lanes_equal_single_mu_solves(models, shared):
    """solve_batch: [B, nt+1, K, N]; with exact per-mu factors each lane is
    the single-mu trajectory (same iterate sequence: 1e-12, equal counts);
    with the factors shared at mu_bar each lane converges to it (1e-8).
    Both equal JAX's solve_batch to 1e-10."""
    imj = unfrozen(models[0])
    imt = fresh()
    dt = T / NT
    mus = [mu_of(s) for s in SWITCHES]
    kw = dict(two_level=True, coarse_modes=4)
    # freeze the coarse level at the batch's first mu on both sides
    imt._solve_mf(imt.parse_parameter(mus[0]), dt, **kw)
    imj._solve_mf(imj.parse_parameter(mus[0]), dt, **kw)
    Ub = imt.solve_batch(mus, shared_preconditioner=shared, **kw)
    its_b = imt.last_solve_iters
    assert tuple(Ub.shape) == (len(mus), NT + 1) + imt.stationary.solution_shape
    Ubj = imj.solve_batch([imj.parse_parameter(m) for m in mus],
                          shared_preconditioner=shared, **kw)
    assert rel(Ub, Ubj) <= 1e-10
    for b, m in enumerate(mus):
        U, its = imt._solve_mf(imt.parse_parameter(m), dt, return_iters=True, **kw)
        if shared:
            assert rel(Ub[b], U) <= 1e-8
        else:
            assert rel(Ub[b], U) <= 1e-12
            assert its_b[b].tolist() == its.tolist()


def test_parabolic_estimator_equals_jax(models):
    """The five groups (nc, r, df with the elliptic reconstruction, time
    residual, time-derivative nonconformity) and eta on the same
    trajectory, to 1e-9; '_t' defaults to 0."""
    imj, imt = models
    mu = mu_of(SWITCHES[0])
    Uj = np.array(imj.solve(imj.parse_parameter(mu)))
    eta, parts = imt.estimate(torch.as_tensor(Uj), mu)
    etaj, partsj = imj.estimate(Uj, imj.parse_parameter(mu))
    assert abs(float(eta) - float(etaj)) <= 1e-9 * abs(float(etaj))
    for a, b in zip(parts, partsj):
        assert rel(a, b) <= 1e-9
    eta0, _ = imt.estimate(torch.as_tensor(Uj), dict(mu, _t=0.0))
    assert float(eta0) == float(eta)
    for p in parts:
        assert bool(torch.isfinite(p).all()) and bool((p >= 0).all())


def test_elliptic_reconstruction_estimate_equals_jax(models):
    imj, imt = models
    mu = dict(mu_of(SWITCHES[1]), _t=0.0)
    Uj = np.array(imj.solve(imj.parse_parameter(mu)))
    est = EllipticEstimator(imt.stationary.estimator.data)
    out = est.estimate(torch.as_tensor(Uj), imt.parse_parameter(mu), decompose=True, d=imt,
                       elliptic_reconstruction=True)
    outj = imj.stationary.estimator.estimate(Uj, imj.parse_parameter(mu), d=imj, decompose=True,
                                             elliptic_reconstruction=True)
    assert rel(out[0], outj[0]) <= 1e-9
    for a, b in zip(out[1], outj[1]):
        assert rel(a, b) <= 1e-9
    assert rel(out[2], outj[2]) <= 1e-9


def test_lean_model_refuses_the_elliptic_reconstruction():
    imt, _ = discretize(channels(CFG), T=T, nt=NT, device="cpu", lean=True)
    U = imt.solve(mu_of(0.5))
    with pytest.raises(ValueError, match="lean"):
        imt.estimate(U, mu_of(0.5))


def test_instationary_from_numpy_carries_the_mass(models):
    imj, imt = models
    carried = instationary_from_numpy(imt.stationary, imj.T, imj.nt, np.asarray(imj.mass))
    assert (carried.T, carried.nt) == (T, NT)
    assert rel(carried.mass, imj.mass) == 0.0
    assert rel(carried.solve(mu_of(0.3)), imt.solve(mu_of(0.3))) <= 1e-13


def test_monolithic_parabolic_discretizer_equals_jax():
    """K = 1 (the monolithic SWIPDG discretizer) on the OS2015 problem:
    the dense trajectory to 1e-10."""
    cfg = dict(CFG, num_subdomains=[2, 2])
    imj, _ = jax_parabolic_mono(jax_os2015(cfg), T=0.5, nt=4)
    imt, _ = discretize_mono(os2015(cfg), T=0.5, nt=4, device="cpu")
    assert imt.stationary.space.K == 1
    U = imt.solve(0.6)
    assert rel(U, imj.solve(imj.parse_parameter(0.6))) <= 1e-10
