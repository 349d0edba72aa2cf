"""The port's batched patch corrector (``ops/corrector.py``) on CPU float64,
mirrored from tests/test_corrector.py, and against the JAX package's.

On CPU tensors the kernel wrappers take their plain versions, so these tests
hold the masked PCG, its masks and its preconditioner; the kernels
themselves are held to the plain versions on the card (tests/test_torch_cuda.py).
Tolerances: the batched corrector against the dense host patch solve 1e-8
at PCG tol 1e-10 (1e-7 at the reference test's 1e-12 / 500 iterations, kept
as there); against the JAX corrector 1e-8 (the same PCG, products summed in
another order).  Blocks stay at N <= 96: the corrector inverts ``[K, N, N]``
in one call, and torch's CPU batched LU (2.13 with MKL, two threads) has hung
on stacks of larger blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops.corrector import BatchedCorrector as JaxCorrector  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from pylrbms_tpu_torch.ops.corrector import (SIDES, BatchedCorrector,  # noqa: E402
                                             patch_coarse_matrix)

CFG = {"num_subdomains": [3, 3],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
CFG43 = dict(CFG, num_subdomains=[4, 3])


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def fom():
    d, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return d


def test_batched_corrector_matches_host_patch_solver(fom):
    d = fom
    mu = d.parse_parameter(0.4)
    U = d.solve(mu)
    bc = BatchedCorrector(d)
    marked = [0, 1, 3, 4]       # corner, edge, edge, interior patches in one batch
    W = bc.solve(marked, mu, current_solution=U, mode="residual", tol=1e-12, maxiter=500)
    assert 0 < bc.last_iters < 500
    for i, k in enumerate(marked):
        w_ref = d.solve_for_local_correction(k, None, mu, current_solution=U, mode="residual")
        assert rel(W[i], w_ref) < 1e-7, k


@pytest.mark.parametrize("two_level", [True, False])
def test_batched_corrector_default_tolerance(fom, two_level):
    """Against the dense patch solve at the default PCG tol 1e-10: 1e-8.  A
    residual far from zero (0.4 of the solution), three marked subdomains
    padded to four lanes."""
    d = fom
    mu = d.parse_parameter(0.6)
    U0 = 0.4 * d.solve(mu)
    marked = [8, 2, 4]
    W = BatchedCorrector(d).solve(marked, mu, current_solution=U0, two_level=two_level)
    assert W.shape == (3, d.space.N)
    for i, k in enumerate(sorted(marked)):
        w_ref = d.solve_for_local_correction(k, None, mu, current_solution=U0)
        assert rel(W[i], w_ref) < 1e-8, k


def test_batched_corrector_f_mode(fom):
    d = fom
    mu = d.parse_parameter(1.0)
    W = BatchedCorrector(d).solve([4], mu, mode="reference", tol=1e-12, maxiter=500)
    w_ref = d.solve_for_local_correction(4, None, mu, mode="reference")
    assert rel(W[0], w_ref) < 1e-7


def test_batched_corrector_rhs_override_and_empty(fom):
    d = fom
    mu = d.parse_parameter(0.5)
    bc = BatchedCorrector(d)
    assert bc.solve([], mu).shape == (0, d.space.N)
    W = bc.solve([4], mu, rhs_full=d.rhs(mu))
    assert rel(W, bc.solve([4], mu, mode="reference")) == 0.0


def test_patch_coarse_matrix_exact(fom):
    """The two-level patch preconditioner's coarse matrix is the EXACT
    Galerkin coarse matrix of the masked patch operator."""
    d = fom
    mu = d.parse_parameter(0.7)
    theta = d.theta(mu)
    bc = BatchedCorrector(d)
    st = d.op.static
    mix = lambda C: torch.einsum("q,q...->...", theta, C)   # noqa: E731
    D = {sd: mix(bc.D_side[sd]) for sd in SIDES}
    Rq = {nm: mix(v) for nm, v in bc.quads["R"].items()}
    Uq = {nm: mix(v) for nm, v in bc.quads["U"].items()}
    A0c = mix(bc.A0c_q)
    marked = [0, 1, 4]
    pmask = bc.patch_mask_table[marked]
    idx = torch.as_tensor
    fams = [(Rq, D["right"], D["left"], idx(st.left_k), idx(st.right_k)),
            (Uq, D["top"], D["bottom"], idx(st.low_k), idx(st.up_k))]
    Ac = patch_coarse_matrix(A0c, pmask, fams).numpy()
    N = d.space.N
    for b, k in enumerate(marked):
        members, A_q, _ = d.assemble_patch(k, mu)
        A_patch = sum(float(t) * A.numpy() for t, A in zip(theta, A_q))
        m = len(members)
        ref = A_patch.reshape(m, N, m, N).sum(axis=(1, 3))     # [m, m]
        np.testing.assert_allclose(Ac[b][np.ix_(members, members)], ref,
                                   rtol=1e-10, atol=1e-12)
        outside = np.setdiff1d(np.arange(d.space.K), members)
        if outside.size:       # rows/cols outside the patch are zero
            assert np.abs(Ac[b][np.ix_(outside, outside)]).max() == 0.0


def test_coarse_matrix_is_the_galerkin_matrix_on_constants(fom):
    d = fom
    A = d.assemble(d.parse_parameter(0.7))
    K, N = d.space.K, d.space.N
    ref = A.to_dense().reshape(K, N, K, N).sum(dim=(1, 3))
    assert rel(A.coarse_matrix(), ref) < 1e-12


def test_stencil_patch_apply_matches_dense():
    """The matrix-free patch apply (global stencil on the masked field +
    strip corrections for patch-crossing faces) equals the dense-block
    patch apply (1e-9: two PCGs at 1e-12)."""
    d, _ = discretize(init_grid_and_problem(CFG43), device="cpu")
    mu = d.parse_parameter(0.6)
    U0 = 0.4 * d.solve(mu)
    marked = [0, 5, 11]
    bc = BatchedCorrector(d)
    assert bc.stencils is None          # dense below 32 768 dofs
    W_d = bc.solve(marked, mu, current_solution=U0, tol=1e-12, maxiter=2000)
    W_s = BatchedCorrector(d).enable_stencil().solve(
        marked, mu, current_solution=U0, tol=1e-12, maxiter=2000)
    assert float(W_d.abs().max()) > 1e-3
    np.testing.assert_allclose(W_s.numpy(), W_d.numpy(), rtol=1e-9, atol=1e-12)


def test_corrector_goes_through_both_kernel_wrappers(fom, monkeypatch):
    """The dense apply calls block_matvec with G = 1 and one lane per marked
    patch (no padding), the preconditioner precond_dot; the stencil apply
    calls precond_dot only."""
    from pylrbms_tpu_torch.ops import corrector as mod
    calls = []

    def bm(A, x, coef=None):
        calls.append(("block_matvec",) + tuple(A.shape) + tuple(x.shape))
        return hk.block_matvec_plain(A, x, coef)

    def pd(F, r):
        calls.append(("precond_dot",) + tuple(F.shape) + tuple(r.shape))
        return hk.precond_dot_plain(F, r)

    monkeypatch.setattr(mod, "block_matvec", bm)
    monkeypatch.setattr(mod, "precond_dot", pd)
    d = fom
    K, N = d.space.K, d.space.N
    mu = d.parse_parameter(0.5)
    bc = BatchedCorrector(d)
    bc.solve([1, 4, 6], mu)
    assert ("block_matvec", 1, K, N, N, 3, K, N) in calls
    assert ("precond_dot", K, N, N, 3, K, N) in calls
    assert {c[-3] for c in calls} == {3}
    assert len([c for c in calls if c[0] == "precond_dot"]) == bc.last_iters + 1
    calls.clear()
    bc.enable_stencil().solve([1, 4], mu)
    assert {c[0] for c in calls} == {"precond_dot"}


def test_masked_rz_equals_dot_of_r_and_z(fom, monkeypatch):
    """The CG scalar is built from precond_dot's per-subdomain partials,
    masked as the reference masks z: with the partials replaced by garbage
    the solve must change, with z . r recomputed from z it must not."""
    from pylrbms_tpu_torch.ops import corrector as mod
    d = fom
    mu = d.parse_parameter(0.5)
    U0 = 0.4 * d.solve(mu)
    W = BatchedCorrector(d).solve([0, 4], mu, current_solution=U0)

    def pd_checked(F, r):
        z, rz = hk.precond_dot_plain(F, r)
        # r is masked to the patch, so the partials vanish outside it
        assert rel((r * z).sum(-1), rz) < 1e-13
        return z, rz

    monkeypatch.setattr(mod, "precond_dot", pd_checked)
    W2 = BatchedCorrector(d).solve([0, 4], mu, current_solution=U0)
    assert torch.equal(W, W2)
    monkeypatch.setattr(mod, "precond_dot",
                        lambda F, r: (hk.precond_dot_plain(F, r)[0],
                                      torch.ones(r.shape[:2], dtype=r.dtype)))
    W3 = BatchedCorrector(d).solve([0, 4], mu, current_solution=U0)
    assert rel(W3, W) > 1e-6


@pytest.mark.parametrize("stencil", [False, True], ids=["dense", "stencil"])
def test_batched_corrector_equals_jax(stencil):
    """Same current solution, same marked set: W within 1e-8 of the JAX
    corrector's (both run the masked PCG to tol 1e-10)."""
    dj, _ = jax_discretize(jax_problem(CFG43))
    dt, _ = discretize(init_grid_and_problem(CFG43), device="cpu")
    U0 = 0.4 * np.asarray(dj.solve(dj.parse_parameter(0.6)))
    marked = [0, 5, 6, 7, 11]
    bj, bt = JaxCorrector(dj), BatchedCorrector(dt)
    if stencil:
        bj.enable_stencil()
        bt.enable_stencil()
    Wj = np.asarray(bj.solve(marked, dj.parse_parameter(0.6), current_solution=U0))
    Wt = bt.solve(marked, 0.6, current_solution=torch.tensor(U0))
    assert rel(Wt, Wj) < 1e-8
    assert rel(bt.A0c_q, bj.A0c_q) < 1e-12
