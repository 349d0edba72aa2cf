"""Port Q2 on the 3D hex family (ops/rt1hex: the RT_[1] hex flux space, the
order-2 branch of the 3D discretizer) and the 3D prolongation
(ops/prolong.prolongation_gather_3d) against the JAX package on CPU
float64, mirrored from tests/test_hex3d_q2.py and tests/test_prolong3d.py.

Blocks stay at Q2 s = 1 (N = 27): torch's CPU batched LU (MKL, two
threads) has hung on stacks of blocks with N >= ~190 (Q2 s = 2 is N = 216).  Tolerances:

* the RT_[1] hex tables (moment-dual basis, divergences, layouts) equal
  JAX's to 1e-12; duality and the per-cell Gauss identity to 1e-10;
* the RT_[1] reconstruction and the Q2 estimator tensors against JAX's
  (1e-12), the local quantities of both forms (1e-10), matrix form =
  positive form (1e-9);
* the Q2 stencil apply equals the dense-block apply (1e-13) and its PCG
  reaches 1e-10;
* prolongation: polynomial interpolants prolong exactly (1e-12), a
  cellwise constant one-sidedly (exactly), and equal JAX's gather (1e-14).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops import rt1hex as jax_rt1hex  # noqa: E402
from pylrbms_tpu.grid3d import Grid3D as JaxGrid3D  # noqa: E402
from pylrbms_tpu.ops.spaces3d import BlockDGSpace3D as JaxSpace3D  # noqa: E402
from pylrbms_tpu.ops.prolong import prolong as jax_prolong  # noqa: E402

from pylrbms_tpu_torch.grid3d import Grid3D  # noqa: E402
from pylrbms_tpu_torch.ops.spaces3d import BlockDGSpace3D  # noqa: E402
from pylrbms_tpu_torch.ops import rt1hex  # noqa: E402
from pylrbms_tpu_torch.ops.prolong import prolong  # noqa: E402
from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402

CFG = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 0}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _grid(k, s, cls=Grid3D):
    return cls(lower_left=(0.0, 0.0, 0.0), upper_right=(1.0, 1.0, 1.0),
               kx=k[0], ky=k[1], kz=k[2], s=s)


@pytest.fixture(scope="module")
def q2():
    """(JAX Q2 model, port Q2 model) on CFG (s = 1, N = 27)."""
    dj, _ = jax_discretize(jax_problem(CFG), order=2)
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu", order=2)
    return dj, dt


def test_rt1hex_duality_and_divergence():
    sp = BlockDGSpace3D(_grid((2, 2, 2), 1), order=2)
    Minv, chi, div = rt1hex._moment_dual_h(sp)
    M = np.linalg.inv(Minv)
    np.testing.assert_allclose(M @ Minv, np.eye(36), atol=1e-10)
    vol_int = sp.volume * np.einsum("q,qj->j", sp.vol_w, div)
    face_sum = np.zeros(36)
    face_sum[0:24:4] = [-1.0, 1.0, -1.0, 1.0, -1.0, 1.0]     # signed m0 moments
    np.testing.assert_allclose(vol_int, face_sum, atol=1e-10)
    spj = JaxSpace3D(_grid((2, 2, 2), 1, JaxGrid3D), order=2)
    for a, b in zip((Minv, chi, div), jax_rt1hex._moment_dual_h(spj)):
        assert rel(a, b) <= 1e-12


@pytest.mark.parametrize("k,s", [((2, 1, 1), 1), ((1, 2, 2), 2)])
def test_rt1hex_layout_consistency(k, s):
    sp = BlockDGSpace3D(_grid(k, s), order=2)
    spj = JaxSpace3D(_grid(k, s, JaxGrid3D), order=2)
    l2g = rt1hex.rt1hex_local_to_global(sp)
    np.testing.assert_array_equal(l2g, jax_rt1hex.rt1hex_local_to_global(spj))
    assert l2g.shape == (sp.K, rt1hex.N_rt1h(sp))
    assert len(np.unique(l2g)) == rt1hex.N_rt1h_global(sp) == l2g.max() + 1
    chi, idx, div = rt1hex.rt1hex_cell_tab(sp)
    np.testing.assert_array_equal(idx, jax_rt1hex.rt1hex_cell_tab(spj)[1])
    assert idx.max() == rt1hex.N_rt1h(sp) - 1
    for a, b in zip(rt1hex.rt_tab_any_order3(sp), jax_rt1hex.rt_tab_any_order3(spj)):
        if isinstance(a, np.ndarray):
            assert rel(a, b) <= 1e-12
        else:
            assert a == b


def test_q2_tensors_and_reconstruction_against_jax(q2):
    """The Q2 operator, the RT_[1] estimator tensors and the RT_[1]
    reconstruction of random DG functions against JAX's."""
    dj, dt = q2
    assert dt.space.N == 27 and type(dt.estimator.data.flux).__name__ == "FluxReconstructorRT1Hex"
    for name in ("A_diag", "C_R_io", "C_U_oi", "C_W_io", "C_W_oi"):
        assert rel(getattr(dt.op, name), getattr(dj.op, name)) <= 1e-12, name
    for name in ("E_bar", "L2", "M_aa", "BB", "M_ab", "A_div", "R_dd", "d_vec"):
        assert rel(getattr(dt.estimator.data, name), getattr(dj.estimator.data, name)) <= 1e-12
    U = np.random.default_rng(5).normal(size=(2, dt.space.K, dt.space.N))
    fj, ft = dj.estimator.data.flux, dt.estimator.data.flux
    for lj, lt in zip(dj.estimator.data.lambda_funcs, dt.estimator.data.lambda_funcs):
        assert rel(ft.apply(lt, torch.tensor(U)), fj.apply(lj, jnp.asarray(U))) <= 1e-12


def test_q2_matrix_vs_positive_paths(q2):
    """Matrix-form = positive-form local quantities on the port (1e-9),
    and both equal JAX's (1e-10)."""
    dj, dt = q2
    mu = {"diffusion": 0.6}
    U, Uj = dt.solve(mu), dj.solve(dj.parse_parameter(mu))
    assert rel(U, Uj) <= 1e-12
    est = dt.estimator
    q_mat = est.local_quantities(U[None], dt.parse_parameter(mu))
    q_pos = est.local_quantities_positive(U[None], dt.parse_parameter(mu))
    for a, b in zip(q_mat, q_pos):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-13)
    for fn, q in (("local_quantities", q_mat), ("local_quantities_positive", q_pos)):
        qj = getattr(dj.estimator, fn)(Uj[None], dj.parse_parameter(mu))
        for a, b in zip(q, qj):
            assert rel(a, b) <= 1e-10, fn


def test_q2_matrix_free_stencil_matches_dense(q2):
    """The Q2 hex stencil equals the dense-block apply and its PCG with the
    subdomain block factors converges; mf_pcg solves the model."""
    _, d = q2
    theta = torch.tensor([1.0, 0.45], dtype=torch.float64)
    A_mf, A_d = d.mf_operator().assemble(theta), d.op.assemble(theta)
    x = torch.tensor(np.random.default_rng(7).normal(size=(d.space.K, d.space.N)))
    assert rel(A_mf.apply(x), A_d.apply(x)) <= 1e-13
    b = d.rhs_q[0]
    xs = A_mf.solve_pcg(b, tol=1e-11, maxiter=3000,
                        block_factors=A_d.block_jacobi_factors())
    assert float(torch.linalg.norm(A_d.apply(xs) - b) / torch.linalg.norm(b)) < 1e-10
    mu = d.parse_parameter(0.45)
    U = d.solve(mu, {"type": "mf_pcg", "precision": 1e-11})
    assert rel(U, A_d.solve_dense(b)) <= 1e-9


def test_q2_rom_equals_fom_of_reconstruction_and_parabolic(q2):
    """MOR on Q2: the ROM estimate equals the FOM estimate of the
    reconstruction (1e-10); the Q2 parabolic estimate is finite."""
    from pylrbms_tpu_torch.reductor import LRBMSReductor
    from pylrbms_tpu_torch.model import InstationaryBlockModel
    _, d = q2
    red = LRBMSReductor(d, order=0)
    for m in (0.3, 1.0):
        red.extend_basis(d.solve({"diffusion": m}))
    rd = red.reduce()
    mu = {"diffusion": 0.6}
    c = rd.solve(mu)
    assert rel(rd.estimate(c, mu), d.estimate(rd.reconstruct(c), mu)) < 1e-10
    im = InstationaryBlockModel(stationary=d, T=1.0, nt=3)
    eta, parts = im.estimate(im.solve(mu), mu)
    assert np.isfinite(float(eta)) and float(eta) > 0 and len(parts) == 5


def _interp(space, f):
    return f(space.node_coords_phys()).reshape(space.K, space.N)


@pytest.mark.parametrize("order", [1, 2])
def test_prolong3d_same_order_exact(order):
    sc = BlockDGSpace3D(_grid((2, 2, 2), 2), order=order)
    sf = BlockDGSpace3D(_grid((2, 2, 2), 4), order=order)
    if order == 1:
        f = lambda x: (1.0 + 2 * x[..., 0] - 3 * x[..., 1]          # noqa: E731
                       + 0.5 * x[..., 2] + x[..., 0] * x[..., 1] * x[..., 2])
    else:
        f = lambda x: ((1 + x[..., 0] ** 2) * (2 - x[..., 1] + x[..., 1] ** 2)  # noqa: E731
                       * (1 + 0.3 * x[..., 2] ** 2))
    Uc = _interp(sc, f)
    Uf = prolong(sc, torch.tensor(Uc), sf).numpy()
    assert np.abs(Uf - _interp(sf, f)).max() < 1e-12
    Ub = prolong(sc, torch.tensor(np.stack([Uc, 2 * Uc])), sf).numpy()
    assert np.abs(Ub[1] - 2 * Uf).max() < 1e-12
    scj = JaxSpace3D(_grid((2, 2, 2), 2, JaxGrid3D), order=order)
    sfj = JaxSpace3D(_grid((2, 2, 2), 4, JaxGrid3D), order=order)
    V = np.random.default_rng(order).normal(size=Uc.shape)
    assert rel(prolong(sc, torch.tensor(V), sf), jax_prolong(scj, V, sfj)) <= 1e-14


def test_prolong3d_q1_into_q2_and_block_relayout():
    sc = BlockDGSpace3D(_grid((2, 2, 1), 2), order=1)    # 4x4x2 cells
    sf = BlockDGSpace3D(_grid((4, 4, 2), 2), order=2)    # 8x8x4 cells
    f = lambda x: 1.0 - x[..., 0] + 2 * x[..., 1] * x[..., 2]   # noqa: E731
    Uf = prolong(sc, torch.tensor(_interp(sc, f)), sf).numpy()
    assert np.abs(Uf - _interp(sf, f)).max() < 1e-12


def test_prolong3d_discontinuous_one_sided():
    sc = BlockDGSpace3D(_grid((2, 1, 1), 1), order=1)    # 2x1x1 cells
    sf = BlockDGSpace3D(_grid((2, 1, 1), 2), order=1)    # 4x2x2 cells
    Uc = np.zeros((sc.K, sc.N))
    Uc[1] = 1.0
    want = np.zeros((sf.K, sf.N))
    want[1] = 1.0
    assert np.abs(prolong(sc, torch.tensor(Uc), sf).numpy() - want).max() == 0.0
