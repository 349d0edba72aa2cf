"""The port's MOR layer (reductor, reduced model, online enrichment) on CPU
float64: its own consistency checks, mirrored from tests/test_mor.py and
tests/test_colored_images.py, and parity with the JAX package from the same
bases (carried across by ``convert.bases_from_numpy``).

Tolerances, each stated beside its assert: reduced tensors 1e-10 relative
to the field's max |.| (float64 contractions that differ in summation order
only); reduced solve, estimate and indicators 1e-9 (one dense LU of a
conditioned system on top); ``residual_norm`` 1e-7 (a cancellation of three
terms); enrichment eta 1e-6 (PCG correctors at 1e-10 feed a Gram-Schmidt).
Blocks stay at N <= 96 (half 1): torch's CPU batched LU (2.13 with MKL, two
threads) has hung on stacks of larger blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.reductor import LRBMSReductor as JaxReductor  # noqa: E402
from pylrbms_tpu.reductor import ReducedModel as JaxReducedModel  # noqa: E402
from pylrbms_tpu.online_enrichment import AdaptiveEnrichment as JaxEnrichment  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.convert import bases_from_numpy, reduced_from_numpy  # noqa: E402
from pylrbms_tpu_torch.reductor import (ExtensionError, LRBMSReductor,  # noqa: E402
                                        ParallelLRBMSReductor, ReducedModel)
from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment, doerfler_marking  # noqa: E402

CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
CFG42 = dict(CFG, num_subdomains=[4, 2])
CFG32 = dict(CFG, num_subdomains=[3, 2])
CFG66 = dict(CFG, num_subdomains=[6, 6], num_refinements=0)
RED_TENSORS = ("A_red", "b_red", "G_nc", "AA", "ABT", "BBT", "DV", "RD")
FIELDS = JaxReducedModel._ARRAY_FIELDS


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_online_step_cache():
    """The JAX package caches its jitted reduced online step by array shapes
    alone, closed over the first reduced model (its parameter type): a model
    of equal shapes from another file run earlier in this worker process
    would be reused here.  Start this file with an empty cache."""
    from pylrbms_tpu import reductor as jax_reductor
    jax_reductor._ONLINE_JIT_CACHE.clear()


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def fom_of(cfg):
    gpd = init_grid_and_problem(cfg)
    d, data = discretize(gpd, device="cpu")
    return gpd, d, data


@pytest.fixture(scope="module")
def fom():
    return fom_of(CFG)


@pytest.fixture(scope="module")
def d66():
    return fom_of(CFG66)[1]


# ---------------------------------------------------------------- the port alone

def test_rom_reproduces_fom_when_solution_in_basis(fom):
    _, d, _ = fom
    mu = d.parse_parameter(0.5)
    U = d.solve(mu)
    red = LRBMSReductor(d, order=0)
    red.extend_basis(U)
    rd = red.reduce()
    # exact Galerkin projection: the snapshot is in the basis (1e-10)
    assert rel(red.reconstruct(rd.solve(mu)), U) < 1e-10


def test_rom_estimator_matches_fom_estimator_on_reconstruction(fom):
    _, d, _ = fom
    red = LRBMSReductor(d, order=0)
    for m in (0.2, 1.0):
        red.extend_basis(d.solve(d.parse_parameter(m)))
    rd = red.reduce()
    mu = d.parse_parameter(0.6)
    c = rd.solve(mu)
    eta_r, parts_r, ind_r = rd.estimate(c, mu, decompose=True)
    eta_f, parts_f, ind_f = d.estimate(red.reconstruct(c), mu, decompose=True)
    for a, b in zip(parts_r + (ind_r,), parts_f + (ind_f,)):
        assert rel(a, b) < 1e-10      # the projected estimator is exact
    assert rel(eta_r, eta_f) < 1e-10


def test_extension_error_on_duplicates(fom):
    _, d, _ = fom
    red = LRBMSReductor(d, order=0)
    U = d.solve(d.parse_parameter(1.0))
    red.extend_basis(U)
    with pytest.raises(ExtensionError):
        red.extend_basis(U)    # same snapshot again adds nothing


def test_doerfler_marking_minimal_prefix():
    ind = [3.0, 1.0, 2.0, 0.5]
    # squared: 9, 1, 4, 0.25; sorted desc: 9(0), 4(2), 1(1), 0.25(3); total 14.25
    assert doerfler_marking(ind, 0.6) == [0]          # 9 > 8.55
    assert doerfler_marking(ind, 0.7) == [0, 2]       # 13 > 9.975
    assert set(doerfler_marking(torch.tensor(ind), 1.0)) == {0, 1, 2, 3}
    with pytest.raises(ValueError):
        doerfler_marking(ind, 0.0)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "host"])
def test_adaptive_enrichment_reduces_eta(fom, batched):
    gpd, d, _ = fom
    red = LRBMSReductor(d, order=0)
    rd = red.reduce()
    mu = d.parse_parameter(0.3)
    eta0 = float(rd.estimate(rd.solve(mu), mu))
    loop = AdaptiveEnrichment(gpd, d, d.space, red, rd, target_error=1e-12,
                              marking_doerfler_theta=0.5, marking_max_age=100,
                              batched_correctors=batched)
    etas = []
    loop.solve(mu, enrichment_steps=3,
               callback=lambda rd_, u, mu_, info: etas.append(info["eta"]))
    assert etas[0] == pytest.approx(eta0, rel=1e-8)
    assert etas[-1] < 0.6 * etas[0], f"enrichment did not reduce eta: {etas}"


def test_corrector_patch_matches_global_matrix(fom):
    """On the 2x2 grid the patch of subdomain 0 is the whole domain with the
    true boundary as its Dirichlet boundary: the patch matrix equals the
    global matrix (1e-12 of its largest entry)."""
    _, d, _ = fom
    mu = d.parse_parameter(1.0)
    members, mats, _ = d.assemble_patch(0, mu)
    A_patch = sum(float(t) * M for t, M in zip(d.theta(mu), mats))
    assert members == sorted(members)
    assert rel(A_patch, d.assemble(mu).to_dense()) < 1e-12


def test_online_step_matches_eager_solve_estimate(fom):
    _, d, _ = fom
    rd = LRBMSReductor(d).reduce()
    c, eta, ind = rd.online_step(0.7)
    c2 = rd.solve(0.7)
    eta2, _, ind2 = rd.estimate(c2, 0.7, decompose=True)
    assert torch.equal(c, c2) and float(eta) == float(eta2) and torch.equal(ind, ind2)


def test_online_step_lanes_match_single_queries(fom):
    """The B-lane form of the online step: lane b == the single query at
    mu_b (1e-10: the batched LU pivots like the single one)."""
    _, d, _ = fom
    red = LRBMSReductor(d, order=0)
    red.extend_basis(d.solve(d.parse_parameter(1.0)))
    rd = red.reduce()
    mus = np.array([0.1, 0.4, 0.9])
    c, eta, ind = rd.online_step({"diffusion": torch.tensor(mus[:, None])})
    assert c.shape == (3, d.space.K, rd.r_max) and eta.shape == (3,)
    for b, m in enumerate(mus):
        c1, eta1, ind1 = rd.online_step(float(m))
        assert rel(c[b], c1) < 1e-10
        assert rel(eta[b], eta1) < 1e-10
        assert rel(ind[b], ind1[:, 0]) < 1e-10


def test_lean_reduce_matches_standard():
    """The lean reduce (row-chunked images, several chunks, no Gramians)
    equals the standard one (1e-13: same contractions, other chunking)."""
    _, d, data = fom_of(CFG42)
    red = LRBMSReductor(d, products=data["local_energy_dg_product"], order=0)
    for v in (0.3, 1.0):
        red.extend_basis(d.solve({"diffusion": v}))
    rd_ref = red.reduce()
    red.force_lean = True
    red.use_colored_images = False
    red.force_chunk = 4           # R_all = 32 -> 8 chunks
    rd_lean = red.reduce()
    assert rd_ref.G_AA is not None and rd_lean.G_AA is None
    for name in RED_TENSORS:
        assert rel(getattr(rd_lean, name), getattr(rd_ref, name)) < 1e-13, name
    mu = {"diffusion": 0.55}
    e1 = float(rd_ref.estimate(rd_ref.solve(mu), mu))
    e2 = float(rd_lean.estimate(rd_lean.solve(mu), mu))
    assert abs(e1 - e2) <= 1e-10 * abs(e1)


def test_gramians_do_not_depend_on_the_chunking():
    """force_chunk changes the column chunks of the operator applies and of
    the block dots, not the Gramians (1e-13)."""
    _, d, _ = fom_of(CFG42)
    red = LRBMSReductor(d, order=0)
    red.extend_basis(d.solve({"diffusion": 0.3}))
    rd_ref = red.reduce()
    red.force_chunk = 5           # R_all = 32: a short last chunk
    rd = red.reduce()
    for name in ("G_bb", "G_Ab", "G_AA"):
        assert rel(getattr(rd, name), getattr(rd_ref, name)) < 1e-13, name


def _check_incremental(d, red):
    rd_inc = red.reduce()              # incremental (cache hit)
    ref = LRBMSReductor(d, bases=[b.copy() for b in red.bases])
    ref.force_lean = True
    ref.force_full_projection = True
    rd_full = ref.reduce()
    for name in RED_TENSORS:           # 1e-10: same images, summed in another order
        assert rel(getattr(rd_inc, name), getattr(rd_full, name)) < 1e-10, name
    mu = d.parse_parameter(0.6)
    assert rel(rd_inc.solve(mu), rd_full.solve(mu)) < 1e-10


def test_incremental_reduce_matches_full(fom):
    """Incremental re-reduction (cached Oswald/flux image stacks, only new
    columns applied) == the full projection, also across a bucket-growth
    remap."""
    _, d, _ = fom
    rng = np.random.default_rng(7)
    red = LRBMSReductor(d, order=0)
    red.force_lean = True
    red.reduce()                           # seeds the image cache
    assert red._img_cache is not None
    # one subdomain grows by one vector -> incremental update of 1 column
    red.extend_basis_local(1, rng.normal(size=(1, d.space.N)))
    _check_incremental(d, red)
    # several subdomains at once (snapshot extension)
    red.extend_basis(d.solve(d.parse_parameter(0.3)))
    _check_incremental(d, red)
    # past the bucket boundary (r_max 4 -> 8): layout remap + update
    red.extend_basis_local(0, rng.normal(size=(4, d.space.N)))
    assert max(red.basis_sizes()) > 4
    _check_incremental(d, red)


def test_batched_gs_extension_matches_host():
    """The device-batched Gram-Schmidt extension makes the same acceptance
    decisions as the host loop and a P-orthonormal basis of the same local
    spaces; the ROMs are equivalent."""
    _, d, data = fom_of(CFG42)
    P = data["local_energy_dg_product"].numpy()
    red_h = LRBMSReductor(d, order=0)
    red_d = LRBMSReductor(d, order=0)
    red_d.batched_gs = True
    snaps = [d.solve({"diffusion": v}) for v in (0.3, 1.0)]
    snaps.append(snaps[-1])          # a duplicate: rejected on both paths
    for U in snaps:
        counts = []
        for red in (red_h, red_d):
            try:
                counts.append(red.extend_basis(U))
            except ExtensionError:
                counts.append(0)
        assert counts[0] == counts[1]
    assert (red_h.basis_sizes() == red_d.basis_sizes()).all()
    for k in range(d.space.K):
        Vd, Vh = red_d.bases[k], red_h.bases[k]
        np.testing.assert_allclose(Vd @ P[k] @ Vd.T, np.eye(Vd.shape[0]), atol=1e-9)
        # same span: the P-orthogonal projectors agree
        np.testing.assert_allclose(Vh.T @ Vh @ P[k], Vd.T @ Vd @ P[k], atol=1e-8)
    mu = {"diffusion": 0.55}
    rd_h, rd_d = red_h.reduce(), red_d.reduce()
    np.testing.assert_allclose(red_h.reconstruct(rd_h.solve(mu)).numpy(),
                               red_d.reconstruct(rd_d.solve(mu)).numpy(), rtol=0, atol=1e-9)


def test_subdomain_colors_are_neighborhood_disjoint(d66):
    color, n_colors = LRBMSReductor._subdomain_colors(d66.grid)
    assert n_colors == 9 and len(color) == d66.grid.num_subdomains
    assert (np.bincount(color) == 4).all()     # 6x6: 4 subdomains per color
    for c in range(n_colors):
        hoods = [set(d66.grid.neighborhood_of(int(k))) for k in np.where(color == c)[0]]
        for i in range(len(hoods)):
            for j in range(i + 1, len(hoods)):
                assert not (hoods[i] & hoods[j])


def test_colored_full_reduce_matches_rowchunked(d66):
    """Colored images == row-chunked images, exactly: adding structural
    zeros is exact."""
    def build(colored):
        red = LRBMSReductor(d66, order=0)
        red.force_lean = True
        red.use_colored_images = colored
        for v in (0.3, 1.0):
            red.extend_basis(d66.solve({"diffusion": v}))
        return red.reduce()

    rd_c, rd_r = build(True), build(False)
    for name in RED_TENSORS:
        assert torch.equal(getattr(rd_c, name), getattr(rd_r, name)), name


def test_colored_incremental_update_matches_full(d66):
    red = LRBMSReductor(d66, order=0)
    red.force_lean = True
    red.extend_basis(d66.solve({"diffusion": 0.3}))
    red.reduce()                                   # seeds the image cache
    red.extend_basis(d66.solve({"diffusion": 1.0}))  # one new column per subdomain
    _check_incremental(d66, red)


def test_local_bases_are_orthonormal_in_the_default_product(fom):
    """The default product is d.products['energy_mu_bar']; after an
    enrichment round the Gram matrix of every local basis is I (1e-10)."""
    gpd, d, _ = fom
    red = LRBMSReductor(d, order=1)
    P = d.products["energy_mu_bar"].numpy()
    assert np.array_equal(red.products, P)
    AdaptiveEnrichment(gpd, d, d.space, red, red.reduce(), target_error=1e-12).solve(
        0.3, enrichment_steps=1)
    assert red.basis_sizes().max() > 4
    for k, V in enumerate(red.bases):
        np.testing.assert_allclose(V @ P[k] @ V.T, np.eye(V.shape[0]), atol=1e-10)


def test_reduce_needs_the_matrix_form_estimator_tensors():
    d, _ = discretize(init_grid_and_problem(CFG), device="cpu", lean=True)
    with pytest.raises(ValueError, match="lean"):
        LRBMSReductor(d).reduce()


def test_parallel_reductor_is_the_single_device_reductor(fom):
    _, d, _ = fom
    red = ParallelLRBMSReductor(d, order=0)
    # no process group is up: no mesh, the single-device reductor
    assert isinstance(red, LRBMSReductor) and red.mesh is None
    assert red.reduce().solution_dim == d.space.K


# ---------------------------------------------------------------- port vs JAX

@pytest.fixture(scope="module")
def both():
    """The JAX reductor with two snapshots, the port's with the same bases,
    and both reductions."""
    dj, _ = jax_discretize(jax_problem(CFG))
    _, dt, _ = fom_of(CFG)
    red_j = JaxReductor(dj, order=0)
    for m in (0.2, 1.0):
        red_j.extend_basis(dj.solve(dj.parse_parameter(m)))
    red_t = bases_from_numpy(dt, [np.asarray(b) for b in red_j.bases])
    return dj, dt, red_j, red_t, red_j.reduce(), red_t.reduce()


def test_bases_from_numpy_carries_the_bases(both):
    _, dt, red_j, red_t, _, _ = both
    assert (red_t.basis_sizes() == red_j.basis_sizes()).all()
    for bj, bt in zip(red_j.bases, red_t.bases):
        assert np.array_equal(np.asarray(bj), bt)
    # the port's own Gram-Schmidt from the port's solves gives the same
    # bases (1e-9: two dense FOM solves and a normalization)
    red = LRBMSReductor(dt, order=0)
    for m in (0.2, 1.0):
        red.extend_basis(dt.solve(dt.parse_parameter(m)))
    for bj, bt in zip(red_j.bases, red.bases):
        assert rel(bt, bj) < 1e-9


@pytest.mark.parametrize("name", FIELDS)
def test_reduced_tensor_equals_jax(both, name):
    *_, rd_j, rd_t = both
    # 1e-10 of the field's largest entry
    assert rel(getattr(rd_t, name), getattr(rd_j, name)) < 1e-10


@pytest.fixture(scope="module")
def both_lean(both):
    """Both packages' lean reductions (no Gramians) of the same bases."""
    dj, dt, red_j, red_t, _, _ = both
    rj = JaxReductor(dj, bases=[np.asarray(b) for b in red_j.bases])
    rt = bases_from_numpy(dt, red_t.bases)
    rj.force_lean = rt.force_lean = True
    rj.prefetch_next = False
    return rj.reduce(), rt.reduce()


@pytest.mark.parametrize("name", RED_TENSORS)
def test_lean_reduced_tensor_equals_jax(both_lean, name):
    rd_j, rd_t = both_lean
    assert rd_t.G_AA is None and rd_j.G_AA is None
    assert rel(getattr(rd_t, name), getattr(rd_j, name)) < 1e-10


@pytest.mark.parametrize("m", [0.15, 0.6, 1.0])
def test_rom_solve_estimate_residual_equal_jax(both, m):
    *_, rd_j, rd_t = both
    cj = rd_j.solve(m)
    ct = rd_t.solve(m)
    assert rel(ct, cj) < 1e-9
    eta_j, parts_j, ind_j = rd_j.estimate(cj, m, decompose=True)
    eta_t, parts_t, ind_t = rd_t.estimate(ct, m, decompose=True)
    assert rel(eta_t, eta_j) < 1e-9
    for a, b in zip(parts_t + (ind_t,), parts_j + (ind_j,)):
        assert rel(a, b) < 1e-9
    rj = float(rd_j.residual_norm(cj, rd_j.parse_parameter(m)))
    rt = float(rd_t.residual_norm(ct, m))
    assert abs(rt - rj) <= 1e-7 * rj          # a cancellation: 1e-7 relative


def test_reduced_from_numpy_online_step_equals_jax(both):
    """The port's ReducedModel on the JAX package's tensors gives the JAX
    online step (1e-9)."""
    _, _, _, red_t, rd_j, _ = both
    fields = {n: np.asarray(getattr(rd_j, n)) for n in FIELDS}
    rd = reduced_from_numpy(red_t, fields)
    assert isinstance(rd, ReducedModel) and rd.r_max == rd_j.r_max
    assert np.array_equal(rd.nbhd_idx, rd_j.nbhd_idx)
    cj, eta_j, ind_j = rd_j.online_step(0.45)
    ct, eta_t, ind_t = rd.online_step(0.45)
    assert rel(ct, cj) < 1e-9 and rel(eta_t, eta_j) < 1e-9 and rel(ind_t, ind_j) < 1e-9
    lean = reduced_from_numpy(red_t, {n: v for n, v in fields.items() if not n.startswith("G_A")})
    assert lean.G_AA is None and lean.G_Ab is None


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "host"])
def test_adaptive_enrichment_equals_jax(batched):
    """2 mus x 3 enrichment steps from the order-0 basis: the same local
    basis sizes after every round, eta within 1e-6.  On 3x2 subdomains: the
    square grids' mirror symmetry makes indicator pairs tie up to rounding,
    and the marking then depends on the last bit."""
    gpd_j = jax_problem(CFG32)
    dj, _ = jax_discretize(gpd_j)
    gpd_t, dt, _ = fom_of(CFG32)
    red_j = JaxReductor(dj, order=0)
    red_t = LRBMSReductor(dt, order=0)
    kw = dict(target_error=1e-2, marking_doerfler_theta=0.33, marking_max_age=4,
              batched_correctors=batched)
    loop_j = JaxEnrichment(gpd_j, dj, dj.space, red_j, red_j.reduce(), **kw)
    loop_t = AdaptiveEnrichment(gpd_t, dt, dt.space, red_t, red_t.reduce(), **kw)
    for m in (0.3, 0.8):
        log_j, log_t = [], []
        loop_j.solve(m, enrichment_steps=3, callback=lambda rd, u, mu, info: log_j.append(info))
        loop_t.solve(m, enrichment_steps=3, callback=lambda rd, u, mu, info: log_t.append(info))
        assert len(log_t) == len(log_j)
        for a, b in zip(log_t, log_j):
            assert a["local RB sizes"] == b["local RB sizes"]
            assert a["local_problem_solves"] == b["local_problem_solves"]
            assert a["eta"] == pytest.approx(b["eta"], rel=1e-6)
