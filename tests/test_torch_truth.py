"""Port truth solver (pylrbms_tpu_torch/truth.py) against the JAX package on
CPU float64, on the fixture of tests/test_truth.py (SPE10 3D, 4x4x2
subdomains, half 1, nref 1: K=32, N=64; raster (2, 4, 4), nearest,
contrast 1e3).  Tolerances, relative to the largest entry:

* ``dense_subdomain_blocks`` equals JAX's and the folded ``A_diag`` (and on
  one subdomain the dense global matrix) to 1e-12: the same sums in
  another order;
* ``spd_block_inverse`` equals JAX's to 1e-10 (an eigh of blocks with
  condition ~1e3-1e4 in f64: eigenvector rounding times the condition);
* the colored Galerkin matrix equals the dense block algebra to 1e-10 (as
  in tests/test_truth.py) and JAX's to 1e-12; the harvested basis (same
  seed, f64 stencil and factors) and ``prepare_coarse_mf``'s conditioned
  basis and pseudo-inverse equal JAX's to 1e-8 (a degree-30 Chebyshev
  filter in two rounds amplifies rounding before the QR);
* the 442k-q2 config's pooled SPE10 raster field (the one that made
  ``docs/results/ref442k.npz``) equals JAX's exactly.

``truth_solve`` itself (splu, JAX's U and iteration counts, the bf16
storage and ``SolveOnlyModel``) is held in tests/test_torch_truth_solve.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.utils.precision import hp  # noqa: E402
from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d as jax_spe10  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.la.block import AssembledBlockOp as JaxBlockOp  # noqa: E402
import pylrbms_tpu.truth as jt  # noqa: E402
import pylrbms_tpu.ops.ir as jir  # noqa: E402

from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d as spe10  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402
from pylrbms_tpu_torch.la.block import AssembledBlockOp, to_scipy_csr  # noqa: E402
from pylrbms_tpu_torch.ops.ir import cast_f32  # noqa: E402
import pylrbms_tpu_torch.truth as tt  # noqa: E402

f64 = torch.float64
CFG = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
FIELD = dict(raster=(2, 4, 4), raster_mode="nearest", max_contrast=1e3)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def jit(fn, *args):
    return jax.jit(hp(fn))(*args)


@pytest.fixture(scope="module")
def pair():
    dj, _ = jax_discretize(jax_spe10(CFG, **FIELD))
    dt, _ = discretize(spe10(CFG, **FIELD), device="cpu")
    return dj, dt


@pytest.fixture(scope="module")
def stencils(pair):
    """(JAX, port) assembled f64 stencils at switch = 0.8."""
    dj, dt = pair
    Sj = jit(lambda s, th: s.assemble(th), dj.mf_operator(),
             dj.theta(dj.parse_parameter({"switch": 0.8})))
    St = dt.mf_operator().assemble(dt.theta(dt.parse_parameter({"switch": 0.8})))
    return Sj, St


def test_dense_subdomain_blocks_single_subdomain():
    """On one subdomain the dense subdomain block is the whole operator."""
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_academic3d
    from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem
    cfg = {"num_subdomains": [1, 1, 1], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    dj, _ = jax_discretize(jax_academic3d(cfg))
    dt, _ = discretize(init_grid_and_problem(cfg), device="cpu")
    mu = dt.parse_parameter([1.0])
    S = dt.mf_operator().assemble(dt.theta(mu))
    D = S.dense_subdomain_blocks()
    assert D.dtype == f64
    A = to_scipy_csr(dt.assemble(mu)).toarray()
    assert rel(D[0], A) < 1e-12
    Sj = jit(lambda s, th: s.assemble(th), dj.mf_operator(), dj.theta(dj.parse_parameter([1.0])))
    assert rel(D, jit(lambda s: s.dense_subdomain_blocks(), Sj)) < 1e-12


def test_dense_subdomain_blocks_match_folded(pair, stencils):
    """Many subdomains: equal to the folded A_diag (interface in_in/out_out
    strips, Dirichlet strips on boundary subdomains only) and to JAX's."""
    dj, dt = pair
    Sj, St = stencils
    D = St.dense_subdomain_blocks()
    A = dt.assemble(dt.parse_parameter({"switch": 0.8}))
    assert rel(D, A.A_diag) < 1e-12
    assert rel(D, jit(lambda s: s.dense_subdomain_blocks(), Sj)) < 1e-12
    D32 = cast_f32(St).dense_subdomain_blocks()
    assert D32.dtype == torch.float32 and rel(D32, D) < 1e-6


def test_cast_f32(stencils):
    """Every tensor field cast (the D_side dict too), the space kept; the
    values those of JAX's cast_f32."""
    Sj, St = stencils
    S32, Sj32 = cast_f32(St), jir.cast_f32(Sj)
    assert S32.space is St.space
    for name in ("vol", "X", "Y", "Z", "IX", "IY", "IZ", "D_side"):
        a, b = getattr(S32, name), getattr(Sj32, name)
        if name == "D_side":
            assert sorted(a) == sorted(b)
            a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
        for x, y in zip(*((a, b) if isinstance(a, (tuple, list)) else ((a,), (b,)))):
            assert x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_spd_block_inverse(stencils):
    Sj, St = stencils
    D = St.dense_subdomain_blocks()
    B = tt.spd_block_inverse(D)
    Bj = jit(jt.spd_block_inverse, jit(lambda s: s.dense_subdomain_blocks(), Sj))
    assert rel(B, Bj) < 1e-10
    assert rel(B, B.transpose(-1, -2)) < 1e-12


def test_colored_coarse_galerkin_matches_dense(pair, stencils):
    dj, dt = pair
    Sj, St = stencils
    C = AssembledBlockOp.coarse_modes_basis(dt.space, 4)
    A = dt.assemble(dt.parse_parameter({"switch": 0.8}))
    Ac_dense = A.coarse_matrix_general(torch.as_tensor(C))
    Ac_mf = tt.coarse_galerkin_mf(St, C)
    assert Ac_mf.shape == Ac_dense.shape
    assert rel(Ac_mf, Ac_dense) < 1e-10
    assert rel(Ac_mf, jt.coarse_galerkin_mf(Sj, JaxBlockOp.coarse_modes_basis(dj.space, 4))) \
        < 1e-12


@pytest.mark.parametrize("route", ["block", "cell"])
def test_harvest_and_prepare_coarse(pair, stencils, route):
    """Same seed, f64 stencil and factors: the harvested basis, the
    conditioned basis and the coarse pseudo-inverse equal JAX's."""
    dj, dt = pair
    Sj, St = stencils
    if route == "block":
        kw = dict(block_factors=tt.spd_block_inverse(St.dense_subdomain_blocks()))
        kwj = dict(block_factors=jit(jt.spd_block_inverse,
                                     jit(lambda s: s.dense_subdomain_blocks(), Sj)))
        F, Fj = None, None
    else:
        kw, kwj = {}, {}
        F, Fj = St.cell_jacobi_factors(), jit(lambda s: s.cell_jacobi_factors(), Sj)
    C = tt.harvested_coarse_cell(St, F, dt.space, n_harvest=8, extra_modal=3, **kw)
    Cj = jt.harvested_coarse_cell(Sj, Fj, dj.space, n_harvest=8, extra_modal=3, **kwj)
    assert C.shape == (32, 64, 11) and rel(C, Cj) < 1e-8
    Cc, ci = tt.prepare_coarse_mf(St, C)
    Ccj, cij = jt.prepare_coarse_mf(Sj, Cj)
    assert rel(Cc, Ccj) < 1e-8 and rel(ci, cij) < 1e-8


def test_442k_q2_field_equals_jax():
    """The config of docs/results/ref442k.npz: SPE10 3D (layers 40-44),
    raster (4, 8, 8) nearest, contrast 1e4, 8x8x4 subdomains, half 1, nref
    2, Q2: the port's pooled field and floor equal JAX's at every cell
    center, and the space has the reference's 256 x 1728 dofs."""
    from pylrbms_tpu_torch.ops.spaces3d import BlockDGSpace3D
    ref = np.load("docs/results/ref442k.npz")
    cfg = {"num_subdomains": [int(v) for v in ref["subs"]],
           "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": int(ref["nref"])}
    field = dict(raster=tuple(int(v) for v in ref["raster"]), raster_mode="nearest",
                 max_contrast=float(ref["max_contrast"]))
    gt, gj = spe10(cfg, **field), jax_spe10(cfg, **field)
    space = BlockDGSpace3D(gt["grid"], order=int(ref["order"]))
    assert (space.K, space.N) == ref["u_1.0"].shape == (256, 1728)
    g = gt["grid"]
    axes = [(np.arange(n) + 0.5) * h + lo for n, h, lo in
            ((g.global_nz, g.hz, g.lower_left[2]), (g.global_ny, g.hy, g.lower_left[1]),
             (g.global_nx, g.hx, g.lower_left[0]))]
    Z, Y, X = np.meshgrid(*axes, indexing="ij")
    x = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    for ft, fj in zip(gt["lambda"]["functions"], gj["lambda"]["functions"]):
        np.testing.assert_array_equal(ft(torch.as_tensor(x)).numpy(),
                                      np.asarray(fj(jnp.asarray(x))))
