"""The lane-batched 2D tri P1 stencil form on the CPU.

``StencilOperator.assemble`` with theta [B, Q] on tri P1 (T = 2, nb = 3,
not crisscross) gives a ``LaneStencil``: the affine family, folded once per
dtype and device into one own block and three neighbour blocks a triangle
(``fold_stencils2``), and theta.  On the card its apply is
``hopper_kernels.stencil2_apply``; on the CPU it is the per-lane
``AssembledStencil``'s apply.  Here:

* the folded components applied by the plain gather
  (``stencil2_apply_plain``) equal ``AssembledStencil.apply`` in float64
  (1e-12 of the |.|-sum) for each component alone and for a lane mix, on
  grids with one subdomain along an axis and s in {1, 2, 4}, and on the
  OS2015 configuration of the benchmark's stencil cell;
* the lane form's CPU apply is the per-lane apply bit for bit;
* ``assemble`` takes the lane form only for lane-batched theta on tri P1
  (quad, crisscross, P2 and single theta keep per-lane fields);
* ``matrixfree.cast`` and ``certify`` work on it; its cell-Jacobi factors
  are the per-lane form's;
* the online step folds at set-up on tri P1 (nothing on the other
  families), never in a call, and launches no ``stencil2_apply`` on the CPU;
* the wrapper's shape checks, neighbour table and work count (the
  benchmark's count at the cell's shape).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from benchmark import stencil_roofline  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.grid import Grid  # noqa: E402
from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from pylrbms_tpu_torch.ops import matrixfree as mf  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree import (AssembledStencil, LaneStencil,  # noqa: E402
                                              StencilOperator, SwipdgStencil, cast)
from pylrbms_tpu_torch.ops.spaces import BlockDGSpace  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS  # noqa: E402

f64 = torch.float64
SIDES = ("left", "right", "bottom", "top")
# (ky, kx, s): one subdomain along an axis, s = 1, 2, 4
GRIDS = [(1, 1, 1), (1, 1, 4), (2, 1, 2), (1, 3, 1), (1, 2, 4), (2, 3, 2), (3, 2, 1),
         (2, 2, 4)]
# the benchmark's os2015_tri_stencil cell (8x8 subdomains of 8^2 cells)
OS2015 = {"num_subdomains": [8, 8], "half_num_fine_elements_per_subdomain_and_dim": 2,
          "num_refinements": 2}
SMALL = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 2}
ENTRY = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}


def random_family(ky, kx, s, Q=2, dtype=f64, seed=0):
    """A StencilOperator of Q components on a tri P1 space of ky x kx
    subdomains of s^2 cells, every field standard normal."""
    g = torch.Generator().manual_seed(seed)
    space = BlockDGSpace(Grid(lower_left=(0.0, 0.0), upper_right=(1.0, 1.0), kx=kx, ky=ky,
                              s=s, grid_type="tri"))
    K, nb = space.K, space.nb

    def r(*shape):
        return torch.randn(shape + (nb, nb), generator=g, dtype=dtype)

    def quads(*shape):
        return tuple(r(*shape) for _ in range(4))

    return StencilOperator(space, tuple(SwipdgStencil(
        vol=r(K, s, s, 2), D=quads(K, s, s), V=quads(K, s, s - 1), H=quads(K, s - 1, s),
        R=quads(ky * (kx - 1), s), U=quads((ky - 1) * kx, s),
        D_side={sd: r(K, s) for sd in SIDES}) for _ in range(Q)))


def os2015_model(cfg, dtype, order=1):
    return discretize(init_grid_and_problem(cfg), device="cpu", dtype=dtype, order=order)[0]


def grid_of(op):
    return (op.space.grid.ky, op.space.grid.kx)


def gather_error(op, theta, x):
    """max |gather(fold) - AssembledStencil.apply| / max |.|-sum."""
    P = op.folded(f64, "cpu")
    got = hk.stencil2_apply_plain(P, theta, x, grid_of(op))
    ref = op.mix(theta).apply(x)
    scale = hk.stencil2_apply_plain(P.abs(), theta.abs(), x.abs(), grid_of(op)).max()
    return float((got - ref).abs().max() / scale)


def thetas(B, g):
    """Each component alone, then a lane mix in [0.1, 1]."""
    return (torch.tensor([[1.0, 0.0]] * B, dtype=f64), torch.tensor([[0.0, 1.0]] * B, dtype=f64),
            0.1 + 0.9 * torch.rand((B, 2), generator=g, dtype=f64))


@pytest.fixture(scope="module")
def os2015_op():
    return os2015_model(OS2015, f64).mf_operator()


@pytest.mark.parametrize("ky,kx,s", GRIDS)
def test_folded_gather_equals_the_assembled_apply(ky, kx, s):
    op = random_family(ky, kx, s)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, op.space.K, op.space.N), generator=g, dtype=f64)
    for theta in thetas(3, g):
        assert gather_error(op, theta, x) <= 1e-12


def test_folded_gather_equals_the_assembled_apply_on_os2015(os2015_op):
    op = os2015_op
    assert (op.space.K, op.space.s, op.space.nb, len(op.stencils)) == (64, 8, 3, 2)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, op.space.K, op.space.N), generator=g, dtype=f64)
    for theta in thetas(2, g):
        assert gather_error(op, theta, x) <= 1e-12
    P = op.folded(f64, "cpu")
    assert P.shape == (2, 64, 8, 8, 2, 4, 3, 3)
    assert op.folded(f64, "cpu") is P                               # built once


@pytest.mark.parametrize("dtype", [torch.float32, f64])
def test_lane_form_cpu_apply_is_the_per_lane_apply_bit_for_bit(dtype):
    for op in (random_family(2, 1, 2, dtype=dtype), os2015_model(SMALL, dtype).mf_operator()):
        theta = torch.tensor([[1.0, 0.2], [1.0, 0.7], [1.0, 1.0]], dtype=dtype)
        x = torch.randn((3, op.space.K, op.space.N), generator=torch.Generator().manual_seed(3),
                        dtype=dtype)
        A = op.assemble(theta)
        assert isinstance(A, LaneStencil)
        assert torch.equal(A.apply(x), op.mix(theta).apply(x))


@pytest.mark.parametrize("cfg,order,lanes", [
    (ENTRY, 1, True),                                               # tri P1
    (dict(ENTRY, grid_type="quad"), 1, False),
    (dict(ENTRY, grid_type="crisscross"), 1, False),
    (ENTRY, 2, False),                                              # tri P2
], ids=["tri_p1", "quad", "crisscross", "tri_p2"])
def test_assemble_takes_the_lane_form_only_for_lanes_on_tri_p1(cfg, order, lanes):
    op = os2015_model(cfg, f64, order).mf_operator()
    assert op.lane_kernel == ("stencil2_apply" if lanes else None)
    theta = torch.tensor([[1.0, 0.5], [1.0, 0.2]], dtype=f64)
    assert isinstance(op.assemble(theta[0]), AssembledStencil)      # single theta
    A = op.assemble(theta)
    assert isinstance(A, LaneStencil if lanes else AssembledStencil)
    if not lanes:
        assert A.vol.shape[0] == 2                                  # per-lane fields
    x = torch.randn((2, op.space.K, op.space.N), dtype=f64)
    assert torch.equal(A.apply(x), op.mix(theta).apply(x))


def test_lane_form_cell_jacobi_factors_are_the_per_lane_forms():
    op = random_family(2, 2, 2)
    theta = torch.tensor([[1.0, 0.3], [1.0, 0.8]], dtype=f64)
    A, ref = op.assemble(theta), op.mix(theta)
    assert torch.equal(A.cell_jacobi_factors(), ref.cell_jacobi_factors())
    assert A.space is op.space and A.materialize() is A.materialize()


def test_lane_form_takes_a_contiguous_theta():
    """theta expanded from one row (the FOM residual of the greedy) is made
    contiguous: the kernel reads it as a dense [B, Q]."""
    op = random_family(1, 2, 2)
    A = op.assemble(torch.tensor([1.0, 0.4], dtype=f64).expand(3, -1))
    assert isinstance(A, LaneStencil) and A.theta.is_contiguous()


def test_cast_keeps_the_lane_form_in_the_new_dtype():
    op = os2015_model(SMALL, torch.float32).mf_operator()
    theta = torch.tensor([[1.0, 0.25], [1.0, 0.75]], dtype=torch.float32)
    A = op.assemble(theta)
    Aw = cast(A, f64)
    assert isinstance(Aw, LaneStencil) and Aw.op is op and Aw.theta.dtype == f64
    x = torch.randn((2, op.space.K, op.space.N), generator=torch.Generator().manual_seed(4),
                    dtype=f64)
    y = Aw.apply(x)
    assert y.dtype == f64
    assert torch.equal(y, cast(op, f64).mix(theta.double()).apply(x))
    # the f64 components folded once, from the f32 family widened
    P = op.folded(f64, "cpu")
    assert P.dtype == f64 and op.folded(f64, "cpu") is P
    assert torch.equal(P, mf.fold_stencils2(op.space, cast(op, f64).stencils, f64, "cpu"))


def test_certify_with_lanes_on_a_2d_f32_model():
    """certify polishes each lane to the f64 solution of the f32 components
    at theta in f64 (the lane form cast): the lanes agree with the single
    queries (the widened single-theta operator) to f32 resolution, and
    their indicators come in f64."""
    d = os2015_model(SMALL, torch.float32)
    step = make_online_step(d, tol=1e-6, maxiter=500, matrix_free=True, certify=True,
                            coarse_space="harvested", coarse_modes=4)
    mus = np.array([0.3, 0.9])
    th = torch.tensor(np.stack([np.ones(2), mus], 1))
    tf = torch.ones((2, 1), dtype=f64)
    Ub, ib = step(th, tf, {"diffusion": torch.tensor(mus[:, None])})
    assert ib.dtype == f64 and Ub.dtype == torch.float32
    for i, m in enumerate(mus):
        U1, i1 = step(th[i], tf[i], {"diffusion": torch.tensor([m])})
        assert float((Ub[i] - U1).abs().max() / U1.abs().max()) <= 1e-6
        assert float((ib[i] - i1).abs().max() / i1.abs().max()) <= 1e-6


@pytest.mark.parametrize("cfg,order,folded", [
    (SMALL, 1, [torch.float32]),                                    # tri P1: nb = 3
    (dict(SMALL, grid_type="quad"), 1, []),
    (dict(SMALL, grid_type="crisscross"), 1, []),
    (ENTRY, 2, []),                                                 # tri P2: nb = 6
], ids=["tri_p1", "quad", "crisscross", "tri_p2"])
def test_the_step_folds_at_set_up_and_counts_no_kernel_apply_on_the_cpu(monkeypatch, cfg,
                                                                         order, folded):
    folds = []
    real = mf.fold_stencils2
    monkeypatch.setattr(mf, "fold_stencils2",
                        lambda *a, **k: folds.append(a[2]) or real(*a, **k))
    d = os2015_model(cfg, torch.float32, order)
    step = make_online_step(d, tol=1e-6, maxiter=200, matrix_free=True,
                            coarse_space="harvested", coarse_modes=4)
    assert folds == folded
    mus = np.array([0.2, 0.5, 0.8])
    args = (np.stack([np.ones(3), mus], 1), np.ones((3, 1)),
            {"diffusion": torch.tensor(mus[:, None], dtype=torch.float32)})
    hk.reset_launch_counts()
    GLOBAL_TIMINGS.clear()
    GLOBAL_TIMINGS.enable()
    try:
        step(*args)
        counters = dict(GLOBAL_TIMINGS.counters)
    finally:
        GLOBAL_TIMINGS.disable()
        GLOBAL_TIMINGS.clear()
    assert folds == folded                                          # none in the call
    assert counters["stencil.applies"] > 0
    assert hk.launch_counts()["stencil2_apply"] == 0


def test_wrapper_on_cpu_tensors_is_the_plain_gather():
    op = random_family(2, 2, 2, Q=3)
    P = op.folded(f64, "cpu")
    theta = torch.rand((5, 3), dtype=f64)
    x = torch.randn((5, op.space.K, op.space.N), dtype=f64)
    hk.reset_launch_counts()
    assert torch.equal(hk.stencil2_apply(P, theta, x, grid_of(op)),
                       hk.stencil2_apply_plain(P, theta, x, grid_of(op)))
    assert hk.launch_counts()["stencil2_apply"] == 0
    assert hk.launch_signatures()["stencil2_apply"] == set()


@pytest.mark.parametrize("bad", ["nb", "triangles", "grid", "lanes", "Q", "x_rank", "N"])
def test_wrapper_refuses_bad_shapes(bad):
    op = random_family(2, 1, 2)
    P = op.folded(f64, "cpu")
    theta, x, grid = torch.rand((3, 2), dtype=f64), torch.randn((3, 2, 24), dtype=f64), (2, 1)
    if bad == "nb":
        P = torch.zeros(P.shape[:-2] + (6, 6), dtype=f64)
    elif bad == "triangles":
        P = torch.zeros(P.shape[:4] + (1,) + P.shape[5:], dtype=f64)
    elif bad == "grid":
        grid = (2, 2)
    elif bad == "lanes":
        theta = theta[:2]
    elif bad == "Q":
        theta = torch.rand((3, 3), dtype=f64)
    elif bad == "x_rank":
        x = x[0]
    else:
        x = x[..., :18]
    with pytest.raises(ValueError):
        hk.stencil2_apply(P, theta, x, grid)


@pytest.mark.parametrize("ky,kx,s", GRIDS)
def test_neighbour_table_is_symmetric(ky, kx, s):
    nbr = hk.stencil2_neighbours(ky, kx, s)
    KC = 2 * ky * kx * s * s
    assert nbr.shape == (KC, 4) and (nbr[:, 0] == np.arange(KC)).all()
    for j in (1, 2, 3):                              # partner, vertical, horizontal edge
        has = nbr[:, j] < KC
        assert (nbr[nbr[has, j], j] == np.nonzero(has)[0]).all()
        assert (nbr[has, j] % 2 != np.nonzero(has)[0] % 2).all()  # A <-> B
    nx, ny = kx * s, ky * s
    assert (nbr[:, 1:] < KC).sum() == 2 * (nx * ny + (nx - 1) * ny + nx * (ny - 1))


def test_work_and_bound_at_the_cells_shape(os2015_op):
    """The wrapper's count is the benchmark's at the stencil cell's shape
    (B = 1024, f32): 0.0608 ms an apply, bound by bytes."""
    C, F = stencil_roofline.mesh_counts(os2015_op.space)
    assert (C, F) == (8192, 12160)
    sp = os2015_op.space
    counts = stencil_roofline.counts(C, F, sp.nb, 2, sp.K, sp.N, torch.float32,
                                     torch.float32, 1024)
    assert hk.stencil2_work(2, 8, 8, 8, 1024, torch.float32) == counts
    ms, by = hk.stencil2_bound(2, 8, 8, 8, 1024, torch.float32)
    assert by == "bytes" and abs(ms - 1e3 * stencil_roofline.bound_s(
        C, F, sp.nb, 2, sp.K, sp.N, torch.float32, torch.float32, 1024)) < 1e-9
    assert abs(ms - 0.0608) < 5e-5
