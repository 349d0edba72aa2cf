"""The lane-batched 3D hex stencil form on the CPU.

``StencilOperator3.assemble`` with theta [B, Q] at nb = 8 gives a
``LaneStencil3``: the affine family, folded once per dtype and device into
one own block and six neighbour blocks a cell (``fold_stencils3``), and
theta.  On the card its apply is ``hopper_kernels.stencil3_apply``; on the
CPU it is the per-lane ``AssembledStencil3``'s apply.  Here:

* the folded components applied by the plain gather
  (``stencil3_apply_plain``) equal ``AssembledStencil3.apply`` in float64
  (1e-12 of the |.|-sum) for each component alone and for a lane mix, on
  grids with one subdomain along an axis and s in {1, 2, 4}, and on the
  SPE10 3D configuration of the benchmark's cell;
* the lane form's CPU apply is the per-lane apply bit for bit;
* ``assemble`` takes the lane form only for lane-batched theta at nb = 8;
* ``matrixfree.cast`` and ``certify`` work on it; its cell-Jacobi factors
  are the per-lane form's;
* the online step folds at set-up (at nb = 8; nothing at Q2, nb = 27),
  never in a call, and launches no ``stencil3_apply`` on the CPU;
* the wrapper's shape checks, neighbour table and work count.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from pylrbms_tpu_torch.ops import matrixfree3d as mf3  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree import cast  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree3d import (AssembledStencil3, LaneStencil3,  # noqa: E402
                                                StencilOperator3, SwipdgStencil3)
from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS  # noqa: E402

f64 = torch.float64
SIDES = ("left", "right", "bottom", "top", "near", "far")
# (kz, ky, kx, s): one subdomain along an axis, s = 1, 2, 4
GRIDS = [(1, 1, 1, 1), (1, 1, 1, 4), (2, 1, 1, 2), (1, 3, 1, 1), (1, 1, 2, 4),
         (2, 3, 2, 2), (3, 2, 1, 1), (2, 2, 2, 4)]
SPE10 = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 2, "grid_type": "hex"}
SPE10_SMALL = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
               "num_refinements": 1, "grid_type": "hex"}


def random_family(kz, ky, kx, s, Q=2, nb=8, dtype=f64, seed=0):
    """A StencilOperator3 of Q components with every field standard normal."""
    g = torch.Generator().manual_seed(seed)
    K = kz * ky * kx
    space = SimpleNamespace(K=K, s=s, nb=nb, N=s ** 3 * nb,
                            grid=SimpleNamespace(kx=kx, ky=ky, kz=kz))

    def r(*shape):
        return torch.randn(shape + (nb, nb), generator=g, dtype=dtype)

    def quads(*shape):
        return tuple(r(*shape) for _ in range(4))

    return StencilOperator3(space, tuple(SwipdgStencil3(
        vol=r(K, s, s, s), X=quads(K, s, s, s - 1), Y=quads(K, s, s - 1, s),
        Z=quads(K, s - 1, s, s), IX=quads(kz * ky * (kx - 1), s * s),
        IY=quads(kz * (ky - 1) * kx, s * s), IZ=quads((kz - 1) * ky * kx, s * s),
        D_side={sd: r(K, s * s) for sd in SIDES}) for _ in range(Q)))


def spe10_model(cfg, dtype, order=1):
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu_torch.problems.spe10_3d import init_grid_and_problem
    return discretize(init_grid_and_problem(cfg), device="cpu", dtype=dtype, order=order)[0]


def grid_of(op):
    g = op.space.grid
    return (g.kz, g.ky, g.kx)


def gather_error(op, theta, x):
    """max |gather(fold) - AssembledStencil3.apply| / max |.|-sum."""
    P = op.folded(f64, "cpu")
    got = hk.stencil3_apply_plain(P, theta, x, grid_of(op))
    ref = op.mix(theta).apply(x)
    scale = hk.stencil3_apply_plain(P.abs(), theta.abs(), x.abs(), grid_of(op)).max()
    return float((got - ref).abs().max() / scale)


@pytest.mark.parametrize("kz,ky,kx,s", GRIDS)
def test_folded_gather_equals_the_assembled_apply(kz, ky, kx, s):
    op = random_family(kz, ky, kx, s)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, op.space.K, op.space.N), generator=g, dtype=f64)
    for theta in (torch.tensor([[1.0, 0.0]] * 3, dtype=f64),       # each component alone
                  torch.tensor([[0.0, 1.0]] * 3, dtype=f64),
                  0.1 + 0.9 * torch.rand((3, 2), generator=g, dtype=f64)):
        assert gather_error(op, theta, x) <= 1e-12


def test_folded_gather_equals_the_assembled_apply_on_spe10_3d():
    op = spe10_model(SPE10, f64).mf_operator()
    assert (op.space.K, op.space.s, op.space.nb, len(op.stencils)) == (32, 4, 8, 2)
    x = torch.randn((2, op.space.K, op.space.N), generator=torch.Generator().manual_seed(2),
                    dtype=f64)
    for theta in ([[1.0, 0.0], [1.0, 0.0]], [[0.0, 1.0], [0.0, 1.0]], [[1.0, 0.1], [1.0, 0.95]]):
        assert gather_error(op, torch.tensor(theta, dtype=f64), x) <= 1e-12
    P = op.folded(f64, "cpu")
    assert P.shape == (2, 32, 4, 4, 4, 7, 8, 8)
    assert op.folded(f64, "cpu") is P                               # built once


@pytest.mark.parametrize("dtype", [torch.float32, f64])
def test_lane_form_cpu_apply_is_the_per_lane_apply_bit_for_bit(dtype):
    for op in (random_family(2, 1, 2, 2, dtype=dtype),
               spe10_model(SPE10_SMALL, dtype).mf_operator()):
        theta = torch.tensor([[1.0, 0.2], [1.0, 0.7], [1.0, 1.0]], dtype=dtype)
        x = torch.randn((3, op.space.K, op.space.N), generator=torch.Generator().manual_seed(3),
                        dtype=dtype)
        A = op.assemble(theta)
        assert isinstance(A, LaneStencil3)
        assert torch.equal(A.apply(x), op.mix(theta).apply(x))


def test_assemble_takes_the_lane_form_only_for_lanes_at_nb_8():
    q1 = random_family(1, 2, 1, 2)
    assert isinstance(q1.assemble(torch.tensor([1.0, 0.5], dtype=f64)), AssembledStencil3)
    assert isinstance(q1.assemble(torch.tensor([[1.0, 0.5]], dtype=f64)), LaneStencil3)
    q2 = random_family(1, 2, 1, 1, nb=27)                           # hex Q2
    A2 = q2.assemble(torch.tensor([[1.0, 0.5], [1.0, 0.2]], dtype=f64))
    assert isinstance(A2, AssembledStencil3) and A2.vol.shape[0] == 2
    x = torch.randn((2, q2.space.K, q2.space.N), dtype=f64)
    assert torch.equal(A2.apply(x), q2.mix(torch.tensor([[1.0, 0.5], [1.0, 0.2]],
                                                         dtype=f64)).apply(x))


def test_lane_form_cell_jacobi_factors_are_the_per_lane_forms():
    op = random_family(2, 2, 1, 2)
    theta = torch.tensor([[1.0, 0.3], [1.0, 0.8]], dtype=f64)
    A, ref = op.assemble(theta), op.mix(theta)
    assert torch.equal(A.cell_jacobi_factors(), ref.cell_jacobi_factors())
    assert A.space is op.space and A.materialize() is A.materialize()


def test_cast_keeps_the_lane_form_in_the_new_dtype():
    op = spe10_model(SPE10_SMALL, torch.float32).mf_operator()
    theta = torch.tensor([[1.0, 0.25], [1.0, 0.75]], dtype=torch.float32)
    A = op.assemble(theta)
    Aw = cast(A, f64)
    assert isinstance(Aw, LaneStencil3) and Aw.op is op and Aw.theta.dtype == f64
    x = torch.randn((2, op.space.K, op.space.N), generator=torch.Generator().manual_seed(4),
                    dtype=f64)
    y = Aw.apply(x)
    assert y.dtype == f64
    assert torch.equal(y, cast(op, f64).mix(theta.double()).apply(x))
    # the f64 components folded once, from the f32 family widened
    P = op.folded(f64, "cpu")
    assert P.dtype == f64 and op.folded(f64, "cpu") is P
    assert torch.equal(P, mf3.fold_stencils3(op.space, cast(op, f64).stencils, f64, "cpu"))


def test_certify_with_lanes_on_a_3d_f32_model():
    """certify polishes each lane to the f64 solution of the f32 components
    at theta in f64 (the lane form cast): the lanes agree with the single
    queries (the widened single-theta operator) to f32 resolution, and
    their indicators come in f64."""
    d = spe10_model(SPE10_SMALL, torch.float32)
    step = make_online_step(d, tol=1e-6, maxiter=500, matrix_free=True, certify=True,
                            coarse_space="harvested", coarse_modes=4)
    mus = np.array([0.3, 0.9])
    th = torch.tensor(np.stack([np.ones(2), mus], 1))
    tf = torch.ones((2, 1), dtype=f64)
    Ub, ib = step(th, tf, {"switch": torch.tensor(mus[:, None])})
    assert ib.dtype == f64 and Ub.dtype == torch.float32
    for i, m in enumerate(mus):
        U1, i1 = step(th[i], tf[i], {"switch": torch.tensor([m])})
        assert float((Ub[i] - U1).abs().max() / U1.abs().max()) <= 1e-6
        assert float((ib[i] - i1).abs().max() / i1.abs().max()) <= 1e-6


@pytest.mark.parametrize("order,cfg,folded", [
    (1, SPE10_SMALL, [torch.float32]),                              # hex Q1: nb = 8
    (2, dict(SPE10_SMALL, num_refinements=0), []),                  # hex Q2: nb = 27
], ids=["q1", "q2"])
def test_the_step_folds_at_set_up_and_counts_no_kernel_apply_on_the_cpu(monkeypatch, order,
                                                                         cfg, folded):
    folds = []
    real = mf3.fold_stencils3
    monkeypatch.setattr(mf3, "fold_stencils3",
                        lambda *a, **k: folds.append(a[2]) or real(*a, **k))
    d = spe10_model(cfg, torch.float32, order)
    assert d.space.nb == (8 if order == 1 else 27)
    step = make_online_step(d, tol=1e-6, maxiter=200, matrix_free=True,
                            coarse_space="harvested", coarse_modes=4)
    assert folds == folded
    mus = np.array([0.2, 0.5, 0.8])
    args = (np.stack([np.ones(3), mus], 1), np.ones((3, 1)),
            {"switch": torch.tensor(mus[:, None], dtype=torch.float32)})
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
    assert hk.launch_counts()["stencil3_apply"] == 0


def test_wrapper_on_cpu_tensors_is_the_plain_gather():
    op = random_family(1, 2, 2, 2, Q=3)
    P = op.folded(f64, "cpu")
    theta = torch.rand((5, 3), dtype=f64)
    x = torch.randn((5, op.space.K, op.space.N), dtype=f64)
    hk.reset_launch_counts()
    assert torch.equal(hk.stencil3_apply(P, theta, x, grid_of(op)),
                       hk.stencil3_apply_plain(P, theta, x, grid_of(op)))
    assert hk.launch_counts()["stencil3_apply"] == 0
    assert hk.launch_signatures()["stencil3_apply"] == set()


@pytest.mark.parametrize("bad", ["nb", "grid", "lanes", "Q", "x_rank", "N"])
def test_wrapper_refuses_bad_shapes(bad):
    op = random_family(1, 2, 1, 2)
    P = op.folded(f64, "cpu")
    theta, x, grid = torch.rand((3, 2), dtype=f64), torch.randn((3, 2, 64), dtype=f64), (1, 2, 1)
    if bad == "nb":
        P = torch.zeros(P.shape[:-2] + (27, 27), dtype=f64)
    elif bad == "grid":
        grid = (2, 2, 1)
    elif bad == "lanes":
        theta = theta[:2]
    elif bad == "Q":
        theta = torch.rand((3, 3), dtype=f64)
    elif bad == "x_rank":
        x = x[0]
    else:
        x = x[..., :56]
    with pytest.raises(ValueError):
        hk.stencil3_apply(P, theta, x, grid)


@pytest.mark.parametrize("kz,ky,kx,s", GRIDS)
def test_neighbour_table_is_symmetric(kz, ky, kx, s):
    nbr = hk.stencil3_neighbours(kz, ky, kx, s)
    KC = kz * ky * kx * s ** 3
    assert nbr.shape == (KC, 7) and (nbr[:, 0] == np.arange(KC)).all()
    for j, back in ((1, 2), (2, 1), (3, 4), (4, 3), (5, 6), (6, 5)):
        has = nbr[:, j] < KC
        assert (nbr[nbr[has, j], back] == np.nonzero(has)[0]).all()
    nx, ny, nz = kx * s, ky * s, kz * s
    assert (nbr[:, 1:] < KC).sum() == 2 * ((nx - 1) * ny * nz + nx * (ny - 1) * nz
                                           + nx * ny * (nz - 1))


def test_work_and_bound_at_the_cells_shape():
    """The benchmark's count of the cell's apply: 42.1 us, bound by bytes."""
    ms, by = hk.stencil3_bound(2, 2, 4, 4, 4, 1024, torch.float32)
    assert by == "bytes" and abs(ms - 0.0421) < 5e-5
    ops, nbytes = hk.stencil3_work(2, 2, 4, 4, 4, 1024, torch.float32)
    assert ops == 2 * 1024 * 64 * (2048 + 2 * 5632)
