"""The stencil apply's operation and byte counts against shapes worked by
hand, its cell and face counts against the program's own operator, and the
span reader of ``benchmark/spans.py`` on a made-up trace."""
import numpy as np
import pytest
import torch

from benchmark import spans, stencil_roofline

f32 = torch.float32
GRID2 = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}
GRID3 = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}


def test_2d_triangles_by_hand():
    # 4 x 4 squares, two triangles each: C = 32; F = 16 diagonals + 12 + 12
    # blocks 9 (32 + 80) = 1008; K = 4, N = 24, Q = 2, B = 3
    ops, nbytes = stencil_roofline.counts(32, 40, 3, 2, 4, 24, f32, f32, 3)
    assert ops == 2 * 3 * 1008
    assert nbytes == 2 * 1008 * 4 + (2 * 3 * 4 * 24 + 3 * 2) * 4


def test_3d_hexahedra_by_hand():
    # 4 x 4 x 4 hexahedra: C = 64, F = 3 * 48; blocks 64 (64 + 288) = 22 528;
    # K = 8, N = 64, Q = 2, B = 3
    ops, nbytes = stencil_roofline.counts(64, 144, 8, 2, 8, 64, f32, f32, 3)
    assert ops == 135_168
    assert nbytes == 180_224 + 12_312
    # bytes-bound on the card: 2 flops per 4-byte stencil number
    assert stencil_roofline.bound_s(64, 144, 8, 2, 8, 64, f32, f32, 3) == \
        pytest.approx(nbytes / 3.35e12)


def test_the_spe10_cell_is_bytes_bound():
    # 16 x 16 x 8 hexahedra, K = 32, N = 512, B = 1024: ~141 MB an apply
    shape = (2048, 5632, 8, 2, 32, 512, f32, f32, 1024)
    ops, nbytes = stencil_roofline.counts(*shape)
    assert nbytes / 3.35e12 > ops / 67e12
    assert 1e6 * stencil_roofline.bound_s(*shape) == pytest.approx(42.1, abs=0.1)


@pytest.mark.parametrize("dim", [2, 3])
def test_cells_and_faces_are_the_programs_nonzero_blocks(dim):
    """C + 2 F is the number of nonzero nb x nb blocks of the program's
    assembled operator (the mathematics the count follows)."""
    from pylrbms_tpu_torch.la.block import to_scipy_csr
    torch.set_num_threads(2)
    if dim == 2:
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
        from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
        d, _ = discretize(init_grid_and_problem(GRID2), device="cpu")
        mu = {"diffusion": torch.tensor([0.5], dtype=torch.float64)}
    else:
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
        from pylrbms_tpu_torch.problems.spe10_3d import init_grid_and_problem
        d, _ = discretize(init_grid_and_problem(GRID3), device="cpu")
        mu = {"switch": torch.tensor([0.5], dtype=torch.float64)}
    sp = d.space
    A = to_scipy_csr(d.assemble(mu)).tocoo()
    nb = sp.nb
    blocks = {(r, c) for r, c in zip(A.row // nb, A.col // nb)}
    C, F = stencil_roofline.mesh_counts(sp)
    assert C * nb == sp.K * sp.N and len(blocks) == C + 2 * F


def _x(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_inside_gives_each_span_the_device_work_launched_in_it():
    events = [_x("step", 0, 100, "user_annotation"),
              _x("estimate", 50, 40, "user_annotation"),
              _x("estimate.oswald", 60, 10, "user_annotation"),
              _x("cudaLaunchKernel", 61, 1, "cuda_runtime", corr=1),
              _x("cudaLaunchKernel", 80, 1, "cuda_runtime", corr=2),
              _x("cudaLaunchKernel", 10, 1, "cuda_runtime", corr=3),
              _x("k1", 200, 3000, "kernel", tid=7, corr=1),
              _x("k2", 300, 1000, "kernel", tid=7, corr=2),
              _x("k3", 400, 500, "kernel", tid=7, corr=3)]
    got = spans.inside(events)
    assert got["estimate.oswald"] == pytest.approx(3.0)
    assert got["estimate"] == pytest.approx(4.0) and got["step"] == pytest.approx(4.5)
    assert spans.inside([e for e in events if e["name"] != "step"]) is None


def test_a_traced_cpu_run_leaves_the_roofline_out():
    from benchmark.tests.conftest import run_tiny
    result, _ = run_tiny("os2015_tri_stencil.sweep_b1024", trace=True)
    assert result["correct"]
    # the reader needs the device's time, which a CPU run does not have
    assert "stencil_apply_roofline" not in result["metrics"]


def test_spans_measure_counts_applies_per_call():
    from benchmark import spec
    from benchmark.harness import Context, _merge
    from benchmark.system import OnlineStep
    from benchmark.tests.conftest import tiny
    torch.set_num_threads(2)
    cell = "os2015_tri_stencil.sweep_b1024"
    ov = tiny(cell)
    cfg = _merge(spec.config(spec.workload(cell)["config"]), ov["config"])
    system = OnlineStep(cfg, torch.device("cpu"))
    ctx = Context(system=system, setup_s=0.0,
                  batches=[np.array([0.2, 0.5, 0.9, 1.0])] * 2)
    got = spans.of(ctx)
    assert got["device_ms"] is None
    c = got["counters"]
    assert c["stencil.applies"] >= 2 and c["stencil.lane_applies"] == 4 * c["stencil.applies"]
    assert stencil_roofline.shape_of(system)[:6] == (2 * 16, 40, 3, 2, 4, 24)
