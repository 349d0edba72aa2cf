"""Port roofline accounting (pylrbms_tpu_torch/utils/roofline.py) against
the JAX package's ``KernelCost`` counts: the operations and bytes of one
apply of the 2D block operator, the 2D stencil and the 3D hex stencil, and
of one PCG iteration with block factors and a coarse level, are equal
(exact: both count coefficients from shapes); the rates and shares are
the measured rates over the H100 peaks of ``ops/hopper_kernels``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.utils import roofline as jax_roofline  # noqa: E402
from pylrbms_tpu.utils.precision import hp  # noqa: E402

from pylrbms_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from pylrbms_tpu_torch.utils import roofline  # noqa: E402

CFG2 = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1}
CFG3 = {"num_subdomains": [2, 1, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1}


def models(dim):
    if dim == 2:
        from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jp
        from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jd
        from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as tp
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize as td
        cfg, mu = CFG2, 0.5
    else:
        from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jp
        from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jd
        from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as tp
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as td
        cfg, mu = CFG3, 0.5
    dj, _ = jd(jp(cfg))
    dt, _ = td(tp(cfg), device="cpu")
    return dj, dt, mu


def same(cost, cost_j):
    assert (cost.flops, cost.bytes) == (float(cost_j.flops), float(cost_j.bytes))


@pytest.mark.parametrize("dim", [2, 3])
def test_costs_equal_jax(dim):
    dj, dt, m = models(dim)
    muj, mut = dj.parse_parameter(m), dt.parse_parameter(m)
    A, Aj = dt.assemble(mut), dj.assemble(muj)
    S = dt.mf_operator().assemble(dt.theta(mut))
    Sj = jax.jit(hp(lambda s, th: s.assemble(th)))(dj.mf_operator(), dj.theta(muj))
    same(roofline.matvec_cost(A), jax_roofline.matvec_cost(Aj))          # block operator
    same(roofline.matvec_cost(S), jax_roofline.matvec_cost(Sj))          # stencil
    F = A.block_jacobi_factors()
    C = torch.as_tensor(A.coarse_modes_basis(dt.space, 3))
    ci = torch.eye(dt.space.K * C.shape[-1], dtype=torch.float64)
    for lanes in (1, 8):
        same(roofline.pcg_iteration_cost(S, F, C, ci, lanes=lanes),
             jax_roofline.pcg_iteration_cost(Sj, jnp.asarray(F.numpy()), jnp.asarray(C.numpy()),
                                             jnp.asarray(ci.numpy()), lanes=lanes))
    same(roofline.pcg_iteration_cost(A), jax_roofline.pcg_iteration_cost(Aj))
    same(roofline.vector_cost(dt.space.K, dt.space.N, 8),
         jax_roofline.vector_cost(dj.space.K, dj.space.N, 8))


def test_roofline_shares_of_the_h100_peaks():
    cost = roofline.KernelCost(4e12, 6.7e12) + 2 * roofline.KernelCost(0.5e12, 0.0)
    assert (cost.flops, cost.bytes) == (5e12, 6.7e12)
    r = roofline.roofline(cost, 4.0)
    assert r["hbm_gbs"] == pytest.approx(6.7e12 / 4.0 / 1e9)
    assert r["hbm_util"] == pytest.approx(6.7e12 / 4.0 / hk.HBM_BYTES_PER_S)
    assert r["tflops"] == pytest.approx(1.25)
    for key, peak in (("mfu_vs_bf16_peak", "bf16"), ("mfu_vs_f32_highest", "f32")):
        assert r[key] == pytest.approx(1.25e12 / hk.PEAK_OPS_PER_S[peak])
    assert np.isfinite(list(r.values())).all()
