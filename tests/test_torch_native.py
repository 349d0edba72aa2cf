"""Port native host assembler (pylrbms_tpu_torch/native): its CSR of each
affine SWIPDG component equals the port's assembled block operator and the
JAX package's native CSR (2D tri P1 and 3D hex Q1).  Tolerance: 1e-12 of
the largest entry against the port's operator (the same integrands summed
in another order), exact against JAX's native CSR (the same C++ source on
the same tabulated coefficients).  Skips only where g++ (or the Python
headers) cannot build the extension.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu import native as jax_native  # noqa: E402

from pylrbms_tpu_torch import native  # noqa: E402

CASES = {
    "p1-2d": ({"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
               "num_refinements": 1}, "os2015"),
    "q1-3d": ({"num_subdomains": [2, 1, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
               "num_refinements": 0}, "academic3d"),
}


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("no C++ toolchain: g++ cannot build the native assembler")


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_csr_equals_port_and_jax(built, case):
    cfg, problem = CASES[case]
    if problem == "os2015":
        from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jp
        from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jd
        from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as tp
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize as td
        assemble, jax_assemble = native.assemble_swipdg_p1_csr, jax_native.assemble_swipdg_p1_csr
    else:
        from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jp
        from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jd
        from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as tp
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as td
        assemble, jax_assemble = (native.assemble_swipdg_q1_3d_csr,
                                  jax_native.assemble_swipdg_q1_3d_csr)
    dj, _ = jd(jp(cfg))
    dt, _ = td(tp(cfg), device="cpu")
    funcs = dt.estimator.data.lambda_funcs
    for q, lam in enumerate(funcs):
        theta = torch.zeros(len(funcs), dtype=torch.float64)
        theta[q] = 1.0
        A = assemble(dt.space, lam).toarray()
        A_op = dt.op.assemble(theta).to_dense().numpy()
        assert np.abs(A - A_op).max() <= 1e-12 * np.abs(A_op).max(), q
        A_jax = jax_assemble(dj.space, dj.estimator.data.lambda_funcs[q]).toarray()
        np.testing.assert_array_equal(A, A_jax)
