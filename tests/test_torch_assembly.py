"""Port assembly (pylrbms_tpu_torch) against the JAX package on CPU float64.

Same OS2015 problem, same grid: coefficient functions at the quadrature
points, theta(mu) single and lane-batched, the affine SWIPDG components,
fold_diag, the rhs, the products and the estimator tensors.  Tolerance
1e-12 relative (max-norm): both sides evaluate the same quadrature in
float64 and differ only by einsum summation order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops import assembly as jasm  # noqa: E402
from pylrbms_tpu.ops.swipdg import fold_diag as jax_fold_diag  # noqa: E402
from pylrbms_tpu.parameters import evaluate_coefficients as jax_coeffs  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.ops import assembly as asm  # noqa: E402
from pylrbms_tpu_torch.ops.swipdg import fold_diag  # noqa: E402
from pylrbms_tpu_torch.parameters import evaluate_coefficients  # noqa: E402

TOL = 1e-12
CONFIGS = {
    "entry": {"num_subdomains": [2, 2],
              "half_num_fine_elements_per_subdomain_and_dim": 1,
              "num_refinements": 1},
    "nref2": {"num_subdomains": [2, 2],
              "half_num_fine_elements_per_subdomain_and_dim": 1,
              "num_refinements": 2},
}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    cfg = CONFIGS[request.param]
    dj, _ = jax_discretize(jax_problem(cfg))
    gpd = init_grid_and_problem(cfg)
    dt, _ = discretize(gpd, device="cpu")
    return dj, dt, gpd


def test_coefficients_at_quadrature_points(models):
    dj, dt, gpd = models
    xq = asm.vol_points(dt.space)
    assert rel(xq, jasm._vol_points(dj.space)) <= TOL
    xt = torch.tensor(xq)
    for ft, fj in zip(dt.estimator.data.lambda_funcs + dt.estimator.data.f_funcs
                      + [dt.estimator.data.lambda_hat, gpd["lambda_bar"]],
                      dj.estimator.data.lambda_funcs + dj.estimator.data.f_funcs
                      + [dj.estimator.data.lambda_hat, jax_problem(CONFIGS["entry"])["lambda_bar"]]):
        assert rel(ft(xt), fj(jnp.asarray(xq))) <= TOL
    kap = gpd["kappa"](xt)
    assert kap.shape == xq.shape[:-1] + (2, 2)


def test_theta_single_and_batched(models):
    dj, dt, _ = models
    mus = np.array([0.1, 0.37, 1.0])
    batched = evaluate_coefficients(dt.lambda_coeffs, {"diffusion": torch.tensor(mus[:, None])})
    assert batched.shape == (3, 2)
    for i, m in enumerate(mus):
        ref = np.asarray(jax_coeffs(dj.lambda_coeffs, {"diffusion": jnp.asarray([m])}))
        single = dt.theta(dt.parse_parameter(m))
        assert rel(single, ref) <= TOL
        assert rel(batched[i], ref) <= TOL
        assert rel(dt.theta_f({"diffusion": torch.tensor([m])}),
                   dj.theta_f({"diffusion": jnp.asarray([m])})) <= TOL


@pytest.mark.parametrize("field", ["A_loc", "R_in_in", "R_in_out", "R_out_in",
                                   "R_out_out", "U_in_in", "U_in_out",
                                   "U_out_in", "U_out_out"])
def test_swipdg_components(models, field):
    dj, dt, _ = models
    for cj, ct in zip(dj.components, dt.components):
        assert rel(getattr(ct, field), getattr(cj, field)) <= TOL


def test_swipdg_side_blocks_and_fold_diag(models):
    dj, dt, _ = models
    for cj, ct in zip(dj.components, dt.components):
        for side in ("left", "right", "bottom", "top"):
            assert rel(ct.D_side[side], cj.D_side[side]) <= TOL
        assert rel(fold_diag(dt.space, ct), jax_fold_diag(dj.space, cj)) <= TOL
    for name in ("A_diag", "C_R_io", "C_R_oi", "C_U_io", "C_U_oi"):
        assert rel(getattr(dt.op, name), getattr(dj.op, name)) <= TOL


def test_rhs_and_assembled_operator(models):
    dj, dt, _ = models
    assert rel(dt.rhs_q, dj.rhs_q) <= TOL
    for m in (0.2, 0.8):
        Aj, At = dj.assemble(dj.parse_parameter(m)), dt.assemble(dt.parse_parameter(m))
        assert rel(At.to_dense(), Aj.to_dense()) <= TOL
        assert rel(dt.rhs(dt.parse_parameter(m)), dj.rhs(dj.parse_parameter(m))) <= TOL


@pytest.mark.parametrize("name", ["E_bar", "L2", "M_aa", "M_ab", "BB", "A_div",
                                  "R_dd", "d_vec", "rf_qq", "min_ev", "diam"])
def test_estimator_tensors_and_products(models, name):
    dj, dt, _ = models
    assert rel(getattr(dt.estimator.data, name), getattr(dj.estimator.data, name)) <= TOL


def test_energy_product(models):
    dj, dt, _ = models
    assert rel(dt.products["energy_mu_bar"], dj.products["energy_mu_bar"]) <= TOL


def test_lean_model_drops_only_matrix_form_tensors():
    dt, _ = discretize(init_grid_and_problem(CONFIGS["entry"]), device="cpu", lean=True)
    ed = dt.estimator.data
    assert ed.M_aa is None and ed.BB is None and ed.M_ab is None and ed.R_dd is None
    assert ed.E_bar is not None and ed.d_vec is not None
