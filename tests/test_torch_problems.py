"""The port's SPE10 problem (2D) and monolithic K=1 discretizer against the
JAX package on CPU float64.

The permeability data is the deterministic synthetic layer (seeded numpy),
so both sides see the same numbers.  Tolerances: assembled tensors, solves
and estimates 1e-10 relative to the largest entry (float64 quadrature and a
dense LU, summation order aside); the data rasters are equal bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems import spe10 as jax_spe10  # noqa: E402
from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.discretize_elliptic_swipdg import discretize as jax_monolithic  # noqa: E402

from pylrbms_tpu_torch.problems import spe10  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_swipdg import discretize as monolithic  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_swipdg import monolithic_grid  # noqa: E402
from pylrbms_tpu_torch.functions import make_cellwise_function_1x1  # noqa: E402
from pylrbms_tpu_torch.greedy import weak_greedy  # noqa: E402

TOL = 1e-10
CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 2,
       "num_refinements": 0}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_synthetic_layer_and_pooling_equal_jax():
    layer = spe10.load_spe10_layer(42)
    assert layer.shape == (spe10.SPE10_NY, spe10.SPE10_NX)
    assert np.array_equal(layer, jax_spe10.load_spe10_layer(42))
    assert layer.max() / layer.min() > 1e5          # SPE10-like contrast
    for mode in ("log-mean", "nearest"):
        assert np.array_equal(spe10.pool_log_mean(layer, 8, 4, mode=mode),
                              jax_spe10.pool_log_mean(layer, 8, 4, mode=mode))


def test_cellwise_function_reads_the_cell_raster():
    grid = spe10.init_grid_and_problem(CFG)["grid"]
    vals = np.arange(grid.global_ny * grid.global_nx, dtype=float).reshape(
        grid.global_ny, grid.global_nx)
    fn = make_cellwise_function_1x1(grid, vals)
    x = torch.tensor([[0.01, 0.01], [0.99, 0.01], [0.01, 0.99], [1.5, -1.0]])
    # clamped outside the domain, as the reference
    assert fn(x).tolist() == [vals[0, 0], vals[0, -1], vals[-1, 0], vals[0, -1]]


@pytest.fixture(scope="module")
def spe10_models():
    kw = dict(max_contrast=1e4, raster=(4, 4), raster_mode="nearest")
    dj, _ = jax_discretize(jax_spe10.init_grid_and_problem(CFG, **kw))
    dt, _ = discretize(spe10.init_grid_and_problem(CFG, **kw), device="cpu")
    return dj, dt


@pytest.mark.parametrize("name", ["A_diag", "C_R_io", "C_U_oi"])
def test_spe10_operator_equals_jax(spe10_models, name):
    dj, dt = spe10_models
    assert rel(getattr(dt.op, name), getattr(dj.op, name)) <= TOL
    assert rel(dt.rhs_q, dj.rhs_q) <= TOL


@pytest.mark.parametrize("name", ["E_bar", "M_aa", "M_ab", "BB", "R_dd", "d_vec", "rf_qq",
                                  "min_ev"])
def test_spe10_estimator_tensor_equals_jax(spe10_models, name):
    dj, dt = spe10_models
    # min_ev is tr/2 - sqrt(tr^2/4 - det) with kappa = I: the radicand is pure
    # rounding, and its square root carries sqrt(eps) ~ 1e-8 into the result
    tol = 1e-7 if name == "min_ev" else TOL
    assert rel(getattr(dt.estimator.data, name), getattr(dj.estimator.data, name)) <= tol


def test_spe10_solve_and_estimate_equal_jax(spe10_models):
    dj, dt = spe10_models
    assert dt.parameter_type == {"switch": (1,)}
    for m in (0.1, 0.6):
        Uj = dj.solve(dj.parse_parameter(m), {"type": "dense"})
        Ut = dt.solve(m, {"type": "dense"})
        assert rel(Ut, Uj) <= 1e-9                   # contrast 1e4 costs a digit
        assert rel(dt.estimate(Ut, m), dj.estimate(Uj, dj.parse_parameter(m))) <= 1e-9


def test_spe10_greedy_runs_on_the_port(spe10_models):
    """The MOR path takes the SPE10 problem (parameter 'switch'): the
    greedy's residual surrogate falls twentyfold in three extensions."""
    _, dt = spe10_models
    res = weak_greedy(dt, dt.parameter_space.sample_uniformly(5), target_error=1e-12,
                      max_extensions=3)
    assert res.fom_solves == 3
    assert res.max_etas[-1] < 5e-2 * res.max_etas[0], res.max_etas


@pytest.mark.parametrize("polorder", [1, 2])
def test_monolithic_discretizer_equals_jax(polorder):
    mj, _ = jax_monolithic(jax_os2015(CFG), polorder=polorder)
    mt, data = monolithic(os2015(CFG), polorder=polorder, device="cpu")
    assert mt.space.K == 1 and mt.estimator is None and data["grid"].kx == 1
    assert mt.space.N == mj.space.N
    assert rel(mt.op.A_diag, mj.op.A_diag) <= TOL
    assert rel(mt.rhs_q, mj.rhs_q) <= TOL
    for name in ("l2", "elliptic_mu_bar"):
        assert rel(mt.products[name], mj.products[name]) <= TOL
    for a, b in zip(mt.products["elliptic_q"], mj.products["elliptic_q"]):
        assert rel(a, b) <= TOL
    Uj = mj.solve(mj.parse_parameter(0.7), {"type": "dense"})
    assert rel(mt.solve(0.7, {"type": "dense"}), Uj) <= TOL


def test_monolithic_discretizer_device_and_mesh_rules(monkeypatch):
    gpd = os2015(dict(CFG, num_subdomains=[2, 1]))
    with pytest.raises(ValueError, match="square"):
        monolithic_grid(gpd["grid"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monolithic(os2015(CFG))


# ---------------------------------------------------------------------------
# the remaining 2D problems: thermal block, local thermal block,
# non-parametric, artificial channels
# ---------------------------------------------------------------------------

PROBLEMS = {
    "thermalblock": ([0.3, 0.6, 0.9, 0.45], dict(num_subdomains=[2, 2])),
    "local_thermalblock": (2.1, dict(num_subdomains=[3, 3])),
    "non_parametric": (None, dict(num_subdomains=[2, 2])),
    "artificial_channels": (0.27, dict(num_subdomains=[2, 2])),
}
CFG_TB = {"half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 1}


def _problem_pair(name):
    import importlib
    mu, cfg = PROBLEMS[name]
    cfg = dict(CFG_TB, **cfg)
    # the reference's module names (``*_problem``) are aliases of these
    port = importlib.import_module(f"pylrbms_tpu_torch.problems.{name}_problem")
    ref = importlib.import_module(f"pylrbms_tpu.problems.{name}")
    return port.init_grid_and_problem(cfg), ref.init_grid_and_problem(cfg), mu


def _affine_parts(obj):
    return (list(obj["functions"]), list(obj["coefficients"])) if isinstance(obj, dict) \
        else ([obj], [1.0])


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_data_equals_jax_exactly(name):
    """lambda_q, lambda_bar, lambda_hat and f_q at the quadrature points of
    the port's space, theta(mu) and theta_f(mu, t) (t at the quarter
    steps, where the channels' switch sin(4 pi t) > 0 turns) equal JAX's
    bit for bit; the problem metadata is the same."""
    from pylrbms_tpu.parameters import evaluate_coefficients as jax_coefficients
    from pylrbms_tpu_torch.ops.assembly import vol_points
    from pylrbms_tpu_torch.ops.spaces import BlockDGSpace
    from pylrbms_tpu_torch.parameters import evaluate_coefficients, parse_parameter
    gt, gj, mu = _problem_pair(name)
    for key in ("parameter_type", "mu_bar", "mu_hat", "mu_min", "mu_max", "parameter_range"):
        assert gt[key] == gj[key], key
    xq = vol_points(BlockDGSpace(gt["grid"], order=1))
    xt = torch.as_tensor(xq)
    fns_t = _affine_parts(gt["lambda"])[0] + _affine_parts(gt["f"])[0] + \
        [gt["lambda_bar"], gt["lambda_hat"]]
    fns_j = _affine_parts(gj["lambda"])[0] + _affine_parts(gj["f"])[0] + \
        [gj["lambda_bar"], gj["lambda_hat"]]
    for ft, fj in zip(fns_t, fns_j):
        assert np.array_equal(ft(xt).numpy(), np.asarray(fj(xq)))
    pt = gt["parameter_type"]
    mut = parse_parameter(pt, mu) if pt else {}
    muj = {k: np.asarray(v) for k, v in mut.items()}
    for i, (ct, cj) in enumerate(zip(_affine_parts(gt["lambda"])[1],
                                     _affine_parts(gj["lambda"])[1])):
        assert float(evaluate_coefficients([ct], mut, device="cpu")[0]) == \
            float(np.asarray(jax_coefficients([cj], muj))[0]), i
    f_t, f_j = _affine_parts(gt["f"])[1], _affine_parts(gj["f"])[1]
    for t in np.arange(9) / 4.0 + 0.125 * (name == "thermalblock"):
        th = evaluate_coefficients(f_t, dict(mut, _t=float(t)), device="cpu").numpy()
        thj = np.asarray(jax_coefficients(f_j, dict(muj, _t=float(t))))
        assert np.array_equal(th, thj), t


@pytest.mark.parametrize("name", sorted(set(PROBLEMS) - {"artificial_channels"}))
def test_problem_solves_equal_jax(name):
    """The stationary solve (dense) and theta on the port's and JAX's
    discretizations; the channels' solves are compared in
    tests/test_torch_parabolic.py."""
    gt, gj, mu = _problem_pair(name)
    dt, _ = discretize(gt, device="cpu", lean=True)
    dj, _ = jax_discretize(gj, lean=True)
    mu_t = {} if mu is None else dt.parse_parameter(mu)
    mu_j = {} if mu is None else dj.parse_parameter(mu)
    Ut = dt.solve(mu_t, {"type": "dense"})
    Uj = dj.solve(mu_j, {"type": "dense"})
    assert rel(Ut, Uj) <= TOL
    assert rel(dt.theta(mu_t), dj.theta(mu_j)) == 0.0


def test_non_parametric_exact_solution():
    """lambda == 1: the solution is cos(pi x/2) cos(pi y/2) up to the
    discretization error (the check of tests/test_problems.py)."""
    from pylrbms_tpu_torch.problems.non_parametric import init_grid_and_problem
    gpd = init_grid_and_problem(dict(CFG_TB, num_subdomains=[2, 2], num_refinements=2))
    d, _ = discretize(gpd, device="cpu")
    U = d.solve({})
    xn = d.space.node_coords_phys()
    exact = np.cos(0.5 * np.pi * xn[..., 0]) * np.cos(0.5 * np.pi * xn[..., 1])
    assert np.abs(U.numpy().reshape(exact.shape) - exact).max() < 0.1
