"""Port estimator (pylrbms_tpu_torch) against the JAX package on CPU float64.

The same U goes through both sides: the Oswald interpolation, the RT0 flux
reconstruction, the positive-form and matrix-form local quantities and the
aggregated estimate, single and lane-batched.  Tolerance 1e-10 relative
(max-norm): float64 quadrature whose only difference is summation order,
with the matrix forms' quadratic cancellation costing a few digits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402

TOL = 1e-10
CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 2}
MUS = np.array([0.15, 0.5, 1.0])


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def setup():
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    # the detailed solutions at MUS (JAX dense solve) plus a rough random
    # field, so the nonconformity and residual terms are far from zero
    rng = np.random.default_rng(0)
    U = np.stack([np.asarray(dj.solve(dj.parse_parameter(m), {"type": "dense"}))
                  for m in MUS])
    U[-1] += 0.1 * rng.normal(size=U[-1].shape)
    return dj, dt, U


def test_oswald_interpolation(setup):
    dj, dt, U = setup
    ref = dj.estimator.data.oswald.apply(jnp.asarray(U))
    assert rel(dt.estimator.data.oswald.apply(torch.tensor(U)), ref) <= TOL
    assert rel(dt.estimator.data.oswald.apply(torch.tensor(U[0])), ref[0]) <= TOL


@pytest.mark.parametrize("i", range(len(MUS)))
def test_flux_reconstruction(setup, i):
    dj, dt, U = setup
    mu_j, mu_t = {"diffusion": jnp.asarray([MUS[i]])}, {"diffusion": torch.tensor([MUS[i]])}
    tj = dj.estimator.reconstruct_flux(jnp.asarray(U[i]), mu_j, per_component=True)
    tt = dt.estimator.reconstruct_flux(torch.tensor(U[i]), mu_t, per_component=True)
    assert rel(tt, tj) <= TOL
    assert rel(dt.estimator.reconstruct_flux(torch.tensor(U[i]), mu_t),
               dj.estimator.reconstruct_flux(jnp.asarray(U[i]), mu_j)) <= TOL


@pytest.mark.parametrize("form", ["local_quantities_positive", "local_quantities"])
def test_local_quantities_single(setup, form):
    dj, dt, U = setup
    for i, m in enumerate(MUS):
        qj = getattr(dj.estimator, form)(jnp.asarray(U[i:i + 1]), {"diffusion": jnp.asarray([m])})
        qt = getattr(dt.estimator, form)(torch.tensor(U[i:i + 1]), {"diffusion": torch.tensor([m])})
        for a, b in zip(qt, qj):
            assert rel(a, b) <= TOL


@pytest.mark.parametrize("form", ["local_quantities_positive", "local_quantities"])
def test_local_quantities_lane_batched(setup, form):
    """theta and theta_f carry the lane axis: lane i at mu_i equals the
    single-query evaluation of JAX at mu_i."""
    dj, dt, U = setup
    qt = getattr(dt.estimator, form)(torch.tensor(U), {"diffusion": torch.tensor(MUS[:, None])})
    for i, m in enumerate(MUS):
        qj = getattr(dj.estimator, form)(jnp.asarray(U[i:i + 1]), {"diffusion": jnp.asarray([m])})
        for a, b in zip(qt, qj):
            assert rel(a[i], b[0]) <= TOL


def test_positive_form_equals_matrix_form(setup):
    _, dt, U = setup
    mu = {"diffusion": torch.tensor([0.5])}
    pos = dt.estimator.local_quantities_positive(torch.tensor(U), mu)
    mat = dt.estimator.local_quantities(torch.tensor(U), mu)
    for a, b in zip(pos, mat):
        assert rel(a, b) <= 1e-9      # the matrix form cancels a few digits


def test_estimate_and_indicators(setup):
    dj, dt, U = setup
    for i, m in enumerate(MUS):
        etaj, (ncj, rj, dfj), indj = dj.estimate(jnp.asarray(U[i]), m, decompose=True)
        etat, (nct, rt, dft), indt = dt.estimate(torch.tensor(U[i]), m, decompose=True)
        assert rel(etat, etaj) <= TOL
        for a, b in ((nct, ncj), (rt, rj), (dft, dfj), (indt, indj)):
            assert rel(a, b) <= TOL
        assert rel(dt.estimate(torch.tensor(U[i]), m, paper_convention=True),
                   dj.estimate(jnp.asarray(U[i]), m, paper_convention=True)) <= TOL
