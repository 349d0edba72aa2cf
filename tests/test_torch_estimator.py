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


# -- the estimator's U- and mu-independent tables ----------------------------

TABLE_CHECKS = ["jax", "float32", "builds", "wide", "band"]


@pytest.fixture(scope="module")
def grids():
    """{grid type: (JAX model, port float64 model, port float32 model)}."""
    out = {}
    for gt in ("tri", "crisscross"):
        cfg = dict(CFG, grid_type=gt)
        dj, _ = jax_discretize(jax_problem(dict(cfg)))
        d64, _ = discretize(init_grid_and_problem(dict(cfg)), device="cpu")
        d32, _ = discretize(init_grid_and_problem(dict(cfg)), device="cpu",
                            dtype=torch.float32)
        out[gt] = (dj, d64, d32)
    return out


def _table_tensors(est, dtype):
    """Every tensor of the estimator's tables at ``dtype`` (face and volume)."""
    vol = est.tables(dtype, "cpu")
    face = est.data.flux.tables(est.data.lambda_funcs)
    return [v for v in vol.values() if isinstance(v, torch.Tensor)] + list(face)


@pytest.mark.parametrize("check", TABLE_CHECKS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("gt", ["tri", "crisscross"])
def test_estimator_tables(grids, gt, B, check):
    """The tabled flux reconstruction and positive form (order 1, B lanes at
    their own mu): equal to JAX lane by lane; float32 tables on a float32
    model; one table build serves five calls; the certified step's wide
    estimator builds float64 tables at set-up; a band's quantities are the
    full evaluation's rows."""
    from pylrbms_tpu_torch.estimators import EllipticEstimator
    from pylrbms_tpu_torch.model import _wide_estimator, make_online_step
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS

    dj, d64, d32 = grids[gt]
    rng = np.random.default_rng(B)
    mus = np.linspace(0.1, 1.0, B) if B > 1 else np.array([0.3])
    u0 = np.asarray(dj.solve(dj.parse_parameter(0.5), {"type": "dense"}))
    U = u0[None] + 0.05 * rng.normal(size=(B,) + u0.shape)
    mu = {"diffusion": torch.tensor(mus[:, None])}

    if check == "jax":
        est = EllipticEstimator(d64.estimator.data)
        t = est.reconstruct_flux(torch.tensor(U), mu, per_component=True)
        q = est.local_quantities_positive(torch.tensor(U), mu)
        for i, m in enumerate(mus):
            mj = {"diffusion": jnp.asarray([m])}
            assert rel(t[:, i], dj.estimator.reconstruct_flux(
                jnp.asarray(U[i]), mj, per_component=True)) <= TOL
            qj = dj.estimator.local_quantities_positive(jnp.asarray(U[i:i + 1]), mj)
            for a, b in zip(q, qj):
                assert rel(a[i], b[0]) <= TOL
    elif check == "float32":
        est = EllipticEstimator(d32.estimator.data)
        q32 = est.local_quantities_positive(torch.tensor(U, dtype=torch.float32),
                                            {"diffusion": mu["diffusion"].float()})
        assert all(v.dtype == torch.float32 for v in q32)
        assert all(v.dtype == torch.float32 for v in _table_tensors(est, torch.float32)
                   if v.is_floating_point())
        q64 = d64.estimator.local_quantities_positive(torch.tensor(U), mu)
        for a, b in zip(q32, q64):
            assert rel(a, b) <= 1e-4         # float32 rounding, ~1e-6 seen
    elif check == "builds":
        est = EllipticEstimator(d64.estimator.data)
        GLOBAL_TIMINGS.clear()
        GLOBAL_TIMINGS.enable()
        try:
            first = est.local_quantities_positive(torch.tensor(U), mu)
            for _ in range(4):
                again = est.local_quantities_positive(torch.tensor(U), mu)
            builds = GLOBAL_TIMINGS.counters["estimate.table_builds"]
        finally:
            GLOBAL_TIMINGS.disable()
            GLOBAL_TIMINGS.clear()
        assert builds == 1
        for a, b in zip(again, first):
            assert torch.equal(a, b)
    elif check == "wide":
        wide = _wide_estimator(d32.estimator, torch.float64)
        assert wide.data.flux.dtype == torch.float64
        assert all(v.dtype == torch.float64 for v in _table_tensors(wide, torch.float64)
                   if v.is_floating_point())
        GLOBAL_TIMINGS.clear()
        GLOBAL_TIMINGS.enable()
        try:
            step = make_online_step(d32, tol=1e-6, maxiter=200, certify=True)
            built = GLOBAL_TIMINGS.counters["estimate.table_builds"]
            th = torch.tensor(np.stack([np.ones(B), mus], 1), dtype=torch.float32)
            _, ind = step(th, torch.ones((B, 1), dtype=torch.float32),
                          {"diffusion": mu["diffusion"].float()})
            after = GLOBAL_TIMINGS.counters["estimate.table_builds"]
        finally:
            GLOBAL_TIMINGS.disable()
            GLOBAL_TIMINGS.clear()
        assert (built, after) == (1, 1)          # built at set-up, not in the call
        assert ind.dtype == torch.float64
    else:
        est = EllipticEstimator(d64.estimator.data)
        full = est.local_quantities_positive(torch.tensor(U), mu)
        K = d64.space.K
        for k0, k1 in ((0, 1), (1, K - 1), (K - 2, K)):
            part = est.local_quantities_positive(torch.tensor(U), mu, band=(k0, k1))
            for a, b in zip(part, full):
                assert rel(a, b[..., k0:k1]) <= 1e-14    # summation order only
