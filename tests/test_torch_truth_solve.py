"""Port truth solver (pylrbms_tpu_torch/truth.py): ``truth_solve`` against
scipy splu and the JAX package on CPU float64, on the fixture of
tests/test_truth.py (SPE10 3D, 4x4x2 subdomains, half 1, nref 1: K=32,
N=64; raster (2, 4, 4), nearest, contrast 1e3).  The components are held
to JAX's in tests/test_torch_truth.py; the solves live here so that each
file stays near a minute on the CPU.

* U matches splu to 1e-6 (as in tests/test_truth.py) and JAX's U to 1e-6
  on both preconditioner routes and both recurrences, relres <= 1e-9, with
  JAX's iteration counts; the cell route's f32 IR inner iterations are held
  to 5% of JAX's (f32 sums in another order move the count), its rounds
  exactly;
* ``jacobi_storage='bf16'`` solves to the same accuracy, and a
  ``SolveOnlyModel`` (one stencil per (mu, dtype)) has JAX's stencil and
  rhs (1e-12) and solves the model's system.
"""
import numpy as np
import pytest
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d as jax_spe10  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize  # noqa: E402
import pylrbms_tpu.truth as jt  # noqa: E402

from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d as spe10  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402
from pylrbms_tpu_torch.la.block import to_scipy_csr  # noqa: E402
import pylrbms_tpu_torch.truth as tt  # noqa: E402

f64 = torch.float64
CFG = {"num_subdomains": [4, 4, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
FIELD = dict(raster=(2, 4, 4), raster_mode="nearest", max_contrast=1e3)
SOLVE = dict(tol=1e-10, n_harvest=8, extra_modal=3, rounds=2, verbose=False)
ROUTES = {"block-f64": dict(), "block-f32ir": dict(recurrence="f32ir"),
          "cell-f64": dict(precond="cell"), "cell-f32ir": dict(precond="cell", recurrence="f32ir")}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def pair():
    dj, _ = jax_discretize(jax_spe10(CFG, **FIELD))
    dt, _ = discretize(spe10(CFG, **FIELD), device="cpu")
    return dj, dt


@pytest.fixture(scope="module")
def splu_ref(pair):
    _, dt = pair
    mu = dt.parse_parameter({"switch": 0.6})
    A = to_scipy_csr(dt.assemble(mu)).tocsc()
    return spla.splu(A).solve(dt.rhs(mu).numpy().reshape(-1))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_truth_solve_matches_splu_and_jax(pair, splu_ref, route):
    dj, dt = pair
    kw = ROUTES[route]
    U, info = tt.truth_solve(dt, {"switch": 0.6}, **SOLVE, **kw)
    Uj, info_j = jt.truth_solve(dj, {"switch": 0.6}, **SOLVE, **kw)
    assert U.shape == (32, 64) and info["relres"] <= 1e-9
    assert rel(U.reshape(-1), splu_ref) < 1e-6
    assert rel(U, Uj) < 1e-6
    assert info["rounds"] == info_j["rounds"]
    if route == "cell-f32ir":
        assert abs(info["it32"] - info_j["it32"]) <= 0.05 * info_j["it32"]
    else:
        assert (info["it32"], info["it64"]) == (info_j["it32"], info_j["it64"])


def test_bf16_jacobi_storage_and_solve_only_model(pair, splu_ref):
    """The bf16-stored factors solve to the same accuracy; a SolveOnlyModel
    (one stencil per (mu, dtype)) gives JAX's stencil and rhs and solves
    the model's system."""
    dj, dt = pair
    U, info = tt.truth_solve(dt, {"switch": 0.6}, jacobi_storage="bf16", **SOLVE)
    assert info["relres"] <= 1e-9 and rel(U.reshape(-1), splu_ref) < 1e-6
    m = tt.SolveOnlyModel(spe10(CFG, **FIELD), device="cpu")
    mj = jt.SolveOnlyModel(jax_spe10(CFG, **FIELD))
    mu = {"switch": 0.6}
    assert rel(m.rhs(mu), mj.rhs(mu)) < 1e-12
    S, Sj = m.stencil_at(mu, f64), mj.stencil_at(mu, jnp.float64)
    for name in ("vol", "X", "Z", "IY"):
        a, b = getattr(S, name), getattr(Sj, name)
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert rel(x, y) < 1e-12
    U2, info2 = tt.truth_solve(m, mu, **SOLVE)
    assert info2["relres"] <= 1e-9 and rel(U2.reshape(-1), splu_ref) < 1e-6
