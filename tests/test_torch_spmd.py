"""The port's row-sharded SPMD solve (``parallel/spmd.py``) and the
K-sharded matrix-free solve over gloo ranks on the CPU == the unsharded
solves, mirrored from tests/test_spmd.py.

Ranks: ``scripts/distributed_smoke.launch`` runs the case of
``scripts/dryrun_multichip.CASES`` on each; this process runs the JAX
package (unsharded, on the CPU) and the port unsharded.  Tolerances, the
JAX tests' own: SPMD U rtol 1e-8 / atol 1e-11; the matrix-free solve rtol
1e-9 / atol 1e-11.  Port sharded against port unsharded: 1e-10 relative to
max |U|.  The solves run to PCG tolerance 1e-12 (the JAX tests: 1e-10): on
these 1D-like subdomain chains the recurrence's tail is sensitive to the
order of the dot products' sums (ky = 8 over 4 ranks stops 6 iterations
after the unsharded solve at 1e-10), so two solves at 1e-10 agree only to
~1e-10 of max |U|; at 1e-12 to ~1e-13.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.ops.matrixfree import StencilOperator, assemble_swipdg_stencil  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.scripts import distributed_smoke  # noqa: E402
from pylrbms_tpu_torch.scripts.dryrun_multichip import case_target  # noqa: E402


TOL = 1e-12


def cfg(subs):
    return {"num_subdomains": list(subs),
            "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 1}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def run_case(world, name, subs, **kw):
    spec = {"problem": "os2015", "cfg": cfg(subs)}
    return distributed_smoke.launch(case_target, world, args=(name, spec, kw),
                                    device="cpu", timeout_s=300)[0]["result"]


def port_pcg(subs, theta, tol):
    d, _ = discretize(init_grid_and_problem(cfg(subs)), device="cpu")
    th = torch.tensor(theta, dtype=torch.float64)
    return d.op.assemble(th).solve_pcg(torch.einsum("q,qkn->kn", torch.ones(1, dtype=torch.float64),
                                                    d.rhs_q), tol=tol, maxiter=500)


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_pcg_matches_unsharded(world):
    subs = [2, 4]                                  # kx=2, ky=4
    d, _ = jax_discretize(jax_problem(cfg(subs)))
    theta, theta_f = jnp.asarray([1.0, 0.5]), jnp.asarray([1.0])
    U_ref = d.op.assemble(theta).solve_pcg(jnp.einsum("q,qkn->kn", theta_f, d.rhs_q),
                                           tol=TOL, maxiter=500)
    out = run_case(world, "spmd", subs, theta=(1.0, 0.5), tol=TOL, maxiter=500)
    np.testing.assert_allclose(out["U"], np.asarray(U_ref), rtol=1e-8, atol=1e-11)
    assert rel(out["U"], port_pcg(subs, (1.0, 0.5), TOL)) < 1e-10


def test_spmd_pcg_multiple_rows_per_shard():
    """ky=8 over 4 ranks: 2 subdomain rows per rank — the intra-band
    vertical couplings together with the cross-band strips."""
    subs = [1, 8]
    d, _ = jax_discretize(jax_problem(cfg(subs)))
    U_ref = d.op.assemble(jnp.asarray([1.0, 0.8])).solve_pcg(
        jnp.einsum("q,qkn->kn", jnp.asarray([1.0]), d.rhs_q), tol=TOL, maxiter=500)
    out = run_case(4, "spmd", subs, theta=(1.0, 0.8), tol=TOL, maxiter=500)
    np.testing.assert_allclose(out["U"], np.asarray(U_ref), rtol=1e-8, atol=1e-11)
    assert rel(out["U"], port_pcg(subs, (1.0, 0.8), TOL)) < 1e-10


@pytest.mark.parametrize("world", [2, 4])
def test_matrixfree_solve_sharded_matches_unsharded(world):
    """The matrix-free two-level solve (subdomain-constant coarse level)
    with the stencil K-banded over the ranks == unsharded (one halo row per
    neighbor per apply, the coarse residual all-reduced)."""
    subs = [4, 4]
    d, _ = jax_discretize(jax_problem(cfg(subs)))
    theta = jnp.asarray([1.0, 0.5])
    sop = StencilOperator(d.space, tuple(assemble_swipdg_stencil(d.space, lf, None)
                                         for lf in d.estimator.data.lambda_funcs))
    A_dense = d.op.assemble(theta)
    U_ref = sop.assemble(theta).solve_pcg(
        d.rhs_q[0], tol=TOL, maxiter=2000, block_factors=A_dense.block_jacobi_factors(),
        coarse_inv=jnp.linalg.inv(A_dense.coarse_matrix()))
    out = run_case(world, "mf_solve", subs, mu=0.5, tol=TOL, two_level=True,
                   coarse_space="constants")
    np.testing.assert_allclose(out["U"], np.asarray(U_ref), rtol=1e-9, atol=1e-11)

    dp, _ = discretize(init_grid_and_problem(cfg(subs)), device="cpu")
    th = torch.tensor([1.0, 0.5], dtype=torch.float64)
    Ap = dp.op.assemble(th)
    Up = dp.mf_operator().assemble(th).solve_pcg(
        dp.rhs_q[0], tol=TOL, maxiter=2000, block_factors=Ap.block_jacobi_factors(),
        coarse_inv=torch.linalg.inv(Ap.coarse_matrix()))
    assert rel(out["U"], Up) < 1e-10
