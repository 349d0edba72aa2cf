"""K-sharded matrix-free (stencil) work of the port over gloo ranks on the
CPU == unsharded, mirrored from tests/test_mf_sharded.py.

The banded stencil (``parallel/stencil.BandedStencil``) applies the
unsharded stencil on a rank's rows plus one halo row (z-layer) per
neighbor and keeps the rows; the PCG all-reduces its dot products and the
coarse residual.  Ranks run the cases of ``scripts/dryrun_multichip``; this
process runs the JAX package (unsharded, CPU) and the port unsharded.
Tolerances, the JAX tests' own: 2D two-level solve rtol 1e-9 / atol 1e-12;
3D single-level solve (stalling near 1e-8) rtol 1e-3 / atol 1e-8 plus its
own relative residual < 1e-8; crisscross apply rtol 1e-11 / atol 1e-13;
3D corrector rtol 1e-7 / atol 1e-10; lean positive estimate rtol 1e-10 /
atol 1e-14.  Port sharded against port unsharded: 1e-10 relative to the
field's max |.| (the 3D solve: its own residual, as against JAX).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem3  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize3  # noqa: E402
from pylrbms_tpu.la.block import prepare_coarse  # noqa: E402
from pylrbms_tpu.la.block import AssembledBlockOp as JaxABO  # noqa: E402
from pylrbms_tpu.ops.corrector import BatchedCorrector as JaxCorrector  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as problem3  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as discretize3  # noqa: E402
from pylrbms_tpu_torch.model import _frozen_preconditioner  # noqa: E402
from pylrbms_tpu_torch.ops.corrector import BatchedCorrector  # noqa: E402
from pylrbms_tpu_torch.scripts import distributed_smoke  # noqa: E402
from pylrbms_tpu_torch.scripts.dryrun_multichip import case_target  # noqa: E402


def cfg(subs, **kw):
    return {"num_subdomains": list(subs),
            "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 1, **kw}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def run_case(world, name, problem, c, lean=False, **kw):
    spec = {"problem": problem, "cfg": c, "lean": lean}
    return distributed_smoke.launch(case_target, world, args=(name, spec, kw),
                                    device="cpu", timeout_s=300)[0]["result"]


@functools.lru_cache(maxsize=None)
def refs_2d():
    """(JAX x, port x) of the 2D two-level solve (shared by both worlds)."""
    c = cfg([2, 8])
    d, _ = jax_discretize(jax_problem(c))
    theta = jnp.asarray([1.0, 0.45])
    A0 = d.op.assemble(theta)
    C, ci = prepare_coarse(A0, JaxABO.coarse_modes_basis(d.space, 3))
    x_ref = d.mf_operator().assemble(theta).solve_pcg(
        d.rhs_q[0], tol=1e-12, maxiter=2000, block_factors=A0.block_jacobi_factors(),
        coarse_basis=C, coarse_inv=ci)
    dp, _ = discretize(init_grid_and_problem(c), device="cpu")
    mu = dp.parse_parameter(0.45)
    th = dp.theta(mu)
    bf, Cp, cip = _frozen_preconditioner(dp, th, True, "modal", 3)
    Up = dp.mf_operator().assemble(th).solve_pcg(dp.rhs(mu), tol=1e-12, maxiter=2000,
                                                 block_factors=bf, coarse_basis=Cp,
                                                 coarse_inv=cip)
    return np.asarray(x_ref), Up.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_mf_sharded_solve_matches_unsharded_2d(world):
    c = cfg([2, 8])          # ky=8: 4 or 2 subdomain rows per rank
    out = run_case(world, "mf_solve", "os2015", c, mu=0.45, tol=1e-12, two_level=True,
                   coarse_space="modal", coarse_modes=3)
    x_ref, Up = refs_2d()
    np.testing.assert_allclose(out["U"], x_ref, rtol=1e-9, atol=1e-12)
    assert rel(out["U"], Up) < 1e-10


@functools.lru_cache(maxsize=None)
def refs_3d():
    """(JAX x, the port's model) of the 3D single-level solve."""
    c = cfg([1, 1, 8])
    d, _ = jax_discretize3(jax_problem3(c))
    theta = jnp.asarray([1.0, 0.45])
    x_ref = d.mf_operator().assemble(theta).solve_pcg(
        d.rhs_q[0], tol=1e-8, maxiter=2000,
        block_factors=d.op.assemble(theta).block_jacobi_factors())
    return np.asarray(x_ref), discretize3(problem3(c), device="cpu")[0]


@pytest.mark.parametrize("world", [2, 4])
def test_mf_sharded_solve_matches_unsharded_3d(world):
    c = cfg([1, 1, 8])       # kz=8 (the subdomain index is kz-major in 3D)
    out = run_case(world, "mf_solve", "academic3d", c, mu=0.45, tol=1e-8, two_level=False)
    x_ref, dp = refs_3d()
    # solution agreement is bounded by cond(A) * tol; the sharded solve's own
    # residual is held independently
    np.testing.assert_allclose(out["U"], x_ref, rtol=1e-3, atol=1e-8)
    mu = dp.parse_parameter(0.45)
    U = torch.as_tensor(out["U"])
    res = float(torch.linalg.norm(dp.mf_operator().assemble(dp.theta(mu)).apply(U) - dp.rhs(mu))
                / torch.linalg.norm(dp.rhs(mu)))
    assert res < 1e-8, res


@functools.lru_cache(maxsize=None)
def refs_cc():
    """(x, JAX y, port y) of the crisscross apply."""
    c = cfg([2, 8], grid_type="crisscross")
    d, _ = jax_discretize(jax_problem(c))
    x = np.random.default_rng(3).normal(size=(d.space.K, d.space.N))
    y_ref = np.asarray(d.mf_operator().assemble(jnp.asarray([1.0, 0.7])).apply(jnp.asarray(x)))
    dp, _ = discretize(init_grid_and_problem(c), device="cpu")
    yp = dp.mf_operator().assemble(torch.tensor([1.0, 0.7], dtype=torch.float64)).apply(
        torch.as_tensor(x))
    return x, y_ref, yp.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_mf_sharded_apply_matches_unsharded_crisscross(world):
    """The parity-masked crisscross stencil apply on band + halo rows."""
    c = cfg([2, 8], grid_type="crisscross")
    out = run_case(world, "stencil_apply", "os2015", c, theta=(1.0, 0.7), seed=3)
    _, y_ref, yp = refs_cc()
    np.testing.assert_allclose(out["y"], y_ref, rtol=1e-11, atol=1e-13)
    assert rel(out["y"], yp) < 1e-10


def test_corrector_sharded_matches_unsharded_3d():
    """The 3D batched patch corrector (z couplings included), K-banded over
    two ranks (one z-layer each), equals the unsharded solve."""
    c = cfg([2, 2, 2])
    d, _ = jax_discretize3(jax_problem3(c))
    mu = {"diffusion": 0.6}
    U = d.solve(mu)
    marked = [0, 3, 7]
    W_ref = np.asarray(JaxCorrector(d).solve(marked, mu, current_solution=U))
    out = run_case(2, "corrector", "academic3d", c, marked=marked, mu=0.6,
                   current=np.asarray(U))
    np.testing.assert_allclose(out["W"], W_ref, rtol=1e-7, atol=1e-10)
    dp, _ = discretize3(problem3(c), device="cpu")
    W_port = BatchedCorrector(dp).solve(marked, dp.parse_parameter(0.6),
                                        current_solution=torch.tensor(np.asarray(U)))
    assert rel(out["W"], W_port) < 1e-10


def test_corrector_stencil_sharded_matches_unsharded():
    """The matrix-free patch apply (the at-scale corrector path: the banded
    stencil plus the patch-crossing strip corrections on band + halo)."""
    c = cfg([2, 4])
    dp, _ = discretize(init_grid_and_problem(c), device="cpu")
    mu = dp.parse_parameter(0.5)
    U0 = 0.3 * dp.solve(mu)
    marked = [1, 4, 6]
    W_ref = BatchedCorrector(dp).enable_stencil().solve(marked, mu, current_solution=U0)
    out = run_case(2, "corrector", "os2015", c, marked=marked, mu=0.5, current=U0.numpy(),
                   stencil=True)
    assert rel(out["W"], W_ref) < 1e-10
    d, _ = jax_discretize(jax_problem(c))
    W_jax = np.asarray(JaxCorrector(d).solve(marked, {"diffusion": 0.5},
                                             current_solution=jnp.asarray(U0.numpy())))
    assert np.abs(W_jax - out["W"]).max() <= 1e-8 * np.abs(W_jax).max()


def test_lean_positive_estimate_sharded_matches_unsharded_3d():
    """The lean (positive-form) local quantities on the rank's band: the
    Oswald and flux operators on the gathered U, the integrals on the
    band's subdomains only."""
    c = cfg([2, 2, 2])
    d, _ = jax_discretize3(jax_problem3(c), lean=True)
    mu = {"diffusion": 0.6}
    U = d.solve(mu)
    ref = [np.asarray(v)[0] for v in d.estimator.local_quantities_positive(U[None], mu)]
    out = run_case(2, "positive_estimate", "academic3d", c, lean=True, mu=0.6,
                   U=np.asarray(U))
    for a, b in zip(out["quantities"], ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    dp, _ = discretize3(problem3(c), device="cpu", lean=True)
    port = dp.estimator.local_quantities_positive(torch.tensor(np.asarray(U))[None],
                                                  dp.parse_parameter(0.6))
    for a, b in zip(out["quantities"], port):
        assert rel(a, b[0]) < 1e-10
