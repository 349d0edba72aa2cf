"""The port's 2D SPE10 scripts, the concurrency invariants and the K-sharded
matrix-free demo against the JAX package on CPU float64, at small
configurations (N <= 96); the native-3D SPE10 script:
tests/test_torch_scripts_spe10_3d.py.

Each case runs the JAX script's pipeline (the JAX package pieces its
``main`` calls, with the script's flags' values) and the port's script on
the same configuration.  Tolerances: rel 1e-8 for f64 quantities and for
solves run to 1e-11 or tighter; where a script's own solver tolerance is
loose (the stencil solves of ``spe10_scale`` at 1e-6, ``_mf_solve`` with
f32-applied factors) the port's relative residual is held to that
tolerance and its iteration count to +-15% of JAX's (the ``MF_PRECISION``
trap of tests/test_torch_matrixfree.py).  Enrichment on 3x2 grids (square
OS2015-like grids tie indicator pairs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu_torch.scripts import (  # noqa: E402
    batched_matvec_test, mf_sharded_xl_demo, spe10_greedy, spe10_parabolic, spe10_scale,
    threadpool_test)

TOL = 1e-8


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ------------------------------------------------------------------ row 13

def test_spe10_greedy_matches_jax():
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu.greedy import weak_greedy
    from pylrbms_tpu.online_enrichment import AdaptiveEnrichment
    from pylrbms_tpu import reductor as jax_reductor
    # the JAX package caches its jitted online step by array shapes alone,
    # closed over the first reduced model's parameter type: an OS2015 model
    # of equal shapes, reduced earlier in this worker process, would be
    # reused here ("missing parameter component 'diffusion'"); start empty
    jax_reductor._ONLINE_JIT_CACHE.clear()
    subs, half, nref, training, target = (3, 2), 1, 1, 4, 1e-2
    gpd = init_grid_and_problem({'num_subdomains': list(subs),
                                 'half_num_fine_elements_per_subdomain_and_dim': half,
                                 'num_refinements': nref})
    d, _ = discretize(gpd, dtype=jnp.float64)
    res = weak_greedy(d, d.parameter_space.sample_uniformly(training), target_error=target,
                      max_extensions=20)
    online = AdaptiveEnrichment(gpd, d, d.space, res.reductor, res.rd, target_error=target,
                                marking_doerfler_theta=0.33, marking_max_age=4)
    jax_online = []
    for mu in d.parameter_space.sample_randomly(2, seed=3):
        _, rd, _ = online.solve(mu, enrichment_steps=3)
        jax_online.append((float(online.estimate(rd.solve(mu), mu)), rd.solution_dim))

    out = spe10_greedy.main(subs, half, nref, training, target, online_mus=2, device="cpu")
    assert out["fom_solves"] == res.fom_solves and out["rb_size"] == res.rd.solution_dim
    assert rel(out["max_etas"], res.max_etas) < TOL
    # enrichment etas: PCG correctors at 1e-10 feed a Gram-Schmidt (as
    # tests/test_torch_mor.py), here at SPE10 contrast (measured 2.1e-8)
    for (e, n), (e_j, n_j) in zip(out["online"], jax_online):
        assert n == n_j and rel(e, e_j) < 1e-6


# ------------------------------------------------------------------ row 14

def test_spe10_scale_paths_match_jax():
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize
    cfg = {'num_subdomains': [4, 4], 'half_num_fine_elements_per_subdomain_and_dim': 1,
           'num_refinements': 1}
    d, _ = discretize(init_grid_and_problem(cfg), dtype=jnp.float64, lean=True)
    # --model-solver at precision 1e-11: U to rel 1e-8
    opts = {"type": "mf_pcg", "precision": 1e-11, "max_iter": 600,
            "coarse_space": "harvested", "coarse_modes": 16, "return_iters": True}
    mu = d.parse_parameter(0.2)
    d._mf_solve(d.theta(d.parse_parameter(0.5)), d.rhs(d.parse_parameter(0.5)), opts)
    U_j, it_j = d._mf_solve(d.theta(mu), d.rhs(mu), opts)
    out = spe10_scale.main(4, 4, 1, 1, "float64", model_solver=True, precision=1e-11,
                           device="cpu")
    assert rel(out["U"].numpy(), U_j) < TOL
    assert abs(out["per_mu"][-1][1] - int(it_j)) <= 0.15 * int(it_j)
    # --matrix-free --dtype float64 (tol 1e-6): the residual under the tolerance
    out = spe10_scale.main(4, 4, 1, 1, "float64", matrix_free=True, device="cpu")
    assert out["relres"] <= 1e-6 and out["finite"]


# ------------------------------------------------------------------ row 15

def test_spe10_parabolic_matches_jax():
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem
    from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu.reductor import ParabolicLRBMSReductor
    cfg = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
           "num_refinements": 1}
    nt, mu_v, nsnap = 4, 0.5, 4
    im, _ = discretize(init_grid_and_problem(cfg), T=1.0, nt=nt)
    mu, mu2 = (im.parse_parameter({"switch": v}) for v in (mu_v, 0.9 * mu_v))
    traj, traj2 = im.solve(mu), im.solve(mu2)
    eta = float(im.estimate(traj2, mu2)[0])
    sel = np.unique(np.linspace(0, nt, nsnap).astype(int))
    red = ParabolicLRBMSReductor(im.stationary)
    red.extend_basis(np.vstack([np.asarray(traj[sel]), np.asarray(traj2[sel])]))
    rd = red.reduce().attach_instationary(im)
    eta_rom = float(rd.estimate(rd.solve(mu2), mu2, projected=True)[0])

    out = spe10_parabolic.main(["--subdomains", "2", "2", "--half", "1", "--nref", "1",
                                "--nt", str(nt), "--rom", "--rom-snapshots", str(nsnap),
                                "--batch", "2"], device="cpu")
    assert rel(out["eta"], eta) < TOL and rel(out["rom_eta"], eta_rom) < TOL
    # the final step's equation, the host splu run and the lanes: rounding level
    assert out["euler_residual"] < 1e-12 and out["host_agreement"] < 1e-10
    assert out["batch_lane"] < 1e-8


# ------------------------------------------------------------------ row 18

def test_threadpool_and_batched_apply_match_jax():
    from pylrbms_tpu.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize
    out = threadpool_test.main(8, 2, 1, 4, device="cpu")
    assert out["identical"]
    out = batched_matvec_test.main(4, 2, 1, 1, device="cpu")
    assert out["max_lane_err"] < 1e-10
    # the operator both scripts apply equals JAX's on the same vectors
    d_j, _ = discretize(init_grid_and_problem({
        'num_subdomains': [2, 2], 'half_num_fine_elements_per_subdomain_and_dim': 1,
        'num_refinements': 1}))
    A_j = d_j.op.assemble(jnp.asarray([1.0, 0.5]))
    _, A, xs = threadpool_test.operator_and_vectors(8, 2, 1, torch.device("cpu"))
    for x in xs:
        assert rel(A.apply(x).numpy(), A_j.apply(jnp.asarray(x.numpy()))) < 1e-12


# ------------------------------------------------------------------ row 19

def test_xl_demo_sharded_matches_jax_unsharded():
    """2 gloo ranks, 2x2x2 hex subdomains (s = 2): the sharded U against the
    rank's own unsharded solve and against JAX's stencil PCG (both to
    1e-8 relres: U to 1e-6, the conditioning at this size)."""
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem
    from pylrbms_tpu.ops.spaces3d import BlockDGSpace3D
    from pylrbms_tpu.ops import assembly3d as asm3
    from pylrbms_tpu.ops.matrixfree3d import (assemble_swipdg_stencil3, StencilOperator3,
                                              stencil_coarse_matrix)
    res = mf_sharded_xl_demo.main(["--world", "2", "--backend", "gloo"], device="cpu",
                                  subdomains=(2, 2, 2), half=2)
    assert res["world"] == 2 and res["relres"] < 1e-8 and res["relres_unsharded"] < 1e-8
    assert res["u_vs_unsharded"] < 1e-8
    gpd = init_grid_and_problem({'num_subdomains': [2, 2, 2],
                                 'half_num_fine_elements_per_subdomain_and_dim': 2,
                                 'num_refinements': 0})
    sp = BlockDGSpace3D(gpd["grid"])
    sop = StencilOperator3(sp, tuple(assemble_swipdg_stencil3(sp, lf, None, dtype=jnp.float64)
                                     for lf in gpd["lambda"]["functions"]))
    A = sop.assemble(jnp.asarray([1.0, 0.5]))
    b = asm3.volume_functional(sp, gpd["f"], jnp.float64)
    ci = jnp.linalg.inv(stencil_coarse_matrix(A))
    U_j = A.solve_pcg(b, tol=1e-12, maxiter=2000, coarse_inv=ci)
    assert rel(res["U"], U_j) < 1e-6
