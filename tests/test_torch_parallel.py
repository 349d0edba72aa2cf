"""K-sharded execution of the port over gloo ranks on the CPU, mirrored from
tests/test_parallel.py (and the sharded sweeps of tests/test_greedy.py).

Each test launches 2 or 4 ranks (``scripts/distributed_smoke.launch``: one
spawned process per rank, a ``file://`` store in a temporary directory);
the ranks build the port's model from the same config and run the case of
``scripts/dryrun_multichip.CASES``.  This process runs the JAX package on
the same config (unsharded, on the CPU) and the port unsharded.
Tolerances, the JAX package's own for its sharded-vs-unsharded checks:
online step U rtol 1e-9 / atol 1e-12, indicators rtol 1e-8 / atol 1e-12;
reduced arrays rtol 1e-12 / atol 1e-14, ROM solve rtol 1e-10 / atol 1e-13,
estimate 1e-10; corrector 1e-8 of max |W|; greedy max errors rtol 1e-9.
The sweep's surrogates against JAX take the port's established bounds
(tests/test_torch_mor.py): the Gramian residual, a cancellation of three
terms, 1e-7; the direct FOM residual 1e-9.  Port sharded against port
unsharded: 1e-10 relative to the field's max |.|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.reductor import LRBMSReductor as JaxReductor  # noqa: E402
from pylrbms_tpu.ops.corrector import BatchedCorrector as JaxCorrector  # noqa: E402
from pylrbms_tpu.greedy import batched_estimates as jax_batched_estimates  # noqa: E402
from pylrbms_tpu.greedy import _stack_mus as jax_stack_mus  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.greedy import _stack_mus, batched_estimates, weak_greedy  # noqa: E402
from pylrbms_tpu_torch.ops.corrector import BatchedCorrector  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402
from pylrbms_tpu_torch.scripts import distributed_smoke  # noqa: E402
from pylrbms_tpu_torch.scripts.dryrun_multichip import case_target  # noqa: E402

REDUCED = ("A_red", "b_red", "G_nc", "AA", "ABT", "BBT", "DV", "RD")


def cfg(subs):
    return {"num_subdomains": list(subs),
            "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 1}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def run_case(world, name, subs, **kw):
    """Rank payloads of case ``name`` on ``world`` gloo ranks (CPU)."""
    spec = {"problem": "os2015", "cfg": cfg(subs)}
    return distributed_smoke.launch(case_target, world, args=(name, spec, kw), device="cpu",
                                    timeout_s=300)


def jax_fom(subs):
    return jax_discretize(jax_problem(cfg(subs)))


def port_fom(subs):
    return discretize(init_grid_and_problem(cfg(subs)), device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_online_step_matches_unsharded(world):
    subs = [2, 4]
    d, _ = jax_fom(subs)
    theta, theta_f = jnp.asarray([1.0, 0.5]), jnp.asarray([1.0])
    mu = d.parse_parameter(0.5)
    A = d.op.assemble(theta)
    U_ref = A.solve_pcg(jnp.einsum("q,qkn->kn", theta_f, d.rhs_q), tol=1e-10, maxiter=500)
    nc, r, df = d.estimator.local_quantities(U_ref, mu)
    ind_ref = np.asarray(nc + r + df)

    out = run_case(world, "online_step", subs, mu=0.5, tol=1e-10, maxiter=500)[0]["result"]
    np.testing.assert_allclose(out["U"], np.asarray(U_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out["ind"], ind_ref, rtol=1e-8, atol=1e-12)

    dp, _ = port_fom(subs)
    mu_p = dp.parse_parameter(0.5)
    Up = dp.assemble(mu_p).solve_pcg(dp.rhs(mu_p), tol=1e-10, maxiter=500)
    ncp, rp, dfp = dp.estimator.local_quantities(Up[None], mu_p)
    assert rel(out["U"], Up) < 1e-10
    assert rel(out["ind"], (ncp + rp + dfp)[0]) < 1e-10
    # eta from the ranks' bands and all-reduced norms
    eta_ref = float(d.estimate(U_ref, mu))
    assert abs(out["eta"] - eta_ref) <= 1e-8 * abs(eta_ref)
    assert abs(out["eta"] - float(dp.estimate(Up, mu_p))) <= 1e-10 * abs(eta_ref)


def _jax_bases(subs, products=True):
    d, data = jax_fom(subs)
    red = JaxReductor(d, products=data["local_energy_dg_product"] if products else None,
                      order=0)
    for v in (0.3, 1.0):
        red.extend_basis(d.solve({"diffusion": v}))
    return d, red


@pytest.mark.parametrize("world,subs", [(2, [4, 2]), (4, [2, 4])])
def test_sharded_reduce_matches_unsharded(world, subs):
    """reduce(mesh=) K-shards the projection over the ranks; every rank
    holds the whole reduced model, equal to the unsharded one."""
    _, red = _jax_bases(subs)
    rd_ref = red.reduce()
    bases = [np.asarray(b) for b in red.bases]
    outs = run_case(world, "reduce", subs, bases=bases, mu=0.55)
    dp, data = port_fom(subs)
    rd_port = LRBMSReductor(dp, bases=bases, products=data["local_energy_dg_product"]).reduce()
    for o in outs:
        res = o["result"]
        for name in REDUCED:
            np.testing.assert_allclose(res["arrays"][name], np.asarray(getattr(rd_ref, name)),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
        for name, a in res["arrays"].items():
            assert rel(a, getattr(rd_port, name)) < 1e-10, name
    mu = {"diffusion": 0.55}
    c_ref = np.asarray(rd_ref.solve(mu))
    res = outs[0]["result"]
    np.testing.assert_allclose(res["c"], c_ref, rtol=1e-10, atol=1e-13)
    e_ref = float(rd_ref.estimate(rd_ref.solve(mu), mu))
    assert abs(res["eta"] - e_ref) <= 1e-10 * abs(e_ref)


@pytest.mark.parametrize("world,subs", [(2, [4, 2]), (4, [2, 4])])
def test_sharded_corrector_matches_unsharded(world, subs):
    """The batched patch-corrector solve K-banded over the ranks equals the
    unsharded solve."""
    d, _ = jax_fom(subs)
    mu = {"diffusion": 0.5}
    U0 = 0.3 * d.solve(mu)          # deliberately wrong current solution
    marked = [1, 3, 6]
    W_ref = np.asarray(JaxCorrector(d).solve(marked, mu, current_solution=U0))
    out = run_case(world, "corrector", subs, marked=marked, mu=0.5,
                   current=np.asarray(U0))[0]["result"]
    assert np.abs(W_ref).max() > 1e-3         # nontrivial corrections
    assert np.abs(W_ref - out["W"]).max() <= 1e-8 * np.abs(W_ref).max()
    dp, _ = port_fom(subs)
    W_port = BatchedCorrector(dp).solve(marked, dp.parse_parameter(0.5),
                                        current_solution=torch.as_tensor(np.array(U0)))
    assert rel(out["W"], W_port) < 1e-10


def test_two_process_distributed_smoke():
    """The rank launcher end to end: two gloo ranks, an all_reduce and an
    all_gather, one K-sharded online step == unsharded (the port of the
    two-process jax.distributed smoke)."""
    assert distributed_smoke.main(["--world", "2", "--device", "cpu"]) == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card here")
def test_launchers_default_to_the_card():
    """Without a device the launchers mean the card: on a machine without
    CUDA they raise before any rank starts, and never fall back to the
    CPU."""
    from pylrbms_tpu_torch.scripts import dryrun_multichip
    for call in (lambda: distributed_smoke.launch(case_target, 1),
                 lambda: distributed_smoke.main(["--world", "1"]),
                 lambda: dryrun_multichip.run(1),
                 lambda: dryrun_multichip.main(["--world", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("world", [2, 4])
def test_parallel_reductor_defaults_to_device_mesh(world):
    """ParallelLRBMSReductor builds a mesh over the largest rank prefix
    that divides the subdomain rows: 4x2 subdomains give 2 rows, so at
    world 4 ranks 0-1 form a subgroup and ranks 2-3 reduce locally; every
    rank's reduced model equals the unsharded one."""
    subs = [4, 2]
    d, data = jax_fom(subs)
    ref = JaxReductor(d, products=data["local_energy_dg_product"], order=0)
    snaps = []
    for v in (0.3, 1.0):
        U = d.solve({"diffusion": v})
        ref.extend_basis(U)
        snaps.append(np.asarray(U))
    rd_ref = ref.reduce()
    outs = run_case(world, "parallel_reductor", subs, snapshots=np.stack(snaps))
    assert [o["result"]["mesh_size"] for o in outs] == [2, 2] + [None] * (world - 2)
    for o in outs:
        for name in REDUCED:
            np.testing.assert_allclose(o["result"]["arrays"][name],
                                       np.asarray(getattr(rd_ref, name)),
                                       rtol=1e-12, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_batched_estimates_sharded_over_training_set(world):
    """The sweep splits the (tiled) training lanes over the ranks: B=5 pads
    to a multiple of the world size, B=3 below the world size tiles."""
    subs = [2, 2]
    _, red = _jax_bases(subs, products=False)
    rd_ref = red.reduce()
    bases = [np.asarray(b) for b in red.bases]
    dp, _ = port_fom(subs)
    rd_port = LRBMSReductor(dp, bases=bases).reduce()
    for mus in ((0.1, 0.25, 0.4, 0.6, 0.8), (0.15, 0.5, 0.95)):
        for crit in ("residual", "residual_fom"):
            out = run_case(world, "batched_estimates", subs, bases=bases, mus=list(mus),
                           criterion=crit)[0]["result"]
            stacked = _stack_mus([dp.parse_parameter([m]) for m in mus])
            port = batched_estimates(rd_port, stacked, crit)
            np.testing.assert_allclose(out["etas"], port.numpy(), rtol=1e-10)
            jax_ref = np.asarray(jax_batched_estimates(
                rd_ref, jax_stack_mus([{"diffusion": m} for m in mus]), crit))
            # the Gramian residual cancels three terms: 1e-7 against JAX, as
            # test_torch_mor's residual_norm (the direct residual 1e-9)
            np.testing.assert_allclose(out["etas"], jax_ref,
                                       rtol=1e-7 if crit == "residual" else 1e-9)


def test_weak_greedy_sweep_sharded_matches_unsharded():
    """weak_greedy(mesh=) shards the surrogate sweep; every rank picks the
    same parameters and the trajectory equals the unsharded greedy's."""
    subs = [2, 2]
    dp, _ = port_fom(subs)
    training = [0.1 + 0.15 * i for i in range(7)]
    ref = weak_greedy(dp, [dp.parse_parameter([m]) for m in training], target_error=1e-8,
                      max_extensions=4, criterion="residual")
    outs = run_case(2, "weak_greedy", subs, training=training, extensions=4,
                    criterion="residual")
    for o in outs:
        np.testing.assert_allclose(o["result"]["max_etas"], ref.max_etas, rtol=1e-9)
        assert o["result"]["sizes"] == ref.reductor.basis_sizes().tolist()
