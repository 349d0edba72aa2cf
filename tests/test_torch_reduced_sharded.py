"""The port's block-row-sharded reduced solve (``ReducedModel.solve_sharded``,
the TP analog) over gloo ranks on the CPU == the replicated dense solve,
mirrored from tests/test_reduced_sharded.py.

The JAX package builds the reduced model from three snapshots; its bases go
to the ranks, which reduce on their own (replicated) and solve block-row
sharded: the matvec all-gathers the iterate, the diagonal-block inverses
precondition through ``precond_dot``, the dot products are all-reduced.
Tolerances, the JAX tests' own: c to 1e-8 relative to max |c| at PCG
tolerance 1e-12, the estimate of the sharded c to 1e-8; port sharded
against port unsharded (``rd.solve``) 1e-10.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.reductor import LRBMSReductor as JaxReductor  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402
from pylrbms_tpu_torch.scripts import distributed_smoke  # noqa: E402
from pylrbms_tpu_torch.scripts.dryrun_multichip import case_target  # noqa: E402

CFG = {"num_subdomains": [4, 4],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
MUS = (0.1, 0.55, 1.0)


@functools.lru_cache(maxsize=None)
def reference():
    """(bases, JAX reduced model, port reduced model) from three snapshots."""
    d, _ = jax_discretize(jax_problem(CFG))
    red = JaxReductor(d)
    # grow the bases past order-0 so the reduced system is non-trivial
    for m in (0.2, 0.7, 1.0):
        red.extend_basis(d.solve(d.parse_parameter([m])))
    bases = tuple(np.asarray(b) for b in red.bases)
    dp, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return bases, red.reduce(), LRBMSReductor(dp, bases=list(bases)).reduce()


@functools.lru_cache(maxsize=None)
def sharded(world):
    bases, _, _ = reference()
    spec = {"problem": "os2015", "cfg": CFG}
    return distributed_smoke.launch(case_target, world,
                                    args=("solve_sharded", spec,
                                          {"bases": list(bases), "mus": list(MUS) + [0.4]}),
                                    device="cpu", timeout_s=300)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_reduced_solve_matches_dense(world):
    _, rd, rd_port = reference()
    for o in sharded(world):                       # every rank holds the whole c
        for m, c_sh in zip(MUS, o["result"]["c"]):
            c_ref = np.asarray(rd.solve(rd.parse_parameter([m])))
            rel = np.abs(c_sh - c_ref).max() / max(np.abs(c_ref).max(), 1e-300)
            assert rel < 1e-8, (m, rel)
            c_port = rd_port.solve(rd_port.parse_parameter([m])).numpy()
            assert np.abs(c_sh - c_port).max() < 1e-10 * np.abs(c_port).max(), m


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_feeds_estimator(world):
    _, rd, _ = reference()
    mu = rd.parse_parameter([0.4])
    eta_sh = sharded(world)[0]["result"]["eta"][-1]
    eta_ref = float(rd.estimate(rd.solve(mu), mu))
    assert abs(eta_sh - eta_ref) < 1e-8 * max(abs(eta_ref), 1e-300)


def test_sharded_reduce_3d_matches_unsharded():
    """reduce(mesh=) on the 3D hex family (the z couplings in the band's
    block rows and operator images): 2x2x2 subdomains over two ranks, one
    z-layer each, against JAX's unsharded reduce (rtol 1e-12 / atol 1e-14,
    the JAX sharded-reduce test's bounds) and the port's (1e-10)."""
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem3
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize3
    from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as problem3
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as discretize3
    c = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}
    d, data = jax_discretize3(jax_problem3(c))
    red = JaxReductor(d, products=data["local_energy_dg_product"], order=0)
    for v in (0.3, 1.0):
        red.extend_basis(d.solve({"diffusion": v}))
    rd_ref = red.reduce()
    bases = [np.asarray(b) for b in red.bases]
    out = distributed_smoke.launch(case_target, 2, args=(
        "reduce", {"problem": "academic3d", "cfg": c}, {"bases": bases, "mu": 0.55}),
        device="cpu", timeout_s=300)[0]["result"]
    dp, datap = discretize3(problem3(c), device="cpu")
    rd_port = LRBMSReductor(dp, bases=bases, products=datap["local_energy_dg_product"]).reduce()
    for name, a in out["arrays"].items():
        ref = getattr(rd_ref, name)
        if ref is not None:
            np.testing.assert_allclose(a, np.asarray(ref), rtol=1e-12, atol=1e-14, err_msg=name)
        p = getattr(rd_port, name).numpy()
        assert np.abs(a - p).max() <= 1e-10 * np.abs(p).max(), name


def test_sharded_parabolic_reduce_matches_unsharded():
    """ParabolicLRBMSReductor.reduce(mesh=) passes the mesh on: the
    projected parabolic tensors (band rows of M^-1 A V, Gramian G_MAA
    summed over the ranks) and the reduced mass against JAX (1e-10 of
    max |.|, the port's bound for these tensors in
    tests/test_torch_parabolic_mor.py) and the port unsharded (1e-10)."""
    from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize as jax_parabolic
    from pylrbms_tpu.reductor import ParabolicLRBMSReductor as JaxParabolicReductor
    from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as parabolic
    from pylrbms_tpu_torch.reductor import ParabolicLRBMSReductor
    c = {"num_subdomains": [2, 4], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}
    imj, _ = jax_parabolic(jax_problem(c), T=0.5, nt=4)
    U = np.asarray(imj.solve(imj.parse_parameter(0.6)))
    redj = JaxParabolicReductor(imj.stationary)
    redj.extend_basis(U[1::2])
    rdj = redj.reduce()
    bases = [np.asarray(b) for b in redj.bases]
    out = distributed_smoke.launch(case_target, 2, args=(
        "parabolic_reduce", {"problem": "os2015", "cfg": c, "parabolic": {"T": 0.5, "nt": 4}},
        {"bases": bases}), device="cpu", timeout_s=300)[0]["result"]
    imt, _ = parabolic(init_grid_and_problem(c), T=0.5, nt=4, device="cpu")
    rdt = ParabolicLRBMSReductor(imt.stationary, bases=bases, order=None).reduce()

    def rel(a, b):
        b = np.asarray(b)
        return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300))
    for name, a in out["parabolic"].items():
        assert rel(a, rdj.elliptic.parabolic[name]) <= 1e-10, name
        assert rel(a, rdt.parabolic[name]) <= 1e-10, name
    assert rel(out["arrays"]["M_red"], rdj.M_red) <= 1e-10
    for name in ("A_red", "b_red", "G_nc", "G_AA"):
        assert rel(out["arrays"][name], getattr(rdj.elliptic, name)) <= 1e-10, name
        assert rel(out["arrays"][name], getattr(rdt, name)) <= 1e-10, name


def test_enrichment_inherits_the_reductors_mesh():
    """AdaptiveEnrichment with a reductor on the mesh: the corrector solves
    and the re-reductions run K-sharded, every rank marks the same
    subdomains (the reduced model is replicated), and eta and the local
    basis sizes per step equal the unsharded enrichment's (1e-10; 3x2
    subdomains: square grids tie mirror-twin indicators)."""
    c = {"num_subdomains": [3, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": 1}
    outs = distributed_smoke.launch(case_target, 2, args=(
        "enrichment", {"problem": "os2015", "cfg": c}, {"mu": 0.4, "steps": 2}), device="cpu",
        timeout_s=300)
    dp, data = discretize(init_grid_and_problem(c), device="cpu")
    from pylrbms_tpu_torch.scripts.dryrun_multichip import case_enrichment
    ref = case_enrichment(None, dp, data, mu=0.4, steps=2, sharded=False)
    assert len(ref["etas"]) == 3 and ref["sizes"][-1] != ref["sizes"][0]
    for o in outs:
        assert o["result"]["sizes"] == ref["sizes"]
        np.testing.assert_allclose(o["result"]["etas"], ref["etas"], rtol=1e-10)
