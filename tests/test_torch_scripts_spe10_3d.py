"""The port's native-3D SPE10 script (``scripts/spe10_3d``) against the JAX
package on CPU float64 at small configurations (Q1 s <= 2, N <= 64): the
two-level FOM solve, estimate and snapshot ROM; the weak greedy and online
enrichment; the lean matrix-free run.  Tolerances beside each assert.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu_torch.scripts import spe10_3d  # noqa: E402

TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_online_step_cache():
    """The JAX package caches its jitted reduced online step by array shapes
    alone, closed over the first reduced model (its parameter type): a model
    of equal shapes from another file run earlier in this worker process
    would be reused here.  Start this file with an empty cache."""
    from pylrbms_tpu import reductor as jax_reductor
    jax_reductor._ONLINE_JIT_CACHE.clear()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ------------------------------------------------------------------ row 16

@pytest.mark.parametrize("flags", ["", "--greedy 2 --training 3 --online-mus 2"])
def test_spe10_3d_matches_jax(flags):
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu.reductor import LRBMSReductor
    gpd = init_grid_and_problem_3d({"num_subdomains": [3, 2, 2],
                                    "half_num_fine_elements_per_subdomain_and_dim": 1,
                                    "num_refinements": 1}, layers=(40, 44), max_contrast=1e4)
    d, _ = discretize(gpd, dtype=jnp.float64)
    mu = {"switch": 1.0}
    A = d.op.assemble(d.theta(mu))
    b = d.rhs(mu)
    U, it = A.solve_pcg(b, tol=1e-8, maxiter=4000, two_level=True, return_iters=True)
    relres = float(jnp.abs(A.apply(U) - b).max() / jnp.abs(b).max())
    eta = float(d.estimate(U, mu, paper_convention=True))
    out = spe10_3d.main(["--subdomains", "3", "2", "2", "--nref", "1"] + flags.split(),
                        device="cpu")
    # the script's two-level f64 PCG at 1e-8: the same iterations and
    # residual (its max-norm ratio; the PCG's tolerance is on the 2-norm);
    # the two iterates differ at the solve's rounding level under contrast
    # 1e4, and eta of them by 2.9e-8 (measured): 1e-6
    assert out["fom_its"] == int(it)
    assert rel(out["relres"], relres) < 1e-4
    assert rel(out["eta"], eta) < 1e-6
    mu_t = d.parse_parameter({"switch": 0.7})
    if not flags:
        red = LRBMSReductor(d, order=0)
        for m in (0.1, 0.4, 1.0):
            red.extend_basis(np.asarray(d.solve({"switch": m}), np.float64))
        rd = red.reduce()
        c = rd.solve(mu_t)
        eta_rom = float(rd.estimate(c, mu_t, paper_convention=True))
        assert out["rb_size"] == int(rd.sizes.sum())
        assert rel(out["eta_rom"], eta_rom) < TOL
        assert out["rom_fom_gap"] < 1e-8
        return
    from pylrbms_tpu.greedy import weak_greedy
    from pylrbms_tpu.online_enrichment import AdaptiveEnrichment
    res = weak_greedy(d, [{"switch": m} for m in np.linspace(0.1, 1.0, 3)],
                      target_error=1e-3, max_extensions=2)
    assert out["fom_solves"] == res.fom_solves
    assert rel(out["max_etas"], res.max_etas) < TOL
    assert rel(out["eta_rom"], float(res.rd.estimate(res.rd.solve(mu_t), mu_t))) < TOL
    rd_cur = res.rd
    for m, o in zip(np.random.default_rng(3).uniform(0.1, 1.0, 2), out["online"]):
        online = AdaptiveEnrichment(gpd, d, d.space, res.reductor, rd_cur, target_error=1e-3,
                                    marking_doerfler_theta=0.33, marking_max_age=4)
        rounds = []
        _, rd_cur, _ = online.solve({"switch": float(m)}, enrichment_steps=3,
                                    callback=lambda rd_, u_, mu_, st: rounds.append(st["eta"]))
        assert o["rb_size"] == rd_cur.solution_dim and rel(o["eta"], rounds[-1]) < 1e-6


def test_spe10_3d_lean_matrix_free_matches_jax():
    """``--lean --mf`` (the recorded at-scale command's form) at 3x2x2
    subdomains, s = 2: the positive-form estimate of the lean model against
    JAX's of the same U; both solves to 1e-8, the two-norm residual under
    it."""
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize
    gpd = init_grid_and_problem_3d({"num_subdomains": [3, 2, 2],
                                    "half_num_fine_elements_per_subdomain_and_dim": 1,
                                    "num_refinements": 1}, layers=(40, 44), max_contrast=1e4)
    d, _ = discretize(gpd, dtype=jnp.float64, lean=True)
    out = spe10_3d.main(["--subdomains", "3", "2", "2", "--nref", "1", "--lean", "--mf"],
                        device="cpu")
    assert out["relres2"] <= 1e-8
    U = d.op.assemble(d.theta({"switch": 1.0})).solve_pcg(
        d.rhs({"switch": 1.0}), tol=1e-12, maxiter=4000, two_level=True)
    # the port's U stopped at 1e-8, JAX's at 1e-12: eta to 1e-6
    assert rel(out["eta"], float(d.estimate(U, {"switch": 1.0}, paper_convention=True))) < 1e-6
