"""The port's weak greedy (``greedy.py``) on CPU float64, mirrored from
tests/test_greedy.py, and against the JAX package's greedy.

Tolerances: batched against sequential estimates 1e-10 (batched LU and
einsums against their single forms); ``residual_norm`` against the true
residual 1e-8 (the reference test's); the JAX greedy: the same training
indices chosen and ``max_etas`` within 1e-6 relative per iteration (each
iteration stacks a FOM solve, a Gram-Schmidt and a cancelling surrogate).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.greedy import weak_greedy as jax_weak_greedy  # noqa: E402

from pylrbms_tpu_torch import model as model_mod  # noqa: E402
from pylrbms_tpu_torch import greedy as greedy_mod  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.greedy import weak_greedy, batched_estimates, _stack_mus  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402
from pylrbms_tpu_torch.utils.checkpoint import load_reductor, save_reductor  # noqa: E402
from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS, Timings  # noqa: E402

CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}


@pytest.fixture(scope="module")
def fom():
    d, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return d


@pytest.fixture(scope="module")
def rd1(fom):
    red = LRBMSReductor(fom, order=0)
    red.extend_basis(fom.solve(fom.parse_parameter(1.0)))
    return red.reduce()


@pytest.mark.parametrize("criterion", ["estimator", "residual", "residual_fom"])
def test_batched_estimates_match_sequential(fom, rd1, criterion):
    d, rd = fom, rd1
    mus = [d.parse_parameter(m) for m in (0.1, 0.4, 0.9)]
    etas = batched_estimates(rd, _stack_mus(mus), criterion)
    assert etas.shape == (3,)
    for mu, eta in zip(mus, etas):
        c = rd.solve(mu)
        if criterion == "estimator":
            ref = float(rd.estimate(c, mu))
        elif criterion == "residual":
            ref = float(rd.residual_norm(c, mu))
        else:
            U = rd.reconstruct(c)
            ref = float(torch.linalg.norm((d.rhs(mu) - d.assemble(mu).apply(U)).reshape(-1)))
        assert float(eta) == pytest.approx(ref, rel=1e-10)


def test_residual_falls_back_to_the_fom_residual_without_gramians(fom):
    d = fom
    red = LRBMSReductor(d, order=0)
    red.force_lean = True
    rd = red.reduce()
    assert rd.G_AA is None
    st = _stack_mus([d.parse_parameter(m) for m in (0.2, 0.7)])
    assert torch.equal(batched_estimates(rd, st, "residual"),
                       batched_estimates(rd, st, "residual_fom"))
    with pytest.raises(ValueError):
        batched_estimates(rd, st, "nonsense")


def test_residual_norm_matches_true_residual(fom, rd1):
    d, rd = fom, rd1
    mu = d.parse_parameter(0.35)
    c = rd.solve(mu)
    U = rd.reconstruct(c)
    r_true = float(torch.linalg.norm((d.rhs(mu) - d.assemble(mu).apply(U)).reshape(-1)))
    assert float(rd.residual_norm(c, mu)) == pytest.approx(r_true, rel=1e-8)


def test_weak_greedy_converges(fom):
    d = fom
    GLOBAL_TIMINGS.clear()
    GLOBAL_TIMINGS.enable()                 # off by default: the spans record only when on
    try:
        res = weak_greedy(d, d.parameter_space.sample_uniformly(7), target_error=1e-8,
                          max_extensions=10, criterion="residual")
    finally:
        GLOBAL_TIMINGS.disable()
    # the residual surrogate decays hard (smooth 1-parameter problem)
    assert res.max_etas[-1] < 1e-6 * res.max_etas[0], res.max_etas
    # and the ROM reproduces the FOM at an unseen parameter
    mu = d.parse_parameter(0.55)
    U_rom = res.reductor.reconstruct(res.rd.solve(mu))
    U_fom = d.solve(mu)
    assert float((U_rom - U_fom).abs().max() / U_fom.abs().max()) < 1e-6
    # the local bases stay orthonormal in the default product (1e-10)
    P = d.products["energy_mu_bar"].numpy()
    for k, V in enumerate(res.reductor.bases):
        np.testing.assert_allclose(V @ P[k] @ V.T, np.eye(V.shape[0]), atol=1e-10)
    # the spans the smoke run prints
    spans = GLOBAL_TIMINGS.spans
    assert len(spans["greedy: surrogate sweep"]) == len(res.max_etas)
    assert len(spans["greedy: FOM snapshot solve"]) == res.fom_solves
    for name in ("greedy: initial reduction", "greedy: basis extension (GS)",
                 "greedy: re-reduction (projection)"):
        assert name in spans and name in GLOBAL_TIMINGS.report()


def test_initial_rb_order_one(fom):
    d = fom
    red = LRBMSReductor(d, order=1)
    assert all(s == 4 for s in red.basis_sizes())   # 1, x, y, xy per subdomain
    mu = d.parse_parameter(0.5)
    rd1_, rd0 = red.reduce(), LRBMSReductor(d, order=0).reduce()
    # richer initial basis -> smaller estimate
    assert float(rd1_.estimate(rd1_.solve(mu), mu)) < float(rd0.estimate(rd0.solve(mu), mu))
    with pytest.raises(ValueError):
        LRBMSReductor(d, order=2)


def test_greedy_checkpoint_resume(fom, tmp_path):
    """Interrupt-and-resume reproduces the uninterrupted run."""
    d = fom
    training = d.parameter_space.sample_uniformly(4)
    ref = weak_greedy(d, training, target_error=1e-10, max_extensions=4)
    ckpt = str(tmp_path / "greedy_ckpt")
    part = weak_greedy(d, training, target_error=1e-10, max_extensions=2,
                       checkpoint_path=ckpt)
    assert part.fom_solves == 2
    res = weak_greedy(d, training, target_error=1e-10, max_extensions=4,
                      checkpoint_path=ckpt, resume=True)
    assert res.fom_solves == ref.fom_solves - 2     # the first two were not redone
    assert res.rd.solution_dim == ref.rd.solution_dim
    assert np.allclose(res.max_etas[-1], ref.max_etas[-1], rtol=1e-8)
    for b1, b2 in zip(res.reductor.bases, ref.reductor.bases):
        assert b1.shape == b2.shape and np.allclose(b1, b2, atol=1e-10)


def test_reductor_checkpoint_round_trip(fom, rd1, tmp_path):
    path = save_reductor(rd1.reductor, str(tmp_path / "red"))
    red = load_reductor(fom, path)
    for b1, b2 in zip(red.bases, rd1.reductor.bases):
        assert np.array_equal(b1, b2)
    assert torch.equal(red.reduce().A_red, rd1.A_red)


def test_greedy_at_scale_takes_the_lean_fom_residual_path(fom, monkeypatch):
    """Above the size gates (lowered here) the greedy evaluates the FOM
    residual directly, forces the lean projection on the reductor it owns,
    re-reduces incrementally and takes mf_pcg snapshot solves behind a
    background prepare_solver; a caller's reductor keeps its Gramians."""
    d, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    monkeypatch.setattr(greedy_mod, "RESIDUAL_FOM_MIN_DOFS", 0)
    monkeypatch.setattr(model_mod, "MF_SOLVE_MIN_DOFS", 0)
    training = d.parameter_space.sample_uniformly(6)
    res = weak_greedy(d, training, target_error=1e-12, max_extensions=3)
    assert res.reductor.force_lean and res.rd.G_AA is None
    assert res.reductor._img_cache["r_max"] == res.rd.r_max
    assert d.last_solve_iters is not None and res.fom_solves == 3
    assert res.max_etas[-1] < 5e-2 * res.max_etas[0], res.max_etas
    own = LRBMSReductor(d, order=0)
    kept = weak_greedy(d, training, target_error=1e-12, max_extensions=1, reductor=own)
    assert not own.force_lean and kept.rd.G_AA is not None
    # same selections from the Gramian form and the direct form (1e-6)
    monkeypatch.setattr(greedy_mod, "RESIDUAL_FOM_MIN_DOFS", 10**9)
    ref = weak_greedy(d, training, target_error=1e-12, max_extensions=3,
                      snapshot_options={"type": "dense"})
    assert [float(m["diffusion"]) for m in res.chosen_mus] == \
        [float(m["diffusion"]) for m in ref.chosen_mus]
    np.testing.assert_allclose(res.max_etas[:3], ref.max_etas[:3], rtol=1e-6)


def test_timings_wait_for_tensors_and_report():
    T = Timings()
    with T.span("a", sync=torch.ones(2)) as out:
        out["sync"] = torch.zeros(1)
    with T.span("a"):
        pass
    assert len(T.spans["a"]) == 2 and '"calls": 2' in T.as_json()
    assert "median[ms]" in T.report()
    T.clear()
    assert not T.spans


def test_weak_greedy_equals_jax():
    """The bench's greedy call on 2x2 subdomains: the same training indices
    chosen, max_etas within 1e-6 relative per iteration, equal basis sizes."""
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    res_j = jax_weak_greedy(dj, dj.parameter_space.sample_uniformly(6),
                            target_error=1e-12, max_extensions=4)
    res_t = weak_greedy(dt, dt.parameter_space.sample_uniformly(6),
                        target_error=1e-12, max_extensions=4)
    assert res_t.fom_solves == res_j.fom_solves
    assert [float(m["diffusion"]) for m in res_t.chosen_mus] == \
        [float(np.asarray(m["diffusion"]).ravel()[0]) for m in res_j.chosen_mus]
    assert len(res_t.max_etas) == len(res_j.max_etas)
    np.testing.assert_allclose(res_t.max_etas, res_j.max_etas, rtol=1e-6)
    assert (res_t.reductor.basis_sizes() == res_j.reductor.basis_sizes()).all()
