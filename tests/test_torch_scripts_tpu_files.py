"""Two values of the TPU-written result files that the port reproduces only
under the file's own conditions, shown on the CPU against the JAX package:

* the channels demo (``scripts/parabolic.py --subdomains 8 8 --nt 100``,
  ``docs/results/parabolic_tpu.txt``): its rhs switch sin(4 pi t) > 0 sits
  on its zeros at t = 1/4, 1/2, 3/4, 1, where the sign is rounding noise.
  Given the JAX CPU run's decisions there, the port equals the JAX script
  (1e-8); given the file's, it reproduces the file's estimates (1e-6 the
  FOM's, 1e-5 the ROM's);
* the at-scale SPE10 3D estimate (``spe10_3d_tpu.txt``: 2.2489e+03): the
  JAX package's accelerator branch (positive-form integrals in f32 above
  32 768 dofs, ``pylrbms_tpu/estimators.py:368-379``), which the port does
  not take.  At 55 296 dofs the JAX f64 estimate equals the port's (1e-8)
  and the forced accelerator branch is off by more than a factor of 100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu_torch.scripts import _results, parabolic as channels  # noqa: E402

KEYS = ("total", "nc", "r", "df", "rt", "tdnc")


def _jnorm(v):
    return float(np.sqrt(np.sum(np.asarray(v, np.float64) ** 2)))


def test_channels_demo_equals_jax_given_its_switch_at_the_zeros():
    """nt = 100 puts four steps on the switch's zeros; on 2x2 subdomains
    (the JAX channels discretization costs seconds a subdomain row)."""
    from pylrbms_tpu.problems.artificial_channels import init_grid_and_problem
    from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize
    d, _ = discretize(init_grid_and_problem({
        'num_subdomains': [2, 2], 'half_num_fine_elements_per_subdomain_and_dim': 1,
        'num_refinements': 1, 'grid_type': 'tri'}), 1.0, 100)
    mu = d.parameter_space.sample_randomly(1, seed=11)[0]
    est, parts = d.estimate(d.solve(mu), mu)
    jax_fom = [float(est)] + [_jnorm(p) for p in parts]
    with _results.channels_switch_at_ties(_results.CHANNELS_TIES_JAX_CPU):
        out = channels.main(nt=100, subdomains=(2, 2), device="cpu")["FOM"]
    for k, v in zip(KEYS, jax_fom):
        assert abs(out[k] - v) <= 1e-8 * v, k
    # the port's own decisions (on at 1/4 and 3/4) move the time terms
    own = channels.main(nt=100, subdomains=(2, 2), device="cpu")["FOM"]
    assert abs(own["rt"] / out["rt"] - 1) > 1e-3


def test_channels_demo_reproduces_the_tpu_file_given_its_switch_at_the_zeros():
    """The reference configuration (8x8 subdomains, nt = 100) with the file's
    decisions: the six FOM estimates to 1e-6, the ROM's to 1e-5 (the file's
    ROM values differ from its FOM values by up to 1.7e-6)."""
    with _results.channels_switch_at_ties(_results.CHANNELS_TIES_TPU):
        out = channels.main(nt=100, subdomains=(8, 8), device="cpu")
    for tag, tol in (("fom", 1e-6), ("rom", 1e-5)):
        for k in KEYS:
            _, _, _, ref, _, _ = _results.TPU_VALUES[f"parabolic.{tag}.{k}"]
            assert abs(out[tag.upper()][k] - ref) <= tol * ref, (tag, k)


def test_spe10_3d_at_scale_estimate_of_the_tpu_file_is_the_f32_branch(monkeypatch):
    from pylrbms_tpu import estimators
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d as jax_init
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize as jax_discretize
    from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
    cfg = {"num_subdomains": [8, 8, 4], "half_num_fine_elements_per_subdomain_and_dim": 3,
           "num_refinements": 0}
    kw = dict(layers=(40, 44), max_contrast=1e4)
    mu = {"switch": 1.0}
    d, _ = jax_discretize(jax_init(cfg, **kw), dtype=jnp.float64, lean=True)
    assert d.space.K * d.space.N == 55296
    U = d.op.assemble(d.theta(mu)).solve_pcg(d.rhs(mu), tol=1e-8, maxiter=4000,
                                             two_level=True)
    eta = float(d.estimate(U, mu, paper_convention=True))
    d_port, _ = discretize(init_grid_and_problem_3d(cfg, **kw), dtype=torch.float64,
                           lean=True, device="cpu")
    eta_port = float(d_port.estimate(torch.as_tensor(np.array(U)), mu, paper_convention=True))
    assert abs(eta_port - eta) <= 1e-8 * eta
    monkeypatch.setattr(estimators.jax, "default_backend", lambda: "tpu")
    eta_f32 = float(d.estimate(U, mu, paper_convention=True))
    assert eta_f32 > 100 * eta, (eta_f32, eta)
