"""The port's parabolic model order reduction (parabolic reductor, reduced
parabolic model, POD-greedy, parabolic adaptive enrichment) against the JAX
package on CPU float64.

Inputs: the artificial-channels problem on 3x2 subdomains, half 1, nref 1
(N = 24), nt 4; where the reduced tensors are compared the port's
reductor is given the JAX reductor's bases.
Tolerances, each stated beside its assert: reduced tensors 1e-10 relative
to the field's max |.| (float64 contractions in another summation order,
through an f64 inverse of the L2 blocks); reduced trajectories and
estimates 1e-9 (one dense LU per parameter on top); the projected estimate
against the FOM estimate of the reconstruction 1e-8; POD-greedy max
estimates 1e-6 (FOM trajectories feed a host eigh and Gram-Schmidt).
R = K * r_max stays below 190: torch's CPU batched LU (MKL, two threads)
has hung on larger stacks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pylrbms_tpu.online_enrichment as jax_enrichment  # noqa: E402
from pylrbms_tpu.problems.artificial_channels import init_grid_and_problem as jax_channels  # noqa: E402
from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize as jax_parabolic  # noqa: E402
from pylrbms_tpu.reductor import ParabolicLRBMSReductor as JaxParabolicReductor  # noqa: E402
from pylrbms_tpu.greedy import pod_greedy as jax_pod_greedy  # noqa: E402

import pylrbms_tpu_torch.online_enrichment as port_enrichment  # noqa: E402
from pylrbms_tpu_torch.problems.artificial_channels import init_grid_and_problem as channels  # noqa: E402
from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.convert import reduced_from_numpy  # noqa: E402
from pylrbms_tpu_torch.greedy import pod_greedy  # noqa: E402
from pylrbms_tpu_torch.reductor import (ParabolicLRBMSReductor,  # noqa: E402
                                        ReducedParabolicModel)

CFG = {"num_subdomains": [3, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
T, NT = 1.0, 4
RNG = np.random.default_rng(7)
SWITCHES = RNG.uniform(0.01, 1.0, 3)
PB_FIELDS = ("G_MAA", "G_BLB", "G_BLdiv", "G_FLF", "G_BLF", "G_FLdiv")


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def mu_of(s):
    return {"switch": float(s)}


@pytest.fixture(scope="module")
def models():
    imj, _ = jax_parabolic(jax_channels(CFG), T=T, nt=NT)
    imt, _ = discretize(channels(CFG), T=T, nt=NT, device="cpu")
    return imj, imt


@pytest.fixture(scope="module")
def reduced(models):
    """The JAX reductor on two-step-strided snapshots of one trajectory and
    the port's reductor on the same bases; both reduced and attached."""
    imj, imt = models
    U = np.asarray(imj.solve(imj.parse_parameter(mu_of(SWITCHES[0]))))
    redj = JaxParabolicReductor(imj.stationary)
    redj.extend_basis(U[1::2])
    rdj = redj.reduce().attach_instationary(imj)
    redt = ParabolicLRBMSReductor(imt.stationary, bases=[np.asarray(b) for b in redj.bases],
                                  order=None)
    rdt = redt.reduce().attach_instationary(imt)
    return rdj, rdt


@pytest.mark.parametrize("name", PB_FIELDS)
def test_parabolic_tensors_equal_jax(reduced, name):
    rdj, rdt = reduced
    assert rel(rdt.parabolic[name], rdj.elliptic.parabolic[name]) <= 1e-10


@pytest.mark.parametrize("name", ["M_red", "A_red", "b_red", "G_nc", "G_AA"])
def test_reduced_mass_and_operator_equal_jax(reduced, name):
    rdj, rdt = reduced
    ref = rdj.M_red if name == "M_red" else getattr(rdj.elliptic, name)
    assert rel(getattr(rdt, name), ref) <= 1e-10


def test_reduced_from_numpy_carries_the_parabolic_tensors(reduced, models):
    """The JAX reduced parabolic model's arrays carried into the port give
    a ReducedParabolicModel whose projected estimate is JAX's (1e-9)."""
    rdj, rdt = reduced
    _, imt = models
    el = rdj.elliptic
    fields = {n: (None if getattr(el, n) is None else np.asarray(getattr(el, n)))
              for n in el._ARRAY_FIELDS}
    fields["parabolic"] = {k: np.asarray(v) for k, v in el.parabolic.items()}
    fields["M_red"] = np.asarray(rdj.M_red)
    rc = reduced_from_numpy(rdt.reductor, fields).attach_instationary(imt)
    assert isinstance(rc, ReducedParabolicModel)
    assert sorted(rc.parabolic) == sorted(PB_FIELDS)
    mu = mu_of(SWITCHES[1])
    c = rc.solve(mu)
    eta, _ = rc.estimate(c, mu)
    etaj, _ = rdj.estimate(rdj.solve(rdj.d.parse_parameter(mu)), rdj.d.parse_parameter(mu))
    assert abs(float(eta) - float(etaj)) <= 1e-9 * abs(float(etaj))


@pytest.mark.parametrize("s", SWITCHES)
def test_reduced_trajectory_and_estimate_equal_jax(reduced, s):
    rdj, rdt = reduced
    mu = mu_of(s)
    c = rdt.solve(mu)
    muj = rdj.d.parse_parameter(mu)
    cj = rdj.solve(muj)
    assert tuple(c.shape) == (NT + 1, len(rdt.sizes), rdt.r_max)
    assert rel(c, cj) <= 1e-9
    eta, parts = rdt.estimate(c, mu)
    etaj, partsj = rdj.estimate(cj, muj)
    assert abs(float(eta) - float(etaj)) <= 1e-9 * abs(float(etaj))
    for a, b in zip(parts, partsj):
        assert rel(a, b) <= 1e-9


def test_projected_estimate_equals_the_fom_estimate_of_the_reconstruction(reduced):
    _, rdt = reduced
    mu = mu_of(SWITCHES[2])
    c = rdt.solve(mu)
    eta_p, parts_p = rdt.estimate(c, mu, projected=True)
    eta_r, parts_r = rdt.estimate(c, mu, projected=False)
    assert abs(float(eta_p) - float(eta_r)) <= 1e-8 * abs(float(eta_r))
    for a, b in zip(parts_p, parts_r):
        assert float((a - b).abs().max()) <= 1e-8 * max(float(b.abs().max()), 1e-12)


def test_batched_reduced_trajectories_and_estimates(reduced):
    """solve_batch / estimate_batch: lane b equals the per-mu solve and
    estimate (1e-12), and JAX's batched sweep (1e-9)."""
    rdj, rdt = reduced
    mus = [mu_of(s) for s in SWITCHES]
    cs = rdt.solve_batch(mus)
    etas = rdt.estimate_batch(cs, mus)
    for b, mu in enumerate(mus):
        assert rel(cs[b], rdt.solve(mu)) <= 1e-12
        assert abs(float(etas[b]) - float(rdt.estimate(cs[b], mu)[0])) <= 1e-12
    musj = [rdj.d.parse_parameter(m) for m in mus]
    csj = rdj.solve_batch(musj)
    assert rel(cs, csj) <= 1e-9
    assert rel(etas, rdj.estimate_batch(csj, musj)) <= 1e-9


def _span_gap(A, B, P):
    """max over rows of A of the P-norm of its part outside span(B) (B
    P-orthonormal rows)."""
    R = A - (A @ P @ B.T) @ B
    return float(np.sqrt(np.maximum(np.einsum("in,nm,im->i", R, P, R), 0.0)).max())


@pytest.fixture(scope="module")
def greedy_runs(models):
    imj, imt = models
    train_j = imj.parameter_space.sample_uniformly(4)
    train_t = imt.parameter_space.sample_uniformly(4)
    kw = dict(target_error=1e-6, max_extensions=3, pod_modes=2)
    return jax_pod_greedy(imj, train_j, **kw), pod_greedy(imt, train_t, **kw), train_t, kw


def test_pod_greedy_equals_jax(greedy_runs):
    """Same max estimates (1e-6), selections and basis sizes; the local
    bases span the same spaces (eigh signs are free)."""
    resj, rest, _, _ = greedy_runs
    assert rel(rest.max_etas, resj.max_etas) <= 1e-6
    assert rest.fom_solves == resj.fom_solves
    assert [float(m["switch"][0]) for m in rest.chosen_mus] == \
        [float(np.asarray(m["switch"])[0]) for m in resj.chosen_mus]
    assert np.array_equal(rest.reductor.basis_sizes(), resj.reductor.basis_sizes())
    for k, (Bt, Bj) in enumerate(zip(rest.reductor.bases, resj.reductor.bases)):
        P = rest.reductor.products[k]
        assert _span_gap(np.asarray(Bj), Bt, P) <= 1e-6
        assert _span_gap(Bt, np.asarray(Bj), P) <= 1e-6


def test_pod_greedy_resumes_from_its_checkpoint(greedy_runs, models, tmp_path):
    """Stopped after one extension and resumed, the POD-greedy ends where
    the uninterrupted run ended: same max estimates and bases."""
    _, rest, train, kw = greedy_runs
    _, imt = models
    path = str(tmp_path / "pod.npz")
    first = pod_greedy(imt, train, **dict(kw, max_extensions=1), checkpoint_path=path)
    assert len(first.max_etas) == 1
    resumed = pod_greedy(imt, train, **kw, checkpoint_path=path, resume=True)
    assert rel(resumed.max_etas, rest.max_etas) <= 1e-12
    for a, b in zip(resumed.reductor.bases, rest.reductor.bases):
        assert rel(a, b) <= 1e-10


def test_pod_greedy_with_batched_gram_schmidt(greedy_runs, models, monkeypatch):
    """The device-batched Gram-Schmidt (one POD-mode row of all subdomains
    at a time) gives the host path's estimates and basis sizes."""
    _, rest, train, kw = greedy_runs
    _, imt = models
    monkeypatch.setattr(ParabolicLRBMSReductor, "batched_gs", True)
    res = pod_greedy(imt, train, **kw)
    assert rel(res.max_etas, rest.max_etas) <= 1e-9
    assert np.array_equal(res.reductor.basis_sizes(), rest.reductor.basis_sizes())


def _enrichment_history(lib, im, Reductor, Loop, mu, monkeypatch):
    marks = []
    real = lib.doerfler_marking

    def recording(ind, theta):
        out = real(ind, theta)
        marks.append(sorted(out))
        return out

    monkeypatch.setattr(lib, "doerfler_marking", recording)
    red = Reductor(im.stationary)
    loop = Loop(im, red, red.reduce().attach_instationary(im), target_error=0.0)
    etas, sizes = [], []

    def cb(rd, c, mu_, info):
        etas.append(info["eta"])
        sizes.append(list(info["local RB sizes"]))

    c, rd, _ = loop.solve(im.parse_parameter(mu), enrichment_steps=3, callback=cb)
    return marks, etas, sizes, np.asarray(rd.reconstruct(c))


def test_parabolic_enrichment_history_equals_jax(models, monkeypatch):
    """From the order-0 basis, 3 rounds at one mu: the same Doerfler sets,
    basis sizes and eta per round (1e-6), and the ROM trajectory moves
    towards the FOM one."""
    imj, imt = models
    mu = mu_of(SWITCHES[1])
    mt, et, st, Ut = _enrichment_history(port_enrichment, imt, ParabolicLRBMSReductor,
                                         port_enrichment.ParabolicAdaptiveEnrichment, mu,
                                         monkeypatch)
    mj, ej, sj, _ = _enrichment_history(jax_enrichment, imj, JaxParabolicReductor,
                                        jax_enrichment.ParabolicAdaptiveEnrichment, mu,
                                        monkeypatch)
    assert mt == mj and len(mt) == 3
    assert st == sj
    assert rel(et, ej) <= 1e-6
    U = imt.solve(mu)
    red0 = ParabolicLRBMSReductor(imt.stationary)
    rd0 = red0.reduce().attach_instationary(imt)
    err0 = float(torch.linalg.norm(red0.reconstruct(rd0.solve(mu)) - U))
    assert float(np.linalg.norm(Ut - U.numpy())) < err0
