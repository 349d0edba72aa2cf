"""The reduced online step with adaptive online enrichment
(``model.make_online_step(d, enrichment=...)``) on SPE10 layer 42, held to
the plain episode of ``benchmark/reference/enrichment.py`` on the
reference discretization of ``benchmark/reference/spe10_2d.py``.

Grid: 3 x 2 subdomains of 4 x 4 cells (K = 6, N = 96: the batched-LU size
rule), not square, so that no two indicators tie in the marking.  The field
is clipped at contrast 1e4, as the 3D cell clips its own: there the
corrector's PCG converges (asserted below its cap), while at the full 1.8e8
it is a truncated CG that need not equal a dense patch LU.

Tolerances, each beside its assert: U and the indicators 1e-7 of their
largest entry (the corrector's PCG stops at a relative residual of 1e-10
where the reference factors each patch; the measured gaps are 1e-11 for U
and 1e-9 for the indicators); the marked sets and basis sizes exactly.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmark.reference import spe10_2d as ref  # noqa: E402
from benchmark.reference.enrichment import Episode, patch_of  # noqa: E402
from benchmark.reference.mesh import Mesh  # noqa: E402
from pylrbms_tpu_torch import greedy  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.ops.corrector import BatchedCorrector  # noqa: E402
from pylrbms_tpu_torch.problems import spe10  # noqa: E402
from pylrbms_tpu_torch.reductor import LRBMSReductor  # noqa: E402
from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the recorded run's settings, as the benchmark's configuration states them
SETTINGS = json.loads((ROOT / "benchmark/configs/spe10_2d_lrbms.json").read_text())[
    "program"]["step"]["enrichment"]
GRID = {"num_subdomains": [3, 2], "half_num_fine_elements_per_subdomain_and_dim": 2,
        "num_refinements": 1, "grid_type": "tri"}
CONTRAST = 1e4
MUS = (0.13, 0.55, 0.97)
TOL = 1e-7
SPANS = ("enrich: ROM online step", "enrich: corrector solve", "enrich: basis extension",
         "enrich: re-reduction", "enrich: restore")
f64 = torch.float64


def build(monkeypatch=None, lean=False):
    """(model, step) at the test's size; ``lean``: the greedy's direct FOM
    residual, as at scale, so the re-reductions run the image cache."""
    if lean:
        monkeypatch.setattr(greedy, "RESIDUAL_FOM_MIN_DOFS", 0)
    gpd = spe10.init_grid_and_problem(dict(GRID), max_contrast=CONTRAST)
    d, _ = discretize(gpd, device="cpu", dtype=f64)
    return d, make_online_step(d, enrichment=SETTINGS)


def query(mus):
    mus = np.atleast_1d(np.asarray(mus, np.float64))
    return (np.stack([np.ones_like(mus), mus], -1), np.ones((len(mus), 1)),
            {"switch": torch.as_tensor(mus[:, None])})


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def problem():
    mesh = Mesh.from_config(GRID, [[0.0, 0.0], [1.0, 1.0]])
    return ref.Spe10Tri(mesh, ref.cell_field(mesh, ref.LAYER, CONTRAST))


@pytest.fixture(scope="module")
def built():
    return build()


def test_the_reference_is_the_ports_discretization(built, problem):
    d, _ = built
    from pylrbms_tpu_torch.la.block import to_scipy_csr
    for mu in MUS:
        m = d.parse_parameter({"switch": mu})
        A, R = to_scipy_csr(d.assemble(m)), problem.matrix(mu)
        assert abs(A - R).max() <= 1e-12 * abs(R).max()          # float64 sums reordered
        U = torch.randn(d.space.K, d.space.N, dtype=f64, generator=torch.Generator().manual_seed(3))
        for got, want in zip(d.estimator.local_quantities(U[None], m), problem.parts(U.numpy(), mu)):
            assert rel(got[0], want) <= 1e-12                   # same integrals, float64


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("mu", MUS)
def test_episodes_match_the_reference(monkeypatch, problem, lean, mu):
    d, step = build(monkeypatch, lean)
    online = step.enrichment
    rounds = []
    solve, reduce = BatchedCorrector.solve, LRBMSReductor.reduce

    def corrector(self, marked, *a, **kw):
        rounds.append({"marked": sorted(marked), "sizes": online.reductor.basis_sizes().tolist()})
        W = solve(self, marked, *a, **kw)
        rounds[-1]["residual"] = float(self.last_residual.max())
        return W

    def reduced(self, *a, **kw):
        if rounds:
            rounds[-1]["after"] = self.basis_sizes().tolist()
        return reduce(self, *a, **kw)

    monkeypatch.setattr(BatchedCorrector, "solve", corrector)
    monkeypatch.setattr(LRBMSReductor, "reduce", reduced)
    U, ind = step(*query(mu))
    Ur, indr, hist = Episode(problem, step.offline.reductor[0], online.reductor.products)(mu)
    assert len(rounds) == len(hist) - 1 == SETTINGS["enrichment_steps"]
    for got, want, after in zip(rounds, hist, hist[1:]):
        assert got["marked"] == want["marked"]
        assert got["sizes"] == want["sizes"] and got["after"] == after["sizes"]
    assert max(online.corrector_iters) < 300                    # converged, below the cap
    assert all(r["residual"] <= 1e-10 for r in rounds)          # on the true residual
    assert rel(U[0], Ur) <= TOL and rel(ind[0], indr) <= TOL


def test_queries_do_not_see_each_other(built):
    _, step = built
    U1, i1 = step(*query([MUS[0], MUS[2]]))
    U2, i2 = step(*query([MUS[2], MUS[0]]))
    assert torch.allclose(U1, U2.flip(0), rtol=1e-12, atol=0.0)
    assert torch.allclose(i1, i2.flip(0), rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("lean", [False, True])
def test_a_call_leaves_the_offline_state_bitwise(monkeypatch, lean):
    _, step = build(monkeypatch, lean)
    red = step.enrichment.reductor
    bases = [b.copy() for b in red.bases]
    cache = red._img_cache
    assert (cache is not None) == lean
    kept = None if cache is None else {k: cache[k].clone() for k in ("Wk", "Tk")}
    rd = step.enrichment.rd
    tensors = {n: getattr(rd, n).clone() for n in step.arrays}
    step(*query(MUS))
    assert step.enrichment.rd is rd
    assert all(np.array_equal(a, b) for a, b in zip(red.bases, bases))
    assert len(red.bases) == len(bases)
    if lean:
        assert red._img_cache["r_max"] == cache["r_max"]
        assert all(torch.equal(red._img_cache[k], kept[k]) for k in kept)
        assert all(torch.equal(step.offline.reductor[1][k], kept[k]) for k in kept)
    assert all(torch.equal(getattr(rd, n), t) for n, t in tensors.items())


def test_the_steps_contract(built):
    d, step = built
    K, N = d.space.K, d.space.N
    U, ind = step(*query(MUS[:2]))
    assert U.shape == (2, K, N) and ind.shape == (2, K)
    assert U.dtype == ind.dtype == f64 and bool((ind > 0).all())
    assert "stencils" not in step.arrays and "A_red" in step.arrays
    th, thf, mu = query(MUS[1])
    u1, i1 = step(th[0], thf[0], {"switch": mu["switch"][0]})
    assert u1.shape == (K, N) and i1.shape == (K,)
    assert torch.allclose(u1, U[1], rtol=1e-12, atol=0.0)
    iters = step.iters_probe(*query(MUS[1]))
    assert isinstance(iters, int) and 0 < iters < 300
    with pytest.raises(ValueError, match="coefficients"):
        step(th + 0.1, thf, mu)
    with pytest.raises(ValueError, match="from mu"):
        step(th, thf)
    with pytest.raises(TypeError, match="rounds"):
        make_online_step(d, enrichment={**SETTINGS, "rounds": 2})


def test_enrichment_none_changes_nothing(built):
    d, _ = built
    th, thf, mu = query(MUS)
    a = make_online_step(d, tol=1e-10)(th, thf, mu)
    b = make_online_step(d, tol=1e-10, enrichment=None)(th, thf, mu)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_counters_and_spans(built):
    _, step = built
    th, thf, mu = query(MUS[:2])
    GLOBAL_TIMINGS.clear()
    step(th, thf, mu)                                   # off: nothing recorded
    assert not GLOBAL_TIMINGS.records and not GLOBAL_TIMINGS.counts
    GLOBAL_TIMINGS.enable()
    try:
        step(th, thf, mu)
    finally:
        GLOBAL_TIMINGS.disable()
    roots = [r for r in GLOBAL_TIMINGS.records if r.parent is None]
    spans, counters = GLOBAL_TIMINGS.spans, GLOBAL_TIMINGS.counters
    applies = [r for r in GLOBAL_TIMINGS.records if r.name in ("operator.apply", "precond.apply")]
    GLOBAL_TIMINGS.clear()
    rounds = 2 * SETTINGS["enrichment_steps"]
    assert [r.name for r in roots] == ["step"]
    # the corrector's applies: one of each an iteration, one apply to
    # confirm the stop, one preconditioner apply to start
    assert len(applies) == 2 * counters["corrector.iters"] + 2 * rounds
    assert all(r.parent.name == "enrich: corrector solve" for r in applies)
    assert len(spans["enrich: restore"]) == 2 and len(spans["enrich: ROM online step"]) == rounds + 2
    assert all(len(spans[s]) == rounds for s in SPANS[1:4])
    assert counters["enrich.rounds"] == rounds
    assert rounds <= counters["enrich.marked"] and 0 < counters["enrich.columns"] <= \
        counters["enrich.marked"]
    assert counters["corrector.iters"] > 0


def test_the_references_import_neither_jax_nor_the_port():
    code = ("import sys; import benchmark.reference.spe10_2d, benchmark.reference.enrichment; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'pylrbms_tpu', 'pylrbms_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_full_width_episode_matches_the_reference_on_the_card():
    """16 x 16 subdomains, 98 304 dofs, full contrast, float64, 2 queries:
    round 1's marked set equals the reference's (both start from the same
    offline model); each corrector solve stops on its true residual within
    its tolerance 1e-10, or at its cap of 300 iterations; each correction
    agrees with the reference's dense patch LU on its subdomain within 1e-8
    (the two solve the same patch system, assembled apart: the gap reads
    4e-15 to 7e-14 at 12 x 12 subdomains of N = 96 at full contrast on the
    CPU, 1.2e-10 to 4.8e-10 here on an NVIDIA H100).  The later rounds and
    U are printed beside the reference's.

    The reference's matrix cannot judge the residual at 1e-10 here: at a
    face between high and low permeability an entry cancels from O(0.1)
    terms to 1e-7, so the two assemblies differ by rounding in entries
    whose products with x ~ 1e4 move the residual by ~1e-9 (the reference's
    own patch LU reads 8e-10 against the port's matrix at 12 x 12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from pylrbms_tpu_torch.ops import hopper_kernels
    hopper_kernels.load()
    grid = {"num_subdomains": [16, 16], "half_num_fine_elements_per_subdomain_and_dim": 2,
            "num_refinements": 2, "grid_type": "tri"}
    dev = torch.device("cuda")
    d, _ = discretize(spe10.init_grid_and_problem(dict(grid)), device=dev, dtype=f64)
    step = make_online_step(d, enrichment=SETTINGS)
    online = step.enrichment
    mesh = Mesh.from_config(grid, [[0.0, 0.0], [1.0, 1.0]])
    problem = ref.Spe10Tri(mesh, ref.cell_field(mesh))
    episode = Episode(problem, step.offline.reductor[0], online.reductor.products, device=dev)
    solve = BatchedCorrector.solve
    seen = []

    def corrector(self, marked, mu=None, current_solution=None, **kw):
        W = solve(self, marked, mu, current_solution=current_solution, **kw)
        seen.append((sorted(marked), current_solution.cpu().numpy(), W.cpu().numpy(),
                     self.last_iters, self.last_residual.cpu().numpy()))
        return W

    BatchedCorrector.solve = corrector
    first, columns = [], []
    try:
        for mu in (0.23, 0.81):
            seen.clear()
            U, ind = step(*query(mu))
            Ur, indr, hist = episode(mu)
            print(f"mu {mu}: r_max offline {step.offline.rd.r_max}, "
                  f"u_err vs reference {rel(U[0].cpu(), Ur):.3e}, "
                  f"ind_err {rel(ind[0].cpu(), indr):.3e}")
            first.append((seen[0][0], hist[0]["marked"]))
            for r, ((marked, u_cur, W, its, own), h) in enumerate(zip(seen, hist)):
                gaps = [float(np.linalg.norm(W[i] - x.cpu().numpy()) / np.linalg.norm(x.cpu().numpy()))
                        for i, (_, x, *_r) in enumerate(episode.corrections(mu, u_cur, marked))]
                columns += [(g, float(o), its) for g, o in zip(gaps, own)]
                print(f"  round {r + 1}: marked {marked} (reference {h.get('marked')}), "
                      f"corrector {its} iterations, true residual {own.max():.3e}, "
                      f"gap to the patch LU {max(gaps):.3e}, eta {h['eta']:.4e}, "
                      f"sizes {sum(h['sizes'])}")
    finally:
        BatchedCorrector.solve = solve
    assert all(got == want for got, want in first)
    assert all(own <= 1e-10 or its >= 300 for _, own, its in columns)
    assert all(gap <= 1e-8 for gap, _, _ in columns)
