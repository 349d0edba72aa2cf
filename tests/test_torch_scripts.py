"""The port's entry-point scripts (``pylrbms_tpu_torch/scripts``) against the
JAX package's scripts on CPU float64: the demo pipeline, the reference's
acceptance script, the golden-gap study and the VTU solve (the OS2015
tables: tests/test_torch_scripts_os2015.py); and every ported script raises
without a device when CUDA is absent.

Each case runs the JAX script's pipeline (its ``main`` where that returns
the numbers, else the JAX package pieces the script calls with the
script's module-level config) and the port's script on the same small
configuration (N <= 96).  Tolerances, stated beside each assert: rel 1e-8
for f64 quantities; the decomp script's detailed triple to ``GOLDEN`` of
tests/test_scripts.py at rel 1e-5 and the crisscross golden triple to rel
1e-4 (chip_smoke phase 14's values).  The demo runs on a 3x2 grid: on
square grids the OS2015 indicators tie in mirror pairs and Doerfler marking
may take the other twin.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402

from pylrbms_tpu_torch.scripts import _results  # noqa: E402
from pylrbms_tpu_torch.scripts import (  # noqa: E402
    golden_gap_study, linearelliptic_block_swipdg_decomp as decomp, mpi_elliptic,
    online_adaptive_lrbms as demo)

SCRIPTS = ("online_adaptive_lrbms", "linearelliptic_block_swipdg_decomp", "golden_gap_study",
           "mpi_elliptic", "OS2015_convergence_study", "OS2015_convergence_study_as_reduced",
           "p2_convergence_study", "parabolic_convergence_study", "parabolic",
           "academic3d_convergence_study", "q2_3d_convergence_study", "spe10_efficiency_study",
           "spe10_greedy", "spe10_scale", "spe10_parabolic", "spe10_3d",
           "spe10_3d_efficiency_study", "threadpool_test", "batched_matvec_test",
           "mf_sharded_xl_demo")
GOLDEN_CC = (1.656117e-01, 1.446952e-01, 3.548075e-01)


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


def _jax_triple(nc, r, df, eta):
    return [float(np.linalg.norm(np.asarray(v))) for v in (nc, r, df)] + [float(eta)]


# ------------------------------------------------------------------ row 1

def test_demo_pipeline_matches_jax():
    import online_adaptive_lrbms as js
    from pylrbms_tpu.reductor import ParallelLRBMSReductor, ExtensionError
    from pylrbms_tpu.online_enrichment import AdaptiveEnrichment
    cfg = dict(js.config, num_subdomains=[3, 2])
    gpd = jax_os2015(cfg)
    d, _ = jax_discretize(gpd, js.solver_options)
    mu = d.parse_parameter(1.)
    U = d.solve(mu)
    eta, _, _ = d.estimate(U, mu, decompose=True)
    red = ParallelLRBMSReductor(d, order=cfg['initial_RB_order'])
    try:
        red.extend_basis(U)
    except ExtensionError:
        pass
    rd = red.reduce()
    eta_red = float(rd.estimate(rd.solve(mu), mu))
    online = AdaptiveEnrichment(gpd, d, d.space, red, rd,
                                target_error=cfg['enrichment_target_error'],
                                marking_doerfler_theta=cfg['marking_doerfler_theta'],
                                marking_max_age=cfg['marking_max_age'])
    jax_online = []
    for mu_i in d.parameter_space.sample_randomly(2, seed=7):
        _, rd_i, _ = online.solve(mu_i, enrichment_steps=2)
        jax_online.append((float(online.estimate(rd_i.solve(mu_i), mu_i)), rd_i.solution_dim))

    out = demo.main(2, 2, device="cpu", config=cfg)
    # detailed and reduced eta: f64, one PCG at 1e-10 and a dense reduced solve
    assert rel(out["eta"], float(eta)) < 1e-8
    assert rel(out["eta_red"], eta_red) < 1e-8
    for (e_p, n_p), (e_j, n_j) in zip(out["online"], jax_online):
        assert n_p == n_j
        assert rel(e_p, e_j) < 1e-8


def test_demo_module_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "pylrbms_tpu_torch.scripts.online_adaptive_lrbms",
                        "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "online mu #4: final eta" in r.stdout


# ------------------------------------------------------------------ row 2

def test_decomp_script_reproduces_golden_and_jax(capsys):
    from tests.test_scripts import GOLDEN
    import linearelliptic_block_swipdg_decomp as js
    eta_rom_jax = float(js.main())
    out = decomp.main(device="cpu")
    for k, g in GOLDEN.items():
        assert out["fom"][k] == pytest.approx(g, rel=1e-5), (k, out["fom"][k], g)
    # ROM from 5 snapshots reproduces the detailed triple (as the JAX test)
    for k in ("eta_nc", "eta_r", "eta_df"):
        assert rel(out["rom"][k], out["fom"][k]) < 1e-8
    assert rel(out["rom"]["eta"], eta_rom_jax) < 1e-8
    assert out["max_reduction_error"] < 1e-8


def test_decomp_crisscross_paper_golden_triple(monkeypatch):
    import linearelliptic_block_swipdg_decomp as js
    monkeypatch.setattr(sys, "argv", ["x", "--crisscross", "--paper-convention"])
    try:
        eta_rom_jax = float(importlib.reload(js).main())
    finally:
        monkeypatch.setattr(sys, "argv", ["x"])
        importlib.reload(js)
    out = decomp.main(crisscross=True, paper_convention=True, device="cpu")
    triple = [out["fom"][k] for k in ("eta_nc", "eta_r", "eta_df")]
    assert rel(triple, GOLDEN_CC) < 1e-4, triple
    assert rel(out["rom"]["eta"], eta_rom_jax) < 1e-8


# ------------------------------------------------------------------ row 3

def test_golden_gap_study_matches_jax_and_the_file(tmp_path):
    import golden_gap_study as js
    rows_j, nozero_j = js.main(write=False)
    out = golden_gap_study.main(out=str(tmp_path / "gap.md"), device="cpu")
    assert (tmp_path / "gap.md").read_text() == out["text"]
    for (nref, h, ex, pa), (nref_j, h_j, ex_j, pa_j) in zip(out["rows"], rows_j):
        assert nref == nref_j and h == pytest.approx(h_j, rel=1e-14)
        for k in ("nc", "r", "df"):
            assert rel(ex[k], ex_j[k]) < 1e-8 and rel(pa[k], pa_j[k]) < 1e-8
    for k in ("nc", "r", "df"):
        assert rel(out["paper_nozero"][k], nozero_j[k]) < 1e-8
    # the file's sweep and findings to their printed digits
    assert _results.hold_golden_gap(out["rows"], out["text"]) == []


# ------------------------------------------------------------------ row 4

def test_mpi_elliptic_solution_and_vtu(tmp_path):
    import mpi_elliptic as js
    from chip_smoke import _vtu_check
    d, _ = jax_discretize(jax_os2015(js.config), solver_options={
        'type': 'pcg', 'precision': 1e-10, 'max_iter': 400})
    U_j = np.asarray(d.solve(d.parse_parameter(0.5)))
    out = mpi_elliptic.main(str(tmp_path), device="cpu")
    U = out["U"].numpy()
    # PCG to 1e-10 on both sides
    assert rel(U, U_j) < 1e-8
    sp = out["d"].space
    _vtu_check(out["path"], sp.K, sp.N, sp.K * sp.s * sp.s * sp.T, U)


# ------------------------------------------------------------------ every script

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without CUDA")
@pytest.mark.parametrize("name", SCRIPTS)
def test_script_without_device_raises(name):
    mod = importlib.import_module(f"pylrbms_tpu_torch.scripts.{name}")
    entry = getattr(mod, "cli", None) or mod.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry([])
