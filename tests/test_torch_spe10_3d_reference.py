"""The SPE10 3D configuration of the benchmark on the CPU: the port's hex Q1
block SWIPDG, its online step and its estimator held to the plain float64
reference of ``benchmark/reference/spe10_3d.py`` at 2 x 2 x 2 subdomains of
2^3 cells (K = 8, N = 64), on the surrogate field and on seeded random
cellwise fields of contrast 1e4.

Tolerances, each beside its assert: the matrix and the right-hand side
1e-12 of their largest entry (float64 sums in another order; lambda on a
face is each side's cell value in both); the float64 step's U 1e-9 of the
LU solution (PCG to a relative residual of 1e-13 at a condition number
near 1e4 times the mesh's); indicators on one U 1e-9 of their largest
(float64 quadrature of the same integrals); a batched float32 step within
the cell's own limits (``benchmark/workloads``), which the TF32 control of
``benchmark/reference/solve.py`` exceeds.
"""
import json
import pathlib

import numpy as np
import pytest
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmark import check  # noqa: E402
from benchmark.reference import spe10_3d as ref  # noqa: E402
from benchmark.reference.mesh3d import Mesh3D  # noqa: E402
from benchmark.reference.solve import Tf32Control  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize  # noqa: E402
from pylrbms_tpu_torch.la.block import to_scipy_csr  # noqa: E402
from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.problems import spe10, spe10_3d  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "spe10_3d_q1.sweep_b1024_c2"
GRID = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1, "grid_type": "hex"}
MESH = Mesh3D.from_config(GRID)
MUS = (0.1, 0.55, 1.0)
FIELDS = ("surrogate", "random0", "random1")
f64 = torch.float64


def _json(*parts):
    return json.loads(ROOT.joinpath("benchmark", *parts).read_text())


def random_block(seed):
    """[nz, ny, nx] cellwise field on the mesh's own raster, log-uniform
    over four decades."""
    return 10.0 ** np.random.default_rng(seed).uniform(-4.0, 0.0, MESH.shape)


def pair(field, dtype=f64, monkeypatch=None):
    """(port model, reference problem) of one field."""
    if field == "surrogate":
        k = ref.cell_field(MESH, spe10_3d.LAYERS, spe10_3d.MAX_CONTRAST)
        gpd = spe10_3d.init_grid_and_problem(dict(GRID))
    else:
        block = random_block(int(field[-1]))
        monkeypatch.setattr(spe10, "load_spe10_block", lambda layers: block)
        gpd = spe10_3d.init_grid_and_problem(dict(GRID))
        k = np.maximum(block / block.max(), 1.0 / spe10_3d.MAX_CONTRAST)
    d, _ = discretize(gpd, device="cpu", dtype=dtype)
    return d, ref.Spe10Q1(MESH, k)


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def surrogate():
    return pair("surrogate")


def test_the_configuration_names_the_programs_block():
    cfg = _json("configs", "spe10_3d_q1.json")
    assert tuple(cfg["field"]["layers"]) == spe10_3d.LAYERS
    assert cfg["field"]["max_contrast"] == spe10_3d.MAX_CONTRAST
    assert cfg["program"]["problem"] == spe10_3d.__name__
    k = ref.cell_field(Mesh3D.from_config(cfg["grid"]), spe10_3d.LAYERS, spe10_3d.MAX_CONTRAST)
    assert k.shape == (8, 16, 16) and k.max() == 1.0 and k.min() == 1e-4


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("mu", MUS)
def test_the_reference_matrix_is_the_ports_operator(field, mu, monkeypatch):
    d, prob = pair(field, monkeypatch=monkeypatch)
    m = {"switch": torch.tensor([mu], dtype=f64)}
    A, Ar = to_scipy_csr(d.assemble(m)), prob.matrix(mu)
    # float64 sums in another order: 1e-12 of the largest entry
    assert abs(A - Ar).max() <= 1e-12 * abs(Ar).max()
    assert rel(d.rhs(m).numpy().reshape(-1), prob.b) <= 1e-12


@pytest.mark.parametrize("field", FIELDS)
def test_the_float64_step_is_the_reference_solve_and_estimator(field, monkeypatch):
    d, prob = pair(field, monkeypatch=monkeypatch)
    step = make_online_step(d, tol=1e-13, maxiter=2000, matrix_free=True,
                            coarse_space="harvested", coarse_modes=4, jacobi_storage="native")
    mus = np.array(MUS)
    U, ind = step(np.stack([np.ones_like(mus), mus], 1), np.ones((len(mus), 1)),
                  {"switch": torch.tensor(mus[:, None])})
    for b, mu in enumerate(mus):
        u_ref = spla.splu(prob.matrix(mu)).solve(prob.b)
        # PCG to 1e-13 at contrast 1e4: U within 1e-9 of the LU solution
        assert np.linalg.norm(U[b].numpy().ravel() - u_ref) <= 1e-9 * np.linalg.norm(u_ref)
        # the same integrals on the same U, float64 quadrature: 1e-9
        assert rel(ind[b].numpy(), prob.indicators(U[b].numpy(), mu)) <= 1e-9


def test_the_float32_step_meets_the_cells_limits_and_the_tf32_control_does_not(surrogate):
    cfg = _json("configs", "spe10_3d_q1.json")
    limits = _json("workloads", CELL + ".json")["limits"]
    d32, _ = pair("surrogate", dtype=torch.float32)
    _, prob = surrogate
    kw = cfg["program"]["step"]            # bf16 factors as the card holds them
    step = make_online_step(d32, **{**kw, "matrix_free": True, "coarse_modes": 4})
    mus = np.random.default_rng(5).uniform(0.1, 1.0, 16)
    U, ind = step(np.stack([np.ones_like(mus), mus], 1), np.ones((len(mus), 1)),
                  {"switch": torch.tensor(mus[:, None], dtype=torch.float32)})
    got = check.numbers(prob, [(float(m), U[b].numpy(), ind[b].numpy())
                               for b, m in enumerate(mus)])
    assert all(got[k] <= limits[k] for k in check.NUMBERS), (got, limits)
    control = Tf32Control(prob, kw["tol"], "cpu")
    Uc = control(mus[:4])
    bad = check.numbers(prob, [(float(m), Uc[b].numpy(), control.indicators(Uc[b].numpy(), m))
                               for b, m in enumerate(mus[:4])])
    assert any(bad[k] > limits[k] for k in check.NUMBERS), (bad, limits)


def test_the_benchmark_system_builds_the_configuration_on_the_cpu():
    from benchmark.harness import _merge
    from benchmark.system import OnlineStep
    cfg = _merge(_json("configs", "spe10_3d_q1.json"),
                 {"grid": {"num_subdomains": [2, 2, 2], "num_refinements": 1},
                  "program": {"step": {"matrix_free": True, "coarse_modes": 4}}})
    system = OnlineStep(cfg, torch.device("cpu"))
    assert (system.K, system.N) == (8, 64) and "stencils" in system.step.arrays
    U, ind = system(np.array([0.1, 0.7]))
    assert U.shape == (2, 8, 64) and ind.shape == (2, 8) and bool(torch.isfinite(ind).all())

