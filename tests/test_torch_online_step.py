"""Port online step (pylrbms_tpu_torch.model.make_online_step) against the
JAX package on CPU float64.

* carried-over state: the JAX step's ``step.arrays`` go through
  ``convert.arrays_from_numpy`` into the port's step, so both solve with
  identical operators, preconditioners and coarse spaces; U and indicators
  agree to 1e-10 relative (summation order only) and the PCG iteration
  counts are equal, single and per lane of a batched call;
* the stencil form (``matrix_free=True``) applies the block factors in
  f32, as the reference does: its lanes and single queries share the
  iteration counts, and agree to 1e-10 (f32 sums reordered by the lane
  batch) instead of 1e-12;
* end to end: the port builds its own model and preconditioner; at
  tol=1e-12 the independently built coarse bases (rounding-level
  differences) leave U within 1e-9 of JAX;
* the port imports neither jax nor the JAX package (subprocess, online
  step and matrix-free solve; and no such import line in its sources),
  its copies of the grid and space tables equal the JAX package's, and
  its entry points need ``device="cpu"`` where CUDA is absent.
"""
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.model import make_online_step as jax_online_step  # noqa: E402

from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.la.block import AffineBlockApply  # noqa: E402
from pylrbms_tpu_torch.ops.matrixfree import StencilOperator  # noqa: E402
from pylrbms_tpu_torch.convert import arrays_from_numpy, stencils_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"num_subdomains": [2, 2],
       "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 2}
MUS = np.array([0.15, 0.6, 1.0, 0.33])
STEP_KINDS = {
    "single_modal": dict(matrix_free=False),
    "affine_harvested": dict(matrix_free="affine", coarse_space="harvested",
                             coarse_modes=4),
    "stencil_harvested": dict(matrix_free=True, coarse_space="harvested",
                              coarse_modes=4),
}
# lanes against single queries: exact up to summation order, except where
# the preconditioner is applied in f32 (the stencil form)
LANE_TOL = {"single_modal": 1e-12, "affine_harvested": 1e-12, "stencil_harvested": 1e-10}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def args_jax(i):
    m = MUS[i]
    return jnp.asarray([1.0, m]), jnp.asarray([1.0]), {"diffusion": jnp.asarray([m])}


def args_torch(i):
    m = MUS[i]
    return (torch.tensor([1.0, m], dtype=torch.float64), torch.tensor([1.0], dtype=torch.float64),
            {"diffusion": torch.tensor([m])})


def batched_args():
    th = np.stack([np.ones(len(MUS)), MUS], 1)
    tf = np.ones((len(MUS), 1))
    return th, tf, MUS[:, None]


@pytest.fixture(scope="module")
def models():
    dj, _ = jax_discretize(jax_problem(CFG))
    dt, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return dj, dt


@pytest.fixture(scope="module", params=sorted(STEP_KINDS))
def carried(request, models):
    dj, dt = models
    kw = STEP_KINDS[request.param]
    sj = jax_online_step(dj, tol=1e-10, maxiter=500, **kw)
    st = make_online_step(dt, tol=1e-10, maxiter=500, **kw)
    assert set(st.arrays) == set(sj.arrays)
    st.arrays.update(arrays_from_numpy({k: np.asarray(v) for k, v in sj.arrays.items()
                                        if k != "stencils"}))
    if "stencils" in sj.arrays:
        st.arrays["stencils"] = stencils_from_numpy(sj.arrays["stencils"])
    return request.param, sj, st


def test_carried_single_queries(carried):
    _, sj, st = carried
    for i in range(len(MUS)):
        Uj, indj = sj(*args_jax(i))
        Ut, indt = st(*args_torch(i))
        assert rel(Ut, Uj) <= 1e-10
        assert rel(indt, indj) <= 1e-10
        assert st.iters_probe(*args_torch(i)[:2]) == sj.iters_probe(*args_jax(i)[:2])


def test_carried_batched_call(carried):
    _, sj, st = carried
    th, tf, mus = batched_args()
    Uj, indj = sj(jnp.asarray(th), jnp.asarray(tf), {"diffusion": jnp.asarray(mus)})
    Ut, indt = st(torch.tensor(th), torch.tensor(tf), {"diffusion": torch.tensor(mus)})
    assert Ut.shape == (len(MUS),) + tuple(Uj.shape[1:]) and indt.shape == indj.shape
    assert rel(Ut, Uj) <= 1e-10
    assert rel(indt, indj) <= 1e-10


def test_batched_equals_single_queries(carried):
    kind, _, st = carried
    th, tf, mus = batched_args()
    Ub, indb = st(torch.tensor(th), torch.tensor(tf), {"diffusion": torch.tensor(mus)})
    for i in range(len(MUS)):
        U1, ind1 = st(*args_torch(i))
        # per-lane frozen CG: each lane runs the single query's iterate
        # sequence; only the lock-step batched einsums reorder sums
        assert rel(Ub[i], U1) <= LANE_TOL[kind]
        assert rel(indb[i], ind1) <= LANE_TOL[kind]


def test_per_lane_iteration_counts(models, carried):
    """A shared lane-batched solve (the affine or the stencil apply over the
    carried arrays) freezes each lane at its own convergence: the per-lane
    counts equal the JAX single-query counts."""
    kind, sj, st = carried
    th, tf, _ = batched_args()
    a = st.arrays
    b = torch.einsum("bq,qkn->bkn", torch.tensor(tf), a["rhs_q"])
    pre = dict(coarse_inv=a["Cinv_bar"], coarse_basis=a["C_coarse"])
    if kind.startswith("stencil"):
        op = StencilOperator(models[1].space, a["stencils"]).assemble(torch.tensor(th))
        pre["block_factors"] = a["Minv_bar"]
    else:
        op = AffineBlockApply(models[1].op.static, a["A_diag"], a["C_R_io"],
                              a["C_R_oi"], a["C_U_io"], a["C_U_oi"], torch.tensor(th))
        pre["factors"] = a["Minv_bar"]
    _, it = op.solve_pcg(b, tol=1e-10, maxiter=500, return_iters=True, **pre)
    ref = [sj.iters_probe(*args_jax(i)[:2]) for i in range(len(MUS))]
    assert it.tolist() == ref
    assert st.iters_probe(torch.tensor(th), torch.tensor(tf)) == max(ref)


@pytest.mark.parametrize("kind", sorted(STEP_KINDS))
def test_end_to_end_against_jax(models, kind):
    dj, dt = models
    kw = STEP_KINDS[kind]
    sj = jax_online_step(dj, tol=1e-12, maxiter=1000, **kw)
    st = make_online_step(dt, tol=1e-12, maxiter=1000, **kw)
    th, tf, mus = batched_args()
    Ut, indt = st(torch.tensor(th), torch.tensor(tf), {"diffusion": torch.tensor(mus)})
    for i in range(len(MUS)):
        Uj, indj = sj(*args_jax(i))
        assert rel(Ut[i], Uj) <= 1e-9
        assert rel(indt[i], indj) <= 1e-9


@pytest.mark.parametrize("kw", [
    dict(matrix_free=False, coarse_space="geneo"),
    dict(matrix_free=False, fixed_preconditioner=False),
    dict(matrix_free="affine", fixed_preconditioner=False),
    dict(matrix_free=False, positive_form=False),
    dict(matrix_free="affine", two_level=False),
    dict(matrix_free="affine", with_estimate=False),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_step_options_against_jax(models, kw):
    """The step's other options (reference defaults otherwise), end to end
    at tol=1e-12 against JAX, single queries and one batched call."""
    dj, dt = models
    sj = jax_online_step(dj, tol=1e-12, maxiter=1000, **kw)
    st = make_online_step(dt, tol=1e-12, maxiter=1000, **kw)
    th, tf, mus = batched_args()
    out_b = st(torch.tensor(th), torch.tensor(tf), {"diffusion": torch.tensor(mus)})
    for i in (0, 3):
        out_j, out_t = sj(*args_jax(i)), st(*args_torch(i))
        if not kw.get("with_estimate", True):
            out_j, out_t, out_bi = (out_j,), (out_t,), (out_b[i],)
        else:
            out_bi = (out_b[0][i], out_b[1][i])
        for a, b, c in zip(out_t, out_j, out_bi):
            assert rel(a, b) <= 1e-9
            assert rel(c, b) <= 1e-9


def test_model_solve_dense_and_pcg(models):
    dj, dt = models
    for m in (0.2, 0.9):
        Uj = dj.solve(dj.parse_parameter(m), {"type": "dense"})
        assert rel(dt.solve(m, {"type": "dense"}), Uj) <= 1e-12
        assert rel(dt.solve(m, {"type": "pcg", "precision": 1e-12}), Uj) <= 1e-9


def test_dense_parity_fault_reproduced(models):
    """The cause of test_model_solve_dense_and_pcg's unsteady 4.26e-10
    (it passes at ~3e-15 otherwise), reproduced deterministically.  The
    port's first volume assembly evaluates lambda_0 = 1 + cos(pi x/2)
    cos(pi y/2) at 3200 quadrature points; that first ``cos`` was the
    process's first call into MKL's vector math, which torch splits into
    two chunks of 1600 run by its two intra-op threads at once.  Now and
    then (15 of 1600 fresh processes at 8 threads, ``scripts/vml_first_call.py``)
    MKL computed such a chunk (here the second: subdomains 2-3)
    with its AVX2 enhanced-performance kernel, not the AVX-512
    high-accuracy one that torch asks for.  Substituting that kernel's
    values gives the operator entry that faulty runs stored, bit for bit,
    and the failing test's 4.256528201200766e-10.  The package's import now
    makes every such first call on one element
    (``utils.precision.init_cpu_vector_math``), so no first call is
    concurrent."""
    import ctypes
    lib = os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so")
    if not hasattr(ctypes.CDLL(lib), "VMDCOS_"):
        pytest.skip("torch's CPU build has no MKL vector math")
    from pylrbms_tpu_torch.functions import ScalarFunction
    from pylrbms_tpu_torch.scripts.vml_first_call import VML_EP, vml_cos
    dj, dt = models
    gpd = init_grid_and_problem(CFG)
    lam0 = gpd["lambda"]["functions"][0]
    calls = []

    def first_cos_half_ep(x):              # the first evaluation is the volume's
        calls.append(x.shape)
        if len(calls) > 1:
            return lam0(x)
        a = (0.5 * np.pi * x[..., 0]).reshape(-1)
        c0 = torch.cos(a)
        c0[1600:] = torch.as_tensor(vml_cos(a[1600:].numpy(), VML_EP, "AVX2"))
        return 1 + c0.reshape(x.shape[:-1]) * torch.cos(0.5 * np.pi * x[..., 1])

    gpd["lambda"]["functions"][0] = ScalarFunction(first_cos_half_ep, name="lambda_0",
                                                   order=lam0.order)
    bad, _ = discretize(gpd, device="cpu")
    assert calls[0] == (4, 4, 4, 2, 25, 2)
    unit = torch.tensor([1.0, 0.0], dtype=torch.float64)
    A_bad, A = (m.op.assemble(unit).to_dense().numpy() for m in (bad, dt))
    assert A_bad[295, 295] == 4.666106313067205 != A[295, 295]
    assert 4.9e-10 < rel(A_bad, A) < 5e-10
    Uj = dj.solve(dj.parse_parameter(0.2), {"type": "dense"})
    assert abs(rel(bad.solve(0.2, {"type": "dense"}), Uj) / 4.256528201200766e-10 - 1) < 1e-4
    assert rel(dt.solve(0.2, {"type": "dense"}), Uj) <= 1e-12


def test_package_import_makes_the_first_vector_math_calls():
    """``import pylrbms_tpu_torch`` calls every VML-backed function once on
    one element per float dtype, before any port code runs."""
    code = (
        "import torch\n"
        "from torch.profiler import profile\n"
        "with profile(record_shapes=True) as p:\n"
        "    import pylrbms_tpu_torch\n"
        "from pylrbms_tpu_torch.utils.precision import _VML_FUNCTIONS\n"
        "seen = {(e.name, str(e.input_shapes)) for e in p.events()}\n"
        "for f in _VML_FUNCTIONS:\n"
        "    assert ('aten::' + f, '[[1]]') in seen, f\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem\n"
        "from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize\n"
        "from pylrbms_tpu_torch.model import make_online_step\n"
        "import pylrbms_tpu_torch.convert, pylrbms_tpu_torch.ops.hopper_kernels\n"
        "cfg = {'num_subdomains': [2, 2], "
        "'half_num_fine_elements_per_subdomain_and_dim': 1, 'num_refinements': 1}\n"
        "d, _ = discretize(init_grid_and_problem(cfg), device='cpu')\n"
        "U, ind = make_online_step(d, tol=1e-8)(torch.tensor([1.0, 0.5]), torch.tensor([1.0]),"
        " {'diffusion': torch.tensor([0.5])})\n"
        "assert U.shape == (4, 24) and bool(torch.isfinite(ind).all())\n"
        "U = d.solve(0.5, {'type': 'mf_pcg', 'precision': 1e-10})\n"
        "r = d.assemble(d.parse_parameter(0.5)).apply(U) - d.rhs(d.parse_parameter(0.5))\n"
        "assert int(d.last_solve_iters) > 0 and float(r.norm()) < 1e-8\n"
        "from pylrbms_tpu_torch.reductor import ParallelLRBMSReductor\n"
        "from pylrbms_tpu_torch.greedy import weak_greedy\n"
        "from pylrbms_tpu_torch.online_enrichment import AdaptiveEnrichment\n"
        "import pylrbms_tpu_torch.utils.checkpoint, pylrbms_tpu_torch.utils.logging\n"
        "import pylrbms_tpu_torch.problems.spe10, pylrbms_tpu_torch.discretize_elliptic_swipdg\n"
        "red = ParallelLRBMSReductor(d, order=0)\n"
        "rd = red.reduce()\n"
        "sizes = []\n"
        "AdaptiveEnrichment(None, d, d.space, red, rd, target_error=1e-9).solve(\n"
        "    0.5, enrichment_steps=1, callback=lambda rd, u, mu, m: sizes.append(m['global RB size']))\n"
        "assert sizes[0] == 4 and sizes[1] > 4, sizes\n"
        "res = weak_greedy(d, d.parameter_space.sample_uniformly(3), max_extensions=1)\n"
        "assert res.fom_solves == 1 and res.max_etas[0] > 0\n"
        "from pylrbms_tpu_torch.problems.artificial_channels_problem import "
        "init_grid_and_problem as channels\n"
        "import pylrbms_tpu_torch.problems.thermalblock_problem, "
        "pylrbms_tpu_torch.problems.local_thermalblock_problem\n"
        "import pylrbms_tpu_torch.problems.non_parametric_problem, "
        "pylrbms_tpu_torch.problems.OS2015_academic_problem\n"
        "from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as parabolic\n"
        "import pylrbms_tpu_torch.discretize_parabolic_swipdg\n"
        "from pylrbms_tpu_torch.greedy import pod_greedy\n"
        "from pylrbms_tpu_torch.online_enrichment import ParabolicAdaptiveEnrichment\n"
        "im, _ = parabolic(channels(cfg), T=1.0, nt=4, device='cpu')\n"
        "eta, parts = im.estimate(im.solve({'switch': 0.5}), {'switch': 0.5})\n"
        "pg = pod_greedy(im, im.parameter_space.sample_uniformly(2), max_extensions=1)\n"
        "assert pg.fom_solves == 1 and len(parts) == 5 and float(eta) > 0\n"
        "from pylrbms_tpu_torch.ops.rt1 import FluxReconstructorRT1\n"
        "from pylrbms_tpu_torch.ops.prolong import prolong\n"
        "from pylrbms_tpu_torch.ops.halodense import halo_from_assembled\n"
        "from pylrbms_tpu_torch.ops.banded import banded_operator\n"
        "from pylrbms_tpu_torch.EOC import StationaryEocStudy, InstationaryEocStudy\n"
        "cc, _ = discretize(init_grid_and_problem(dict(cfg, grid_type='crisscross')), "
        "device='cpu')\n"
        "p2, _ = discretize(init_grid_and_problem(cfg), device='cpu', order=2)\n"
        "assert isinstance(p2.estimator.data.flux, FluxReconstructorRT1)\n"
        "for m in (cc, p2):\n"
        "    mu = m.parse_parameter(0.5)\n"
        "    assert float(m.estimate(m.solve(mu), mu)) > 0\n"
        "A = d.assemble(d.parse_parameter(0.5))\n"
        "assert float((halo_from_assembled(A).apply(U) - A.apply(U)).abs().max()) < 1e-12\n"
        "bop = banded_operator(d.space, d.op)\n"
        "y = bop.apply(bop.assemble(d.theta(d.parse_parameter(0.5))), U)\n"
        "assert float((y - A.apply(U)).abs().max()) < 1e-12\n"
        "assert prolong(d.space, U, p2.space).shape == (4, 48)\n"
        "from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as ac3\n"
        "from pylrbms_tpu_torch.problems.thermalblock3d import init_grid_and_problem as tb3\n"
        "from pylrbms_tpu_torch.problems.spe10 import init_grid_and_problem_3d\n"
        "from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as d3\n"
        "from pylrbms_tpu_torch.discretize_parabolic_block_swipdg3d import discretize as p3\n"
        "from pylrbms_tpu_torch.ops.rt1hex import FluxReconstructorRT1Hex\n"
        "from pylrbms_tpu_torch.ops.matrixfree3d import stencil_coarse_matrix\n"
        "c3 = {'num_subdomains': [2, 1, 2], "
        "'half_num_fine_elements_per_subdomain_and_dim': 1, 'num_refinements': 0}\n"
        "h1, _ = d3(ac3(c3), device='cpu')\n"
        "h2, _ = d3(ac3(c3), device='cpu', order=2)\n"
        "assert isinstance(h2.estimator.data.flux, FluxReconstructorRT1Hex)\n"
        "for m in (h1, h2):\n"
        "    mu = m.parse_parameter(0.5)\n"
        "    U3 = m.solve(mu, {'type': 'mf_pcg', 'precision': 1e-10})\n"
        "    assert float(m.estimate(U3, mu)) > 0\n"
        "assert prolong(h1.space, torch.ones(4, 8, dtype=torch.float64), h2.space).shape == (4, 27)\n"
        "assert stencil_coarse_matrix(h1.mf_operator().assemble(h1.theta(mu))).shape == (4, 4)\n"
        "im3, _ = p3(ac3(c3), T=1.0, nt=2, device='cpu')\n"
        "assert im3.solve(im3.parse_parameter(0.5)).shape == (3, 4, 8)\n"
        "d3(tb3(c3), device='cpu', lean=True)\n"
        "d3(init_grid_and_problem_3d(c3, max_contrast=1e4), device='cpu', lean=True)\n"
        "import tempfile\n"
        "from pylrbms_tpu_torch.truth import truth_solve, SolveOnlyModel\n"
        "from pylrbms_tpu_torch.utils import vtk, roofline\n"
        "from pylrbms_tpu_torch import native\n"
        "from pylrbms_tpu_torch.scripts import spe10_3d_truth\n"
        "assert '442k-q2' in spe10_3d_truth.CONFIGS\n"
        "U4, info = truth_solve(h1, 0.5, tol=1e-10, n_harvest=4, extra_modal=2, verbose=False)\n"
        "assert info['relres'] < 1e-9 and U4.shape == (4, 8)\n"
        "U5, _ = truth_solve(SolveOnlyModel(ac3(c3), device='cpu'), 0.5, n_harvest=4,\n"
        "                    extra_modal=2, recurrence='f32ir', verbose=False)\n"
        "assert abs(U5 - U4).max() < 1e-6 * abs(U4).max()\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    assert h1.visualize(U4, tmp + '/u').endswith('.vtu')\n"
        "    h1.grid.visualize(tmp + '/g'); d.grid.visualize(tmp + '/g2')\n"
        "assert roofline.matvec_cost(h1.mf_operator().assemble(h1.theta(mu))).flops > 0\n"
        "native.available()\n"
        "import torch.distributed as dist\n"
        "from pylrbms_tpu_torch.parallel.mesh import (SubdomainMesh, initialize_distributed,\n"
        "                                             psum_norm)\n"
        "from pylrbms_tpu_torch.parallel.spmd import SpmdOnlineSolver\n"
        "from pylrbms_tpu_torch.parallel.stencil import BandedStencil, BandedBlockOp\n"
        "from pylrbms_tpu_torch.scripts import distributed_smoke, dryrun_multichip\n"
        "mu0 = d.parse_parameter(0.5)\n"
        "U0 = d.assemble(mu0).solve_pcg(d.rhs(mu0), tol=1e-10)\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    initialize_distributed('file://' + tmp + '/store', 1, 0, device='cpu')\n"
        "    mesh = SubdomainMesh.create()\n"
        "    Um, ind = mesh.online_step(d, tol=1e-10)(d.theta(mu0), d.theta_f(mu0), mu0)\n"
        "    Us = SpmdOnlineSolver(d, mesh).make_step(tol=1e-10)(d.theta(mu0), d.theta_f(mu0))\n"
        "    assert mesh.axis == 'k' and mesh.to_host(Um, mesh.shard_k(0)).shape == (4, 24)\n"
        "    assert float(psum_norm(mesh.globalize(torch.ones(4, dtype=torch.float64)), mesh)) == 2\n"
        "    dist.destroy_process_group()\n"
        "assert float((Um - U0).abs().max()) < 1e-12 and float((Us - U0).abs().max()) < 1e-12\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'pylrbms_tpu')\n"
        "assert not ref, ref\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_sources_have_no_reference_import():
    """No line of the port's package or of the root tools (chip_smoke.py,
    kernel_ab.py) imports the JAX package (docstrings may still name its
    files)."""
    pattern = re.compile(r"^\s*(from|import) pylrbms_tpu(\.|\s|$)")
    files = sorted(os.path.join(root, f)
                   for root, _, names in os.walk(os.path.join(REPO, "pylrbms_tpu_torch"))
                   for f in names if f.endswith(".py"))
    files += [os.path.join(REPO, tool) for tool in ("chip_smoke.py", "kernel_ab.py")]
    assert len(files) > 20
    scanned = {os.path.relpath(f, REPO) for f in files}
    for module in ("truth.py", "utils/vtk.py", "utils/roofline.py", "native/__init__.py",
                   "scripts/spe10_3d_truth.py"):
        assert f"pylrbms_tpu_torch/{module}" in scanned, module
    hits = [f"{path}:{i}" for path in files
            for i, line in enumerate(open(path, encoding="utf-8"), 1) if pattern.match(line)]
    assert not hits, hits


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA and without a device, the entry points raise: the port
    runs on the card unless the caller names the CPU."""
    from pylrbms_tpu_torch.model import StationaryBlockModel
    from pylrbms_tpu_torch.parameters import evaluate_coefficients
    from pylrbms_tpu_torch.utils.precision import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"num_subdomains": [2, 2],
           "half_num_fine_elements_per_subdomain_and_dim": 1, "num_refinements": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        discretize(init_grid_and_problem(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StationaryBlockModel(None, None, None, [], None, [], None, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_coefficients([1.0], {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device("cuda")
    assert device("cpu") == torch.device("cpu")
    d, _ = discretize(init_grid_and_problem(cfg), device="cpu")
    assert d.device == torch.device("cpu") and d.rhs_q.device.type == "cpu"


def _hex_tables_equal_jax(cfg, order):
    """The 3D copies (grid3d, the hex basis and rules, ops.spaces3d with its
    RT0 hex layout) against the JAX package's tables."""
    import pylrbms_tpu.basis as jB
    import pylrbms_tpu.quadrature as jQ
    import pylrbms_tpu_torch.basis as tB
    import pylrbms_tpu_torch.quadrature as tQ
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_ac3
    from pylrbms_tpu.ops.spaces3d import BlockDGSpace3D as JaxSpace3D
    from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem as ac3
    from pylrbms_tpu_torch.ops.spaces3d import BlockDGSpace3D

    pts = np.random.default_rng(0).random((7, 3))
    assert tB.num_basis_hex(order) == jB.num_basis_hex(order)
    for fn in ("hex_node_coords_unit",):
        np.testing.assert_array_equal(getattr(tB, fn)(order), getattr(jB, fn)(order))
    for fn in ("eval_basis_hex", "eval_basis_hex_grad_unit"):
        np.testing.assert_array_equal(getattr(tB, fn)(order, pts), getattr(jB, fn)(order, pts))
    for fn in ("hex_rule_unit_cell", "face3d_rule"):
        for a, b in zip(getattr(tQ, fn)(3), getattr(jQ, fn)(3)):
            np.testing.assert_array_equal(a, b)
    gj, gt = jax_ac3(cfg)["grid"], ac3(cfg)["grid"]
    assert type(gt).__module__ == "pylrbms_tpu_torch.grid3d"
    assert vars(gt) == vars(gj)
    np.testing.assert_array_equal(gt.subdomain_origins(), gj.subdomain_origins())
    for i in range(gt.num_subdomains):
        assert gt.neighborhood_of(i) == gj.neighborhood_of(i)
        assert gt.neighboring_subdomains(i) == gj.neighboring_subdomains(i)
    assert gt.boundary_subdomains() == gj.boundary_subdomains()
    with tempfile.TemporaryDirectory() as tmp:               # the JAX package's file
        with open(gt.visualize(f"{tmp}/port")) as f, open(gj.visualize(f"{tmp}/jax")) as g:
            assert f.read() == g.read()
    sj, st = JaxSpace3D(gj, order=order), BlockDGSpace3D(gt, order=order)
    assert (st.K, st.N, st.nb, st.T, st.N_rt, st.N_rt_global) == \
        (sj.K, sj.N, sj.nb, sj.T, sj.N_rt, sj.N_rt_global)
    for name in ("vol_qp", "vol_w", "vol_phi", "vol_dphi", "nodes_unit", "face_uv",
                 "subdomain_origins", "cell_origins_local"):
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name), err_msg=name)
    for fn in ("node_coords_phys", "rt_local_to_global", "hex_face_dofs"):
        np.testing.assert_array_equal(getattr(st, fn)(), getattr(sj, fn)(), err_msg=fn)
    for a, b in zip(st.rt_cell_tab(), sj.rt_cell_tab()):
        np.testing.assert_array_equal(a, b)
    for side in ("left", "right", "bottom", "top", "near", "far"):
        np.testing.assert_array_equal(st.side_dofs(side), sj.side_dofs(side))
    for fam, sets in st.interior_face_sets().items():
        for a, b in zip(sets, sj.interior_face_sets()[fam]):
            np.testing.assert_array_equal(a, b)
    assert sorted(st.face_tabs) == sorted(sj.face_tabs)
    for key, tab in st.face_tabs.items():
        ref = sj.face_tabs[key]
        for field in ("phi_m", "dphi_m", "phi_p", "dphi_p", "normal", "w",
                      "pts_unit_m", "pts_unit_p", "centroid_m", "centroid_p"):
            a, b = getattr(tab, field), getattr(ref, field)
            assert (a is None) == (b is None), (key, field)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{key}.{field}")
        assert (tab.length, tab.pen_len) == (ref.length, ref.pen_len)


@pytest.mark.parametrize("cfg", [
    {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
     "num_refinements": 1},                                    # the entry config
    {"num_subdomains": [8, 8], "half_num_fine_elements_per_subdomain_and_dim": 2,
     "num_refinements": 2},                                    # the serving config
    {"num_subdomains": [2, 1, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
     "num_refinements": 1},                                    # 3D hex, Q1
    {"num_subdomains": [3, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
     "num_refinements": 0, "order": 2},                        # 3D hex, Q2
], ids=["entry", "serving", "hex-q1", "hex-q2"])
def test_copied_grid_and_space_tables_equal_jax(cfg):
    """The port's copies of grid/basis/quadrature/ops.spaces (and of
    grid3d/ops.spaces3d on 3D configs) give the JAX package's tables:
    integer tables equal, coordinates and tabulations with zero
    difference."""
    from pylrbms_tpu.ops.spaces import BlockDGSpace as JaxSpace
    from pylrbms_tpu_torch.ops.spaces import BlockDGSpace

    if len(cfg["num_subdomains"]) == 3:
        cfg = dict(cfg)
        _hex_tables_equal_jax(cfg, cfg.pop("order", 1))
        return
    gj, gt = jax_problem(cfg)["grid"], init_grid_and_problem(cfg)["grid"]
    assert type(gt).__module__ == "pylrbms_tpu_torch.grid"
    assert vars(gt) == vars(gj)
    np.testing.assert_array_equal(gt.subdomain_cell_origins(), gj.subdomain_cell_origins())
    assert [gt.neighborhood_of(i) for i in range(gt.num_subdomains)] == \
        [gj.neighborhood_of(i) for i in range(gj.num_subdomains)]
    sj, st = JaxSpace(gj), BlockDGSpace(gt)
    assert (st.K, st.N, st.nb, st.T, st.N_rt) == (sj.K, sj.N, sj.nb, sj.T, sj.N_rt)
    for name in ("vol_qp", "vol_w", "vol_phi", "vol_dphi", "tri_centroids", "nodes_unit",
                 "face_t", "subdomain_origins", "cell_origins_local"):
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name), err_msg=name)
    np.testing.assert_array_equal(st.node_coords_phys(), sj.node_coords_phys())
    np.testing.assert_array_equal(st.rt_local_to_global(), sj.rt_local_to_global())
    for side in ("left", "right", "bottom", "top"):
        np.testing.assert_array_equal(st.side_dofs(side), sj.side_dofs(side))
    for a, b in zip(st.rt_cell_tab(), sj.rt_cell_tab()):
        np.testing.assert_array_equal(a, b)
    fam_t, fam_j = st.interior_face_sets(), sj.interior_face_sets()
    assert sorted(fam_t) == sorted(fam_j)
    for fam in fam_t:
        for a, b in zip(fam_t[fam], fam_j[fam]):
            np.testing.assert_array_equal(a, b)
    assert sorted(st.face_tabs) == sorted(sj.face_tabs)
    for key, tab in st.face_tabs.items():
        ref = sj.face_tabs[key]
        for field in ("phi_m", "dphi_m", "phi_p", "dphi_p", "normal", "w",
                      "pts_unit_m", "pts_unit_p", "centroid_m", "centroid_p"):
            a, b = getattr(tab, field), getattr(ref, field)
            assert (a is None) == (b is None), (key, field)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{key}.{field}")
        assert (tab.length, tab.pen_len, tab.tri_m, tab.tri_p) == \
            (ref.length, ref.pen_len, ref.tri_m, ref.tri_p)
