"""The plain reference: independent of the program, exact where the
problem is, and the same discrete problem as the program's at small sizes
(float64 on the CPU)."""
import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import os2015
from benchmark.reference.mesh import Mesh
from benchmark.reference.solve import exact


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("pylrbms") or n.split(".")[0] in
                           ("jax", "benchmark") for n in names), (path.name, names)
    code = ("import sys, json; import benchmark.reference.os2015, benchmark.reference.solve; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert not {"pylrbms_tpu", "pylrbms_tpu_torch", "jax"} & set(json.loads(out))


def test_exact_solution_at_mu_one_converges():
    """At mu = 1 the diffusion is 1 and u = cos(pi x/2) cos(pi y/2): the
    nodal error of the discrete solution falls about fourfold a halving."""
    errs = []
    for s in (2, 4, 8):
        prob = os2015.Os2015(Mesh(2, 2, s))
        u = exact(prob, 1.0)
        x = prob.verts.reshape(-1, 2)
        errs.append(np.abs(u[prob.dofs.reshape(-1)] - os2015.c_fn(x)).max())
    assert errs[0] / errs[1] > 3.0 and errs[1] / errs[2] > 3.0


@pytest.mark.parametrize("mu", [0.1, 0.55, 1.0])
def test_reference_is_the_programs_discrete_problem(mu):
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.la.block import to_scipy_csr
    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    torch.set_num_threads(2)
    grid = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
            "num_refinements": 2}
    d, _ = discretize(init_grid_and_problem(grid), device="cpu", dtype=torch.float64)
    prob = os2015.Os2015(Mesh.from_config(grid, [[-1, -1], [1, 1]]))
    m = {"diffusion": torch.tensor([mu], dtype=torch.float64)}
    A, Ar = to_scipy_csr(d.assemble(m)), prob.matrix(mu)
    # the program evaluates lambda 1e-6 of the way into each face's element
    assert abs(A - Ar).max() <= 1e-7 * abs(Ar).max()
    assert np.abs(d.rhs(m).numpy().reshape(-1) - prob.b).max() <= 1e-9 * np.abs(prob.b).max()
    u = exact(prob, mu)
    U = torch.tensor(u.reshape(d.space.K, d.space.N))
    nc, r, df = d.estimator.local_quantities_positive(
        U[None], {"diffusion": torch.tensor([[mu]], dtype=torch.float64)})
    ind, ref = (nc + r + df)[0].numpy(), prob.indicators(u, mu)
    assert np.abs(ind - ref).max() <= 1e-6 * ref.max()
