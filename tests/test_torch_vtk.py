"""Port VTU writer (pylrbms_tpu_torch/utils/vtk.py) and the entry points
that use it (``Grid.visualize``, ``Grid3D.visualize``,
``StationaryBlockModel.visualize``) against the JAX package: for the same
numpy values the files are the same text, character for character, on
the tri, quad and crisscross families (P1/P2, Q1/Q2) and the hex family
(Q1/Q2); a solution given as a tensor writes the file its numpy values
write; the written values and counts parse back exactly.
"""
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu.utils import vtk as jax_vtk  # noqa: E402
from pylrbms_tpu.grid import make_grid as jax_make_grid  # noqa: E402
from pylrbms_tpu.grid3d import make_grid3d as jax_make_grid3d  # noqa: E402
from pylrbms_tpu.ops.spaces import BlockDGSpace as JaxSpace  # noqa: E402
from pylrbms_tpu.ops.spaces3d import BlockDGSpace3D as JaxSpace3D  # noqa: E402

from pylrbms_tpu_torch.utils import vtk  # noqa: E402
from pylrbms_tpu_torch.grid import make_grid  # noqa: E402
from pylrbms_tpu_torch.grid3d import make_grid3d  # noqa: E402
from pylrbms_tpu_torch.ops.spaces import BlockDGSpace  # noqa: E402
from pylrbms_tpu_torch.ops.spaces3d import BlockDGSpace3D  # noqa: E402

GRID3D = dict(num_subdomains=[2, 1, 1], half_num_fine_elements_per_subdomain_and_dim=1,
              num_refinements=1)


def text(path):
    with open(path) as f:
        return f.read()


def point_values(path):
    root = ET.parse(path).getroot()
    return np.array(root.find(".//PointData/DataArray").text.split(), dtype=np.float64)


@pytest.mark.parametrize("grid_type", ["tri", "quad", "crisscross"])
@pytest.mark.parametrize("order", [1, 2])
def test_write_dg_vtu_equals_jax(tmp_path, grid_type, order):
    args = (((0, 0), (1, 1)), [2, 2], 1)
    sp = BlockDGSpace(make_grid(*args, num_refinements=1, grid_type=grid_type), order=order)
    spj = JaxSpace(jax_make_grid(*args, num_refinements=1, grid_type=grid_type), order=order)
    U = np.random.default_rng(order).normal(size=(sp.K, sp.N))
    f = vtk.write_dg_vtu(sp, torch.as_tensor(U), str(tmp_path / "port"))
    assert f.endswith(".vtu")
    assert text(f) == text(jax_vtk.write_dg_vtu(spj, U, str(tmp_path / "jax")))
    np.testing.assert_array_equal(point_values(f), U.reshape(-1))


@pytest.mark.parametrize("order", [1, 2])
def test_write_hex_vtu_equals_jax(tmp_path, order):
    sp = BlockDGSpace3D(make_grid3d(**GRID3D), order=order)
    spj = JaxSpace3D(jax_make_grid3d(**GRID3D), order=order)
    U = np.random.default_rng(order).random((sp.K, sp.N))
    f = vtk.write_hex_vtu(sp, U, str(tmp_path / "port"))
    assert text(f) == text(jax_vtk.write_hex_vtu(spj, U, str(tmp_path / "jax")))
    t = text(f)
    n_cells = sp.K * sp.s ** 3 * order ** 3
    assert re.search(r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', t).groups() == \
        (str(sp.K * sp.N), str(n_cells))
    np.testing.assert_array_equal(point_values(f), U.reshape(-1))


def test_grid_visualize_equals_jax(tmp_path):
    """Grid.visualize and Grid3D.visualize (which raised before the writer
    was ported) write JAX's subdomain-id files."""
    args = (((0, 0), (1, 1)), [2, 2], 1)
    f = make_grid(*args, num_refinements=0).visualize(str(tmp_path / "g2"))
    assert text(f) == text(jax_vtk.write_grid_vtu(jax_make_grid(*args, num_refinements=0),
                                                  str(tmp_path / "g2j")))
    f3 = make_grid3d(**GRID3D).visualize(str(tmp_path / "g3"))
    assert text(f3) == text(jax_make_grid3d(**GRID3D).visualize(str(tmp_path / "g3j")))
    assert sorted(set(point_values(f3))) == [0.0, 1.0]


@pytest.mark.parametrize("dim", [2, 3])
def test_model_visualize(tmp_path, dim):
    """The model's visualize writes the solution with its space's writer
    (JAX's file for the same values); the values parse back."""
    if dim == 2:
        from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_problem
        from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
        cfg = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
               "num_refinements": 0}
        mu, jax_write, JS = 1.0, jax_vtk.write_dg_vtu, JaxSpace
    else:
        from pylrbms_tpu.problems.academic3d import init_grid_and_problem as jax_problem
        from pylrbms_tpu_torch.problems.academic3d import init_grid_and_problem
        from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize
        cfg = dict(GRID3D)
        mu, jax_write, JS = 0.5, jax_vtk.write_hex_vtu, JaxSpace3D
    d, _ = discretize(init_grid_and_problem(cfg), device="cpu")
    U = d.solve(mu)
    f = d.visualize(U, str(tmp_path / "sol"))
    Un = U.numpy()
    spj = JS(jax_problem(cfg)["grid"], order=1)
    assert text(f) == text(jax_write(spj, Un, str(tmp_path / "solj")))
    vals = point_values(f)
    np.testing.assert_array_equal(vals, Un.reshape(-1))
    assert vals.max() > 0
