"""VTU output for DG functions on the structured grids (tri, quad, hex).

The port of ``pylrbms_tpu/utils/vtk.py``: the same files, character for
character, for the same values.  DG functions are written with duplicated
points (one point per element corner), so discontinuities are kept.
Solutions may be given as numpy arrays or as tensors on any device (they
are copied to the host).
"""
from __future__ import annotations

import numpy as np
import torch


def _host(U) -> np.ndarray:
    if isinstance(U, torch.Tensor):
        return U.detach().cpu().numpy().reshape(-1)
    return np.asarray(U).reshape(-1)


def _vtu_header(n_points, n_cells):
    return (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n'
        '<UnstructuredGrid>\n'
        f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">\n'
    )


def _write(filename, points, conn, n_cells, nv, vtk_type, vals, name):
    """One ASCII VTU: ``points`` one "x y z" line each, cells of nv
    corners each."""
    with open(filename, "w") as f:
        f.write(_vtu_header(len(points), n_cells))
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        for line in points:
            f.write(line + "\n")
        f.write('</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        f.write(" ".join(str(i) for i in conn))
        f.write('\n</DataArray>\n<DataArray type="Int32" Name="offsets" format="ascii">\n')
        f.write(" ".join(str(nv * (i + 1)) for i in range(n_cells)))
        f.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(" ".join(str(vtk_type) for _ in range(n_cells)))
        f.write('\n</DataArray>\n</Cells>\n')
        f.write(f'<PointData Scalars="{name}">'
                f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
        f.write(" ".join(f"{v}" for v in vals))
        f.write('\n</DataArray></PointData>\n')
        f.write('</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')
    return filename


def write_dg_vtu(space, U, filename: str, name: str = "u"):
    """U [K, N] nodal DG coefficients -> filename.vtu (2D).

    Order 1 writes one linear cell per element; order 2 subdivides each
    element at its midpoint nodes (4 linear sub-cells per P2 triangle / Q2
    quad, exact at every nodal point)."""
    if not filename.endswith(".vtu"):
        filename += ".vtu"
    if space.order not in (1, 2):
        raise ValueError("the VTU writer supports P1/P2/Q1/Q2 output")
    xn = space.node_coords_phys().reshape(-1, 2)
    nb = space.nb
    if nb == 3:
        vtk_type, subcells = 5, ((0, 1, 2),)            # VTK_TRIANGLE
    elif nb == 4:
        vtk_type, subcells = 9, ((0, 1, 3, 2),)         # VTK_QUAD (ccw)
    elif nb == 6:                                       # P2 tri: v0 v1 v2 +
        vtk_type, subcells = 5, ((0, 3, 5), (3, 1, 4),  # midpoints m01 m12 m20
                                 (5, 4, 2), (3, 4, 5))
    else:                                               # Q2: 3x3, x fastest
        vtk_type, subcells = 9, ((0, 1, 4, 3), (1, 2, 5, 4),
                                 (3, 4, 7, 6), (4, 5, 8, 7))
    sub = np.asarray(subcells)                          # [nsub, nv]
    n_elems = xn.shape[0] // nb
    conn = (np.arange(n_elems)[:, None, None] * nb + sub[None, :, :]).reshape(-1)
    return _write(filename, [f"{x} {y} 0" for x, y in xn], conn, n_elems * sub.shape[0],
                  sub.shape[1], vtk_type, _host(U), name)


def write_grid_vtu(grid, filename: str):
    """Subdomain-id field on the 2D grid (<-> ``Grid.visualize``)."""
    from ..ops.spaces import BlockDGSpace
    space = BlockDGSpace(grid, order=1)
    ids = np.repeat(np.arange(grid.num_subdomains, dtype=float)[:, None], space.N, axis=1)
    return write_dg_vtu(space, ids, filename, name="subdomain")


def write_hex_vtu(space, U, filename: str, name: str = "u"):
    """3D hex family: U [K, N] Q1/Q2 nodal coefficients -> filename.vtu
    (duplicated points keep the DG jumps).  Q1 writes one VTK_HEXAHEDRON
    per cell; Q2 subdivides each hex into 8 sub-hexes whose corners are
    the half-lattice Q2 nodes (exact: the nodal values, no
    re-interpolation).  VTK's hex corner order is the bottom quad ccw
    (z=0), then the top quad ccw (z=1); the space's is
    j = (iz*n1 + iy)*n1 + ix with n1 = order + 1."""
    if not filename.endswith(".vtu"):
        filename += ".vtu"
    if getattr(space, "dim", 2) != 3 or space.order not in (1, 2):
        raise ValueError("write_hex_vtu takes a Q1/Q2 hex space")
    xn = space.node_coords_phys().reshape(-1, 3)
    nb, p = space.nb, space.order
    n1 = p + 1
    corn = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
    sub = np.array([[((oz + dz) * n1 + (oy + dy)) * n1 + (ox + dx)
                     for dx, dy, dz in corn]
                    for oz in range(p) for oy in range(p) for ox in range(p)])
    n_elems = xn.shape[0] // nb
    conn = (np.arange(n_elems)[:, None, None] * nb + sub[None]).reshape(-1)
    return _write(filename, [f"{x} {y} {z}" for x, y, z in xn], conn, n_elems * p ** 3, 8,
                  12, _host(U), name)
