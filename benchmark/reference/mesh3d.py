"""The hexahedral mesh the SPE10 3D cells are discretized on, in plain NumPy.

The unit box is cut into ``kx x ky x kz`` box subdomains of ``s x s x s``
hexahedral cells each (``s = half * 2**nref``), so the global raster has
``nx = kx s`` by ``ny = ky s`` by ``nz = kz s`` cells of size
``hx x hy x hz``.  Each cell carries the eight trilinear (Q1) Lagrange
functions of its vertices; vertex ``j = (iz * 2 + iy) * 2 + ix`` of a cell
is its corner ``(ix, iy, iz)`` in {0, 1}^3 (x fastest).

A field is stored subdomain by subdomain, ``[K, N]`` with
``K = kx ky kz`` and ``N = 8 s^3``: the subdomain ``(sx, sy, sz)`` is row
``(sz * ky + sy) * kx + sx``, and within it the dof of vertex ``j`` of the
local cell ``(cx, cy, cz)`` is ``((cz * s + cy) * s + cx) * 8 + j``.  This
is the layout the system under test returns its answers in; everything
else here is derived from first principles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# the corners (ix, iy, iz) of the eight vertices of a cell, j = (iz*2 + iy)*2 + ix
CORNERS = np.array([[j % 2, (j // 2) % 2, j // 4] for j in range(8)])


def gauss_legendre_01(n: int):
    """Gauss-Legendre points and weights on [0, 1] (weights sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def q1(xi):
    """[..., 8] values of the Q1 functions at unit-cell points xi [..., 3]."""
    f = np.where(CORNERS == 1, xi[..., None, :], 1.0 - xi[..., None, :])   # [..., 8, 3]
    return f.prod(-1)


def q1_grad(xi):
    """[..., 8, 3] unit-cell gradients of the Q1 functions at xi [..., 3]."""
    f = np.where(CORNERS == 1, xi[..., None, :], 1.0 - xi[..., None, :])   # [..., 8, 3]
    df = np.where(CORNERS == 1, 1.0, -1.0) * np.ones_like(f)
    out = np.empty_like(f)
    for a in range(3):
        others = [b for b in range(3) if b != a]
        out[..., a] = df[..., a] * f[..., others[0]] * f[..., others[1]]
    return out


def cube_rule(n: int):
    """Tensor Gauss rule on the unit cube: points [n^3, 3], weights [n^3]
    summing to 1."""
    u, w = gauss_legendre_01(n)
    P = np.stack(np.meshgrid(u, u, u, indexing="ij"), -1).reshape(-1, 3)
    W = np.einsum("i,j,k->ijk", w, w, w).reshape(-1)
    return P, W


def face_rule(n: int, axis: int, value: float):
    """Tensor Gauss rule on the face ``xi[axis] = value`` of the unit cube:
    points [n^2, 3] (the same tangential points for every ``value``),
    weights [n^2] summing to 1."""
    u, w = gauss_legendre_01(n)
    U, V = (a.ravel() for a in np.meshgrid(u, u, indexing="ij"))
    tang = [b for b in range(3) if b != axis]
    P = np.empty((n * n, 3))
    P[:, axis] = value
    P[:, tang[0]], P[:, tang[1]] = U, V
    return P, np.outer(w, w).ravel()


@dataclass(frozen=True)
class Mesh3D:
    kx: int
    ky: int
    kz: int
    s: int

    @classmethod
    def from_config(cls, grid: dict) -> "Mesh3D":
        if grid.get("grid_type", "hex") != "hex" or len(grid["num_subdomains"]) != 3:
            raise ValueError(f"the reference mesh is the 3D hex grid, not {grid!r}")
        kx, ky, kz = grid["num_subdomains"]
        s = grid["half_num_fine_elements_per_subdomain_and_dim"] * 2 ** grid["num_refinements"]
        return cls(kx, ky, kz, s)

    @property
    def K(self) -> int:
        return self.kx * self.ky * self.kz

    @property
    def N(self) -> int:
        return 8 * self.s ** 3

    @property
    def shape(self) -> tuple:
        """(nz, ny, nx): the cell raster, z slowest."""
        return (self.kz * self.s, self.ky * self.s, self.kx * self.s)

    @property
    def h(self) -> np.ndarray:
        """(hx, hy, hz)."""
        nz, ny, nx = self.shape
        return np.array([1.0 / nx, 1.0 / ny, 1.0 / nz])

    @property
    def volume(self) -> float:
        return float(np.prod(self.h))

    @property
    def subdomain_diameter(self) -> float:
        return float(math.sqrt(((self.s * self.h) ** 2).sum()))

    def cells(self):
        """(gx, gy, gz) of every cell, each [nz * ny * nx] in raster order
        (x fastest): cell ``c`` is ``(gz * ny + gy) * nx + gx``."""
        gz, gy, gx = (a.ravel() for a in np.meshgrid(*map(np.arange, self.shape),
                                                      indexing="ij"))
        return gx, gy, gz

    def subdomain_of(self, gx, gy, gz):
        s = self.s
        return (np.asarray(gz) // s * self.ky + np.asarray(gy) // s) * self.kx + np.asarray(gx) // s

    def dofs(self, gx, gy, gz):
        """[..., 8] global dof numbers (flat index into [K * N]) of the
        cells (gx, gy, gz)."""
        s = self.s
        local = ((np.asarray(gz) % s * s + np.asarray(gy) % s) * s + np.asarray(gx) % s) * 8
        return (self.subdomain_of(gx, gy, gz) * self.N + local)[..., None] + np.arange(8)

    def vertex_ids(self, gx, gy, gz):
        """[..., 8] global vertex numbers of the cells' eight vertices, on the
        (nz+1) x (ny+1) x (nx+1) vertex lattice."""
        nz, ny, nx = self.shape
        c = CORNERS
        return (((np.asarray(gz)[..., None] + c[:, 2]) * (ny + 1)
                 + np.asarray(gy)[..., None] + c[:, 1]) * (nx + 1)
                + np.asarray(gx)[..., None] + c[:, 0])
