"""The triangulation the OS2015 cells are discretized on, in plain NumPy.

The domain is cut into ``kx x ky`` rectangular subdomains of ``s x s``
square cells each (``s = half * 2**nref``).  Every cell is split along its
main diagonal into two triangles:

* ``t = 0``: vertices (0, 0), (1, 0), (1, 1) of the unit cell (below);
* ``t = 1``: vertices (0, 0), (0, 1), (1, 1) (above).

P1 dofs are the values at those three vertices, in that order.  A field is
stored subdomain by subdomain, ``[K, N]`` with ``K = kx * ky`` and
``N = 6 s^2``; the subdomain ``(sx, sy)`` is row ``sy * kx + sx``, and within
it the dof of vertex ``i`` of triangle ``t`` of local cell ``(cx, cy)`` is
``((cy * s + cx) * 2 + t) * 3 + i``.  This is the layout the system under
test returns its answers in; everything else here is derived from first
principles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# unit-cell vertices of the two triangles of a cell
TRI_VERTS = np.array([[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]],
                      [[0.0, 0.0], [0.0, 1.0], [1.0, 1.0]]])


def gauss_legendre_01(n: int):
    """Gauss-Legendre points and weights on [0, 1] (weights sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def triangle_rule(n: int):
    """Collapsed (Duffy) Gauss rule on the reference triangle
    {(a, b): 0 <= b <= a <= 1}: barycentric coordinates [n*n, 3] of the
    points and weights [n*n] summing to 1 (integral = area * sum(w f))."""
    u, wu = gauss_legendre_01(n)
    a = np.repeat(u, n)
    b = a * np.tile(u, n)
    w = 2.0 * np.repeat(wu, n) * np.tile(wu, n) * a
    # (a, b) in the triangle (0,0), (1,0), (1,1): x = a, y = b
    bary = np.stack([1.0 - a, a - b, b], axis=-1)
    return bary, w


@dataclass(frozen=True)
class Mesh:
    kx: int
    ky: int
    s: int
    lower_left: tuple = (-1.0, -1.0)
    upper_right: tuple = (1.0, 1.0)

    @classmethod
    def from_config(cls, grid: dict, domain) -> "Mesh":
        if grid.get("grid_type", "tri") != "tri":
            raise ValueError(f"the reference mesh is the diagonal split, not {grid['grid_type']!r}")
        kx, ky = grid["num_subdomains"]
        s = grid["half_num_fine_elements_per_subdomain_and_dim"] * 2 ** grid["num_refinements"]
        return cls(kx, ky, s, tuple(domain[0]), tuple(domain[1]))

    @property
    def K(self) -> int:
        return self.kx * self.ky

    @property
    def N(self) -> int:
        return 6 * self.s * self.s

    @property
    def nx(self) -> int:
        return self.kx * self.s

    @property
    def ny(self) -> int:
        return self.ky * self.s

    @property
    def hx(self) -> float:
        return (self.upper_right[0] - self.lower_left[0]) / self.nx

    @property
    def hy(self) -> float:
        return (self.upper_right[1] - self.lower_left[1]) / self.ny

    @property
    def area(self) -> float:
        """Area of one triangle."""
        return 0.5 * self.hx * self.hy

    @property
    def subdomain_diameter(self) -> float:
        return math.hypot(self.s * self.hx, self.s * self.hy)

    def dofs(self, gx, gy, t):
        """[..., 3] global dof numbers (flat index into [K * N]) of the
        triangles ``t`` of the cells ``(gx, gy)`` (broadcast)."""
        gx, gy, t = np.broadcast_arrays(np.asarray(gx), np.asarray(gy), np.asarray(t))
        s = self.s
        ii = (gy // s) * self.kx + gx // s
        local = (((gy % s) * s + gx % s) * 2 + t) * 3
        return (ii * self.N + local)[..., None] + np.arange(3)

    def cells(self):
        """(gx, gy) of every cell, each [ny, nx]."""
        gy, gx = np.meshgrid(np.arange(self.ny), np.arange(self.nx), indexing="ij")
        return gx, gy

    def vertices(self, gx, gy, t):
        """[..., 3, 2] physical vertex coordinates of triangles (gx, gy, t)."""
        gx, gy, t = np.broadcast_arrays(np.asarray(gx), np.asarray(gy), np.asarray(t))
        org = np.stack([self.lower_left[0] + gx * self.hx,
                        self.lower_left[1] + gy * self.hy], -1)
        return org[..., None, :] + TRI_VERTS[t] * np.array([self.hx, self.hy])

    def subdomain_of(self, gx, gy):
        return (np.asarray(gy) // self.s) * self.kx + np.asarray(gx) // self.s


def p1_gradients(verts):
    """[..., 3, 2] gradients of the three barycentric coordinates of the
    triangles with vertices ``verts`` [..., 3, 2]."""
    e1 = verts[..., 1, :] - verts[..., 0, :]
    e2 = verts[..., 2, :] - verts[..., 0, :]
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    # rows of the inverse Jacobian give the gradients of lambda_1, lambda_2
    g1 = np.stack([e2[..., 1], -e2[..., 0]], -1) / det[..., None]
    g2 = np.stack([-e1[..., 1], e1[..., 0]], -1) / det[..., None]
    return np.stack([-g1 - g2, g1, g2], axis=-2)


def barycentric(verts, x):
    """[..., q, 3] barycentric coordinates of points x [..., q, 2] in the
    triangles ``verts`` [..., 3, 2]."""
    grads = p1_gradients(verts)                                  # [..., 3, 2]
    d = x - verts[..., None, 0, :]                               # [..., q, 2]
    l12 = np.einsum("...qa,...ia->...qi", d, grads[..., 1:, :])
    return np.concatenate([1.0 - l12.sum(-1, keepdims=True), l12], axis=-1)
