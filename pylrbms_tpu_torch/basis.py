"""Nodal DG bases on the structured grids: P1/P2 triangles and Q1/Q2 quads.

The port's own copy of ``pylrbms_tpu/basis.py`` (numpy only).

Replaces dune-gdt's DG space shape-function machinery
(``make_block_dg_space`` / ``make_dg_space``, SURVEY.md §2.3 "DG spaces") for
both grid families the reference supports (simplex 'alu' and cube 'yasp'
grids, ``grid.py:17-42``).  We use *nodal* Lagrange bases (values at element
nodes) — basis choice is an internal detail; all model outputs (solutions as
functions, estimator values, reduced quantities) are basis-independent.
Nodal bases make Oswald interpolation (vertex averaging), prolongation
(point evaluation) and visualization trivial array programs.

Element keys: "A"/"B" = the two triangles of a main-diagonal cell; "C"/"E" =
the two triangles of an ANTI-diagonal cell (the 'crisscross' family — the
mesh DUNE's ALU_2D_SIMPLEX_CONFORMING bisection produces from a Kuhn macro
pair after an even number of halvings, see grid.py); "Q" = the whole cell as
a single bilinear/biquadratic quad element.

Unit-cell triangle vertices (see grid.py):
  A: a0=(0,0), a1=(1,0), a2=(1,1)      (below the (0,0)-(1,1) diagonal)
  B: b0=(0,0), b1=(0,1), b2=(1,1)      (above)
  C: c0=(0,0), c1=(1,0), c2=(0,1)      (below the (1,0)-(0,1) anti-diagonal)
  E: e0=(1,0), e1=(1,1), e2=(0,1)      (above)

Barycentric coordinates (unit-cell coords xi, eta):
  A: l0 = 1-xi, l1 = xi-eta, l2 = eta
  B: l0 = 1-eta, l1 = eta-xi, l2 = xi
  C: l0 = 1-xi-eta, l1 = xi, l2 = eta
  E: l0 = 1-eta, l1 = xi+eta-1, l2 = 1-xi

Local edges (edge k connects vertex k and k+1 mod 3):
  A: e0 = bottom (a0,a1), e1 = right (a1,a2), e2 = diagonal (a2,a0)
  B: e0 = left (b0,b1), e1 = top (b1,b2), e2 = diagonal (b2,b0)
  C: e0 = bottom (c0,c1), e1 = anti-diagonal (c1,c2), e2 = left (c2,c0)
  E: e0 = right (e0,e1), e1 = top (e1,e2), e2 = anti-diagonal (e2,e0)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

TRI_VERTS_UNIT = {
    "A": np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]),
    "B": np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
    "C": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "E": np.array([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
}

# unit-cell gradients of the barycentric coordinates: [3, 2]
TRI_BARY_GRAD_UNIT = {
    "A": np.array([[-1.0, 0.0], [1.0, -1.0], [0.0, 1.0]]),
    "B": np.array([[0.0, -1.0], [-1.0, 1.0], [1.0, 0.0]]),
    "C": np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]),
    "E": np.array([[0.0, -1.0], [1.0, 1.0], [-1.0, 0.0]]),
}


def barycentric(tri: str, pts: np.ndarray) -> np.ndarray:
    """pts [..., 2] unit-cell coords -> [..., 3] barycentric coords."""
    xi, eta = pts[..., 0], pts[..., 1]
    if tri == "A":
        return np.stack([1 - xi, xi - eta, eta], axis=-1)
    if tri == "B":
        return np.stack([1 - eta, eta - xi, xi], axis=-1)
    if tri == "C":
        return np.stack([1 - xi - eta, xi, eta], axis=-1)
    if tri == "E":
        return np.stack([1 - eta, xi + eta - 1, 1 - xi], axis=-1)
    raise ValueError(tri)


def num_basis(order: int, elem: str = "A") -> int:
    if elem == "Q":
        return {1: 4, 2: 9}[order]
    return {1: 3, 2: 6}[order]


# Q1/Q2 node 1d coordinates per order (tensor-product Lagrange)
_Q_NODES_1D = {1: np.array([0.0, 1.0]), 2: np.array([0.0, 0.5, 1.0])}


def _lagrange_1d(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """1d Lagrange basis values at x: [..., len(nodes)]."""
    x = np.asarray(x)
    nn = len(nodes)
    out = np.ones(x.shape + (nn,))
    for j in range(nn):
        for m in range(nn):
            if m != j:
                out[..., j] *= (x - nodes[m]) / (nodes[j] - nodes[m])
    return out


def _lagrange_1d_deriv(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    nn = len(nodes)
    out = np.zeros(x.shape + (nn,))
    for j in range(nn):
        for k in range(nn):
            if k == j:
                continue
            term = np.ones_like(x) / (nodes[j] - nodes[k])
            for m in range(nn):
                if m != j and m != k:
                    term *= (x - nodes[m]) / (nodes[j] - nodes[m])
            out[..., j] += term
    return out


def node_coords_unit(tri: str, order: int) -> np.ndarray:
    """Nodal points in unit-cell coords: [nb, 2].

    P1: the 3 vertices.  P2: vertices + edge midpoints (node 3+k on edge k).
    Q1/Q2: tensor Lagrange nodes, x fastest (node j = iy*n1d + ix).
    """
    if tri == "Q":
        n1 = _Q_NODES_1D[order]
        X, Y = np.meshgrid(n1, n1, indexing="xy")   # [iy, ix]
        return np.stack([X.ravel(), Y.ravel()], axis=-1)
    v = TRI_VERTS_UNIT[tri]
    if order == 1:
        return v.copy()
    if order == 2:
        mids = np.array([(v[0] + v[1]) / 2, (v[1] + v[2]) / 2, (v[2] + v[0]) / 2])
        return np.concatenate([v, mids], axis=0)
    raise ValueError(order)


def eval_basis(tri: str, order: int, pts: np.ndarray) -> np.ndarray:
    """Nodal basis values at unit-cell points: [..., nb]."""
    if tri == "Q":
        n1 = _Q_NODES_1D[order]
        lx = _lagrange_1d(n1, pts[..., 0])          # [..., n1d]
        ly = _lagrange_1d(n1, pts[..., 1])
        return (ly[..., :, None] * lx[..., None, :]).reshape(pts.shape[:-1] + (-1,))
    lam = barycentric(tri, pts)
    if order == 1:
        return lam
    if order == 2:
        l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
        return np.stack([
            l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
            4 * l0 * l1, 4 * l1 * l2, 4 * l2 * l0,
        ], axis=-1)
    raise ValueError(order)


def eval_basis_grad_unit(tri: str, order: int, pts: np.ndarray) -> np.ndarray:
    """Unit-cell gradients of the nodal basis at points: [..., nb, 2].

    Physical gradients are obtained by dividing component-wise by (hx, hy).
    """
    if tri == "Q":
        n1 = _Q_NODES_1D[order]
        lx = _lagrange_1d(n1, pts[..., 0])
        ly = _lagrange_1d(n1, pts[..., 1])
        dlx = _lagrange_1d_deriv(n1, pts[..., 0])
        dly = _lagrange_1d_deriv(n1, pts[..., 1])
        nb = len(n1) ** 2
        gx = (ly[..., :, None] * dlx[..., None, :]).reshape(pts.shape[:-1] + (nb,))
        gy = (dly[..., :, None] * lx[..., None, :]).reshape(pts.shape[:-1] + (nb,))
        return np.stack([gx, gy], axis=-1)
    g = TRI_BARY_GRAD_UNIT[tri]          # [3, 2]
    lam = barycentric(tri, pts)          # [..., 3]
    if order == 1:
        return np.broadcast_to(g, pts.shape[:-1] + (3, 2)).copy()
    if order == 2:
        l = lam[..., :, None]            # [..., 3, 1]
        dvert = (4 * l - 1) * g          # [..., 3, 2]
        d01 = 4 * (lam[..., 0, None] * g[1] + lam[..., 1, None] * g[0])
        d12 = 4 * (lam[..., 1, None] * g[2] + lam[..., 2, None] * g[1])
        d20 = 4 * (lam[..., 2, None] * g[0] + lam[..., 0, None] * g[2])
        dmid = np.stack([d01, d12, d20], axis=-2)   # [..., 3, 2]
        return np.concatenate([dvert, dmid], axis=-2)
    raise ValueError(order)


@dataclass(frozen=True)
class EdgeGeom:
    """Unit-cell parametrization of a face family edge: x(t) = start + t*dir."""
    start: Tuple[float, float]
    direction: Tuple[float, float]

    def points(self, t: np.ndarray) -> np.ndarray:
        s = np.asarray(self.start)
        d = np.asarray(self.direction)
        return s[None, :] + t[:, None] * d[None, :]


# unit-cell edge parametrizations used by the face families (grid.py docstring)
EDGES_UNIT = {
    # face family: (minus-side (tri, edge geom), plus-side (tri, edge geom))
    # D: the in-cell diagonal, minus = A, plus = B, both parametrized (t, t)
    "D": (("A", EdgeGeom((0.0, 0.0), (1.0, 1.0))),
          ("B", EdgeGeom((0.0, 0.0), (1.0, 1.0)))),
    # V: between cell (cx,.) right edge (A) and cell (cx+1,.) left edge (B)
    "V": (("A", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
          ("B", EdgeGeom((0.0, 0.0), (0.0, 1.0)))),
    # H: between cell (.,cy) top edge (B) and cell (.,cy+1) bottom edge (A)
    "H": (("B", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
          ("A", EdgeGeom((0.0, 0.0), (1.0, 0.0)))),
}

# boundary edges: (tri, edge geom, outward normal sign convention handled in assembly)
BOUNDARY_EDGES_UNIT = {
    "left":   ("B", EdgeGeom((0.0, 0.0), (0.0, 1.0))),
    "right":  ("A", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
    "bottom": ("A", EdgeGeom((0.0, 0.0), (1.0, 0.0))),
    "top":    ("B", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
}

# local edge index (0,1,2) of each face family side within its triangle,
# needed for RT0 dof bookkeeping (edge k connects vertex k, k+1 mod 3)
FACE_LOCAL_EDGE = {
    "D": (2, 2),       # diagonal is edge 2 for both A and B
    "V": (1, 0),       # minus: A right = e1; plus: B left = e0
    "H": (1, 0),       # minus: B top = e1; plus: A bottom = e0
}
BOUNDARY_LOCAL_EDGE = {"left": 0, "right": 1, "bottom": 0, "top": 1}

# quad ('yasp'/cube) grid: one "Q" element per cell, face families V/H only
QUAD_EDGES_UNIT = {
    # V: between cell (cx,.) right edge and cell (cx+1,.) left edge
    "V": (("Q", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
          ("Q", EdgeGeom((0.0, 0.0), (0.0, 1.0)))),
    # H: between cell (.,cy) top edge and cell (.,cy+1) bottom edge
    "H": (("Q", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
          ("Q", EdgeGeom((0.0, 0.0), (1.0, 0.0)))),
}
QUAD_BOUNDARY_EDGES_UNIT = {
    "left":   ("Q", EdgeGeom((0.0, 0.0), (0.0, 1.0))),
    "right":  ("Q", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
    "bottom": ("Q", EdgeGeom((0.0, 0.0), (1.0, 0.0))),
    "top":    ("Q", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
}

# ---------------------------------------------------------------------------
# 'crisscross' grid (the ALU-conform even-bisection family, grid.py):
# cell parity p = (gx + gy) % 2; p=0 cells carry the main diagonal (A/B),
# p=1 cells the anti-diagonal (C/E).  Interior face families are split by
# the parity of the MINUS cell: "V0" couples an even cell's right edge (A)
# to the odd right-neighbor's left edge (C), "V1" couples E to B, etc.
CC_EDGES_UNIT = {
    # in-cell diagonal of even cells: identical to the uniform-tri "D" family
    "D0": (("A", EdgeGeom((0.0, 0.0), (1.0, 1.0))),
           ("B", EdgeGeom((0.0, 0.0), (1.0, 1.0)))),
    # in-cell ANTI-diagonal of odd cells; minus = C (contains (0,0))
    "D1": (("C", EdgeGeom((1.0, 0.0), (-1.0, 1.0))),
           ("E", EdgeGeom((1.0, 0.0), (-1.0, 1.0)))),
    # V: even minus cell right edge (A e1) <-> odd plus cell left edge (C e2)
    "V0": (("A", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
           ("C", EdgeGeom((0.0, 0.0), (0.0, 1.0)))),
    # V: odd minus cell right edge (E e0) <-> even plus cell left edge (B e0)
    "V1": (("E", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
           ("B", EdgeGeom((0.0, 0.0), (0.0, 1.0)))),
    # H: even minus cell top edge (B e1) <-> odd plus cell bottom edge (C e0)
    "H0": (("B", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
           ("C", EdgeGeom((0.0, 0.0), (1.0, 0.0)))),
    # H: odd minus cell top edge (E e1) <-> even plus cell bottom edge (A e0)
    "H1": (("E", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
           ("A", EdgeGeom((0.0, 0.0), (1.0, 0.0)))),
}

# boundary side -> per-parity (tri, edge geom); key suffix = cell parity
CC_BOUNDARY_EDGES_UNIT = {
    "left":   (("B", EdgeGeom((0.0, 0.0), (0.0, 1.0))),
               ("C", EdgeGeom((0.0, 0.0), (0.0, 1.0)))),
    "right":  (("A", EdgeGeom((1.0, 0.0), (0.0, 1.0))),
               ("E", EdgeGeom((1.0, 0.0), (0.0, 1.0)))),
    "bottom": (("A", EdgeGeom((0.0, 0.0), (1.0, 0.0))),
               ("C", EdgeGeom((0.0, 0.0), (1.0, 0.0)))),
    "top":    (("B", EdgeGeom((0.0, 1.0), (1.0, 0.0))),
               ("E", EdgeGeom((0.0, 1.0), (1.0, 0.0)))),
}

# local edge index of each crisscross face family side (RT0 bookkeeping)
CC_FACE_LOCAL_EDGE = {
    "D0": (2, 2),      # diagonal: A e2 / B e2
    "D1": (1, 2),      # anti-diagonal: C e1 / E e2
    "V0": (1, 2),      # minus A right = e1; plus C left = e2
    "V1": (0, 0),      # minus E right = e0; plus B left = e0
    "H0": (1, 0),      # minus B top = e1; plus C bottom = e0
    "H1": (1, 0),      # minus E top = e1; plus A bottom = e0
}
CC_BOUNDARY_LOCAL_EDGE = {
    "left": (0, 2), "right": (1, 0), "bottom": (0, 0), "top": (1, 1),
}


# ---------------------------------------------------------------------------
# 3D hex (tensor-Lagrange Q_k) basis — the 'hex' grid family
# ---------------------------------------------------------------------------
# Node ordering: j = (iz*n1d + iy)*n1d + ix (x fastest), mirroring the 2D "Q"
# convention j = iy*n1d + ix.  Unit-cell coords in [0,1]^3; physical gradients
# are obtained by dividing component-wise by (hx, hy, hz).

def num_basis_hex(order: int) -> int:
    return (order + 1) ** 3


def hex_node_coords_unit(order: int) -> np.ndarray:
    """Tensor Lagrange nodes of the unit hex: [nb, 3]."""
    n1 = _Q_NODES_1D[order]
    Z, Y, X = np.meshgrid(n1, n1, n1, indexing="ij")   # [iz, iy, ix]
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def eval_basis_hex(order: int, pts: np.ndarray) -> np.ndarray:
    """Nodal basis values at unit-cell points [..., 3] -> [..., nb]."""
    n1 = _Q_NODES_1D[order]
    lx = _lagrange_1d(n1, pts[..., 0])                 # [..., n1d]
    ly = _lagrange_1d(n1, pts[..., 1])
    lz = _lagrange_1d(n1, pts[..., 2])
    prod = (lz[..., :, None, None] * ly[..., None, :, None]
            * lx[..., None, None, :])
    return prod.reshape(pts.shape[:-1] + (-1,))


def eval_basis_hex_grad_unit(order: int, pts: np.ndarray) -> np.ndarray:
    """Unit-cell gradients at points [..., 3] -> [..., nb, 3]."""
    n1 = _Q_NODES_1D[order]
    nb = len(n1) ** 3
    lx = _lagrange_1d(n1, pts[..., 0])
    ly = _lagrange_1d(n1, pts[..., 1])
    lz = _lagrange_1d(n1, pts[..., 2])
    dlx = _lagrange_1d_deriv(n1, pts[..., 0])
    dly = _lagrange_1d_deriv(n1, pts[..., 1])
    dlz = _lagrange_1d_deriv(n1, pts[..., 2])

    def tp(a, b, c):
        return (a[..., :, None, None] * b[..., None, :, None]
                * c[..., None, None, :]).reshape(pts.shape[:-1] + (nb,))

    return np.stack([tp(lz, ly, dlx), tp(lz, dly, lx), tp(dlz, ly, lx)],
                    axis=-1)
