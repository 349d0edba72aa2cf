"""Quadrature rules (numpy, tabulated once at discretize time).

The port's own copy of ``pylrbms_tpu/quadrature.py``.

Replaces the quadrature machinery inside dune-gdt's C++ grid walks
(SURVEY.md §2.3 "Grid walkers / assemblers").  All cells are congruent, so a
single reference rule per element family suffices; physical points are
origin + scaled reference points.

Triangle rules use the Duffy transform from the unit square onto the
unit-cell triangle A = {(0,0),(1,0),(1,1)}:  (u,v) -> (u, u*v), |J| = u.
Triangle B = {(0,0),(0,1),(1,1)} is the mirror (x,y) -> (y,x).
"""
from __future__ import annotations

import numpy as np


def gauss_legendre_01(n: int):
    """Gauss-Legendre rule on [0,1]: points [n], weights [n] (sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def triangle_rule_unit_cell(tri: str, n: int = 5):
    """Quadrature on triangle A or B in unit-cell coordinates.

    Returns points [nq, 2] and weights [nq] summing to the *unit-cell* triangle
    area 1/2.  Physical integral over a cell triangle = sum(w * f(x)) * (hx*hy)
    (the affine map (xi,eta)->(hx*xi, hy*eta) has Jacobian hx*hy).
    """
    u, wu = gauss_legendre_01(n)
    v, wv = gauss_legendre_01(n)
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    xi = U.ravel()
    eta = (U * V).ravel()
    w = (WU * WV * U).ravel()          # Duffy Jacobian u; sums to 1/2
    if tri == "A":
        pts = np.stack([xi, eta], axis=-1)
    elif tri == "B":
        pts = np.stack([eta, xi], axis=-1)  # mirror across the diagonal
    elif tri == "C":
        pts = np.stack([1.0 - xi, eta], axis=-1)   # mirror A at x = 1/2
    elif tri == "E":
        pts = np.stack([1.0 - eta, xi], axis=-1)   # mirror B at x = 1/2
    else:
        raise ValueError(tri)
    return pts, w


def quad_rule_unit_cell(n: int = 5):
    """Tensor Gauss-Legendre rule on the unit cell [0,1]^2 (for 'quad' grids).

    Returns points [n*n, 2] and weights [n*n] summing to 1 (the unit-cell
    area); physical integral = sum(w * f(x)) * (hx*hy)."""
    u, wu = gauss_legendre_01(n)
    v, wv = gauss_legendre_01(n)
    U, V = np.meshgrid(u, v, indexing="ij")
    WU, WV = np.meshgrid(wu, wv, indexing="ij")
    pts = np.stack([U.ravel(), V.ravel()], axis=-1)
    return pts, (WU * WV).ravel()


def edge_rule(n: int = 5):
    """Rule on the unit interval [0,1] for faces (points [n], weights sum 1)."""
    return gauss_legendre_01(n)


def hex_rule_unit_cell(n: int = 3):
    """Tensor Gauss-Legendre rule on the unit cell [0,1]^3 (for 'hex' grids).

    Returns points [n^3, 3] and weights [n^3] summing to 1; physical
    integral = sum(w * f(x)) * (hx*hy*hz)."""
    u, wu = gauss_legendre_01(n)
    U, V, W = np.meshgrid(u, u, u, indexing="ij")
    WU, WV, WW = np.meshgrid(wu, wu, wu, indexing="ij")
    pts = np.stack([U.ravel(), V.ravel(), W.ravel()], axis=-1)
    return pts, (WU * WV * WW).ravel()


def face3d_rule(n: int = 3):
    """Tensor rule on the unit square [0,1]^2 for the faces of 'hex' cells.

    Returns points [n*n, 2] and weights [n*n] summing to 1 (physical face
    integral = sum(w * f(x)) * face_area)."""
    u, wu = gauss_legendre_01(n)
    U, V = np.meshgrid(u, u, indexing="ij")
    WU, WV = np.meshgrid(wu, wu, indexing="ij")
    return np.stack([U.ravel(), V.ravel()], axis=-1), (WU * WV).ravel()
