"""3D block DG space (trilinear Q1 hexes) + RT0 hex layout: static tables.

The port's own copy of ``pylrbms_tpu/ops/spaces3d.py`` (numpy only).

Extends the 2D ``ops/spaces.py`` design (static tabulations, index maps, no
mappers/walkers — SURVEY.md §7) to the 3D 'hex' grid family (``grid3d.py``),
which goes BEYOND the 2D-only reference (its dune-gdt bindings are
instantiated for 2D grids only; SPE10 model 2 is natively 3D).

Layouts
-------
DG dof vector per subdomain: ``[N]`` with ``N = s^3 * nb`` and
``index(cz, cy, cx, i) = ((cz*s + cy)*s + cx)*nb + i`` (one Q_order element
per hex cell, T = 1).

Block vector over subdomains: ``[K, N]`` with ``K = kx*ky*kz``,
``ii = (sz*ky + sy)*kx + sx``.

Local RT0 dof vector per subdomain: ``[N_rt]`` with ``N_rt = 3*s^2*(s+1)``:
  X faces [s, s, s+1] -> idx = (cz*s + cy)*(s+1) + fx
  Y faces [s, s+1, s] -> idx = s^2(s+1) + (cz*(s+1) + fy)*s + cx
  Z faces [s+1, s, s] -> idx = 2*s^2(s+1) + (fz*s + cy)*s + cx
Face dof convention (as in 2D): integral of the normal trace w.r.t. the
*family* normal (X: (1,0,0); Y: (0,1,0); Z: (0,0,1)).

Face quadrature parameterization (u, v) of each family maps to unit-cell
coords so that minus- and plus-side points are the SAME physical point:
  X: minus (1, u, v) / plus (0, u, v)
  Y: minus (u, 1, v) / plus (u, 0, v)
  Z: minus (u, v, 1) / plus (u, v, 0)
``FaceTab.length`` stores the physical face AREA (the face kernels in
``ops/assembly.py`` are dimension-agnostic given these tables).
"""
from __future__ import annotations

from functools import cached_property
from typing import Dict

import numpy as np

from ..grid3d import Grid3D
from .. import basis as B
from .. import quadrature as Q
from .spaces import FaceTab

_CENTROID = np.array([0.5, 0.5, 0.5])


def _face_pts_unit(fam_or_side: str, uv: np.ndarray, side01: float) -> np.ndarray:
    """Map face params [nqf, 2] to unit-cell coords [nqf, 3].

    ``fam_or_side`` in {'X','Y','Z'}; ``side01`` = fixed coordinate value
    (1.0 on the minus side of an interior family / 'hi' boundary, 0.0 on the
    plus side / 'lo' boundary)."""
    u, v = uv[:, 0], uv[:, 1]
    c = np.full_like(u, side01)
    if fam_or_side == "X":
        return np.stack([c, u, v], axis=-1)
    if fam_or_side == "Y":
        return np.stack([u, c, v], axis=-1)
    if fam_or_side == "Z":
        return np.stack([u, v, c], axis=-1)
    raise ValueError(fam_or_side)


# boundary side -> (family axis, fixed unit coordinate, outward normal sign)
SIDES3D = {
    "left":   ("X", 0.0, -1.0),
    "right":  ("X", 1.0, +1.0),
    "bottom": ("Y", 0.0, -1.0),
    "top":    ("Y", 1.0, +1.0),
    "near":   ("Z", 0.0, -1.0),
    "far":    ("Z", 1.0, +1.0),
}

_AXIS = {"X": 0, "Y": 1, "Z": 2}


class BlockDGSpace3D:
    """Static metadata for assembly on the 3D hex block DG space."""

    dim = 3

    def __init__(self, grid: Grid3D, order: int = 1, vol_quad: int = 3,
                 face_quad: int = 3):
        assert grid.grid_type == "hex", grid.grid_type
        self.grid = grid
        self.order = order
        self.elem = "H"
        self.nb = B.num_basis_hex(order)
        self.s = grid.s
        self.T = 1
        self.N = self.s ** 3 * self.nb
        self.K = grid.num_subdomains
        self.hx, self.hy, self.hz = grid.hx, grid.hy, grid.hz
        self._vol_quad = vol_quad
        self._face_quad = face_quad
        self._tabulate()

    @property
    def percell(self) -> bool:
        return False

    @property
    def face_families(self):
        return ("X", "Y", "Z")

    @property
    def volume(self) -> float:
        """Physical cell volume (the 3D 'area' factor of the 2D kernels)."""
        return self.hx * self.hy * self.hz

    def _phys_grad(self, dunit: np.ndarray) -> np.ndarray:
        out = dunit.copy()
        out[..., 0] /= self.hx
        out[..., 1] /= self.hy
        out[..., 2] /= self.hz
        return out

    def _tabulate(self):
        order = self.order
        qp, w = Q.hex_rule_unit_cell(self._vol_quad)
        self.vol_qp = qp                                       # [nq, 3]
        self.vol_w = w                                         # [nq] (sum 1)
        self.vol_phi = B.eval_basis_hex(order, qp)             # [nq, nb]
        self.vol_dphi = self._phys_grad(
            B.eval_basis_hex_grad_unit(order, qp))             # [nq, nb, 3]
        self.nodes_unit = B.hex_node_coords_unit(order)        # [nb, 3]

        uv, wf = Q.face3d_rule(self._face_quad)
        self.face_uv = uv
        self.face_tabs: Dict[str, FaceTab] = {}
        areas = {"X": self.hy * self.hz, "Y": self.hx * self.hz,
                 "Z": self.hx * self.hy}
        # SWIPDG penalty length scale |e| = face diameter (in 2D it is the
        # face length; the integration measure 'length' is the area here)
        diams = {"X": float(np.hypot(self.hy, self.hz)),
                 "Y": float(np.hypot(self.hx, self.hz)),
                 "Z": float(np.hypot(self.hx, self.hy))}
        normals = {"X": np.array([1.0, 0.0, 0.0]), "Y": np.array([0.0, 1.0, 0.0]),
                   "Z": np.array([0.0, 0.0, 1.0])}
        for fam in ("X", "Y", "Z"):
            pm = _face_pts_unit(fam, uv, 1.0)
            pp = _face_pts_unit(fam, uv, 0.0)
            self.face_tabs[fam] = FaceTab(
                phi_m=B.eval_basis_hex(order, pm),
                dphi_m=self._phys_grad(B.eval_basis_hex_grad_unit(order, pm)),
                phi_p=B.eval_basis_hex(order, pp),
                dphi_p=self._phys_grad(B.eval_basis_hex_grad_unit(order, pp)),
                normal=normals[fam], length=areas[fam], w=wf,
                pts_unit_m=pm, pts_unit_p=pp,
                tri_m=0, tri_p=0,
                centroid_m=_CENTROID, centroid_p=_CENTROID,
                pen_scale=diams[fam],
            )
        for side, (fam, c01, sgn) in SIDES3D.items():
            pm = _face_pts_unit(fam, uv, c01)
            self.face_tabs["bnd_" + side] = FaceTab(
                phi_m=B.eval_basis_hex(order, pm),
                dphi_m=self._phys_grad(B.eval_basis_hex_grad_unit(order, pm)),
                phi_p=None, dphi_p=None,
                normal=sgn * normals[fam], length=areas[fam], w=wf,
                pts_unit_m=pm, pts_unit_p=None,
                tri_m=0, tri_p=None,
                centroid_m=_CENTROID, centroid_p=None,
                pen_scale=diams[fam],
            )

    # ------------------------------------------------------------------
    # face enumeration
    # ------------------------------------------------------------------
    def interior_face_sets(self):
        """dict: family -> (cz_m, cy_m, cx_m, cz_p, cy_p, cx_p) flat arrays
        of the subdomain-interior faces."""
        s = self.s
        sets = {}
        cz, cy, cx = np.meshgrid(np.arange(s), np.arange(s), np.arange(s - 1),
                                 indexing="ij")
        sets["X"] = (cz.ravel(), cy.ravel(), cx.ravel(),
                     cz.ravel(), cy.ravel(), cx.ravel() + 1)
        cz, cy, cx = np.meshgrid(np.arange(s), np.arange(s - 1), np.arange(s),
                                 indexing="ij")
        sets["Y"] = (cz.ravel(), cy.ravel(), cx.ravel(),
                     cz.ravel(), cy.ravel() + 1, cx.ravel())
        cz, cy, cx = np.meshgrid(np.arange(s - 1), np.arange(s), np.arange(s),
                                 indexing="ij")
        sets["Z"] = (cz.ravel(), cy.ravel(), cx.ravel(),
                     cz.ravel() + 1, cy.ravel(), cx.ravel())
        return sets

    def side_cells(self, side: str):
        """(cz, cy, cx) arrays [s*s] of the cells touching a subdomain side,
        in canonical ``pos`` order: left/right iterate (cz, cy), bottom/top
        (cz, cx), near/far (cy, cx) — pos = a*s + b for the iterated pair."""
        s = self.s
        a, b = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        a, b = a.ravel(), b.ravel()
        edge = np.full(s * s, s - 1, np.int64)
        zero = np.zeros(s * s, np.int64)
        if side == "left":
            return a, b, zero
        if side == "right":
            return a, b, edge
        if side == "bottom":
            return a, zero, b
        if side == "top":
            return a, edge, b
        if side == "near":
            return zero, a, b
        if side == "far":
            return edge, a, b
        raise ValueError(side)

    def boundary_face_groups(self, side: str):
        """[(tab_key, cz, cy, cx, pos)] — single group per side in 3D."""
        cz, cy, cx = self.side_cells(side)
        pos = np.arange(self.s * self.s)
        return [("bnd_" + side, cz, cy, cx, pos)]

    def interface_face_groups(self, orient: str):
        """[(family, cz_m, cy_m, cx_m, pos)] for a subdomain interface:
        minus cells on the 'hi' side of the orientation axis; ``pos``
        matches the side_cells ordering of that side."""
        side = {"X": "right", "Y": "top", "Z": "far"}[orient]
        cz, cy, cx = self.side_cells(side)
        return [(orient, cz, cy, cx, np.arange(self.s * self.s))]

    # ------------------------------------------------------------------
    # dof index helpers
    # ------------------------------------------------------------------
    def dof_index(self, cz, cy, cx, i):
        s, nb = self.s, self.nb
        return (((np.asarray(cz) * s + np.asarray(cy)) * s + np.asarray(cx))
                * nb + np.asarray(i))

    def cell_dofs(self, cz, cy, cx) -> np.ndarray:
        """[..., nb] dof indices of cell (cz, cy, cx)."""
        i = np.arange(self.nb)
        return self.dof_index(np.asarray(cz)[..., None], np.asarray(cy)[..., None],
                              np.asarray(cx)[..., None], i)

    def side_dofs(self, side: str) -> np.ndarray:
        """[s*s*nb] dof indices of the boundary-layer cells on a side."""
        cz, cy, cx = self.side_cells(side)
        return self.cell_dofs(cz, cy, cx).ravel()

    @cached_property
    def subdomain_origins(self) -> np.ndarray:
        """[K, 3] physical lower corner of each subdomain."""
        return self.grid.subdomain_origins()

    @cached_property
    def cell_origins_local(self) -> np.ndarray:
        """[s, s, s, 3] cell lower corners relative to the subdomain origin
        (index [cz, cy, cx])."""
        cx = np.arange(self.s) * self.hx
        cy = np.arange(self.s) * self.hy
        cz = np.arange(self.s) * self.hz
        CZ, CY, CX = np.meshgrid(cz, cy, cx, indexing="ij")
        return np.stack([CX, CY, CZ], axis=-1)

    def node_coords_phys(self) -> np.ndarray:
        """[K, s, s, s, nb, 3] physical coordinates of all nodal points."""
        org = (self.subdomain_origins[:, None, None, None, :]
               + self.cell_origins_local[None])                # [K,s,s,s,3]
        scale = np.array([self.hx, self.hy, self.hz])
        nodes = self.nodes_unit * scale                        # [nb, 3]
        return org[..., None, :] + nodes[None, None, None, None]

    # ------------------------------------------------------------------
    # RT0 hex layout
    # ------------------------------------------------------------------
    @property
    def N_rt(self) -> int:
        s = self.s
        return 3 * s * s * (s + 1)

    def rt_index_X(self, cz, cy, fx):
        s = self.s
        return (np.asarray(cz) * s + np.asarray(cy)) * (s + 1) + np.asarray(fx)

    def rt_index_Y(self, cz, fy, cx):
        s = self.s
        return (s * s * (s + 1)
                + (np.asarray(cz) * (s + 1) + np.asarray(fy)) * s + np.asarray(cx))

    def rt_index_Z(self, fz, cy, cx):
        s = self.s
        return (2 * s * s * (s + 1)
                + (np.asarray(fz) * s + np.asarray(cy)) * s + np.asarray(cx))

    def hex_face_dofs(self) -> np.ndarray:
        """[s, s, s, 1, 6] local RT dof ids per cell in face order
        (xlo, xhi, ylo, yhi, zlo, zhi)."""
        s = self.s
        cz, cy, cx = np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                                 indexing="ij")
        idx = np.zeros((s, s, s, 1, 6), dtype=np.int64)
        idx[..., 0, 0] = self.rt_index_X(cz, cy, cx)
        idx[..., 0, 1] = self.rt_index_X(cz, cy, cx + 1)
        idx[..., 0, 2] = self.rt_index_Y(cz, cy, cx)
        idx[..., 0, 3] = self.rt_index_Y(cz, cy + 1, cx)
        idx[..., 0, 4] = self.rt_index_Z(cz, cy, cx)
        idx[..., 0, 5] = self.rt_index_Z(cz + 1, cy, cx)
        return idx

    def rt_cell_tab(self):
        """RT0 hex cell tabulation: ``(chi, idx, div)`` with
        chi [1, nq, 6, 3] family-convention basis values at the volume
        quadrature points (physical, cell-relative), idx [s, s, s, 1, 6],
        div [1, 6].  chi_xlo = ((hx-x)/V, 0, 0), chi_xhi = (x/V, 0, 0) etc.,
        V = hx*hy*hz; div = -+1/V (each chi_e has unit face dof on its own
        face w.r.t. the family normal, zero on the others — the tensor RT0
        on boxes, the 3D analog of the 2D 'quad' branch)."""
        scale = np.array([self.hx, self.hy, self.hz])
        qp = self.vol_qp * scale                               # [nq, 3] physical
        V = self.volume
        nq = qp.shape[0]
        x, y, z = qp[:, 0], qp[:, 1], qp[:, 2]
        o = np.zeros(nq)
        chi = np.stack([
            np.stack([(self.hx - x) / V, o, o], -1),           # xlo
            np.stack([x / V, o, o], -1),                       # xhi
            np.stack([o, (self.hy - y) / V, o], -1),           # ylo
            np.stack([o, y / V, o], -1),                       # yhi
            np.stack([o, o, (self.hz - z) / V], -1),           # zlo
            np.stack([o, o, z / V], -1),                       # zhi
        ], axis=1)[None]                                       # [1, nq, 6, 3]
        div = np.array([[-1.0, 1.0, -1.0, 1.0, -1.0, 1.0]]) / V
        return chi, self.hex_face_dofs(), div

    def rt_local_to_global(self) -> np.ndarray:
        """[K, N_rt] flat indices into the flattened global RT vector
        (layout: concat(X [Sz*Sy*(Sx+1)], Y [Sz*(Sy+1)*Sx], Z [(Sz+1)*Sy*Sx]);
        shared interface faces are duplicated in both adjacent local
        spaces)."""
        g = self.grid
        s = self.s
        Sx, Sy, Sz = g.global_nx, g.global_ny, g.global_nz
        offX = 0
        offY = Sz * Sy * (Sx + 1)
        offZ = offY + Sz * (Sy + 1) * Sx
        out = np.zeros((self.K, self.N_rt), dtype=np.int64)
        for ii in range(self.K):
            sx, sy, sz = g.subdomain_coords(ii)
            cz, cy, fx = np.meshgrid(np.arange(s), np.arange(s), np.arange(s + 1),
                                     indexing="ij")
            gX = offX + ((sz * s + cz) * Sy + (sy * s + cy)) * (Sx + 1) + (sx * s + fx)
            out[ii, self.rt_index_X(cz, cy, fx).ravel()] = gX.ravel()
            cz, fy, cx = np.meshgrid(np.arange(s), np.arange(s + 1), np.arange(s),
                                     indexing="ij")
            gY = offY + ((sz * s + cz) * (Sy + 1) + (sy * s + fy)) * Sx + (sx * s + cx)
            out[ii, self.rt_index_Y(cz, fy, cx).ravel()] = gY.ravel()
            fz, cy, cx = np.meshgrid(np.arange(s + 1), np.arange(s), np.arange(s),
                                     indexing="ij")
            gZ = offZ + ((sz * s + fz) * Sy + (sy * s + cy)) * Sx + (sx * s + cx)
            out[ii, self.rt_index_Z(fz, cy, cx).ravel()] = gZ.ravel()
        return out

    @property
    def N_rt_global(self) -> int:
        g = self.grid
        Sx, Sy, Sz = g.global_nx, g.global_ny, g.global_nz
        return (Sz * Sy * (Sx + 1) + Sz * (Sy + 1) * Sx + (Sz + 1) * Sy * Sx)
