"""Block DG space + local RT0 space descriptors: static tabulations & index maps.

The port's own copy of ``pylrbms_tpu/ops/spaces.py`` (numpy only).

Replacement for dune-gdt's ``make_block_dg_space`` /
``make_rt_space`` / ``restrict_to_dd_subdomain_view`` and the mapper machinery
(``discretize_elliptic_block_swipdg.py:543-546``, SURVEY.md §2.3).

Layouts
-------
DG dof vector per subdomain: ``[N]`` with ``N = s*s*T*nb`` and
``index(cy, cx, t, i) = ((cy*s + cx)*T + t)*nb + i``
(t = triangle-in-cell: 0 = A below diagonal, 1 = B above).

Block vector over subdomains: ``[K, N]`` with ``K = kx*ky``,
``ii = sy*kx + sx``  — "block space" = leading axis (SURVEY.md §7).

Local RT0 dof vector per subdomain: ``[N_rt]`` with ``N_rt = 3*s*s + 2*s``:
  D faces  [s, s]      -> idx = cy*s + cx
  V faces  [s, s+1]    -> idx = s*s + cy*(s+1) + vx          (vx = 0..s)
  H faces  [s+1, s]    -> idx = s*s + s*(s+1) + hy*s + cx    (hy = 0..s)
Face dof convention: integral of the normal trace w.r.t. the *family* normal
(V: (1,0); H: (0,1); D: (-hy,hx)/|.| pointing from triangle A to B).

Global RT0 space: D [Sy,Sx], V [Sy,Sx+1], H [Sy+1,Sx]; the subdomain->global
map is a pure index shift (shared interface faces are duplicated in both
adjacent local spaces, matching dune-gdt's restricted RT spaces,
``discretize_elliptic_block_swipdg.py:171-173``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict

import numpy as np

from ..grid import Grid
from .. import basis as B
from .. import quadrature as Q


@dataclass(frozen=True)
class FaceTab:
    """Static tabulation for one face family (or boundary side); the
    penalty length ``pen_len`` is ``length`` unless ``pen_scale`` is set."""
    phi_m: np.ndarray        # [nqf, nb] minus-side traces
    dphi_m: np.ndarray       # [nqf, nb, dim] physical gradients
    phi_p: np.ndarray | None  # plus side (None for boundary)
    dphi_p: np.ndarray | None
    normal: np.ndarray       # [dim] family normal (from minus to plus / outward)
    length: float            # physical face measure (length / area)
    w: np.ndarray            # [nqf] weights (sum to 1)
    pts_unit_m: np.ndarray   # [nqf, dim] unit-cell coords in the minus cell
    pts_unit_p: np.ndarray | None
    tri_m: int               # triangle-in-cell index of minus side (0=A, 1=B)
    tri_p: int | None
    centroid_m: np.ndarray   # [dim] unit-cell centroid of the minus element
    centroid_p: np.ndarray | None
    pen_scale: float | None = None   # penalty length |e| (None -> length)

    @property
    def pen_len(self) -> float:
        return self.length if self.pen_scale is None else self.pen_scale


TRI_ID = {"A": 0, "B": 1, "C": 0, "E": 1, "Q": 0}

# element types per cell parity for the crisscross family (t = 0 lower, 1 upper)
CC_ELEMS = (("A", "B"), ("C", "E"))


class BlockDGSpace:
    """All static metadata for assembly on the block DG space.

    Supports the structured grid families of the reference ('tri' = uniform
    Kuhn diagonal, 'crisscross' = the ALU-conform bisection checkerboard,
    'quad' = the Yasp cube grids; ``grid.py:17-42``): the differences are the
    per-cell element tables (T elements x nb basis functions; per-cell for
    'crisscross' where the diagonal direction alternates) and the face
    families (tri/crisscross have in-cell diagonal families).
    """

    def __init__(self, grid: Grid, order: int = 1, vol_quad: int = 5, face_quad: int = 5):
        assert grid.grid_type in ("tri", "quad", "crisscross"), grid.grid_type
        self.grid = grid
        self.order = order
        self.elem = "Q" if grid.grid_type == "quad" else "A"
        self.nb = B.num_basis(order, self.elem)
        self.s = grid.s
        self.T = grid.tri_per_cell
        self.N = self.s * self.s * self.T * self.nb
        self.K = grid.num_subdomains
        self.hx, self.hy = grid.hx, grid.hy
        self._vol_quad = vol_quad
        self._face_quad = face_quad
        if grid.grid_type == "quad":
            self._tabulate_quad()
        elif grid.grid_type == "crisscross":
            assert self.s % 2 == 0, \
                "crisscross needs an even cell count per subdomain side " \
                "(s = half*2**num_refinements with num_refinements >= 1)"
            self._tabulate_crisscross()
        else:
            self._tabulate()

    @property
    def percell(self) -> bool:
        """True when the volume tables carry a leading per-cell [s, s] axis
        (the 'crisscross' family, where element shapes vary per cell)."""
        return self.grid.grid_type == "crisscross"

    @property
    def cell_parity(self) -> np.ndarray:
        """[s, s] diagonal parity per cell (0 everywhere except 'crisscross')."""
        return self.grid.cell_parity()

    @property
    def face_families(self):
        """Interior face families: tri/crisscross have in-cell diagonals."""
        if self.grid.grid_type == "tri":
            return ("D", "V", "H")
        if self.grid.grid_type == "crisscross":
            return ("D0", "D1", "V0", "V1", "H0", "H1")
        return ("V", "H")

    # ------------------------------------------------------------------
    # face enumeration (static numpy; family -> minus/plus cell coords)
    # ------------------------------------------------------------------
    def interior_face_sets(self):
        """dict: family -> (cy_m, cx_m, cy_p, cx_p) flat cell-coord arrays of
        the subdomain-interior faces (the "one grid walk" face lists;
        <-> ``discretize_elliptic_block_swipdg.py:399-423``)."""
        s = self.s
        sets = {}
        if self.grid.grid_type == "crisscross":
            par = self.cell_parity
            for p in (0, 1):
                cy, cx = np.nonzero(par == p)
                sets[f"D{p}"] = (cy, cx, cy, cx)
                m = cx < s - 1
                sets[f"V{p}"] = (cy[m], cx[m], cy[m], cx[m] + 1)
                m = cy < s - 1
                sets[f"H{p}"] = (cy[m], cx[m], cy[m] + 1, cx[m])
            return sets
        if "D" in self.face_families:
            cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
            sets["D"] = (cy.ravel(), cx.ravel(), cy.ravel(), cx.ravel())
        cy, cx = np.meshgrid(np.arange(s), np.arange(s - 1), indexing="ij")
        sets["V"] = (cy.ravel(), cx.ravel(), cy.ravel(), cx.ravel() + 1)
        cy, cx = np.meshgrid(np.arange(s - 1), np.arange(s), indexing="ij")
        sets["H"] = (cy.ravel(), cx.ravel(), cy.ravel() + 1, cx.ravel())
        return sets

    def boundary_face_groups(self, side: str):
        """List of (tab_key, cy, cx, t, pos) for the faces on a subdomain
        side; ``pos`` is the index along the side (cy for left/right, cx for
        bottom/top).  One group for tri/quad; two parity groups for
        'crisscross' (the boundary-layer element type alternates)."""
        cy, cx, t = self.side_cells(side)
        pos = cy if side in ("left", "right") else cx
        if self.grid.grid_type != "crisscross":
            return [("bnd_" + side, cy, cx, t, pos)]
        par = (cy + cx) % 2
        out = []
        for p in (0, 1):
            m = par == p
            out.append((f"bnd_{side}_p{p}", cy[m], cx[m], t[m], pos[m]))
        return out

    def interface_face_groups(self, orient: str):
        """List of (family, cy_m, cx_m, pos) for the faces of a subdomain
        INTERFACE: ``orient='V'`` = the right edge (minus cells (r, s-1)),
        ``orient='H'`` = the top edge (minus cells (s-1, r)); ``pos`` = r,
        the index along the interface.  One group for tri/quad; two parity
        groups for 'crisscross'."""
        s = self.s
        r = np.arange(s)
        if orient == "V":
            cy, cx = r, np.full(s, s - 1, np.int64)
        elif orient == "H":
            cy, cx = np.full(s, s - 1, np.int64), r
        else:
            raise ValueError(orient)
        if self.grid.grid_type != "crisscross":
            return [(orient, cy, cx, r)]
        par = (cy + cx) % 2
        return [(f"{orient}{p}", cy[par == p], cx[par == p], r[par == p])
                for p in (0, 1)]

    # ------------------------------------------------------------------
    def _phys_grad(self, dunit: np.ndarray) -> np.ndarray:
        out = dunit.copy()
        out[..., 0] /= self.hx
        out[..., 1] /= self.hy
        return out

    def _tabulate(self):
        order = self.order
        # volume quadrature per triangle type
        qpA, wA = Q.triangle_rule_unit_cell("A", self._vol_quad)
        qpB, wB = Q.triangle_rule_unit_cell("B", self._vol_quad)
        self.vol_qp = np.stack([qpA, qpB])                  # [2, nq, 2] unit-cell
        self.vol_w = np.stack([wA, wB])                     # [2, nq]  (sum 1/2 each)
        self.vol_phi = np.stack([B.eval_basis("A", order, qpA),
                                 B.eval_basis("B", order, qpB)])       # [2, nq, nb]
        self.vol_dphi = np.stack([
            self._phys_grad(B.eval_basis_grad_unit("A", order, qpA)),
            self._phys_grad(B.eval_basis_grad_unit("B", order, qpB)),
        ])                                                   # [2, nq, nb, 2]
        self.tri_centroids = np.stack([B.TRI_VERTS_UNIT["A"].mean(0),
                                       B.TRI_VERTS_UNIT["B"].mean(0)])  # [2, 2]
        # nodal points (for interpolation / oswald / prolongation)
        self.nodes_unit = np.stack([B.node_coords_unit("A", order),
                                    B.node_coords_unit("B", order)])    # [2, nb, 2]

        # face tabulations
        t, w = Q.edge_rule(self._face_quad)
        self.face_t = t                 # 1d face parameter (RT1 edge moments)
        self.face_tabs: Dict[str, FaceTab] = {}
        lengths = {"D": float(np.hypot(self.hx, self.hy)), "V": self.hy, "H": self.hx}
        normals = {
            "D": np.array([-self.hy, self.hx]) / np.hypot(self.hx, self.hy),
            "V": np.array([1.0, 0.0]),
            "H": np.array([0.0, 1.0]),
        }
        for fam, ((tm, em), (tp, ep)) in B.EDGES_UNIT.items():
            pm = em.points(t)
            pp = ep.points(t)
            self.face_tabs[fam] = FaceTab(
                phi_m=B.eval_basis(tm, order, pm),
                dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                phi_p=B.eval_basis(tp, order, pp),
                dphi_p=self._phys_grad(B.eval_basis_grad_unit(tp, order, pp)),
                normal=normals[fam], length=lengths[fam], w=w,
                pts_unit_m=pm, pts_unit_p=pp,
                tri_m=TRI_ID[tm], tri_p=TRI_ID[tp],
                centroid_m=self.tri_centroids[TRI_ID[tm]],
                centroid_p=self.tri_centroids[TRI_ID[tp]],
            )
        bnd_normals = {"left": np.array([-1.0, 0.0]), "right": np.array([1.0, 0.0]),
                       "bottom": np.array([0.0, -1.0]), "top": np.array([0.0, 1.0])}
        bnd_lengths = {"left": self.hy, "right": self.hy, "bottom": self.hx, "top": self.hx}
        for side, (tm, em) in B.BOUNDARY_EDGES_UNIT.items():
            pm = em.points(t)
            self.face_tabs["bnd_" + side] = FaceTab(
                phi_m=B.eval_basis(tm, order, pm),
                dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                phi_p=None, dphi_p=None,
                normal=bnd_normals[side], length=bnd_lengths[side], w=w,
                pts_unit_m=pm, pts_unit_p=None,
                tri_m=TRI_ID[tm], tri_p=None,
                centroid_m=self.tri_centroids[TRI_ID[tm]], centroid_p=None,
            )

    def _tabulate_crisscross(self):
        """Crisscross tables: the element SHAPE varies per cell (checkerboard
        parity), so the volume tables carry a leading per-cell [s, s] axis
        (gathered from two per-parity stacks; O(s^2 nq nb) statics — same
        order as the dof vector).  Face families are split by the minus
        cell's parity (basis.py CC_EDGES_UNIT)."""
        order = self.order
        s = self.s
        par = self.cell_parity                               # [s, s]
        qp_t, w_t, phi_t, dphi_t, cen_t, nod_t = [], [], [], [], [], []
        for elems in CC_ELEMS:                               # parity 0, 1
            qps, ws, phis, dphis, cens, nods = [], [], [], [], [], []
            for el in elems:                                 # t = 0, 1
                qp, w = Q.triangle_rule_unit_cell(el, self._vol_quad)
                qps.append(qp)
                ws.append(w)
                phis.append(B.eval_basis(el, order, qp))
                dphis.append(self._phys_grad(B.eval_basis_grad_unit(el, order, qp)))
                cens.append(B.TRI_VERTS_UNIT[el].mean(0))
                nods.append(B.node_coords_unit(el, order))
            qp_t.append(np.stack(qps))
            w_t.append(np.stack(ws))
            phi_t.append(np.stack(phis))
            dphi_t.append(np.stack(dphis))
            cen_t.append(np.stack(cens))
            nod_t.append(np.stack(nods))
        # per-cell weights for uniform einsum rewriting (assembly._vol_ein);
        # mirrored rules share weights pointwise, so this is a broadcast copy
        assert np.allclose(w_t[0], w_t[1])
        self.vol_w = np.stack(w_t)[par]                      # [s, s, T, nq]
        self.vol_qp = np.stack(qp_t)[par]                    # [s, s, T, nq, 2]
        self.vol_phi = np.stack(phi_t)[par]                  # [s, s, T, nq, nb]
        self.vol_dphi = np.stack(dphi_t)[par]                # [s, s, T, nq, nb, 2]
        self.tri_centroids = np.stack(cen_t)[par]            # [s, s, T, 2]
        self.nodes_unit = np.stack(nod_t)[par]               # [s, s, T, nb, 2]

        # face tabulations (6 interior families + 2 per boundary side)
        t, w = Q.edge_rule(self._face_quad)
        self.face_t = t
        self.face_tabs: Dict[str, FaceTab] = {}
        diag_len = float(np.hypot(self.hx, self.hy))
        lengths = {"D0": diag_len, "D1": diag_len,
                   "V0": self.hy, "V1": self.hy, "H0": self.hx, "H1": self.hx}
        normals = {
            "D0": np.array([-self.hy, self.hx]) / diag_len,
            "D1": np.array([self.hy, self.hx]) / diag_len,
            "V0": np.array([1.0, 0.0]), "V1": np.array([1.0, 0.0]),
            "H0": np.array([0.0, 1.0]), "H1": np.array([0.0, 1.0]),
        }

        def centroid(el):
            return B.TRI_VERTS_UNIT[el].mean(0)

        for fam, ((tm, em), (tp, ep)) in B.CC_EDGES_UNIT.items():
            pm = em.points(t)
            pp = ep.points(t)
            self.face_tabs[fam] = FaceTab(
                phi_m=B.eval_basis(tm, order, pm),
                dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                phi_p=B.eval_basis(tp, order, pp),
                dphi_p=self._phys_grad(B.eval_basis_grad_unit(tp, order, pp)),
                normal=normals[fam], length=lengths[fam], w=w,
                pts_unit_m=pm, pts_unit_p=pp,
                tri_m=TRI_ID[tm], tri_p=TRI_ID[tp],
                centroid_m=centroid(tm), centroid_p=centroid(tp),
            )
        bnd_normals = {"left": np.array([-1.0, 0.0]), "right": np.array([1.0, 0.0]),
                       "bottom": np.array([0.0, -1.0]), "top": np.array([0.0, 1.0])}
        bnd_lengths = {"left": self.hy, "right": self.hy,
                       "bottom": self.hx, "top": self.hx}
        for side, per_parity in B.CC_BOUNDARY_EDGES_UNIT.items():
            for p, (tm, em) in enumerate(per_parity):
                pm = em.points(t)
                self.face_tabs[f"bnd_{side}_p{p}"] = FaceTab(
                    phi_m=B.eval_basis(tm, order, pm),
                    dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                    phi_p=None, dphi_p=None,
                    normal=bnd_normals[side], length=bnd_lengths[side], w=w,
                    pts_unit_m=pm, pts_unit_p=None,
                    tri_m=TRI_ID[tm], tri_p=None,
                    centroid_m=centroid(tm), centroid_p=None,
                )

    def _tabulate_quad(self):
        """Same tables as :meth:`_tabulate` for the 'quad' grid: one "Q"
        element per cell (T=1), face families V/H only (no in-cell diagonal)."""
        order = self.order
        qp, w = Q.quad_rule_unit_cell(self._vol_quad)
        self.vol_qp = qp[None]                               # [1, nq, 2]
        self.vol_w = w[None]                                 # [1, nq] (sum 1)
        self.vol_phi = B.eval_basis("Q", order, qp)[None]    # [1, nq, nb]
        self.vol_dphi = self._phys_grad(
            B.eval_basis_grad_unit("Q", order, qp))[None]    # [1, nq, nb, 2]
        self.tri_centroids = np.array([[0.5, 0.5]])          # [1, 2]
        self.nodes_unit = B.node_coords_unit("Q", order)[None]  # [1, nb, 2]

        t, w = Q.edge_rule(self._face_quad)
        self.face_t = t
        self.face_tabs: Dict[str, FaceTab] = {}
        lengths = {"V": self.hy, "H": self.hx}
        normals = {"V": np.array([1.0, 0.0]), "H": np.array([0.0, 1.0])}
        for fam, ((tm, em), (tp, ep)) in B.QUAD_EDGES_UNIT.items():
            pm = em.points(t)
            pp = ep.points(t)
            self.face_tabs[fam] = FaceTab(
                phi_m=B.eval_basis(tm, order, pm),
                dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                phi_p=B.eval_basis(tp, order, pp),
                dphi_p=self._phys_grad(B.eval_basis_grad_unit(tp, order, pp)),
                normal=normals[fam], length=lengths[fam], w=w,
                pts_unit_m=pm, pts_unit_p=pp,
                tri_m=0, tri_p=0,
                centroid_m=self.tri_centroids[0],
                centroid_p=self.tri_centroids[0],
            )
        bnd_normals = {"left": np.array([-1.0, 0.0]), "right": np.array([1.0, 0.0]),
                       "bottom": np.array([0.0, -1.0]), "top": np.array([0.0, 1.0])}
        bnd_lengths = {"left": self.hy, "right": self.hy, "bottom": self.hx, "top": self.hx}
        for side, (tm, em) in B.QUAD_BOUNDARY_EDGES_UNIT.items():
            pm = em.points(t)
            self.face_tabs["bnd_" + side] = FaceTab(
                phi_m=B.eval_basis(tm, order, pm),
                dphi_m=self._phys_grad(B.eval_basis_grad_unit(tm, order, pm)),
                phi_p=None, dphi_p=None,
                normal=bnd_normals[side], length=bnd_lengths[side], w=w,
                pts_unit_m=pm, pts_unit_p=None,
                tri_m=0, tri_p=None,
                centroid_m=self.tri_centroids[0], centroid_p=None,
            )

    # ------------------------------------------------------------------
    # dof index helpers (numpy, static)
    # ------------------------------------------------------------------
    def dof_index(self, cy, cx, t, i):
        s, T, nb = self.s, self.T, self.nb
        return ((np.asarray(cy) * s + np.asarray(cx)) * T + np.asarray(t)) * nb + np.asarray(i)

    def cell_dofs(self, cy, cx, t) -> np.ndarray:
        """[..., nb] dof indices of cell (cy,cx) triangle t."""
        i = np.arange(self.nb)
        return self.dof_index(np.asarray(cy)[..., None], np.asarray(cx)[..., None],
                              np.asarray(t)[..., None] if np.ndim(t) else t, i)

    @cached_property
    def subdomain_origins(self) -> np.ndarray:
        """[K, 2] physical lower-left corner of each subdomain."""
        g = self.grid
        sx = np.arange(g.kx) * (g.s * g.hx) + g.lower_left[0]
        sy = np.arange(g.ky) * (g.s * g.hy) + g.lower_left[1]
        SX, SY = np.meshgrid(sx, sy)           # [ky, kx]
        return np.stack([SX.ravel(), SY.ravel()], axis=-1)

    @cached_property
    def cell_origins_local(self) -> np.ndarray:
        """[s, s, 2] cell lower-left corners relative to the subdomain origin
        (index [cy, cx])."""
        cx = np.arange(self.s) * self.hx
        cy = np.arange(self.s) * self.hy
        CX, CY = np.meshgrid(cx, cy)           # [cy, cx] -> CX[cy,cx]=cx*hx
        return np.stack([CX, CY], axis=-1)

    def node_coords_phys(self) -> np.ndarray:
        """[K, s, s, T, nb, 2] physical coordinates of all nodal points."""
        org = (self.subdomain_origins[:, None, None, :]
               + self.cell_origins_local[None, :, :, :])       # [K, s, s, 2]
        scale = np.array([self.hx, self.hy])
        nodes = self.nodes_unit * scale        # [T, nb, 2] or [s, s, T, nb, 2]
        if self.percell:
            return org[:, :, :, None, None, :] + nodes[None]
        return org[:, :, :, None, None, :] + nodes[None, None, None, :, :, :]

    # ------------------------------------------------------------------
    # RT0 layout
    # ------------------------------------------------------------------
    @property
    def N_rt(self) -> int:
        s = self.s
        if self.grid.grid_type == "quad":
            return 2 * s * (s + 1)
        return 3 * s * s + 2 * s

    def rt_index_D(self, cy, cx):
        assert self.grid.grid_type in ("tri", "crisscross")
        return np.asarray(cy) * self.s + np.asarray(cx)

    def rt_index_V(self, cy, vx):
        off = 0 if self.grid.grid_type == "quad" else self.s * self.s
        return off + np.asarray(cy) * (self.s + 1) + np.asarray(vx)

    def rt_index_H(self, hy, cx):
        off = (self.s * (self.s + 1) if self.grid.grid_type == "quad"
               else self.s * self.s + self.s * (self.s + 1))
        return off + np.asarray(hy) * self.s + np.asarray(cx)

    # triangle -> (local rt dof, orientation sign, opposite vertex unit coords)
    # edges per triangle: A: [bottom H(cy,cx), right V(cy,cx+1), diag D(cy,cx)]
    #                     B: [left V(cy,cx), top H(cy+1,cx), diag D(cy,cx)]
    def tri_face_dofs(self):
        """Static incidence: returns (idx, sign, opp) with
        idx [s, s, T, 3] local RT dof ids, sign [T, 3] orientation
        (+1 if family normal is outward), opp [T, 3, 2] opposite vertex in
        unit-cell coords."""
        s = self.s
        cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        idx = np.zeros((s, s, 2, 3), dtype=np.int64)
        idx[:, :, 0, 0] = self.rt_index_H(cy, cx)          # A bottom
        idx[:, :, 0, 1] = self.rt_index_V(cy, cx + 1)      # A right
        idx[:, :, 0, 2] = self.rt_index_D(cy, cx)          # A diag
        idx[:, :, 1, 0] = self.rt_index_V(cy, cx)          # B left
        idx[:, :, 1, 1] = self.rt_index_H(cy + 1, cx)      # B top
        idx[:, :, 1, 2] = self.rt_index_D(cy, cx)          # B diag
        sign = np.array([[-1.0, 1.0, 1.0],                  # A: bottom,right,diag
                         [-1.0, 1.0, -1.0]])                # B: left,top,diag
        opp = np.array([
            [[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]],           # A: opp of e0,e1,e2
            [[1.0, 1.0], [0.0, 0.0], [0.0, 1.0]],           # B
        ])
        return idx, sign, opp

    def cc_face_dofs(self):
        """Crisscross RT0 incidence in LOCAL-EDGE order (slot k = element
        local edge k; basis.py CC_FACE_LOCAL_EDGE): returns per-cell
        (idx [s,s,T,3], sign [s,s,T,3], opp [s,s,T,3,2])."""
        s = self.s
        cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        par = self.cell_parity                               # [s, s]
        idx = np.zeros((s, s, 2, 3), dtype=np.int64)
        # parity 0 (A/B) — same as tri_face_dofs
        idx[:, :, 0, 0] = np.where(par == 0, self.rt_index_H(cy, cx),       # A e0 bottom / C e0 bottom
                                   self.rt_index_H(cy, cx))
        idx[:, :, 0, 1] = np.where(par == 0, self.rt_index_V(cy, cx + 1),   # A e1 right / C e1 anti-diag
                                   self.rt_index_D(cy, cx))
        idx[:, :, 0, 2] = np.where(par == 0, self.rt_index_D(cy, cx),       # A e2 diag / C e2 left
                                   self.rt_index_V(cy, cx))
        idx[:, :, 1, 0] = np.where(par == 0, self.rt_index_V(cy, cx),       # B e0 left / E e0 right
                                   self.rt_index_V(cy, cx + 1))
        idx[:, :, 1, 1] = np.where(par == 0, self.rt_index_H(cy + 1, cx),   # B e1 top / E e1 top
                                   self.rt_index_H(cy + 1, cx))
        idx[:, :, 1, 2] = self.rt_index_D(cy, cx)                           # diag both
        # orientation w.r.t. family normals (V=(1,0), H=(0,1), D0/D1 per
        # spaces-module docstring; derivation in basis.py CC_* comments)
        sign_par = np.array([
            [[-1.0, 1.0, 1.0],     # A: bottom H, right V, diag D
             [-1.0, 1.0, -1.0]],   # B: left V, top H, diag D
            [[-1.0, 1.0, -1.0],    # C: bottom H, anti-diag D, left V
             [1.0, 1.0, -1.0]],    # E: right V, top H, anti-diag D
        ])
        opp_par = np.array([
            [[[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]],     # A
             [[1.0, 1.0], [0.0, 0.0], [0.0, 1.0]]],    # B
            [[[0.0, 1.0], [0.0, 0.0], [1.0, 0.0]],     # C
             [[0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]],    # E
        ])
        sign = sign_par[par]                                 # [s, s, T, 3]
        opp = opp_par[par]                                   # [s, s, T, 3, 2]
        return idx, sign, opp

    def quad_face_dofs(self):
        """Quad-grid RT0 incidence: idx [s, s, 1, 4] local RT dof ids in face
        order (left V, right V, bottom H, top H)."""
        s = self.s
        cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        idx = np.zeros((s, s, 1, 4), dtype=np.int64)
        idx[:, :, 0, 0] = self.rt_index_V(cy, cx)
        idx[:, :, 0, 1] = self.rt_index_V(cy, cx + 1)
        idx[:, :, 0, 2] = self.rt_index_H(cy, cx)
        idx[:, :, 0, 3] = self.rt_index_H(cy + 1, cx)
        return idx

    def rt_cell_tab(self):
        """Unified RT0 cell tabulation for products/estimators.

        Returns ``(chi, idx, div)`` with
        * ``chi`` [T, nq, nf, 2] — *family-convention* RT0 basis values at the
          volume quadrature points (physical, cell-relative; orientation signs
          already folded in): the flux restricted to a cell is
          ``t = sum_e c_e chi_e`` with ``c_e`` the family-normal face dofs;
        * ``idx`` [s, s, T, nf] — local RT dof ids per cell element;
        * ``div`` [T, nf] — the (constant) divergence of each chi_e.

        tri: chi_e = sigma_e (x - p_e)/(2|T|) (simplex RT0, p_e = opposite
        vertex), div = sigma_e/|T|.  quad: the tensor RT0 on rectangles,
        chi_L = ((hx-x)/(hx hy), 0), chi_R = (x/(hx hy), 0) etc.,
        div = -+1/(hx hy).
        """
        scale = np.array([self.hx, self.hy])
        qp = self.vol_qp * scale                 # [T, nq, 2] physical, cell-relative
        area = self.hx * self.hy
        if self.grid.grid_type == "quad":
            nq = qp.shape[1]
            x, y = qp[0, :, 0], qp[0, :, 1]
            z = np.zeros(nq)
            chi = np.stack([
                np.stack([(self.hx - x) / area, z], -1),    # left V
                np.stack([x / area, z], -1),                # right V
                np.stack([z, (self.hy - y) / area], -1),    # bottom H
                np.stack([z, y / area], -1),                # top H
            ], axis=1)[None]                                 # [1, nq, 4, 2]
            div = np.array([[-1.0, 1.0, -1.0, 1.0]]) / area  # [1, 4]
            return chi, self.quad_face_dofs(), div
        if self.grid.grid_type == "crisscross":
            idx, sign, opp = self.cc_face_dofs()             # per-cell
            p = opp * scale                                  # [s, s, T, 3, 2]
            # qp is per-cell [s, s, T, nq, 2] for crisscross
            chi = (qp[:, :, :, :, None, :] - p[:, :, :, None, :, :]) / area
            chi = chi * sign[:, :, :, None, :, None]         # [s,s,T,nq,3,2]
            div = sign / (area / 2.0)                        # [s, s, T, 3]
            return chi, idx, div
        idx, sign, opp = self.tri_face_dofs()
        p = opp * scale                          # [T, 3, 2]
        chi = (qp[:, :, None, :] - p[:, None, :, :]) / area  # (x-p)/(2|T|)
        chi = chi * sign[:, None, :, None]
        div = sign / (area / 2.0)
        return chi, idx, div

    def rt_local_to_global(self) -> np.ndarray:
        """[K, N_rt] flat indices into the flattened global RT vector.

        Global RT flat layout: concat(D [Sy*Sx], V [Sy*(Sx+1)], H [(Sy+1)*Sx])
        for 'tri'; concat(V, H) for 'quad'.
        """
        g = self.grid
        s = self.s
        Sy, Sx = g.global_ny, g.global_nx
        has_D = g.grid_type in ("tri", "crisscross")
        offD = 0
        offV = Sy * Sx if has_D else 0
        offH = offV + Sy * (Sx + 1)
        out = np.zeros((self.K, self.N_rt), dtype=np.int64)
        for ii in range(self.K):
            sx, sy = g.subdomain_coords(ii)
            if has_D:
                cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
                gD = offD + (sy * s + cy) * Sx + (sx * s + cx)
                out[ii, self.rt_index_D(cy, cx).ravel()] = gD.ravel()
            cy, vx = np.meshgrid(np.arange(s), np.arange(s + 1), indexing="ij")
            gV = offV + (sy * s + cy) * (Sx + 1) + (sx * s + vx)
            out[ii, self.rt_index_V(cy, vx).ravel()] = gV.ravel()
            hy, cx = np.meshgrid(np.arange(s + 1), np.arange(s), indexing="ij")
            gH = offH + (sy * s + hy) * Sx + (sx * s + cx)
            out[ii, self.rt_index_H(hy, cx).ravel()] = gH.ravel()
        return out

    @property
    def N_rt_global(self) -> int:
        g = self.grid
        Sy, Sx = g.global_ny, g.global_nx
        nVH = Sy * (Sx + 1) + (Sy + 1) * Sx
        return nVH if g.grid_type == "quad" else Sy * Sx + nVH

    # ------------------------------------------------------------------
    # interface dof lists (for couplings / patch boundary terms)
    # ------------------------------------------------------------------
    def side_cells(self, side: str):
        """(cy, cx, t) arrays [s] of the cells+element touching a subdomain
        side.  For 'crisscross' the boundary-layer element alternates on the
        left/right sides (B/C resp. A/E, both mapping to in-cell index
        1-p resp. p with p the cell parity); bottom is always the lower
        element (A/C, t=0) and top the upper (B/E, t=1)."""
        s = self.s
        r = np.arange(s)
        z = np.zeros(s, np.int64)
        cc = self.grid.grid_type == "crisscross"
        tB = z if self.grid.grid_type == "quad" else np.ones(s, np.int64)
        if side == "left":
            t = (1 - (r % 2)) if cc else tB                  # B (p0) / C (p1)
            return r, np.zeros(s, np.int64), t
        if side == "right":
            t = ((r + s - 1) % 2) if cc else z               # A (p0) / E (p1)
            return r, np.full(s, s - 1, np.int64), t
        if side == "bottom":
            return np.zeros(s, np.int64), r, z               # A / C
        if side == "top":
            return np.full(s, s - 1, np.int64), r, tB        # B / E
        raise ValueError(side)

    def side_dofs(self, side: str) -> np.ndarray:
        """[s*nb] dof indices of the boundary-layer triangles on a side."""
        cy, cx, t = self.side_cells(side)
        return self.cell_dofs(cy, cx, t).ravel()
