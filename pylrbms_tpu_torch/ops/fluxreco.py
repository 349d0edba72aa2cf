"""RT0 diffusive flux reconstruction, batched over all faces.

The port of ``pylrbms_tpu/ops/fluxreco.py`` (RT0, non-per-cell families):
per affine diffusion component ``lambda_q`` reconstruct t_q in RT0 from u_h
via the face moments

  inner face e:      int_e t.n  = int_e ( -{lambda_q kappa grad u}_omega . n
                                           + penalty_e(lambda_q) [u] )
  Dirichlet face e:  int_e t.n_out = int_e ( -lambda_q kappa grad u . n_out
                                             + penalty_b(lambda_q) u )

with the assembly's weights and penalties, on all faces of the mesh at once,
then restrict to the local subdomain RT spaces by a static index gather.
Each face dof is linear in the values of its two cells: the coefficients
(the lambda_q, omega, gamma and penalty factors at the face points with the
quadrature) are U- and mu-independent tables, built once per set of
components in the reconstructor's dtype on its device, so a call is a
gather of the cell values, their jumps at the face points and a product
with the tables.
The RT1 reconstruction of order-2 spaces (``ops/rt1.py``) subclasses
:class:`FluxReconstructor`: it changes the moments per edge, the dof layout
and adds interior dofs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .assembly import IPDGParams, DEFAULT_IPDG, _EVAL_EPS, _omega_gamma, tensor


@dataclass
class Faces:
    """One family of faces that share a tab: the minus (and plus) cell of
    each face as a flat index of the cell-by-cell u [..., cells, nb], the
    minus cells' origins and each face's slot in the flat face layout."""
    key: str                    # the face tab
    side: str | None            # the boundary side; None for inner faces
    orgs: np.ndarray            # [F, dim]
    src_m: np.ndarray           # [F]
    src_p: np.ndarray | None    # [F]; None on the boundary
    slot: np.ndarray            # [F]


class FluxReconstructor:
    """Precomputes face geometry; ``apply(lam_fn, U)`` -> local RT dofs.

    The flat global dof layout is D [Sy*Sx] (tri and crisscross), V
    [Sy*(Sx+1)], H [(Sy+1)*Sx], each edge with ``nm`` moments (1 for RT0),
    followed by any interior dofs (:meth:`_extra_parts`)."""

    nm = 1          # moments per edge
    required_order = 1

    def __init__(self, space, kappa_fn=None, ipdg: IPDGParams = DEFAULT_IPDG,
                 dtype=torch.float64, device=None):
        if space.order != self.required_order:
            raise ValueError(f"{type(self).__name__} expects an order-"
                             f"{self.required_order} DG space")
        self.space = space
        self.kappa_fn = kappa_fn
        self.ipdg = ipdg
        self.dtype = dtype
        self.device = device
        g = space.grid
        self.Sy, self.Sx = g.global_ny, g.global_nx
        self.rt_l2g = torch.as_tensor(self._local_to_global(space), device=device)
        self.cell_org = g.cell_origins()                       # [Sy, Sx, 2]
        self._tables = {}

    def _local_to_global(self, space):
        return space.rt_local_to_global()

    def _extra_parts(self, lam_fn, uc, out_dt):
        """Non-edge (interior) dof blocks appended after the edge parts."""
        return []

    def _t(self, a):
        return tensor(a, self.dtype, self.device)

    def _u_block_to_cells(self, U):
        sp = self.space
        g = sp.grid
        lead = U.shape[:-2]
        U = U.reshape(lead + (g.ky, g.kx, sp.s, sp.s, sp.T, sp.nb))
        U = torch.movedim(U, -4, -5)
        return U.reshape(lead + (self.Sy, self.Sx, sp.T, sp.nb))

    def _edge_moments(self, w, integrand, ell):
        """[..., F, nqf] integrand -> [..., F, nm] edge moments."""
        return (ell * torch.einsum("q,...fq->...f", w, integrand))[..., None]

    def _face_tables(self, f, lam_fn):
        """(jump, coefficients) of the faces of the family ``f`` for one
        component, on the differences d = (u_j - u_0 of the minus cell,
        j >= 1; the same of the plus cell) and d0 = u_0(minus) - u_0(plus)
        (u_0(minus) on the boundary): ``jump`` [F, 2 (nb - 1), nqf] gives
        the jump [u] at the face points as d0 + d . jump (u itself on the
        boundary), ``coefficients`` [F, 2 (nb - 1) + nqf, nm] the face dofs
        from d and that jump:

          inner:    int_e ( -{lambda_q kappa grad u}_omega . n
                            + penalty_e(lambda_q) [u] ) v
          boundary: +-int_e ( -lambda_q kappa grad u . n_out
                              + penalty_b(lambda_q) u ) v

        for each edge moment's test function v (:meth:`_edge_moments`; v = 1
        for RT0), the sign turning n_out into the family normal (V=(1,0),
        H=(0,1), in 3D the X, Y, Z axes).  The cell basis sums to one, so
        u_0 drops out of a gradient and enters a value once: the
        differences are small where u is smooth, and no large one-sided
        terms cancel in the reconstructor's dtype.  lambda_q and kappa are
        evaluated in that dtype as the points are; the factors are combined
        in float64 and rounded once."""
        sp = self.space
        tab = sp.face_tabs[f.key]
        dt, wide = self.dtype, torch.float64
        n = tensor(tab.normal, wide, self.device)
        F = len(f.slot)

        def one_side(x, dphi):
            """(lambda, n.kappa.n, kappa grad(phi_j) . n) at the points x."""
            x = self._t(x)
            lam = lam_fn(x).to(dt).to(wide)
            dphi = tensor(dphi, wide, self.device)
            if self.kappa_fn is None:
                dn = torch.einsum("qja,a->qj", dphi, n).expand((F,) + dphi.shape[:2])
                return lam, torch.ones_like(lam), dn
            kap = self.kappa_fn(x).to(dt).to(wide)
            return (lam, torch.einsum("...ab,a,b->...", kap, n, n),
                    torch.einsum("fqab,qjb,a->fqj", kap, dphi, n))

        for phi in (tab.phi_m, tab.phi_p):
            if phi is not None and not np.allclose(np.sum(phi, -1), 1.0):
                raise ValueError("the face tables take a cell basis that sums to one")
        x_m, x_p = self._phys_pts(tab, f.orgs)
        lam_m, delta_m, dn_m = one_side(x_m, tab.dphi_m)
        phi_m = tensor(tab.phi_m, wide, self.device)[:, 1:]
        if f.side is None:
            lam_p, delta_p, dn_p = one_side(x_p, tab.dphi_p)
            om_m, om_p, gamma = _omega_gamma(delta_m, delta_p)
            pen = (self.ipdg.sigma_inner(sp.order) * gamma
                   * (om_m * lam_m + om_p * lam_p) / tab.pen_len ** self.ipdg.beta)
            grad = torch.cat([(om_m * lam_m)[..., None] * dn_m[..., 1:],
                              (om_p * lam_p)[..., None] * dn_p[..., 1:]], -1)
            phi = torch.cat([phi_m, -tensor(tab.phi_p, wide, self.device)[:, 1:]], -1)
            sign = 1.0
        else:
            pen = (self.ipdg.sigma_boundary(sp.order) * delta_m * lam_m
                   / tab.pen_len ** self.ipdg.beta)
            grad = lam_m[..., None] * dn_m[..., 1:]
            grad = torch.cat([grad, torch.zeros_like(grad)], -1)
            phi = torch.cat([phi_m, torch.zeros_like(phi_m)], -1)
            sign = +1.0 if f.side in ("right", "top", "far") else -1.0
        nqf = phi.shape[0]
        W = sign * self._edge_moments(tensor(tab.w, wide, self.device),
                                      torch.eye(nqf, dtype=wide, device=self.device)[:, None],
                                      tab.length)[:, 0]             # [nqf, nm]
        coef = torch.cat([-torch.einsum("fqk,qm->fkm", grad, W),
                          pen[..., None] * W], 1)            # [F, 2 (nb - 1) + nqf, nm]
        jump = phi.T.expand((F,) + phi.T.shape)
        return jump.to(dt), coef.to(dt)

    @property
    def scale(self) -> np.ndarray:
        """Cell widths per axis."""
        return np.array([self.space.hx, self.space.hy])

    def _phys_pts(self, tab, orgs):
        """orgs [F, dim] -> one-sided eval points [F, nqf, dim] (float64
        numpy); an axis-aligned family normal puts the plus element one cell
        over."""
        scale = self.scale
        orgs = np.asarray(orgs, np.float64)[:, None, :]
        x = orgs + (tab.pts_unit_m * scale)[None]
        cen_m = orgs + (tab.centroid_m * scale)[None]
        x_m = x + _EVAL_EPS * (cen_m - x)
        if tab.centroid_p is None:
            return x_m, None
        n = np.asarray(tab.normal)
        shift = (np.abs(n) * scale if np.count_nonzero(np.abs(n) > 1e-12) == 1
                 else np.zeros_like(scale))
        cen_p = orgs + (shift + tab.centroid_p * scale)[None]
        x_p = x + _EVAL_EPS * (cen_p - x)
        return x_m, x_p

    def _face_families(self):
        """(families, number of face slots): every face of the mesh once, in
        families of one tab (:class:`Faces`); the flat face layout is D
        [Sy*Sx] (where the grid has diagonals), V [Sy*(Sx+1)], H
        [(Sy+1)*Sx], crisscross families split by the minus cell's parity
        (the D dofs of odd cells take the anti-diagonal D1 family normal)."""
        sp = self.space
        Sy, Sx, T = self.Sy, self.Sx, sp.T
        gy, gx = (a.ravel() for a in np.meshgrid(np.arange(Sy), np.arange(Sx), indexing="ij"))
        diag = sp.percell or "D" in sp.face_tabs
        offV = Sy * Sx if diag else 0
        offH = offV + Sy * (Sx + 1)
        # (family, plus-cell step, minus cells, slot of each face, boundary side)
        inner = [("V", (0, 1), gx < Sx - 1, offV + gy * (Sx + 1) + gx + 1, None),
                 ("H", (1, 0), gy < Sy - 1, offH + (gy + 1) * Sx + gx, None)]
        bnd = [("V", None, gx == 0, offV + gy * (Sx + 1), "left"),
               ("V", None, gx == Sx - 1, offV + gy * (Sx + 1) + Sx, "right"),
               ("H", None, gy == 0, offH + gx, "bottom"),
               ("H", None, gy == Sy - 1, offH + Sy * Sx + gx, "top")]
        if diag:
            inner.insert(0, ("D", (0, 0), np.ones_like(gx, bool), gy * Sx + gx, None))
        fams = []
        for fam, step, sel, slot, side in inner + bnd:
            for p in ((0, 1) if sp.percell else (None,)):
                m = sel if p is None else sel & ((gy + gx) % 2 == p)
                if not m.any():
                    continue
                key = (fam if side is None else "bnd_" + side) + (
                    "" if p is None else (str(p) if side is None else f"_p{p}"))
                tab = sp.face_tabs[key]
                cy, cx = gy[m], gx[m]
                src_p = (None if step is None else
                         ((cy + step[0]) * Sx + cx + step[1]) * T + tab.tri_p)
                fams.append(Faces(key, side, self.cell_org[cy, cx],
                                  (cy * Sx + cx) * T + tab.tri_m, src_p, slot[m]))
        return fams, offH + (Sy + 1) * Sx

    def tables(self, lam_fns):
        """(gather, jump, coefficients) of every face for the components
        ``lam_fns`` (:meth:`_face_tables`), in the reconstructor's dtype on
        its device, built on first use and kept: ``gather`` [2 E] the
        (minus, plus) cells of each face slot in the cell-by-cell u (-1 on
        the boundary: a zero cell after the last), ``jump`` [E, 2 (nb - 1),
        nqf], ``coefficients`` [Q, E, 2 (nb - 1) + nqf, nm]."""
        key = (tuple(lam_fns), self.dtype, str(self.device))
        got = self._tables.get(key)
        if got is None:
            fams, n = self._face_families()
            src = np.zeros((n, 2), np.int64)
            jump = coef = None
            for f in fams:
                src[f.slot, 0] = f.src_m
                src[f.slot, 1] = -1 if f.src_p is None else f.src_p   # -1: a zero cell
                slot = torch.as_tensor(f.slot, device=self.device)
                for q, lf in enumerate(lam_fns):
                    jf, cf = self._face_tables(f, lf)
                    if coef is None:
                        jump = jf.new_zeros((n,) + jf.shape[1:])
                        coef = cf.new_zeros((len(lam_fns), n) + cf.shape[1:])
                    jump[slot] = jf
                    coef[q, slot] = cf
            got = self._tables[key] = (torch.as_tensor(src.reshape(-1), device=self.device),
                                       jump, coef)
        return got

    def apply_components(self, lam_fns, U):
        """U [..., K, N] -> global RT dofs [Q, ..., N_rt_global], one per
        component of ``lam_fns``: a gather of the cell values, their
        differences and jumps at the face points, and one product with the
        face tables."""
        nb = self.space.nb
        uc = self._u_block_to_cells(U)             # [..., Sy, Sx, T, nb] | [..., Sz, Sy, Sx, nb]
        out_dt = torch.promote_types(uc.dtype, self.dtype)
        lead = uc.shape[:-4]
        src, jump, coef = self.tables(lam_fns)
        ucf = uc.reshape(lead + (-1, nb))
        ucf = torch.cat([ucf, ucf.new_zeros(lead + (1, nb))], -2)
        u2 = ucf[..., src, :].reshape(lead + (-1, 2, nb)).to(out_dt)
        d = (u2[..., 1:] - u2[..., :1]).flatten(-2)                # [..., E, 2 (nb - 1)]
        d0 = u2[..., 0, 0] - u2[..., 1, 0]
        # products and sums over the last axes, not a matmul: a face's dofs
        # round the same whatever the batch around them
        vals = torch.cat([d, d0[..., None] + (d[..., None] * jump.to(out_dt)).sum(-2)], -1)
        coef = coef.to(out_dt)
        coef = coef.reshape(coef.shape[:1] + (1,) * len(lead) + coef.shape[1:])
        t = (vals[..., None] * coef).sum(-2)                         # [Q, ..., E, nm]
        parts = [t.reshape(t.shape[:-2] + (-1,))]
        extra = [self._extra_parts(lf, uc, out_dt) for lf in lam_fns]
        parts += [torch.stack(ps).to(out_dt) for ps in zip(*extra)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def apply_global(self, lam_fn, U):
        """U [..., K, N] -> global RT dofs [..., N_rt_global]."""
        return self.apply_components((lam_fn,), U)[0]

    def restrict(self, t_global):
        """[..., N_rt_global] -> [..., K, N_rt] local RT vectors."""
        return t_global[..., self.rt_l2g]

    def apply(self, lam_fn, U):
        """U [..., K, N] -> [..., K, N_rt] (global reconstruction, restricted)."""
        return self.restrict(self.apply_global(lam_fn, U))
