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
The RT1 reconstruction of order-2 spaces (``ops/rt1.py``) subclasses
:class:`FluxReconstructor`: it changes the moments per edge, the dof layout
and adds interior dofs.
"""
from __future__ import annotations

import numpy as np
import torch

from .assembly import IPDGParams, DEFAULT_IPDG, _EVAL_EPS, tensor


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

    def _face_moment_inner(self, fam, lam_fn, u_m, u_p, x_m, x_p):
        """[..., F, nm] face dofs for a batch of inner faces.
        u_m/u_p: [..., F, nb]; x_m/x_p: [F, nqf, 2] one-sided eval points."""
        sp = self.space
        tab = sp.face_tabs[fam]
        dt = self.dtype
        n = self._t(tab.normal)
        w = self._t(tab.w)
        ell = tab.length
        phi_m, phi_p = self._t(tab.phi_m), self._t(tab.phi_p)
        dphi_m, dphi_p = self._t(tab.dphi_m), self._t(tab.dphi_p)
        x_m, x_p = self._t(x_m), self._t(x_p)
        lam_m = lam_fn(x_m).to(dt)
        lam_p = lam_fn(x_p).to(dt)
        if self.kappa_fn is None:
            delta_m = torch.ones_like(lam_m)
            delta_p = torch.ones_like(lam_p)
            gun_m = torch.einsum("...fj,qja,a->...fq", u_m, dphi_m, n)
            gun_p = torch.einsum("...fj,qja,a->...fq", u_p, dphi_p, n)
        else:
            kap_m = self.kappa_fn(x_m).to(dt)
            kap_p = self.kappa_fn(x_p).to(dt)
            delta_m = torch.einsum("...ab,a,b->...", kap_m, n, n)
            delta_p = torch.einsum("...ab,a,b->...", kap_p, n, n)
            gun_m = torch.einsum("...fj,fqab,qjb,a->...fq", u_m, kap_m, dphi_m, n)
            gun_p = torch.einsum("...fj,fqab,qjb,a->...fq", u_p, kap_p, dphi_p, n)
        ssum = delta_m + delta_p
        nz = ssum != 0
        safe = torch.where(nz, ssum, torch.ones_like(ssum))
        om_m = torch.where(nz, delta_p / safe, torch.full_like(ssum, 0.5))
        om_p = torch.where(nz, delta_m / safe, torch.full_like(ssum, 0.5))
        gamma = torch.where(nz, delta_m * delta_p / safe, torch.zeros_like(ssum))
        pen = (self.ipdg.sigma_inner(sp.order) * gamma
               * (om_m * lam_m + om_p * lam_p) / tab.pen_len ** self.ipdg.beta)
        uv_m = torch.einsum("...fj,qj->...fq", u_m, phi_m)
        uv_p = torch.einsum("...fj,qj->...fq", u_p, phi_p)
        integrand = (-(om_m * lam_m * gun_m + om_p * lam_p * gun_p)
                     + pen * (uv_m - uv_p))
        return self._edge_moments(w, integrand, ell)

    def _face_moment_boundary(self, side, lam_fn, u, x, key=None):
        """[..., F, nm] boundary face dofs in the family-normal convention;
        ``key`` overrides the tab (the crisscross parity tabs)."""
        sp = self.space
        tab = sp.face_tabs[key or ("bnd_" + side)]
        dt = self.dtype
        n_out = self._t(tab.normal)
        w = self._t(tab.w)
        ell = tab.length
        phi = self._t(tab.phi_m)
        dphi = self._t(tab.dphi_m)
        x = self._t(x)
        lam = lam_fn(x).to(dt)
        if self.kappa_fn is None:
            delta = torch.ones_like(lam)
            gun = torch.einsum("...fj,qja,a->...fq", u, dphi, n_out)
        else:
            kap = self.kappa_fn(x).to(dt)
            delta = torch.einsum("...ab,a,b->...", kap, n_out, n_out)
            gun = torch.einsum("...fj,fqab,qjb,a->...fq", u, kap, dphi, n_out)
        pen = (self.ipdg.sigma_boundary(sp.order) * delta * lam
               / tab.pen_len ** self.ipdg.beta)
        uv = torch.einsum("...fj,qj->...fq", u, phi)
        t_dot_nout = self._edge_moments(w, -lam * gun + pen * uv, ell)
        # family normal: V=(1,0), H=(0,1) (3D: X, Y, Z axes); sign +1 where
        # n_out == n_family
        sign = +1.0 if side in ("right", "top", "far") else -1.0
        return sign * t_dot_nout

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

    def apply_global(self, lam_fn, U):
        """U [..., K, N] -> global RT dofs [..., N_rt_global]."""
        sp = self.space
        Sy, Sx, nm, nb = self.Sy, self.Sx, self.nm, sp.nb
        uc = self._u_block_to_cells(U)             # [..., Sy, Sx, T, nb]
        out_dt = torch.promote_types(uc.dtype, self.dtype)
        lead = uc.shape[:-4]
        org = self.cell_org
        phys = self._phys_pts
        if sp.percell:
            return self._apply_global_cc(lam_fn, uc, out_dt)

        parts = []
        if "D" in sp.face_tabs:
            tab = sp.face_tabs["D"]
            x_m, x_p = phys(tab, org.reshape(-1, 2))
            dofD = self._face_moment_inner(
                "D", lam_fn,
                uc[..., tab.tri_m, :].reshape(lead + (Sy * Sx, nb)),
                uc[..., tab.tri_p, :].reshape(lead + (Sy * Sx, nb)),
                x_m, x_p)
            parts.append(dofD.reshape(lead + (-1,)))

        tab = sp.face_tabs["V"]
        dofV = torch.zeros(lead + (Sy, Sx + 1, nm), dtype=out_dt, device=uc.device)
        if Sx > 1:
            x_m, x_p = phys(tab, org[:, :-1].reshape(-1, 2))
            um = uc[..., :, :-1, tab.tri_m, :].reshape(lead + (Sy * (Sx - 1), nb))
            up = uc[..., :, 1:, tab.tri_p, :].reshape(lead + (Sy * (Sx - 1), nb))
            inner = self._face_moment_inner("V", lam_fn, um, up, x_m, x_p)
            dofV[..., :, 1:Sx, :] = inner.reshape(lead + (Sy, Sx - 1, nm))
        tabL = sp.face_tabs["bnd_left"]
        xL, _ = phys(tabL, org[:, 0].reshape(-1, 2))
        uL = uc[..., :, 0, tabL.tri_m, :].reshape(lead + (Sy, nb))
        dofV[..., :, 0, :] = self._face_moment_boundary("left", lam_fn, uL, xL)
        tabR = sp.face_tabs["bnd_right"]
        xR, _ = phys(tabR, org[:, Sx - 1].reshape(-1, 2))
        uR = uc[..., :, Sx - 1, tabR.tri_m, :].reshape(lead + (Sy, nb))
        dofV[..., :, Sx, :] = self._face_moment_boundary("right", lam_fn, uR, xR)
        parts.append(dofV.reshape(lead + (-1,)))

        tab = sp.face_tabs["H"]
        dofH = torch.zeros(lead + (Sy + 1, Sx, nm), dtype=out_dt, device=uc.device)
        if Sy > 1:
            x_m, x_p = phys(tab, org[:-1, :].reshape(-1, 2))
            um = uc[..., :-1, :, tab.tri_m, :].reshape(lead + ((Sy - 1) * Sx, nb))
            up = uc[..., 1:, :, tab.tri_p, :].reshape(lead + ((Sy - 1) * Sx, nb))
            inner = self._face_moment_inner("H", lam_fn, um, up, x_m, x_p)
            dofH[..., 1:Sy, :, :] = inner.reshape(lead + (Sy - 1, Sx, nm))
        tabB = sp.face_tabs["bnd_bottom"]
        xB, _ = phys(tabB, org[0, :].reshape(-1, 2))
        uB = uc[..., 0, :, tabB.tri_m, :].reshape(lead + (Sx, nb))
        dofH[..., 0, :, :] = self._face_moment_boundary("bottom", lam_fn, uB, xB)
        tabT = sp.face_tabs["bnd_top"]
        xT, _ = phys(tabT, org[Sy - 1, :].reshape(-1, 2))
        uT = uc[..., Sy - 1, :, tabT.tri_m, :].reshape(lead + (Sx, nb))
        dofH[..., Sy, :, :] = self._face_moment_boundary("top", lam_fn, uT, xT)
        parts.append(dofH.reshape(lead + (-1,)))
        parts += self._extra_parts(lam_fn, uc, out_dt)
        return torch.cat([p.to(out_dt) for p in parts], dim=-1)

    def _apply_global_cc(self, lam_fn, uc, out_dt):
        """Crisscross face moments: the same integrands with the face
        families split by the minus cell's parity (the D dofs of odd cells
        take the anti-diagonal D1 family normal)."""
        sp = self.space
        nm, Sy, Sx = self.nm, self.Sy, self.Sx
        lead = uc.shape[:-4]
        org = self.cell_org
        dev = uc.device
        gy, gx = np.meshgrid(np.arange(Sy), np.arange(Sx), indexing="ij")
        P = (gy + gx) % 2

        def ix(a):
            return torch.as_tensor(a, device=dev)

        def u_at(cy, cx, t):
            return uc[..., ix(cy), ix(cx), t, :]              # [..., F, nb]

        dofD = torch.zeros(lead + (Sy * Sx, nm), dtype=out_dt, device=dev)
        for p in (0, 1):
            cy, cx = np.nonzero(P == p)
            tab = sp.face_tabs[f"D{p}"]
            x_m, x_p = self._phys_pts(tab, org[cy, cx])
            dofD[..., ix(cy * Sx + cx), :] = self._face_moment_inner(
                f"D{p}", lam_fn, u_at(cy, cx, tab.tri_m), u_at(cy, cx, tab.tri_p),
                x_m, x_p).to(out_dt)
        parts = [dofD.reshape(lead + (-1,))]

        dofV = torch.zeros(lead + (Sy, Sx + 1, nm), dtype=out_dt, device=dev)
        for p in (0, 1):
            cy, cx = np.nonzero((P == p) & (gx < Sx - 1))
            if cy.size:
                tab = sp.face_tabs[f"V{p}"]
                x_m, x_p = self._phys_pts(tab, org[cy, cx])
                dofV[..., ix(cy), ix(cx + 1), :] = self._face_moment_inner(
                    f"V{p}", lam_fn, u_at(cy, cx, tab.tri_m),
                    u_at(cy, cx + 1, tab.tri_p), x_m, x_p).to(out_dt)
        for side, cxv, vxv in (("left", 0, 0), ("right", Sx - 1, Sx)):
            cy_all = np.arange(Sy)
            for p in (0, 1):
                cys = cy_all[(cy_all + cxv) % 2 == p]
                key = f"bnd_{side}_p{p}"
                tab = sp.face_tabs[key]
                x, _ = self._phys_pts(tab, org[cys, cxv])
                dofV[..., ix(cys), vxv, :] = self._face_moment_boundary(
                    side, lam_fn, u_at(cys, np.full_like(cys, cxv), tab.tri_m),
                    x, key=key).to(out_dt)
        parts.append(dofV.reshape(lead + (-1,)))

        dofH = torch.zeros(lead + (Sy + 1, Sx, nm), dtype=out_dt, device=dev)
        for p in (0, 1):
            cy, cx = np.nonzero((P == p) & (gy < Sy - 1))
            if cy.size:
                tab = sp.face_tabs[f"H{p}"]
                x_m, x_p = self._phys_pts(tab, org[cy, cx])
                dofH[..., ix(cy + 1), ix(cx), :] = self._face_moment_inner(
                    f"H{p}", lam_fn, u_at(cy, cx, tab.tri_m),
                    u_at(cy + 1, cx, tab.tri_p), x_m, x_p).to(out_dt)
        for side, cyv, hyv in (("bottom", 0, 0), ("top", Sy - 1, Sy)):
            cx_all = np.arange(Sx)
            for p in (0, 1):
                cxs = cx_all[(cyv + cx_all) % 2 == p]
                key = f"bnd_{side}_p{p}"
                tab = sp.face_tabs[key]
                x, _ = self._phys_pts(tab, org[np.full_like(cxs, cyv), cxs])
                dofH[..., hyv, ix(cxs), :] = self._face_moment_boundary(
                    side, lam_fn, u_at(np.full_like(cxs, cyv), cxs, tab.tri_m),
                    x, key=key).to(out_dt)
        parts.append(dofH.reshape(lead + (-1,)))
        parts += self._extra_parts(lam_fn, uc, out_dt)
        return torch.cat([p.to(out_dt) for p in parts], dim=-1)

    def restrict(self, t_global):
        """[..., N_rt_global] -> [..., K, N_rt] local RT vectors."""
        return t_global[..., self.rt_l2g]

    def apply(self, lam_fn, U):
        """U [..., K, N] -> [..., K, N_rt] (global reconstruction, restricted)."""
        return self.restrict(self.apply_global(lam_fn, U))
