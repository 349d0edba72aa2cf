"""RT1 (first-order Raviart-Thomas) flux space for P2 SWIPDG estimation.

The port of ``pylrbms_tpu/ops/rt1.py``: the OS2015/RS2017 a-posteriori
machinery at polynomial order 2, with the degree-matched flux
reconstruction in RT1 (edge moments against P1(e) of the SWIPDG numerical
flux, interior moments of -lambda kappa grad(u) plus the SIPG jump
lifting).  The tabulations are static float64 numpy, cached on the space;
the products and the reconstruction are torch einsums.

RT1 on a triangle: t(x) = p(x) + x q(x), p in (P1)^2, q in P1-homog; 8 dofs
(family-normal convention, like RT0): per edge m0 = int_e t.n and
m1 = int_e t.n (2 tau - 1), per triangle mi = int_T t.e_i.  On the
rectangle ('quad') RT_[1] = Q_{2,1} x Q_{1,2}: 12 dofs, 2 per edge and 4
interior moments against grad(Q1).  div t is elementwise linear (Q_{1,1}),
so the order-2 nodal basis interpolates it exactly.

Local dof layout per subdomain: the edge dofs first (local RT0 edge e ->
dofs 2e, 2e+1), then ``n_int`` interior dofs per element; the global layout
likewise (the doubled RT0 edge layout, then ``n_int`` dofs per global
element).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import basis as B
from ..quadrature import edge_rule, triangle_rule_unit_cell
from . import assembly as asm
from .assembly import IPDGParams, DEFAULT_IPDG
from .fluxreco import FluxReconstructor
from .spaces import CC_ELEMS


NB_RT1 = 8    # dofs per triangle (RT1 simplex)
NB_RT1Q = 12  # dofs per rectangle (RT_[1] = Q_{2,1} x Q_{1,2})


def _n_int(space) -> int:
    """Interior dofs per element: 2 on triangles, 4 on rectangles."""
    return 4 if space.grid.grid_type == "quad" else 2


def nb_rt1(space) -> int:
    return NB_RT1Q if space.grid.grid_type == "quad" else NB_RT1


# ---------------------------------------------------------------------------
# coefficient bases in physical cell-local coordinates
# ---------------------------------------------------------------------------
def _coeff_basis_vals(x):
    """x [..., 2] -> [..., 8, 2]: the RT1 coefficient basis
    (1,0),(x,0),(y,0),(0,1),(0,x),(0,y),(x^2,xy),(xy,y^2)."""
    xs, ys = x[..., 0], x[..., 1]
    z, o = np.zeros_like(xs), np.ones_like(xs)
    return np.stack([np.stack(p, -1) for p in (
        (o, z), (xs, z), (ys, z), (z, o), (z, xs), (z, ys),
        (xs * xs, xs * ys), (xs * ys, ys * ys))], axis=-2)


def _coeff_basis_div(x):
    """x [..., 2] -> [..., 8] divergences of the coefficient basis."""
    xs, ys = x[..., 0], x[..., 1]
    z, o = np.zeros_like(xs), np.ones_like(xs)
    return np.stack([z, o, z, z, z, o, 3 * xs, 3 * ys], axis=-1)


def _coeff_basis_vals_q(x):
    """Rectangle coefficient basis at x [..., 2] -> [..., 12, 2]: comp-x
    spans {1,x,y,xy,x^2,x^2 y}, comp-y {1,x,y,xy,y^2,x y^2}."""
    xs, ys = x[..., 0], x[..., 1]
    z, o = np.zeros_like(xs), np.ones_like(xs)
    cx = [o, xs, ys, xs * ys, xs * xs, xs * xs * ys]
    cy = [o, xs, ys, xs * ys, ys * ys, xs * ys * ys]
    return np.stack([np.stack([c, z], -1) for c in cx]
                    + [np.stack([z, c], -1) for c in cy], axis=-2)


def _coeff_basis_div_q(x):
    """[..., 12] divergences of the rectangle coefficient basis."""
    xs, ys = x[..., 0], x[..., 1]
    z, o = np.zeros_like(xs), np.ones_like(xs)
    return np.stack([z, o, z, ys, 2 * xs, 2 * xs * ys,
                     z, z, o, xs, 2 * ys, 2 * xs * ys], axis=-1)


def _int_test_basis_q(space, x):
    """Interior test fields of the rectangle at x [..., 2] -> [..., 4, 2]:
    (1,0), (ybar,0), (0,1), (0,xbar) with xbar = 2x/hx - 1, ybar = 2y/hy - 1
    (the span of grad(Q1))."""
    xb = 2 * x[..., 0] / space.hx - 1
    yb = 2 * x[..., 1] / space.hy - 1
    z, o = np.zeros_like(xb), np.ones_like(xb)
    return np.stack([np.stack([o, z], -1), np.stack([yb, z], -1),
                     np.stack([z, o], -1), np.stack([z, xb], -1)], axis=-2)


# ---------------------------------------------------------------------------
# per-element moment matrices and dual-basis tabulation
# ---------------------------------------------------------------------------
def _tri_edge_slots(space):
    """Per element type in {A, B}: 3 (EdgeGeom, normal, length) in the RT0
    incidence slot order of ``tri_face_dofs`` (A: bottom H, right V, diag D;
    B: left V, top H, diag D)."""
    slot_fams = {"A": ("H", "V", "D"), "B": ("V", "H", "D")}
    out = {}
    for name in ("A", "B"):
        slots = []
        for fam in slot_fams[name]:
            (tm, em), (tp, ep) = B.EDGES_UNIT[fam]
            tab = space.face_tabs[fam]
            slots.append((em if tm == name else ep, np.asarray(tab.normal),
                          float(tab.length)))
        out[name] = slots
    return out


def _cc_edge_slots(space):
    """Crisscross: per element type in {A, B, C, E}, slot k = local edge k
    (the incidence order of ``cc_face_dofs``)."""
    out = {name: [None] * 3 for name in ("A", "B", "C", "E")}
    for fam, ((tm, em), (tp, ep)) in B.CC_EDGES_UNIT.items():
        km, kp = B.CC_FACE_LOCAL_EDGE[fam]
        tab = space.face_tabs[fam]
        n, ell = np.asarray(tab.normal), float(tab.length)
        out[tm][km] = (em, n, ell)
        out[tp][kp] = (ep, n, ell)
    assert all(all(s is not None for s in v) for v in out.values())
    return out


def _quad_edge_slots(space):
    """Rectangle: 4 slots in the ``quad_face_dofs`` order [left V, right V,
    bottom H, top H]."""
    (_, vm_e), (_, vp_e) = B.QUAD_EDGES_UNIT["V"]
    (_, hm_e), (_, hp_e) = B.QUAD_EDGES_UNIT["H"]
    tV, tH = space.face_tabs["V"], space.face_tabs["H"]
    nV, lV = np.asarray(tV.normal), float(tV.length)
    nH, lH = np.asarray(tH.normal), float(tH.length)
    return [(vp_e, nV, lV), (vm_e, nV, lV), (hp_e, nH, lH), (hm_e, nH, lH)]


def _edge_rows(space, slots, vals_fn, nf):
    """The 2 edge-moment rows per slot of the moment matrix [nf, nf]."""
    scale = np.array([space.hx, space.hy])
    tau, wf = edge_rule(space._face_quad)
    M = np.zeros((nf, nf))
    for k, (geom, n, ell) in enumerate(slots):
        Vn = vals_fn(geom.points(tau) * scale) @ n
        M[2 * k] = ell * np.einsum("q,qc->c", wf, Vn)
        M[2 * k + 1] = ell * np.einsum("q,q,qc->c", wf, 2 * tau - 1, Vn)
    return M


def _moment_dual(space, slots, qp_unit, vol_w):
    """(Minv, chi [nq, 8, 2], div [nq, 8]) of one triangle type with
    unit-cell quadrature ``qp_unit`` [nq, 2] and weights ``vol_w``."""
    area = space.hx * space.hy
    M = _edge_rows(space, slots, _coeff_basis_vals, NB_RT1)
    qp = qp_unit * np.array([space.hx, space.hy])
    Vq = _coeff_basis_vals(qp)                           # [nq, 8, 2]
    M[6] = area * np.einsum("q,qc->c", vol_w, Vq[..., 0])
    M[7] = area * np.einsum("q,qc->c", vol_w, Vq[..., 1])
    Minv = np.linalg.inv(M)
    return (Minv, np.einsum("qca,cj->qja", Vq, Minv),
            np.einsum("qc,cj->qj", _coeff_basis_div(qp), Minv))


def _moment_dual_q(space, qp_unit, vol_w):
    """(Minv [12, 12], chi [nq, 12, 2], div [nq, 12]) of the rectangle."""
    area = space.hx * space.hy
    M = _edge_rows(space, _quad_edge_slots(space), _coeff_basis_vals_q, NB_RT1Q)
    qp = qp_unit * np.array([space.hx, space.hy])
    Vq = _coeff_basis_vals_q(qp)                         # [nq, 12, 2]
    R = _int_test_basis_q(space, qp)                     # [nq, 4, 2]
    for j in range(4):
        M[8 + j] = area * np.einsum("q,qca,qa->c", vol_w, Vq, R[:, j])
    Minv = np.linalg.inv(M)
    return (Minv, np.einsum("qca,cj->qja", Vq, Minv),
            np.einsum("qc,cj->qj", _coeff_basis_div_q(qp), Minv))


def rt1_cell_tab(space):
    """(chi1 [T, nq, nf, 2], idx1 [s, s, T, nf], div1 [T, nq, nf]) — the
    values / divergences of the moment-dual RT1 basis at the volume
    quadrature points (per-cell [s, s, T, ...] on 'crisscross'), and the
    local dof of every element slot.  Cached on the space (with the moment
    inverses in ``space._rt1_minv``)."""
    tab = getattr(space, "_rt1_tab", None)
    if tab is not None:
        return tab
    gt = space.grid.grid_type
    s, T = space.s, space.T
    ni = _n_int(space)
    if gt == "quad":
        Minv, chi, div = _moment_dual_q(space, space.vol_qp[0], space.vol_w[0])
        chi1, div1 = chi[None], div[None]
        space._rt1_minv = Minv[None]
        idx0 = space.quad_face_dofs()                    # [s, s, 1, 4]
    elif gt == "tri":
        slots = _tri_edge_slots(space)
        duals = [_moment_dual(space, slots[name], space.vol_qp[ti], space.vol_w[ti])
                 for ti, name in enumerate(("A", "B"))]
        space._rt1_minv = np.stack([d[0] for d in duals])
        chi1 = np.stack([d[1] for d in duals])           # [T, nq, 8, 2]
        div1 = np.stack([d[2] for d in duals])           # [T, nq, 8]
        idx0 = space.tri_face_dofs()[0]                  # [s, s, T, 3]
    else:
        # crisscross: 4 element types on the parity checkerboard, gathered
        # per cell like the space's own volume tables
        slots = _cc_edge_slots(space)
        duals = []
        for elems in CC_ELEMS:                           # parity 0, 1
            duals.append([_moment_dual(space, slots[el],
                                       *triangle_rule_unit_cell(el, space._vol_quad))
                          for el in elems])              # t = 0, 1
        par = space.cell_parity
        space._rt1_minv = np.stack([[d[0] for d in p] for p in duals])   # [2, T, 8, 8]
        chi1 = np.stack([[d[1] for d in p] for p in duals])[par]         # [s,s,T,nq,8,2]
        div1 = np.stack([[d[2] for d in p] for p in duals])[par]         # [s,s,T,nq,8]
        idx0 = space.cc_face_dofs()[0]                   # [s, s, T, 3]
    ne = idx0.shape[-1]
    idx1 = np.zeros((s, s, T, 2 * ne + ni), dtype=np.int64)
    idx1[..., 0:2 * ne:2] = 2 * idx0
    idx1[..., 1:2 * ne:2] = 2 * idx0 + 1
    cy, cx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    elem = (cy * s + cx)[:, :, None] * T + np.arange(T)[None, None, :]
    for j in range(ni):
        idx1[..., 2 * ne + j] = 2 * space.N_rt + ni * elem + j
    space._rt1_tab = (chi1, idx1, div1)
    return space._rt1_tab


def N_rt1(space) -> int:
    return 2 * space.N_rt + _n_int(space) * space.s * space.s * space.T


def N_rt1_global(space) -> int:
    g = space.grid
    return 2 * space.N_rt_global + _n_int(space) * g.global_ny * g.global_nx * space.T


def rt1_local_to_global(space) -> np.ndarray:
    """[K, N_rt1] flat indices into the flattened global RT1 vector."""
    g = space.grid
    s, T = space.s, space.T
    Sx = g.global_nx
    l2g0 = space.rt_local_to_global()                    # [K, N_rt] edges
    out = np.zeros((space.K, N_rt1(space)), dtype=np.int64)
    out[:, 0:2 * space.N_rt:2] = 2 * l2g0
    out[:, 1:2 * space.N_rt:2] = 2 * l2g0 + 1
    off = 2 * space.N_rt_global
    ni = _n_int(space)
    cy, cx, tt = np.meshgrid(np.arange(s), np.arange(s), np.arange(T), indexing="ij")
    loc = (2 * space.N_rt + ni * ((cy * s + cx) * T + tt)).ravel()
    for ii in range(space.K):
        sx, sy = g.subdomain_coords(ii)
        ge = (((sy * s + cy) * Sx + (sx * s + cx)) * T + tt).ravel()
        for j in range(ni):
            out[ii, loc + j] = off + ni * ge + j
    return out


# ---------------------------------------------------------------------------
# products over RT1 (dispatched from ops/products.py by space.order)
# ---------------------------------------------------------------------------
def df_bb_rt1(space, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N_rt1, N_rt1]: int t . (lam_hat kappa)^{-1} s over the subdomain."""
    from .products import _kinv_fn
    chi, idx, _div = rt1_cell_tab(space)
    nf = idx.shape[-1]
    xq = asm.tensor(asm.vol_points(space), dtype, device)
    Ki = _kinv_fn(lam_hat, kappa_fn)(xq).to(dtype)
    w = asm.tensor(space.vol_w, dtype, device)
    chi_j = asm.tensor(chi, dtype, device)
    blocks = space.hx * space.hy * torch.einsum(
        asm.vol_ein(space, "tq,tqea,kyxtqab,tqfb->kyxtef"), w, chi_j, Ki, chi_j)
    F = space.s * space.s * space.T
    rows = idx.reshape(F, nf)
    A = torch.zeros((space.K, N_rt1(space), N_rt1(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(space.K, F, nf, nf), rows, rows)


def df_ab_rt1(space, lam_v, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N, N_rt1]: int (lam_v / lam_hat) grad(phi_i) . chi1_e."""
    chi, idx, _div = rt1_cell_tab(space)
    nf = idx.shape[-1]
    xq = asm.tensor(asm.vol_points(space), dtype, device)
    wgt = (lam_v(xq) / lam_hat(xq)).to(dtype)
    w = asm.tensor(space.vol_w, dtype, device)
    dphi = asm.tensor(space.vol_dphi, dtype, device)
    blocks = space.hx * space.hy * torch.einsum(
        asm.vol_ein(space, "tq,kyxtq,tqia,tqea->kyxtie"), w, wgt, dphi,
        asm.tensor(chi, dtype, device))
    F = space.s * space.s * space.T
    rows = np.arange(space.N, dtype=np.int64).reshape(F, space.nb)
    A = torch.zeros((space.K, space.N, N_rt1(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(space.K, F, space.nb, nf),
                              rows, idx.reshape(F, nf))


def divergence_matrix_rt1(space, dtype=torch.float64, device=None):
    """[N, N_rt1]: RT1 coefficients -> DG nodal coefficients of div t
    (exact: div t is elementwise linear)."""
    _chi, idx, _div = rt1_cell_tab(space)
    nf = idx.shape[-1]
    nodes = space.nodes_unit * np.array([space.hx, space.hy])
    F = space.s * space.s * space.T
    if space.percell:                                    # crisscross
        Minv = space._rt1_minv[space.cell_parity]        # [s, s, T, 8, 8]
        blocks = np.einsum("yxtic,yxtcj->yxtij", _coeff_basis_div(nodes), Minv)
    else:
        divf = _coeff_basis_div_q if space.grid.grid_type == "quad" else _coeff_basis_div
        blocks = np.broadcast_to(
            np.einsum("tic,tcj->tij", divf(nodes), space._rt1_minv)[None],
            (space.s * space.s, space.T, space.nb, nf))
    rows = np.arange(space.N, dtype=np.int64).reshape(F, space.nb)
    A = torch.zeros((space.N, N_rt1(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, asm.tensor(blocks.reshape(F, space.nb, nf), dtype, device),
                              rows, idx.reshape(F, nf))


def rt_tab_any_order(space):
    """(chi, idx, div_q, n_rt_local): the RT cell tabulation of the space's
    matching flux order (RT0 for order 1, RT1 for order 2), with the
    divergence given at the quadrature points."""
    if space.order == 1:
        chi, idx, div = space.rt_cell_tab()
        nq = chi.shape[-3]
        # div [T, nf] | percell [s, s, T, nf]
        div_q = np.broadcast_to(div[..., None, :], div.shape[:-1] + (nq, div.shape[-1]))
        return chi, idx, div_q, space.N_rt
    chi, idx, div_q = rt1_cell_tab(space)
    return chi, idx, div_q, N_rt1(space)


# ---------------------------------------------------------------------------
# RT1 flux reconstruction
# ---------------------------------------------------------------------------
class FluxReconstructorRT1(FluxReconstructor):
    """t_q in RT1 from a P2 DG u: per face the two moments of the SWIPDG
    numerical flux against {1, 2 tau - 1}, per element the interior moments
    of -lam kappa grad(u) plus the SIPG jump lifting (which makes div t
    equal Pi_1 f up to data oscillation: without it the residual indicator
    loses one order)."""

    nm = 2
    required_order = 2

    def __init__(self, space, kappa_fn=None, ipdg: IPDGParams = DEFAULT_IPDG,
                 dtype=torch.float64, device=None):
        super().__init__(space, kappa_fn, ipdg, dtype, device)
        rt1_cell_tab(space)

    def _local_to_global(self, space):
        return rt1_local_to_global(space)

    def _edge_moments(self, w, integrand, ell):
        tau = self._t(self.space.face_t).to(integrand.dtype)
        wj = w.to(integrand.dtype)
        W = torch.stack([wj, wj * (2 * tau - 1)])          # [2, nqf]
        return ell * torch.einsum("mq,...fq->...fm", W, integrand)

    # -- SIPG jump lifting ---------------------------------------------
    def _omega(self, tab, x_m, x_p):
        """(om_m, om_p, kn_m, kn_p): the face weights and kappa n per side
        (kappa = I: 1/2 and n)."""
        n = self._t(tab.normal)
        if self.kappa_fn is None:
            return 0.5, 0.5, n, n
        kap_m = self.kappa_fn(x_m).to(self.dtype)
        kap_p = self.kappa_fn(x_p).to(self.dtype)
        delta_m = torch.einsum("...ab,a,b->...", kap_m, n, n)
        delta_p = torch.einsum("...ab,a,b->...", kap_p, n, n)
        ssum = delta_m + delta_p
        nz = ssum != 0
        safe = torch.where(nz, ssum, torch.ones_like(ssum))
        om_m = torch.where(nz, delta_p / safe, torch.full_like(ssum, 0.5))
        om_p = torch.where(nz, delta_m / safe, torch.full_like(ssum, 0.5))
        return (om_m, om_p, torch.einsum("...ab,b->...a", kap_m, n),
                torch.einsum("...ab,b->...a", kap_p, n))

    def _lift_terms(self, wq, ell, weighted_jump, kn, R):
        """ell int_e weighted_jump (kappa r_j).n ds -> [..., F, n_int]; kn is
        n (kappa = I, [2]) or kappa n per point [F, nqf, 2]; R the interior
        test fields along the edge [nqf, n_int, 2] (None: e_0, e_1)."""
        if kn.ndim == 1:
            if R is None:
                return ell * torch.einsum("q,...fq,a->...fa", wq, weighted_jump, kn)
            return ell * torch.einsum("q,...fq,qj->...fj", wq, weighted_jump,
                                      self._t(R) @ kn)
        if R is None:
            return ell * torch.einsum("q,...fq,fqa->...fa", wq, weighted_jump, kn)
        Rn = torch.einsum("qja,fqa->fqj", self._t(R), kn)
        return ell * torch.einsum("q,...fq,fqj->...fj", wq, weighted_jump, Rn)

    def _lift_inner(self, lam_fn, tab, x_m, x_p, u_m, u_p, R_m=None, R_p=None):
        """(corr_minus, corr_plus) [..., F, n_int]: per side
        omega_T int_e lam_T [u] (kappa_T r_j).n_e ds."""
        x_m, x_p = self._t(x_m), self._t(x_p)
        wq = self._t(tab.w)
        jump = (torch.einsum("...fj,qj->...fq", u_m, self._t(tab.phi_m))
                - torch.einsum("...fj,qj->...fq", u_p, self._t(tab.phi_p)))
        lam_m = lam_fn(x_m).to(self.dtype)
        lam_p = lam_fn(x_p).to(self.dtype)
        om_m, om_p, kn_m, kn_p = self._omega(tab, x_m, x_p)
        return (self._lift_terms(wq, tab.length, om_m * lam_m * jump, kn_m, R_m),
                self._lift_terms(wq, tab.length, om_p * lam_p * jump, kn_p, R_p))

    def _lift_boundary(self, lam_fn, tab, x, u, R=None):
        """[..., F, n_int]: the full-weight boundary lifting
        int_e lam u (kappa r_j).n_out ds (all-Dirichlet, g = 0)."""
        x = self._t(x)
        n_out = self._t(tab.normal)
        uv = torch.einsum("...fj,qj->...fq", u, self._t(tab.phi_m))
        lam = lam_fn(x).to(self.dtype)
        kn = (n_out if self.kappa_fn is None else
              torch.einsum("...ab,b->...a", self.kappa_fn(x).to(self.dtype), n_out))
        return self._lift_terms(self._t(tab.w), tab.length, lam * uv, kn, R)

    def _extra_parts(self, lam_fn, uc, out_dt):
        """Interior moments m_i = -int_T lam kappa grad(u) . r_i dx plus the
        jump lifting of every face of T."""
        sp = self.space
        g = sp.grid
        lead = uc.shape[:-4]
        scale = np.array([sp.hx, sp.hy])
        area = sp.hx * sp.hy
        org = self._t(self.cell_org)                        # [Sy, Sx, 2]
        if sp.percell:
            # tile the subdomain-parity tables over the subdomain grid (s is
            # even, so the parity lines up)
            qp = self._t(np.tile(sp.vol_qp, (g.ky, g.kx, 1, 1, 1)) * scale)
            xq = org[:, :, None, None, :] + qp              # [Sy,Sx,T,nq,2]
            w = self._t(np.tile(sp.vol_w, (g.ky, g.kx, 1, 1)))
            dphi = self._t(np.tile(sp.vol_dphi, (g.ky, g.kx, 1, 1, 1, 1)))
            gu = torch.einsum("...yxtj,yxtqja->...yxtqa", uc, dphi)
            wexpr = "yxtq,yxtq,...yxtqa->...yxta"
        else:
            xq = org[:, :, None, None, :] + self._t(sp.vol_qp * scale)[None, None]
            w = self._t(sp.vol_w)
            gu = torch.einsum("...yxtj,tqja->...yxtqa", uc, self._t(sp.vol_dphi))
            wexpr = "tq,yxtq,...yxtqa->...yxta"
        lam = lam_fn(xq).to(self.dtype)
        if self.kappa_fn is not None:
            gu = torch.einsum("yxtqab,...yxtqb->...yxtqa",
                              self.kappa_fn(xq).to(self.dtype), gu)
        if g.grid_type == "quad":
            R = self._t(_int_test_basis_q(sp, sp.vol_qp[0] * scale))
            m = -area * torch.einsum("tq,yxtq,...yxtqa,qja->...yxtj", w, lam, gu, R)
            m = m + self._lift_quad(lam_fn, uc, m.dtype)
        else:
            m = -area * torch.einsum(wexpr, w, lam, gu)
            m = m + (self._lift_cc if sp.percell else self._lift_tri)(lam_fn, uc, m.dtype)
        return [m.reshape(lead + (-1,)).to(out_dt)]

    def _lift_tri(self, lam_fn, uc, mdt):
        sp = self.space
        lead = uc.shape[:-4]
        Sy, Sx, nb = self.Sy, self.Sx, sp.nb
        corr = torch.zeros(lead + (Sy, Sx, sp.T, 2), dtype=mdt, device=uc.device)
        org = self.cell_org

        # D: minus = (cell, A), plus = (cell, B)
        tab = sp.face_tabs["D"]
        x_m, x_p = self._phys_pts(tab, org.reshape(-1, 2))
        cm, cp = self._lift_inner(
            lam_fn, tab, x_m, x_p,
            uc[..., tab.tri_m, :].reshape(lead + (Sy * Sx, nb)),
            uc[..., tab.tri_p, :].reshape(lead + (Sy * Sx, nb)))
        corr[..., tab.tri_m, :] += cm.reshape(lead + (Sy, Sx, 2))
        corr[..., tab.tri_p, :] += cp.reshape(lead + (Sy, Sx, 2))
        # V: minus = (cy, cx, A), plus = (cy, cx+1, B)
        if Sx > 1:
            tab = sp.face_tabs["V"]
            x_m, x_p = self._phys_pts(tab, org[:, :-1].reshape(-1, 2))
            F = Sy * (Sx - 1)
            cm, cp = self._lift_inner(
                lam_fn, tab, x_m, x_p,
                uc[..., :, :-1, tab.tri_m, :].reshape(lead + (F, nb)),
                uc[..., :, 1:, tab.tri_p, :].reshape(lead + (F, nb)))
            corr[..., :, :-1, tab.tri_m, :] += cm.reshape(lead + (Sy, Sx - 1, 2))
            corr[..., :, 1:, tab.tri_p, :] += cp.reshape(lead + (Sy, Sx - 1, 2))
        # H: minus = (cy, cx, B), plus = (cy+1, cx, A)
        if Sy > 1:
            tab = sp.face_tabs["H"]
            x_m, x_p = self._phys_pts(tab, org[:-1, :].reshape(-1, 2))
            F = (Sy - 1) * Sx
            cm, cp = self._lift_inner(
                lam_fn, tab, x_m, x_p,
                uc[..., :-1, :, tab.tri_m, :].reshape(lead + (F, nb)),
                uc[..., 1:, :, tab.tri_p, :].reshape(lead + (F, nb)))
            corr[..., :-1, :, tab.tri_m, :] += cm.reshape(lead + (Sy - 1, Sx, 2))
            corr[..., 1:, :, tab.tri_p, :] += cp.reshape(lead + (Sy - 1, Sx, 2))
        for side, orgs, pos in (("left", org[:, 0], (slice(None), 0)),
                                ("right", org[:, Sx - 1], (slice(None), Sx - 1)),
                                ("bottom", org[0, :], (0, slice(None))),
                                ("top", org[Sy - 1, :], (Sy - 1, slice(None)))):
            tb = sp.face_tabs["bnd_" + side]
            x, _ = self._phys_pts(tb, orgs)
            sel = (Ellipsis,) + pos + (tb.tri_m, slice(None))
            u = uc[sel]                                      # [..., F, nb]
            corr[sel] += self._lift_boundary(lam_fn, tb, x, u)
        return corr

    def _lift_cc(self, lam_fn, uc, mdt):
        """Crisscross lifting: the 6 parity-split interior families and the
        per-parity boundary groups (the face enumeration of
        :meth:`FluxReconstructor._face_families`)."""
        sp = self.space
        lead = uc.shape[:-4]
        Sy, Sx = self.Sy, self.Sx
        dev = uc.device
        corr = torch.zeros(lead + (Sy, Sx, sp.T, 2), dtype=mdt, device=dev)
        org = self.cell_org
        gy, gx = np.meshgrid(np.arange(Sy), np.arange(Sx), indexing="ij")
        P = (gy + gx) % 2

        def ix(a):
            return torch.as_tensor(a, device=dev)

        def u_at(cy, cx, t):
            return uc[..., ix(cy), ix(cx), t, :]

        def add(cy, cx, t, c):
            corr[..., ix(cy), ix(cx), t, :] += c

        for p in (0, 1):
            for fam, (cy, cx), (dy, dx) in (
                    ("D", np.nonzero(P == p), (0, 0)),
                    ("V", np.nonzero((P == p) & (gx < Sx - 1)), (0, 1)),
                    ("H", np.nonzero((P == p) & (gy < Sy - 1)), (1, 0))):
                if not cy.size:
                    continue
                tab = sp.face_tabs[f"{fam}{p}"]
                x_m, x_p = self._phys_pts(tab, org[cy, cx])
                cm, cp = self._lift_inner(lam_fn, tab, x_m, x_p,
                                          u_at(cy, cx, tab.tri_m),
                                          u_at(cy + dy, cx + dx, tab.tri_p))
                add(cy, cx, tab.tri_m, cm)
                add(cy + dy, cx + dx, tab.tri_p, cp)
        for side, (cy_all, cx_all) in (
                ("left", (np.arange(Sy), np.zeros(Sy, np.int64))),
                ("right", (np.arange(Sy), np.full(Sy, Sx - 1, np.int64))),
                ("bottom", (np.zeros(Sx, np.int64), np.arange(Sx))),
                ("top", (np.full(Sx, Sy - 1, np.int64), np.arange(Sx)))):
            for p in (0, 1):
                msk = (cy_all + cx_all) % 2 == p
                cys, cxs = cy_all[msk], cx_all[msk]
                if not cys.size:
                    continue
                tab = sp.face_tabs[f"bnd_{side}_p{p}"]
                x, _ = self._phys_pts(tab, org[cys, cxs])
                add(cys, cxs, tab.tri_m,
                    self._lift_boundary(lam_fn, tab, x, u_at(cys, cxs, tab.tri_m)))
        return corr

    def _lift_quad(self, lam_fn, uc, mdt):
        """Rectangle lifting: V/H interior families and the 4 boundary
        sides, with the interior test fields (grad Q1 span) at the per-side
        cell-local edge points."""
        sp = self.space
        lead = uc.shape[:-4]
        Sy, Sx, nb = self.Sy, self.Sx, sp.nb
        scale = np.array([sp.hx, sp.hy])
        tau, _ = edge_rule(sp._face_quad)
        corr = torch.zeros(lead + (Sy, Sx, 1, 4), dtype=mdt, device=uc.device)
        org = self.cell_org

        def R_of(geom):
            return _int_test_basis_q(sp, geom.points(tau) * scale)

        # V: minus = (cy, cx) right edge, plus = (cy, cx+1) left edge
        if Sx > 1:
            (_, em), (_, ep) = B.QUAD_EDGES_UNIT["V"]
            tab = sp.face_tabs["V"]
            x_m, x_p = self._phys_pts(tab, org[:, :-1].reshape(-1, 2))
            F = Sy * (Sx - 1)
            cm, cp = self._lift_inner(
                lam_fn, tab, x_m, x_p,
                uc[..., :, :-1, 0, :].reshape(lead + (F, nb)),
                uc[..., :, 1:, 0, :].reshape(lead + (F, nb)),
                R_m=R_of(em), R_p=R_of(ep))
            corr[..., :, :-1, 0, :] += cm.reshape(lead + (Sy, Sx - 1, 4))
            corr[..., :, 1:, 0, :] += cp.reshape(lead + (Sy, Sx - 1, 4))
        # H: minus = (cy, cx) top edge, plus = (cy+1, cx) bottom edge
        if Sy > 1:
            (_, em), (_, ep) = B.QUAD_EDGES_UNIT["H"]
            tab = sp.face_tabs["H"]
            x_m, x_p = self._phys_pts(tab, org[:-1, :].reshape(-1, 2))
            F = (Sy - 1) * Sx
            cm, cp = self._lift_inner(
                lam_fn, tab, x_m, x_p,
                uc[..., :-1, :, 0, :].reshape(lead + (F, nb)),
                uc[..., 1:, :, 0, :].reshape(lead + (F, nb)),
                R_m=R_of(em), R_p=R_of(ep))
            corr[..., :-1, :, 0, :] += cm.reshape(lead + (Sy - 1, Sx, 4))
            corr[..., 1:, :, 0, :] += cp.reshape(lead + (Sy - 1, Sx, 4))
        for side, orgs, pos in (("left", org[:, 0], (slice(None), 0)),
                                ("right", org[:, Sx - 1], (slice(None), Sx - 1)),
                                ("bottom", org[0, :], (0, slice(None))),
                                ("top", org[Sy - 1, :], (Sy - 1, slice(None)))):
            tb = sp.face_tabs["bnd_" + side]
            _, geom = B.QUAD_BOUNDARY_EDGES_UNIT[side]
            x, _ = self._phys_pts(tb, orgs)
            sel = (Ellipsis,) + pos + (0, slice(None))
            corr[sel] += self._lift_boundary(lam_fn, tb, x, uc[sel], R=R_of(geom))
        return corr
