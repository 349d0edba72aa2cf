"""RT_[1] hex flux space for Q2 SWIPDG estimation in 3D.

The port of ``pylrbms_tpu/ops/rt1hex.py`` (the moment-dual tables are the
same float64 numpy; the products and the reconstruction are torch).

3D counterpart of the rectangle RT_[1] machinery in ``ops/rt1.py`` (beyond
the reference, whose estimator pipeline is 2D P1/RT0-only): the tensor
Raviart-Thomas space on boxes

  RT_[1](H) = Q_{2,1,1} x Q_{1,2,1} x Q_{1,1,2},   dim 36,

with the Ern/Vohralik degree-matched moments:

* per face (6 faces, family parametrization (u, v), family normal n):
  the FOUR moments of t.n against Q_{1,1}(face) = {1, 2u-1, 2v-1,
  (2u-1)(2v-1)} — t.n restricted to a face lies in Q_{1,1}(face), so the
  moments pin the trace exactly and the global space is H(div)-conforming;
* per cell: the TWELVE interior moments against the span of grad(Q1(hex))
  = { (q(ybar, zbar), 0, 0) : q in Q_{1,1} } (+ y/z rotations) — exactly
  the 3D analog of the rectangle's grad(Q1) interior fields, which is what
  the SIPG jump lifting needs for a second-order eta_r
  (``FluxReconstructorRT1._extra_parts`` docstring).

div t lies in Q_{1,1,1} and is interpolated EXACTLY by the Q2 nodal basis
(divergence_matrix_rt1hex).  Everything is a cell-invariant tabulation (one
element type on the structured hex grid) contracted with batched einsums —
same design as RT0 (``spaces3d.rt_cell_tab`` / ``fluxreco3d``).

Local dof layout per subdomain: face dofs first (local RT0 face f ->
dofs 4f..4f+3), then 12 interior dofs per cell
(4*N_rt + 12*((cz*s+cy)*s+cx) + j).  Global layout likewise: quadrupled
RT0 face layout (X/Y/Z flat order of ``spaces3d.rt_local_to_global``)
followed by 12 dofs per global cell.
"""
from __future__ import annotations

import numpy as np
import torch

from .spaces3d import BlockDGSpace3D, SIDES3D, _face_pts_unit
from . import assembly as asm
from . import assembly3d as asm3
from .assembly import IPDGParams, DEFAULT_IPDG, tensor
from .fluxreco3d import FluxReconstructor3D
from .rt1 import FluxReconstructorRT1

NB_RT1H = 36   # dofs per hex
N_INT_H = 12   # interior dofs per hex
NM_FACE = 4    # face moments

# coefficient basis: for each component axis, the 12 monomials
# x_axis^a * x_b^eb * x_c^ec with a <= 2, eb, ec <= 1 (b, c the other axes)
_EXPS = []
for _axis in range(3):
    for _a in range(3):
        for _eb in range(2):
            for _ec in range(2):
                e = [0, 0, 0]
                e[_axis] = _a
                e[(_axis + 1) % 3] = _eb
                e[(_axis + 2) % 3] = _ec
                _EXPS.append((_axis, tuple(e)))
assert len(_EXPS) == NB_RT1H


def _pow(xs, e):
    m = np.ones(np.broadcast(*xs).shape)
    for d in range(3):
        if e[d]:
            m = m * xs[d] ** e[d]
    return m


def _coeff_basis_vals_h(x):
    """x [..., 3] -> [..., 36, 3] values of the RT_[1] coefficient basis."""
    xs = (x[..., 0], x[..., 1], x[..., 2])
    V = np.zeros(x.shape[:-1] + (NB_RT1H, 3))
    for ci, (axis, e) in enumerate(_EXPS):
        V[..., ci, axis] = _pow(xs, e)
    return V


def _coeff_basis_div_h(x):
    """x [..., 3] -> [..., 36] divergences of the coefficient basis."""
    xs = (x[..., 0], x[..., 1], x[..., 2])
    D = np.zeros(x.shape[:-1] + (NB_RT1H,))
    for ci, (axis, e) in enumerate(_EXPS):
        if e[axis] == 0:
            continue
        de = list(e)
        de[axis] -= 1
        D[..., ci] = e[axis] * _pow(xs, tuple(de))
    return D


def _int_test_basis_h(space, x):
    """Interior test fields at x [..., 3] -> [..., 12, 3]: for each axis the
    four fields q(bbar, cbar) e_axis with q in {1, bbar, cbar, bbar*cbar}
    and centered coords bbar = 2 x_b / h_b - 1 — the span of grad(Q1)."""
    h = (space.hx, space.hy, space.hz)
    xb = [2 * x[..., d] / h[d] - 1 for d in range(3)]
    R = np.zeros(x.shape[:-1] + (N_INT_H, 3))
    j = 0
    for axis in range(3):
        b, c = (axis + 1) % 3, (axis + 2) % 3
        for q in (np.ones_like(xb[0]), xb[b], xb[c], xb[b] * xb[c]):
            R[..., j, axis] = q
            j += 1
    return R


# face slot order of spaces3d.hex_face_dofs: (xlo, xhi, ylo, yhi, zlo, zhi)
_FACE_SLOTS = (("X", 0.0), ("X", 1.0), ("Y", 0.0), ("Y", 1.0),
               ("Z", 0.0), ("Z", 1.0))


def _face_weights(space):
    """[4, nqf] moment weight functions {1, 2u-1, 2v-1, (2u-1)(2v-1)} times
    the face quadrature weights."""
    uv = space.face_uv
    w = np.asarray(space.face_tabs["X"].w)
    a, b = 2 * uv[:, 0] - 1, 2 * uv[:, 1] - 1
    return np.stack([w, w * a, w * b, w * a * b])


def _moment_dual_h(space):
    """(Minv [36, 36], chi [nq, 36, 3], div [nq, 36]) of the moment-dual
    basis on the (cell-invariant) physical hex."""
    scale = np.array([space.hx, space.hy, space.hz])
    V = space.volume
    W = _face_weights(space)                                  # [4, nqf]
    M = np.zeros((NB_RT1H, NB_RT1H))
    naxis = {"X": np.array([1.0, 0, 0]), "Y": np.array([0, 1.0, 0]),
             "Z": np.array([0, 0, 1.0])}
    for k, (fam, c01) in enumerate(_FACE_SLOTS):
        xe = _face_pts_unit(fam, space.face_uv, c01) * scale  # [nqf, 3]
        area = float(space.face_tabs[fam].length)
        Vn = _coeff_basis_vals_h(xe) @ naxis[fam]             # [nqf, 36]
        M[4 * k:4 * k + 4] = area * np.einsum("mq,qc->mc", W, Vn)
    qp_phys = space.vol_qp * scale
    Vq = _coeff_basis_vals_h(qp_phys)                         # [nq, 36, 3]
    R = _int_test_basis_h(space, qp_phys)                     # [nq, 12, 3]
    M[24:] = V * np.einsum("q,qca,qja->jc", space.vol_w, Vq, R)
    Minv = np.linalg.inv(M)
    chi = np.einsum("qca,cj->qja", Vq, Minv)
    div = np.einsum("qc,cj->qj", _coeff_basis_div_h(qp_phys), Minv)
    return Minv, chi, div


def rt1hex_cell_tab(space: BlockDGSpace3D):
    """(chi [nq, 36, 3], idx [s, s, s, 36], div [nq, 36]); cached."""
    tab = getattr(space, "_rt1h_tab", None)
    if tab is not None:
        return tab
    s = space.s
    Minv, chi, div = _moment_dual_h(space)
    space._rt1h_minv = Minv
    idx0 = space.hex_face_dofs()[..., 0, :]                   # [s, s, s, 6]
    idx1 = np.zeros((s, s, s, NB_RT1H), dtype=np.int64)
    for k in range(6):
        for m in range(NM_FACE):
            idx1[..., 4 * k + m] = 4 * idx0[..., k] + m
    cz, cy, cx = np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                             indexing="ij")
    elem = (cz * s + cy) * s + cx
    for j in range(N_INT_H):
        idx1[..., 24 + j] = 4 * space.N_rt + N_INT_H * elem + j
    space._rt1h_tab = (chi, idx1, div)
    return space._rt1h_tab


def N_rt1h(space: BlockDGSpace3D) -> int:
    return 4 * space.N_rt + N_INT_H * space.s ** 3


def N_rt1h_global(space: BlockDGSpace3D) -> int:
    g = space.grid
    return (4 * space.N_rt_global
            + N_INT_H * g.global_nz * g.global_ny * g.global_nx)


def rt1hex_local_to_global(space: BlockDGSpace3D) -> np.ndarray:
    """[K, N_rt1h] flat indices into the flattened global RT_[1] vector."""
    g = space.grid
    s = space.s
    Sx, Sy, Sz = g.global_nx, g.global_ny, g.global_nz
    l2g0 = space.rt_local_to_global()                         # [K, N_rt]
    out = np.zeros((space.K, N_rt1h(space)), dtype=np.int64)
    for m in range(NM_FACE):
        out[:, m:4 * space.N_rt:4] = 4 * l2g0 + m
    off = 4 * space.N_rt_global
    cz, cy, cx = np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                             indexing="ij")
    loc = 4 * space.N_rt + N_INT_H * ((cz * s + cy) * s + cx)
    for ii in range(space.K):
        sx, sy, sz = g.subdomain_coords(ii)
        ge = ((sz * s + cz) * Sy + (sy * s + cy)) * Sx + (sx * s + cx)
        for j in range(N_INT_H):
            out[ii, loc.ravel() + j] = (off + N_INT_H * ge).ravel() + j
    return out


def rt_tab_any_order3(space: BlockDGSpace3D):
    """(chi [nq, nf, 3], idx [s, s, s, nf], div_q [nq, nf], n_rt_local): the
    degree-matched RT hex tabulation (RT0 for Q1, RT_[1] for Q2) with the
    divergence uniformly given at the quadrature points."""
    if space.order == 1:
        chi, idx, div = space.rt_cell_tab()                   # chi [1,nq,6,3]
        nq = chi.shape[1]
        div_q = np.broadcast_to(div[0][None, :], (nq, div.shape[-1]))
        return chi[0], idx[..., 0, :], div_q, space.N_rt
    chi, idx, div = rt1hex_cell_tab(space)
    return chi, idx, div, N_rt1h(space)


# ---------------------------------------------------------------------------
# products over RT_[1] hex (dispatched from ops/products3d.py by space.order)
# ---------------------------------------------------------------------------
def df_bb_rt1hex(space: BlockDGSpace3D, lam_hat, kappa_fn=None,
                 dtype=torch.float64, device=None):
    """[K, N_rt1h, N_rt1h]: int t . (lam_hat kappa)^{-1} s."""
    from .products3d import _kinv_fn
    chi, idx, _div = rt1hex_cell_tab(space)
    nf = idx.shape[-1]
    xq = asm3.vol_points(space, dtype, device)
    Ki = _kinv_fn(lam_hat, kappa_fn)(xq).to(dtype)
    w = tensor(space.vol_w, dtype, device)
    chi_j = tensor(chi, dtype, device)
    blocks = space.volume * torch.einsum("q,qea,kcqab,qfb->kcef", w, chi_j, Ki, chi_j)
    K, C = space.K, space.s ** 3
    rows = idx.reshape(C, nf)
    A = torch.zeros((K, N_rt1h(space), N_rt1h(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(K, C, nf, nf), rows, rows)


def df_ab_rt1hex(space: BlockDGSpace3D, lam_v, lam_hat, kappa_fn=None,
                 dtype=torch.float64, device=None):
    """[K, N, N_rt1h]: int (lam_v / lam_hat) grad(phi_i) . chi_e."""
    chi, idx, _div = rt1hex_cell_tab(space)
    nf = idx.shape[-1]
    xq = asm3.vol_points(space, dtype, device)
    wgt = (lam_v(xq) / lam_hat(xq)).to(dtype)
    w = tensor(space.vol_w, dtype, device)
    dphi = tensor(space.vol_dphi, dtype, device)
    chi_j = tensor(chi, dtype, device)
    blocks = space.volume * torch.einsum("q,kcq,qia,qea->kcie", w, wgt, dphi, chi_j)
    K, C = space.K, space.s ** 3
    rows = np.arange(space.N, dtype=np.int64).reshape(C, space.nb)
    A = torch.zeros((K, space.N, N_rt1h(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(K, C, space.nb, nf), rows,
                              idx.reshape(C, nf))


def divergence_matrix_rt1hex(space: BlockDGSpace3D, dtype=torch.float64, device=None):
    """[N, N_rt1h]: RT_[1] coeffs -> Q2 nodal coeffs of div t (exact:
    div t in Q_{1,1,1}, interpolated exactly by the Q2 nodal basis)."""
    rt1hex_cell_tab(space)
    Minv = space._rt1h_minv
    _chi, idx, _div = space._rt1h_tab
    nf = idx.shape[-1]
    nodes_phys = space.nodes_unit * np.array([space.hx, space.hy, space.hz])
    div_nodal = _coeff_basis_div_h(nodes_phys) @ Minv         # [nb, 36]
    C = space.s ** 3
    blocks = tensor(div_nodal, dtype, device)[None].expand(C, space.nb, nf)
    rows = np.arange(space.N, dtype=np.int64).reshape(C, space.nb)
    A = torch.zeros((space.N, N_rt1h(space)), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks, rows, idx.reshape(C, nf))


# ---------------------------------------------------------------------------
# RT_[1] hex flux reconstruction
# ---------------------------------------------------------------------------
class FluxReconstructorRT1Hex(FluxReconstructor3D):
    """t_q in RT_[1] hex from a Q2 DG u: per face the FOUR moments of the
    SWIPDG numerical flux against Q_{1,1}(face), plus per cell the twelve
    interior moments of -lambda kappa grad(u) against grad(Q1) with the
    SIPG jump lifting (the 2D ``FluxReconstructorRT1`` lifting algebra is
    dimension-generic and reused)."""

    nm = NM_FACE
    required_order = 2

    _omega = FluxReconstructorRT1._omega
    _lift_terms = FluxReconstructorRT1._lift_terms
    _lift_inner = FluxReconstructorRT1._lift_inner
    _lift_boundary = FluxReconstructorRT1._lift_boundary

    def __init__(self, space: BlockDGSpace3D, kappa_fn=None,
                 ipdg: IPDGParams = DEFAULT_IPDG, dtype=torch.float64, device=None):
        rt1hex_cell_tab(space)
        super().__init__(space, kappa_fn, ipdg, dtype, device)

    def _local_to_global(self, space):
        return rt1hex_local_to_global(space)

    def _edge_moments(self, w, integrand, ell):
        W = tensor(_face_weights(self.space), integrand.dtype, integrand.device)
        return ell * torch.einsum("mq,...fq->...fm", W, integrand)

    def _extra_parts(self, lam_fn, uc, out_dt):
        """Interior moments -int_H lam kappa grad(u) . r_j dx + the SIPG
        jump lifting over the 3 interior face families and 6 boundary
        sides."""
        sp = self.space
        lead = uc.shape[:-4]
        scale = self.scale
        org = self._t(self.cell_org)                          # [Sz, Sy, Sx, 3]
        xq = org[:, :, :, None, :] + self._t(sp.vol_qp * scale)[None, None, None]
        w = self._t(sp.vol_w)
        gu = torch.einsum("...zyxj,qja->...zyxqa", uc, self._t(sp.vol_dphi))
        lam = lam_fn(xq).to(self.dtype)
        if self.kappa_fn is not None:
            gu = torch.einsum("zyxqab,...zyxqb->...zyxqa",
                              self.kappa_fn(xq).to(self.dtype), gu)
        R = self._t(_int_test_basis_h(sp, np.asarray(sp.vol_qp) * scale))
        m = -sp.volume * torch.einsum("q,zyxq,...zyxqa,qja->...zyxj", w, lam, gu, R)
        m = m + self._lift_hex(lam_fn, uc, m.dtype)
        return [m.reshape(lead + (-1,)).to(out_dt)]

    def _R_of(self, fam_or_side, c01):
        """Interior test fields at the cell-local face points [nqf, 12, 3]."""
        sp = self.space
        pts = _face_pts_unit(fam_or_side, sp.face_uv, c01) * self.scale
        return _int_test_basis_h(sp, pts)

    def _lift_hex(self, lam_fn, uc, mdt):
        sp = self.space
        lead = uc.shape[:-4]
        S = (self.Sz, self.Sy, self.Sx)
        nb = sp.nb
        corr = torch.zeros(lead + S + (N_INT_H,), dtype=mdt, device=uc.device)
        org = self.cell_org
        # interior families: minus = hi side of the minus cell (c01 = 1),
        # plus = lo side of the plus cell (c01 = 0); cell axis of [Sz, Sy, Sx]
        for fam, ax in (("X", 2), ("Y", 1), ("Z", 0)):
            n = S[ax]
            if n < 2:
                continue
            a = -4 + ax                                       # axis in [..., Sz, Sy, Sx, .]
            orgs = np.take(org, np.arange(n - 1), axis=ax).reshape(-1, 3)
            x_m, x_p = self._phys_pts(sp.face_tabs[fam], orgs)
            um, up = uc.narrow(a, 0, n - 1), uc.narrow(a, 1, n - 1)
            cm, cp = self._lift_inner(
                lam_fn, sp.face_tabs[fam], x_m, x_p,
                um.reshape(lead + (-1, nb)), up.reshape(lead + (-1, nb)),
                R_m=self._R_of(fam, 1.0), R_p=self._R_of(fam, 0.0))
            corr.narrow(a, 0, n - 1).add_(cm.reshape(um.shape[:-1] + (N_INT_H,)))
            corr.narrow(a, 1, n - 1).add_(cp.reshape(up.shape[:-1] + (N_INT_H,)))
        for side, (fam, c01, _sgn) in SIDES3D.items():
            ax = {"X": 2, "Y": 1, "Z": 0}[fam]
            c = 0 if c01 == 0.0 else S[ax] - 1
            a = -4 + ax
            x, _ = self._phys_pts(sp.face_tabs["bnd_" + side],
                                  np.take(org, c, axis=ax).reshape(-1, 3))
            u = uc.select(a, c)
            cb = self._lift_boundary(lam_fn, sp.face_tabs["bnd_" + side], x,
                                     u.reshape(lead + (-1, nb)), R=self._R_of(fam, c01))
            corr.select(a, c).add_(cb.reshape(u.shape[:-1] + (N_INT_H,)))
        return corr
