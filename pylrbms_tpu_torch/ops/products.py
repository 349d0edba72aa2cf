"""Estimator products and constants (the RS2017 kernel set, batched).

The port of ``pylrbms_tpu/ops/products.py`` (order-2 spaces dispatch to
the RT1 products of ``ops/rt1.py``):

* :func:`df_aa`, :func:`df_ab`, :func:`df_bb` — the diffusive-flux products
    aa: (lam_u lam_v / lam_hat) grad(u) . kappa grad(v)
    ab: (lam_v / lam_hat)       grad(v) . t
    bb: t . (lam_hat kappa)^{-1} s
* :func:`divergence_matrix` — local RT0 coefficients -> DG coefficients of
  div(t) (elementwise constant);
* :func:`penalty_product` — jump penalty over subdomain-interior faces plus
  the one-sided penalty on the subdomain boundary;
* :func:`min_diffusion_ev` — min over the subdomain of the smallest
  eigenvalue of lam_hat(x) kappa(x).
"""
from __future__ import annotations

import numpy as np
import torch

from . import assembly as asm
from .assembly import IPDGParams, DEFAULT_IPDG, tensor


def _kinv_fn(lam_hat, kappa_fn):
    """(lam_hat * kappa)^{-1} evaluated pointwise; [..., 2, 2]."""
    def fn(x):
        lh = lam_hat(x)
        if kappa_fn is None:
            inv = torch.zeros(x.shape[:-1] + (2, 2), dtype=x.dtype, device=x.device)
            inv[..., 0, 0] = 1.0 / lh
            inv[..., 1, 1] = 1.0 / lh
            return inv
        k = kappa_fn(x)
        det = k[..., 0, 0] * k[..., 1, 1] - k[..., 0, 1] * k[..., 1, 0]
        inv = torch.stack([
            torch.stack([k[..., 1, 1], -k[..., 0, 1]], dim=-1),
            torch.stack([-k[..., 1, 0], k[..., 0, 0]], dim=-1),
        ], dim=-2) / (det * lh)[..., None, None]
        return inv
    return fn


def df_aa(space, lam_u, lam_v, lam_hat, kappa_fn=None, dtype=torch.float64,
          device=None):
    """[K, N, N]: int (lam_u lam_v / lam_hat) grad(phi_i) . kappa grad(phi_j)."""
    def weight(x):
        return lam_u(x) * lam_v(x) / lam_hat(x)
    return asm.volume_elliptic(space, weight, kappa_fn, dtype, device)


def df_bb(space, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N_rt, N_rt]: int t . (lam_hat kappa)^{-1} s  over the subdomain."""
    if space.order == 2:
        from .rt1 import df_bb_rt1
        return df_bb_rt1(space, lam_hat, kappa_fn, dtype, device)
    chi, idx, _div = space.rt_cell_tab()
    nf = idx.shape[-1]
    xq = tensor(asm.vol_points(space), dtype, device)          # [K,s,s,T,nq,2]
    Ki = _kinv_fn(lam_hat, kappa_fn)(xq).to(dtype)             # [K,s,s,T,nq,2,2]
    w = tensor(space.vol_w, dtype, device)
    area = space.hx * space.hy
    chi_j = tensor(chi, dtype, device)
    blocks = area * torch.einsum(asm.vol_ein(space, "tq,tqea,kyxtqab,tqfb->kyxtef"),
                                 w, chi_j, Ki, chi_j)
    F = space.s * space.s * space.T
    rows = idx.reshape(F, nf)
    A = torch.zeros((space.K, space.N_rt, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(space.K, F, nf, nf), rows, rows)


def df_ab(space, lam_v, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N, N_rt]: int (lam_v / lam_hat) grad(phi_i) . chi_e."""
    if space.order == 2:
        from .rt1 import df_ab_rt1
        return df_ab_rt1(space, lam_v, lam_hat, kappa_fn, dtype, device)
    chi, idx, _div = space.rt_cell_tab()
    nf = idx.shape[-1]
    xq = tensor(asm.vol_points(space), dtype, device)
    wgt = (lam_v(xq) / lam_hat(xq)).to(dtype)                  # [K,s,s,T,nq]
    w = tensor(space.vol_w, dtype, device)
    dphi = tensor(space.vol_dphi, dtype, device)               # [T,nq,nb,2]
    area = space.hx * space.hy
    chi_j = tensor(chi, dtype, device)
    blocks = area * torch.einsum(asm.vol_ein(space, "tq,kyxtq,tqia,tqea->kyxtie"),
                                 w, wgt, dphi, chi_j)
    F = space.s * space.s * space.T
    rows = np.arange(space.N, dtype=np.int64).reshape(F, space.nb)
    A = torch.zeros((space.K, space.N, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(space.K, F, space.nb, nf),
                              rows, idx.reshape(F, nf))


def divergence_matrix(space, dtype=torch.float64, device=None):
    """[N, N_rt] (same for every subdomain): RT0 coeffs -> DG coeffs of div t
    (elementwise constant, so every nodal coefficient of an element is the
    element's div constant)."""
    if space.order == 2:
        from .rt1 import divergence_matrix_rt1
        return divergence_matrix_rt1(space, dtype, device)
    _chi, idx, div = space.rt_cell_tab()
    nf = idx.shape[-1]
    F = space.s * space.s * space.T
    if space.percell:                          # div [s, s, T, nf] (crisscross)
        blocks = np.broadcast_to(div[:, :, :, None, :],
                                 (space.s, space.s, space.T, space.nb, nf))
    else:                                      # div [T, nf]
        blocks = np.broadcast_to(div[None, :, None, :],
                                 (space.s * space.s, space.T, space.nb, nf))
    blocks = blocks.reshape(F, space.nb, nf)
    rows = np.arange(space.N, dtype=np.int64).reshape(F, space.nb)
    A = torch.zeros((space.N, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, tensor(blocks, dtype, device), rows, idx.reshape(F, nf))


def penalty_product(space, lam_fn, kappa_fn=None, ipdg: IPDGParams = DEFAULT_IPDG,
                    dtype=torch.float64, device=None):
    """[K, N, N]: jump penalty over subdomain-interior faces + one-sided
    boundary penalty on all four subdomain sides (local all-Dirichlet)."""
    order = space.order
    origins = space.subdomain_origins
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)
    A = torch.zeros((space.K, space.N, space.N), dtype=dtype, device=device)
    for fam, (cy_m, cx_m, cy_p, cx_p) in space.interior_face_sets().items():
        tab = space.face_tabs[fam]
        x_m, x_p = asm.face_phys_points(space, tab, cy_m, cx_m, origins)
        Mmm, Mmp, Mpm, Mpp = asm.penalty_face_blocks_inner(
            space, tab, lam_fn, kappa_fn, x_m, x_p, order, **kw)
        rows_m = space.cell_dofs(cy_m, cx_m, np.full_like(cy_m, tab.tri_m))
        rows_p = space.cell_dofs(cy_p, cx_p, np.full_like(cy_p, tab.tri_p))
        asm.scatter_blocks(A, Mmm, rows_m, rows_m)
        asm.scatter_blocks(A, Mmp, rows_m, rows_p)
        asm.scatter_blocks(A, Mpm, rows_p, rows_m)
        asm.scatter_blocks(A, Mpp, rows_p, rows_p)
    for side in ("left", "right", "bottom", "top"):
        for key, cy, cx, t, _pos in space.boundary_face_groups(side):
            tab = space.face_tabs[key]
            x_m, _ = asm.face_phys_points(space, tab, cy, cx, origins)
            blk = asm.penalty_face_blocks_boundary(
                space, tab, lam_fn, kappa_fn, x_m, order, **kw)
            rows = space.cell_dofs(cy, cx, t)
            asm.scatter_blocks(A, blk, rows, rows)
    return A


def min_diffusion_ev(space, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K]: min over the subdomain of the smallest eigenvalue of
    lam_hat(x) * kappa(x) (2x2 spd closed form)."""
    xq = tensor(asm.vol_points(space), dtype, device)
    lh = lam_hat(xq).to(dtype)
    if kappa_fn is None:
        ev = lh
    else:
        k = kappa_fn(xq).to(dtype) * lh[..., None, None]
        tr2 = (k[..., 0, 0] + k[..., 1, 1]) / 2
        det = k[..., 0, 0] * k[..., 1, 1] - k[..., 0, 1] * k[..., 1, 0]
        ev = tr2 - torch.sqrt(torch.clamp(tr2 * tr2 - det, min=0.0))
    return ev.reshape(space.K, -1).min(dim=1).values
