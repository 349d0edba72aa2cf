"""Estimator products and constants on the 3D hex family (RS2017 set in 3D).

The port of ``pylrbms_tpu/ops/products3d.py``, the 3D counterparts of
``ops/products.py`` for ``BlockDGSpace3D``: the diffusive-flux products
df_aa/ab/bb on the tensor RT0 hex space (RT_[1] for Q2, ``ops/rt1hex.py``),
the RT -> DG divergence interpolation, the jump/boundary penalty product and
the min-diffusion-eigenvalue constant.
"""
from __future__ import annotations

import numpy as np
import torch

from . import assembly as asm
from . import assembly3d as asm3
from .assembly import IPDGParams, DEFAULT_IPDG, tensor
from .swipdg3d import SIDES


def _kinv_fn(lam_hat, kappa_fn):
    """(lam_hat * kappa)^{-1} pointwise; [..., 3, 3] (kappa None -> I/lam)."""
    def fn(x):
        lh = lam_hat(x)
        if kappa_fn is None:
            eye = torch.eye(3, dtype=x.dtype, device=x.device)
            return eye / lh[..., None, None]
        return torch.linalg.inv(kappa_fn(x)) / lh[..., None, None]
    return fn


def df_aa(space, lam_u, lam_v, lam_hat, kappa_fn=None, dtype=torch.float64,
          device=None):
    """[K, N, N]: int (lam_u lam_v / lam_hat) grad(phi_i) . kappa grad(phi_j)."""
    def weight(x):
        return lam_u(x) * lam_v(x) / lam_hat(x)
    return asm3.volume_elliptic(space, weight, kappa_fn, dtype, device)


def df_bb(space, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N_rt, N_rt]: int t . (lam_hat kappa)^{-1} s over the subdomain
    (tensor RT0 for Q1, RT_[1] for Q2)."""
    if space.order == 2:
        from .rt1hex import df_bb_rt1hex
        return df_bb_rt1hex(space, lam_hat, kappa_fn, dtype, device)
    chi, idx, _div = space.rt_cell_tab()          # chi [1, nq, 6, 3]
    nf = idx.shape[-1]
    xq = asm3.vol_points(space, dtype, device)    # [K, C, nq, 3]
    Ki = _kinv_fn(lam_hat, kappa_fn)(xq).to(dtype)
    w = tensor(space.vol_w, dtype, device)
    chi_j = tensor(chi[0], dtype, device)         # [nq, 6, 3]
    blocks = space.volume * torch.einsum("q,qea,kcqab,qfb->kcef", w, chi_j, Ki, chi_j)
    K, C = space.K, space.s ** 3
    rows = idx.reshape(C, nf)
    A = torch.zeros((K, space.N_rt, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(K, C, nf, nf), rows, rows)


def df_ab(space, lam_v, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N, N_rt]: int (lam_v / lam_hat) grad(phi_i) . chi_e."""
    if space.order == 2:
        from .rt1hex import df_ab_rt1hex
        return df_ab_rt1hex(space, lam_v, lam_hat, kappa_fn, dtype, device)
    chi, idx, _div = space.rt_cell_tab()
    nf = idx.shape[-1]
    xq = asm3.vol_points(space, dtype, device)
    wgt = (lam_v(xq) / lam_hat(xq)).to(dtype)                  # [K, C, nq]
    w = tensor(space.vol_w, dtype, device)
    dphi = tensor(space.vol_dphi, dtype, device)               # [nq, nb, 3]
    chi_j = tensor(chi[0], dtype, device)
    blocks = space.volume * torch.einsum("q,kcq,qia,qea->kcie", w, wgt, dphi, chi_j)
    K, C = space.K, space.s ** 3
    rows = np.arange(space.N, dtype=np.int64).reshape(C, space.nb)
    cols = idx.reshape(C, nf)
    A = torch.zeros((K, space.N, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks.reshape(K, C, space.nb, nf), rows, cols)


def divergence_matrix(space, dtype=torch.float64, device=None):
    """[N, N_rt] (the same for every subdomain): RT coefficients -> DG
    coefficients of div t (elementwise constant for RT0; the exact Q2 nodal
    interpolation for RT_[1])."""
    if space.order == 2:
        from .rt1hex import divergence_matrix_rt1hex
        return divergence_matrix_rt1hex(space, dtype, device)
    _chi, idx, div = space.rt_cell_tab()          # div [1, 6]
    nf = idx.shape[-1]
    C = space.s ** 3
    blocks = tensor(div, dtype, device)[:, None, :].expand(C, space.nb, nf)
    rows = np.arange(space.N, dtype=np.int64).reshape(C, space.nb)
    A = torch.zeros((space.N, space.N_rt), dtype=dtype, device=device)
    return asm.scatter_blocks(A, blocks, rows, idx.reshape(C, nf))


def penalty_product(space, lam_fn, kappa_fn=None, ipdg: IPDGParams = DEFAULT_IPDG,
                    dtype=torch.float64, device=None):
    """[K, N, N]: jump penalty over subdomain-interior faces + one-sided
    boundary penalty on all six subdomain sides (local all-Dirichlet)."""
    order = space.order
    origins = space.subdomain_origins
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)
    A = torch.zeros((space.K, space.N, space.N), dtype=dtype, device=device)
    for fam, (cz_m, cy_m, cx_m, cz_p, cy_p, cx_p) in space.interior_face_sets().items():
        if cz_m.size == 0:
            continue
        tab = space.face_tabs[fam]
        _, x_m, x_p = asm3.face_phys_points(space, tab, cz_m, cy_m, cx_m, origins)
        Mmm, Mmp, Mpm, Mpp = asm.penalty_face_blocks_inner(
            space, tab, lam_fn, kappa_fn, x_m, x_p, order, **kw)
        rows_m = space.cell_dofs(cz_m, cy_m, cx_m)
        rows_p = space.cell_dofs(cz_p, cy_p, cx_p)
        asm.scatter_blocks(A, Mmm, rows_m, rows_m)
        asm.scatter_blocks(A, Mmp, rows_m, rows_p)
        asm.scatter_blocks(A, Mpm, rows_p, rows_m)
        asm.scatter_blocks(A, Mpp, rows_p, rows_p)
    for side in SIDES:
        for key, cz, cy, cx, _pos in space.boundary_face_groups(side):
            tab = space.face_tabs[key]
            _, x_m, _ = asm3.face_phys_points(space, tab, cz, cy, cx, origins)
            blk = asm.penalty_face_blocks_boundary(space, tab, lam_fn, kappa_fn, x_m,
                                                   order, **kw)
            rows = space.cell_dofs(cz, cy, cx)
            asm.scatter_blocks(A, blk, rows, rows)
    return A


def min_diffusion_ev(space, lam_hat, kappa_fn=None, dtype=torch.float64, device=None):
    """[K]: min over the subdomain of the smallest eigenvalue of
    lam_hat(x) * kappa(x)."""
    xq = asm3.vol_points(space, dtype, device)
    lh = lam_hat(xq).to(dtype)
    if kappa_fn is None:
        ev = lh
    else:
        ev = torch.linalg.eigvalsh(kappa_fn(xq).to(dtype) * lh[..., None, None])[..., 0]
    return ev.reshape(space.K, -1).min(dim=1).values
