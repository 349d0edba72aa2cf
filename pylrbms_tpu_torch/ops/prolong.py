"""Inter-grid prolongation for nested structured grids (2D and 3D hex).

The port of ``pylrbms_tpu/ops/prolong.py``: evaluate the coarse DG
function one-sidedly at the nodal points of the fine space.  For nested
refinements (the fine mesh an integer subdivision of the coarse one, the
diagonal split the same line on both levels, on 'crisscross' per cell
parity) this is an exact embedding of the coarse DG space into the fine
one, for any pair of orders.  The gather tables are static float64 numpy;
the apply is one gather and one contraction.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import basis as B


def prolongation_gather(coarse, fine):
    """Static gather data: for each fine dof the flat coarse element index
    (into [K_c * s_c * s_c * T]) and the coarse basis values at the fine
    node.  Returns (src_idx [Mf], weights [Mf, nb_c]), Mf = fine.K * fine.N."""
    gc, gf = coarse.grid, fine.grid
    assert np.isclose(gc.lower_left[0], gf.lower_left[0]) and \
        np.isclose(gc.upper_right[0], gf.upper_right[0])
    Mf = fine.K * fine.N
    xn = fine.node_coords_phys().reshape(Mf, 2)
    # the fine element centroids decide which coarse cell / element holds a node
    org = (fine.subdomain_origins[:, None, None, :]
           + fine.cell_origins_local[None, :, :, :])          # [Kf, s, s, 2]
    scale = np.array([fine.hx, fine.hy])
    if fine.percell:                                          # [s, s, T, 2]
        cen = org[:, :, :, None, :] + fine.tri_centroids[None] * scale
    else:
        cen = org[:, :, :, None, :] + fine.tri_centroids[None, None, None] * scale
    cen = np.broadcast_to(cen[:, :, :, :, None, :],
                          (fine.K, fine.s, fine.s, fine.T, fine.nb, 2)).reshape(Mf, 2)
    cgx = np.clip(((cen[:, 0] - gc.lower_left[0]) / gc.hx).astype(np.int64),
                  0, gc.global_nx - 1)
    cgy = np.clip(((cen[:, 1] - gc.lower_left[1]) / gc.hy).astype(np.int64),
                  0, gc.global_ny - 1)
    xi = (cen[:, 0] - gc.lower_left[0]) / gc.hx - cgx
    eta = (cen[:, 1] - gc.lower_left[1]) / gc.hy - cgy
    pts = np.stack([(xn[:, 0] - gc.lower_left[0]) / gc.hx - cgx,
                    (xn[:, 1] - gc.lower_left[1]) / gc.hy - cgy], axis=-1)
    if gc.grid_type == "quad":
        tri = np.zeros(Mf, dtype=np.int64)
        weights = B.eval_basis("Q", coarse.order, pts)
    elif gc.grid_type == "crisscross":
        # parity 0 cells split along the main diagonal into A/B, parity 1
        # along the anti-diagonal into C/E (t = 0 lower, 1 upper)
        par = (cgx + cgy) % 2
        tri = np.where(par == 0, (eta > xi).astype(np.int64),
                       (xi + eta > 1.0).astype(np.int64))
        w = {t: B.eval_basis(t, coarse.order, pts) for t in "ABCE"}
        weights = np.where((par == 0)[:, None],
                           np.where(tri[:, None] == 0, w["A"], w["B"]),
                           np.where(tri[:, None] == 0, w["C"], w["E"]))
    else:
        tri = (eta > xi).astype(np.int64)        # 0 = A (below diag), 1 = B
        weights = np.where(tri[:, None] == 0, B.eval_basis("A", coarse.order, pts),
                           B.eval_basis("B", coarse.order, pts))
    csx, ccx = cgx // gc.s, cgx % gc.s
    csy, ccy = cgy // gc.s, cgy % gc.s
    k = csy * gc.kx + csx
    flat_tri = (k * (gc.s * gc.s * gc.tri_per_cell)
                + (ccy * gc.s + ccx) * gc.tri_per_cell + tri)
    return flat_tri, weights


def prolongation_gather_3d(coarse, fine):
    """3D hex analogue of :func:`prolongation_gather`: for each fine dof the
    flat coarse hex-cell index (into [K_c * s_c^3]) and the coarse Q1/Q2
    basis values at the fine node.  Nested tensor refinements keep every
    fine node inside (or on the boundary of) one coarse hex; the fine cell
    centroid picks the side, so the embedding of the discontinuous space is
    exact."""
    gc, gf = coarse.grid, fine.grid
    assert gc.grid_type == gf.grid_type == "hex"
    assert np.allclose(gc.lower_left, gf.lower_left) and \
        np.allclose(gc.upper_right, gf.upper_right)
    Mf = fine.K * fine.N
    xn = fine.node_coords_phys().reshape(Mf, 3)
    org = (fine.subdomain_origins[:, None, None, None, :]
           + fine.cell_origins_local[None])                   # [Kf, s, s, s, 3]
    half = 0.5 * np.array([fine.hx, fine.hy, fine.hz])
    cen = np.broadcast_to((org + half)[..., None, :],
                          (fine.K, fine.s, fine.s, fine.s, fine.nb, 3)).reshape(Mf, 3)
    ll = np.asarray(gc.lower_left, dtype=float)
    h = np.array([gc.hx, gc.hy, gc.hz])
    nxyz = np.array([gc.global_nx, gc.global_ny, gc.global_nz])
    cg = np.clip(((cen - ll) / h).astype(np.int64), 0, nxyz - 1)   # [Mf, 3]
    weights = B.eval_basis_hex(coarse.order, (xn - ll) / h - cg)  # [Mf, nb_c]
    cs, cc = cg // gc.s, cg % gc.s                            # subdomain / cell
    k = (cs[:, 2] * gc.ky + cs[:, 1]) * gc.kx + cs[:, 0]
    cell = (cc[:, 2] * gc.s + cc[:, 1]) * gc.s + cc[:, 0]
    return k * gc.s ** 3 + cell, weights


def prolong(coarse, U_coarse, fine):
    """[..., K_c, N_c] -> [..., K_f, N_f] exact nested-grid prolongation."""
    if getattr(coarse, "dim", 2) == 3:
        src, wts = prolongation_gather_3d(coarse, fine)
    else:
        src, wts = prolongation_gather(coarse, fine)
    U = torch.as_tensor(U_coarse)
    lead = U.shape[:-2]
    Uc = U.reshape(lead + (-1, coarse.nb))                    # [..., elements, nb]
    vals = (Uc[..., torch.as_tensor(src, device=U.device), :]
            * torch.as_tensor(wts, dtype=U.dtype, device=U.device)).sum(-1)
    return vals.reshape(lead + (fine.K, fine.N))
