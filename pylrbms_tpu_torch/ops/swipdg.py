"""Affine-component SWIPDG block assembly.

The port of ``pylrbms_tpu/ops/swipdg.py``: for every affine diffusion
component ``lambda_q``

* ``A_loc``  [K, N, N]  — volume + subdomain-interior face terms,
* ``D_side`` {side: [K, s, nb, nb]} — one-sided Dirichlet-penalty blocks for
  every subdomain side,
* interface quadruples ``in_in / in_out / out_in / out_out`` [E, s, nb, nb]
  per neighbouring pair (right and up edges),

and :func:`fold_diag` folds the physical-boundary and interface
in_in/out_out blocks into the diagonal blocks ``A_diag``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from . import assembly as asm
from .assembly import IPDGParams, DEFAULT_IPDG


@dataclass
class SwipdgComponent:
    """One affine component of the block SWIPDG operator."""
    A_loc: torch.Tensor                    # [K, N, N]
    D_side: Dict[str, torch.Tensor]        # side -> [K, s, nb, nb]
    R_in_in: torch.Tensor                  # [E_R, s, nb, nb]
    R_in_out: torch.Tensor
    R_out_in: torch.Tensor
    R_out_out: torch.Tensor
    U_in_in: torch.Tensor                  # [E_U, s, nb, nb]
    U_in_out: torch.Tensor
    U_out_in: torch.Tensor
    U_out_out: torch.Tensor


def assemble_swipdg_component(space, lam_fn, kappa_fn=None,
                              ipdg: IPDGParams = DEFAULT_IPDG,
                              dtype=torch.float64, device=None) -> SwipdgComponent:
    grid = space.grid
    order = space.order
    K, s, nb = space.K, space.s, space.nb
    origins = space.subdomain_origins                    # [K, 2] numpy
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)

    A_loc = asm.volume_elliptic(space, lam_fn, kappa_fn, dtype, device)

    for fam, (cy_m, cx_m, cy_p, cx_p) in space.interior_face_sets().items():
        tab = space.face_tabs[fam]
        x_m, x_p = asm.face_phys_points(space, tab, cy_m, cx_m, origins)
        Mmm, Mmp, Mpm, Mpp = asm.inner_face_blocks(
            space, tab, lam_fn, kappa_fn, x_m, x_p, order, **kw)
        rows_m = space.cell_dofs(cy_m, cx_m, np.full_like(cy_m, tab.tri_m))
        rows_p = space.cell_dofs(cy_p, cx_p, np.full_like(cy_p, tab.tri_p))
        asm.scatter_blocks(A_loc, Mmm, rows_m, rows_m)
        asm.scatter_blocks(A_loc, Mmp, rows_m, rows_p)
        asm.scatter_blocks(A_loc, Mpm, rows_p, rows_m)
        asm.scatter_blocks(A_loc, Mpp, rows_p, rows_p)

    D_side = {}
    for side in ("left", "right", "bottom", "top"):
        strip = torch.zeros((K, s, nb, nb), dtype=dtype, device=device)
        for key, cy, cx, _t, pos in space.boundary_face_groups(side):
            tab = space.face_tabs[key]
            x_m, _ = asm.face_phys_points(space, tab, cy, cx, origins)
            strip[:, torch.as_tensor(pos)] = asm.boundary_face_blocks(
                space, tab, lam_fn, kappa_fn, x_m, order, **kw)
        D_side[side] = strip

    kx, ky = grid.kx, grid.ky
    org = origins.reshape(ky, kx, 2)

    def _interface(orient: str, minus_org: np.ndarray):
        E = minus_org.shape[0]
        out = [torch.zeros((E, s, nb, nb), dtype=dtype, device=device)
               for _ in range(4)]
        for fam, cy_m, cx_m, pos in space.interface_face_groups(orient):
            tab = space.face_tabs[fam]
            x_m, x_p = asm.face_phys_points(space, tab, cy_m, cx_m, minus_org)
            blocks = asm.inner_face_blocks(space, tab, lam_fn, kappa_fn,
                                           x_m, x_p, order, **kw)
            for o, b in zip(out, blocks):
                o[:, torch.as_tensor(pos)] = b
        return tuple(out)

    empty = torch.zeros((0, s, nb, nb), dtype=dtype, device=device)
    if kx > 1:
        Rii, Rio, Roi, Roo = _interface("V", org[:, :-1].reshape(-1, 2))
    else:
        Rii = Rio = Roi = Roo = empty
    if ky > 1:
        Uii, Uio, Uoi, Uoo = _interface("H", org[:-1, :].reshape(-1, 2))
    else:
        Uii = Uio = Uoi = Uoo = empty

    return SwipdgComponent(A_loc=A_loc, D_side=D_side,
                           R_in_in=Rii, R_in_out=Rio, R_out_in=Roi, R_out_out=Roo,
                           U_in_in=Uii, U_in_out=Uio, U_out_in=Uoi, U_out_out=Uoo)


def edge_lists(grid) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Subdomain indices of the primal coupling pairs:
    right pairs (left_k [E_R], right_k [E_R]) and up pairs (low_k, up_k)."""
    kx, ky = grid.kx, grid.ky
    sy, sx = np.meshgrid(np.arange(ky), np.arange(kx - 1), indexing="ij")
    left_k = (sy * kx + sx).ravel()
    right_k = left_k + 1
    sy, sx = np.meshgrid(np.arange(ky - 1), np.arange(kx), indexing="ij")
    low_k = (sy * kx + sx).ravel()
    up_k = low_k + kx
    return left_k, right_k, low_k, up_k


def fold_diag(space, comp: SwipdgComponent, dtype=torch.float64) -> torch.Tensor:
    """Fold boundary + interface in_in/out_out contributions into the
    diagonal blocks -> A_diag [K, N, N] (a new tensor; ``comp`` is kept).
    ``dtype`` is accepted as the reference's is and, like it, unused: the
    result keeps the component's dtype."""
    grid = space.grid
    s, nb = space.s, space.nb
    kx, ky = grid.kx, grid.ky
    A = comp.A_loc.clone()
    side_rows = {side: space.side_dofs(side).reshape(s, nb)
                 for side in ("left", "right", "bottom", "top")}

    def add(subs, rows, blk):
        asm.add_at(A, (subs[:, None, None, None], rows[None, :, :, None],
                       rows[None, :, None, :]), blk)

    bnd_subs = {
        "left":  np.array([sy * kx for sy in range(ky)]),
        "right": np.array([sy * kx + kx - 1 for sy in range(ky)]),
        "bottom": np.arange(kx),
        "top":   np.arange(kx) + (ky - 1) * kx,
    }
    for side, subs in bnd_subs.items():
        add(subs, side_rows[side], comp.D_side[side][torch.as_tensor(subs)])

    left_k, right_k, low_k, up_k = edge_lists(grid)
    if left_k.size:
        add(left_k, side_rows["right"], comp.R_in_in)
        add(right_k, side_rows["left"], comp.R_out_out)
    if low_k.size:
        add(low_k, side_rows["top"], comp.U_in_in)
        add(up_k, side_rows["bottom"], comp.U_out_out)
    return A
