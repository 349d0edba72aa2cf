"""Affine-component SWIPDG block assembly on the 3D hex family.

The port of ``pylrbms_tpu/ops/swipdg3d.py`` (the face kernels of
``ops/assembly.py`` are reused as they are): per affine diffusion component

* ``A_loc``  [K, N, N]           — volume + subdomain-interior face terms,
* ``D_side`` {side: [K, s^2, nb, nb]} — one-sided Dirichlet-penalty strips
  for all six box sides,
* interface quadruples for the three orientations (x/y/z primal pairs)
  ``in_in / in_out / out_in / out_out`` [E, s^2, nb, nb],

and :func:`fold_diag3` folds the physical-boundary and interface
in_in/out_out blocks into the diagonal blocks ``A_diag``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from . import assembly as asm
from . import assembly3d as asm3
from .assembly import IPDGParams, DEFAULT_IPDG

SIDES = ("left", "right", "bottom", "top", "near", "far")


@dataclass
class SwipdgComponent3:
    """One affine component of the 3D block SWIPDG operator."""
    A_loc: torch.Tensor                    # [K, N, N]
    D_side: Dict[str, torch.Tensor]        # side -> [K, s^2, nb, nb]
    X_in_in: torch.Tensor                  # [E_X, s^2, nb, nb]
    X_in_out: torch.Tensor
    X_out_in: torch.Tensor
    X_out_out: torch.Tensor
    Y_in_in: torch.Tensor
    Y_in_out: torch.Tensor
    Y_out_in: torch.Tensor
    Y_out_out: torch.Tensor
    Z_in_in: torch.Tensor
    Z_in_out: torch.Tensor
    Z_out_in: torch.Tensor
    Z_out_out: torch.Tensor


def edge_lists3(grid) -> Tuple[np.ndarray, ...]:
    """Subdomain indices of the primal coupling pairs per orientation:
    (xlo_k, xhi_k, ylo_k, yhi_k, zlo_k, zhi_k)."""
    kx, ky, kz = grid.kx, grid.ky, grid.kz

    def pairs(axis):
        n = [kx, ky, kz]
        n[axis] -= 1
        sz, sy, sx = np.meshgrid(np.arange(n[2]), np.arange(n[1]), np.arange(n[0]),
                                 indexing="ij")
        lo = ((sz * ky + sy) * kx + sx).ravel()
        return lo, lo + (1, kx, kx * ky)[axis]

    return pairs(0) + pairs(1) + pairs(2)


def assemble_swipdg_component3(space, lam_fn, kappa_fn=None,
                               ipdg: IPDGParams = DEFAULT_IPDG,
                               dtype=torch.float64, device=None) -> SwipdgComponent3:
    grid = space.grid
    order = space.order
    s, nb = space.s, space.nb
    F = s * s
    origins = space.subdomain_origins                      # [K, 3] numpy
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)

    A_loc = asm3.volume_elliptic(space, lam_fn, kappa_fn, dtype, device)

    for fam, (cz_m, cy_m, cx_m, cz_p, cy_p, cx_p) in \
            space.interior_face_sets().items():
        if cz_m.size == 0:                                 # s == 1
            continue
        tab = space.face_tabs[fam]
        _, x_m, x_p = asm3.face_phys_points(space, tab, cz_m, cy_m, cx_m, origins)
        Mmm, Mmp, Mpm, Mpp = asm.inner_face_blocks(
            space, tab, lam_fn, kappa_fn, x_m, x_p, order, **kw)
        rows_m = space.cell_dofs(cz_m, cy_m, cx_m)
        rows_p = space.cell_dofs(cz_p, cy_p, cx_p)
        asm.scatter_blocks(A_loc, Mmm, rows_m, rows_m)
        asm.scatter_blocks(A_loc, Mmp, rows_m, rows_p)
        asm.scatter_blocks(A_loc, Mpm, rows_p, rows_m)
        asm.scatter_blocks(A_loc, Mpp, rows_p, rows_p)

    D_side = {}
    for side in SIDES:
        (key, cz, cy, cx, _pos), = space.boundary_face_groups(side)
        tab = space.face_tabs[key]
        _, x_m, _ = asm3.face_phys_points(space, tab, cz, cy, cx, origins)
        D_side[side] = asm.boundary_face_blocks(
            space, tab, lam_fn, kappa_fn, x_m, order, **kw)  # [K, s^2, nb, nb]

    def _interface(orient: str, minus_org: np.ndarray):
        if minus_org.shape[0] == 0:
            z = torch.zeros((0, F, nb, nb), dtype=dtype, device=device)
            return z, z, z, z
        (fam, cz_m, cy_m, cx_m, _pos), = space.interface_face_groups(orient)
        tab = space.face_tabs[fam]
        _, x_m, x_p = asm3.face_phys_points(space, tab, cz_m, cy_m, cx_m, minus_org)
        return asm.inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m, x_p,
                                     order, **kw)

    org = origins.reshape(grid.kz, grid.ky, grid.kx, 3)
    Xq = _interface("X", org[:, :, :-1].reshape(-1, 3))
    Yq = _interface("Y", org[:, :-1, :].reshape(-1, 3))
    Zq = _interface("Z", org[:-1].reshape(-1, 3))

    return SwipdgComponent3(
        A_loc=A_loc, D_side=D_side,
        X_in_in=Xq[0], X_in_out=Xq[1], X_out_in=Xq[2], X_out_out=Xq[3],
        Y_in_in=Yq[0], Y_in_out=Yq[1], Y_out_in=Yq[2], Y_out_out=Yq[3],
        Z_in_in=Zq[0], Z_in_out=Zq[1], Z_out_in=Zq[2], Z_out_out=Zq[3])


def fold_diag3(space, comp: SwipdgComponent3, dtype=torch.float64) -> torch.Tensor:
    """Fold boundary + interface in_in/out_out contributions into the
    diagonal blocks -> A_diag [K, N, N] (a new tensor; ``comp`` is kept).
    ``dtype`` is accepted as the reference's is and, like it, unused."""
    grid = space.grid
    kx, ky, kz = grid.kx, grid.ky, grid.kz
    A = comp.A_loc.clone()
    side_rows = {side: space.side_dofs(side).reshape(space.s * space.s, space.nb)
                 for side in SIDES}

    def add(subs, rows, blk):
        if subs.size:
            asm.add_at(A, (subs[:, None, None, None], rows[None, :, :, None],
                           rows[None, :, None, :]), blk)

    subs_all = np.arange(grid.num_subdomains)
    sx = subs_all % kx
    sy = (subs_all // kx) % ky
    sz = subs_all // (kx * ky)
    bnd_subs = {
        "left": subs_all[sx == 0], "right": subs_all[sx == kx - 1],
        "bottom": subs_all[sy == 0], "top": subs_all[sy == ky - 1],
        "near": subs_all[sz == 0], "far": subs_all[sz == kz - 1],
    }
    for side, subs in bnd_subs.items():
        add(subs, side_rows[side],
            comp.D_side[side][torch.as_tensor(subs, device=A.device)])

    xlo, xhi, ylo, yhi, zlo, zhi = edge_lists3(grid)
    add(xlo, side_rows["right"], comp.X_in_in)
    add(xhi, side_rows["left"], comp.X_out_out)
    add(ylo, side_rows["top"], comp.Y_in_in)
    add(yhi, side_rows["bottom"], comp.Y_out_out)
    add(zlo, side_rows["far"], comp.Z_in_in)
    add(zhi, side_rows["near"], comp.Z_out_out)
    return A
