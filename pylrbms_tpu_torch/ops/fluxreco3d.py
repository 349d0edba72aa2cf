"""RT0 hex diffusive flux reconstruction (3D), batched over all faces.

The port of ``pylrbms_tpu/ops/fluxreco3d.py``: per affine diffusion
component reconstruct t_q in tensor RT0 on hexes from the face moments of
:class:`~pylrbms_tpu_torch.ops.fluxreco.FluxReconstructor` (its integrands
and face tables are dimension-agnostic and reused); only the bookkeeping —
three face families X/Y/Z and six boundary sides — is 3D.
"""
from __future__ import annotations

import numpy as np
import torch

from .assembly import IPDGParams, DEFAULT_IPDG
from .fluxreco import Faces, FluxReconstructor


class FluxReconstructor3D(FluxReconstructor):
    """``apply(lam_fn, U)`` -> [..., K, N_rt] local RT0 hex dofs.  The flat
    global layout is X [Sz*Sy*(Sx+1)], Y [Sz*(Sy+1)*Sx], Z [(Sz+1)*Sy*Sx],
    each face with ``nm`` moments, then any interior dofs."""

    nm = 1
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
        self.Sx, self.Sy, self.Sz = g.global_nx, g.global_ny, g.global_nz
        self.rt_l2g = torch.as_tensor(self._local_to_global(space), device=device)
        gz, gy, gx = np.meshgrid(np.arange(self.Sz), np.arange(self.Sy),
                                 np.arange(self.Sx), indexing="ij")
        self.cell_org = (np.asarray(g.lower_left)
                         + np.stack([gx, gy, gz], axis=-1) * self.scale)  # [Sz,Sy,Sx,3]
        self._tables = {}

    @property
    def scale(self) -> np.ndarray:
        g = self.space.grid
        return np.array([g.hx, g.hy, g.hz])

    def _u_block_to_cells(self, U):
        sp, g = self.space, self.space.grid
        lead = U.shape[:-2]
        U = U.reshape(lead + (g.kz, g.ky, g.kx, sp.s, sp.s, sp.s, sp.nb))
        U = torch.movedim(U, -4, -6)
        U = torch.movedim(U, -3, -4)
        return U.reshape(lead + (self.Sz, self.Sy, self.Sx, sp.nb))

    def _face_families(self):
        """(families, number of face slots) of the 3D layout: per axis X,
        Y, Z the inner faces (slot = the plus cell) and the two boundary
        sides."""
        S = (self.Sz, self.Sy, self.Sx)
        c = np.stack([a.ravel() for a in np.meshgrid(*map(np.arange, S), indexing="ij")])
        org = self.cell_org.reshape(-1, 3)
        fams, off = [], 0
        for fam, ax, lo, hi in (("X", 2, "left", "right"), ("Y", 1, "bottom", "top"),
                                ("Z", 0, "near", "far")):
            n = S[ax]
            fshape = list(S)
            fshape[ax] = n + 1
            step = np.zeros((3, 1), np.int64)
            step[ax] = 1
            for side, m, dst in ((None, c[ax] < n - 1, c + step), (lo, c[ax] == 0, c),
                                 (hi, c[ax] == n - 1, c + step)):
                if not m.any():
                    continue
                fams.append(Faces(
                    fam if side is None else "bnd_" + side, side, org[m],
                    np.ravel_multi_index(c[:, m], S),
                    None if side else np.ravel_multi_index(dst[:, m], S),
                    off + np.ravel_multi_index(dst[:, m], fshape)))
            off += int(np.prod(fshape))
        return fams, off
