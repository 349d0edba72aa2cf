"""Oswald interpolation error operator (vertex averaging), batched.

The port of ``pylrbms_tpu/ops/oswald.py`` for P1 on ``tri`` and Q1 on
``quad``: the conforming Oswald interpolant I_os(u) takes at every mesh
vertex the arithmetic mean of the DG values of all incident elements and 0
at Dirichlet-boundary vertices; :meth:`OswaldOperator.apply` returns the
nonconformity witness u - I_os(u).  The vertex tables are static numpy;
the scatter-add is ``index_add_`` and the gather an index on the flat
``[..., K*N]`` axis.
"""
from __future__ import annotations

import numpy as np
import torch


class OswaldOperator:
    def __init__(self, space, device=None, dtype=torch.float64):
        if space.order != 1 or space.grid.grid_type == "crisscross":
            raise NotImplementedError(
                "only the order-1 tri/quad Oswald tables are ported")
        self.space = space
        g = space.grid
        Sy, Sx = g.global_ny, g.global_nx
        gy, gx = np.meshgrid(np.arange(Sy), np.arange(Sx), indexing="ij")

        def v(iy, ix):
            return iy * (Sx + 1) + ix
        if g.grid_type == "quad":
            # Q1 node order (0,0), (1,0), (0,1), (1,1)  (x fastest)
            vid = np.zeros((Sy, Sx, 1, 4), dtype=np.int64)
            vid[:, :, 0, 0] = v(gy, gx)
            vid[:, :, 0, 1] = v(gy, gx + 1)
            vid[:, :, 0, 2] = v(gy + 1, gx)
            vid[:, :, 0, 3] = v(gy + 1, gx + 1)
        else:
            # A: (0,0), (1,0), (1,1);  B: (0,0), (0,1), (1,1)  (unit-cell coords)
            vid = np.zeros((Sy, Sx, 2, 3), dtype=np.int64)
            vid[:, :, 0, 0] = v(gy, gx)
            vid[:, :, 0, 1] = v(gy, gx + 1)
            vid[:, :, 0, 2] = v(gy + 1, gx + 1)
            vid[:, :, 1, 0] = v(gy, gx)
            vid[:, :, 1, 1] = v(gy + 1, gx)
            vid[:, :, 1, 2] = v(gy + 1, gx + 1)
        vertex_ids = vid.reshape(-1)                            # global-cell order
        self.n_vertices = (Sy + 1) * (Sx + 1)
        counts = np.zeros(self.n_vertices)
        np.add.at(counts, vertex_ids, 1.0)
        iy, ix = np.meshgrid(np.arange(Sy + 1), np.arange(Sx + 1), indexing="ij")
        interior = ((iy > 0) & (iy < Sy) & (ix > 0) & (ix < Sx)).reshape(-1)
        # re-index to the block dof layout [K*N]: node of block-flat dof i
        perm = np.arange(space.K * space.N).reshape(
            g.ky, g.kx, space.s, space.s, space.T, space.nb)
        perm = np.moveaxis(perm, 2, 1).reshape(-1)
        vb = np.empty(space.K * space.N, dtype=np.int64)
        vb[perm] = vertex_ids
        self.vertex_ids_block = torch.as_tensor(vb, device=device)
        self.counts = torch.as_tensor(counts, dtype=dtype, device=device)
        self.interior_mask = torch.as_tensor(interior, dtype=dtype, device=device)

    def interpolate(self, U):
        """I_os(u): [..., K, N] -> [..., K, N] (conforming, zero on boundary)."""
        lead = U.shape[:-2]
        vals = U.reshape(lead + (-1,))
        sums = torch.zeros(lead + (self.n_vertices,), dtype=U.dtype, device=U.device)
        sums.index_add_(-1, self.vertex_ids_block, vals)
        avg = sums / self.counts.to(U.dtype) * self.interior_mask.to(U.dtype)
        return avg[..., self.vertex_ids_block].reshape(U.shape)

    def apply(self, U):
        """Nonconformity witness u - I_os(u)."""
        return U - self.interpolate(U)
