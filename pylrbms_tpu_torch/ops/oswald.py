"""Oswald interpolation error operator (vertex averaging), batched.

The port of ``pylrbms_tpu/ops/oswald.py``: the conforming Oswald
interpolant I_os(u) takes at every mesh vertex the arithmetic mean of the
DG values of all incident elements and 0 at Dirichlet-boundary vertices;
:meth:`OswaldOperator.apply` returns the nonconformity witness u - I_os(u).
Order 1 reads hand-built per-family vertex tables (on 'crisscross' off the
per-cell node tables); order 2 quantizes the physical node coordinates to
the half-cell lattice, so the same average enforces C^0 continuity of the
whole order-2 nodal set.  The vertex tables are static numpy; the
scatter-add is ``index_add_`` and the gather an index on the flat
``[..., K*N]`` axis.
"""
from __future__ import annotations

import numpy as np
import torch


class OswaldOperator:
    def __init__(self, space, device=None, dtype=torch.float64):
        self.space = space
        g = space.grid
        Sy, Sx = g.global_ny, g.global_nx
        if space.order == 1:
            vertex_ids = self._vertex_ids_p1(space)
            self.n_vertices = (Sy + 1) * (Sx + 1)
            ny_, nx_ = Sy, Sx
        else:
            vertex_ids = self._vertex_ids_lattice(space)
            self.n_vertices = (2 * Sy + 1) * (2 * Sx + 1)
            ny_, nx_ = 2 * Sy, 2 * Sx
        counts = np.zeros(self.n_vertices)
        np.add.at(counts, vertex_ids, 1.0)
        counts = np.maximum(counts, 1.0)        # lattice points no node uses
        iy, ix = np.meshgrid(np.arange(ny_ + 1), np.arange(nx_ + 1), indexing="ij")
        interior = ((iy > 0) & (iy < ny_) & (ix > 0) & (ix < nx_)).reshape(-1)
        # re-index to the block dof layout [K*N]: node of block-flat dof i
        perm = np.arange(space.K * space.N).reshape(
            g.ky, g.kx, space.s, space.s, space.T, space.nb)
        perm = np.moveaxis(perm, 2, 1).reshape(-1)
        vb = np.empty(space.K * space.N, dtype=np.int64)
        vb[perm] = vertex_ids
        self.vertex_ids_block = torch.as_tensor(vb, device=device)
        self.counts = torch.as_tensor(counts, dtype=dtype, device=device)
        self.interior_mask = torch.as_tensor(interior, dtype=dtype, device=device)

    @staticmethod
    def _vertex_ids_p1(space):
        """[Sy*Sx*T*nb] vertex id of every P1/Q1 node in global-cell order."""
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
        elif g.grid_type == "crisscross":
            # P1 nodes are the triangle vertices: read them off the per-cell
            # node tables (parity checkerboard)
            tile = np.rint(space.nodes_unit).astype(np.int64)    # [s, s, T, nb, 2]
            reps = (g.ky, 1, g.kx, 1, 1, 1)
            shape = (Sy, Sx, space.T, space.nb)
            ny_ = np.tile(tile[None, :, None, ..., 1], reps).reshape(shape)
            nx_ = np.tile(tile[None, :, None, ..., 0], reps).reshape(shape)
            vid = v(gy[:, :, None, None] + ny_, gx[:, :, None, None] + nx_)
        else:
            # A: (0,0), (1,0), (1,1);  B: (0,0), (0,1), (1,1)  (unit-cell coords)
            vid = np.zeros((Sy, Sx, 2, 3), dtype=np.int64)
            vid[:, :, 0, 0] = v(gy, gx)
            vid[:, :, 0, 1] = v(gy, gx + 1)
            vid[:, :, 0, 2] = v(gy + 1, gx + 1)
            vid[:, :, 1, 0] = v(gy, gx)
            vid[:, :, 1, 1] = v(gy + 1, gx)
            vid[:, :, 1, 2] = v(gy + 1, gx + 1)
        return vid.reshape(-1)

    @staticmethod
    def _vertex_ids_lattice(space):
        """Order 2, any family: node ids on the half-cell lattice
        (2 Sy + 1) x (2 Sx + 1), in global-cell order."""
        g = space.grid
        Sy, Sx = g.global_ny, g.global_nx
        org = g.cell_origins()                              # [Sy, Sx, 2]
        nodes = space.nodes_unit * np.array([space.hx, space.hy])
        if space.percell:                                   # [s, s, T, nb, 2]
            nodes = np.tile(nodes[None, :, None], (g.ky, 1, g.kx, 1, 1, 1, 1)
                            ).reshape(Sy, Sx, space.T, space.nb, 2)
        else:                                               # [T, nb, 2]
            nodes = np.broadcast_to(nodes[None, None], (Sy, Sx, space.T, space.nb, 2))
        coords = org[:, :, None, None, :] + nodes
        x0 = org[0, 0]
        ix2 = np.rint((coords[..., 0] - x0[0]) / (space.hx / 2)).astype(np.int64)
        iy2 = np.rint((coords[..., 1] - x0[1]) / (space.hy / 2)).astype(np.int64)
        assert ix2.min() >= 0 and ix2.max() <= 2 * Sx
        assert iy2.min() >= 0 and iy2.max() <= 2 * Sy
        return (iy2 * (2 * Sx + 1) + ix2).reshape(-1)

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
