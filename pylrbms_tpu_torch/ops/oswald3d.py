"""3D Oswald interpolation error operator (vertex averaging on hexes).

The port of ``pylrbms_tpu/ops/oswald3d.py``: for a Q1 DG function u the
conforming Oswald interpolant I_os(u) takes at every mesh vertex the mean
of the DG values from all (up to 8) incident hexes, and 0 at Dirichlet
boundary vertices; :meth:`Oswald3D.apply` returns the nonconformity witness
u - I_os(u).  Order 2 quantizes the physical node coordinates to the
half-cell lattice (as the 2D ``OswaldOperator`` does).  The vertex tables
are static numpy; the scatter-add is ``index_add_`` and the gather an index
on the flat ``[..., K*N]`` axis.
"""
from __future__ import annotations

import numpy as np
import torch


class Oswald3D:
    def __init__(self, space, device=None, dtype=torch.float64):
        self.space = space
        g = space.grid
        Sx, Sy, Sz = g.global_nx, g.global_ny, g.global_nz
        self.Sx, self.Sy, self.Sz = Sx, Sy, Sz
        if space.order == 1:
            gz, gy, gx = np.meshgrid(np.arange(Sz), np.arange(Sy), np.arange(Sx),
                                     indexing="ij")
            # Q1 node order j = (iz*2 + iy)*2 + ix (basis.hex_node_coords_unit)
            vid = np.zeros((Sz, Sy, Sx, 8), dtype=np.int64)
            for j, (iz, iy, ix) in enumerate(np.ndindex(2, 2, 2)):
                vid[..., j] = ((gz + iz) * (Sy + 1) + gy + iy) * (Sx + 1) + gx + ix
            self.vertex_ids = vid.reshape(-1)
            nz_, ny_, nx_ = Sz, Sy, Sx
        else:
            # every Q2 node lies on the half-cell lattice; its identity is
            # recovered by quantizing the physical coordinates
            coords = self._block_to_global_cells_np(space.node_coords_phys(), 3)
            x0 = np.asarray(g.lower_left)
            ix2 = np.rint((coords[:, 0] - x0[0]) / (space.hx / 2)).astype(np.int64)
            iy2 = np.rint((coords[:, 1] - x0[1]) / (space.hy / 2)).astype(np.int64)
            iz2 = np.rint((coords[:, 2] - x0[2]) / (space.hz / 2)).astype(np.int64)
            assert ix2.min() >= 0 and ix2.max() <= 2 * Sx
            assert iy2.min() >= 0 and iy2.max() <= 2 * Sy
            assert iz2.min() >= 0 and iz2.max() <= 2 * Sz
            self.vertex_ids = (iz2 * (2 * Sy + 1) + iy2) * (2 * Sx + 1) + ix2
            nz_, ny_, nx_ = 2 * Sz, 2 * Sy, 2 * Sx
        self.n_vertices = (nz_ + 1) * (ny_ + 1) * (nx_ + 1)
        counts = np.zeros(self.n_vertices)
        np.add.at(counts, self.vertex_ids, 1.0)
        counts = np.maximum(counts, 1.0)           # lattice points no node uses
        iz, iy, ix = np.meshgrid(np.arange(nz_ + 1), np.arange(ny_ + 1),
                                 np.arange(nx_ + 1), indexing="ij")
        interior = ((iz > 0) & (iz < nz_) & (iy > 0) & (iy < ny_)
                    & (ix > 0) & (ix < nx_)).reshape(-1)
        # re-index to the block dof layout [K*N]: node of block-flat dof i
        perm = self._block_to_global_cells_np(np.arange(space.K * space.N), 0)
        vb = np.empty(space.K * space.N, dtype=np.int64)
        vb[perm] = self.vertex_ids
        self.vertex_ids_block = torch.as_tensor(vb, device=device)
        self.counts = torch.as_tensor(counts, dtype=dtype, device=device)
        self.interior_mask = torch.as_tensor(interior, dtype=dtype, device=device)

    def _block_to_global_cells_np(self, a, trail: int):
        """Block dof order [K*N (, trail)] -> global-cell order
        [Sz*Sy*Sx*nb (, trail)] (numpy)."""
        sp, g = self.space, self.space.grid
        tail = (trail,) if trail else ()
        a = np.asarray(a).reshape((g.kz, g.ky, g.kx, sp.s, sp.s, sp.s, sp.nb) + tail)
        a = np.moveaxis(a, 3, 1)                   # sz next to kz
        a = np.moveaxis(a, 4, 3)                   # sy next to ky
        return a.reshape((-1,) + tail)

    def interpolate(self, U):
        """I_os(u): [..., K, N] -> [..., K, N] (conforming, zero on the
        domain boundary)."""
        lead = U.shape[:-2]
        vals = U.reshape(lead + (-1,))
        sums = torch.zeros(lead + (self.n_vertices,), dtype=U.dtype, device=U.device)
        sums.index_add_(-1, self.vertex_ids_block, vals)
        avg = sums / self.counts.to(U.dtype) * self.interior_mask.to(U.dtype)
        return avg[..., self.vertex_ids_block].reshape(U.shape)

    def apply(self, U):
        """Nonconformity witness u - I_os(u)."""
        return U - self.interpolate(U)
