"""Explicit SPMD online solve: row-sharded block PCG with strip halos.

The port of ``pylrbms_tpu/parallel/spmd.py`` (``shard_map`` + ``ppermute``
+ ``psum``), the hand-written counterpart of the K-sharded online step of
:mod:`.mesh` and the direct analog of the reference's MPI structure:

* subdomain ROWS of the kx x ky partition are split over the ranks (the
  rank-local subdomain lists);
* the up/down interface couplings crossing a band edge exchange one
  boundary-layer strip (s nb dofs per subdomain) per neighbor per matvec
  (``ppermute`` -> one ``batch_isend_irecv``, the ``dof_communicator``
  halo exchange);
* the coupling strip of the interface below the band lives with the rank
  below and is shipped once, outside the CG loop;
* CG's dot products are all-reduced (``psum``): ``p . Ap`` in one call,
  the band's summed ``r . z`` partials of the preconditioner with
  ``r . r`` in another.

The diagonal blocks go through ``block_matvec`` and the block-Jacobi
preconditioner (the port's ``block_jacobi_factors``, where the JAX module
inverts with ``jnp.linalg.inv``) through ``precond_dot``.
Requirement: ky divisible by the mesh size.
"""
from __future__ import annotations

import torch

from ..la.block import block_jacobi_factors
from ..la.krylov import pcg_chunked
from ..ops.hopper_kernels import block_matvec, precond_dot


class SpmdOnlineSolver:
    """Row-sharded (assemble + block-Jacobi PCG) step of a 2D block model
    ``d`` over the ranks of ``mesh``; :meth:`make_step` builds it."""

    def __init__(self, d, mesh):
        self.d = d
        self.mesh = mesh
        grid = d.grid
        self.kx, self.ky = grid.kx, grid.ky
        if self.ky % mesh.size:
            raise ValueError(f"ky={self.ky} must be divisible by the mesh size {mesh.size}")
        self.rows = self.ky // mesh.size
        st = d.op.static
        dev = mesh.device
        self.side = {sd: torch.as_tensor(st.side_rows[sd].reshape(-1), device=dev)
                     for sd in ("left", "right", "bottom", "top")}

    def _band_arrays(self):
        """Row-band stacks [Q, kyl, ...]: the diagonal blocks, the R
        couplings [Q, kyl, kx-1, s, nb, nb] and the U couplings re-indexed
        by their LOWER row (a zero edge row above the top row), so every
        interface lives on one rank."""
        d, st, mesh = self.d, self.d.op.static, self.mesh
        Q, K, N, s, nb = d.op.A_diag.shape[0], st.K, st.N, st.s, st.nb
        kx, ky = self.kx, self.ky
        y0, y1 = mesh.rank * self.rows, (mesh.rank + 1) * self.rows
        A = d.op.A_diag.reshape(Q, ky, kx, N, N)[:, y0:y1]
        R_io = d.op.C_R_io.reshape(Q, ky, kx - 1, s, nb, nb)[:, y0:y1]
        R_oi = d.op.C_R_oi.reshape(Q, ky, kx - 1, s, nb, nb)[:, y0:y1]

        def up(C):
            z = C.new_zeros((Q, 1, kx, s, nb, nb))
            return torch.cat([C.reshape(Q, ky - 1, kx, s, nb, nb), z], dim=1)[:, y0:y1]
        dev = mesh.device
        return (A.reshape(Q, -1, N, N).to(dev), R_io.to(dev), R_oi.to(dev),
                up(d.op.C_U_io).to(dev), up(d.op.C_U_oi).to(dev),
                d.rhs_q.reshape(-1, ky, kx, N)[:, y0:y1].reshape(-1, self.rows * kx, N).to(dev))

    def _apply_local(self, op_local, C_from_below, x):
        """Local block apply plus the cross-band strip exchange for the U
        couplings; x [kyl kx, N] (this rank's rows)."""
        A, R_io, R_oi, U_io, U_oi = op_local
        kx, kyl, N = self.kx, self.rows, x.shape[-1]
        s, nb = R_io.shape[-3], R_io.shape[-1]
        sd = self.side
        y = block_matvec(A[None], x[None].contiguous())[0]
        yg, xg = y.view(kyl, kx, N), x.view(kyl, kx, N)
        e = "yxfij,yxfj->yxfi"
        if kx > 1:
            xl = xg[:, :-1][..., sd["right"]].reshape(kyl, kx - 1, s, nb)
            xr = xg[:, 1:][..., sd["left"]].reshape(kyl, kx - 1, s, nb)
            yg[:, :-1, sd["right"]] += torch.einsum(e, R_io, xr).reshape(kyl, kx - 1, s * nb)
            yg[:, 1:, sd["left"]] += torch.einsum(e, R_oi, xl).reshape(kyl, kx - 1, s * nb)
        # my first row's bottom strip goes down, my last row's top strip up
        below, above = self.mesh.exchange(xg[0][:, sd["bottom"]], xg[-1][:, sd["top"]])
        if kyl > 1:
            xm = xg[:-1][..., sd["top"]].reshape(kyl - 1, kx, s, nb)
            xp = xg[1:][..., sd["bottom"]].reshape(kyl - 1, kx, s, nb)
            yg[:-1, :, sd["top"]] += torch.einsum(e, U_io[:-1], xp).reshape(kyl - 1, kx, s * nb)
            yg[1:, :, sd["bottom"]] += torch.einsum(e, U_oi[:-1], xm).reshape(kyl - 1, kx, s * nb)
        e1 = "xfij,xfj->xfi"
        if above is not None:      # my last row (in) <-> the next band's first row (out)
            yg[-1][:, sd["top"]] += torch.einsum(
                e1, U_io[-1], above.reshape(kx, s, nb)).reshape(kx, s * nb)
        if below is not None:
            yg[0][:, sd["bottom"]] += torch.einsum(
                e1, C_from_below, below.reshape(kx, s, nb)).reshape(kx, s * nb)
        return y

    def make_step(self, tol: float = 1e-8, maxiter: int = 400):
        """``run(theta, theta_f) -> U band`` [kyl kx, N] (this rank's rows;
        ``mesh.gather(U, mesh.shard_k(0))`` gives the whole field).  The
        last PCG count is kept in ``run.last_iters``."""
        A_q, R_io_q, R_oi_q, U_io_q, U_oi_q, rhs_q = self._band_arrays()
        dt = A_q.dtype

        def run(theta, theta_f):
            theta = torch.as_tensor(theta, device=A_q.device).to(dt)
            theta_f = torch.as_tensor(theta_f, device=A_q.device).to(dt)

            def mix(a):
                return torch.einsum("q,q...->...", theta, a)
            op_local = (mix(A_q).contiguous(), mix(R_io_q), mix(R_oi_q),
                        mix(U_io_q), mix(U_oi_q))
            b = torch.einsum("q,qkn->kn", theta_f, rhs_q)
            F = block_jacobi_factors(op_local[0]).contiguous()
            # the interface below my first row lives on the rank below:
            # receive its out_in strip once (constant over the CG loop)
            C_from_below, _ = self.mesh.exchange(None, op_local[4][-1])

            def M(r):
                z, rz = precond_dot(F, r[None].contiguous())
                return z[0], rz.sum()

            x, it = pcg_chunked(lambda v: self._apply_local(op_local, C_from_below, v),
                                M, b, tol, maxiter, comm=self.mesh)
            run.last_iters = int(it)
            return x

        run.last_iters = None
        return run
