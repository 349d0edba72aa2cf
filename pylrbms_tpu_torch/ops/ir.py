"""Mixed-precision iterative refinement for the matrix-free Krylov solves.

The port of ``pylrbms_tpu/ops/ir.py`` (see its docstring for the method):
an f32 PCG on the symmetrically Jacobi-scaled system ``A~ = S A S``,
``S = diag(A)^(-1/2)`` (matvec ``v -> s * A32(s * v)``, preconditioner
conjugated as ``r -> (1/s) M((1/s) r)``), f64 residual recomputation
between rounds, and an f64 PCG polish when the rounds stall before ``tol``.

The reference's ``lax.while_loop`` over rounds is a Python loop that reads
the tolerance and stall test on the host once per round.  The subdomain
block-Jacobi apply goes through the hand-written
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.precond_dot`.  Whether the
mixed path is the default is the caller's choice (``StationaryBlockModel``
keeps the plain f64 solve unless ``mixed`` is asked for).
"""
from __future__ import annotations

import torch

from .matrixfree import cast, make_precond
from ..la.krylov import lane_dot, pcg_chunked


def pcg(matvec, M, b, tol, maxiter, x0=None, comm=None):
    """Generic preconditioned CG (dtype follows ``b``), ``M(r) -> z``;
    returns (x, iters).  Exit when ||r||_2 <= tol * ||b||_2 or at
    ``maxiter`` (``la/krylov.pcg_chunked``; ``comm`` all-reduces its dot
    products)."""
    def Mz(r):
        z = M(r)
        return z, lane_dot(r, z)
    return pcg_chunked(matvec, Mz, b, tol, maxiter, x0=x0, comm=comm)


def make_precond_f32(block_factors=None, factors=None, cell_shape=None,
                     coarse_inv=None, coarse_basis=None, comm=None, band=None):
    """f32 preconditioner closure ``r [..., K, N] -> z`` of the inner IR
    solve: :func:`~pylrbms_tpu_torch.ops.matrixfree.make_precond` for f32
    vectors (subdomain block-Jacobi through ``precond_dot`` with the factors
    in f32, or bf16 as stored; per-cell ``factors`` reshaped by
    ``cell_shape``; the constant or basis coarse level in f32) with its
    ``rz`` dropped.  ``comm`` and ``band`` shard it over K as there."""
    P = make_precond(torch.float32, block_factors=block_factors, factors=factors,
                     cell_shape=cell_shape, coarse_inv=coarse_inv,
                     coarse_basis=coarse_basis, comm=comm, band=band)

    def M(r):
        return P(r)[0]
    return M


def solve_ir(A64, A32, b, diag, *, tol=1e-10, maxiter=2000,
             block_factors=None, factors=None, cell_shape=None,
             coarse_inv=None, coarse_basis=None, x0=None,
             inner_tol=1e-4, inner_maxiter=300, max_rounds=20,
             stall_factor=0.5, fallback=True, return_info=False,
             comm=None, band=None):
    """Solve ``A64 x = b`` (b [K, N]) to f64 accuracy with f32 Krylov work.

    ``A64`` / ``A32`` are operators with a matrix-free ``.apply`` (``A32``
    the f32 version of ``A64``), ``diag`` [K, N] a positive diagonal of
    A(theta) for the scaling.  Stops on ``||b - A x||_2 <= tol ||b||_2``,
    the round budget, or a stall (a round cutting the residual by less than
    ``stall_factor``); ``fallback`` then runs the f64 PCG from the
    accumulated iterate.  Returns ``x`` (or ``(x, f32_iters, rounds,
    fallback_iters)``).

    K-sharded: with ``comm`` (and ``band``, as in ``make_precond``) b,
    ``diag`` and the factors are this rank's bands, the operators banded
    ones; norms and dot products are summed and the scaling maximum is
    taken over the ranks, so every rank runs the same rounds."""
    if comm is None:
        def total(t):
            return t

        def top(t):
            return t
    else:
        total, top = comm.sum, comm.max
    f32, f64 = torch.float32, b.dtype
    s64 = 1.0 / torch.sqrt(torch.clamp(torch.abs(diag), min=1e-300))
    s32 = s64.to(f32)
    si32 = (1.0 / s64).to(f32)
    Mf = make_precond_f32(block_factors=block_factors, factors=factors,
                          cell_shape=cell_shape, coarse_inv=coarse_inv,
                          coarse_basis=coarse_basis, comm=comm, band=band)

    def matvec32(v):
        return s32 * A32.apply(s32 * v)

    def M32(r):
        return si32 * Mf(si32 * r)

    atol2 = (tol ** 2) * torch.clamp(total(lane_dot(b, b)), min=1e-300)
    x = torch.zeros_like(b) if x0 is None else x0.to(f64).clone()
    r = b - A64.apply(x)
    rn2 = total(lane_dot(r, r))
    it32 = torch.zeros((), dtype=torch.int64, device=b.device)
    rounds, ok = 0, True
    while ok and rounds < max_rounds and bool(rn2 > atol2):
        rt = s64 * r
        nrm = torch.clamp(top(torch.abs(rt).max()), min=1e-300)
        dxt, k = pcg(matvec32, M32, (rt / nrm).to(f32), inner_tol, inner_maxiter, comm=comm)
        x = x + nrm * s64 * dxt.to(f64)
        r = b - A64.apply(x)                # the round's one f64 matvec
        rn2_new = total(lane_dot(r, r))
        ok = bool(rn2_new <= (stall_factor ** 2) * rn2)
        rn2, it32, rounds = rn2_new, it32 + k, rounds + 1

    it64 = torch.zeros((), dtype=torch.int64, device=b.device)
    if fallback and bool(rn2 > atol2):
        # correctness anchor: finish in f64 from the accumulated iterate, in
        # the unscaled space (Mf, not the conjugated M32)
        x, it64 = pcg(A64.apply, lambda rr: Mf(rr.to(f32)).to(f64), b, tol,
                      maxiter, x0=x, comm=comm)
    if return_info:
        return x, it32, rounds, it64
    return x


def cast_f32(op):
    """f32 copy of an assembled stencil or operator dataclass (every
    floating tensor field, the ``D_side`` dict too; the space kept)."""
    return cast(op, torch.float32)


def diag_of_blocks(A_diag_q):
    """[Q, K, N, N] affine diagonal-block stacks -> [Q, K, N] diagonals
    (combine with theta via ``einsum('q,qkn->kn', theta, diag_q)``)."""
    return torch.diagonal(A_diag_q, dim1=-2, dim2=-1)
