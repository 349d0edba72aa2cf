"""Preconditioned CG with per-lane select-frozen state and chunked
convergence checks.

The port of ``pylrbms_tpu/la/krylov.py``.  The right-hand side carries an
optional leading lane axis ``[B, K, N]`` (one independent system per lane,
the port of ``vmap`` over the JAX ``while_loop``).  Every body evaluation
computes the candidate update for all lanes and SELECTS it only where the
lane is still active (``|r|^2 > tol^2 |b|^2`` and ``it < maxiter``), so each
lane's iterate sequence is the plain CG sequence and its iteration count is
its own.  Convergence is read on the host once per ``chunk`` body
evaluations — the only host synchronization of the loop.

With ``comm`` (an object whose ``sum`` all-reduces a tensor over the ranks
that share the subdomain axis, e.g. a
:class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh`) every vector holds
one rank's band of subdomains and every dot product is the sum of the
ranks' partials: ``p . Ap`` in one all-reduce, ``r . z`` and ``r . r`` of
the new residual stacked into a second one.  Each rank then reads the same
numbers, so every rank stops on the same iteration.

Each operator apply is an ``operator.apply`` span and each preconditioner
apply a ``precond.apply`` span of ``utils/timers.GLOBAL_TIMINGS``; the
counter ``pcg.bodies`` adds ``chunk`` per outer loop (no-ops while the
timings are off).
"""
from __future__ import annotations

import torch

from ..utils.timers import GLOBAL_TIMINGS as T


def default_chunk(device) -> int:
    """16 on CUDA (a host sync per chunk instead of per iteration), 1 on CPU."""
    return 16 if torch.device(device).type == "cuda" else 1


def lane_dot(u, v):
    """Per-lane dot product of [..., K, N] tensors -> [...]."""
    return (u * v).sum(dim=(-2, -1))


def pcg_chunked(matvec, M, b, tol, maxiter, x0=None, chunk: int = None, comm=None):
    """Preconditioned CG on ``b`` [..., K, N]; ``M(r) -> (z, rz)`` returns the
    preconditioned residual and the per-lane CG scalar ``r . z`` (with
    ``comm``: this rank's partial of it).  Returns ``(x, iters)`` with
    ``iters`` of the lane shape.  Stopping per lane:
    ``||r||_2 <= tol * ||b||_2`` on the recurrence residual, or ``maxiter``."""
    if chunk is None:
        chunk = default_chunk(b.device)
    if comm is None:
        def total(*partials):
            return partials if len(partials) > 1 else partials[0]
    else:
        def total(*partials):
            return tuple(comm.sum(torch.stack(partials)).unbind(0)) \
                if len(partials) > 1 else comm.sum(partials[0])
    atol2 = (tol ** 2) * torch.clamp(total(lane_dot(b, b)), min=torch.finfo(b.dtype).tiny)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    with T.span("operator.apply"):
        Ax = matvec(x)
    r = b - Ax
    with T.span("precond.apply"):
        z, rz = M(r)
    rz, rr = total(rz, lane_dot(r, r))
    p = z
    it = torch.zeros(b.shape[:-2], dtype=torch.int64, device=b.device)

    def active():
        return (rr > atol2) & (it < maxiter)

    while bool(active().any()):
        T.count("pcg.bodies", chunk)
        for _ in range(chunk):
            act = active()
            with T.span("operator.apply"):
                Ap = matvec(p)
            alpha = rz / total(lane_dot(p, Ap))
            xn = x + alpha[..., None, None] * p
            rn = r - alpha[..., None, None] * Ap
            with T.span("precond.apply"):
                zn, rzn = M(rn)
            rzn, rrn = total(rzn, lane_dot(rn, rn))
            pn = zn + (rzn / rz)[..., None, None] * p
            sel = act[..., None, None]
            x = torch.where(sel, xn, x)
            r = torch.where(sel, rn, r)
            p = torch.where(sel, pn, p)
            rz = torch.where(act, rzn, rz)
            rr = torch.where(act, rrn, rr)
            it = it + act.to(it.dtype)
    return x, it
