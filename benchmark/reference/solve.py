"""The reference's solves: the exact one in float64, and the control, the
reference computed in TF32 in the program's place.

The program states float32 with TF32 off, so the nearest precision below is
TF32: float32 numbers rounded to 10 stored mantissa bits before each
product, products summed in float32 (what a TF32 tensor-core matmul does).
The control solves the same systems by block-Jacobi preconditioned CG (the
diagonal blocks of A(mu_bar), inverted in float64) to the step's tolerance,
every operand of the operator and preconditioner products rounded to TF32,
and evaluates the indicators on its answer rounded to TF32.  It is there to
show that the check fails a step computed below the stated precision.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse.linalg as spla
import torch


def exact(problem, mu: float) -> np.ndarray:
    """[K*N] float64 solution by a sparse LU."""
    return spla.splu(problem.matrix(mu)).solve(problem.b)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 stored mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _csr(A, device):
    A = A.tocsr()
    with warnings.catch_warnings():                # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, dtype=torch.int64),
            torch.as_tensor(A.indices, dtype=torch.int64),
            to_tf32(torch.as_tensor(A.data, dtype=torch.float32)), size=A.shape,
            check_invariants=False).to(device)


class Tf32Control:
    """``control(mus) -> U [B, K, N]`` for a batch; ``indicators(u, mu)`` of
    one answer, both below the stated precision."""

    def __init__(self, problem, tol: float, device, maxiter: int = 20000):
        m = problem.mesh
        self.problem, self.tol, self.maxiter = problem, tol, maxiter
        self.K, self.N, self.device = m.K, m.N, torch.device(device)
        self.A_q = [_csr(A, self.device) for A in problem.A_q]
        self.b = torch.as_tensor(problem.b, dtype=torch.float32, device=self.device)
        A_bar = problem.matrix(1.0).tocsr()
        blocks = np.stack([A_bar[k * m.N:(k + 1) * m.N, k * m.N:(k + 1) * m.N].toarray()
                           for k in range(m.K)])
        self.F = to_tf32(torch.as_tensor(np.linalg.inv(blocks), dtype=torch.float32,
                                         device=self.device))

    def _matvec(self, X, mus):
        """A(mu_b) x_b for X [n, B]."""
        X = to_tf32(X)
        return (self.A_q[0] @ X) + (self.A_q[1] @ X) * mus[None, :]

    def _precond(self, R):
        B = R.shape[1]
        r = to_tf32(R.T.reshape(B, self.K, self.N)).transpose(0, 1)      # [K, B, N]
        z = torch.bmm(r, self.F.transpose(1, 2))                         # [K, B, N]
        return z.transpose(0, 1).reshape(B, -1).T.contiguous()

    def __call__(self, mus: np.ndarray) -> torch.Tensor:
        mu = torch.as_tensor(mus, dtype=torch.float32, device=self.device)
        B = len(mus)
        b = self.b[:, None].expand(-1, B).contiguous()
        x = torch.zeros_like(b)
        r = b.clone()
        z = self._precond(r)
        p = z.clone()
        rz = (r * z).sum(0)
        bb = (b * b).sum(0)
        active = torch.ones(B, dtype=torch.bool, device=self.device)
        for _ in range(self.maxiter):
            active = active & ((r * r).sum(0) > self.tol ** 2 * bb)
            if not bool(active.any()):
                break
            Ap = self._matvec(p, mu)
            alpha = torch.where(active, rz / (p * Ap).sum(0), torch.zeros_like(rz))
            x = x + alpha * p
            r = r - alpha * Ap
            z = self._precond(r)
            rz_new = (r * z).sum(0)
            p = torch.where(active, z + (rz_new / rz) * p, p)
            rz = torch.where(active, rz_new, rz)
        return x.T.reshape(B, self.K, self.N)

    def indicators(self, u: np.ndarray, mu: float) -> np.ndarray:
        ut = to_tf32(torch.as_tensor(np.asarray(u, np.float32))).double().numpy()
        return self.problem.indicators(ut, mu)
