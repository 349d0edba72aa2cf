"""Plain reference of one episode of adaptive online enrichment (Ohlberger
and Schindler, SIAM J. Sci. Comput. 37(6), 2015, sec. 4), in float64 with
PyTorch for the dense algebra and the problem of :mod:`.spe10_2d` for the
matrices, the patch systems and the estimator.

An episode starts from the offline local bases and answers one parameter:

    round: Galerkin projection of A(mu), b onto the block-diagonal span of
           the local bases and a dense solve; u = V c;
           estimate of u: the squared local quantities (eta_nc, eta_r,
           eta_df) of the full-order estimator on u, aggregated to
           eta = (sqrt(gamma_bar) |eta_nc| + |eta_r + eta_df| / sqrt(alpha_hat))
                 / sqrt(alpha_bar)
           and to the marking indicators
           (2 / alpha_bar) (gamma_bar eta_nc^2 + (eta_r + eta_df)^2 / alpha_hat);
    stop when eta <= target or after ``rounds`` enrichments;
    mark: Doerfler on the squared marking indicators (the smallest set,
          largest first, whose sum exceeds theta times the total), plus
          every subdomain not marked for more than ``max_age`` rounds;
    correct: for each marked subdomain k, the patch of k (k and the
          subdomains that touch it) solves its own SWIPDG system with zero
          Dirichlet data on the patch's boundary against the residual
          b - A(mu) u restricted to the patch (one dense LU a patch); the
          correction is the solution's rows on k;
    extend: Gram-Schmidt of the correction against k's basis in k's local
          energy product (two passes; kept when its norm after them exceeds
          1e-10 of its norm before).

Departures from the published loop, which the program makes and this file
follows: the marking indicators are squared twice (once in the
aggregation, once by the marking), as upstream pymor-based code does;
alpha is the ratio of the first coefficient alone (theta_0 = 1 here, so
alpha_bar = alpha_hat = 1 and gamma_bar = max(1, mu)); the corrector's
right-hand side is the global residual of the reconstruction restricted to
the patch; every marked patch is solved against the same reconstruction
(the round's bases do not change until all corrections are in); a round
that adds nothing still counts.  The program solves the patches by a
preconditioned CG to a relative residual of 1e-10 (capped at 300
iterations) where this file factors them.

Nothing here reads the system under test.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .os2015 import MU_BAR, MU_HAT

F64 = torch.float64
RTOL = 1e-10


def theta(mu: float) -> np.ndarray:
    return np.array([1.0, mu])


def constants(mu: float) -> tuple:
    """(alpha_bar, gamma_bar, alpha_hat) of the estimator at mu."""
    r_bar, r_hat = theta(mu) / theta(MU_BAR), theta(mu) / theta(MU_HAT)
    return float(r_bar[0]), float(r_bar.max()), float(r_hat[0])


def aggregate(parts, mu: float) -> tuple:
    """(eta, marking indicators [K]) of the squared local quantities."""
    nc, r, df = (np.asarray(p, np.float64) for p in parts)
    a_bar, g_bar, a_hat = constants(mu)
    eta = (np.sqrt(g_bar) * np.linalg.norm(nc)
           + np.linalg.norm(r + df) / np.sqrt(a_hat)) / np.sqrt(a_bar)
    return float(eta), (2.0 / a_bar) * (g_bar * nc ** 2 + (r + df) ** 2 / a_hat)


def doerfler(indicators, fraction: float) -> list:
    """The smallest set of subdomains, largest squared indicator first, whose
    squared indicators sum to more than ``fraction`` of their total."""
    v = np.asarray(indicators, np.float64) ** 2
    order = np.argsort(-v, kind="stable")
    over = np.cumsum(v[order]) > fraction * v.sum()
    n = int(np.argmax(over)) + 1 if over.any() else len(v)
    return sorted(int(i) for i in order[:n])


def patch_of(kx: int, ky: int, k: int) -> list:
    """k and the subdomains that share an edge or a corner with it."""
    sx, sy = k % kx, k // kx
    return sorted(y * kx + x for y in range(sy - 1, sy + 2) for x in range(sx - 1, sx + 2)
                  if 0 <= x < kx and 0 <= y < ky)


def gram_schmidt(v: torch.Tensor, basis: torch.Tensor, P: torch.Tensor):
    """v orthonormalized against the rows of ``basis`` in the product P, or
    None when nothing new is left."""
    norm0 = torch.sqrt(torch.clamp(v @ (P @ v), min=0.0))
    if norm0 <= 0.0:
        return None
    for _ in range(2):
        for b in basis:
            v = v - (b @ (P @ v)) * b
    norm = torch.sqrt(torch.clamp(v @ (P @ v), min=0.0))
    return v / norm if norm > RTOL * norm0 else None


class Episode:
    """``Episode(problem, bases, products)(mu)`` runs one episode.

    ``problem``: a :class:`.spe10_2d.Spe10Tri` (``matrix``, ``b``,
    ``parts``, ``patch_matrix``, ``mesh``); ``bases``: the offline local
    bases, K arrays [r_k, N]; ``products``: [K, N, N] local energy
    products.  The answer is (U [K, N], indicators [K] = eta_nc + eta_r +
    eta_df of U, history): one entry a round with its eta, local basis
    sizes, marked subdomains, and the corrections and their patch systems."""

    def __init__(self, problem, bases, products, target: float = 1e-2,
                 fraction: float = 0.33, max_age: int = 4, rounds: int = 3, device="cpu"):
        self.problem, self.device = problem, torch.device(device)
        self.bases = [torch.as_tensor(np.asarray(b, np.float64), device=self.device)
                      for b in bases]
        self.products = torch.as_tensor(np.asarray(products, np.float64), device=self.device)
        self.target, self.fraction, self.max_age, self.rounds = target, fraction, max_age, rounds

    def _galerkin(self, A, bases):
        """The reduced solution as a field [K*N] (numpy)."""
        m = self.problem.mesh
        blocks = [sp.csr_matrix(b.cpu().numpy().T) for b in bases]
        V = sp.block_diag(blocks, format="csr")                    # [K*N, R]
        A_red = torch.as_tensor((V.T @ (A @ V)).toarray(), device=self.device)
        b_red = torch.as_tensor(V.T @ self.problem.b, device=self.device)
        c = torch.linalg.solve(A_red, b_red).cpu().numpy()
        return (V @ c).reshape(m.K, m.N)

    def corrections(self, mu: float, u: np.ndarray, marked) -> list:
        """[(subdomain, correction [N], patch dofs, patch matrix [n, n],
        patch rhs [n], patch solution [n])] against the reconstruction u."""
        m = self.problem.mesh
        A = self.problem.matrix(mu)
        res = self.problem.b - A @ np.asarray(u, np.float64).reshape(-1)
        out = []
        for k in marked:
            subs = patch_of(m.kx, m.ky, k)
            dofs, Ap = self.problem.patch_matrix(mu, subs)
            bp = res[dofs]
            x = torch.linalg.solve(torch.as_tensor(Ap, device=self.device),
                                   torch.as_tensor(bp, device=self.device))
            i = subs.index(k)
            out.append((k, x[i * m.N:(i + 1) * m.N], dofs, Ap, bp, x.cpu().numpy()))
        return out

    def __call__(self, mu: float):
        m = self.problem.mesh
        A = self.problem.matrix(mu)
        bases = list(self.bases)
        age = np.ones(m.K)
        history, step = [], 1
        while True:
            u = self._galerkin(A, bases)
            parts = self.problem.parts(u, mu)
            eta, marking = aggregate(parts, mu)
            entry = {"eta": eta, "sizes": [int(b.shape[0]) for b in bases]}
            history.append(entry)
            if eta <= self.target or step > self.rounds:
                return u, sum(parts), history
            step += 1
            marked = set(doerfler(marking, self.fraction))
            marked |= {int(i) for i in np.where(age > self.max_age)[0]}
            marked = sorted(marked)
            corr = self.corrections(mu, u, marked)
            entry.update(marked=marked, corrections=corr)
            for k, w, *_ in corr:
                v = gram_schmidt(w, bases[k], self.products[k])
                if v is not None:
                    bases[k] = torch.cat([bases[k], v[None]])
            age = np.where(np.isin(np.arange(m.K), marked), 1.0, age + 1.0)
