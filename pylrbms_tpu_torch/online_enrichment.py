"""Online adaptive enrichment: Doerfler marking + solve/estimate/enrich loop.

The port of ``pylrbms_tpu/online_enrichment.py`` (the parabolic variant is
not ported yet):

* :func:`doerfler_marking`: square the indicators (they are already squared
  quantities — the reference's double squaring is replicated on purpose),
  sort descending, return the smallest prefix whose cumulative sum exceeds
  theta * total.
* :class:`AdaptiveEnrichment`: solve -> estimate -> mark (Doerfler +
  age-based) -> enrich marked subdomains (corrector solves) -> re-reduce;
  loop until eta <= target_error or enrichment_steps exhausted; metrics
  callback hook.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.corrector import BatchedCorrector
from .reductor import ExtensionError
from .utils.logging import getLogger
from .utils.timers import GLOBAL_TIMINGS


def doerfler_marking(indicators, theta: float):
    """The smallest set of subdomains (largest squared indicators first)
    whose squared indicators sum to more than theta * total."""
    if not 0.0 < theta <= 1.0:
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    if isinstance(indicators, torch.Tensor):
        indicators = indicators.detach().cpu().numpy()
    ind = np.asarray(indicators, dtype=float).reshape(-1) ** 2
    order = np.argsort(-ind, kind="stable")
    sorted_vals = ind[order]
    over = np.cumsum(sorted_vals) > theta * sorted_vals.sum()
    if over.any():
        return [int(i) for i in order[:int(np.argmax(over)) + 1]]
    return [int(i) for i in order]


class AdaptiveEnrichment:
    """Adaptive online enrichment of a reduced model for one parameter at a
    time; ``batched_correctors`` solves all marked patches in one masked PCG
    on the device (:class:`~pylrbms_tpu_torch.ops.corrector.BatchedCorrector`),
    otherwise one dense host-assembled patch solve per marked subdomain."""

    def __init__(self, grid_and_problem_data, discretization, block_space,
                 reductor, rd, target_error: float,
                 marking_doerfler_theta: float = 0.33,
                 marking_max_age: int = 4,
                 batched_correctors: bool = True):
        self.grid_and_problem_data = grid_and_problem_data
        self.discretization = discretization
        self.block_space = block_space
        self.reductor = reductor
        self.rd = rd
        self.target_error = float(target_error)
        self.marking_doerfler_theta = float(marking_doerfler_theta)
        self.marking_max_age = int(marking_max_age)
        self.batched_correctors = batched_correctors
        self._corrector = None
        self.logger = getLogger("pylrbms.online_enrichment")

    def estimate(self, u, mu, decompose: bool = False):
        return self.rd.estimate(u, mu, decompose=decompose)

    def _enrich_once(self, u, mu, indicators, age_count):
        marked = set(doerfler_marking(indicators, self.marking_doerfler_theta))
        n_doerfler = len(marked)
        for ii in np.where(age_count > self.marking_max_age)[0]:
            marked.add(int(ii))
        self.logger.info3(
            f"marked {n_doerfler}/{self.block_space.K} subdomains (Doerfler) "
            f"+ {len(marked) - n_doerfler} (age)")
        # reconstruct once, before the bases change mid-round
        u_full = self.rd.reconstruct(u)
        T = GLOBAL_TIMINGS
        if self.batched_correctors:
            if self._corrector is None:
                self._corrector = BatchedCorrector(self.discretization)
            marked_sorted = sorted(marked)
            with T.span('enrich: corrector solve') as _s:
                W = self._corrector.solve(marked_sorted, mu, current_solution=u_full)
                _s["sync"] = W
            with T.span('enrich: basis extension'):
                W = W.detach().cpu().numpy()
                for i, ii in enumerate(marked_sorted):
                    try:
                        self.reductor.extend_basis_local(ii, W[i])
                    except ExtensionError:
                        pass
        else:
            for ii in sorted(marked):
                self.reductor.enrich_local(ii, u, mu, current_solution=u_full)
        with T.span('enrich: re-reduction') as _s:
            self.rd = self.reductor.reduce()
            _s["sync"] = self.rd.A_red
        for ii in range(self.block_space.K):
            age_count[ii] = 1 if ii in marked else age_count[ii] + 1
        return len(marked)

    def solve(self, mu, enrichment_steps=np.inf, callback=None):
        mu = self.discretization.parse_parameter(mu)
        enrichment_step = 1
        age_count = np.ones(self.block_space.K)
        local_problem_solves = 0
        rb_size = self.rd.solution_dim
        while True:
            with GLOBAL_TIMINGS.span('enrich: ROM online step') as _s:
                u, eta, indicators = self.rd.online_step(mu)
                _s["sync"] = eta
            eta = float(eta)
            if callback:
                callback(self.rd, u, mu, {
                    "eta": eta,
                    "local_problem_solves": local_problem_solves,
                    "global RB size": self.rd.solution_dim,
                    "local RB sizes": list(map(int, self.rd.sizes))})
            if eta <= self.target_error:
                self.logger.info3(f"eta {eta:.3e} <= target {self.target_error:.3e}")
                return u, self.rd, self.reductor
            if enrichment_step > enrichment_steps:
                self.logger.warning(
                    f"eta {eta:.3e} > target {self.target_error:.3e}, stopping "
                    f"after {enrichment_steps} enrichment steps")
                return u, self.rd, self.reductor
            enrichment_step += 1
            local_problem_solves = self._enrich_once(u, mu, indicators, age_count)
            self.logger.info3(f"RB size {rb_size} -> {self.rd.solution_dim}")
            rb_size = self.rd.solution_dim
