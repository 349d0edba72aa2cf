"""Online adaptive enrichment: Doerfler marking + solve/estimate/enrich loop.

The port of ``pylrbms_tpu/online_enrichment.py``:

* :func:`doerfler_marking`: square the indicators (they are already squared
  quantities — the reference's double squaring is replicated on purpose),
  sort descending, return the smallest prefix whose cumulative sum exceeds
  theta * total.
* :class:`AdaptiveEnrichment`: solve -> estimate -> mark (Doerfler +
  age-based) -> enrich marked subdomains (corrector solves) -> re-reduce;
  loop until eta <= target_error or enrichment_steps exhausted; metrics
  callback hook.  :meth:`~AdaptiveEnrichment.solve` grows one basis that
  later calls share; :meth:`~AdaptiveEnrichment.episode` answers one query
  from an :class:`OfflineState` and puts that state back afterwards, so
  queries never see each other's enrichment.  Each round counts
  ``enrich.rounds``, ``enrich.marked`` (subdomains marked) and
  ``enrich.columns`` (columns Gram-Schmidt accepted) in
  ``GLOBAL_TIMINGS``.
* :class:`ParabolicAdaptiveEnrichment`: the same loop on the parabolic ROM,
  with correctors against the implicit-Euler defect at the worst time step.
"""
from __future__ import annotations

from dataclasses import dataclass

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


@dataclass
class OfflineState:
    """What an enrichment episode changes: the reductor's local bases and
    image cache (:meth:`~pylrbms_tpu_torch.reductor.LRBMSReductor.state`)
    and the reduced model."""
    reductor: tuple
    rd: object


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
        # PCG iterations of each corrector solve of the last solve()
        self.corrector_iters = []
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
                # inherit the reductor's mesh: the whole enrichment loop
                # (corrector, re-reduction) then runs K-sharded
                self._corrector.mesh = getattr(self.reductor, "mesh", None)
            marked_sorted = sorted(marked)
            with T.span('enrich: corrector solve') as _s:
                W = self._corrector.solve(marked_sorted, mu, current_solution=u_full)
                _s["sync"] = W
            self.corrector_iters.append(self._corrector.last_iters)
            added = 0
            with T.span('enrich: basis extension'):
                W = W.detach().cpu().numpy()
                for i, ii in enumerate(marked_sorted):
                    try:
                        added += self.reductor.extend_basis_local(ii, W[i])
                    except ExtensionError:
                        pass
        else:
            added = sum(self.reductor.enrich_local(ii, u, mu, current_solution=u_full)
                        for ii in sorted(marked))
        T.count("enrich.rounds")
        T.count("enrich.marked", len(marked))
        T.count("enrich.columns", added)
        with T.span('enrich: re-reduction') as _s:
            self.rd = self.reductor.reduce()
            _s["sync"] = self.rd.A_red
        for ii in range(self.block_space.K):
            age_count[ii] = 1 if ii in marked else age_count[ii] + 1
        return len(marked)

    def offline_state(self) -> OfflineState:
        """The state an :meth:`episode` starts from and leaves: the current
        bases, image cache and reduced model."""
        return OfflineState(reductor=self.reductor.state(), rd=self.rd)

    def restore(self, state: OfflineState) -> None:
        """Put ``state`` back (copies only: ``state`` stays as it was)."""
        self.reductor.restore(state.reductor)
        self.rd = state.rd

    def episode(self, mu, state: OfflineState, enrichment_steps=np.inf):
        """Answer one query from ``state`` and leave ``state`` behind:
        :meth:`solve`, then the answer U = V c [K, N] and its indicators
        eta_nc + eta_r + eta_df [K] (the reduced estimator's local parts of
        c: the full-order estimator of U), both float64, then
        :meth:`restore` in an ``enrich: restore`` span."""
        mu = self.discretization.parse_parameter(mu)
        try:
            c, rd, _ = self.solve(mu, enrichment_steps)
            U = rd.reconstruct(c)
            nc, r, df = rd.local_quantities(c, mu)
        finally:
            with GLOBAL_TIMINGS.span('enrich: restore'):
                self.restore(state)
        return U, nc + r + df

    def solve(self, mu, enrichment_steps=np.inf, callback=None):
        mu = self.discretization.parse_parameter(mu)
        enrichment_step = 1
        age_count = np.ones(self.block_space.K)
        self.corrector_iters = []
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


class ParabolicAdaptiveEnrichment:
    """Online adaptive enrichment of the parabolic LRBMS ROM for one
    parameter at a time.

    Per round: ROM trajectory -> fully projected parabolic estimate ->
    per-subdomain indicator (time-aggregated squared local parts
    eta_nc / eta_r / eta_df plus the time-derivative nonconformity) ->
    Doerfler + age marking -> batched corrector patch solves against the
    implicit-Euler defect f(t_b) - M (u_b - u_{b-1}) / dt - A u_b of the
    reconstructed trajectory at the worst step b -> local basis extension
    -> re-reduction."""

    def __init__(self, im, reductor, rd, target_error: float,
                 marking_doerfler_theta: float = 0.33,
                 marking_max_age: int = 4):
        self.im = im
        self.d = im.stationary
        self.reductor = reductor            # ParabolicLRBMSReductor
        self.rd = rd                        # ReducedParabolicModel (attached)
        self.target_error = float(target_error)
        self.marking_doerfler_theta = float(marking_doerfler_theta)
        self.marking_max_age = int(marking_max_age)
        self._corrector = None
        self.logger = getLogger("pylrbms.online_enrichment.parabolic")

    @staticmethod
    def _localize(parts):
        """[K] indicator from the decomposed parts (squared aggregation over
        time, the squared-locals convention of the pipeline)."""
        nc, r, df, _time_res, tdnc = (p.detach().cpu().numpy() for p in parts)
        return (nc ** 2 + r ** 2 + df ** 2).sum(axis=1) + (tdnc ** 2).sum(axis=1)

    def _enrich_once(self, c, mu, parts, age_count):
        K = self.d.space.K
        marked = set(doerfler_marking(self._localize(parts), self.marking_doerfler_theta))
        n_doerfler = len(marked)
        for ii in np.where(age_count > self.marking_max_age)[0]:
            marked.add(int(ii))
        self.logger.info3(f"marked {n_doerfler}/{K} subdomains (Doerfler) "
                          f"+ {len(marked) - n_doerfler} (age)")
        # corrector rhs: the implicit-Euler defect at the worst step b* (the
        # per-step elliptic residual is exhausted after one extension; the
        # parabolic defect keeps supplying new directions as b* moves)
        nc, r, df = (p.detach().cpu().numpy() for p in parts[:3])
        per_step = (nc ** 2 + r ** 2 + df ** 2).sum(axis=0)           # [nt+1]
        b_star = 1 + int(np.argmax(per_step[1:]))
        dt = self.im.T / self.im.nt
        u_b = self.reductor.reconstruct(c[b_star])
        u_bm1 = self.reductor.reconstruct(c[b_star - 1])
        mu_b = dict(mu)
        mu_b["_t"] = b_star * dt
        T = GLOBAL_TIMINGS
        with T.span('parabolic enrich: corrector solve') as _s:
            defect = (self.d.rhs(mu_b) - self.im.mass_apply((u_b - u_bm1) / dt)
                      - self.d.assemble(mu).apply(u_b))
            if self._corrector is None:
                self._corrector = BatchedCorrector(self.d)
                self._corrector.mesh = getattr(self.reductor, "mesh", None)
            mu_t = dict(mu)
            mu_t.setdefault("_t", 0.0)
            marked_sorted = sorted(marked)
            W = self._corrector.solve(marked_sorted, mu_t, rhs_full=defect)
            _s["sync"] = W
        with T.span('parabolic enrich: basis extension'):
            W = W.detach().cpu().numpy()
            for i, ii in enumerate(marked_sorted):
                try:
                    self.reductor.extend_basis_local(ii, W[i])
                except ExtensionError:
                    pass
        with T.span('parabolic enrich: re-reduction') as _s:
            self.rd = self.reductor.reduce().attach_instationary(self.im)
            _s["sync"] = self.rd.A_red
        for ii in range(K):
            age_count[ii] = 1 if ii in marked else age_count[ii] + 1
        return len(marked)

    def solve(self, mu, enrichment_steps=np.inf, callback=None):
        mu = self.d.parse_parameter(mu)
        enrichment_step = 1
        age_count = np.ones(self.d.space.K)
        local_problem_solves = 0
        rb_size = self.rd.solution_dim
        while True:
            with GLOBAL_TIMINGS.span('parabolic enrich: ROM trajectory + estimate') as _s:
                c = self.rd.solve(mu)
                eta, parts = self.rd.estimate(c, mu, projected=True)
                _s["sync"] = eta
            eta = float(eta)
            if callback:
                callback(self.rd, c, mu, {
                    "eta": eta,
                    "local_problem_solves": local_problem_solves,
                    "global RB size": self.rd.solution_dim,
                    "local RB sizes": list(map(int, self.rd.sizes))})
            if eta <= self.target_error:
                self.logger.info3(f"eta {eta:.3e} <= target {self.target_error:.3e}")
                return c, self.rd, self.reductor
            if enrichment_step > enrichment_steps:
                self.logger.warning(
                    f"eta {eta:.3e} > target {self.target_error:.3e}, "
                    f"stopping after {enrichment_steps} enrichment steps")
                return c, self.rd, self.reductor
            enrichment_step += 1
            local_problem_solves = self._enrich_once(c, mu, parts, age_count)
            self.logger.info3(f"RB size {rb_size} -> {self.rd.solution_dim}")
            rb_size = self.rd.solution_dim
