"""The one traffic generator: a closed loop of batched parameter queries.

A traffic file gives (see ``traffic/*.json``):

* ``batch``: queries per call; ``clients``: callers, each waiting for its
  answer before it sends the next call (1: a parameter-study loop);
* ``mu``: ``{"low", "high"}``, each query's parameter drawn uniformly;
* ``warmup_calls``: calls made in set-up, on batches of their own;
* ``trace_calls``: calls a traced run profiles; ``gap_calls``: calls it
  profiles apart, with CPU operators, to name the card's idle gaps;
* ``sample``: which answers the correctness check reads: ``calls`` drawn
  uniformly over the window's calls and, in each, the queries with the
  smallest and largest parameter and ``per_tile`` more drawn at random from
  each run of ``tile`` consecutive queries (a kernel tile of lanes), so a
  fault confined to one tile of a batch is read in every checked call.

Every draw comes from the run's seed, so one seed gives one sequence of
batches whatever the speed of the system, and every seed the same sizes.
"""
from __future__ import annotations

import numpy as np

# streams of the seed's draws: the window's batches, the warm-up batches,
# the choice of the answers to check
WINDOW, WARMUP, SAMPLE = 0, 1, 2


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % 2 ** 64, *stream])


class ClosedLoop:
    def __init__(self, spec: dict, seed: int):
        if spec.get("kind") != "closed_loop" or spec.get("clients", 1) != 1:
            raise ValueError(f"unsupported traffic: {spec}")
        self.spec, self.seed = spec, seed
        self.batch_size = int(spec["batch"])

    def mus(self, i: int, stream: int = WINDOW) -> np.ndarray:
        """[batch] parameters of call ``i``."""
        lo, hi = self.spec["mu"]["low"], self.spec["mu"]["high"]
        return rng(self.seed, stream, i).uniform(lo, hi, self.batch_size)


class Sample:
    """Reservoir sample of ``k`` calls over a window of unknown length,
    drawn from the seed, and the queries of each to check."""

    def __init__(self, spec: dict, seed: int):
        self.k = int(spec["sample"]["calls"])
        self.tile = int(spec["sample"]["tile"])
        self.per_tile = int(spec["sample"]["per_tile"])
        self.rng = rng(seed, SAMPLE)
        self.kept: list = []

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.kept.append((i, item))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.kept[j] = (i, item)

    def answers(self) -> list:
        """[(mu, U [K, N], indicators [K] or None)] on the host of the
        queries to check, and drop the kept calls.  A kept item is
        (mus, U, ind or None)."""
        out = []
        for _, (mus, U, ind) in self.kept:
            for lane in self.lanes_of(mus):
                out.append((float(mus[lane]), U[lane].cpu().numpy(),
                            ind[lane].cpu().numpy() if ind is not None else None))
        self.kept.clear()
        return out

    def lanes_of(self, mus: np.ndarray) -> list:
        """The smallest and the largest parameter and ``per_tile`` others
        from each tile of lanes."""
        ends = {int(np.argmin(mus)), int(np.argmax(mus))}
        picked = set(ends)
        for lo in range(0, len(mus), self.tile):
            rest = [j for j in range(lo, min(lo + self.tile, len(mus))) if j not in ends]
            n = min(self.per_tile, len(rest))
            picked |= {int(j) for j in self.rng.choice(rest, size=n, replace=False)} if n else set()
        return sorted(picked)
