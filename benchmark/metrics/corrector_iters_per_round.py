"""corrector_iters_per_round: PCG iterations of the enrichment's patch
corrector per round, the program's ``corrector.iters`` counter over its
``enrich.rounds`` counter, from the recorded calls of ``benchmark/spans.py``
(a round's solve stops at a relative residual of 1e-10 or at its cap)."""
from benchmark import spans


def read(ctx):
    iters, rounds = spans.counter(ctx, "corrector.iters"), spans.counter(ctx, "enrich.rounds")
    if iters is None or not rounds:
        return None
    return iters / rounds
