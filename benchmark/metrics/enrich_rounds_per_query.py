"""enrich_rounds_per_query: enrichment rounds per query, the program's
``enrich.rounds`` counter per call over the queries a call sends, from the
recorded calls of ``benchmark/spans.py``: each round is a corrector solve,
a basis extension and a re-reduction.  Nothing where the program has no
such counter."""
from benchmark import spans


def read(ctx):
    rounds = spans.counter(ctx, "enrich.rounds")
    if rounds is None or not ctx.batches:
        return None
    return rounds / len(ctx.batches[0])
