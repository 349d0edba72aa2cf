"""pcg_iters: mean lock-step PCG iteration count per call over the traced
calls' parameter batches, read by the step's own iteration probe (a solve
of its own per batch) after the window."""


def read(ctx):
    if not ctx.batches:
        return None
    return sum(ctx.system.iterations(mus) for mus in ctx.batches) / len(ctx.batches)
