"""queries_per_s: parameter queries answered (U and indicators on the
device) over the whole window's time, host clock; only finished calls count."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 and ctx.trace is None else None
