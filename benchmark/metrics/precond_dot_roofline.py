"""precond_dot_roofline: percent of the roofline of the hand precond_dot
kernel: the benchmark's bound per launch (``benchmark/roofline.py``) over
the kernel's mean device time in the trace."""
from benchmark.roofline import share_pct


def read(ctx):
    if ctx.trace is None:
        return None
    n, seconds = ctx.trace.kernel("precond_dot")
    return share_pct("precond_dot", ctx.launches.get("precond_dot", {}), n, seconds)
