"""block_matvec_roofline: percent of the roofline of the hand block_matvec
kernel: the benchmark's bound per launch (``benchmark/roofline.py``) over
the kernel's mean device time in the trace.  Nothing when the cell's step
did not launch it."""
from benchmark.roofline import share_pct


def read(ctx):
    if ctx.trace is None:
        return None
    n, seconds = ctx.trace.kernel("block_matvec")
    return share_pct("block_matvec", ctx.launches.get("block_matvec", {}), n, seconds)
