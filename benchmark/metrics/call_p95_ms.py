"""call_p95_ms: 95th percentile of the latency of every batched call of the
window, from its submission until its answers are synchronized on the
device (host clock)."""
import numpy as np


def read(ctx):
    if ctx.trace is not None or not ctx.latencies_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.latencies_s), 95))
