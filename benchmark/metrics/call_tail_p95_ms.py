"""call_tail_p95_ms: 95th percentile of the latency of every batched call
of a measured window, from its submission until its answers are
synchronized on the device (host clock): ``call_p95_ms`` read per layer,
in a cell where the tail cannot be bounded end to end (a window of some
tens of long calls).  A traced run measures such a window, untraced and
``--seconds`` long, before its trace."""
import numpy as np

WINDOW = True


def read(ctx):
    if not ctx.window_latencies_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.window_latencies_s), 95))
