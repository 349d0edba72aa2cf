"""device_ops_per_call: device operations (kernels, copies, fills) the host
dispatched per batched call, counted in the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.calls == 0 or not t.device:
        return None
    return len(t.device) / t.calls
