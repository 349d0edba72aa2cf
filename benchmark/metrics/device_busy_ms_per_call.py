"""device_busy_ms_per_call: milliseconds per batched call in which some
device operation ran, from the trace of device activity: the card's own
work a call, steady where the host's clock is not."""


def read(ctx):
    t = ctx.trace
    if t is None or t.calls == 0 or not t.device:
        return None
    return 1e3 * t.busy_s / t.calls
