"""stencil_apply_roofline: percent of the roofline of the stencil apply: the
benchmark's bound of the applies a call makes (``benchmark/stencil_roofline.py``;
the program's ``stencil.applies`` and ``stencil.lane_applies`` counters) over
the device time launched inside the program's ``operator.apply`` spans, per
call (``benchmark/spans.py``).  Nothing when the step holds no stencils or
the program has no such counter."""
from benchmark import spans, stencil_roofline


def read(ctx):
    if ctx.trace is None:
        return None
    shape = stencil_roofline.shape_of(ctx.system)
    applies = spans.counter(ctx, "stencil.applies")
    if shape is None or not applies:
        return None
    ms = spans.device_ms(ctx, "operator.apply")
    if not ms:
        return None
    lanes = spans.counter(ctx, "stencil.lane_applies") / applies
    return 100.0 * applies * stencil_roofline.bound_s(*shape, lanes) / (1e-3 * ms)
