"""pcg_self_device_ms_per_call: device milliseconds per call launched inside
the program's ``solve`` span but outside its ``operator.apply`` and
``precond.apply`` spans: the CG vector updates, the selects and the dot
products, from the profiled calls of ``benchmark/layers.py``."""
from benchmark import layers


def read(ctx):
    return layers.device(ctx, "device_ms", "pcg_self")
