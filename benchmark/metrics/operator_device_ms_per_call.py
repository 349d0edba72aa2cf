"""operator_device_ms_per_call: device milliseconds per call launched inside
the program's ``operator.assemble`` and ``operator.apply`` spans (the
operator at theta, and every operator apply of the PCG), from the profiled
calls of ``benchmark/layers.py``."""
from benchmark import layers


def read(ctx):
    return layers.device(ctx, "device_ms", "operator.assemble", "operator.apply")
