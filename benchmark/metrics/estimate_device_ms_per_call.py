"""estimate_device_ms_per_call: device milliseconds per call launched inside
the program's ``estimate`` span (the flux reconstruction included), from
the profiled calls of ``benchmark/layers.py``."""
from benchmark import layers


def read(ctx):
    return layers.device(ctx, "device_ms", "estimate")
