"""oswald_device_ms_per_call: device milliseconds per call launched inside
the program's ``estimate.oswald`` span (the Oswald witness u - I_os(u) of
the estimator), from the profiled calls of ``benchmark/spans.py``."""
from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "estimate.oswald")
