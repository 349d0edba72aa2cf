"""rereduction_device_ms_per_call: device milliseconds per call launched
inside the program's ``enrich: re-reduction`` spans (the projection of the
grown bases and the estimator's images), from the profiled calls of
``benchmark/spans.py``."""
from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "enrich: re-reduction")
