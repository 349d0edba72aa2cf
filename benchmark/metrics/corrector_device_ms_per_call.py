"""corrector_device_ms_per_call: device milliseconds per call launched
inside the program's ``enrich: corrector solve`` spans (the batched patch
PCG of every enrichment round), from the profiled calls of
``benchmark/spans.py``."""
from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "enrich: corrector solve")
