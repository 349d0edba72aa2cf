"""basis_extension_host_ms_per_call: wall milliseconds per call inside the
program's ``enrich: basis extension`` spans (the corrections copied to the
host and Gram-Schmidt in the local energy products there), from the
recorded calls of ``benchmark/layers.py``'s program timings."""
from benchmark import layers

SPAN = "enrich: basis extension"


def read(ctx):
    got = layers.of(ctx)["program"]
    return None if got is None else got["host_ms"].get(SPAN)
