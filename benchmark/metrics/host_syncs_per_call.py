"""host_syncs_per_call: CUDA runtime calls inside the online step that block
the host on the device (stream, device and event synchronizations and
synchronous copies) per call, from the profiled calls of
``benchmark/layers.py``: where the host waits, the card idles next."""
from benchmark import layers


def read(ctx):
    return layers.device(ctx, "syncs")
