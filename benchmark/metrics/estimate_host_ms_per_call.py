"""estimate_host_ms_per_call: wall milliseconds per call inside the
program's ``estimate`` span (host clock: what the host spends there,
blocking copies included), over the recorded calls of
``benchmark/layers.py``."""
from benchmark import layers


def read(ctx):
    return layers.program(ctx, "estimate")
