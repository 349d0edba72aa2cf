"""solve_host_ms_per_call: wall milliseconds per call inside the program's
``solve`` span (host clock; its convergence reads wait for the device),
over the recorded calls of ``benchmark/layers.py``."""
from benchmark import layers


def read(ctx):
    return layers.program(ctx, "solve")
