"""pcg_bodies_per_call: PCG body evaluations per call, the program's
``pcg.bodies`` counter (``chunk`` per convergence read) over the recorded
calls of ``benchmark/layers.py``: the lock-step iterations rounded up to
the chunk."""
from benchmark import layers


def read(ctx):
    return layers.program(ctx, "bodies")
