"""pcg_ops_per_body: device operations launched inside the program's
``solve`` span per PCG body evaluation (its ``pcg.bodies`` counter), both
per call of ``benchmark/layers.py``: the launches a CUDA graph of a body
would replace."""
from benchmark import layers


def read(ctx):
    ops, bodies = layers.device(ctx, "ops", "solve"), layers.program(ctx, "bodies")
    if ops is None or not bodies:
        return None
    return ops / bodies
