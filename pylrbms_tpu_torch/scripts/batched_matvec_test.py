"""Batched block-operator apply on the card: the port of ``scripts/batched_matvec_test.py``.

The batch-width analog of the reference's thread-pool invariant: the
assembled block operator (OS2015, S x S subdomains, half M, nref 1)
applied to a batch of N vectors in one call must equal the per-vector
applies; prints the time per batched apply.

    python -m pylrbms_tpu_torch.scripts.batched_matvec_test [N S M W] [--device cpu]

:func:`main` returns the time per apply and the largest lane difference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(N=8, S=2, M=1, W=1, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.os2015 import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    gpd = init_grid_and_problem({'num_subdomains': [S, S],
                                 'half_num_fine_elements_per_subdomain_and_dim': M,
                                 'num_refinements': 1})
    d, _ = discretize(gpd, device=dev)
    A = d.op.assemble(torch.tensor([1.0, 0.5], dtype=d.dtype, device=dev))
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(N, d.space.K, d.space.N)), device=dev)

    Y = A.apply(X)
    for _ in range(W):
        A.apply(X)
    sync()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        Y = A.apply(X)
    sync()
    dt = (time.perf_counter() - t0) / reps
    flops = 2.0 * N * d.space.K * d.space.N ** 2
    print(f'batched matvec: batch={N} dofs={d.space.K * d.space.N} '
          f'{dt * 1e3:.3f} ms/apply  {flops / dt / 1e9:.2f} GFLOP/s')

    # correctness: batched == per-vector
    worst = 0.0
    for i in range(N):
        yi = A.apply(X[i])
        err = float((yi - Y[i]).abs().max() / (Y[i].abs().max() + 1e-30))
        worst = max(worst, err)
        assert err < 1e-10, "batched apply must match per-vector apply"
    print('batched == per-vector: OK')
    return {"ms": dt * 1e3, "max_lane_err": worst}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("args", type=int, nargs="*", help="N S M W")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(*a.args, device=a.device)


if __name__ == '__main__':
    cli()
