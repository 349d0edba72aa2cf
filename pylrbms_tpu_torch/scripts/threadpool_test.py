"""Thread-pool dispatch on the card: the port of ``scripts/threadpool_test.py``.

The reference's concurrency invariant: W host threads each apply the
assembled block operator (OS2015, S x S subdomains, half M, nref 1) to
their share of N vectors, each thread on its own CUDA stream, and every
result must equal the sequential one exactly.

    python -m pylrbms_tpu_torch.scripts.threadpool_test [N S M W] [--device cpu]

:func:`main` returns the sequential and the pool's seconds.
"""
from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def operator_and_vectors(N, S, M, dev):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.os2015 import init_grid_and_problem
    gpd = init_grid_and_problem({'num_subdomains': [S, S],
                                 'half_num_fine_elements_per_subdomain_and_dim': M,
                                 'num_refinements': 1})
    d, _ = discretize(gpd, device=dev)
    A = d.op.assemble(torch.tensor([1.0, 0.5], dtype=d.dtype, device=dev))
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.normal(size=(d.space.K, d.space.N)), dtype=d.dtype, device=dev)
          for _ in range(N)]
    return d, A, xs


def main(N=16, S=2, M=1, W=4, device=None):
    from ..utils.precision import device as _device
    dev = _device(device)
    d, A, xs = operator_and_vectors(N, S, M, dev)
    A.apply(xs[0])                                   # first call (kernel load) once

    t0 = time.perf_counter()
    seq = [A.apply(x).cpu() for x in xs]
    t_seq = time.perf_counter() - t0

    streams = {}
    lock = threading.Lock()

    def on_stream(x):
        # each pool thread applies on a CUDA stream of its own
        if dev.type != "cuda":
            return A.apply(x).cpu()
        tid = threading.get_ident()
        with lock:
            s = streams.setdefault(tid, torch.cuda.Stream(dev))
        s.wait_stream(torch.cuda.default_stream(dev))
        with torch.cuda.stream(s):
            y = A.apply(x)
            out = y.to("cpu", non_blocking=False)
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=W) as pool:
        par = list(pool.map(on_stream, xs))
    t_par = time.perf_counter() - t0

    for a, b in zip(seq, par):                  # the reference's invariant
        assert torch.equal(a, b), "thread-parallel result differs"
    print(f"threadpool_test: N={N} S={S} M={M} W={W}: sequential "
          f"{t_seq * 1e3:.1f} ms, {W}-thread pool {t_par * 1e3:.1f} ms "
          f"({len(streams)} CUDA streams), results identical")
    return {"t_seq": t_seq, "t_par": t_par, "streams": len(streams), "identical": True}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("args", type=int, nargs="*", help="N S M W")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(*a.args, device=a.device)


if __name__ == '__main__':
    cli()
