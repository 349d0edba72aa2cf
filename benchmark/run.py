"""The benchmark of ``pylrbms_tpu_torch``: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  Prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number the correctness check
compared with its limit (also the last lines on standard error).

Exits with another code than 0 and prints no result when CUDA is missing
or has fewer devices than the cell asks for, or when the JAX package or
JAX itself was loaded into the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()       # set-up is timed from here, before any heavy import

import argparse                      # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402
from pathlib import Path             # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)

# one serving process with one CPU thread: the step's host work runs on the
# main thread, and a pool of threads that wait on their slowest member
# spreads a call's host time on a shared host
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

FORBIDDEN = {"jax", "jaxlib", "flax", "pylrbms_tpu"}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must never pull in
    (whole names: ``pylrbms_tpu_torch`` is not ``pylrbms_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from . import harness, spec

    chips = spec.workload(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                "cuda:0", T_START)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
