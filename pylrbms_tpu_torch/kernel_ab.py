"""A/B of the kernel source against a variant of it on one GPU.

    python3 -m pylrbms_tpu_torch.kernel_ab VARIANT.cu [--shape SHAPE ...]

Run from the repository root (it uses ``chip_smoke.kernel_case``).  Builds
the package's ``csrc/block_kernels.cu`` and VARIANT.cu (a copy of it with
one change, same C interface) each into its own library, then holds both
to the plain versions and times them at each shape in turns "base,
variant, variant, base" (L2 flushed, median of 20 CUDA-event times; each
line gives the max error, kernel, plain, library and bound ms).  SHAPE is
``kind,G,K,N,B,matrix dtype,vector dtype``, e.g.
``block_matvec,2,64,384,256,f32,f32``; the default is every main-path
shape of ``PERF.md`` section 6.  Every line carries the card's name and
power limit.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .ops import hopper_kernels as hk
from .utils.precision import pin_precision

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
MAIN_PATH_SHAPES = [
    "precond_dot,1,64,1536,1,f32,f32", "block_matvec,1,64,1536,1,f64,f64",
    "block_matvec,1,64,1536,16,f64,f64", "precond_dot,1,64,384,256,bf16,f32",
    "block_matvec,2,64,384,256,f32,f32", "block_matvec,2,64,384,1,f32,f32",
    "block_matvec,1,64,384,12,f32,f32", "block_matvec,1,64,384,1,f32,f32",
    "precond_dot,1,64,384,1,bf16,f32"]
TURNS = ("base", "variant", "variant", "base")


def parse_shape(text):
    kind, G, K, N, B, mdt, vdt = text.split(",")
    return kind, int(G), int(K), int(N), int(B), DTYPES[mdt], DTYPES[vdt]


def load_library(source, library):
    """Build ``source`` into ``library`` and load it, leaving the
    package's own source and library in place for every later call."""
    saved = hk.SOURCE, hk.LIBRARY
    hk.SOURCE, hk.LIBRARY = source, library
    hk._lib.cache_clear()
    try:
        hk.build()
        return hk._lib()
    finally:
        hk.SOURCE, hk.LIBRARY = saved
        hk._lib.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", help="the variant's .cu source")
    ap.add_argument("--shape", action="append", help="kind,G,K,N,B,mdt,vdt (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this probe runs only on a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs                              # the repository root's smoke run

    smi = cs.smi_line()
    pin_precision()
    libs = {"base": load_library(hk.SOURCE, hk.LIBRARY),
            "variant": load_library(os.path.abspath(args.variant),
                                    os.path.join(hk.BUILD_DIR, "libblock_kernels_variant.so"))}
    dev = torch.device("cuda", 0)
    lib = hk._lib
    try:
        for shape in map(parse_shape, args.shape or MAIN_PATH_SHAPES):
            for turn in TURNS:
                hk._lib = lambda t=turn: libs[t]             # noqa: E731
                rng = np.random.default_rng(cs.SEED)
                randn = lambda s: torch.as_tensor(rng.standard_normal(s), device=dev)  # noqa: E731
                print(f"{turn:7s} [{smi}]", end=" ", flush=True)
                cs.kernel_case(hk, torch, dev, randn, *shape)
            torch.cuda.empty_cache()
    finally:
        hk._lib = lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
