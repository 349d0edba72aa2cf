"""A/B of the kernel source against variants of it on one GPU.

    python3 kernel_ab.py [VARIANT.cu ...] [--define NAME=VALUE ...]
        [--shape SHAPE ... | --dmma | --tensor]

Run from the repository root, beside ``chip_smoke.py``, whose
``kernel_case`` and shape tables it uses.  Builds the package's
``csrc/block_kernels.cu`` and each VARIANT.cu (a copy of it
with one change, same C interface) into libraries of their own, all
``nvcc`` runs started together, then holds each to the plain versions and
times them at each shape in turns "base, variants, variants reversed, base"
(L2 flushed, median of 20 CUDA-event times; each line gives the max error,
kernel, plain, library and bound ms).  A turn that disagrees with the plain
version is reported and the run goes on; the exit code is then 1.  SHAPE
is ``kind,G,K,N,B,matrix dtype,vector dtype``, e.g.
``block_matvec,2,64,384,256,f32,f32`` (``stencil2_apply,Q,K,N,B,dt,dt``
for the 2D stencil kernel on Q random components, K square subdomains of N
= 6 s^2 dofs: ``chip_smoke.stencil_case``); the default is the kernel phase's
path shapes (``chip_smoke.PATH_SHAPES``), ``--dmma`` the dmma route's f64
shapes (``chip_smoke.DMMA_SHAPES``), ``--tensor`` the tensor route's
shapes (``chip_smoke.TENSOR_SHAPES``).  ``--define NAME=VALUE`` makes a variant
of the package's source with the one ``constexpr`` line of that name set
to VALUE (e.g. ``TC_A_INFLIGHT_LANES=32``, ``TC_MAX_STAGES=3``), written
under ``_build/``; each ``--define`` is a variant of its own.  Every line
carries the card's name and power limit.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from pylrbms_tpu_torch.ops import hopper_kernels as hk
from pylrbms_tpu_torch.utils.precision import pin_precision

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def parse_shape(text):
    """``kind,G,K,N,B,mdt,vdt`` -> the shape as the tables hold it."""
    kind, G, K, N, B, mdt, vdt = text.split(",")
    return kind, int(G), int(K), int(N), int(B), mdt, vdt


def define_variant(name_value):
    """A copy of the package's source with ``constexpr <type> NAME = ...;``
    set to VALUE, under ``_build/``; returns its path."""
    name, value = name_value.split("=", 1)
    with open(hk.SOURCE) as f:
        src = f.read()
    pattern = re.compile(rf"^(constexpr \w+ {re.escape(name)} = )[^;]+;", re.M)
    if len(pattern.findall(src)) != 1:
        raise SystemExit(f"kernel_ab: no single constexpr line named {name} in {hk.SOURCE}")
    os.makedirs(hk.BUILD_DIR, exist_ok=True)
    path = os.path.join(hk.BUILD_DIR, f"{name}_{value}.cu".replace("/", "_"))
    with open(path, "w") as f:
        f.write(pattern.sub(lambda m: m.group(1) + value + ";", src))
    return path


def build_all(sources):
    """``{name: library}`` for ``{name: source}``, the builds in parallel;
    the package's own library is left in place."""
    libraries = {name: (hk.LIBRARY if src == hk.SOURCE else
                        os.path.join(hk.BUILD_DIR, f"libblock_kernels_{name}.so"))
                 for name, src in sources.items()}
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda n: hk.build(sources[n], libraries[n]), sources))
    return {name: hk.open_library(lib) for name, lib in libraries.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="the variants' .cu sources")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE: a variant with that constexpr set (repeatable)")
    ap.add_argument("--shape", action="append", help="kind,G,K,N,B,mdt,vdt (repeatable)")
    ap.add_argument("--dmma", action="store_true", help="the dmma route's f64 shapes")
    ap.add_argument("--tensor", action="store_true", help="the tensor route's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this probe runs only on a GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    pin_precision()
    variants = [*args.variants, *map(define_variant, args.define)]
    names = [os.path.splitext(os.path.basename(v))[0] for v in variants]
    libs = build_all({"base": hk.SOURCE,
                      **{n: os.path.abspath(v) for n, v in zip(names, variants)}})
    turns = ["base", *names, *names[::-1], "base"] if names else ["base"]
    shapes = (list(map(parse_shape, args.shape)) if args.shape
              else [(*s, "f64", "f64") for s in cs.DMMA_SHAPES] if args.dmma
              else cs.TENSOR_SHAPES if args.tensor else cs.PATH_SHAPES)
    dev = torch.device("cuda", 0)
    lib, failed = hk._lib, 0
    try:
        for kind, G, K, N, B, mdt, vdt in shapes:
            for turn in turns:
                hk._lib = lambda t=turn: libs[t]             # noqa: E731
                rng = np.random.default_rng(cs.SEED)
                randn = lambda s: torch.as_tensor(rng.standard_normal(s), device=dev)  # noqa: E731
                print(f"{turn:9s} [{smi}]", end=" ", flush=True)
                try:
                    cs.kernel_case(hk, torch, dev, randn, kind, G, K, N, B,
                                   DTYPES[mdt], DTYPES[vdt])
                except AssertionError as err:
                    failed += 1
                    print(f"{turn:9s} FAILED: {err}", flush=True)
            torch.cuda.empty_cache()
    finally:
        hk._lib = lib
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
