"""Times the dmma route of ``csrc/block_kernels.cu`` at every block tile on
one GPU.

    python3 -m pylrbms_tpu_torch.dmma_tile_probe

Run from the repository root (it uses ``chip_smoke``).  For each f64 shape
of ``chip_smoke.DMMA_SHAPES``, calls the C entry with
route ``hk.DMMA`` at each ``(rows, lanes)`` of ``hk.DMMA_TILES``, holds the
result to the plain version (max relative error printed) and times it as
``chip_smoke.kernel_case`` does (L2 flushed, median of 20 CUDA-event
times).  The tile ``hk.plan`` picks is starred: the probe is how its rule
(``hk._dmma_tile``) was chosen.  Prints the card's name and power limit.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import math
import sys

import torch

from .ops import hopper_kernels as hk


def main() -> int:
    if not torch.cuda.is_available():
        print("dmma_tile_probe: CUDA is not available; this probe runs only on a GPU",
              file=sys.stderr)
        return 2
    import chip_smoke as cs                              # the repository root's smoke run

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    lib, stream = hk._lib(), torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED)
    randn = lambda shape: torch.randn(shape, generator=g, device=dev,  # noqa: E731
                                      dtype=torch.float64)
    for kind, G, K, N, B in cs.DMMA_SHAPES:
        A, x = randn((G, K, N, N)), randn((B, K, N))
        coef = randn((B, G)) if G > 1 else None
        y, rz = torch.empty_like(x), torch.empty((B, K), device=dev, dtype=torch.float64)
        ref = ([hk.block_matvec_plain(A, x, coef)] if kind == "block_matvec"
               else list(hk.precond_dot_plain(A[0], x)))
        p = hk.plan(kind, G, K, N, B, torch.float64, torch.float64)
        out = []
        for rows, lanes in hk.DMMA_TILES:
            chunks = rows // hk.ROWS_PER_BLOCK
            tickets = torch.zeros(K * math.ceil(B / lanes), dtype=torch.int32, device=dev)
            partials = torch.empty(B * K * math.ceil(N / rows), dtype=torch.float64, device=dev)
            if kind == "block_matvec":
                args = (hk.DMMA, lanes, chunks, 0, 0, A.data_ptr(), x.data_ptr(),
                        None if coef is None else coef.data_ptr(), y.data_ptr(), G, K, N, B,
                        stream)
                call = lambda args=args: lib.pylrbms_block_matvec(*args)  # noqa: E731
            else:
                args = (hk.DMMA, lanes, chunks, 0, 0, A[0].data_ptr(), x.data_ptr(),
                        y.data_ptr(), rz.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
                        K, N, B, stream)
                call = lambda args=args: lib.pylrbms_precond_dot(*args)   # noqa: E731
            rc = call()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"dmma {rows}x{lanes}: launch failed with error {rc}")
            err = max(cs.rel(a.cpu(), b.cpu()) for a, b in zip((y, rz), ref))
            ms = cs.cuda_ms(call, flush=True)
            blocks = K * math.ceil(N / rows) * math.ceil(B / lanes)
            star = "*" if (chunks, lanes) == (p.chunks, p.lanes) else " "
            out.append(f"{star}{rows}x{lanes} {ms:.4f} ms ({blocks} blocks, err {err:.1e})")
        print(f"{kind} G={G} K={K} N={N} B={B}: " + "; ".join(out), flush=True)
        del A, x, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
