"""Matmul-precision pinning and device selection.

The port of ``pylrbms_tpu/utils/precision.py``.  On the TPU, f32 matmuls
defaulted to bf16 MXU passes and stalled CG at ~2e-2 relative residual; the
GPU analog is TF32, which keeps ~3 decimal digits and breaks assembly and
Krylov solves the same way.  :func:`pin_precision` turns every reduced-
precision float32 matmul path off; the entry points (``discretize``,
``make_online_step``) call it.
"""
from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full-precision float32 matmuls: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device(name=None) -> torch.device:
    """``torch.device`` for ``name`` (default ``"cpu"``); raises when a CUDA
    device is asked for and none is available — the port never silently
    falls back to the CPU."""
    dev = torch.device("cpu" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
