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
    """``torch.device`` for ``name``; the default (``None``) is the current
    CUDA device.  Raises when a CUDA device is meant and none is available:
    the port runs on the card unless the caller names the CPU
    (``device="cpu"``), and never falls back to it."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no device given and CUDA is not available: "
                               "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
