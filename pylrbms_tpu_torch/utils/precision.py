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


# Elementwise functions that torch's CPU build may hand to MKL's vector math
# library (VML) for contiguous float tensors, in chunks of 2048 elements run
# on the intra-op threads.
_VML_FUNCTIONS = ("acos", "asin", "atan", "cos", "erf", "erfc", "erfinv", "exp",
                  "expm1", "log", "log10", "log1p", "log2", "sin", "sqrt", "tan", "tanh")


def init_cpu_vector_math() -> None:
    """Make the process's first call of each VML-backed function on one
    element per float dtype, on the calling thread.

    MKL's VML chooses its kernels on a process's first call.  When two
    intra-op threads make that first call at once (a tensor of more than
    2048 elements), one of them can run another kernel than the one torch
    asks for: on an AVX-512 Xeon, 15 of 1600 fresh processes at 8 threads
    computed one thread's chunk of their first float64 ``cos`` with MKL's AVX2
    enhanced-performance kernel (~27 bits, up to 6.8e-9 relative) instead
    of the AVX-512 high-accuracy one.  An assembled operator then carries
    errors of ~5e-10.  One element runs inline on the calling thread, so
    after this call no first call is concurrent.  The package calls it on
    import."""
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for name in _VML_FUNCTIONS:
            getattr(torch, name)(x)


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
