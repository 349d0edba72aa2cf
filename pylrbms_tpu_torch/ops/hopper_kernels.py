"""Hand-written Hopper kernels of the PCG body, their plain versions, the
build loader and the launch counters.

The port of ``pylrbms_tpu/ops/pallas_kernels.py``.  Both Pallas TPU kernels
become CUDA C++ kernels for ``sm_90a`` in ``csrc/block_kernels.cu`` (see its
header for the design and what bounds them on the card):

* :func:`block_matvec` <- ``block_matvec_pallas``:
  ``y[b,k,i] = sum_g coef[b,g] sum_j A[g,k,i,j] x[b,k,j]``;
* :func:`precond_dot` <- ``precond_dot_pallas``:
  ``z[b,k] = F[k] @ r[b,k]`` and ``rz[b,k] = r[b,k] . z[b,k]``.

Dispatch rule: a wrapper runs its plain PyTorch version (``*_plain``) only
when the tensors it is given lie on the CPU.  For CUDA tensors it launches
the kernel or raises — there is no fallback and no switch.  Each wrapper
counts its kernel launches in its ``launches`` attribute and records the
shape and dtypes of each launch in its ``signatures`` set, so a caller can
hold the kernel to its plain version at exactly the shapes a path gave it.

The library is compiled with ``nvcc`` from the package's own sources into
``pylrbms_tpu_torch/_build/`` at first use and loaded with ``ctypes``
through a plain C interface; nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "block_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libblock_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
# (matrix dtype, vector dtype) pairs the kernels are instantiated for
_SUPPORTED = {(torch.float64, torch.float64), (torch.bfloat16, torch.float64),
              (torch.float32, torch.float32), (torch.bfloat16, torch.float32)}


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def block_matvec_plain(A, x, coef=None):
    """``einsum`` form of :func:`block_matvec`; A [G, K, N, N], x [B, K, N],
    coef [B, G] or None (G = 1)."""
    Ax = A.to(x.dtype)
    if coef is None:
        y = torch.einsum("kij,bkj->bki", Ax[0], x)
    else:
        y = torch.einsum("bg,gbki->bki", coef, torch.einsum("gkij,bkj->gbki", Ax, x))
    return y.contiguous()


def precond_dot_plain(F, r):
    """``einsum`` + ``sum`` form of :func:`precond_dot`; F [K, N, N],
    r [B, K, N] -> (z [B, K, N], rz [B, K])."""
    z = torch.einsum("kij,bkj->bki", F.to(r.dtype), r).contiguous()
    return z, (r * z).sum(-1)


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile ``csrc/block_kernels.cu`` into :data:`LIBRARY`; returns the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _lib():
    if (not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
        build()
    lib = ctypes.CDLL(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pylrbms_block_matvec.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pylrbms_block_matvec.restype = ci
    lib.pylrbms_precond_dot.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pylrbms_precond_dot.restype = ci
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library now."""
    _lib()


def _check_cuda(name, mat, *vecs):
    dev = vecs[0].device
    for t in (mat,) + vecs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                             f"got {[str(u.device) for u in (mat,) + vecs]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if (mat.dtype, vecs[0].dtype) not in _SUPPORTED:
        raise TypeError(f"{name}: unsupported dtypes {mat.dtype} x {vecs[0].dtype}")
    for t in vecs[1:]:
        if t.dtype != vecs[0].dtype:
            raise TypeError(f"{name}: vector dtypes differ ({t.dtype} vs {vecs[0].dtype})")


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def block_matvec(A, x, coef=None):
    """``y[b,k,i] = sum_g coef[b,g] sum_j A[g,k,i,j] x[b,k,j]``.

    A [G, K, N, N] (f64 | f32 | bf16), x [B, K, N] (f64 | f32), coef [B, G]
    in x's dtype or None (then G must be 1).  Returns y [B, K, N] in x's
    dtype, accumulated in f64 for f64 vectors and f32 otherwise."""
    if A.ndim != 4 or x.ndim != 3 or A.shape[1:3] != x.shape[1:] \
            or A.shape[2] != A.shape[3]:
        raise ValueError(f"block_matvec: bad shapes A {tuple(A.shape)}, x {tuple(x.shape)}")
    G, K, N, _ = A.shape
    B = x.shape[0]
    if coef is None and G != 1:
        raise ValueError("block_matvec: coef is required when G > 1")
    if coef is not None and tuple(coef.shape) != (B, G):
        raise ValueError(f"block_matvec: coef must be [{B}, {G}], got {tuple(coef.shape)}")
    tensors = (A, x) if coef is None else (A, x, coef)
    if all(t.device.type == "cpu" for t in tensors):
        return block_matvec_plain(A, x, coef)
    _check_cuda("block_matvec", *tensors)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().pylrbms_block_matvec(
            _DTYPE_CODE[A.dtype], _DTYPE_CODE[x.dtype], A.data_ptr(), x.data_ptr(),
            None if coef is None else coef.data_ptr(), y.data_ptr(),
            G, K, N, B, _stream(x))
    _raise_on("block_matvec", rc)
    block_matvec.launches += 1
    block_matvec.signatures.add((G, K, N, B, A.dtype, x.dtype))
    return y


def precond_dot(F, r):
    """Fused preconditioner apply and CG partials: F [K, N, N]
    (f64 | f32 | bf16), r [B, K, N] (f64 | f32) -> (z [B, K, N], rz [B, K])
    with ``z[b,k] = F[k] @ r[b,k]`` and ``rz[b,k] = r[b,k] . z[b,k]``."""
    if F.ndim != 3 or r.ndim != 3 or F.shape[0] != r.shape[1] \
            or F.shape[1] != r.shape[2] or F.shape[1] != F.shape[2]:
        raise ValueError(f"precond_dot: bad shapes F {tuple(F.shape)}, r {tuple(r.shape)}")
    if F.device.type == "cpu" and r.device.type == "cpu":
        return precond_dot_plain(F, r)
    _check_cuda("precond_dot", F, r)
    K, N, _ = F.shape
    B = r.shape[0]
    z = torch.empty_like(r)
    rz = torch.empty((B, K), dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        rc = _lib().pylrbms_precond_dot(
            _DTYPE_CODE[F.dtype], _DTYPE_CODE[r.dtype], F.data_ptr(), r.data_ptr(),
            z.data_ptr(), rz.data_ptr(), K, N, B, _stream(r))
    _raise_on("precond_dot", rc)
    precond_dot.launches += 1
    precond_dot.signatures.add((1, K, N, B, F.dtype, r.dtype))
    return z, rz


def reset_launch_counts() -> None:
    """Set both wrappers' launch counts to 0 and clear their signatures."""
    for fn in (block_matvec, precond_dot):
        fn.launches = 0
        fn.signatures = set()


def launch_counts() -> dict:
    return {"block_matvec": block_matvec.launches,
            "precond_dot": precond_dot.launches}


def launch_signatures() -> dict:
    """Per kernel, the distinct ``(G, K, N, B, matrix dtype, vector dtype)``
    it was launched with since the last :func:`reset_launch_counts`."""
    return {"block_matvec": set(block_matvec.signatures),
            "precond_dot": set(precond_dot.signatures)}


reset_launch_counts()
