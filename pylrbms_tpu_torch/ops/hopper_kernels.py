"""Hand-written Hopper kernels of the PCG body, their plain versions, the
build loader and the launch counters.

The port of ``pylrbms_tpu/ops/pallas_kernels.py``.  Both Pallas TPU kernels
become CUDA C++ kernels for ``sm_90a`` in ``csrc/block_kernels.cu`` (see its
header for the design and what bounds them on the card):

* :func:`block_matvec` <- ``block_matvec_pallas``:
  ``y[b,k,i] = sum_g coef[b,g] sum_j A[g,k,i,j] x[b,k,j]``;
* :func:`precond_dot` <- ``precond_dot_pallas``:
  ``z[b,k] = F[k] @ r[b,k]`` and ``rz[b,k] = r[b,k] . z[b,k]``.

Two more kernels in the same library replace no Pallas kernel (the JAX
package's stencil applies are plain ``jnp``):

* :func:`stencil3_apply`: the lane-batched 3D hex Q1 stencil apply
  ``y[b,k,c] = sum_q theta[b,q] sum_j S[q,k,c,j] @ x[b, nbr_j(k,c)]`` on the
  folded component stencils of ``ops/matrixfree3d.fold_stencils3``;
* :func:`stencil2_apply`: the same for the 2D tri P1 stencil, each triangle
  coupled to itself, its in-cell partner and its two edge neighbours, on
  the folded components of ``ops/matrixfree.fold_stencils2``.

Each launch of the first two takes one of five routes, which :func:`plan`
picks from the shape and dtypes by arithmetic intensity (operations per
byte against the card's ridge): ``stream`` (memory-bound, B <= 16 lanes;
at 5-16 lanes the f64 and f32 pairs of both kernels take its ``ring``
form, a cp.async ring of A tiles with the product on the tensor cores, wherever rows are
16-byte multiples and the operands aligned; bf16 matrices, other rows and
misaligned operands keep the register stream at 16 lanes), ``dmma``
(every other f64-vector launch: tiled GEMMs on the f64 tensor cores),
``tensor`` (wgmma on split operands, fed by TMA from a producer warp:
bf16 F x f32 r in precond_dot, f32 x f32 in block_matvec) and ``tiles``
(SIMT, the other f32-vector pairs at many lanes, which no main path
launches).

Dispatch rule: a wrapper runs its plain PyTorch version (``*_plain``) only
when the tensors it is given lie on the CPU.  For CUDA tensors it launches
the kernel or raises — there is no fallback and no switch.  Each wrapper
counts its kernel launches in its ``launches`` attribute and, per shape and
dtypes, in its ``signatures`` dict, so a caller can hold the kernel to its
plain version at exactly the shapes a path gave it.

The library is compiled with ``nvcc`` from the package's own sources into
``pylrbms_tpu_torch/_build/`` at first use and loaded with ``ctypes``
through a plain C interface; nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
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


# routes (the ints the C entry points take) and what plan() knows of them;
# RING is the stream route's form for 5-16 lanes of both kernels
STREAM, TENSOR, TILES, RING, DMMA = 0, 1, 2, 3, 4
ROUTE_NAMES = {STREAM: "stream", TENSOR: "tensor", TILES: "tiles", RING: "ring",
               DMMA: "dmma"}
STREAM_LANES = (1, 4, 16)          # lane counts the stream kernels hold in registers
ROWS_PER_BLOCK = 32                # stream route: rows of one subdomain per block chunk
STREAM_CHUNKS = 8                  # stream route: most row chunks per block
SMEM_BYTES = 200 * 1024            # the kernels' largest dynamic shared memory
MMA_DEPTH = 32                     # tensor and ring routes: N a multiple of it; ring stage
TENSOR_ROWS = 128                  # tensor route: rows per block (two 64-row warpgroups)
TENSOR_LANES = (32, 128)           # tensor route: lanes per block
RING_ROWS = 64                     # ring route: rows per block (16 lanes)
# dmma route: (rows, lanes) a block
DMMA_TILES = ((64, 64), (64, 32), (32, 64), (32, 32))
SMS = 132                          # streaming multiprocessors of the H100 SXM
# (kernel, matrix dtype, vector dtype) pairs with a tensor-core route
TENSOR_PAIRS = {("precond_dot", torch.bfloat16, torch.float32),
                ("block_matvec", torch.float32, torch.float32)}
RING_PAIRS = {(kind, dt, dt) for kind in ("block_matvec", "precond_dot")
              for dt in (torch.float64, torch.float32)}
# H100 SXM at 700 W (NVIDIA's data sheet): bytes/s of HBM3, dense operations/s
# (f64 and f32 outside the tensor cores; f64 on them; TF32; bf16)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12, "f64 tensor": 67e12, "tf32": 495e12,
                  "bf16": 989e12}
# stencil3_apply: dofs a cell (hex Q1), blocks a cell (its own, then the
# -x, +x, -y, +y, -z, +z neighbours), vector dtypes (f32: 3xTF32 mma.sync;
# f64: SIMT)
STENCIL3_NB = 8
STENCIL3_SLOTS = 7
STENCIL_DTYPES = (torch.float32, torch.float64)
# stencil2_apply: dofs a triangle (tri P1), blocks a triangle (its own, then
# its in-cell partner across the diagonal, its neighbour across the vertical
# and across the horizontal edge); SIMT FMA for both vector dtypes
STENCIL2_NB = 3
STENCIL2_SLOTS = 4


class Plan(NamedTuple):
    route: int          # STREAM, RING, DMMA, TENSOR or TILES
    lanes: int          # stream, ring, dmma, tensor: lanes a block computes; else 0
    chunks: int         # stream, dmma: 32-row chunks per block; else 1
    blocks: int         # thread blocks of the launch

    @property
    def name(self) -> str:
        return ROUTE_NAMES[self.route]


def work(kind, G, K, N, B, mdt, vdt):
    """(operations, bytes) of one call: 2 G K N^2 B multiply-adds' worth of
    operations; each input read once and each output written once."""
    sm, sv = torch.finfo(mdt).bits // 8, torch.finfo(vdt).bits // 8
    nbytes = G * K * N * N * sm + 2 * B * K * N * sv
    nbytes += B * G * sv if G > 1 else 0                   # coef
    nbytes += B * K * sv if kind == "precond_dot" else 0   # rz
    return 2 * G * K * N * N * B, nbytes


@functools.lru_cache(maxsize=1024)
def plan(kind, G, K, N, B, mdt, vdt, aligned=True) -> Plan:
    """The route of one launch, by arithmetic intensity.  Below the ridge of
    the vector type's SIMT rate (operations/s over bytes/s: ~20 for f32, ~10
    for f64) the call is memory-bound and streams (B <= 16): in registers
    up to 4 lanes, through the ring at 5-16 lanes for the pairs in
    :data:`RING_PAIRS` (rows of 16-byte multiples: the copy zero-fills the
    columns past N), else in registers at 16 lanes.  Every other
    f64-vector launch (f64 or bf16 matrix, any N, aligned or not) takes the
    f64 tensor cores (``dmma``; block tile: :func:`_dmma_tile`).  Above the
    ridge the f32-vector pairs in :data:`TENSOR_PAIRS` take the tensor
    cores (``tensor``: wgmma fed by TMA, :data:`TENSOR_ROWS` rows x 32 lanes
    a block at B <= 32, so the harvest filter computes no empty lanes, else
    128), the other f32-vector pairs the SIMT tiles.  The ring and tensor
    routes need 16-byte aligned operands, the tensor route N % 32 == 0."""
    ops, nbytes = work(kind, G, K, N, B, mdt, vdt)
    simt = PEAK_OPS_PER_S["f64" if vdt == torch.float64 else "f32"]
    mma = N % MMA_DEPTH == 0 and aligned
    ring = aligned and N * (torch.finfo(vdt).bits // 8) % 16 == 0
    if ops / nbytes < simt / HBM_BYTES_PER_S and B <= STREAM_LANES[-1]:
        lanes = min(n for n in STREAM_LANES if n >= B)
        if lanes == STREAM_LANES[-1] and (kind, mdt, vdt) in RING_PAIRS and ring:
            return Plan(RING, lanes, 1, K * math.ceil(N / RING_ROWS))
        chunks = _stream_chunks(G, K, N, lanes, torch.finfo(vdt).bits // 8)
        return Plan(STREAM, lanes, chunks, K * math.ceil(N / (ROWS_PER_BLOCK * chunks)))
    if vdt == torch.float64:
        rows, lanes = _dmma_tile(K, N, B)
        return Plan(DMMA, lanes, rows // ROWS_PER_BLOCK,
                    K * math.ceil(N / rows) * math.ceil(B / lanes))
    if (kind, mdt, vdt) in TENSOR_PAIRS and mma:
        lanes = TENSOR_LANES[0] if B <= TENSOR_LANES[0] else TENSOR_LANES[1]
        return Plan(TENSOR, lanes, 1, K * math.ceil(N / TENSOR_ROWS) * math.ceil(B / lanes))
    if kind == "block_matvec":
        return Plan(TILES, 0, 1, K * math.ceil(N / 64) * math.ceil(B / 64))
    return Plan(TILES, 0, 1, K * math.ceil(B / 32))


def _dmma_tile(K, N, B):
    """(rows, lanes) of a dmma block (one of :data:`DMMA_TILES`): 64 x 64
    where that gives four blocks an SM, else 32 lanes a block (B > 32 in
    lane tiles; 64 x 32 is about as fast as 64 x 64 per element on the H100
    and fills more SMs); 32 rows where N <= 32 or 64 rows would leave fewer
    than two waves of blocks (PERF.md, the dmma tile probe)."""
    lanes = 32 if B <= 32 else 64
    rows = 64 if N > 32 else 32

    def blocks(r, l):
        return K * math.ceil(N / r) * math.ceil(B / l)
    if lanes == 64 and blocks(rows, 64) < 4 * SMS:
        lanes = 32
    if rows == 64 and blocks(64, lanes) < 2 * SMS:
        rows = 32
    return rows, lanes


def _stream_chunks(G, K, N, lanes, sv):
    """32-row chunks per stream block: one for a single lane (x is small);
    otherwise as many as keep >= 2 waves of blocks on the card, where all of
    x fits in shared memory (it is staged once per block and should cost
    little beside the block's rows of A)."""
    if lanes == 1 or G * lanes * 256 * math.ceil(N / 256) * sv > SMEM_BYTES:
        return 1
    chunks = 1
    while (chunks < STREAM_CHUNKS
           and K * math.ceil(N / (ROWS_PER_BLOCK * (chunks + 1))) >= 2 * SMS):
        chunks += 1
    return chunks


def bound(kind, G, K, N, B, mdt, vdt):
    """(ms, "bytes" | "operations"): the least time the card could take for
    one call — bytes over the HBM rate, or the operations over the card's
    best rate for the operand types, whichever is larger.  The rate does
    not depend on the route :func:`plan` picks (a SIMT kernel does not lower
    the roofline): f64 vectors at the f64 tensor-core peak; f32 vectors at
    the TF32 peak (bf16 peak for a bf16 matrix) with three products per
    product, the split that keeps f32 accuracy on the tensor cores."""
    ops, nbytes = work(kind, G, K, N, B, mdt, vdt)
    if vdt == torch.float64:
        rate = PEAK_OPS_PER_S["f64 tensor"]
    else:
        ops, rate = 3 * ops, PEAK_OPS_PER_S["bf16" if mdt == torch.bfloat16 else "tf32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


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


@functools.lru_cache(maxsize=16)
def stencil3_neighbours(kz, ky, kx, s):
    """[K C, 7] int64: the flat (k, c) cell index of each cell's own block
    and of its -x, +x, -y, +y, -z, +z neighbour on the global grid of kz x
    ky x kx subdomains of s^3 cells (k = (iz ky + iy) kx + ix, c = (cz s +
    cy) s + cx), K C where there is none."""
    nx, ny, nz = kx * s, ky * s, kz * s
    gz, gy, gx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")

    def flat(hx, hy, hz):
        k = ((hz // s) * ky + hy // s) * kx + hx // s
        return (k * s + hz % s) * s * s + (hy % s) * s + hx % s

    KC = nx * ny * nz
    table = np.empty((KC, STENCIL3_SLOTS), np.int64)
    steps = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    for j, (dx, dy, dz) in enumerate(steps):
        hx, hy, hz = gx + dx, gy + dy, gz + dz
        inside = (hx >= 0) & (hx < nx) & (hy >= 0) & (hy < ny) & (hz >= 0) & (hz < nz)
        table[flat(gx, gy, gz).ravel(), j] = np.where(
            inside, flat(np.clip(hx, 0, nx - 1), np.clip(hy, 0, ny - 1),
                         np.clip(hz, 0, nz - 1)), KC).ravel()
    return table


def stencil3_apply_plain(S, theta, x, grid):
    """Gather-and-``einsum`` form of :func:`stencil3_apply` (same
    arguments): each cell's seven neighbour rows of x gathered, every
    component's product taken, then mixed by theta."""
    return _stencil_apply_plain(S, theta, x, stencil3_neighbours(*grid, S.shape[2]))


@functools.lru_cache(maxsize=16)
def stencil2_neighbours(ky, kx, s):
    """[K C, 4] int64: the flat (k, c) index of each triangle's own block,
    of its in-cell partner, and of its neighbour across the vertical and
    across the horizontal edge on the global grid of ky x kx subdomains of
    s^2 cells of two triangles (k = iy kx + ix, c = 2 (cy s + cx) + t; t = 0
    the lower triangle A, whose edge neighbours are the B of the cells to
    its right and below, t = 1 the upper B, whose are the A to its left and
    above), K C where there is none."""
    nx, ny = kx * s, ky * s
    gy, gx, t = np.meshgrid(np.arange(ny), np.arange(nx), np.arange(2), indexing="ij")

    def flat(hx, hy, ht):
        k = (hy // s) * kx + hx // s
        return (k * s * s + (hy % s) * s + hx % s) * 2 + ht

    KC = 2 * nx * ny
    table = np.empty((KC, STENCIL2_SLOTS), np.int64)
    # A (t = 0): right and below; B (t = 1): left and above
    dx, dy = 1 - 2 * t, 2 * t - 1
    for j, (hx, hy) in enumerate(((gx, gy), (gx, gy), (gx + dx, gy), (gx, gy + dy))):
        inside = (hx >= 0) & (hx < nx) & (hy >= 0) & (hy < ny)
        table[flat(gx, gy, t).ravel(), j] = np.where(
            inside, flat(np.clip(hx, 0, nx - 1), np.clip(hy, 0, ny - 1),
                         t if j == 0 else 1 - t), KC).ravel()
    return table


def stencil2_apply_plain(S, theta, x, grid):
    """Gather-and-``einsum`` form of :func:`stencil2_apply` (same
    arguments): each triangle's four neighbour rows of x gathered, every
    component's product taken, then mixed by theta."""
    return _stencil_apply_plain(S, theta, x, stencil2_neighbours(*grid, S.shape[2]))


def _stencil_apply_plain(S, theta, x, table):
    """``sum_q theta[b,q] sum_j S[q,c,j] @ x[b, table[c,j]]`` for S [Q, K, ...,
    slots, nb, nb] and the neighbour ``table`` [K C, slots] (K C: none)."""
    KC, slots = table.shape
    Q, nb, B = S.shape[0], S.shape[-1], x.shape[0]
    nbr = torch.as_tensor(table, device=x.device)
    xn = torch.cat([x.reshape(B, KC, nb), x.new_zeros(B, 1, nb)], 1)[:, nbr]
    per_q = torch.einsum("qcjil,bcjl->bqci", S.reshape(Q, KC, slots, nb, nb), xn)
    return torch.einsum("bq,bqci->bci", theta, per_q).reshape(x.shape)


def _stencil_work(nb, C, F, Q, B, dtype):
    """(operations, bytes) of one lane-batched stencil apply on C cells and
    F inner faces, counted as the benchmark counts it
    (``benchmark/stencil_roofline.py``): one nb x nb block a cell and two a
    face, 2 operations a multiply-add and lane; the Q component stencils
    read once, x read and y written once a lane, theta read once."""
    blocks = nb ** 2 * (C + 2 * F)
    size = torch.finfo(dtype).bits // 8
    return 2 * B * blocks, (Q * blocks + 2 * B * C * nb + B * Q) * size


def _stencil_bound(ops, nbytes, dtype):
    """(ms, "bytes" | "operations"): bytes over the HBM rate or operations
    over the SIMT rate of the vector type (f32 67, f64 34 TFLOP/s),
    whichever is larger."""
    t_ops = ops / PEAK_OPS_PER_S["f64" if dtype == torch.float64 else "f32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def stencil3_work(Q, kz, ky, kx, s, B, dtype):
    """(operations, bytes) of one :func:`stencil3_apply`
    (:func:`_stencil_work` on the hex cells and their faces)."""
    nx, ny, nz = kx * s, ky * s, kz * s
    F = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    return _stencil_work(STENCIL3_NB, nx * ny * nz, F, Q, B, dtype)


def stencil3_bound(Q, kz, ky, kx, s, B, dtype):
    """(ms, "bytes" | "operations"): the least time of one
    :func:`stencil3_apply` on the card (:func:`_stencil_bound`)."""
    return _stencil_bound(*stencil3_work(Q, kz, ky, kx, s, B, dtype), dtype)


def stencil2_work(Q, ky, kx, s, B, dtype):
    """(operations, bytes) of one :func:`stencil2_apply`
    (:func:`_stencil_work` on the triangles, two a square, and their inner
    edges: the diagonals, the vertical and the horizontal ones)."""
    nx, ny = kx * s, ky * s
    F = nx * ny + (nx - 1) * ny + nx * (ny - 1)
    return _stencil_work(STENCIL2_NB, 2 * nx * ny, F, Q, B, dtype)


def stencil2_bound(Q, ky, kx, s, B, dtype):
    """(ms, "bytes" | "operations"): the least time of one
    :func:`stencil2_apply` on the card (:func:`_stencil_bound`)."""
    return _stencil_bound(*stencil2_work(Q, ky, kx, s, B, dtype), dtype)


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


def build(source=None, library=None) -> str:
    """Compile ``source`` (default ``csrc/block_kernels.cu``) into ``library``
    (default :data:`LIBRARY`); returns the compiler's output (``-Xptxas
    -v``: registers, shared memory, spills)."""
    source, library = source or SOURCE, library or LIBRARY
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr


def open_library(library):
    """Load a built kernel library and declare its C entry points."""
    lib = ctypes.CDLL(library)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pylrbms_block_matvec.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp,
                                         ci, ci, ci, ci, vp]
    lib.pylrbms_block_matvec.restype = ci
    lib.pylrbms_precond_dot.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp,
                                        ci, ci, ci, vp]
    lib.pylrbms_precond_dot.restype = ci
    lib.pylrbms_stencil3_apply.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.pylrbms_stencil3_apply.restype = ci
    lib.pylrbms_stencil2_apply.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.pylrbms_stencil2_apply.restype = ci
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    if (not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
        build()
    return open_library(LIBRARY)


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


def _launch(name, fn, dev, stream, *args):
    """``fn(*args, stream)`` with ``dev`` the current device (the launch
    goes to the current device); raises if the launch failed."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# precond_dot's rz scratch (every route but the tiles), per (device, stream):
# integer tickets, one per subdomain (and lane tile), zero between launches
# (the last block of each resets its own), and the rz partials [B, K, row
# blocks] per vector dtype
_PD_WORKSPACE: dict = {}


def _pd_scratch(p, K, N, B):
    """(tickets, partials) element counts of one precond_dot launch: a
    ticket per (k, lane tile), a partial per (lane, k, row tile)."""
    if p.route in (STREAM, RING):                 # a ticket per k, blocks of one k
        return K, B * K * (p.blocks // K)
    if p.route == DMMA:
        return (K * math.ceil(B / p.lanes),
                B * K * math.ceil(N / (ROWS_PER_BLOCK * p.chunks)))
    return K * math.ceil(B / p.lanes), B * K * math.ceil(N / TENSOR_ROWS)


def _pd_workspace(r, stream, n_tickets, n_partials):
    ws = _PD_WORKSPACE.setdefault((r.device, stream), {})
    tickets = ws.get("tickets")
    if tickets is None or tickets.numel() < n_tickets:
        tickets = ws["tickets"] = torch.zeros(n_tickets, dtype=torch.int32, device=r.device)
    partials = ws.get(r.dtype)
    if partials is None or partials.numel() < n_partials:
        partials = ws[r.dtype] = torch.empty(n_partials, dtype=r.dtype, device=r.device)
    return tickets, partials


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
    p = plan("block_matvec", G, K, N, B, A.dtype, x.dtype, _aligned(*tensors))
    y = torch.empty_like(x)
    _launch("block_matvec", _lib().pylrbms_block_matvec, x.device,
            torch.cuda.current_stream(x.device).cuda_stream,
            p.route, p.lanes, p.chunks, _DTYPE_CODE[A.dtype], _DTYPE_CODE[x.dtype],
            A.data_ptr(), x.data_ptr(), None if coef is None else coef.data_ptr(),
            y.data_ptr(), G, K, N, B)
    _count(block_matvec, (G, K, N, B, A.dtype, x.dtype))
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
    p = plan("precond_dot", 1, K, N, B, F.dtype, r.dtype, _aligned(F, r))
    z = torch.empty_like(r)
    rz = torch.empty((B, K), dtype=r.dtype, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    tickets = partials = None
    if p.route != TILES:
        tickets, partials = (t.data_ptr()
                             for t in _pd_workspace(r, stream, *_pd_scratch(p, K, N, B)))
    _launch("precond_dot", _lib().pylrbms_precond_dot, r.device, stream,
            p.route, p.lanes, p.chunks, _DTYPE_CODE[F.dtype], _DTYPE_CODE[r.dtype],
            F.data_ptr(), r.data_ptr(), z.data_ptr(), rz.data_ptr(), partials, tickets,
            K, N, B)
    _count(precond_dot, (1, K, N, B, F.dtype, r.dtype))
    return z, rz


def stencil3_apply(S, theta, x, grid):
    """The lane-batched 3D hex Q1 stencil apply
    ``y[b,k,c,:] = sum_q theta[b,q] sum_j S[q,k,c,j] @ x[b, nbr_j(k,c), :]``.

    S [Q, K, s, s, s, 7, 8, 8] (the folded component stencils:
    ``ops/matrixfree3d.fold_stencils3``), theta [B, Q], x [B, K, 8 s^3],
    all f32 or all f64; ``grid`` (kz, ky, kx) the subdomains (K = kz ky kx),
    neighbours as in :func:`stencil3_neighbours`.  Returns y like x,
    accumulated in x's dtype."""
    if S.ndim != 8 or tuple(S.shape[5:]) != (STENCIL3_SLOTS, STENCIL3_NB, STENCIL3_NB) \
            or not S.shape[2] == S.shape[3] == S.shape[4] or len(grid) != 3 \
            or S.shape[1] != math.prod(grid) or x.ndim != 3 or theta.ndim != 2 \
            or tuple(x.shape[1:]) != (S.shape[1], STENCIL3_NB * S.shape[2] ** 3) \
            or tuple(theta.shape) != (x.shape[0], S.shape[0]):
        raise ValueError(f"stencil3_apply: bad shapes S {tuple(S.shape)}, theta "
                         f"{tuple(theta.shape)}, x {tuple(x.shape)}, grid {tuple(grid)}")
    if all(t.device.type == "cpu" for t in (S, theta, x)):
        return stencil3_apply_plain(S, theta, x, grid)
    _check_stencil("stencil3_apply", S, theta, x)
    Q, s, B = S.shape[0], S.shape[2], x.shape[0]
    kz, ky, kx = (int(g) for g in grid)
    y = torch.empty_like(x)
    _launch("stencil3_apply", _lib().pylrbms_stencil3_apply, x.device,
            torch.cuda.current_stream(x.device).cuda_stream,
            _DTYPE_CODE[x.dtype], S.data_ptr(), theta.data_ptr(), x.data_ptr(), y.data_ptr(),
            Q, kz, ky, kx, s, B)
    _count(stencil3_apply, (Q, kz, ky, kx, s, B, x.dtype))
    return y


def stencil2_apply(S, theta, x, grid):
    """The lane-batched 2D tri P1 stencil apply
    ``y[b,k,c,:] = sum_q theta[b,q] sum_j S[q,k,c,j] @ x[b, nbr_j(k,c), :]``.

    S [Q, K, s, s, 2, 4, 3, 3] (the folded component stencils:
    ``ops/matrixfree.fold_stencils2``), theta [B, Q], x [B, K, 6 s^2], all
    f32 or all f64; ``grid`` (ky, kx) the subdomains (K = ky kx),
    neighbours as in :func:`stencil2_neighbours`.  Returns y like x,
    accumulated in x's dtype."""
    if S.ndim != 8 or tuple(S.shape[4:]) != (2, STENCIL2_SLOTS, STENCIL2_NB, STENCIL2_NB) \
            or S.shape[2] != S.shape[3] or len(grid) != 2 \
            or S.shape[1] != math.prod(grid) or x.ndim != 3 or theta.ndim != 2 \
            or tuple(x.shape[1:]) != (S.shape[1], 2 * STENCIL2_NB * S.shape[2] ** 2) \
            or tuple(theta.shape) != (x.shape[0], S.shape[0]):
        raise ValueError(f"stencil2_apply: bad shapes S {tuple(S.shape)}, theta "
                         f"{tuple(theta.shape)}, x {tuple(x.shape)}, grid {tuple(grid)}")
    if all(t.device.type == "cpu" for t in (S, theta, x)):
        return stencil2_apply_plain(S, theta, x, grid)
    _check_stencil("stencil2_apply", S, theta, x)
    Q, s, B = S.shape[0], S.shape[2], x.shape[0]
    ky, kx = (int(g) for g in grid)
    y = torch.empty_like(x)
    _launch("stencil2_apply", _lib().pylrbms_stencil2_apply, x.device,
            torch.cuda.current_stream(x.device).cuda_stream,
            _DTYPE_CODE[x.dtype], S.data_ptr(), theta.data_ptr(), x.data_ptr(), y.data_ptr(),
            Q, ky, kx, s, B)
    _count(stencil2_apply, (Q, ky, kx, s, B, x.dtype))
    return y


def _check_stencil(name, S, theta, x):
    """A stencil kernel's operands: on one CUDA device, contiguous, all f32
    or all f64, S and x 16-byte aligned."""
    _check_cuda(name, S, theta, x)
    if x.dtype not in STENCIL_DTYPES or S.dtype != x.dtype:
        raise TypeError(f"{name}: unsupported dtypes S {S.dtype}, theta "
                        f"{theta.dtype}, x {x.dtype} (all f32 or all f64)")
    if not _aligned(S, x):
        raise ValueError(f"{name}: S and x must be 16-byte aligned")


# every wrapper of the library, by kernel name
KERNELS = {"block_matvec": block_matvec, "precond_dot": precond_dot,
           "stencil3_apply": stencil3_apply, "stencil2_apply": stencil2_apply}


def _count(fn, signature) -> None:
    fn.launches += 1
    fn.signatures[signature] = fn.signatures.get(signature, 0) + 1


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0 and clear its signatures."""
    for fn in KERNELS.values():
        fn.launches = 0
        fn.signatures = {}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_signatures() -> dict:
    """Per kernel, the distinct signatures it was launched with since the
    last :func:`reset_launch_counts`: ``(G, K, N, B, matrix dtype, vector
    dtype)`` for block_matvec and precond_dot, ``(Q, kz, ky, kx, s, B,
    dtype)`` for stencil3_apply and ``(Q, ky, kx, s, B, dtype)`` for
    stencil2_apply."""
    return {name: set(counts) for name, counts in launch_signature_counts().items()}


def launch_signature_counts() -> dict:
    """Per kernel, ``{signature: launches}`` since the last
    :func:`reset_launch_counts` (signatures as in :func:`launch_signatures`)."""
    return {name: dict(fn.signatures) for name, fn in KERNELS.items()}


reset_launch_counts()
