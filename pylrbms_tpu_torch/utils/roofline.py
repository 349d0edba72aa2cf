"""Roofline accounting for the hot kernels on the H100.

The port of ``pylrbms_tpu/utils/roofline.py``.  Useful operations and
device-memory bytes are counted from operator shapes, and a measured time
becomes achieved rates and shares of the card's peaks.  The counting rules
are the reference's:

- An apply of any stored-coefficient operator costs ``2 * n_coefficients``
  operations (one multiply and one add per stored coefficient) and streams
  its coefficient bytes once.  This is exact for the dense block,
  interface-strip and stencil layouts (every stored coefficient takes part
  in one multiply-add per apply).
- Vector traffic inside a PCG iteration is ``VEC_ROUNDTRIPS`` passes over
  the iterate (the x, r, z, p updates and the dots), each ``K*N`` elements
  read and written.

An operator's coefficients are the tensors among its fields (dataclass
fields, tuples, lists and dicts walked; private fields, which hold caches,
and numpy tables such as a block operator's static layout are not
coefficients, as in the reference, where they are static pytree data).  The peaks are the H100's,
:data:`~pylrbms_tpu_torch.ops.hopper_kernels.HBM_BYTES_PER_S` and
:data:`~pylrbms_tpu_torch.ops.hopper_kernels.PEAK_OPS_PER_S` (NVIDIA's data
sheet, SXM part at 700 W): one source of the card's peaks for the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops.hopper_kernels import HBM_BYTES_PER_S, PEAK_OPS_PER_S

VEC_ROUNDTRIPS = 10     # axpy/dot passes over the iterate per PCG iteration


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if not f.name.startswith("_"):          # private caches
                yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _leaf_stats(tree):
    """(n_elements, n_bytes) over all tensors of ``tree``."""
    elems = bytes_ = 0
    for t in _leaves(tree):
        elems += t.numel()
        bytes_ += t.numel() * t.element_size()
    return elems, bytes_


@dataclass
class KernelCost:
    """Operations and device-memory bytes of ONE application of a kernel."""
    flops: float
    bytes: float

    def __add__(self, other):
        return KernelCost(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k):
        return KernelCost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


def matvec_cost(op) -> KernelCost:
    """One apply of a stored-coefficient operator (``AssembledBlockOp``,
    ``AffineBlockApply``, an assembled stencil, a factor stack, anything
    whose tensors are exactly its coefficients)."""
    elems, bytes_ = _leaf_stats(op)
    return KernelCost(flops=2.0 * elems, bytes=float(bytes_))


def vector_cost(K: int, N: int, itemsize: int,
                roundtrips: int = VEC_ROUNDTRIPS) -> KernelCost:
    """Per-PCG-iteration vector traffic of one lane."""
    n = K * N
    return KernelCost(flops=2.0 * roundtrips * n, bytes=2.0 * roundtrips * n * itemsize)


def pcg_iteration_cost(op, factors=None, coarse_basis=None, coarse_inv=None,
                       lanes: int = 1, itemsize: int = None) -> KernelCost:
    """Cost of ONE lock-step PCG iteration for ``lanes`` parameter lanes
    sharing the operator and preconditioner stream: the coefficients stream
    once, the operations and the vector traffic scale with ``lanes``.
    The coarse level costs a restriction (C^T r), a prolongation (C x_c)
    and the coarse inverse's apply; the vector traffic is counted when the
    factors give K and N ([..., K, N, N])."""
    mv = matvec_cost(op)
    pc = matvec_cost(factors) if factors is not None else KernelCost(0, 0)
    co = KernelCost(0, 0)
    if coarse_basis is not None:
        cb, cbb = _leaf_stats(coarse_basis)
        ci, cib = _leaf_stats(coarse_inv) if coarse_inv is not None else (0, 0)
        co = KernelCost(flops=2.0 * (2 * cb + ci), bytes=float(cbb + cib))
    if itemsize is None:
        first = next(_leaves(op), None)
        itemsize = first.element_size() if first is not None else 4
    vec = KernelCost(0, 0)
    if factors is not None:
        first = next(_leaves(factors), None)
        if first is not None and first.ndim >= 3:
            vec = vector_cost(first.shape[-3], first.shape[-1], itemsize)
    matrix_stream = KernelCost((mv.flops + pc.flops + co.flops) * lanes,
                               mv.bytes + pc.bytes + co.bytes)
    return matrix_stream + lanes * vec


def roofline(cost: KernelCost, seconds: float) -> dict:
    """Achieved rates and their shares of the H100's peaks: ``tflops``,
    ``hbm_gbs``, ``mfu_vs_bf16_peak`` (the tensor cores' dense bf16 rate),
    ``mfu_vs_f32_highest`` (f32 outside the tensor cores, the rate of f32
    products at the port's pinned "highest" precision) and ``hbm_util``."""
    rate = cost.flops / seconds
    return {
        "tflops": rate / 1e12,
        "hbm_gbs": cost.bytes / seconds / 1e9,
        "mfu_vs_bf16_peak": rate / PEAK_OPS_PER_S["bf16"],
        "mfu_vs_f32_highest": rate / PEAK_OPS_PER_S["f32"],
        "hbm_util": cost.bytes / seconds / HBM_BYTES_PER_S,
    }
