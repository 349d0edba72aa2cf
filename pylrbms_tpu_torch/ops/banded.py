"""Banded (static-diagonal) global SWIPDG operator.

The port of ``pylrbms_tpu/ops/banded.py``.  On the structured mesh every
SWIPDG coupling sits on a fixed diagonal of the flattened global dof index
``m = k N + n``: the in-cell, V/H-face and subdomain-interface couplings
each contribute a handful of constant offsets ``off = col - row``, so

    y[m] = sum_b band_b[m] x[m + off_b]

is a static sum of elementwise products of shifted slices.  The bands are
extracted once per affine component from the block tensors (the diagonal
blocks by ``torch.diagonal``, the interface strips by a static scatter),
the same source of truth as the block and stencil views.

The offsets of the interface strips are computed per face from the
subdomain side rows, so the layout also covers 'crisscross', whose
boundary-layer element alternates along the left/right sides (the
reference asserts a per-side-constant element and stops there).

Like the reference, the operator is wired into no solve path; it is a
validated alternative layout, timed beside the stencil apply.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _strip_plan(static):
    """Per coupling family (name, global rows [E, s, nb, nb], global cols
    [E, s, nb, nb]) of its block entries [e, f, i, j]."""
    N, sr = static.N, static.side_rows
    plan = []
    for name, ro, ri, k_out, k_in in static.families():
        if len(k_out) == 0:
            continue
        rows = k_out[:, None, None, None] * N + sr[ro][None, :, :, None]
        cols = k_in[:, None, None, None] * N + sr[ri][None, :, None, :]
        shape = np.broadcast_shapes(rows.shape, cols.shape)
        plan.append((name, np.broadcast_to(rows, shape), np.broadcast_to(cols, shape)))
    return plan


def banded_layout(static, diag_mask: np.ndarray):
    """Static banded layout: (offsets, the in-block offsets, the strip
    plan).  ``diag_mask`` [N, N] is the sparsity union of the diagonal
    blocks."""
    N = static.N
    offs_in = (sorted(int(d) for d in range(-(N - 1), N)
                      if np.diagonal(diag_mask, d).any()) if N > 1 else [0])
    plan = _strip_plan(static)
    offs = set(offs_in)
    for _name, rows, cols in plan:
        offs.update(int(o) for o in np.unique(cols - rows))
    return tuple(sorted(offs)), offs_in, plan


@dataclass(eq=False)
class BandedOperator:
    """Affine family of banded operators: ``assemble(theta)`` -> bands
    [B, M] (M = K N), ``apply(bands, x)``."""
    offsets: Tuple[int, ...]
    bands_q: torch.Tensor           # [Q, B, M]
    K: int
    N: int

    def assemble(self, theta) -> torch.Tensor:
        return torch.einsum("q,qbm->bm", torch.as_tensor(theta).to(self.bands_q),
                            self.bands_q)

    def apply(self, bands: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x [..., K, N] -> A x [..., K, N] via the banded form."""
        lead = x.shape[:-2]
        M = self.K * self.N
        lo = -min(0, min(self.offsets))
        hi = max(0, max(self.offsets))
        xp = torch.nn.functional.pad(x.reshape(lead + (M,)), (lo, hi))
        y = torch.zeros(lead + (M,), dtype=x.dtype, device=x.device)
        for b, off in enumerate(self.offsets):
            y += bands[b] * xp[..., lo + off:lo + off + M]
        return y.reshape(lead + (self.K, self.N))


def extract_bands(static, offsets, offs_in, plan, A_diag, couplings, dtype=None):
    """Banded values [B, M] of one affine component: its diagonal blocks
    A_diag [K, N, N] and ``couplings`` {family name: [E, s, nb, nb]}."""
    K, N = static.K, static.N
    M = K * N
    dtype = dtype or A_diag.dtype
    dev = A_diag.device
    pos = {off: i for i, off in enumerate(offsets)}
    bands = torch.zeros((len(offsets), M), dtype=dtype, device=dev)
    # diagonal blocks: band[d][k N + n] = A_diag[k, n, n + d]
    for d in offs_in:
        diag = torch.diagonal(A_diag, offset=d, dim1=1, dim2=2)      # [K, N - |d|]
        row0 = max(0, -d)
        bands[pos[d]].view(K, N)[:, row0:row0 + diag.shape[1]] = diag.to(dtype)
    # interface strips
    for name, rows, cols in plan:
        b_idx = np.vectorize(pos.__getitem__, otypes=[np.int64])(cols - rows)
        bands.index_put_((torch.as_tensor(b_idx.reshape(-1), device=dev),
                          torch.as_tensor(rows.reshape(-1), device=dev)),
                         couplings[name].to(dtype).reshape(-1), accumulate=True)
    return bands


def banded_operator(space, op, dtype=None) -> BandedOperator:
    """The affine :class:`BandedOperator` of the ``AffineBlockOp`` ``op`` on
    ``space``: the offset set is the diagonal sparsity union over the
    components plus the strips' offsets."""
    static = op.static
    assert (static.K, static.N) == (space.K, space.N)
    mask = (op.A_diag.abs() > 0).any(dim=0).any(dim=0).cpu().numpy()
    offsets, offs_in, plan = banded_layout(static, mask)
    bands_q = torch.stack([
        extract_bands(static, offsets, offs_in, plan, op.A_diag[q],
                      {name: getattr(op, name)[q] for name, *_ in static.families()},
                      dtype)
        for q in range(op.A_diag.shape[0])])
    return BandedOperator(offsets=offsets, bands_q=bands_q, K=static.K, N=static.N)
