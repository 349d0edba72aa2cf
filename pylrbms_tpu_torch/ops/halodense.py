"""Halo-dense (bordered-block) operator form: static halo shifts and one
batched matrix product per apply.

The port of ``pylrbms_tpu/ops/halodense.py`` (2D and 3D hex):

    y[k] = B[k] @ xh[k]

where ``B[k] = [A_kk | C_(k, nbr_1) | ...]`` is the subdomain's block row
with its interface-coupling columns, and the halo vector
``xh[k] = [x[k], strip(nbr_1), ...]`` is built by static shifts over the
regular (kz, ky, kx) subdomain lattice (one gather and one padded shift
per coupling family).  ``Nh`` is padded to a multiple of 128.  The product is a
plain ``torch.matmul`` of rectangular ``[K, N, Nh]`` blocks: the reference
computes it as an einsum outside any hand kernel, and the square-block
kernel of ``ops/hopper_kernels.py`` does not take rectangular blocks.

It streams K N Nh coefficients per apply (~1.3x the dense diagonal blocks
in 2D, Nh = N + 4 s nb) in exchange for the stencil's many small
launches; ``InstationaryBlockModel._solve_mf(..., inner='halo')`` uses it
as the f32 inner operator of the mixed-precision trajectory.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..la.block import AssembledBlockOp, block_jacobi_factors


@dataclass(eq=False)
class HaloPlan:
    """Static halo layout of a block lattice (cached per static)."""
    K: int
    N: int
    Nh: int
    kx: int
    ky: int
    # per coupling family: (name, k_out [E], rows_out [F, nb], col0,
    # rows_in_flat [strip], axis 0/1/2 = x/y/z, d +1 from next / -1 from
    # previous)
    fams: tuple
    strip: int
    kz: int = 1


def make_halo_plan(static) -> HaloPlan:
    K, N = static.K, static.N
    sr = {k: np.asarray(v) for k, v in static.side_rows.items()}
    strip = sr["left"].size
    # static.families(): (name, rows_out side, rows_in side, k_out, k_in);
    # the io families receive from the next neighbour, the oi ones from the
    # previous, along x (R), y (U) or z (W)
    fams_def = [(name, sr[ro], sr[ri], k_out, "RUW".index(name[2]),
                 +1 if name.endswith("io") else -1)
                for name, ro, ri, k_out, _k_in in static.families()]
    Nh = -(-(N + len(fams_def) * strip) // 128) * 128
    fams = tuple((name, np.asarray(k_out, np.int64), rows_out, N + slot * strip,
                  rows_in.reshape(-1).astype(np.int64), axis, d)
                 for slot, (name, rows_out, rows_in, k_out, axis, d) in enumerate(fams_def))
    return HaloPlan(K=K, N=N, Nh=Nh, kx=static.kx, ky=static.ky, fams=fams,
                    strip=strip, kz=static.kz)


_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def halo_plan_for(static) -> HaloPlan:
    plan = _PLAN_CACHE.get(static)
    if plan is None:
        plan = _PLAN_CACHE[static] = make_halo_plan(static)
    return plan


@dataclass(eq=False)
class HaloDenseOp:
    """y = A x as static halo shifts and one batched product.  Provides what
    ``solve_pcg`` (``la/block.py``) and ``solve_ir`` (``ops/ir.py``) use:
    ``.apply``, ``.block_jacobi_factors``, ``.static`` and ``.A_diag``
    (the dtype probe)."""
    plan: HaloPlan
    static: object
    B: torch.Tensor             # [K, N, Nh]

    @property
    def A_diag(self):
        return self.B

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K, N] -> the halo vectors [..., K, Nh]."""
        p = self.plan
        lead = x.shape[:-2]
        xh = torch.zeros(lead + (p.K, p.Nh), dtype=x.dtype, device=x.device)
        xh[..., :p.N] = x
        lat = (p.kz, p.ky, p.kx)
        xg = xh.view(lead + lat + (p.Nh,))
        for name, _k_out, _rows_out, col0, rows_in, axis, d in p.fams:
            side = x[..., torch.as_tensor(rows_in, device=x.device)]      # [..., K, strip]
            g = side.reshape(lead + lat + (p.strip,))
            dst = xg[..., col0:col0 + p.strip]
            a = -2 - axis           # the lattice axis (x -2, y -3, z -4)
            n = lat[2 - axis] - 1
            if d > 0:               # receive from the next neighbour
                dst.narrow(a, 0, n).copy_(g.narrow(a, 1, n))
            else:                   # receive from the previous neighbour
                dst.narrow(a, 1, n).copy_(g.narrow(a, 0, n))
        return xh

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K, N] -> A x."""
        xh = self.halo(x).to(self.B.dtype)
        y = torch.matmul(self.B, xh.unsqueeze(-1)).squeeze(-1)
        return y.to(x.dtype)

    def block_jacobi_factors(self) -> torch.Tensor:
        return block_jacobi_factors(self.B[:, :, :self.plan.N])

    def solve_pcg(self, *a, **kw):
        return AssembledBlockOp.solve_pcg(self, *a, **kw)


def halo_from_assembled(op: AssembledBlockOp, dtype=None) -> HaloDenseOp:
    """The halo-dense form of an :class:`AssembledBlockOp` (its interface
    strips scattered once into the bordered block rows)."""
    plan = halo_plan_for(op.static)
    K, N, Nh, nb = plan.K, plan.N, plan.Nh, op.static.nb
    dt_ = dtype or op.A_diag.dtype
    dev = op.A_diag.device
    B = torch.zeros((K, N, Nh), dtype=dt_, device=dev)
    B[:, :, :N] = op.A_diag.to(dt_)
    for name, k_out, rows_out, col0, _rows_in, _axis, _d in plan.fams:
        C = getattr(op, name)
        if k_out.size == 0:
            continue
        E, F = k_out.shape[0], rows_out.shape[0]
        # target (k_out[e], rows_out[f, i], col0 + f*nb + j)
        rows = np.broadcast_to(rows_out[None, :, :, None], (E, F, nb, nb))
        cols = np.broadcast_to(col0 + np.arange(F)[None, :, None, None] * nb
                               + np.arange(nb)[None, None, None, :], (E, F, nb, nb))
        ks = np.broadcast_to(k_out[:, None, None, None], (E, F, nb, nb))
        flat = torch.as_tensor(((ks * N + rows) * Nh + cols).reshape(-1), device=dev)
        B.view(-1).index_add_(0, flat, C.to(dt_).reshape(-1))
    return HaloDenseOp(plan=plan, static=op.static, B=B)
