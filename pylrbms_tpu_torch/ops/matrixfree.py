"""Matrix-free (stencil) SWIPDG operator: elementwise blocks, fused apply.

The port of ``pylrbms_tpu/ops/matrixfree.py`` (tri, quad and crisscross
families).
The operator's action is held as per-cell volume blocks and per-face block
quadruples, O(K s^2 nb^2) numbers instead of the O(K N^2) dense subdomain
blocks; its apply is a handful of batched block products and shifted
in-place adds on views (the structured mesh needs no gathers).  Each block
product is a multiply and a sum over the last axis (:func:`bmv`): as an
einsum over lane-batched fields it becomes a batched gemv of ~1M tiny
blocks, 8x slower on the H100 (PERF.md).

Layout (x as [..., K, s, s, T, nb]):
  vol   [K, s, s, T, nb, nb]         y[c,t]   += V x[c,t]
  D     4 x [K, s, s, nb, nb]        A<->B within each cell (tri only)
  V     4 x [K, s, s-1, nb, nb]      cell (cy,cx,A) <-> (cy,cx+1,B)
  H     4 x [K, s-1, s, nb, nb]      cell (cy,cx,B) <-> (cy+1,cx,A)
  R, U  4 x [E, s, nb, nb]           subdomain interface quadruples
  D_side {side: [K, s, nb, nb]}      one-sided Dirichlet blocks

On 'crisscross' the layout is the same, each face position filled from its
parity family (D0/D1, V0/V1, H0/H1, per-parity boundary tabs); which
t-plane a V face or a left/right boundary block couples is resolved in the
apply by the static cell-parity checkerboard (H faces couple t1 below to t0
above for both parities, as on 'tri').

Every field of an :class:`AssembledStencil` may carry leading lane axes
(``StencilOperator.mix`` with theta [B, Q]); ``apply`` broadcasts them
against the lanes of x, so B parameter queries share one lane-batched PCG.
Lane-batched operators on tri P1 (T = 2, nb = 3, not crisscross) are a
:class:`LaneStencil` instead: theta and the component stencils, folded
once per dtype and device into one own block and three neighbour blocks a
triangle (:func:`fold_stencils2`), nothing per lane; on the card its apply
is one launch of the hand-written
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil2_apply`, on the CPU it
is the per-lane :class:`AssembledStencil`'s apply.  Quad, crisscross, P2
and single-theta operators stay an :class:`AssembledStencil`, whose apply
is plain torch.  :attr:`StencilOperator.lane_kernel` alone decides which
operators take the lane kernel (:class:`LaneFamily` holds what the 2D and
3D families share of it).

The block-factor preconditioner of :func:`stencil_pcg`, the PCG of every
stencil form (``AssembledStencil.solve_pcg`` and the 3D and lane ones),
goes through the hand-written
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.precond_dot` (f32 or bf16
factors, f32 residual, as the reference applies them).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from . import assembly as asm
from .assembly import IPDGParams, DEFAULT_IPDG
from . import hopper_kernels as hk
from .hopper_kernels import precond_dot
from ..la.krylov import lane_dot, pcg_chunked
from ..utils.timers import GLOBAL_TIMINGS


@dataclass(eq=False)
class SwipdgStencil:
    """One affine component in stencil form."""
    vol: torch.Tensor                      # [K, s, s, T, nb, nb]
    D: Tuple[torch.Tensor, ...]            # 4 x [K, s, s, nb, nb]
    V: Tuple[torch.Tensor, ...]            # 4 x [K, s, s-1, nb, nb]
    H: Tuple[torch.Tensor, ...]            # 4 x [K, s-1, s, nb, nb]
    R: Tuple[torch.Tensor, ...]            # 4 x [E_R, s, nb, nb]
    U: Tuple[torch.Tensor, ...]            # 4 x [E_U, s, nb, nb]
    D_side: Dict[str, torch.Tensor]        # side -> [K, s, nb, nb]


def cast(obj, dtype):
    """A copy of the dataclass ``obj`` (a stencil, stencil operator or block
    operator) with every floating tensor field — also inside tuples, dicts
    and nested stencils — cast to ``dtype``; other fields are shared."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype) if v.is_floating_point() else v
        if isinstance(v, tuple):
            return tuple(conv(u) for u in v)
        if isinstance(v, dict):
            return {k: conv(u) for k, u in v.items()}
        if dataclasses.is_dataclass(v) and hasattr(v, "D_side"):   # a stencil (2D or 3D)
            return cast(v, dtype)
        return v
    return dataclasses.replace(obj, **{f.name: conv(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


def assemble_swipdg_stencil(space, lam_fn, kappa_fn=None,
                            ipdg: IPDGParams = DEFAULT_IPDG,
                            dtype=torch.float64, device=None) -> SwipdgStencil:
    """Stencil form of one affine component (same integrands as
    ``ops/swipdg.assemble_swipdg_component``, kept per cell and face)."""
    s, nb, K = space.s, space.nb, space.K
    origins = space.subdomain_origins
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)

    xq = asm.tensor(asm.vol_points(space), dtype, device)
    lam = lam_fn(xq).to(dtype)
    dphi = asm.tensor(space.vol_dphi, dtype, device)
    w = asm.tensor(space.vol_w, dtype, device)
    area = space.hx * space.hy
    if kappa_fn is None:
        vol = area * torch.einsum(asm.vol_ein(space, "tq,kyxtq,tqia,tqja->kyxtij"),
                                  w, lam, dphi, dphi)
    else:
        kap = kappa_fn(xq).to(dtype)
        vol = area * torch.einsum(asm.vol_ein(space, "tq,kyxtq,tqia,kyxtqab,tqjb->kyxtij"),
                                  w, lam, dphi, kap, dphi)
    if space.percell:
        return _assemble_swipdg_stencil_cc(space, vol, lam_fn, kappa_fn, kw)

    def zeros(shape):
        return tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(4))

    def blocks(fam, cy_m, cx_m, orgs):
        tab = space.face_tabs[fam]
        x_m, x_p = asm.face_phys_points(space, tab, cy_m, cx_m, orgs)
        return asm.inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m, x_p,
                                     space.order, **kw)

    def faces(fam, cy_m, cx_m, shape):
        return tuple(b.reshape((K,) + shape + (nb, nb))
                     for b in blocks(fam, cy_m, cx_m, origins))

    sets = space.interior_face_sets()
    Dq = (faces("D", sets["D"][0], sets["D"][1], (s, s)) if "D" in sets
          else zeros((K, s, s, 0, 0)))
    Vq = (faces("V", sets["V"][0], sets["V"][1], (s, s - 1)) if s > 1
          else zeros((K, s, 0, nb, nb)))
    Hq = (faces("H", sets["H"][0], sets["H"][1], (s - 1, s)) if s > 1
          else zeros((K, 0, s, nb, nb)))

    grid = space.grid
    org = origins.reshape(grid.ky, grid.kx, 2)
    r = np.arange(s)
    Rq = (blocks("V", r, np.full(s, s - 1), org[:, :-1].reshape(-1, 2))
          if grid.kx > 1 else zeros((0, s, nb, nb)))
    Uq = (blocks("H", np.full(s, s - 1), r, org[:-1, :].reshape(-1, 2))
          if grid.ky > 1 else zeros((0, s, nb, nb)))

    D_side = {}
    for side in ("left", "right", "bottom", "top"):
        tab = space.face_tabs["bnd_" + side]
        cy, cx, _t = space.side_cells(side)
        x_m, _ = asm.face_phys_points(space, tab, cy, cx, origins)
        D_side[side] = asm.boundary_face_blocks(space, tab, lam_fn, kappa_fn,
                                                x_m, space.order, **kw)
    return SwipdgStencil(vol=vol, D=Dq, V=Vq, H=Hq, R=Rq, U=Uq, D_side=D_side)


def _assemble_swipdg_stencil_cc(space, vol, lam_fn, kappa_fn, kw) -> SwipdgStencil:
    """Crisscross faces: each face position of the stencil layout filled
    from its parity family (the storage is parity-agnostic)."""
    s, nb, K = space.s, space.nb, space.K
    dtype, device = kw["dtype"], kw["device"]
    origins = space.subdomain_origins
    sets = space.interior_face_sets()

    def blocks(fam, cy_m, cx_m, orgs):
        tab = space.face_tabs[fam]
        x_m, x_p = asm.face_phys_points(space, tab, cy_m, cx_m, orgs)
        return asm.inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m, x_p,
                                     space.order, **kw)

    def zeros(shape):
        return tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(4))

    def interleave(shape, stem):
        outs = zeros((K,) + shape + (nb, nb))
        for p in (0, 1):
            cy, cx = sets[f"{stem}{p}"][:2]
            if len(cy) == 0:
                continue
            iy, ix = torch.as_tensor(cy, device=device), torch.as_tensor(cx, device=device)
            for o, b in zip(outs, blocks(f"{stem}{p}", cy, cx, origins)):
                o[:, iy, ix] = b
        return outs

    def iface(orient, minus_org, E):
        outs = zeros((E, s, nb, nb))
        for fam, cy_m, cx_m, pos in space.interface_face_groups(orient):
            ip = torch.as_tensor(pos, device=device)
            for o, b in zip(outs, blocks(fam, cy_m, cx_m, minus_org)):
                o[:, ip] = b
        return outs

    grid = space.grid
    org = origins.reshape(grid.ky, grid.kx, 2)
    Dq = interleave((s, s), "D")
    Vq = interleave((s, s - 1), "V") if s > 1 else zeros((K, s, 0, nb, nb))
    Hq = interleave((s - 1, s), "H") if s > 1 else zeros((K, 0, s, nb, nb))
    Rq = (iface("V", org[:, :-1].reshape(-1, 2), grid.ky * (grid.kx - 1))
          if grid.kx > 1 else zeros((0, s, nb, nb)))
    Uq = (iface("H", org[:-1, :].reshape(-1, 2), (grid.ky - 1) * grid.kx)
          if grid.ky > 1 else zeros((0, s, nb, nb)))
    D_side = {}
    for side in ("left", "right", "bottom", "top"):
        acc = torch.zeros((K, s, nb, nb), dtype=dtype, device=device)
        for key, cy, cx, _t, pos in space.boundary_face_groups(side):
            tab = space.face_tabs[key]
            x_m, _ = asm.face_phys_points(space, tab, cy, cx, origins)
            acc[:, torch.as_tensor(pos, device=device)] = asm.boundary_face_blocks(
                space, tab, lam_fn, kappa_fn, x_m, space.order, **kw)
        D_side[side] = acc
    return SwipdgStencil(vol=vol, D=Dq, V=Vq, H=Hq, R=Rq, U=Uq, D_side=D_side)


def _parity_masks(space, dtype, device):
    """Static 0/1 masks of the crisscross apply, each [s(, s-1), 1] in
    ``dtype``: V faces on t0 / t1 (parity of the minus cell), the
    left-side element on t0 / t1 and the right-side element on t0 / t1.
    Cached on the space per (dtype, device): every apply reads them, and a
    host-to-device copy per apply would cost more than the masked
    products."""
    cache = space.__dict__.setdefault("_parity_mask_cache", {})
    key = (dtype, torch.device(device))
    if key not in cache:
        par_v = space.cell_parity[:, :-1]                 # [s, s-1]
        pl = np.arange(space.s) % 2                       # left: t = 1 - parity
        pr = (np.arange(space.s) + space.s - 1) % 2       # right: t = parity

        def m(a):
            return torch.as_tensor(a[..., None], dtype=dtype, device=device)
        cache[key] = dict(v0=m(par_v == 0), v1=m(par_v == 1), l0=m(pl == 1),
                          l1=m(pl == 0), r0=m(pr == 0), r1=m(pr == 1))
    return cache[key]


def mass_stencil(space, like: SwipdgStencil) -> SwipdgStencil:
    """The L2 mass in stencil form: volume blocks only, zero face families
    shaped like ``like``, so that it joins an affine
    :class:`StencilOperator` family and the implicit-Euler operator
    G = M + dt A is one more affine component."""
    dtype, dev = like.vol.dtype, like.vol.device
    phi = asm.tensor(space.vol_phi, dtype, dev)
    w = asm.tensor(space.vol_w, dtype, dev)
    area = space.hx * space.hy
    if space.percell:
        elem = area * torch.einsum("yxtq,yxtqi,yxtqj->yxtij", w, phi, phi)
        vol = elem[None].expand(like.vol.shape)
    else:
        elem = area * torch.einsum("tq,tqi,tqj->tij", w, phi, phi)
        vol = elem[None, None, None].expand(like.vol.shape)

    def zeros(t):
        return tuple(torch.zeros_like(b) for b in t)

    return SwipdgStencil(vol=vol.contiguous(), D=zeros(like.D), V=zeros(like.V),
                         H=zeros(like.H), R=zeros(like.R), U=zeros(like.U),
                         D_side={k: torch.zeros_like(v) for k, v in like.D_side.items()})


def fold_stencils2(space, stencils, dtype, device) -> torch.Tensor:
    """The tri P1 components ``stencils`` folded per triangle: [Q, K, s, s,
    2, 4, nb, nb] (triangle t of cell (cy, cx); t = 0 the lower A, 1 the
    upper B), slot 0 the triangle's own block (volume, the own side of its
    diagonal, vertical and horizontal faces, the interface in_in / out_out
    blocks and the Dirichlet strips), slot 1 its coupling to the in-cell
    partner across the diagonal (Dmp / Dpm), slot 2 to its neighbour across
    the vertical edge (Vmp / Vpm, or the interface Rio / Roi: the B to the
    right for A, the A to the left for B), slot 3 across the horizontal
    edge (Hpm / Hmp, or Uoi / Uio: the B below for A, the A above for B);
    zero where there is none.  ``A x`` is then, for each triangle, the sum
    of the four blocks times x on it and its neighbours (the operand of
    :func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil2_apply`); the
    indexing is :meth:`AssembledStencil.apply`'s on 'tri', summed in
    ``dtype``."""
    grid = space.grid
    K, s, nb = space.K, space.s, space.nb
    ky, kx = grid.ky, grid.kx
    P = torch.zeros((len(stencils), ky, kx, s, s, 2, hk.STENCIL2_SLOTS, nb, nb),
                    dtype=dtype, device=device)
    for q, st in enumerate(stencils):
        st = cast(st, dtype)

        def g(t, j):
            """Triangle t's slot j on the grid: [ky, kx, cy, cx, nb, nb]."""
            return P[q, :, :, :, :, t, j]

        def f(t, j):
            """The same per subdomain: [K, cy, cx, nb, nb]."""
            return g(t, j).view(K, s, s, nb, nb)

        Dmm, Dmp, Dpm, Dpp = (b.to(device) for b in st.D)
        f(0, 0).add_(st.vol[..., 0, :, :].to(device)).add_(Dmm)
        f(1, 0).add_(st.vol[..., 1, :, :].to(device)).add_(Dpp)
        f(0, 1).add_(Dmp)
        f(1, 1).add_(Dpm)
        if s > 1:
            # V: minus (cy, cx, A), plus (cy, cx+1, B); H: minus (cy, cx, B),
            # plus (cy+1, cx, A)
            Vmm, Vmp, Vpm, Vpp = (b.to(device) for b in st.V)
            f(0, 0)[:, :, :-1].add_(Vmm)
            f(0, 2)[:, :, :-1].add_(Vmp)
            f(1, 2)[:, :, 1:].add_(Vpm)
            f(1, 0)[:, :, 1:].add_(Vpp)
            Hmm, Hmp, Hpm, Hpp = (b.to(device) for b in st.H)
            f(1, 0)[:, :-1].add_(Hmm)
            f(1, 3)[:, :-1].add_(Hmp)
            f(0, 3)[:, 1:].add_(Hpm)
            f(0, 0)[:, 1:].add_(Hpp)
        if kx > 1:
            # minus (iy, ix, cy, s-1, A), plus (iy, ix+1, cy, 0, B)
            Rii, Rio, Roi, Roo = (b.to(device).reshape(ky, kx - 1, s, nb, nb) for b in st.R)
            g(0, 0)[:, :-1, :, s - 1].add_(Rii)
            g(0, 2)[:, :-1, :, s - 1].add_(Rio)
            g(1, 2)[:, 1:, :, 0].add_(Roi)
            g(1, 0)[:, 1:, :, 0].add_(Roo)
        if ky > 1:
            # minus (iy, ix, s-1, cx, B), plus (iy+1, ix, 0, cx, A)
            Uii, Uio, Uoi, Uoo = (b.to(device).reshape(ky - 1, kx, s, nb, nb) for b in st.U)
            g(1, 0)[:-1, :, s - 1].add_(Uii)
            g(1, 3)[:-1, :, s - 1].add_(Uio)
            g(0, 3)[1:, :, 0].add_(Uoi)
            g(0, 0)[1:, :, 0].add_(Uoo)
        D = {sd: v.to(device).reshape(ky, kx, s, nb, nb) for sd, v in st.D_side.items()}
        g(1, 0)[:, 0, :, 0].add_(D["left"][:, 0])
        g(0, 0)[:, kx - 1, :, s - 1].add_(D["right"][:, kx - 1])
        g(0, 0)[0, :, 0].add_(D["bottom"][0])
        g(1, 0)[ky - 1, :, s - 1].add_(D["top"][ky - 1])
    return P.reshape((len(stencils), K, s, s, 2, hk.STENCIL2_SLOTS, nb, nb))


class LaneFamily:
    """What the 2D and 3D affine stencil families share of their lane
    kernel: the components folded once per dtype and device
    (:meth:`folded`, built by the family's ``fold``), their set-up
    (:meth:`prepare`) and :meth:`assemble`, which gives the family's lane
    form (its ``lane``) for theta [B, Q] where ``lane_kernel`` names a
    kernel, and the per-lane fields of its ``mix`` otherwise."""

    def __post_init__(self):
        self._folded = {}                 # (dtype, device) -> self.fold(...)

    def folded(self, dtype, device) -> torch.Tensor:
        """The family's folded components in ``dtype`` on ``device``, built
        at the first request and kept."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (dtype, device)
        P = self._folded.get(key)
        if P is None:
            P = self._folded[key] = self.fold(dtype, device)
        return P

    def prepare(self, dtypes, device) -> None:
        """The lane kernel's set-up: the components folded in each of
        ``dtypes`` on ``device`` (nothing without a lane kernel)."""
        if self.lane_kernel:
            for dt in dtypes:
                self.folded(dt, device)

    def assemble(self, theta):
        """The operator at theta: theta [B, Q] with a ``lane_kernel`` gives
        the lane form (nothing per lane is built), anything else the
        family's ``mix``."""
        theta = torch.as_tensor(theta).to(self.stencils[0].vol)
        if theta.ndim == 2 and self.lane_kernel:
            return self.lane(theta.contiguous())
        return self.mix(theta)


@dataclass(eq=False)
class StencilOperator(LaneFamily):
    """Affine family of stencils with a fused matrix-free apply."""
    space: object
    stencils: Tuple[SwipdgStencil, ...]

    @property
    def lane_kernel(self):
        """The hand kernel of this family's lane-batched applies:
        ``"stencil2_apply"`` on tri P1 (T = 2 and nb = 3, not crisscross),
        else None (the lanes then carry per-lane fields)."""
        sp = self.space
        tri_p1 = sp.T == 2 and sp.nb == hk.STENCIL2_NB and not sp.percell
        return "stencil2_apply" if tri_p1 else None

    def fold(self, dtype, device) -> torch.Tensor:
        return fold_stencils2(self.space, self.stencils, dtype, device)

    def lane(self, theta) -> "LaneStencil":
        return LaneStencil(self, theta)

    def lane_apply(self, theta, x) -> torch.Tensor:
        """One :func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil2_apply`
        launch: A(theta_b) x_b for every lane b of x [B, K, N] on the card."""
        g = self.space.grid
        return hk.stencil2_apply(self.folded(x.dtype, x.device), theta, x, (g.ky, g.kx))

    def mix(self, theta) -> "AssembledStencil":
        """sum_q theta_q * stencil_q; theta [Q], or [B, Q] for lane-batched
        fields (a leading B axis on every field)."""
        st0 = self.stencils[0]
        theta = torch.as_tensor(theta).to(st0.vol)

        def mix(getter):
            out = None
            for q, st in enumerate(self.stencils):
                p = getter(st)
                t = theta[..., q].reshape(theta.shape[:-1] + (1,) * p.ndim)
                out = t * p if out is None else out + t * p
            return out

        return AssembledStencil(
            space=self.space,
            vol=mix(lambda st: st.vol),
            D=tuple(mix(lambda st, i=i: st.D[i]) for i in range(4)),
            V=tuple(mix(lambda st, i=i: st.V[i]) for i in range(4)),
            H=tuple(mix(lambda st, i=i: st.H[i]) for i in range(4)),
            R=tuple(mix(lambda st, i=i: st.R[i]) for i in range(4)),
            U=tuple(mix(lambda st, i=i: st.U[i]) for i in range(4)),
            D_side={k: mix(lambda st, k=k: st.D_side[k]) for k in st0.D_side})


def count_apply(x) -> None:
    """Count one stencil apply to ``x`` [..., K, N] in ``GLOBAL_TIMINGS``:
    ``stencil.applies`` += 1 and ``stencil.lane_applies`` += the lanes of
    x (1 without a lane axis); nothing while the timings are off."""
    if GLOBAL_TIMINGS.on:
        GLOBAL_TIMINGS.count("stencil.applies")
        GLOBAL_TIMINGS.count("stencil.lane_applies", math.prod(x.shape[:-2]))


def bmv(A, v):
    """Batched block matvec ``A[..., i, j] v[..., j]`` (leading axes
    broadcast)."""
    return (A * v.unsqueeze(-2)).sum(-1)


def make_precond(dtype, *, block_factors=None, factors=None, cell_shape=None,
                 coarse_inv=None, coarse_basis=None, coarse_dtype=None,
                 comm=None, band=None):
    """Preconditioner of the matrix-free solves, ``r [..., K, N] -> (z, rz)``
    for vectors in ``dtype``.

    Fine level: with ``block_factors`` [K, N, N] (or one set per lane,
    [B, K, N, N], for r [B, K, N]) the subdomain block-Jacobi
    as the reference applies it — r rounded to f32, the factors in f32 (or
    bf16 as stored), f32 accumulation in one :func:`precond_dot` launch, z
    widened to ``dtype``; with ``factors`` the per-cell blocks (cell_shape
    ``(K, s, s, cb)``) in ``dtype``; else the identity.  ``coarse_inv``
    adds a coarse level: on the per-subdomain basis ``coarse_basis``
    [K, N, m] ([K*m, K*m] inverse), or subdomain constants without a basis
    ([K, K]), applied in ``coarse_dtype`` (default ``dtype``).  ``rz`` is
    the per-lane r . z from the kernel's fused partials for f32 vectors on
    block factors, else None (the caller takes r . z in r's dtype).

    K-sharded (``comm`` and ``band = (k0, K)``: r holds subdomains
    [k0, k0 + Kb) of K, the factors and ``coarse_basis`` the same band,
    ``coarse_inv`` the whole coarse inverse): the band's coarse residual is
    placed into the K-long coarse vector and summed over the ranks
    (``comm.sum``), the coarse solve takes the band's rows of the inverse,
    and ``rz`` is this rank's partial."""
    f32 = torch.float32
    if block_factors is not None:
        Binv = (block_factors if block_factors.dtype == torch.bfloat16
                else block_factors.to(f32))
        K, N = Binv.shape[-3], Binv.shape[-2]
        # per-lane factors [B, K, N, N] fold the lanes into the subdomain
        # axis: one launch over B*K blocks with one vector lane
        per_lane = Binv.ndim == 4
        Binv = Binv.reshape(-1, N, N).contiguous()
        fused = dtype == f32

        def M_fine(r):
            rr = r.to(f32).reshape((1, -1, N) if per_lane else (-1, K, N)).contiguous()
            z, rz = precond_dot(Binv, rr)
            return (z.reshape(r.shape).to(r.dtype),
                    rz.reshape(r.shape[:-2] + (K,)).sum(-1) if fused else None)
    elif factors is not None:
        Minv = factors.to(dtype)

        def M_fine(r):
            z = bmv(Minv, r.reshape(r.shape[:-2] + tuple(cell_shape)))
            return z.reshape(r.shape), None
    else:
        def M_fine(r):
            return r, None

    if coarse_inv is None:
        return M_fine
    coarse = coarse_level(coarse_inv, coarse_basis, coarse_dtype or dtype, comm, band)

    def M(r):
        z, rz = M_fine(r)
        zc = coarse(r)
        return z + zc, (None if rz is None else rz + lane_dot(r, zc))
    return M


def coarse_level(coarse_inv, coarse_basis, cdt, comm=None, band=None):
    """The additive coarse correction ``r [..., K, N] -> zc`` (in r's
    dtype), applied in ``cdt``: on the per-subdomain basis ``coarse_basis``
    [K, N, m] with the [K*m, K*m] inverse, or on subdomain constants without
    a basis ([K, K]).  ``comm`` and ``band`` as in :func:`make_precond`."""
    Ci = coarse_inv.to(cdt)
    mc = 1 if coarse_basis is None else coarse_basis.shape[-1]
    if band is None:
        def total(rc):
            return rc
    else:
        k0, K_all = band
        Ci = Ci[k0 * mc:]

        def total(rc):
            """[..., Kb, m] band residual -> [..., K, m] summed over ranks."""
            full = rc.new_zeros(rc.shape[:-2] + (K_all, mc))
            full[..., k0:k0 + rc.shape[-2], :] = rc
            return comm.sum(full)
    if coarse_basis is not None:
        Cb = coarse_basis.to(cdt)
        Kc = Cb.shape[0]

        def coarse(r):
            rc = total(torch.einsum("knm,...kn->...km", Cb, r.to(cdt)))
            xc = torch.einsum("ij,...j->...i", Ci[:Kc * mc], rc.reshape(r.shape[:-2] + (-1,)))
            return torch.einsum("knm,...km->...kn", Cb,
                                xc.reshape(r.shape[:-2] + (Kc, mc))).to(r.dtype)
    else:
        def coarse(r):
            rc = total(r.sum(-1, keepdim=True).to(cdt))[..., 0]
            xc = torch.einsum("ij,...j->...i", Ci[:r.shape[-2]], rc)
            return xc.to(r.dtype)[..., None]
    return coarse


def stencil_pcg(A, b, cell_shape, tol, maxiter, factors, block_factors, coarse_inv,
                coarse_basis, return_iters, coarse_f32, x0, *, comm=None, band=None):
    """The matrix-free PCG of every stencil form ``A`` (its ``apply``; its
    ``cell_jacobi_factors`` when no factors are given) for b [K, N] or lanes
    [B, K, N] (per-lane frozen, see ``la/krylov.pcg_chunked``), on cells of
    ``cell_shape`` (K and the cell's axes, the last one its dofs).

    Preconditioner (:func:`make_precond` in b's dtype): the subdomain
    block-Jacobi ``block_factors`` [K, N, N] through one
    :func:`precond_dot` launch, else cell-block Jacobi (``factors``,
    default ``A.cell_jacobi_factors()``); ``coarse_inv`` (with or without
    ``coarse_basis``) adds the coarse level, in f32 when b is f32 or
    ``coarse_f32``.  The CG scalar is r . M(r) in r's dtype (for f32
    vectors the kernel's fused partials).  ``comm`` and ``band`` as in
    :func:`make_precond` (every dot product then all-reduced).  Returns x
    (and the iteration counts)."""
    if block_factors is None and factors is None:
        factors = A.cell_jacobi_factors()
    P = make_precond(b.dtype, block_factors=block_factors, factors=factors,
                     cell_shape=cell_shape, coarse_inv=coarse_inv, coarse_basis=coarse_basis,
                     coarse_dtype=torch.float32 if coarse_f32 else None, comm=comm, band=band)

    def M(r):
        z, rz = P(r)
        return z, (lane_dot(r, z) if rz is None else rz)

    x, it = pcg_chunked(A.apply, M, b, tol, maxiter, x0=x0, comm=comm)
    return (x, it) if return_iters else x


@dataclass(eq=False)
class AssembledStencil:
    space: object
    vol: torch.Tensor
    D: tuple
    V: tuple
    H: tuple
    R: tuple
    U: tuple
    D_side: dict

    def cell_jacobi_factors(self) -> torch.Tensor:
        """Per-cell block inverses [..., K, s, s, cb, cb] (cb = T nb: the
        2nb x 2nb tri cell with its in-cell D face, the nb x nb quad cell),
        with each element's own face contributions; Jacobi-scaled, inverted
        in the operator's dtype."""
        sp = self.space
        s = sp.s
        Ds = self.D_side
        if sp.T == 1:
            cell = self.vol[..., 0, :, :].clone()          # [..., K, s, s, nb, nb]
            if s > 1:
                Vmm, _, _, Vpp = self.V
                Hmm, _, _, Hpp = self.H
                cell[..., :, :-1, :, :] += Vmm
                cell[..., :, 1:, :, :] += Vpp
                cell[..., :-1, :, :, :] += Hmm
                cell[..., 1:, :, :, :] += Hpp
            cell[..., :, 0, :, :] += Ds["left"]
            cell[..., :, s - 1, :, :] += Ds["right"]
            cell[..., 0, :, :, :] += Ds["bottom"]
            cell[..., s - 1, :, :, :] += Ds["top"]
        else:
            Dmm, Dmp, Dpm, Dpp = self.D
            # each triangle's OWN (mm/pp) contributions from all its faces
            # (otherwise constants see no penalty energy: singular blocks)
            dA = self.vol[..., 0, :, :] + Dmm
            dB = self.vol[..., 1, :, :] + Dpp
            mk = (_parity_masks(sp, dA.dtype, dA.device) if sp.percell else None)
            if s > 1:
                Vmm, _, _, Vpp = self.V
                Hmm, _, _, Hpp = self.H
                if sp.percell:
                    # both sides of a V face live on t = parity of the minus cell
                    v0, v1 = mk["v0"][..., None], mk["v1"][..., None]
                    dA[..., :, :-1, :, :] += v0 * Vmm
                    dB[..., :, :-1, :, :] += v1 * Vmm
                    dA[..., :, 1:, :, :] += v0 * Vpp
                    dB[..., :, 1:, :, :] += v1 * Vpp
                else:
                    dA[..., :, :-1, :, :] += Vmm     # A minus side of V at (cy, cx)
                    dB[..., :, 1:, :, :] += Vpp      # B plus side of V at (cy, cx-1)
                dB[..., :-1, :, :, :] += Hmm     # t1 minus side of H at (cy, cx)
                dA[..., 1:, :, :, :] += Hpp      # t0 plus side of H below
            # subdomain-side penalty (one-sided Dirichlet blocks; on
            # interfaces the in_in strips differ slightly: fine for M)
            if sp.percell:
                # the left/right boundary-layer element alternates
                dB[..., :, 0, :, :] += mk["l1"][..., None] * Ds["left"]
                dA[..., :, 0, :, :] += mk["l0"][..., None] * Ds["left"]
                dA[..., :, s - 1, :, :] += mk["r0"][..., None] * Ds["right"]
                dB[..., :, s - 1, :, :] += mk["r1"][..., None] * Ds["right"]
            else:
                dB[..., :, 0, :, :] += Ds["left"]
                dA[..., :, s - 1, :, :] += Ds["right"]
            dA[..., 0, :, :, :] += Ds["bottom"]
            dB[..., s - 1, :, :, :] += Ds["top"]
            cell = torch.cat([torch.cat([dA, Dmp], dim=-1),
                              torch.cat([Dpm, dB], dim=-1)], dim=-2)
        dvec = torch.abs(torch.diagonal(cell, dim1=-2, dim2=-1))
        sca = 1.0 / torch.sqrt(torch.clamp(dvec, min=1e-300))
        S = sca[..., :, None] * sca[..., None, :]
        return torch.linalg.inv(cell * S) * S

    def solve_pcg(self, b, tol: float = 1e-10, maxiter: int = 3000,
                  factors=None, block_factors=None, coarse_inv=None,
                  coarse_basis=None, return_iters: bool = False,
                  coarse_f32: bool = False, x0=None):
        """:func:`stencil_pcg` on this operator's cells."""
        sp = self.space
        return stencil_pcg(self, b, (sp.K, sp.s, sp.s, sp.T * sp.nb), tol, maxiter, factors,
                           block_factors, coarse_inv, coarse_basis, return_iters, coarse_f32, x0)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K, N] -> A x, matrix-free (lane axes of x and of the
        fields broadcast; counted by :func:`count_apply`)."""
        count_apply(x)
        sp = self.space
        grid = sp.grid
        K, s, T, nb = sp.K, sp.s, sp.T, sp.nb
        xc = x.reshape(x.shape[:-2] + (K, s, s, T, nb))
        if T == 1:
            # quad grid: one element per cell, V/H faces couple like elements
            xQ = xc[..., 0, :]                       # [..., K, s, s, nb]
            y = bmv(self.vol[..., 0, :, :], xQ)
            if s > 1:
                Vmm, Vmp, Vpm, Vpp = self.V
                xm, xp = xQ[..., :, :-1, :], xQ[..., :, 1:, :]
                y[..., :, :-1, :] += bmv(Vmm, xm) + bmv(Vmp, xp)
                y[..., :, 1:, :] += bmv(Vpm, xm) + bmv(Vpp, xp)
                Hmm, Hmp, Hpm, Hpp = self.H
                xm, xp = xQ[..., :-1, :, :], xQ[..., 1:, :, :]
                y[..., :-1, :, :] += bmv(Hmm, xm) + bmv(Hmp, xp)
                y[..., 1:, :, :] += bmv(Hpm, xm) + bmv(Hpp, xp)
            y = y[..., None, :]                      # [..., K, s, s, 1, nb]
        else:
            xA, xB = xc[..., 0, :], xc[..., 1, :]    # [..., K, s, s, nb]
            Dmm, Dmp, Dpm, Dpp = self.D
            yA = bmv(self.vol[..., 0, :, :], xA) + bmv(Dmm, xA) + bmv(Dmp, xB)
            yB = bmv(self.vol[..., 1, :, :], xB) + bmv(Dpm, xA) + bmv(Dpp, xB)
            if s > 1:
                Vmm, Vmp, Vpm, Vpp = self.V
                if sp.percell:
                    # crisscross: both sides on t = parity of the minus cell
                    mk = _parity_masks(sp, x.dtype, x.device)
                    v0, v1 = mk["v0"], mk["v1"]
                    xm = v0 * xA[..., :, :-1, :] + v1 * xB[..., :, :-1, :]
                    xp = v0 * xA[..., :, 1:, :] + v1 * xB[..., :, 1:, :]
                    ym = bmv(Vmm, xm) + bmv(Vmp, xp)
                    yp = bmv(Vpm, xm) + bmv(Vpp, xp)
                    yA[..., :, :-1, :] += v0 * ym
                    yB[..., :, :-1, :] += v1 * ym
                    yA[..., :, 1:, :] += v0 * yp
                    yB[..., :, 1:, :] += v1 * yp
                else:
                    # V: minus (cy,cx,A=t0), plus (cy,cx+1,B=t1)
                    xm, xp = xA[..., :, :-1, :], xB[..., :, 1:, :]
                    yA[..., :, :-1, :] += bmv(Vmm, xm) + bmv(Vmp, xp)
                    yB[..., :, 1:, :] += bmv(Vpm, xm) + bmv(Vpp, xp)
                # H: minus (cy,cx,t1), plus (cy+1,cx,t0)
                Hmm, Hmp, Hpm, Hpp = self.H
                xm, xp = xB[..., :-1, :, :], xA[..., 1:, :, :]
                yB[..., :-1, :, :] += bmv(Hmm, xm) + bmv(Hmp, xp)
                yA[..., 1:, :, :] += bmv(Hpm, xm) + bmv(Hpp, xp)
            y = torch.stack([yA, yB], dim=-2)        # [..., K, s, s, T, nb]

        # ---- subdomain interfaces and the physical boundary (K -> [ky, kx])
        tL = int(sp.side_cells("left")[2][0])
        tR = int(sp.side_cells("right")[2][0])
        tB = int(sp.side_cells("bottom")[2][0])
        tT = int(sp.side_cells("top")[2][0])
        kx, ky = grid.kx, grid.ky
        yg = y.reshape(y.shape[:-5] + (ky, kx, s, s, T, nb))
        xg = xc.reshape(xc.shape[:-5] + (ky, kx, s, s, T, nb))

        def grid_of(b, shape):
            return b.reshape(b.shape[:-4] + shape + (s, nb, nb))

        cc = sp.percell
        if cc:
            mk = _parity_masks(sp, x.dtype, x.device)
        if kx > 1:
            Rii, Rio, Roi, Roo = (grid_of(b, (ky, kx - 1)) for b in self.R)
            if cc:
                # the face's parity is the minus cell's (cy, s-1); both
                # sides couple on t = that parity
                r0, r1 = mk["r0"], mk["r1"]
                xm = (r0 * xg[..., :, :-1, :, s - 1, 0, :]
                      + r1 * xg[..., :, :-1, :, s - 1, 1, :])
                xp = r0 * xg[..., :, 1:, :, 0, 0, :] + r1 * xg[..., :, 1:, :, 0, 1, :]
                ym = bmv(Rii, xm) + bmv(Rio, xp)
                yp = bmv(Roi, xm) + bmv(Roo, xp)
                yg[..., :, :-1, :, s - 1, 0, :] += r0 * ym
                yg[..., :, :-1, :, s - 1, 1, :] += r1 * ym
                yg[..., :, 1:, :, 0, 0, :] += r0 * yp
                yg[..., :, 1:, :, 0, 1, :] += r1 * yp
            else:
                xm = xg[..., :, :-1, :, s - 1, tR, :]    # [..., ky, kx-1, s(cy), nb]
                xp = xg[..., :, 1:, :, 0, tL, :]
                yg[..., :, :-1, :, s - 1, tR, :] += bmv(Rii, xm) + bmv(Rio, xp)
                yg[..., :, 1:, :, 0, tL, :] += bmv(Roi, xm) + bmv(Roo, xp)
        if ky > 1:
            Uii, Uio, Uoi, Uoo = (grid_of(b, (ky - 1, kx)) for b in self.U)
            xm = xg[..., :-1, :, s - 1, :, tT, :]    # [..., ky-1, kx, s(cx), nb]
            xp = xg[..., 1:, :, 0, :, tB, :]
            yg[..., :-1, :, s - 1, :, tT, :] += bmv(Uii, xm) + bmv(Uio, xp)
            yg[..., 1:, :, 0, :, tB, :] += bmv(Uoi, xm) + bmv(Uoo, xp)

        Ds = {k: grid_of(v, (ky, kx)) for k, v in self.D_side.items()}
        if cc:
            # left: cell (cy, 0) holds element t = 1 - parity; right: cell
            # (cy, s-1) element t = parity
            l0, l1, r0, r1 = mk["l0"], mk["l1"], mk["r0"], mk["r1"]
            xl = l1 * xg[..., :, 0, :, 0, 1, :] + l0 * xg[..., :, 0, :, 0, 0, :]
            yl = bmv(Ds["left"][..., :, 0, :, :, :], xl)
            yg[..., :, 0, :, 0, 1, :] += l1 * yl
            yg[..., :, 0, :, 0, 0, :] += l0 * yl
            xr = (r0 * xg[..., :, kx - 1, :, s - 1, 0, :]
                  + r1 * xg[..., :, kx - 1, :, s - 1, 1, :])
            yr = bmv(Ds["right"][..., :, kx - 1, :, :, :], xr)
            yg[..., :, kx - 1, :, s - 1, 0, :] += r0 * yr
            yg[..., :, kx - 1, :, s - 1, 1, :] += r1 * yr
        else:
            yg[..., :, 0, :, 0, tL, :] += bmv(
                Ds["left"][..., :, 0, :, :, :], xg[..., :, 0, :, 0, tL, :])
            yg[..., :, kx - 1, :, s - 1, tR, :] += bmv(
                Ds["right"][..., :, kx - 1, :, :, :], xg[..., :, kx - 1, :, s - 1, tR, :])
        yg[..., 0, :, 0, :, tB, :] += bmv(
            Ds["bottom"][..., 0, :, :, :, :], xg[..., 0, :, 0, :, tB, :])
        yg[..., ky - 1, :, s - 1, :, tT, :] += bmv(
            Ds["top"][..., ky - 1, :, :, :, :], xg[..., ky - 1, :, s - 1, :, tT, :])
        return yg.reshape(yg.shape[:-6] + (K, sp.N))


@dataclass(eq=False)
class LaneStencil:
    """A lane-batched operator A(theta_b), b < B, of a family with a lane
    kernel: the affine family ``op`` and theta [B, Q], nothing per lane.  On
    the card :meth:`apply` is ``op.lane_apply`` (one launch of the family's
    hand kernel on ``op.folded`` in x's dtype; f64 after :func:`cast`, which
    casts theta); on the CPU it is :meth:`materialize`'s apply, bit for bit
    the per-lane form.  Its cell-Jacobi factors (the default preconditioner
    of :meth:`solve_pcg`) are :meth:`materialize`'s."""
    op: object
    theta: torch.Tensor

    def __post_init__(self):
        self._plain = None

    @property
    def space(self):
        return self.op.space

    def materialize(self):
        """The per-lane form of ``op.mix`` in theta's dtype (B copies of
        every field: the plain version of the apply)."""
        if self._plain is None:
            op = self.op
            if op.stencils[0].vol.dtype != self.theta.dtype:
                op = cast(op, self.theta.dtype)
            self._plain = op.mix(self.theta)
        return self._plain

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, K, N] -> A(theta_b) x_b for every lane b (counted by
        :func:`count_apply`); x of any strides (the kernel reads a dense
        copy: the greedy's reconstructed U is an einsum's view)."""
        if x.device.type == "cpu":
            return self.materialize().apply(x)
        count_apply(x)
        return self.op.lane_apply(self.theta, x.contiguous())

    def cell_jacobi_factors(self) -> torch.Tensor:
        return self.materialize().cell_jacobi_factors()

    # the matrix-free PCG of the single-theta form, over this form's apply
    solve_pcg = AssembledStencil.solve_pcg
