"""Matrix-free (stencil) SWIPDG operator on the 3D hex family.

The port of ``pylrbms_tpu/ops/matrixfree3d.py``, the 3D counterpart of
``ops/matrixfree.py``: the operator is held as per-cell volume blocks and
per-face block quadruples, O(K s^3 nb^2) numbers instead of the dense
O(K N^2) subdomain blocks (N = s^3 nb grows cubically), and its apply is a
handful of batched block products with shifted in-place adds on views (the
mesh is structured: no gathers).  Each block product is a multiply and a
sum over the last axis (:func:`~pylrbms_tpu_torch.ops.matrixfree.bmv`), not
an einsum (the einsum form of the 2D apply was 8x slower on the H100).

Layout (x as [..., K, s, s, s, nb], cell index [cz, cy, cx]):
  vol  [K, s, s, s, nb, nb]            y[c] += V x[c]
  X    4 x [K, s, s, s-1, nb, nb]      (cz,cy,cx) <-> (cz,cy,cx+1)
  Y    4 x [K, s, s-1, s, nb, nb]      (cz,cy,cx) <-> (cz,cy+1,cx)
  Z    4 x [K, s-1, s, s, nb, nb]      (cz,cy,cx) <-> (cz+1,cy,cx)
  interface quadruples IX/IY/IZ [E, s^2, nb, nb] + 6 Dirichlet side strips
  (the layouts of ``SwipdgComponent3``; face pos = side_cells ordering).

Lane-batched operators (``StencilOperator3.assemble`` with theta [B, Q]) on
hex Q1 (nb = 8) are a :class:`LaneStencil3`: theta and the component
stencils, folded once per dtype and device into one own block and six
neighbour blocks a cell (:func:`fold_stencils3`), nothing per lane; on the
card its apply is one launch of the hand-written
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil3_apply`, on the CPU it
is the per-lane :class:`AssembledStencil3`'s apply.  Single-theta
operators, and lanes at any other nb, are an :class:`AssembledStencil3`,
whose fields then carry the lane axes (its ``apply`` broadcasts them against
the lanes of x).  This module alone decides which operators take the lane
kernel (:attr:`StencilOperator3.lane_kernel`).  ``solve_pcg`` is
``matrixfree.stencil_pcg``, whose subdomain-block preconditioner goes
through the hand-written
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.precond_dot`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from . import assembly as asm
from . import assembly3d as asm3
from .assembly import IPDGParams, DEFAULT_IPDG
from . import hopper_kernels as hk
from .matrixfree import LaneFamily, LaneStencil, bmv, cast, count_apply, stencil_pcg
from .swipdg3d import SIDES, edge_lists3

# (side, k axis, k index of the boundary layer as a function of the grid,
#  cell axis, cell index as a function of s) in [..., kz, ky, kx, cz, cy, cx, nb]
_BOUNDARY = (("left", -5, lambda g: 0, -2, lambda s: 0),
             ("right", -5, lambda g: g.kx - 1, -2, lambda s: s - 1),
             ("bottom", -6, lambda g: 0, -3, lambda s: 0),
             ("top", -6, lambda g: g.ky - 1, -3, lambda s: s - 1),
             ("near", -7, lambda g: 0, -4, lambda s: 0),
             ("far", -7, lambda g: g.kz - 1, -4, lambda s: s - 1))


@dataclass(eq=False)
class SwipdgStencil3:
    """One affine component in 3D stencil form."""
    vol: torch.Tensor                      # [K, s, s, s, nb, nb]
    X: Tuple[torch.Tensor, ...]            # 4 x [K, s, s, s-1, nb, nb]
    Y: Tuple[torch.Tensor, ...]            # 4 x [K, s, s-1, s, nb, nb]
    Z: Tuple[torch.Tensor, ...]            # 4 x [K, s-1, s, s, nb, nb]
    IX: Tuple[torch.Tensor, ...]           # 4 x [E_X, s^2, nb, nb]
    IY: Tuple[torch.Tensor, ...]
    IZ: Tuple[torch.Tensor, ...]
    D_side: Dict[str, torch.Tensor]        # side -> [K, s^2, nb, nb]


def assemble_swipdg_stencil3(space, lam_fn, kappa_fn=None,
                             ipdg: IPDGParams = DEFAULT_IPDG,
                             dtype=torch.float64, device=None) -> SwipdgStencil3:
    """Stencil form of one affine component (the integrands of
    ``ops/swipdg3d.assemble_swipdg_component3``, kept per cell and face)."""
    s, nb, K = space.s, space.nb, space.K
    origins = space.subdomain_origins
    kw = dict(ipdg=ipdg, dtype=dtype, device=device)

    xq = asm3.vol_points(space, dtype, device)
    lam = lam_fn(xq).to(dtype)
    dphi = asm.tensor(space.vol_dphi, dtype, device)
    w = asm.tensor(space.vol_w, dtype, device)
    if kappa_fn is None:
        G = torch.einsum("q,qia,qja->qij", w, dphi, dphi)
        vol = space.volume * torch.einsum("kcq,qij->kcij", lam, G)
    else:
        kap = kappa_fn(xq).to(dtype)
        vol = space.volume * torch.einsum("q,kcq,qia,kcqab,qjb->kcij",
                                          w, lam, dphi, kap, dphi)
    vol = vol.reshape(K, s, s, s, nb, nb)

    sets = space.interior_face_sets()

    def faces(fam, shape):
        if s == 1:
            return tuple(torch.zeros((K,) + shape + (nb, nb), dtype=dtype, device=device)
                         for _ in range(4))
        cz, cy, cx = sets[fam][:3]
        tab = space.face_tabs[fam]
        _, x_m, x_p = asm3.face_phys_points(space, tab, cz, cy, cx, origins)
        blocks = asm.inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m, x_p,
                                       space.order, **kw)
        return tuple(b.reshape((K,) + shape + (nb, nb)) for b in blocks)

    Xq = faces("X", (s, s, s - 1))
    Yq = faces("Y", (s, s - 1, s))
    Zq = faces("Z", (s - 1, s, s))

    grid = space.grid
    org = origins.reshape(grid.kz, grid.ky, grid.kx, 3)

    def iface(orient, minus_org):
        if minus_org.shape[0] == 0:
            return tuple(torch.zeros((0, s * s, nb, nb), dtype=dtype, device=device)
                         for _ in range(4))
        (fam, cz_m, cy_m, cx_m, _pos), = space.interface_face_groups(orient)
        tab = space.face_tabs[fam]
        _, x_m, x_p = asm3.face_phys_points(space, tab, cz_m, cy_m, cx_m, minus_org)
        return asm.inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m, x_p,
                                     space.order, **kw)

    IX = iface("X", org[:, :, :-1].reshape(-1, 3))
    IY = iface("Y", org[:, :-1, :].reshape(-1, 3))
    IZ = iface("Z", org[:-1].reshape(-1, 3))

    D_side = {}
    for side in SIDES:
        (key, cz, cy, cx, _pos), = space.boundary_face_groups(side)
        tab = space.face_tabs[key]
        _, x_m, _ = asm3.face_phys_points(space, tab, cz, cy, cx, origins)
        D_side[side] = asm.boundary_face_blocks(space, tab, lam_fn, kappa_fn, x_m,
                                                space.order, **kw)
    return SwipdgStencil3(vol=vol, X=Xq, Y=Yq, Z=Zq, IX=IX, IY=IY, IZ=IZ,
                          D_side=D_side)


def mass_stencil3(space, like: SwipdgStencil3) -> SwipdgStencil3:
    """The L2 mass in 3D stencil form (volume blocks only; shapes matched to
    ``like`` so it can join an affine family — the implicit-Euler G)."""
    dtype, device = like.vol.dtype, like.vol.device
    phi = asm.tensor(space.vol_phi, dtype, device)
    w = asm.tensor(space.vol_w, dtype, device)
    elem = space.volume * torch.einsum("q,qi,qj->ij", w, phi, phi)

    def zeros(t):
        return tuple(torch.zeros_like(b) for b in t)

    return SwipdgStencil3(vol=elem.expand(like.vol.shape).contiguous(),
                          X=zeros(like.X), Y=zeros(like.Y), Z=zeros(like.Z),
                          IX=zeros(like.IX), IY=zeros(like.IY), IZ=zeros(like.IZ),
                          D_side={k: torch.zeros_like(v) for k, v in like.D_side.items()})


def fold_stencils3(space, stencils, dtype, device) -> torch.Tensor:
    """The components ``stencils`` folded per hex cell: [Q, K, s, s, s, 7,
    nb, nb], slot 0 the cell's own block (volume, the own-side Fmm / Fpp of
    its inner faces, the interface in_in / out_out blocks and the Dirichlet
    strips), slots 1-6 its coupling to the -x, +x, -y, +y, -z, +z neighbour
    (Fpm / Fmp, the interface out_in / in_out blocks, across subdomains;
    zero where there is none).  ``A x`` is then, for each cell, the sum of
    the seven blocks times x on the cell and its neighbours (the operand of
    :func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil3_apply`); the
    indexing is :meth:`AssembledStencil3.apply`'s, summed in ``dtype``."""
    grid = space.grid
    K, s, nb = space.K, space.s, space.nb
    kz, ky, kx = grid.kz, grid.ky, grid.kx
    P = torch.zeros((len(stencils), kz, ky, kx, s, s, s, 7, nb, nb), dtype=dtype,
                    device=device)
    for q, st in enumerate(stencils):
        st = cast(st, dtype)
        # per slot [K, cz, cy, cx, nb, nb] (cells -5..-3) and its grid view
        # [kz, ky, kx, cz, cy, cx, nb, nb] (k -8..-6, cells -5..-3)
        slot = [P[q].select(-3, j) for j in range(7)]
        flat = [t.view(K, s, s, s, nb, nb) for t in slot]
        flat[0].add_(st.vol.to(device))
        if s > 1:
            for (Fmm, Fmp, Fpm, Fpp), a, lo, hi in ((st.X, -3, 1, 2), (st.Y, -4, 3, 4),
                                                    (st.Z, -5, 5, 6)):
                flat[0].narrow(a, 0, s - 1).add_(Fmm.to(device))
                flat[0].narrow(a, 1, s - 1).add_(Fpp.to(device))
                flat[hi].narrow(a, 0, s - 1).add_(Fmp.to(device))
                flat[lo].narrow(a, 1, s - 1).add_(Fpm.to(device))
        kn = {-8: kz, -7: ky, -6: kx}
        for quads, ka, ca, lo, hi in ((st.IX, -6, -3, 1, 2), (st.IY, -7, -4, 3, 4),
                                      (st.IZ, -8, -5, 5, 6)):
            n = kn[ka] - 1
            if n == 0:
                continue
            shape = [kz, ky, kx]
            shape[ka + 8] = n
            Fii, Fio, Foi, Foo = (t.to(device).reshape(tuple(shape) + (s, s, nb, nb))
                                  for t in quads)
            slot[0].narrow(ka, 0, n).select(ca, s - 1).add_(Fii)
            slot[hi].narrow(ka, 0, n).select(ca, s - 1).add_(Fio)
            slot[lo].narrow(ka, 1, n).select(ca, 0).add_(Foi)
            slot[0].narrow(ka, 1, n).select(ca, 0).add_(Foo)
        for side, ka, kidx, ca, cidx in _BOUNDARY:
            D = st.D_side[side].to(device).reshape(kz, ky, kx, s, s, nb, nb)
            k, c = kidx(grid), cidx(s)
            slot[0].select(ka - 1, k).select(ca - 1, c).add_(D.select(ka, k))
    return P.reshape(len(stencils), K, s, s, s, 7, nb, nb)


@dataclass(eq=False)
class StencilOperator3(LaneFamily):
    """Affine family of 3D stencils with a fused matrix-free apply."""
    space: object
    stencils: Tuple[SwipdgStencil3, ...]

    @property
    def lane_kernel(self):
        """The hand kernel of this family's lane-batched applies:
        ``"stencil3_apply"`` on hex Q1 (nb = 8), else None (the lanes then
        carry per-lane fields)."""
        return "stencil3_apply" if self.space.nb == hk.STENCIL3_NB else None

    def fold(self, dtype, device) -> torch.Tensor:
        return fold_stencils3(self.space, self.stencils, dtype, device)

    def lane(self, theta) -> "LaneStencil3":
        return LaneStencil3(self, theta)

    def lane_apply(self, theta, x) -> torch.Tensor:
        """One :func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil3_apply`
        launch: A(theta_b) x_b for every lane b of x [B, K, N] on the card."""
        g = self.space.grid
        return hk.stencil3_apply(self.folded(x.dtype, x.device), theta, x, (g.kz, g.ky, g.kx))

    def mix(self, theta) -> "AssembledStencil3":
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

        def mix4(name):
            return tuple(mix(lambda st, i=i: getattr(st, name)[i]) for i in range(4))

        return AssembledStencil3(
            space=self.space, vol=mix(lambda st: st.vol),
            X=mix4("X"), Y=mix4("Y"), Z=mix4("Z"),
            IX=mix4("IX"), IY=mix4("IY"), IZ=mix4("IZ"),
            D_side={k: mix(lambda st, k=k: st.D_side[k]) for k in st0.D_side})


@dataclass(eq=False)
class AssembledStencil3:
    space: object
    vol: torch.Tensor
    X: tuple
    Y: tuple
    Z: tuple
    IX: tuple
    IY: tuple
    IZ: tuple
    D_side: dict

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K, N] -> A x, matrix-free (lane axes of x and of the
        fields broadcast; counted by
        :func:`~pylrbms_tpu_torch.ops.matrixfree.count_apply`)."""
        count_apply(x)
        sp = self.space
        grid = sp.grid
        K, s, nb = sp.K, sp.s, sp.nb
        kx, ky, kz = grid.kx, grid.ky, grid.kz
        xQ = x.reshape(x.shape[:-2] + (K, s, s, s, nb))
        y = bmv(self.vol, xQ)
        if s > 1:
            # cell axes of [..., K, cz, cy, cx, nb]: z -4, y -3, x -2
            for (Fmm, Fmp, Fpm, Fpp), a in ((self.X, -2), (self.Y, -3), (self.Z, -4)):
                xm, xp = xQ.narrow(a, 0, s - 1), xQ.narrow(a, 1, s - 1)
                y.narrow(a, 0, s - 1).add_(bmv(Fmm, xm) + bmv(Fmp, xp))
                y.narrow(a, 1, s - 1).add_(bmv(Fpm, xm) + bmv(Fpp, xp))

        # ---- subdomain interfaces: K -> [kz, ky, kx]; axes of
        # [..., kz, ky, kx, cz, cy, cx, nb]: k -7..-5, cells -4..-2
        lead = y.shape[:-5]
        yg = y.reshape(lead + (kz, ky, kx, s, s, s, nb))
        xg = xQ.reshape(xQ.shape[:-5] + (kz, ky, kx, s, s, s, nb))
        kn = {-7: kz, -6: ky, -5: kx}
        for quads, ka, ca in ((self.IX, -5, -2), (self.IY, -6, -3), (self.IZ, -7, -4)):
            n = kn[ka] - 1
            if n == 0:
                continue
            shape = [kz, ky, kx]
            shape[ka + 7] = n
            Fii, Fio, Foi, Foo = (q.reshape(q.shape[:-4] + tuple(shape) + (s, s, nb, nb))
                                  for q in quads)
            xm = xg.narrow(ka, 0, n).select(ca, s - 1)     # [..., kz', ky', kx', a, b, nb]
            xp = xg.narrow(ka, 1, n).select(ca, 0)
            ym = bmv(Fii, xm) + bmv(Fio, xp)
            yp = bmv(Foi, xm) + bmv(Foo, xp)
            yg.narrow(ka, 0, n).select(ca, s - 1).add_(ym)
            yg.narrow(ka, 1, n).select(ca, 0).add_(yp)

        # ---- physical-boundary Dirichlet strips
        for side, ka, kidx, ca, cidx in _BOUNDARY:
            D = self.D_side[side]
            D = D.reshape(D.shape[:-4] + (kz, ky, kx, s, s, nb, nb)).select(ka, kidx(grid))
            k, c = kidx(grid), cidx(s)
            yg.select(ka, k).select(ca, c).add_(bmv(D, xg.select(ka, k).select(ca, c)))
        return yg.reshape(lead + (K, sp.N))

    def cell_blocks(self) -> torch.Tensor:
        """Per-hex-cell nb x nb diagonal blocks (vol + own-side face mm/pp
        contributions + boundary strips on every subdomain side)
        [..., K, s, s, s, nb, nb] — the uninverted cell-Jacobi blocks."""
        s = self.space.s
        d = self.vol.clone()
        if s > 1:
            # cell axes of [..., K, cz, cy, cx, nb, nb]: z -5, y -4, x -3
            for (Fmm, _, _, Fpp), a in ((self.X, -3), (self.Y, -4), (self.Z, -5)):
                d.narrow(a, 0, s - 1).add_(Fmm)
                d.narrow(a, 1, s - 1).add_(Fpp)
        # side strips on every subdomain side (on interfaces the in_in strips
        # differ slightly from the Dirichlet ones: fine for a preconditioner)
        for side, a, idx in (("left", -3, 0), ("right", -3, s - 1),
                             ("bottom", -4, 0), ("top", -4, s - 1),
                             ("near", -5, 0), ("far", -5, s - 1)):
            D = self.D_side[side]
            d.select(a, idx).add_(D.reshape(D.shape[:-3] + (s, s) + D.shape[-2:]))
        return d

    def dense_subdomain_blocks(self) -> torch.Tensor:
        """Exact dense per-subdomain diagonal blocks [K, N, N] in the
        stencil's dtype (:func:`stencil_diag_blocks`: equal to the folded
        ``A_diag`` of the assembled operator).  The truth solver's
        subdomain-block preconditioner is built from them without the
        dense affine family (``truth.py``)."""
        return stencil_diag_blocks(self, dtype=self.vol.dtype)

    def cell_jacobi_factors(self) -> torch.Tensor:
        """Per-hex-cell nb x nb block inverses of :meth:`cell_blocks`,
        Jacobi-scaled, inverted in the operator's dtype."""
        d = self.cell_blocks()
        dvec = torch.abs(torch.diagonal(d, dim1=-2, dim2=-1))
        sca = 1.0 / torch.sqrt(torch.clamp(dvec, min=1e-300))
        S = sca[..., :, None] * sca[..., None, :]
        return torch.linalg.inv(d * S) * S

    def solve_pcg(self, b, tol: float = 1e-10, maxiter: int = 3000,
                  factors=None, block_factors=None, coarse_inv=None,
                  coarse_basis=None, return_iters: bool = False,
                  coarse_f32: bool = False, x0=None):
        """:func:`~pylrbms_tpu_torch.ops.matrixfree.stencil_pcg` on this
        operator's hex cells."""
        sp = self.space
        return stencil_pcg(self, b, (sp.K, sp.s, sp.s, sp.s, sp.nb), tol, maxiter, factors,
                           block_factors, coarse_inv, coarse_basis, return_iters, coarse_f32, x0)


class LaneStencil3(LaneStencil):
    """The lane form (``matrixfree.LaneStencil``) of a hex Q1 family: on the
    card one :func:`~pylrbms_tpu_torch.ops.hopper_kernels.stencil3_apply`
    launch an apply, on the CPU the per-lane :class:`AssembledStencil3`."""

    # the matrix-free PCG of the single-theta form, over this form's apply
    solve_pcg = AssembledStencil3.solve_pcg


def stencil_coarse_matrix(A: AssembledStencil3, chunk: int = 64) -> torch.Tensor:
    """Galerkin coarse matrix on the subdomain-constant space from the
    stencil alone: A0[k, k'] = 1_k^T A 1_k' ([K, K]); the columns are the
    per-subdomain sums of A applied to the subdomain indicators, in chunks
    of ``chunk`` indicators (the one-shot [K, K, N] batch is gigabytes at
    scale)."""
    sp = A.space
    K, N = sp.K, sp.N
    eye = torch.eye(K, dtype=A.vol.dtype, device=A.vol.device)
    cols = []
    for lo in range(0, K, chunk):
        X = eye[lo:lo + chunk, :, None].expand(-1, K, N)
        cols.append(A.apply(X).sum(dim=2))                 # [b, K]
    return torch.cat(cols, dim=0).T


def stencil_diag_blocks(A: AssembledStencil3, dtype=torch.float32) -> torch.Tensor:
    """Dense per-subdomain diagonal blocks [K, N, N] scattered from the
    assembled stencil: volume + intra-subdomain face quadruples + interface
    in_in/out_out + physical-boundary Dirichlet strips — the result of
    ``swipdg3d.fold_diag3`` for the assembled operator, without the dense
    affine family.  f32 by default (a preconditioner's precision)."""
    sp = A.space
    grid = sp.grid
    K, N, s, nb = sp.K, sp.N, sp.s, sp.nb
    C = s ** 3
    D = torch.zeros((K, N, N), dtype=dtype, device=A.vol.device)
    rows_c = np.arange(N, dtype=np.int64).reshape(C, nb)
    asm.scatter_blocks(D, A.vol.reshape(K, C, nb, nb), rows_c, rows_c)
    sets = sp.interior_face_sets()
    for fam, quads in (("X", A.X), ("Y", A.Y), ("Z", A.Z)):
        cz_m, cy_m, cx_m, cz_p, cy_p, cx_p = sets[fam]
        if cz_m.size == 0:
            continue
        F = cz_m.size
        rows_m = sp.cell_dofs(cz_m, cy_m, cx_m)
        rows_p = sp.cell_dofs(cz_p, cy_p, cx_p)
        Fmm, Fmp, Fpm, Fpp = (q.reshape(K, F, nb, nb) for q in quads)
        asm.scatter_blocks(D, Fmm, rows_m, rows_m)
        asm.scatter_blocks(D, Fmp, rows_m, rows_p)
        asm.scatter_blocks(D, Fpm, rows_p, rows_m)
        asm.scatter_blocks(D, Fpp, rows_p, rows_p)
    side_rows = {sd: sp.side_dofs(sd).reshape(s * s, nb) for sd in SIDES}

    def add_rows(subs, rows, blk):
        if subs.size:
            asm.add_at(D, (subs[:, None, None, None], rows[None, :, :, None],
                           rows[None, :, None, :]), blk)

    xlo, xhi, ylo, yhi, zlo, zhi = edge_lists3(grid)
    for lo_k, hi_k, quads, hi_side, lo_side in ((xlo, xhi, A.IX, "right", "left"),
                                                (ylo, yhi, A.IY, "top", "bottom"),
                                                (zlo, zhi, A.IZ, "far", "near")):
        add_rows(lo_k, side_rows[hi_side], quads[0])       # in_in
        add_rows(hi_k, side_rows[lo_side], quads[3])       # out_out
    subs_all = np.arange(K)
    kx, ky, kz = grid.kx, grid.ky, grid.kz
    sx, sy, sz = subs_all % kx, (subs_all // kx) % ky, subs_all // (kx * ky)
    bnd = {"left": subs_all[sx == 0], "right": subs_all[sx == kx - 1],
           "bottom": subs_all[sy == 0], "top": subs_all[sy == ky - 1],
           "near": subs_all[sz == 0], "far": subs_all[sz == kz - 1]}
    for sd, subs in bnd.items():
        add_rows(subs, side_rows[sd],
                 A.D_side[sd][torch.as_tensor(subs, device=D.device)])
    return D
