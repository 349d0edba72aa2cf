"""Banded operators: one rank's subdomain rows and their halo apply.

What GSPMD inserts into the sharded ``AssembledStencil.apply`` /
``AssembledStencil3.apply`` (and into the block operator's coupling
gathers) written out for one rank of a
:class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh`:

* :class:`BandedStencil` slices a stencil family to the rank's band of
  subdomain rows (z-layers in 3D) plus one halo row (layer) on each side
  that has a neighbor.  Its assembled ``apply`` receives the neighbors'
  boundary rows of x (one exchange), runs the unsharded stencil apply on
  band + halo (through :class:`BandSpace`, the space with fewer rows) and
  keeps the band: the halo rows' own outputs are incomplete and dropped,
  the band's are exact.  ``solve_pcg`` is the matrix-free PCG of
  ``ops/matrixfree`` with its dot products all-reduced.
* :class:`BandedBlockOp` holds the band's diagonal blocks and the coupling
  strips of every interface whose receiving subdomain lies in the band; its
  apply is one ``block_matvec`` launch on the band and the strip products
  read from band + halo, so no diagonal block is applied twice.

A band must consist of whole rows: the number of subdomain rows (z-layers)
must be divisible by the mesh size.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..la.block import _couple, block_jacobi_factors
from ..la.krylov import lane_dot, pcg_chunked
from ..ops.hopper_kernels import block_matvec, precond_dot
from ..ops.matrixfree import stencil_pcg
from ..ops.matrixfree3d import SwipdgStencil3


def rows_of(grid, dim3: bool):
    """(subdomain rows along the banded axis, subdomains per row): y-rows
    of kx in 2D, z-layers of kx ky in 3D."""
    return (grid.kz, grid.kx * grid.ky) if dim3 else (grid.ky, grid.kx)


def band_rows(mesh, n_rows: int):
    """(r0, r1, lo, hi): this rank's rows [r0, r1) and whether it has a
    halo row below (lo) and above (hi)."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} subdomain rows not divisible by mesh size {mesh.size}")
    rb = n_rows // mesh.size
    r0 = mesh.rank * rb
    return r0, r0 + rb, int(r0 > 0), int(r0 + rb < n_rows)


def extend_band(mesh, x, row: int):
    """x [..., Kb, N] (a rank's band) with the neighbors' boundary rows of
    ``row`` subdomains attached (one exchange): [..., Kb + halo, N]."""
    below, above = mesh.exchange(x[..., :row, :], x[..., -row:, :])
    return torch.cat([t for t in (below, x, above) if t is not None], dim=-2)


def band_static(st, e0: int, e1: int):
    """The ``BlockOpStatic`` of subdomains [e0, e1) (whole rows) with the
    interfaces inside them, renumbered from 0, and per coupling pair
    attribute (``left_k``, ``low_k``, ``near_k``) the indices of those
    interfaces in ``st``'s lists."""
    from ..la.block import BlockOpStatic
    rows_e = (e1 - e0) // rows_of(st, st.dim3)[1]
    pairs = (("left_k", "right_k"), ("low_k", "up_k"))
    pairs += (("near_k", "far_k"),) if st.dim3 else ()
    kw, sel = {}, {}
    for a, b in pairs:
        ka, kb = getattr(st, a), getattr(st, b)
        sel[a] = np.nonzero((ka >= e0) & (ka < e1) & (kb >= e0) & (kb < e1))[0]
        kw[a], kw[b] = ka[sel[a]] - e0, kb[sel[a]] - e0
    return BlockOpStatic(K=e1 - e0, N=st.N, s=st.s, nb=st.nb, kx=st.kx,
                         ky=st.ky if st.dim3 else rows_e, kz=rows_e if st.dim3 else 1,
                         side_rows=st.side_rows, **kw), sel


class _BandGrid:
    """The subdomain grid cut to ``rows`` rows (the banded axis)."""

    def __init__(self, grid, rows: int, dim3: bool):
        self.kx = grid.kx
        self.ky = grid.ky if dim3 else rows
        self.kz = rows if dim3 else 1
        self.dim = 3 if dim3 else 2


class BandSpace:
    """A block space restricted to ``rows`` consecutive subdomain rows
    (z-layers in 3D): ``K`` and ``grid`` describe the rows, every other
    attribute (per-subdomain tables, N, s, nb, ...) is the space's."""

    def __init__(self, space, rows: int):
        dim3 = getattr(space, "dim", 2) == 3
        self._space = space
        self.grid = _BandGrid(space.grid, rows, dim3)
        self.K = rows * rows_of(space.grid, dim3)[1]

    def __getattr__(self, name):
        return getattr(self.__dict__["_space"], name)


def _slice_stencil(st, space, e0: int, e1: int):
    """The affine stencil component ``st`` on subdomain rows [e0, e1):
    per-subdomain fields cut along K, interface quadruples to the
    interfaces inside those rows (the row-crossing family keeps the
    e1 - e0 - 1 interface rows between them)."""
    dim3 = isinstance(st, SwipdgStencil3)
    n_rows, row = rows_of(space.grid, dim3)

    def k(t):
        return t[e0 * row:e1 * row]

    def in_row(t):
        per = t.shape[0] // n_rows
        return t[e0 * per:e1 * per]

    def across(t):
        per = t.shape[0] // (n_rows - 1) if n_rows > 1 else 0
        return t[e0 * per:(e1 - 1) * per]

    def quads(ts, f):
        return tuple(f(t) for t in ts)

    fams = ({"X": k, "Y": k, "Z": k, "IX": in_row, "IY": in_row, "IZ": across} if dim3
            else {"D": k, "V": k, "H": k, "R": in_row, "U": across})
    return dataclasses.replace(
        st, vol=k(st.vol), D_side={sd: k(v) for sd, v in st.D_side.items()},
        **{name: quads(getattr(st, name), f) for name, f in fams.items()})


class BandedStencil:
    """One rank's band (+ halo rows) of an affine stencil family; see the
    module docstring.  ``assemble(theta)`` takes theta [Q] or lanes [B, Q]."""

    def __init__(self, mesh, sop):
        sp = sop.space
        dim3 = getattr(sp, "dim", 2) == 3
        n_rows, row = rows_of(sp.grid, dim3)
        r0, r1, lo, hi = band_rows(mesh, n_rows)
        e0, e1 = r0 - lo, r1 + hi
        self.mesh, self.row, self.lo = mesh, row, lo
        self.K, self.k0, self.Kb = sp.K, r0 * row, (r1 - r0) * row
        self.space = BandSpace(sp, e1 - e0)

        def on_device(st):
            return dataclasses.replace(st, **{
                f.name: _to(getattr(st, f.name), mesh.device) for f in dataclasses.fields(st)})
        self.sop = type(sop)(self.space, tuple(on_device(_slice_stencil(st, sp, e0, e1))
                                               for st in sop.stencils))

    def assemble(self, theta) -> "BandedAssembledStencil":
        return BandedAssembledStencil(self.mesh, self.sop.assemble(theta), self.lo,
                                      self.row, self.k0, self.Kb, self.K)


def _to(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple):
        return tuple(_to(u, device) for u in v)
    if isinstance(v, dict):
        return {k: _to(u, device) for k, u in v.items()}
    return v


@dataclass(eq=False)
class BandedAssembledStencil:
    """An assembled stencil on band + halo rows (``A``) and its halo apply
    on band vectors [..., Kb, N]; ``ops.matrixfree.cast`` converts ``A``."""
    mesh: object
    A: object
    lo: int
    row: int
    k0: int
    Kb: int
    K: int

    def apply(self, x):
        """x [..., Kb, N] (this rank's band) -> (A x) on the band."""
        k = self.lo * self.row
        return self.A.apply(extend_band(self.mesh, x, self.row))[..., k:k + self.Kb, :].contiguous()

    def _cell_factors(self, cell_ndim: int):
        """The cell-block Jacobi factors of the band rows."""
        k = self.lo * self.row
        return self.A.cell_jacobi_factors().narrow(-(cell_ndim + 2), k, self.Kb)

    def solve_pcg(self, b, tol: float = 1e-10, maxiter: int = 3000, factors=None,
                  block_factors=None, coarse_inv=None, coarse_basis=None,
                  return_iters: bool = False, coarse_f32: bool = False, x0=None):
        """:func:`~pylrbms_tpu_torch.ops.matrixfree.stencil_pcg` on the band:
        b, ``block_factors`` [Kb, N, N] (or cell ``factors``) and
        ``coarse_basis`` [Kb, N, m] are this rank's bands, ``coarse_inv``
        the replicated [K*m, K*m] (or [K, K]) inverse.  Every dot product
        is all-reduced."""
        sp = self.A.space
        cell = ((sp.s, sp.s, sp.s, sp.nb) if getattr(sp, "dim", 2) == 3
                else (sp.s, sp.s, sp.T * sp.nb))
        if block_factors is None and factors is None:
            factors = self._cell_factors(len(cell))
        return stencil_pcg(self, b, (self.Kb,) + cell, tol, maxiter, factors, block_factors,
                           coarse_inv, coarse_basis, return_iters, coarse_f32, x0,
                           comm=self.mesh, band=(self.k0, self.K))


@dataclass(eq=False)
class BandedBlockOp:
    """One rank's rows of an ``AffineBlockOp``: the band's diagonal blocks
    ``A_diag`` [Q, Kb, N, N] and, per coupling family, the strips
    [Q, E, F, nb, nb] of the interfaces whose receiving subdomain is in the
    band, with their flat rows (``flat[name] = (out in band coordinates,
    in in band + halo coordinates)``)."""
    mesh: object
    A_diag: torch.Tensor
    C: dict
    flat: dict
    lo: int
    row: int
    k0: int
    K: int

    @staticmethod
    def from_affine(mesh, op, A_diag_band=None) -> "BandedBlockOp":
        st = op.static
        n_rows, row = rows_of(st, st.dim3)
        r0, r1, lo, _hi = band_rows(mesh, n_rows)
        k0, k1 = r0 * row, r1 * row
        e0 = k0 - lo * row
        dev, N, sr = mesh.device, st.N, st.side_rows
        C, flat = {}, {}
        for name, ro, ri, k_out, k_in in st.families():
            sel = np.nonzero((k_out >= k0) & (k_out < k1))[0]
            C[name] = getattr(op, name)[:, torch.as_tensor(sel, device=getattr(op, name).device)
                                        ].to(dev)
            flat[name] = (torch.as_tensor((k_out[sel] - k0)[:, None, None] * N + sr[ro][None],
                                          device=dev),
                          torch.as_tensor((k_in[sel] - e0)[:, None, None] * N + sr[ri][None],
                                          device=dev))
        A_diag = (A_diag_band if A_diag_band is not None
                  else mesh.put(op.A_diag, mesh.shard_k(1)))
        return BandedBlockOp(mesh, A_diag, C, flat, lo, row, k0, st.K)

    def component(self, q: int, dtype=None) -> "BandedAssembledBlockOp":
        """The affine component ``q`` alone (in ``dtype``)."""
        dtype = dtype or self.A_diag.dtype
        return BandedAssembledBlockOp(
            self.mesh, self.A_diag[q].to(dtype).contiguous(),
            {n: C[q].to(dtype) for n, C in self.C.items()},
            self.flat, self.lo, self.row, self.k0, self.K)

    def assemble(self, theta) -> "BandedAssembledBlockOp":
        theta = torch.as_tensor(theta).to(self.A_diag)
        return BandedAssembledBlockOp(
            self.mesh, torch.einsum("q,qkij->kij", theta, self.A_diag).contiguous(),
            {n: torch.einsum("q,qefij->efij", theta, C) for n, C in self.C.items()},
            self.flat, self.lo, self.row, self.k0, self.K)


@dataclass(eq=False)
class BandedAssembledBlockOp:
    """The theta-assembled :class:`BandedBlockOp`: ``A_diag`` [Kb, N, N],
    strips ``C[name]`` [E, F, nb, nb]."""
    mesh: object
    A_diag: torch.Tensor
    C: dict
    flat: dict
    lo: int
    row: int
    k0: int
    K: int

    @property
    def Kb(self) -> int:
        return self.A_diag.shape[0]

    def _apply(self, xb, xe):
        y = block_matvec(self.A_diag[None], xb)
        for name, C in self.C.items():
            y = _couple(y, xe, C, *self.flat[name])
        return y

    def apply(self, x):
        """x [Kb, N] or [B, Kb, N] (this rank's band) -> (A x) on the band;
        one exchange of the boundary rows."""
        single = x.ndim == 2
        xb = (x[None] if single else x).contiguous()
        y = self._apply(xb, extend_band(self.mesh, xb, self.row))
        return y[0] if single else y

    def apply_ext(self, xe):
        """(A x) on the band from x given on band + halo rows, [B, Kb +
        halo, N] (no exchange: the caller holds those rows)."""
        k = self.lo * self.row
        return self._apply(xe[:, k:k + self.Kb].contiguous(), xe)

    def block_jacobi_factors(self):
        return block_jacobi_factors(self.A_diag)

    def solve_pcg(self, b, tol: float = 1e-12, maxiter: int = 2000, factors=None,
                  return_iters: bool = False):
        """Block-Jacobi PCG on the band (b [Kb, N] or [B, Kb, N]): the
        preconditioner and the per-subdomain ``r . z`` partials in one
        ``precond_dot`` launch, summed on the band, all-reduced with
        ``r . r`` in one call."""
        dt = self.A_diag.dtype
        F = (factors if factors is not None else self.block_jacobi_factors()).to(dt).contiguous()
        single = b.ndim == 2
        bb = (b[None] if single else b).to(dt).contiguous()

        def M(r):
            z, rz = precond_dot(F, r)
            return z, rz.sum(-1)

        x, it = pcg_chunked(self.apply, M, bb, tol, maxiter, comm=self.mesh)
        if single:
            x, it = x[0], it[0]
        return (x, it) if return_iters else x

