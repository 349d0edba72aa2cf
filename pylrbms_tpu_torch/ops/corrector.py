"""Batched oversampled-patch corrector solves (online enrichment, on device).

The port of ``pylrbms_tpu/ops/corrector.py`` (2D and 3D hex).
``model.solve_for_local_correction`` assembles and LU-solves one dense patch
system per marked subdomain on the host.  Here ALL marked subdomains are
solved at once by masked PCG on the union space [B, K, N]:

* the patch operator is the affine block operator with (i) couplings gated by
  "both endpoints inside the patch" and (ii) the one-sided Dirichlet penalty
  blocks added on every subdomain side whose neighbor is outside the patch
  (or on the physical boundary) — exactly the fresh neighborhood SWIPDG
  assembly, expressed as masks over precomputed pieces;
* the masked system is SPD on the patch subspace; starting from 0 with a
  masked preconditioner, PCG never leaves it;
* the preconditioner is the (theta-assembled) inverse of the local
  all-Dirichlet diagonal blocks — computed once per parameter, shared by all
  patches — plus an exact patch-constant coarse level.

The block products of the PCG body go through the hand-written kernels:
the dense apply's ``A_loc[k] @ x[b, k]`` is one
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.block_matvec` launch (G = 1),
and the preconditioner's ``Minv[k] @ r[b, k]`` with the per-subdomain
``r . z`` partials one
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.precond_dot` launch.  Above
32 768 dofs the patch operator is applied matrix-free (the global stencil
apply on the masked field plus strip corrections on patch-crossing faces).

Everything runs in the model's dtype: the reference's float32 patch systems
at scale (above 32 768 dofs, 8 192 in 3D) and its float32 inversion gate
exist for a chip without native float64 and are not ported; of its 3D
stencil gate the CPU branch is taken (the stencil above 32 768 dofs in 2D
and 3D).  Correctness is pinned against the host dense
patch solver in tests/test_torch_corrector.py.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .hopper_kernels import block_matvec, precond_dot
from .matrixfree import StencilOperator, bmv
from .matrixfree3d import StencilOperator3
from ..la.krylov import default_chunk
from ..utils.timers import GLOBAL_TIMINGS as T

SIDES = ("left", "right", "bottom", "top")
SIDES3 = SIDES + ("near", "far")
QUADS = ("in_in", "in_out", "out_in", "out_out")
STENCIL_MIN_DOFS = 32768
# per axis: (quadruple stem 2D, stem 3D, hi side, lo side, static pair
# attributes, flat-rows family of the io coupling)
_AXES = (("R", "X", "right", "left", ("left_k", "right_k"), "C_R_io"),
         ("U", "Y", "top", "bottom", ("low_k", "up_k"), "C_U_io"),
         (None, "Z", "far", "near", ("near_k", "far_k"), "C_W_io"))


def patch_coarse_matrix(A0c, pmask, fams):
    """Exact Galerkin coarse matrix [B, K, K] of the masked patch operator
    on the subdomain-constant space.

    ``A0c`` [K, K] is the GLOBAL operator's coarse matrix; masking it to the
    patch (``pm A0c pm``) is exact for intra-patch faces and the physical
    boundary, but on patch-CROSSING faces it keeps the global in_in/out_out
    coupling contribution that the patch operator replaces with the
    one-sided Dirichlet penalty.  Swap the two there: per crossing face,
    subtract the coupling block's entry sum and add the penalty block's
    entry sum.

    ``fams``: per coupling family ``(Cq, D_in, D_out, kl, kr)`` with
    ``Cq['in_in']/['out_out']`` [E, f, i, j] the theta-assembled coupling
    diagonals, ``D_in/D_out`` [K, f, i, j] the penalty blocks on the side of
    kl facing kr / of kr facing kl, and ``kl/kr`` the edge endpoint lists
    (index tensors)."""
    Ac = pmask[:, :, None] * A0c[None] * pmask[:, None, :]
    diag = torch.zeros_like(pmask)
    for Cq, D_in, D_out, kl, kr in fams:
        if kl.numel() == 0:
            continue
        gL = pmask[:, kl] * (1.0 - pmask[:, kr])          # [B, E]
        gR = pmask[:, kr] * (1.0 - pmask[:, kl])
        cin = D_in[kl].sum(dim=(1, 2, 3)) - Cq["in_in"].sum(dim=(1, 2, 3))      # [E]
        cout = D_out[kr].sum(dim=(1, 2, 3)) - Cq["out_out"].sum(dim=(1, 2, 3))
        diag.index_add_(1, kl, gL * cin[None])
        diag.index_add_(1, kr, gR * cout[None])
    return Ac + torch.diag_embed(diag)


class BatchedCorrector:

    def __init__(self, d):
        self.d = d
        grid, sp = d.grid, d.space
        K = sp.K
        st = d.op.static
        dev = d.device
        self.st = st
        self.dim3 = st.dim3
        self.sides = SIDES3 if self.dim3 else SIDES
        # the coupling axes of this dimension (stem, hi side, lo side, pair
        # attributes, flat-rows family)
        self.axes = [(a[1] if self.dim3 else a[0],) + a[2:]
                     for a in _AXES[:3 if self.dim3 else 2]]
        # neighbor table [K, 2 dim] (-1 = physical boundary): side i steps
        # -+1 along axis i // 2
        dims = (grid.kx, grid.ky, grid.kz) if self.dim3 else (grid.kx, grid.ky)
        nbr = -np.ones((K, len(self.sides)), dtype=np.int64)
        for k in range(K):
            coords = grid.subdomain_coords(k)
            for i in range(len(self.sides)):
                nxt = list(coords)
                nxt[i // 2] += -1 if i % 2 == 0 else 1
                if all(0 <= c < n for c, n in zip(nxt, dims)):
                    nbr[k, i] = grid.subdomain_index(*nxt)
        self.nbr = nbr
        # patch membership [K, K]: row k = indicator of neighborhood_of(k)
        pm = np.zeros((K, K))
        for k in range(K):
            pm[k, grid.neighborhood_of(k)] = 1.0
        comps = d.components
        cdt = d.op.A_diag.dtype
        self.dtype = cdt
        self.patch_mask_table = torch.as_tensor(pm, dtype=cdt, device=dev)
        self.side_rows = {s: torch.as_tensor(st.side_rows[s].reshape(-1), device=dev)
                          for s in self.sides}
        self.A_loc = torch.stack([c.A_loc for c in comps]).to(cdt)
        self.D_side = {s: torch.stack([c.D_side[s] for c in comps]).to(cdt)
                       for s in self.sides}
        # the interface quadruples per axis stem (R/U in 2D, X/Y/Z in 3D)
        self.quads = {stem: {nm: torch.stack([getattr(c, f"{stem}_{nm}")
                                              for c in comps]).to(cdt)
                             for nm in QUADS}
                      for stem, *_ in self.axes}
        # at scale, apply the patch operator MATRIX-FREE: the global stencil
        # apply on the masked field + strip corrections for patch-crossing
        # faces.  Small problems keep the dense path; enable_stencil is the
        # test hook.
        self.stencils = None
        if (d.estimator is not None
                and getattr(d.estimator.data, "lambda_funcs", None)
                and K * sp.N > STENCIL_MIN_DOFS):
            self.enable_stencil()
        # per-component subdomain-constant coarse matrices [Q, K, K]: the
        # patch preconditioner's second level.  EXACT for the masked patch
        # operator: the coarse vectors 1_k live within single subdomains, so
        # C^T (pm A pm) C = pm (C^T A C) pm entrywise; the patch-boundary
        # Dirichlet penalties only change the diagonal (patch_coarse_matrix).
        # Block-Jacobi alone leaves the patch-constant modes
        # unpreconditioned.
        Q = len(comps)
        eye = torch.eye(Q, dtype=d.op.A_diag.dtype, device=dev)
        self.A0c_q = torch.stack([d.op.assemble(eye[q]).coarse_matrix()
                                  for q in range(Q)]).to(cdt)
        # PCG iterations of the last solve (the lock-step count of its lanes)
        # and each lane's true relative residual ||b - A x|| / ||b|| at its
        # exit ([B] on the device)
        self.last_iters = self.last_residual = None
        # default SubdomainMesh of solve (the enrichment sets the reductor's)
        self.mesh = None

    def enable_stencil(self):
        """Use the matrix-free patch apply (at any scale: the test hook)."""
        from .matrixfree import cast
        self.stencils = tuple(cast(s, self.dtype) for s in self.d.mf_operator().stencils)
        return self

    # ------------------------------------------------------------------
    def _graph(self, body, state):
        """``body(*state) -> state`` as a CUDA graph: one eager call on the
        capture stream (a real evaluation, which also makes every lazy
        allocation), then the capture of one more on static copies of its
        result.  Returns (the eager call's state, ``replay(*state) ->
        state``), which copies a state it is not handed back into the static
        inputs and replays; the state it returns is the static tensors,
        which the next replay overwrites.  Every capture of this corrector
        runs on one stream into the memory pool of the one before, which
        the corrector keeps (a pool lives while a graph of it does); a
        graph is only replayed before the next capture."""
        dev = state[0].device
        if getattr(self, "_stream", None) is None:
            self._stream, self._last_graph = torch.cuda.Stream(dev), None
        stream, last = self._stream, self._last_graph
        here = torch.cuda.current_stream(dev)
        stream.wait_stream(here)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            state = body(*state)
            static = tuple(t.clone() for t in state)
            graph.capture_begin(pool=None if last is None else last.pool(),
                                capture_error_mode="thread_local")
            try:
                for t, n in zip(static, body(*static)):
                    t.copy_(n)
            finally:
                graph.capture_end()
        here.wait_stream(stream)
        self._last_graph = graph

        def replay(*now):
            for t, n in zip(static, now):
                if t is not n:
                    t.copy_(n)
            graph.replay()
            return static
        return state, replay

    def _view(self, e0: int, e1: int):
        """The corrector's pieces on subdomains [e0, e1) (whole rows, the
        interfaces inside them renumbered from 0): static, neighbor table
        (a neighbor outside the rows counts as boundary), A_loc, D_side,
        interface quadruples and the stencil (space, stencils)."""
        K = self.st.K
        if (e0, e1) == (0, K):
            return SimpleNamespace(st=self.st, nbr=self.nbr, A_loc=self.A_loc,
                                   D_side=self.D_side, quads=self.quads,
                                   space=self.d.space, stencils=self.stencils)
        from ..parallel.stencil import BandSpace, _slice_stencil, band_static, rows_of
        st_e, sel = band_static(self.st, e0, e1)
        nbr = self.nbr[e0:e1] - e0
        nbr[(nbr < 0) | (nbr >= e1 - e0)] = -1
        dev = self.A_loc.device
        quads = {stem: {nm: C[:, torch.as_tensor(sel[pk[0]], device=dev)]
                        for nm, C in self.quads[stem].items()}
                 for stem, _hi, _lo, pk, _fl in self.axes}
        space = stencils = None
        if self.stencils is not None:
            row = rows_of(self.st, self.dim3)[1]
            space = BandSpace(self.d.space, (e1 - e0) // row)
            stencils = tuple(_slice_stencil(t, self.d.space, e0 // row, e1 // row)
                             for t in self.stencils)
        return SimpleNamespace(st=st_e, nbr=nbr, A_loc=self.A_loc[:, e0:e1],
                               D_side={sd: v[:, e0:e1] for sd, v in self.D_side.items()},
                               quads=quads, space=space, stencils=stencils)

    def _solve(self, theta, marked, rhs_full, tol, maxiter, two_level, mesh=None):
        st = self.st
        K, N, nb = st.K, st.N, st.nb
        B = marked.numel()
        dev = rhs_full.device
        side_rows = self.side_rows
        mix = lambda C: torch.einsum("q,q...->...", theta, C)       # noqa: E731
        idx = lambda a: torch.as_tensor(a, device=dev)              # noqa: E731
        pmask_full = self.patch_mask_table[marked]                  # [B, K]
        # K-sharded: this rank's rows [k0, k1) and the rows [e0, e1) with
        # one halo row on each side that has a neighbor; the apply runs on
        # the latter and keeps the former
        if mesh is None:
            k0, k1, e0, e1, row = 0, K, 0, K, 0
        else:
            from ..parallel.stencil import band_rows, rows_of
            n_rows, row = rows_of(st, self.dim3)
            r0, r1, lo, hi = band_rows(mesh, n_rows)
            k0, k1, e0, e1 = r0 * row, r1 * row, (r0 - lo) * row, (r1 + hi) * row
        v = self._view(e0, e1)
        Ke = e1 - e0
        kb = slice(k0 - e0, k1 - e0)
        A_loc = mix(v.A_loc).contiguous()
        D = {sd: mix(v.D_side[sd]) for sd in self.sides}
        # per axis: (theta-assembled quadruples, hi side, lo side, lower /
        # upper subdomain of each pair, flat-rows family)
        fams = [({nm: mix(C) for nm, C in v.quads[stem].items()}, hi, lo,
                 idx(getattr(v.st, pk[0])), idx(getattr(v.st, pk[1])), fl)
                for stem, hi, lo, pk, fl in self.axes]

        pmask = pmask_full[:, e0:e1]                                # [B, Ke]
        pm3 = pmask[:, :, None]
        # neighbor-inside-patch [B, Ke, 4]; Dirichlet on side i of member k
        # iff k is in the patch and its neighbor is not
        nbr = idx(v.nbr)
        nbr_in = torch.where(nbr[None] >= 0, pmask[:, torch.clamp(nbr, min=0)],
                             torch.zeros((), dtype=pmask.dtype, device=dev))
        dir_mask = pm3 * (1.0 - nbr_in)

        # preconditioner: all-Dirichlet local diagonal blocks of the band,
        # symmetrically Jacobi-scaled, inverted once per parameter
        A_dir = A_loc[kb].clone()
        for sd in self.sides:
            rows = side_rows[sd].reshape(-1, nb)
            A_dir[:, rows[:, :, None], rows[:, None, :]] += D[sd][kb]
        dg = torch.diagonal(A_dir, dim1=-2, dim2=-1)
        sc = torch.where(dg > 0, 1.0 / torch.sqrt(torch.where(dg > 0, dg, torch.ones_like(dg))),
                         torch.ones_like(dg))
        S = sc[:, :, None] * sc[:, None, :]
        Minv = (torch.linalg.inv(A_dir * S) * S).contiguous()

        flat = v.st.flat_rows(dev)

        if v.stencils is not None:
            Op = StencilOperator3 if self.dim3 else StencilOperator
            sA = Op(v.space, v.stencils).assemble(theta)
            gdims = (v.st.kz, v.st.ky, v.st.kx) if self.dim3 else (v.st.ky, v.st.kx)
            nd = len(gdims)
            F = side_rows[SIDES[0]].numel() // nb
            # (family, D side of the LO subdomain, of the HI one, grid axis:
            # the x pairs on the last axis of the grid view)
            cross_fams = [(Cq, hi, lo, nd - 1 - a)
                          for a, (Cq, hi, lo, *_r) in enumerate(fams)]

            def apply_rows(x):                         # x [B, Ke, N]
                xm = x * pm3
                y = sA.apply(xm)
                # patch-crossing faces: the global stencil applied the
                # in_in/out_out coupling penalty; the patch problem wants
                # the one-sided Dirichlet penalty instead.  Expressed on the
                # [(kz,) ky, kx] grid view with contiguous slice updates.
                xg = xm.reshape((B,) + gdims + (N,))
                pg = pmask.reshape((B,) + gdims)
                yg = y.reshape((B,) + gdims + (N,)).clone()

                def cross(Cin, Dfull, rows, sl_in, sl_out, eshape):
                    a, b_ = (slice(None),) + sl_in, (slice(None),) + sl_out
                    gate = pg[a] * (1.0 - pg[b_])
                    strip = (Dfull.reshape(gdims + (F, nb, nb))[sl_in]
                             - Cin.reshape(eshape + (F, nb, nb)))
                    xs = xg[a][..., rows].reshape((B,) + eshape + (F, nb))
                    upd = bmv(strip, xs)
                    yg[a + (rows,)] += gate[..., None] * upd.reshape(
                        (B,) + eshape + (rows.numel(),))

                for Cq, sd_lo, sd_hi, ax in cross_fams:
                    if gdims[ax] <= 1:
                        continue
                    lo = tuple(slice(None, -1) if i == ax else slice(None) for i in range(nd))
                    hi = tuple(slice(1, None) if i == ax else slice(None) for i in range(nd))
                    eshape = tuple(g - 1 if i == ax else g for i, g in enumerate(gdims))
                    cross(Cq["in_in"], D[sd_lo], side_rows[sd_lo], lo, hi, eshape)
                    cross(Cq["out_out"], D[sd_hi], side_rows[sd_hi], hi, lo, eshape)
                return yg.reshape(B, Ke, N) * pm3
        else:
            A1 = A_loc[None]

            def couple(yf, xf, Cq, fl, fr, kl, kr):
                """Interface quadruple of one family, gated by both
                endpoints in the patch; fl/fr [E, s, nb] flat rows of the
                lower and upper subdomain's facing sides."""
                if kl.numel() == 0:
                    return
                gate = (pmask[:, kl] * pmask[:, kr])[:, :, None, None]     # [B, E, 1, 1]
                xl, xr = xf[:, fl], xf[:, fr]                              # [B, E, s, nb]
                e = "efij,befj->befi"
                upd_l = torch.einsum(e, Cq["in_in"], xl) + torch.einsum(e, Cq["in_out"], xr)
                upd_r = torch.einsum(e, Cq["out_in"], xl) + torch.einsum(e, Cq["out_out"], xr)
                yf.index_add_(1, fl.reshape(-1), (gate * upd_l).reshape(B, -1))
                yf.index_add_(1, fr.reshape(-1), (gate * upd_r).reshape(B, -1))

            def apply_rows(x):                         # x [B, Ke, N], contiguous
                y = block_matvec(A1, x)
                for i, sd in enumerate(self.sides):
                    rows = side_rows[sd]
                    xs = x[..., rows].reshape(B, Ke, -1, nb)
                    upd = torch.einsum("kfij,bkfj->bkfi", D[sd], xs)
                    y[..., rows] += dir_mask[:, :, i, None] * upd.reshape(B, Ke, rows.numel())
                yf, xf = y.view(B, -1), x.reshape(B, -1)
                for Cq, _hi, _lo, kl, kr, fl in fams:
                    couple(yf, xf, Cq, *flat[fl], kl, kr)
                return y * pm3

        pm_b = pmask_full[:, k0:k1]                                 # [B, Kb]
        if mesh is None:
            apply = apply_rows

            def total(*t):
                return t if len(t) > 1 else t[0]
        else:
            from ..parallel.stencil import extend_band

            def apply(x):                              # x [B, Kb, N]: this rank's rows
                return apply_rows(extend_band(mesh, x, row).contiguous())[:, kb]

            def total(*t):
                return tuple(mesh.sum(torch.stack(t)).unbind(0)) if len(t) > 1 else mesh.sum(t[0])

        def dot(u, v_):
            return (u * v_).sum(dim=(1, 2))            # per-batch [B]

        # M(r) -> (z, r . z).  precond_dot returns the fine level's
        # per-subdomain partials r[b,k] . (Minv[k] r[b,k]); the reference
        # masks z with pmask AFTER the product, so the partials are masked
        # the same way here (and the coarse term added) instead of masking
        # r before the launch: r . z then equals dot(r, z) for any r.
        # K-sharded, r . z is this rank's partial (summed with r . r).
        if two_level:
            # additive patch-constant coarse level: the EXACT Galerkin
            # coarse matrix of the masked patch operator, + identity on the
            # masked-out block ([[A_pp, 0], [0, I]] inverts blockwise); it
            # needs the whole K (every rank builds it: [B, K, K])
            fams_k = fams if mesh is None else [
                ({nm: mix(C) for nm, C in self.quads[stem].items()}, hi, lo,
                 idx(getattr(st, pk[0])), idx(getattr(st, pk[1])), fl)
                for stem, hi, lo, pk, fl in self.axes]
            D_k = D if mesh is None else {sd: mix(self.D_side[sd]) for sd in self.sides}
            A0c = torch.einsum("q,qkl->kl", theta, self.A0c_q)
            Ac = (patch_coarse_matrix(A0c, pmask_full,
                                      [(Cq, D_k[hi], D_k[lo], kl, kr)
                                       for Cq, hi, lo, kl, kr, _f in fams_k])
                  + torch.diag_embed(1.0 - pmask_full))
            cinv = torch.linalg.inv(Ac)[:, k0:k1]                       # [B, Kb, K]

            def M(r):
                fine, rz_k = precond_dot(Minv, r)
                rs = r.sum(dim=2)
                if mesh is None:
                    rs_k = rs
                else:
                    rs_k = rs.new_zeros((B, K))
                    rs_k[:, k0:k1] = rs
                    rs_k = mesh.sum(rs_k)
                y = torch.einsum("bkl,bl->bk", cinv, rs_k)
                return ((fine + y[:, :, None]) * pm_b[:, :, None],
                        ((rz_k + y * rs) * pm_b).sum(dim=1))
        else:
            def M(r):
                fine, rz_k = precond_dot(Minv, r)
                return fine * pm_b[:, :, None], (rz_k * pm_b).sum(dim=1)

        b = (rhs_full[None, k0:k1] * pm_b[:, :, None]).contiguous()
        x = torch.zeros_like(b)
        r = b.clone()                                  # b - apply(0)
        with T.span("precond.apply"):
            z, rz = M(r)
        rz, rr = total(rz, dot(r, r))
        p = z
        bb = torch.clamp(total(dot(b, b)), min=1e-300)
        atol2 = (tol ** 2) * bb
        act = torch.ones((B,), dtype=torch.bool, device=dev)
        it = torch.zeros((), dtype=torch.int64, device=dev)

        def go(rr, act, it):
            return torch.any(act & (rr > atol2)) & (it < maxiter)

        # truncated CG with a negative-curvature FREEZE: at extreme
        # intra-cell coefficient contrast the one-sided-penalty patch system
        # can be (marginally) INDEFINITE — a lane that meets p^T A p <= 0
        # keeps its current iterate.  The maxiter cap is the practical
        # regularizer in that regime: uncapped CG grows unbounded junk
        # along near-null directions while the 2-norm residual oscillates —
        # keep maxiter at the default O(300) for enrichment corrections.
        # The host reads ``go`` once per chunk; inside a chunk every body
        # evaluation is guarded by it on the device, which keeps ``it`` and
        # fully converged states bitwise frozen.  K-sharded, every value it
        # reads is summed over the ranks: all ranks stop together.
        def body(x, r, p, rz, rr, act, it):
            run = go(rr, act, it)
            with T.span("operator.apply"):
                Ap = apply(p.contiguous())
            pAp = total(dot(p, Ap))
            act_n = act & (pAp > 0)
            step = act_n.to(x.dtype)
            alpha = step * rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))
            x_n = x + alpha[:, None, None] * p
            r_n = r - alpha[:, None, None] * Ap
            with T.span("precond.apply"):
                z_n, rz_new = M(r_n)
            rz_new, rr_n = total(rz_new, dot(r_n, r_n))
            rz_n = torch.where(act_n, rz_new, rz)
            # rz <= 0 (indefinite preconditioner at extreme contrast):
            # restart with p = z instead of scaling by a meaningless
            # quotient
            beta = torch.where(rz > 0,
                               step * rz_n / torch.where(rz > 0, rz, torch.ones_like(rz)),
                               torch.zeros_like(rz))
            p_n = z_n * step[:, None, None] + beta[:, None, None] * p
            return (tuple(torch.where(run, n, o) for n, o in
                          ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz), (rr_n, rr), (act_n, act)))
                    + (it + run.to(it.dtype),))

        # On a card (unsharded) one body evaluation is a CUDA graph: its
        # ~200 small launches go out in one replay, so the card and not the
        # host's dispatch paces the solve.  The replay runs the same kernels
        # on the same operands as the eager body.
        state = (x, r, p, rz, rr, act, it)
        if dev.type == "cuda" and mesh is None:
            state, body = self._graph(body, state)
        # The stop is confirmed on the true residual b - A x, from which
        # CG's recurrence r can drift at high contrast: while a running
        # lane's true residual is over the tolerance and iterations are
        # left, CG restarts from the iterates (p = z of the true residual).
        # A frozen lane keeps its iterate; ``last_residual`` shows it.
        chunk = default_chunk(dev)
        while True:
            while bool(go(*state[4:])):
                for _ in range(chunk):
                    state = body(*state)
            x, _r, _p, _rz, _rr, act, it = state
            with T.span("operator.apply"):
                r = b - apply(x)
            rr = total(dot(r, r))
            if not bool(go(rr, act, it)):
                break
            with T.span("precond.apply"):
                z, rz = M(r)
            state = (x, r, z, total(rz), rr, act, it)
        self.last_iters = int(it)
        self.last_residual = torch.sqrt(rr / bb)
        T.count("corrector.iters", self.last_iters)
        # each patch's own subdomain
        if mesh is None:
            return x[torch.arange(B, device=dev), marked, :]       # [B, N]
        mine = (marked >= k0) & (marked < k1)
        W = torch.zeros((B, N), dtype=x.dtype, device=dev)
        W[mine] = x[torch.arange(B, device=dev)[mine], marked[mine] - k0, :]
        return mesh.sum(W)

    def solve(self, marked, mu=None, current_solution=None, mode="residual",
              tol: float = 1e-10, maxiter: int = 300, rhs_full=None,
              two_level: bool = True, mesh=None):
        """marked: list[int] -> corrections [n_marked, N], row i for the
        i-th smallest marked subdomain.  Each patch solve stops when its
        true residual ||b - A x|| (not CG's recurrence, which can drift
        from it at high contrast) is within ``tol`` of ||b||, or at ``maxiter``
        iterations; ``last_iters`` and ``last_residual`` hold what it
        reached.  Each solve adds its PCG iterations to the
        ``corrector.iters`` counter of ``GLOBAL_TIMINGS``; the patch applies
        and preconditioner applies are ``operator.apply`` and
        ``precond.apply`` spans, as in ``la.krylov.pcg_chunked``.

        With ``mesh`` (a SubdomainMesh; default ``self.mesh``) the union
        patch solve runs K-banded over its ranks: each rank holds its rows
        of the masked PCG iterate, applies the patch operator on band +
        halo rows (one exchange per matvec: the block apply and the strip
        couplings, or the banded stencil), preconditions on its band
        (``precond_dot``) and sums every dot product and the coarse
        residual over the ranks.  The small pieces (the rhs, the patch
        masks, the [B, K, K] coarse inverse) are replicated.  Every rank
        returns the same corrections.

        ``rhs_full`` [K, N], when given, overrides the built-in rhs modes:
        the patch solve then corrects against a caller-supplied residual.

        The batch has exactly one lane per marked patch: no padding (eager
        torch has no compiled shapes to reuse, and every padded lane would
        run the whole masked PCG)."""
        d = self.d
        mu = d.parse_parameter(mu)
        theta = d.theta(mu).to(self.dtype)
        if rhs_full is not None:
            rhs_full = torch.as_tensor(rhs_full, device=d.device)
        elif mode == "residual" and current_solution is not None:
            cur = torch.as_tensor(current_solution, device=d.device).to(d.op.A_diag.dtype)
            rhs_full = d.rhs(mu) - d.assemble(mu).apply(cur)
        else:
            rhs_full = d.rhs(mu)
        marked = sorted(marked)
        n_marked = len(marked)
        if n_marked == 0:
            return torch.zeros((0, d.space.N), dtype=self.dtype, device=d.device)
        marked_t = torch.as_tensor(marked, device=d.device)
        mesh = mesh if mesh is not None else self.mesh
        return self._solve(theta, marked_t, rhs_full.to(self.dtype), tol, maxiter, two_level,
                           mesh=mesh)
