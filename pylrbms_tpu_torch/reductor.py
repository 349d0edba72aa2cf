"""LRBMS reductors: local reduced bases + blockwise Galerkin projection.

The port of the stationary 2D part of ``pylrbms_tpu/reductor.py``:

* local bases live per subdomain as float64 numpy rows, orthonormalized
  w.r.t. the local energy DG product by a host Gram-Schmidt (kept as in the
  reference, so both packages' bases agree to rounding);
* ``reduce()`` projects the affine block operator/rhs blockwise
  (A_hat_ij = V_i^T A_ij V_j) and precomputes the projected estimator
  tensors, so the online estimate is N-independent; all of it runs on the
  model's device in float64;
* re-reductions are incremental: the neighborhood-gathered Oswald/flux
  images of the basis columns are cached and only new columns are pushed
  through the operators (lean projections, i.e. without the
  algebraic-residual Gramians);
* ``enrich_local(subdomain, U, mu)`` solves the oversampled corrector
  problem and extends the local basis.

What the JAX module does for its compiler is not ported: there are no
per-shape compile caches, no ahead-of-time bucket prefetch and no CPU
hosting of the online step; every backend gate takes its CPU branch (f64
storage, Gramians unless ``force_lean``).  The ``lax.map`` / ``fori_loop``
chunk loops are Python loops over the same chunks, which bound the
``[chunk, K, N]`` temporaries.  ``r_max`` is still rounded up to a multiple
of ``R_BUCKET``: it fixes the padded shapes.

:class:`ParabolicLRBMSReductor` adds the reduced mass and the projected
parabolic estimator tensors (built through an f64 inverse of the L2
blocks); its :class:`ReducedParabolicModel` runs implicit Euler on the
reduced system and the N-independent parabolic estimate.  The 3D hex
family adds the z coupling family and 27-subdomain patches.

With a :class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh` (``mesh=``
to the reductor or to ``reduce``) the projection runs K-sharded: each rank
projects its band of subdomains (the coupling strips read the neighbors'
basis from the replicated host bases), the Gramians are summed over the
ranks and every rank receives the whole, replicated :class:`ReducedModel`
(all_gather).  ``ReducedModel.solve_sharded`` is the block-row-sharded
reduced PCG.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .estimators import K_AXIS, aggregate_eta
from .la.block import AssembledBlockOp
from .la.krylov import pcg_chunked
from .ops.hopper_kernels import block_matvec, precond_dot
from .model import StationaryBlockModel
from .parameters import evaluate_coefficients

WIDE = torch.float64


def _copy_cache(cache):
    """A copy of an image cache (``LRBMSReductor._images``) whose stacks
    may change without touching the original's; None stays None."""
    if cache is None:
        return None
    return {**cache, "sizes": cache["sizes"].copy(), "Wk": cache["Wk"].clone(),
            "Tk": cache["Tk"].clone()}


class ExtensionError(Exception):
    """Basis extension added nothing new (<-> pymor.core.exceptions.ExtensionError)."""


def gram_schmidt(new: np.ndarray, existing: np.ndarray, P: np.ndarray,
                 rtol: float = 1e-10):
    """Orthonormalize rows of `new` [m, N] against `existing` [r, N] w.r.t.
    the spd product P [N, N]; returns accepted rows (orthonormal)."""
    accepted = []
    basis = [v for v in existing]
    for v in new:
        v = np.asarray(v, dtype=np.float64).copy()
        norm0 = np.sqrt(max(v @ (P @ v), 0.0))
        if norm0 <= 0.0:
            continue
        for _ in range(2):   # reorthogonalization pass
            for b in basis:
                v -= (b @ (P @ v)) * b
        norm = np.sqrt(max(v @ (P @ v), 0.0))
        if norm > rtol * norm0:
            v /= norm
            basis.append(v)
            accepted.append(v)
    return np.asarray(accepted).reshape(len(accepted), new.shape[1])


def _host(a) -> np.ndarray:
    """Tensor or array -> float64 numpy on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", WIDE).numpy()
    return np.asarray(a, dtype=np.float64)


def _lane_norm(v):
    """2-norm over the subdomain axis of [..., K]."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


@dataclass
class ReducedModel:
    """Dense reduced block model + batched projected estimator.

    Online layout: padded coefficients c [K, r_max]; the reduced system is a
    dense [K*r_max, K*r_max] matrix with identity rows on padding.  Every
    method takes one mu or a lane-batched mu (leaves ``[B, ...]``); with
    lanes the coefficients carry a leading B axis.
    """
    reductor: "LRBMSReductor"
    A_red: torch.Tensor         # [Q, R, R] (R = K*r_max), padded
    b_red: torch.Tensor         # [Qf, R]
    sizes: np.ndarray           # [K] actual local basis sizes
    r_max: int
    # ---- projected estimator tensors (neighborhood-padded, P = 9*r_max;
    # 27*r_max in 3D) ----
    nbhd_idx: np.ndarray        # [K, 9 | 27] neighbor subdomain ids (-1 pad)
    G_nc: torch.Tensor          # [K, P, P]
    AA: torch.Tensor            # [Q, Q, K, r_max, r_max]
    ABT: torch.Tensor           # [Q(lam), Q(flux), K, r_max, P]
    BBT: torch.Tensor           # [Q, Q, K, P, P]
    DV: torch.Tensor            # [Qf, Q, K, P]
    RD: torch.Tensor            # [Q, Q, K, P, P]
    rf_qq: torch.Tensor         # [Qf, Qf, K]
    min_ev: torch.Tensor
    diam: torch.Tensor
    # ---- algebraic-residual Gramians (greedy surrogate; N-independent) ----
    G_bb: torch.Tensor = None   # [Qf, Qf]
    G_Ab: torch.Tensor = None   # [Q, Qf, R]
    G_AA: torch.Tensor = None   # [Q, Q, R, R]
    # ---- projected parabolic estimator tensors (ParabolicLRBMSReductor):
    # G_MAA, G_BLB, G_BLdiv, G_FLF, G_BLF, G_FLdiv ----
    parabolic: Optional[dict] = None

    _ARRAY_FIELDS = ("A_red", "b_red", "G_nc", "AA", "ABT", "BBT", "DV",
                     "RD", "rf_qq", "min_ev", "diam", "G_bb", "G_Ab", "G_AA")

    @property
    def d(self):
        return self.reductor.d

    @property
    def solution_dim(self) -> int:
        return int(self.sizes.sum())

    def parse_parameter(self, mu):
        return self.d.parse_parameter(mu)

    @property
    def parameter_space(self):
        return self.d.parameter_space

    def _thetas(self, mu):
        dev = self.A_red.device
        d = self.d
        return (evaluate_coefficients(d.lambda_coeffs, mu, WIDE, dev),
                evaluate_coefficients(d.f_coeffs, mu, WIDE, dev))

    def solve(self, mu):
        """Dense reduced block solve (<-> ``rd.solve``): c [K, r_max], or
        [B, K, r_max] for a lane-batched mu (one batched LU)."""
        mu = self.parse_parameter(mu)
        theta, theta_f = self._thetas(mu)
        A = torch.einsum("...q,qij->...ij", theta, self.A_red)
        b = torch.einsum("...q,qi->...i", theta_f, self.b_red)
        if A.ndim > b.ndim + 1:                 # lanes in theta only
            b = b.expand(A.shape[:-1])
        elif b.ndim > A.ndim - 1:               # lanes in theta_f only
            A = A.expand(b.shape[:-1] + A.shape[-2:])
        c = torch.linalg.solve(A, b.unsqueeze(-1)).squeeze(-1)
        return c.reshape(c.shape[:-1] + (len(self.sizes), self.r_max))

    def reconstruct(self, c):
        return self.reductor.reconstruct(c)

    def solve_sharded(self, mu, mesh, tol: float = 1e-12, maxiter: int = 2000):
        """Block-row-sharded reduced solve (<-> ``solve_sharded``, the TP
        analog): each rank of ``mesh`` owns its band's block rows of
        A_red(theta) and solves by block-Jacobi PCG on the SPD,
        identity-padded reduced system: the matvec all-gathers the iterate,
        the [r_max, r_max] diagonal-block inverses precondition through
        ``precond_dot`` (the band's ``r . z`` partials summed and
        all-reduced with ``r . r``), ``p . Ap`` is all-reduced.  Returns the
        replicated c [K, r_max] (one mu); equals :meth:`solve` to solver
        tolerance."""
        mu = self.parse_parameter(mu)
        theta, theta_f = self._thetas(mu)
        K, r = len(self.sizes), self.r_max
        k0, k1 = mesh.band(K)
        Kb, dev = k1 - k0, mesh.device
        rows = slice(k0 * r, k1 * r)
        A = torch.einsum("q,qij->ij", theta, self.A_red[:, rows]).to(dev)    # [Kb r, K r]
        b = torch.einsum("q,qi->i", theta_f, self.b_red[:, rows]).to(dev).reshape(Kb, r)
        kb = torch.arange(Kb, device=dev)
        D = A.reshape(Kb, r, K, r)[kb, :, k0 + kb, :]                      # [Kb, r, r]
        Dinv = torch.linalg.inv(D).contiguous()

        def mv(c):
            return (A @ mesh.gather(c, mesh.shard_k(0)).reshape(-1)).reshape(Kb, r)

        def M(rv):
            z, rz = precond_dot(Dinv, rv[None].contiguous())
            return z[0], rz.sum()

        c, it = pcg_chunked(mv, M, b, tol, maxiter, comm=mesh)
        self.last_sharded_iters = int(it)
        return mesh.gather(c, mesh.shard_k(0))

    def _gather_neighborhood(self, c):
        """c [..., K, r_max] -> chat [..., K, P*r_max] (zero-padded; P = 9,
        27 in 3D)."""
        dev = c.device
        idx = torch.as_tensor(np.where(self.nbhd_idx < 0, 0, self.nbhd_idx), device=dev)
        mask = torch.as_tensor(self.nbhd_idx >= 0, device=dev).to(c.dtype)
        g = c[..., idx, :] * mask[..., :, None]        # [..., K, P, r_max]
        return g.reshape(g.shape[:-2] + (self.nbhd_idx.shape[1] * self.r_max,))

    def residual_norm(self, c, mu):
        """l2 dual norm of the algebraic FOM residual ||b(mu) - A(mu) V c||_2,
        assembled from the projected Gramians: the greedy error surrogate
        (goes to 0 as the ROM approaches the FOM, unlike the LRBMS
        total-error estimator, which is floored by the discretization
        error).  The three terms nearly cancel as the ROM converges, so they
        are contracted in float64 whatever the model dtype."""
        theta, theta_f = self._thetas(self.parse_parameter(mu))
        cf = c.reshape(c.shape[:-2] + (-1,)).to(WIDE)
        bb = torch.einsum("...p,...r,pr->...", theta_f, theta_f, self.G_bb.to(WIDE))
        Ab = torch.einsum("...q,...f,qfi,...i->...", theta, theta_f,
                          self.G_Ab.to(WIDE), cf)
        AA = torch.einsum("...p,...r,prij,...i,...j->...", theta, theta,
                          self.G_AA.to(WIDE), cf, cf)
        return torch.sqrt(torch.clamp(bb - 2.0 * Ab + AA, min=0.0))

    def local_quantities(self, c, mu):
        """Reduced localized squared quantities; c [..., K, r_max] -> [..., K].

        Algebraically identical to the FOM estimator applied to the
        reconstruction (exact Galerkin projection), at N-independent cost.
        With a lane-batched mu the leading axis of c is the lane axis."""
        theta, theta_f = self._thetas(mu)
        ch = self._gather_neighborhood(c)              # [..., K, P]

        eta_nc = torch.einsum("...kp,kpr,...kr->...k", ch, self.G_nc, ch)

        rf = torch.einsum("...p,...r,prk->...k", theta_f, theta_f, self.rf_qq)
        r_fd = torch.einsum("...f,...q,fqkp,...kp->...k", theta_f, theta, self.DV, ch)
        r_dd = torch.einsum("...p,...r,prkuv,...ku,...kv->...k", theta, theta, self.RD, ch, ch)
        scale = (1.0 / (np.pi ** 2) / self.min_ev) * self.diam ** 2
        eta_r = (rf - 2.0 * r_fd + r_dd) * scale

        aa = torch.einsum("...p,...r,prkuv,...ku,...kv->...k", theta, theta, self.AA, c, c)
        bb = torch.einsum("...p,...r,prkuv,...ku,...kv->...k", theta, theta, self.BBT, ch, ch)
        ab = torch.einsum("...p,...r,prkuv,...ku,...kv->...k", theta, theta, self.ABT, c, ch)
        return eta_nc, eta_r, aa + bb + 2.0 * ab

    def estimate(self, c, mu, decompose: bool = False,
                 paper_convention: bool = False):
        """Reduced estimate of c [K, r_max] (or a stack [B, K, r_max]) at ONE
        mu, with the FOM estimator's aggregation."""
        mu = self.parse_parameter(mu)
        cb = c[None] if c.ndim == 2 else c
        eta_nc, eta_r, eta_df = self.local_quantities(cb, mu)
        return aggregate_eta(self.d.estimator, mu, eta_nc, eta_r, eta_df, decompose,
                             paper_convention=paper_convention)

    def estimate_lanes(self, c, mu):
        """Per-lane estimates for a lane-batched mu: c [B, K, r_max] ->
        (eta [B], indicators [B, K]); lane b equals ``estimate(c[b],
        mu[b], decompose=True)``."""
        mu = self.parse_parameter(mu)
        est = self.d.estimator
        ed = est.data
        dev = c.device
        eta_nc, eta_r, eta_df = self.local_quantities(c, mu)

        def ratios(mu_ref):
            th = evaluate_coefficients(ed.lambda_coeffs, mu, WIDE, dev)
            return th / evaluate_coefficients(ed.lambda_coeffs, mu_ref, WIDE, dev)

        r_bar, r_hat = ratios(ed.mu_bar), ratios(ed.mu_hat)
        first = est.alpha_first_component_only
        a_bar = r_bar[..., 0] if first else r_bar.min(dim=-1).values
        a_hat = r_hat[..., 0] if first else r_hat.min(dim=-1).values
        g_bar = r_bar.max(dim=-1).values
        eta = (torch.sqrt(g_bar) * _lane_norm(eta_nc)
               + (1.0 / torch.sqrt(a_hat)) * _lane_norm(eta_r + eta_df)) / torch.sqrt(a_bar)
        ind = (2.0 / a_bar)[..., None] * (g_bar[..., None] * eta_nc ** 2
                                          + (1.0 / a_hat)[..., None] * (eta_r + eta_df) ** 2)
        return eta, ind

    def online_step(self, mu):
        """One ROM online step ``mu -> (c, eta, indicators)``: the reduced
        solve and the localized estimate.  One mu gives c [K, r_max], a
        scalar eta and indicators [K, 1]; a lane-batched mu (leaves
        ``[B, ...]``) gives c [B, K, r_max], eta [B], indicators [B, K]."""
        mu = self.parse_parameter(mu)
        c = self.solve(mu)
        if c.ndim == 3:
            return (c,) + self.estimate_lanes(c, mu)
        eta, _, indicators = self.estimate(c, mu, decompose=True)
        return c, eta, indicators


class LRBMSReductor:
    """<-> ``reductor.LRBMSReductor``."""

    # r_max is bucketed (rounded up to a multiple of 4): the padded shapes
    # of the reduced tensors only change at bucket boundaries
    R_BUCKET = 4
    # Device-batched Gram-Schmidt, one snapshot row at a time: off by
    # default like the reference's (equivalent, tested)
    batched_gs = False
    # colored image computation is exact (disjoint supports): the flag
    # exists so tests can compare against the row-chunked path
    use_colored_images = True
    # test hooks: chunk width of the row-chunked paths; skip the Gramians;
    # never reuse the image cache
    force_chunk = None
    force_lean = False
    force_full_projection = False
    # the parabolic reductor adds the projected parabolic estimator tensors
    parabolic_tensors = False
    # most new basis columns one incremental image update takes at once
    UPD_CHUNK = 512

    def __init__(self, d: StationaryBlockModel, bases: Optional[List[np.ndarray]] = None,
                 products=None, order: Optional[int] = None, num_cpus: int = 1,
                 solver_options=None, mesh=None):
        # num_cpus: the reference's pyMOR parameter, accepted and unused there too
        if not (order is None or 0 <= order <= 1):
            raise ValueError(f"order must be None, 0 or 1, got {order}")
        self.d = d
        self.solver_options = solver_options
        # default SubdomainMesh of reduce(): the greedy and enrichment
        # re-reductions then run K-sharded
        self.mesh = mesh
        K, N = d.space.K, d.space.N
        if products is None:
            products = d.products.get("energy_mu_bar", d.products["l2"])
        self.products = _host(products)                          # [K, N, N]
        self.bases: List[np.ndarray] = (
            [np.asarray(_host(b)).reshape(-1, N) for b in bases] if bases is not None
            else [np.zeros((0, N))] * K)
        if order is None and bases is None:
            order = 0
        if order is not None:
            for ii in range(K):
                self.extend_basis_local(ii, d.shape_functions(ii, order))
        self._img_cache = None

    # ------------------------------------------------------------------
    def extend_basis_local(self, subdomain: int, vectors) -> int:
        """Gram-Schmidt extend the local basis w.r.t. the local energy
        product.  Raises ExtensionError if nothing new."""
        vecs = np.atleast_2d(_host(vectors))
        added = gram_schmidt(vecs, self.bases[subdomain], self.products[subdomain])
        if added.shape[0] == 0:
            raise ExtensionError(f"no new basis vectors on subdomain {subdomain}")
        self.bases[subdomain] = np.vstack([self.bases[subdomain], added])
        return added.shape[0]

    def extend_basis(self, U) -> int:
        """Blockwise extension with global snapshots [.., K, N] (rows in
        order; an all-zero local row adds nothing).  With ``batched_gs``
        each row is one device-batched extension of all subdomains."""
        U = _host(U)
        if U.ndim == 2:
            U = U[None]
        if self.batched_gs:
            total = 0
            for u in U:
                try:
                    total += self._extend_basis_batched(u)
                except ExtensionError:
                    pass
            if total == 0:
                raise ExtensionError("no new basis vectors on any subdomain")
            return total
        total = 0
        for ii in range(self.d.space.K):
            try:
                total += self.extend_basis_local(ii, U[:, ii, :])
            except ExtensionError:
                pass
        if total == 0:
            raise ExtensionError("no new basis vectors on any subdomain")
        return total

    def _extend_basis_batched(self, u: np.ndarray, rtol: float = 1e-10) -> int:
        """Device-batched Gram-Schmidt for the greedy shape (ONE new column
        per subdomain): all K projections against the local bases run as
        three batched einsums instead of a K-long host loop.  The existing
        bases are P-orthonormal, so the classical (sum) projection equals
        the host loop's sequential projection in exact arithmetic; the same
        two re-orthogonalization passes bound the roundoff.  Acceptance as
        in :func:`gram_schmidt`."""
        dev = self.d.device
        sizes = self.basis_sizes()
        r_max = max(1, int(sizes.max()))
        V = torch.as_tensor(self._padded_bases(r_max), device=dev)
        mask = torch.as_tensor(np.arange(r_max)[None, :] < sizes[:, None], device=dev).to(WIDE)
        P = self._products_device()
        uu = torch.as_tensor(u, dtype=WIDE, device=dev)

        def pnorm(v):
            return torch.sqrt(torch.clamp(torch.einsum("kn,knm,km->k", v, P, v), min=0.0))

        norm0 = pnorm(uu)
        v = uu
        for _ in range(2):   # re-orthogonalization pass
            Pv = torch.einsum("knm,km->kn", P, v)
            coef = torch.einsum("krn,kn->kr", V, Pv) * mask
            v = v - torch.einsum("kr,krn->kn", coef, V)
        norm = pnorm(v)
        accept = ((norm > rtol * norm0) & (norm0 > 0.0)).cpu().numpy()
        w = _host(v / torch.where(norm > 0.0, norm, torch.ones_like(norm))[:, None])
        total = 0
        for k in np.where(accept)[0]:
            self.bases[k] = np.vstack([self.bases[k], w[k]])
            total += 1
        if total == 0:
            raise ExtensionError("no new basis vectors on any subdomain")
        return total

    def state(self) -> tuple:
        """(bases, image cache) as they stand, for :meth:`restore`.  The
        bases are append-only host arrays (the list is copied, the arrays
        shared); the cache's stacks grow in place in the incremental
        re-reduction, so they are copied."""
        return list(self.bases), _copy_cache(self._img_cache)

    def restore(self, state: tuple) -> None:
        """Put back a :meth:`state` (copies of it: it stays as it was)."""
        bases, cache = state
        self.bases = list(bases)
        self._img_cache = _copy_cache(cache)

    def _products_device(self):
        """The local products as a float64 tensor on the model's device."""
        if getattr(self, "_products_dev", None) is None:
            self._products_dev = torch.as_tensor(self.products, device=self.d.device)
        return self._products_dev

    def basis_sizes(self) -> np.ndarray:
        return np.array([b.shape[0] for b in self.bases])

    def reconstruct(self, c) -> torch.Tensor:
        """Padded reduced coefficients [.., K, r_max] -> [.., K, N] (float64,
        on the model's device)."""
        c = torch.as_tensor(c, device=self.d.device).to(WIDE)
        V = torch.as_tensor(self._padded_bases(c.shape[-1]), device=self.d.device)
        return torch.einsum("...kr,krn->...kn", c, V)

    def reconstruct_local(self, c, subdomain: int) -> torch.Tensor:
        c = torch.as_tensor(c, device=self.d.device).to(WIDE)
        V = torch.as_tensor(self.bases[subdomain], device=self.d.device)
        return torch.einsum("...r,rn->...n", c[..., subdomain, :V.shape[0]], V)

    def _padded_bases(self, r_max: int) -> np.ndarray:
        K, N = self.d.space.K, self.d.space.N
        V = np.zeros((K, r_max, N))
        for ii, b in enumerate(self.bases):
            V[ii, :b.shape[0]] = b
        return V

    # ------------------------------------------------------------------
    def enrich_local(self, subdomain: int, U=None, mu=None, mode: str = "residual",
                     current_solution=None):
        """Corrector solve + local extension.

        ``U`` is the current *reduced* solution (padded coefficients); in
        residual mode it is reconstructed to drive the residual corrector.
        Pass ``current_solution`` ([K, N]) directly when the bases may have
        grown since ``U`` was computed (mid-enrichment-round).
        Returns the number of added vectors (0 if extension failed)."""
        current = current_solution
        if current is None and U is not None and mode == "residual":
            current = self.reconstruct(U)
        w = self.d.solve_for_local_correction(subdomain, None, mu,
                                              inverse_options=self.solver_options,
                                              current_solution=current, mode=mode)
        try:
            return self.extend_basis_local(subdomain, w)
        except ExtensionError:
            return 0

    # ------------------------------------------------------------------
    @staticmethod
    def _project(op_arrays, rhs_q, V, mask, static, band=None):
        """V [K, r_max, N] padded bases (rows masked) -> (A_red, b_red);
        ``op_arrays`` = (A_diag, the coupling stacks in ``static.families()``
        order).  With ``band`` = (k0, k1) only the block rows of subdomains
        [k0, k1) ([Q, (k1-k0) r_max, K r_max] and [Qf, (k1-k0) r_max]);
        the couplings into the band read the neighbors' columns of V."""
        A_diag = op_arrays[0]
        side_rows = static.side_rows
        K, r_max, N = V.shape
        k0, k1 = band if band is not None else (0, K)
        Q = A_diag.shape[0]
        R, Rb = K * r_max, (k1 - k0) * r_max
        dev = V.device
        ar = torch.arange(r_max, device=dev)

        def rows_of(k):
            return torch.as_tensor(k, device=dev)[:, None] * r_max + ar[None, :]

        diag = torch.einsum("kan,qknm,kbm->qkab", V[k0:k1], A_diag[:, k0:k1], V[k0:k1])
        A_red = torch.zeros((Q, Rb, R), dtype=V.dtype, device=dev)
        blk_r = rows_of(np.arange(k0, k1))
        # the index pairs of one statement are distinct (one block per
        # subdomain, one per edge), so += needs no accumulate
        A_red[:, blk_r[:, :, None] - k0 * r_max, blk_r[:, None, :]] += diag

        def couple(C, k_out, k_in, rows_out, rows_in):
            sel = np.nonzero((k_out >= k0) & (k_out < k1))[0]
            if sel.size == 0:
                return
            k_out, k_in = k_out[sel], k_in[sel]
            C = C[:, torch.as_tensor(sel, device=C.device)]
            s, nb = C.shape[2], C.shape[3]
            ro_f = torch.as_tensor(rows_out.reshape(-1), device=dev)
            ri_f = torch.as_tensor(rows_in.reshape(-1), device=dev)
            Vo = V[torch.as_tensor(k_out, device=dev)][:, :, ro_f].reshape(-1, r_max, s, nb)
            Vi = V[torch.as_tensor(k_in, device=dev)][:, :, ri_f].reshape(-1, r_max, s, nb)
            blk = torch.einsum("eafi,qefij,ebfj->qeab", Vo, C, Vi)
            ro, ri = rows_of(k_out) - k0 * r_max, rows_of(k_in)
            A_red[:, ro[:, :, None], ri[:, None, :]] += blk

        for C, (_name, ro, ri, k_out, k_in) in zip(op_arrays[1:], static.families()):
            couple(C, k_out, k_in, side_rows[ro], side_rows[ri])

        # identity on padded rows keeps the dense solve well-posed
        flat_mask = mask.reshape(R)          # 1 = real dof, 0 = padding
        band_mask = flat_mask[k0 * r_max:k1 * r_max]
        A_red = A_red * band_mask[None, :, None] * flat_mask[None, None, :]
        ib = torch.arange(Rb, device=dev)
        A_red[0, ib, k0 * r_max + ib] += 1.0 - band_mask

        b_red = torch.einsum("qkn,krn->qkr", rhs_q[:, k0:k1], V[k0:k1]).reshape(-1, Rb)
        return A_red, b_red * band_mask[None, :]

    @staticmethod
    def _column_chunk(V, c0: int, ch: int):
        """Rows [c0, c0+ch) of the VIRTUAL column stack B[k*r_max+j] =
        e_k (x) V[k, j] as a [n, K, N] tensor (n <= ch at the end), built on
        the fly: the full [R, K, N] stack is never materialized."""
        K, r_max, N = V.shape
        r_idx = torch.arange(c0, min(c0 + ch, K * r_max), device=V.device)
        k_idx = r_idx // r_max
        B = torch.zeros((r_idx.numel(), K, N), dtype=V.dtype, device=V.device)
        B[torch.arange(r_idx.numel(), device=V.device), k_idx] = V[k_idx, r_idx % r_max]
        return B

    @staticmethod
    def _patch_rows(oswald, flux, lam_funcs, V, rows_safe, valid_f, store, ch: int):
        """Memory-lean Wk/Tk: neighborhood-gathered Oswald errors and flux
        reconstructions of ALL basis rows WITHOUT materializing the
        [R, K, N] stacked intermediates.  Chunks of ``ch`` basis rows are
        built from V, pushed through the operators, and their contributions
        immediately gathered into the [K, P, (N|Nrt)] neighborhood tensors
        the estimator projections consume; peak extra memory is one
        [ch, K, N] chunk.  Returns (Wk [K, P, N], Tk [Q, K, P, Nrt])."""
        K, r_max, N = V.shape
        R_all = K * r_max
        P = rows_safe.shape[1]
        Nrt = flux.rt_l2g.shape[-1]
        Q = len(lam_funcs)
        kk = torch.arange(K, device=V.device)[:, None]
        Wk = torch.zeros((K, P, N), dtype=store, device=V.device)
        Tk = torch.zeros((Q, K, P, Nrt), dtype=store, device=V.device)
        for c0 in range(0, R_all, ch):
            B_chunk = LRBMSReductor._column_chunk(V, c0, ch)
            n = B_chunk.shape[0]
            in_chunk = (rows_safe >= c0) & (rows_safe < c0 + n) & (valid_f > 0)   # [K, P]
            loc = torch.clamp(rows_safe - c0, 0, n - 1)
            sel = in_chunk[:, :, None].to(store)
            Wk += oswald.apply(B_chunk).to(store)[loc, kk, :] * sel
            for q, lf in enumerate(lam_funcs):
                Tk[q] += flux.apply(lf, B_chunk).to(store)[loc, kk, :] * sel
        return Wk, Tk

    @staticmethod
    def _est_projections(ed_arrays, Vm, Wk, Tk):
        """The six projected estimator tensors.

        Contracted in the WIDE dtype whatever the storage of the matrix
        tensors: eta_r (rf - 2 r_fd + r_dd) and eta_df (aa + bb + 2 ab) are
        cancellation formulas, and a float32 contraction floors them orders
        of magnitude higher.  Rounding of the stored entries largely
        cancels between the r_fd/r_dd (ab/aa) terms because both derive
        from the same rounded data; independent accumulation noise does
        not."""
        E_bar, BB, M_aa, M_ab, d_vec, R_dd = (a.to(WIDE) for a in ed_arrays)
        G_nc = torch.einsum("kpn,knm,kqm->kpq", Wk, E_bar, Wk)
        BBT = torch.einsum("pkur,krs,qkvs->pqkuv", Tk, BB, Tk)
        RD = torch.einsum("pkur,krs,qkvs->pqkuv", Tk, R_dd, Tk)
        AA = torch.einsum("prknm,kan,kbm->prkab", M_aa, Vm, Vm)
        ABT = torch.einsum("kan,pknr,qkur->pqkau", Vm, M_ab, Tk)
        DV = torch.einsum("fkr,qkur->fqku", d_vec, Tk)
        return dict(G_nc=G_nc, AA=AA, ABT=ABT, BBT=BBT, DV=DV, RD=RD)

    @staticmethod
    def _subdomain_colors(grid):
        """3-periodic subdomain coloring: same-color subdomains are >= 3
        apart per axis, so their 3x3(x3) oversampling neighborhoods — and hence
        the supports of Oswald/flux images of columns living on them (both
        operators are one-element-layer local) — are DISJOINT.  Images of
        all same-color columns can then be computed in ONE batch element
        without contaminating each other's neighborhood slots.  Returns
        (color[k] in [0, n_colors), n_colors) with colors compacted to the
        ones actually used (small grids use fewer than 9/27).  ``None`` if the
        grid exposes no structured subdomain lattice."""
        K = grid.num_subdomains
        if getattr(grid, "dim", 2) == 3:
            coords = np.array([grid.subdomain_coords(k) for k in range(K)])
            raw = coords[:, 0] % 3 + 3 * (coords[:, 1] % 3) + 9 * (coords[:, 2] % 3)
        else:
            if not (hasattr(grid, "kx") and hasattr(grid, "ky")):
                return None
            sx = np.arange(K) % grid.kx
            sy = np.arange(K) // grid.kx
            raw = sx % 3 + 3 * (sy % 3)
        uniq, color = np.unique(raw, return_inverse=True)
        return color.astype(np.int64), int(len(uniq))

    @staticmethod
    def _colored_rows(oswald, flux, lam_funcs, V, rows_safe, valid_f, store,
                      color_k, n_colors: int):
        """Memory-lean Wk/Tk via neighborhood-disjoint COLOR batching:
        instead of one batch element per basis column (K*r_max global
        [K, N] vectors pushed through Oswald/flux, each almost all zeros),
        one batch element holds ALL same-color subdomains' columns of one
        slot j.  Their images have disjoint supports (see
        :meth:`_subdomain_colors`), so each neighborhood slot reads its own
        column's image uncontaminated: n_colors * r_max applies replace
        K * r_max.  Returns (Wk [K, P, N], Tk [Q, K, P, Nrt]); exact-equal
        to :meth:`_patch_rows` (adding structural zeros is exact)."""
        K, r_max, N = V.shape
        dev = V.device
        P = rows_safe.shape[1]
        Nrt = flux.rt_l2g.shape[-1]
        Q = len(lam_funcs)
        kk = torch.arange(K, device=dev)[:, None]
        color_t = torch.as_tensor(color_k, device=dev)
        onehot = (color_t[None, :] == torch.arange(n_colors, device=dev)[:, None]).to(V.dtype)
        jj = rows_safe % r_max
        c_src = color_t[rows_safe // r_max]                          # [K, P]
        # j-slab chunking bounds the [C*jc, K, N] batch
        jc = max(1, min(r_max, 64 // n_colors))
        Wk = torch.zeros((K, P, N), dtype=store, device=dev)
        Tk = torch.zeros((Q, K, P, Nrt), dtype=store, device=dev)
        for j0 in range(0, r_max, jc):
            Vs = V[:, j0:j0 + jc, :]                                 # [K, n, N]
            n = Vs.shape[1]
            B = (onehot[:, None, :, None] * Vs.transpose(0, 1)[None]).reshape(n_colors * n, K, N)
            in_sl = (jj >= j0) & (jj < j0 + n) & (valid_f > 0)       # [K, P]
            loc = c_src * n + torch.clamp(jj - j0, 0, n - 1)
            sel = in_sl[:, :, None].to(store)
            Wk += oswald.apply(B).to(store)[loc, kk, :] * sel
            for q, lf in enumerate(lam_funcs):
                Tk[q] += flux.apply(lf, B).to(store)[loc, kk, :] * sel
        return Wk, Tk

    def _image_update(self, V, new_ids, Wk, Tk, rows_safe, valid_f, batch_idx, n_batch):
        """Incremental image update: the Oswald/flux images of the NEW basis
        columns ``new_ids`` (ascending global row ids k*r_max + j) are added
        to the cached neighborhood stacks ``Wk``/``Tk`` in place.  With ``n_batch`` > 0
        the applies run COLOR-batched: ``batch_idx`` assigns each new column
        to a (color, per-subdomain rank) batch element with disjoint image
        supports, so the batch shrinks from one global vector per column to
        ``n_batch``."""
        ed = self.d.estimator.data
        K, r_max, N = V.shape
        dev = V.device
        n = new_ids.numel()
        k_idx = new_ids // r_max
        vals = V[k_idx, new_ids % r_max]
        if n_batch:
            B_chunk = torch.zeros((n_batch, K, N), dtype=V.dtype, device=dev)
            B_chunk[batch_idx, k_idx] = vals
        else:
            B_chunk = torch.zeros((n, K, N), dtype=V.dtype, device=dev)
            B_chunk[torch.arange(n, device=dev), k_idx] = vals
        # slot membership: which (k, p) neighborhood slots hold new ids
        pos = torch.clamp(torch.searchsorted(new_ids, rows_safe), 0, n - 1)   # [K, P]
        hit = (new_ids[pos] == rows_safe) & (valid_f > 0)
        sel = hit[:, :, None].to(Wk.dtype)
        gi = batch_idx[pos] if n_batch else pos
        kk = torch.arange(K, device=dev)[:, None]
        Wk += ed.oswald.apply(B_chunk).to(Wk.dtype)[gi, kk, :] * sel
        for q, lf in enumerate(ed.lambda_funcs):
            Tk[q] += ed.flux.apply(lf, B_chunk).to(Tk.dtype)[gi, kk, :] * sel

    def _operator_images(self, op_arrays, Vm, chV: int):
        """Q x [R, K, N]: every basis column through each affine component's
        block apply, in chunks of ``chV`` columns (the diagonal blocks
        through :func:`~pylrbms_tpu_torch.ops.hopper_kernels.block_matvec`).
        A list, not a stacked [Q, R, K, N] copy."""
        st = self.d.op.static
        K, r_max, _ = Vm.shape
        R_all = K * r_max
        AVs = []
        for q in range(op_arrays[0].shape[0]):
            Aq = AssembledBlockOp(st, op_arrays[0][q], **{
                n: C[q] for n, C in zip(st.names(), op_arrays[1:])})
            AVs.append(torch.cat([Aq.apply(self._column_chunk(Vm, c0, chV))
                                  for c0 in range(0, R_all, chV)]))
        return AVs

    @staticmethod
    def _gram(X, Y, ch: int):
        """[Rx, Ry] Gramian of the [R, K, N] stacks X and Y in row chunks of
        ``ch``: per-subdomain partial dots summed over K."""
        return torch.cat([torch.einsum("ckn,skn->cks", X[c0:c0 + ch], Y).sum(dim=1)
                          for c0 in range(0, X.shape[0], ch)])

    def _gramians(self, AVs, rhs_q, ch: int):
        """The algebraic-residual Gramians G_bb [Qf, Qf], G_Ab [Q, Qf, R],
        G_AA [Q, Q, R, R] from the operator images ``AVs``."""
        G_bb = torch.einsum("pkn,rkn->pr", rhs_q, rhs_q)
        G_Ab = torch.stack([self._gram(AVq, rhs_q, ch).T for AVq in AVs])   # [Q, Qf, R]
        G_AA = torch.stack([torch.stack([self._gram(Ap, Aq, ch) for Aq in AVs])
                            for Ap in AVs])                                 # [Q, Q, R, R]
        return G_bb, G_Ab, G_AA

    def _parabolic(self, AVs, rhs_q, Tk, rows_t, valid_t, ch: int, chV: int, L2=None):
        """The projected parabolic estimator tensors, through an f64
        inverse of the L2 blocks: with B_q = M^-1 A_q V (per column, in
        chunks of ``chV`` through ``block_matvec``) and F_R = M^-1 F,
        G_MAA [Q, Q, R, R] = (A_p V)^T M^-1 (A_q V) (the time residual) and
        the neighborhood-padded G_BLB, G_BLdiv [Q, Q, K, P, P], G_FLF
        [Qf, Qf, K], G_BLF [Q, Qf, K, P], G_FLdiv [Qf, Q, K, P] (the
        elliptic-reconstruction parts of eta_r).  On a band (``L2`` and every
        per-subdomain input cut to it) G_MAA is the band's partial sum."""
        ed = self.d.estimator.data
        L2 = (ed.L2 if L2 is None else L2).to(WIDE)
        A_div = ed.A_div.to(WIDE)
        Linv = torch.linalg.inv(L2)[None].contiguous()                       # [1, K, N, N]
        R_all = AVs[0].shape[0]
        MAVs = [torch.cat([block_matvec(Linv, AVq[c0:c0 + chV].contiguous())
                           for c0 in range(0, R_all, chV)]) for AVq in AVs]  # Q x [R, K, N]
        FR = block_matvec(Linv, rhs_q.contiguous())                          # [Qf, K, N]
        G_MAA = torch.stack([torch.stack([self._gram(MAVp, Aq, ch) for Aq in AVs])
                             for MAVp in MAVs])                              # [Q, Q, R, R]
        kk = torch.arange(L2.shape[0], device=L2.device)[:, None]
        Bk = (torch.stack([MAVq[rows_t, kk, :] for MAVq in MAVs])
              * valid_t[None, :, :, None])                                   # [Q, K, P, N]
        divTk = torch.einsum("nr,qkur->qkun", A_div, Tk)                     # [Q, K, P, N]
        BL = torch.einsum("pkun,knm->pkum", Bk, L2)
        FL = torch.einsum("fkn,knm->fkm", FR, L2)
        return dict(
            G_MAA=G_MAA,
            G_BLB=torch.einsum("pkum,qkvm->pqkuv", BL, Bk),
            G_BLdiv=torch.einsum("pkum,qkvm->pqkuv", BL, divTk),
            G_FLF=torch.einsum("fkm,gkm->fgk", FL, FR),
            G_BLF=torch.einsum("pkum,fkm->pfku", BL, FR),
            G_FLdiv=torch.einsum("fkm,qkum->fqku", FL, divTk))

    @staticmethod
    def _bucket_rows(grid, K: int, r_max: int):
        """Static neighborhood-gather metadata for a bucket width (patch
        size 9 in 2D, 27 on the 3D hex family)."""
        Pn = 27 if getattr(grid, "dim", 2) == 3 else 9
        nbhd_idx = -np.ones((K, Pn), dtype=np.int64)
        for k in range(K):
            nb_list = grid.neighborhood_of(k)
            nbhd_idx[k, :len(nb_list)] = nb_list
        rows = np.where(nbhd_idx[:, :, None] >= 0,
                        nbhd_idx[:, :, None] * r_max + np.arange(r_max)[None, None, :],
                        -1).reshape(K, Pn * r_max)
        valid = (rows >= 0)
        return nbhd_idx, np.where(valid, rows, 0), valid

    def reduce(self, mesh=None) -> ReducedModel:
        """Blockwise Galerkin projection + projected estimator tensors, in
        float64 on the model's device.

        With ``mesh`` (default ``self.mesh``) the projection runs K-sharded
        (<-> ``reduce(mesh=)``): each rank projects its band, the diagonal
        and coupling blocks of its block rows, the estimator projections of
        its subdomains and the operator images (and with them the Gramians
        and the parabolic tensors) on its rows through the banded block
        apply (``parallel.stencil.BandedBlockOp``), whose halo rows it reads
        from the replicated bases.  The neighborhood images of the Oswald
        and flux operators are global operators: every rank computes them
        and keeps its band's rows.  Per-subdomain results are all-gathered,
        Gramians summed over the ranks; the returned model is replicated and
        the incremental image cache is not used.  Without a mesh the band is
        all of K and the collectives are the identity."""
        mesh = mesh if mesh is not None else self.mesh
        d = self.d
        dev = d.device
        K = d.space.K
        if mesh is None:
            k0, k1 = 0, K
            gather = lambda v, k_dim: v                     # noqa: E731
            psum = lambda v: v                              # noqa: E731
        else:
            if torch.device(mesh.device) != torch.device(dev):
                raise ValueError(f"the model lives on {dev}, the mesh rank on {mesh.device}")
            k0, k1 = mesh.band(K)
            gather = lambda v, k_dim: mesh.gather(v, mesh.shard_k(k_dim))   # noqa: E731
            psum = mesh.sum
        sizes = self.basis_sizes()
        r_max = int(max(1, sizes.max()))
        r_max = -(-r_max // self.R_BUCKET) * self.R_BUCKET   # bucket
        V = torch.as_tensor(self._padded_bases(r_max), device=dev)       # [K, r_max, N]
        mask = torch.as_tensor(np.arange(r_max)[None, :] < sizes[:, None], device=dev).to(WIDE)
        Vm = V * mask[:, :, None]
        ed = d.estimator.data
        if ed.M_aa is None:
            raise ValueError("reduce() needs the matrix-form estimator tensors: "
                             "discretize without lean=True")
        nbhd_idx, rows_safe, valid = self._bucket_rows(d.grid, K, r_max)
        rows_t = torch.as_tensor(rows_safe, device=dev)
        valid_t = torch.as_tensor(valid, device=dev).to(WIDE)

        op_arrays = tuple(a.to(WIDE) for a in (d.op.A_diag, *d.op.couplings().values()))
        rhs_q = d.rhs_q.to(WIDE)
        st = d.op.static
        # the algebraic-residual Gramians: always, unless force_lean (set by
        # tests, and by weak_greedy when its criterion never reads them)
        with_gramians = not self.force_lean
        parabolic = self.parabolic_tensors

        Wk, Tk = self._images(Vm, sizes, r_max, rows_t, valid_t,
                              lean=mesh is None and not (with_gramians or parabolic))
        A_red, b_red = self._project(op_arrays, rhs_q, Vm, mask, st, band=(k0, k1))
        names = ("E_bar", "BB", "M_aa", "M_ab", "d_vec", "R_dd")
        ed_band = tuple(getattr(ed, n).narrow(K_AXIS[n], k0, k1 - k0) for n in names)
        out = self._est_projections(ed_band, Vm[k0:k1], Wk[k0:k1], Tk[:, k0:k1])
        out = {n: gather(v, 0 if n == "G_nc" else 2) for n, v in out.items()}
        out.update(A_red=gather(A_red, 1), b_red=gather(b_red, 1),
                   G_bb=None, G_Ab=None, G_AA=None, parabolic=None)
        if with_gramians or parabolic:
            ch, chV = self._chunks(K, r_max)
            AVs = (self._operator_images(op_arrays, Vm, chV) if mesh is None
                   else self._band_images(mesh, Vm, chV))                  # Q x [R, Kb, N]
            rhs_b = rhs_q[:, k0:k1]
            if with_gramians:
                out["G_bb"], out["G_Ab"], out["G_AA"] = (
                    psum(g) for g in self._gramians(AVs, rhs_b, ch))
            if parabolic:
                par = self._parabolic(AVs, rhs_b, Tk[:, k0:k1], rows_t[k0:k1],
                                      valid_t[k0:k1], ch, chV, L2=ed.L2[k0:k1])
                out["parabolic"] = {n: psum(v) if n == "G_MAA" else gather(v, 2)
                                    for n, v in par.items()}
        return self._build_reduced(out, sizes, r_max, nbhd_idx)

    def _band_images(self, mesh, Vm, chV: int):
        """:meth:`_operator_images` on the rank's band of ``mesh``: Q x
        [R, Kb, N], every basis column through the banded block apply, which
        reads the halo rows of the (replicated) columns."""
        from .parallel.stencil import BandedBlockOp
        K, r_max, _ = Vm.shape
        k0, k1 = mesh.band(K)
        bop = BandedBlockOp.from_affine(mesh, self.d.op)
        e0 = k0 - bop.lo * bop.row
        e1 = k1 + (bop.row if k1 < K else 0)
        AVs = []
        for q in range(self.d.op.A_diag.shape[0]):
            Aq = bop.component(q, WIDE)
            AVs.append(torch.cat([Aq.apply_ext(self._column_chunk(Vm, c0, chV)[:, e0:e1])
                                  for c0 in range(0, K * r_max, chV)]))
        return AVs

    def _chunks(self, K: int, r_max: int):
        """(ch, chV): basis columns per chunk of the row-chunked image path
        and block dots, and of the operator applies."""
        R_all = K * r_max
        if self.force_chunk:
            return int(self.force_chunk), int(self.force_chunk)
        ch = max(1, min(R_all, 4096 // K))
        return ch, max(ch, min(R_all, 128))

    def _images(self, Vm, sizes, r_max, rows_t, valid_t, lean: bool):
        """The neighborhood image stacks (Wk [K, P, N], Tk [Q, K, P, Nrt]) of
        the current bases.  Lean reductions keep them in ``_img_cache`` and
        update them only for the basis columns added since the previous
        reduce(): bases are append-only (extend_basis_local), so earlier
        images stay valid, and bucket growth only remaps the slot layout.
        Every other case computes all columns."""
        d = self.d
        ed = d.estimator.data
        K = d.space.K
        dev = Vm.device
        colors = self._subdomain_colors(d.grid) if self.use_colored_images else None
        cache = self._img_cache
        if (lean and cache is not None and not self.force_full_projection
                and cache["r_max"] <= r_max and np.all(sizes >= cache["sizes"])):
            Wk, Tk = cache["Wk"], cache["Tk"]
            r_old = cache["r_max"]
            if r_old < r_max:          # bucket grew: remap slot layout
                def grow(X, axis):
                    shp = list(X.shape)
                    Pn = shp[axis] // r_old
                    Xr = X.reshape(shp[:axis] + [Pn, r_old] + shp[axis + 1:])
                    pad = [0, 0] * (Xr.ndim - axis - 2) + [0, r_max - r_old]
                    Xr = torch.nn.functional.pad(Xr, pad)
                    return Xr.reshape(shp[:axis] + [Pn * r_max] + shp[axis + 1:])
                Wk, Tk = grow(Wk, 1), grow(Tk, 2)
            new_rows = np.concatenate([
                k * r_max + np.arange(cache["sizes"][k], sizes[k])
                for k in range(K)]).astype(np.int64)         # ascending
            for i in range(0, len(new_rows), self.UPD_CHUNK):
                ids = new_rows[i:i + self.UPD_CHUNK]
                n_batch, bidx = 0, None
                if colors is not None:
                    color_k, n_colors = colors
                    kseq = ids // r_max                      # ascending, same-k runs
                    rank = np.arange(len(ids)) - np.searchsorted(kseq, kseq)
                    mb = int(rank.max()) + 1
                    n_batch = n_colors * mb
                    bidx = torch.as_tensor(color_k[kseq] * mb + rank, device=dev)
                self._image_update(Vm, torch.as_tensor(ids, device=dev), Wk, Tk,
                                   rows_t, valid_t, bidx, n_batch)
        elif colors is not None:
            Wk, Tk = self._colored_rows(ed.oswald, ed.flux, ed.lambda_funcs, Vm, rows_t,
                                        valid_t, WIDE, colors[0], colors[1])
        else:
            Wk, Tk = self._patch_rows(ed.oswald, ed.flux, ed.lambda_funcs, Vm, rows_t,
                                      valid_t, WIDE, self._chunks(K, r_max)[0])
        if lean:
            self._img_cache = {"r_max": r_max, "sizes": sizes.copy(), "Wk": Wk, "Tk": Tk}
        return Wk, Tk

    def _build_reduced(self, out, sizes, r_max, nbhd_idx) -> ReducedModel:
        ed = self.d.estimator.data
        return ReducedModel(
            reductor=self, A_red=out["A_red"], b_red=out["b_red"],
            sizes=sizes, r_max=r_max, nbhd_idx=nbhd_idx,
            G_nc=out["G_nc"], AA=out["AA"], ABT=out["ABT"], BBT=out["BBT"],
            DV=out["DV"], RD=out["RD"], rf_qq=ed.rf_qq.to(WIDE), min_ev=ed.min_ev.to(WIDE),
            diam=ed.diam.to(WIDE), G_bb=out["G_bb"], G_Ab=out["G_Ab"], G_AA=out["G_AA"],
            parabolic=out["parabolic"])


class ParallelLRBMSReductor(LRBMSReductor):
    """Distributed-by-default reductor (<-> ``reductor.ParallelLRBMSReductor``;
    the reference's MPI op-sum is dead code).  Without a ``mesh`` and with
    a process group of more than one rank up, it builds a
    :class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh` over the
    largest rank prefix whose size divides the subdomain rows (z-layers in
    3D), and so K: every reduce and re-reduction then runs K-sharded.  Every
    rank of the group must construct it (a prefix below the world size is a
    new subgroup); ranks outside the prefix, and a single process, take the
    (identical-result) local path."""

    def __init__(self, d, *args, mesh=None, **kwargs):
        import torch.distributed as dist
        if mesh is None and dist.is_available() and dist.is_initialized():
            st = d.op.static
            rows = st.kz if st.dim3 else st.ky
            n = dist.get_world_size()
            while n > 1 and rows % n:
                n -= 1
            if n > 1:
                from .parallel.mesh import SubdomainMesh
                mesh = SubdomainMesh.create(n, device=d.device)
        super().__init__(d, *args, mesh=mesh, **kwargs)


class ParabolicLRBMSReductor(LRBMSReductor):
    """<-> ``reductor.ParabolicLRBMSReductor``: adds the reduced mass matrix
    and the fully projected parabolic estimator tensors."""

    parabolic_tensors = True

    def reduce(self, mesh=None) -> "ReducedParabolicModel":
        rd = super().reduce(mesh=mesh)
        d = self.d
        K, r_max = d.space.K, rd.r_max
        V = torch.as_tensor(self._padded_bases(r_max), device=d.device)
        diag = torch.einsum("kan,knm,kbm->kab", V, d.products["l2"].to(WIDE), V)
        blk = (torch.arange(K, device=d.device)[:, None] * r_max
               + torch.arange(r_max, device=d.device)[None, :])
        M_red = torch.zeros((K * r_max, K * r_max), dtype=WIDE, device=d.device)
        M_red[blk[:, :, None], blk[:, None, :]] = diag
        return ReducedParabolicModel(rd, M_red)


@dataclass
class ReducedParabolicModel:
    """Implicit Euler on the reduced system and the parabolic reduced
    estimate; other attributes are the elliptic reduced model's.
    :meth:`attach_instationary` supplies the time grid (T, nt) and the FOM
    the unprojected estimate reconstructs into."""
    elliptic: ReducedModel
    M_red: torch.Tensor                    # [R, R] block-diagonal reduced mass

    def __getattr__(self, name):
        if name == "elliptic":
            raise AttributeError(name)
        return getattr(self.elliptic, name)

    def attach_instationary(self, im):
        self._instationary = im
        return self

    def solve(self, mu, T: float = None, nt: int = None):
        """Reduced implicit-Euler trajectory [nt+1, K, r_max] (one f64 LU of
        M_red + dt A_red(mu))."""
        im = self._instationary
        T = im.T if T is None else T
        nt = int(im.nt if nt is None else nt)
        return self._trajectory(self.elliptic.parse_parameter(mu), T / nt, nt)

    def solve_batch(self, mus, T: float = None, nt: int = None):
        """B reduced trajectories [B, nt+1, K, r_max] (one batched LU)."""
        im = self._instationary
        T = im.T if T is None else T
        nt = int(im.nt if nt is None else nt)
        mus = [self.elliptic.parse_parameter(m) for m in mus]
        stacked = {k: torch.stack([torch.as_tensor(m[k]) for m in mus]) for k in mus[0]}
        return self._trajectory(stacked, T / nt, nt)

    def _trajectory(self, mu, dt: float, nt: int):
        rd = self.elliptic
        d = rd.d
        dev = rd.A_red.device
        theta = evaluate_coefficients(d.lambda_coeffs, mu, WIDE, dev)       # [Q] | [B, Q]
        G = self.M_red + dt * torch.einsum("...q,qij->...ij", theta, rd.A_red)
        # keep padding rows solvable
        G = G + torch.diag_embed((torch.diagonal(G, dim1=-2, dim2=-1) == 0).to(G.dtype))
        lu, piv = torch.linalg.lu_factor(G)
        lanes = tuple(G.shape[:-2])
        # theta_f of every step on the host in f64, one copy to the device
        theta_f = torch.stack([
            evaluate_coefficients(d.f_coeffs, dict(mu, _t=(n + 1.0) * dt), WIDE, "cpu")
            for n in range(nt)]).to(dev)
        c = torch.zeros(lanes + (G.shape[-1],), dtype=WIDE, device=dev)
        traj = [c]
        for n in range(nt):
            f = torch.einsum("...q,qi->...i", theta_f[n], rd.b_red)
            rhs = (torch.einsum("ij,...j->...i", self.M_red, c) + dt * f).expand(c.shape)
            c = torch.linalg.lu_solve(lu, piv, rhs.unsqueeze(-1)).squeeze(-1)
            traj.append(c)
        traj = torch.stack(traj, dim=len(lanes))
        return traj.reshape(traj.shape[:-1] + (len(rd.sizes), rd.r_max))

    def estimate(self, c, mu, decompose: bool = False, projected: bool = True):
        """Parabolic reduced estimate of c [nt+1, K, r_max]:
        (eta, (nc, r, df, time_res, tdnc)).

        projected=True: fully projected, N-independent (the time residual
        from G_MAA, the elliptic-reconstruction additions from the G_BL* /
        G_FL* tensors); projected=False: the FOM estimate of the
        reconstruction (the validation path)."""
        im = self._instationary
        rd = self.elliptic
        if not projected or rd.parabolic is None:
            return im.estimate(rd.reconstruct(c), mu, decompose=decompose)
        d = rd.d
        pb = rd.parabolic
        mu = dict(rd.parse_parameter(mu))
        mu.setdefault("_t", 0.0)
        dt = im.T / im.nt
        theta, theta_f = rd._thetas(mu)

        eta_nc, eta_r, eta_df = rd.local_quantities(c, mu)                  # [nt+1, K]
        ch = rd._gather_neighborhood(c)                                      # [nt+1, K, P]
        tt = torch.einsum("p,r->pr", theta, theta)
        blb = torch.einsum("pr,prkuv,...ku,...kv->...k", tt, pb["G_BLB"], ch, ch)
        flf = torch.einsum("f,g,fgk->k", theta_f, theta_f, pb["G_FLF"])
        bld = torch.einsum("pr,prkuv,...ku,...kv->...k", tt, pb["G_BLdiv"], ch, ch)
        fld = torch.einsum("f,q,fqku,...ku->...k", theta_f, theta, pb["G_FLdiv"], ch)
        scale = (1.0 / (np.pi ** 2) / rd.min_ev) * rd.diam ** 2
        eta_r = eta_r + (blb - flf - 2.0 * (bld - fld)) * scale
        eta = aggregate_eta(d.estimator, mu, eta_nc, eta_r, eta_df)

        dc = (c[1:] - c[:-1]).reshape(c.shape[0] - 1, -1)                  # [nt, R]
        G_M = torch.einsum("pr,prij->ij", tt, pb["G_MAA"])
        tr2 = torch.einsum("bi,ij,bj->b", dc, G_M, dc)
        time_res = torch.sqrt(dt / 3.0 * torch.clamp(tr2, min=0.0))

        cscale = 2.0 * np.sqrt(dt / 3.0)
        eta = eta * cscale
        nc, r, df = (torch.movedim(v, 0, -1) * cscale for v in (eta_nc, eta_r, eta_df))
        dch = rd._gather_neighborhood(c[1:] - c[:-1])
        tdnc = torch.einsum("bkp,kpr,bkr->kb", dch, rd.G_nc, dch) / dt
        tdnc = torch.sqrt(torch.clamp(tdnc, min=0.0))
        out = (torch.linalg.norm(torch.atleast_1d(eta)) + torch.linalg.norm(time_res)
               + torch.linalg.norm(tdnc))
        return out, (nc, r, df, time_res, tdnc)

    def estimate_batch(self, cs, mus):
        """Projected estimates [B] of the trajectories cs [B, nt+1, K, r_max]
        at the B parameters ``mus``."""
        return torch.stack([self.estimate(cs[b], mu, projected=True)[0]
                            for b, mu in enumerate(mus)])
