"""Stationary block model and the online step.

The port of the 2D part of ``pylrbms_tpu/model.py``: the
:class:`StationaryBlockModel` container (theta, rhs, assemble, the detailed
solve — dense, block-Jacobi PCG, or the matrix-free two-level stencil PCG
at scale — with its post-checks, caching and frozen preconditioner,
estimate, and the dense oversampled-patch corrector solve of the online
enrichment) and :func:`make_online_step`, the LRBMS online step
``(theta, theta_f, mu) -> (U, indicators)`` for one query or for B queries
in one call (``vmap`` becomes an explicit leading lane axis).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import validate_solver_options
from .utils.precision import pin_precision, device as _device
from .la.block import (AffineBlockOp, AssembledBlockOp, AffineBlockApply,
                       geneo_coarse_basis, harvested_coarse_basis, neumann_blocks,
                       prepare_coarse, reblock, unblock)
from .ops.matrixfree import StencilOperator, assemble_swipdg_stencil, cast
from .ops.ir import diag_of_blocks, solve_ir
from .ops.fluxreco import FluxReconstructor
from .parameters import (CubicParameterSpace, evaluate_coefficients,
                         parse_parameter)
from .estimators import EllipticEstimator

# dof counts from which the reference takes the stencil operator: in the
# online step (matrix_free=None) and in solve's 'auto' (mf_pcg)
STENCIL_STEP_MIN_DOFS = 16384
MF_SOLVE_MIN_DOFS = 32768


class SolverError(RuntimeError):
    """Raised when the solver post-check fails (<-> ISTL
    ``post_check_solves_system``)."""


class OperatorDictView:
    """Read-only dict facade over the named per-subdomain operators (the
    reference's ``d.operators['local_energy_dg_product_{ii}']`` etc.)."""

    def __init__(self, model: "StationaryBlockModel"):
        self._m = model

    def _lookup(self, key: str):
        m = self._m
        ed = m.estimator.data if m.estimator else None
        name, _, idx = key.rpartition("_")
        if idx.isdigit():
            ii = int(idx)
            table = {
                "local_energy_dg_product": lambda: m.products["energy_mu_bar"][ii],
                "nc": lambda: ed.E_bar[ii],
                "r_dd": lambda: ed.R_dd[ii],
                "r_fd": lambda: ed.d_vec[:, ii],
                "df_bb": lambda: ed.BB[ii],
                "df_aa": lambda: ed.M_aa[:, :, ii],
                "df_ab": lambda: ed.M_ab[:, ii],
                "r_l2": lambda: m.products["l2"][ii],
                "r_ud": lambda: torch.einsum("nm,mr->nr", m.products["l2"][ii], ed.A_div),
            }
            if name in table:
                return table[name]()
        if key in m.products:
            return m.products[key]
        raise KeyError(key)

    def __getitem__(self, key):
        return self._lookup(key)

    def __contains__(self, key):
        try:
            self._lookup(key)
            return True
        except KeyError:
            return False


@dataclass
class StationaryBlockModel:
    grid: object
    space: object
    op: AffineBlockOp
    lambda_coeffs: list
    rhs_q: torch.Tensor                    # [Qf, K, N]
    f_coeffs: list
    estimator: Optional[EllipticEstimator]
    parameter_space: Optional[CubicParameterSpace]
    parameter_type: Optional[dict]
    components: List = field(default_factory=list)
    products: Dict[str, torch.Tensor] = field(default_factory=dict)
    solver_options: Optional[dict] = None
    dtype: torch.dtype = torch.float64
    device: Optional[torch.device] = None  # None: the current CUDA device
    name: str = "StationaryBlockModel"
    # Krylov count of the last matrix-free solve (None after other solves)
    last_solve_iters: Optional[torch.Tensor] = field(default=None, init=False, repr=False)
    _solution_cache: Optional[dict] = field(default=None, init=False, repr=False)
    # the stencil operator and the frozen preconditioners of _mf_solve,
    # built once under _mf_lock (prepare_solver may race a foreground solve)
    _mf_sop: Optional[StencilOperator] = field(default=None, init=False, repr=False)
    _mf_cache: dict = field(default_factory=dict, init=False, repr=False)
    _mf_lock: threading.Lock = field(default_factory=threading.Lock, init=False,
                                     repr=False, compare=False)

    def __post_init__(self):
        self.device = _device(self.device)

    @property
    def operators(self) -> OperatorDictView:
        """String-keyed view of the named per-subdomain operators."""
        return OperatorDictView(self)

    def enable_caching(self, region: str = "memory"):
        """Memoize ``solve`` by parameter and effective solver options
        (opt-in; the reference disables pyMOR caching)."""
        self._solution_cache = {}
        return self

    def disable_caching(self):
        self._solution_cache = None
        return self

    def parse_parameter(self, mu):
        return parse_parameter(self.parameter_type, mu)

    def theta(self, mu):
        return evaluate_coefficients(self.lambda_coeffs, mu, self.dtype, self.device)

    def theta_f(self, mu):
        return evaluate_coefficients(self.f_coeffs, mu, self.dtype, self.device)

    def rhs(self, mu):
        """[K, N] assembled rhs."""
        return torch.einsum("...q,qkn->...kn", self.theta_f(mu), self.rhs_q)

    def assemble(self, mu) -> AssembledBlockOp:
        return self.op.assemble(self.theta(mu))

    def _solver_kind(self, options) -> str:
        """The solver type, with 'auto' resolved to 'mf_pcg' above
        :data:`MF_SOLVE_MIN_DOFS` (the other 'auto' sizes are left to
        :meth:`AssembledBlockOp.solve`)."""
        kind = options.get("type", "auto")
        if (kind == "auto" and self.space.K * self.space.N > MF_SOLVE_MIN_DOFS
                and self.estimator is not None
                and getattr(self.estimator.data, "lambda_funcs", None)):
            return "mf_pcg"
        return kind

    def prepare_solver(self, mu=None, inverse_options=None, background=False):
        """Build the frozen matrix-free preconditioner ahead of the first
        solve, frozen at ``mu`` (default mu_bar).  No-op (None) for options
        that do not take the matrix-free path.  ``background=True`` runs it
        in a daemon thread and returns the thread (join before relying on
        the freeze point)."""
        options = dict(validate_solver_options(inverse_options, "inverse_options")
                       or self.solver_options or {})
        if self._solver_kind(options) != "mf_pcg":
            return None
        if mu is None:
            mu = (self.estimator.data.mu_bar or {}) if self.estimator else {}
        theta = self.theta(self.parse_parameter(mu))
        # a zero rhs exits the Krylov loop at once but builds the freeze
        b0 = torch.zeros((self.space.K, self.space.N), dtype=self.rhs_q.dtype,
                         device=self.device)

        def work():
            try:
                self._mf_solve(theta, b0, options)
            except Exception:       # noqa: BLE001 — the prefetch is best-effort
                logging.getLogger(__name__).exception("solver prefetch failed")

        if background:
            t = threading.Thread(target=work, daemon=True, name="solver-prefetch")
            t.start()
            return t
        work()
        return None

    def solve(self, mu, inverse_options=None):
        """Detailed solve: 'dense', 'pcg' (block-Jacobi PCG), 'mf_pcg'
        (matrix-free two-level stencil PCG, :meth:`_mf_solve`); 'auto' is
        dense up to 6144 dofs, PCG up to 32768 and mf_pcg above.

        An mf_pcg solve is checked by default: a relative residual above
        max(1e3 * precision, 1e-6) raises :class:`SolverError` (opt out
        with ``post_check=False``).  ``post_check_solves_system`` checks the
        relative residual against the assembled operator and retries once
        with the dense LU solve (``fallback=False``: raise only)."""
        options = (validate_solver_options(inverse_options, "inverse_options")
                   or self.solver_options or {})
        mu = self.parse_parameter(mu)
        cache = self._solution_cache
        key = None
        if cache is not None:
            # keyed by the effective options: a 1e-8 snapshot solve must not
            # be served to a later 1e-10 request
            key = (tuple(sorted((k, tuple(torch.as_tensor(v).reshape(-1).tolist()))
                                for k, v in mu.items())),
                   tuple(sorted((k, repr(v)) for k, v in options.items())))
            if key in cache:
                self.last_solve_iters = None
                return cache[key]
        b = self.rhs(mu)
        A = None                 # the dense-block operator, only if needed
        if self._solver_kind(options) == "mf_pcg":
            theta = self.theta(mu)
            U, it = self._mf_solve(theta, b, options)
            self.last_solve_iters = it
            if (options.get("post_check", True)
                    and options.get("post_check_solves_system") is None):
                # divergence guard: a PCG that ran out of iterations or broke
                # down must not return silently (a loose gate, not accuracy)
                tol_eff = float(options.get("precision", 1e-10))
                gate = max(1e3 * tol_eff, 1e-6)
                r = self.mf_operator().assemble(theta).apply(U) - b
                rel = float(torch.sqrt(torch.sum(r * r)
                                       / torch.clamp(torch.sum(b * b), min=1e-300)))
                if not math.isfinite(rel) or rel > gate:
                    raise SolverError(
                        f"mf solve diverged or stalled: |r|/|b| = {rel:.3e} > "
                        f"{gate:.1e} (requested precision {tol_eff:.1e}; iteration "
                        f"budget exhausted or preconditioner breakdown)")
        else:
            A = self.assemble(mu)
            U = A.solve(b, options)
            self.last_solve_iters = None

        check = options.get("post_check_solves_system")
        if check is not None:
            if A is None:
                A = self.assemble(mu)

            def relres(U_):
                r = torch.linalg.norm((b - A.apply(U_)).reshape(-1))
                return float(r) / max(float(torch.linalg.norm(b.reshape(-1))), 1e-300)

            rel = relres(U)
            if not (math.isfinite(rel) and rel <= check) and options.get("fallback", True):
                U = A.solve_dense(b)
                rel = relres(U)
            if not (math.isfinite(rel) and rel <= check):
                raise SolverError(f"solver post-check failed: |r|/|b| = {rel:.3e} "
                                  f"> {check:.1e}")
        if cache is not None:
            cache[key] = U
        return U

    def operator_apply(self, U, mu):
        return self.assemble(mu).apply(U)

    def mf_operator(self) -> StencilOperator:
        """The affine stencil operator of this model (assembled once)."""
        if self._mf_sop is None:
            with self._mf_lock:
                if self._mf_sop is None:
                    dtype = self.op.A_diag.dtype
                    self._mf_sop = StencilOperator(self.space, tuple(
                        assemble_swipdg_stencil(self.space, lf, None, dtype=dtype,
                                                device=self.device)
                        for lf in self.estimator.data.lambda_funcs))
        return self._mf_sop

    def _mf_solve(self, theta, b, options):
        """Matrix-free two-level PCG: stencil apply, f32-applied subdomain
        block-Jacobi (:func:`precond_dot`) and a coarse level ('harvested'
        by default, 16 modes, applied in f32).  The preconditioner is built
        once, at the FIRST theta seen (the cache key has no theta), and
        reused for every later mu.  ``mixed=True`` runs the f32 iterative
        refinement of ``ops/ir.solve_ir`` instead (off unless asked for).
        Returns (U, iterations)."""
        sop = self.mf_operator()
        tol = float(options.get("precision", 1e-10))
        maxiter = int(options.get("max_iter", 2000))
        two_level = bool(options.get("two_level", True))
        coarse_modes = int(options.get("coarse_modes", 16))
        coarse_space = options.get("coarse_space", "harvested")
        pkey = ("precond", two_level, coarse_space, coarse_modes)
        with self._mf_lock:
            pre = self._mf_cache.get(pkey)
            if pre is None:
                pre = self._mf_cache[pkey] = _frozen_preconditioner(
                    self, theta, two_level, coarse_space, coarse_modes)
        bf, C, ci = pre
        A = sop.assemble(theta)
        if not options.get("mixed", False):
            return A.solve_pcg(b, tol=tol, maxiter=maxiter, block_factors=bf,
                               coarse_inv=ci, coarse_basis=C, return_iters=True,
                               coarse_f32=True)
        with self._mf_lock:
            if "sop32" not in self._mf_cache:
                self._mf_cache["sop32"] = cast(sop, torch.float32)
                self._mf_cache["diag_q"] = diag_of_blocks(self.op.A_diag)
        A32 = self._mf_cache["sop32"].assemble(theta.to(torch.float32))
        dvec = torch.einsum("q,qkn->kn", theta, self._mf_cache["diag_q"])
        x, it32, _, it64 = solve_ir(
            A, A32, b, dvec, tol=tol, maxiter=maxiter, block_factors=bf,
            coarse_inv=ci, coarse_basis=C,
            inner_tol=float(options.get("mixed_inner_tol", 1e-4)),
            inner_maxiter=int(options.get("mixed_inner_maxiter", 300)),
            max_rounds=int(options.get("mixed_rounds", 20)), return_info=True)
        return x, it32 + it64

    def estimate(self, U, mu, decompose: bool = False, paper_convention: bool = False):
        mu = self.parse_parameter(mu)
        return self.estimator.estimate(U, mu, decompose=decompose,
                                       paper_convention=paper_convention)

    def l2_solve(self, V):
        """Apply the inverse of the block-diagonal L2 product to V [..., K, N]."""
        return torch.linalg.solve(self.products["l2"], V.unsqueeze(-1)).squeeze(-1)

    @property
    def l2_product(self):
        return self.products["l2"]

    def unblock(self, U):
        return unblock(U)

    def reblock(self, u):
        return reblock(u, self.space.K, self.space.N)

    @property
    def solution_shape(self):
        return (self.space.K, self.space.N)

    def shape_functions(self, subdomain: int, order: int = 0):
        """Initial local RB functions [n_vec, N]: order 0 = the constant,
        order 1 adds the nodal interpolants of x, y, x*y."""
        if order not in (0, 1):
            raise ValueError(f"order must be 0 or 1, got {order}")
        sp = self.space
        vecs = [np.ones(sp.N)]
        if order == 1:
            xn = sp.node_coords_phys()[subdomain].reshape(sp.N, 2)
            vecs += [xn[:, 0], xn[:, 1], xn[:, 0] * xn[:, 1]]
        return torch.as_tensor(np.stack(vecs), dtype=self.dtype, device=self.device)

    def assemble_patch(self, subdomain: int, mu=None):
        """Assemble the oversampled-neighborhood corrector system: the fresh
        neighborhood SWIPDG assembly with local all-Dirichlet boundary info,
        as dense host matrices (the oracle the batched corrector of
        ``ops/corrector.py`` is held to).

        Returns (members, A [m*N, m*N] per affine component, b [m*N]).
        Patch-boundary faces (interfaces leaving the patch) get the one-sided
        Dirichlet penalty blocks; intra-patch interfaces keep their coupling
        quadruples; physical-boundary faces keep the true Dirichlet terms."""
        grid, sp = self.grid, self.space
        members = grid.neighborhood_of(subdomain)
        m = len(members)
        pos = {ii: i for i, ii in enumerate(members)}
        N, s = sp.N, sp.s
        kx, ky = grid.kx, grid.ky
        st = self.op.static
        eR = {(int(l), int(r)): e for e, (l, r) in enumerate(zip(st.left_k, st.right_k))}
        eU = {(int(l), int(u)): e for e, (l, u) in enumerate(zip(st.low_k, st.up_k))}
        side_rows = st.side_rows
        side_neighbor = {"left": -1, "right": +1, "bottom": -kx, "top": +kx}
        mem_t = torch.as_tensor(members, device=self.device)

        def host(t):
            return t.detach().to("cpu", torch.float64).numpy()

        mats = []
        for comp in self.components:
            A = np.zeros((m * N, m * N))
            A_loc = host(comp.A_loc[mem_t])
            D_side = {side: host(comp.D_side[side][mem_t]) for side in side_rows}
            quads = {nm: host(getattr(comp, nm)) for nm in
                     ("R_in_in", "R_in_out", "R_out_in", "R_out_out",
                      "U_in_in", "U_in_out", "U_out_in", "U_out_out")}
            for ii in members:
                i = pos[ii]
                blk = A_loc[i].copy()
                sx, sy = grid.subdomain_coords(ii)
                on_bnd = {"left": sx == 0, "right": sx == kx - 1,
                          "bottom": sy == 0, "top": sy == ky - 1}
                for side, rows in side_rows.items():
                    if on_bnd[side] or ii + side_neighbor[side] not in pos:
                        Ds = D_side[side][i]                     # [s, nb, nb]
                        for f in range(s):
                            blk[np.ix_(rows[f], rows[f])] += Ds[f]
                A[i * N:(i + 1) * N, i * N:(i + 1) * N] += blk
            # intra-patch interface terms
            for ii in members:
                i = pos[ii]
                sx, sy = grid.subdomain_coords(ii)
                for side, fam, emap, other in (("right", "R", eR, "left"),
                                               ("top", "U", eU, "bottom")):
                    if (side == "right" and sx >= kx - 1) or (side == "top" and sy >= ky - 1):
                        continue
                    jj = ii + side_neighbor[side]
                    if jj not in pos:
                        continue
                    j = pos[jj]
                    e = emap[(ii, jj)]
                    rm, rp = side_rows[side], side_rows[other]
                    q_ii, q_io, q_oi, q_oo = (quads[f"{fam}_{q}"][e] for q in
                                              ("in_in", "in_out", "out_in", "out_out"))
                    for f in range(s):
                        r_i = rm[f] + i * N
                        r_j = rp[f] + j * N
                        A[np.ix_(r_i, r_i)] += q_ii[f]
                        A[np.ix_(r_i, r_j)] += q_io[f]
                        A[np.ix_(r_j, r_i)] += q_oi[f]
                        A[np.ix_(r_j, r_j)] += q_oo[f]
            mats.append(torch.as_tensor(A, dtype=self.dtype, device=self.device))

        b = torch.einsum("q,qmn->mn", self.theta_f(mu or {}),
                         self.rhs_q[:, mem_t]).reshape(m * N)
        return members, mats, b

    def solve_for_local_correction(self, subdomain: int, Us=None, mu=None,
                                   inverse_options=None, current_solution=None,
                                   mode: str = "residual"):
        """Local corrector solve on the oversampled patch (dense LU).

        mode='reference': A_patch(mu) w = f with homogeneous Dirichlet on the
        patch boundary; mu-only, so repeated enrichment at one mu stalls.

        mode='residual' (default, the OS2015 paper's corrector):
        A_patch(mu) w = (f - A(mu) u_current)|_patch.  As the reduced
        solution improves the corrector shrinks; w = 0 exactly when
        u_current solves the FOM."""
        mu = self.parse_parameter(mu)
        members, mats, b = self.assemble_patch(subdomain, mu)
        if mode == "residual" and current_solution is not None:
            cur = torch.as_tensor(current_solution, device=self.device).to(self.dtype)
            r = self.rhs(mu) - self.assemble(mu).apply(cur)
            b = r[torch.as_tensor(members, device=self.device)].reshape(-1)
        theta = self.theta(mu)
        A = sum(t * M for t, M in zip(theta, mats))
        w = torch.linalg.solve(A, b)
        i = members.index(subdomain)
        N = self.space.N
        return w[i * N:(i + 1) * N]


def _frozen_preconditioner(d, theta, two_level, coarse_space, coarse_modes,
                           factors=True):
    """The preconditioner frozen at ``theta``: the block-Jacobi factors of
    A(theta) (None with ``factors=False``, unless the harvest needs them)
    and, with ``two_level``, the conditioned coarse basis and its inverse
    (``coarse_space`` 'modal' | 'geneo' | 'harvested', ``coarse_modes``
    columns; None otherwise).  Returns ``(bf, C, ci)``."""
    A = d.op.assemble(theta)
    harvested = two_level and coarse_space == "harvested"
    bf = A.block_jacobi_factors() if factors or harvested else None
    if not two_level:
        return bf, None, None
    if harvested:
        C_np = harvested_coarse_basis(A, bf, d.space, n_harvest=coarse_modes, extra_modal=3)
    elif coarse_space == "geneo":
        C_np = geneo_coarse_basis(neumann_blocks(d, theta), d.products["l2"], coarse_modes)
    else:
        C_np = AssembledBlockOp.coarse_modes_basis(d.space, coarse_modes)
    return (bf,) + prepare_coarse(A, C_np)


def _resolve_theta_bar(d):
    """theta at the model's reference parameter mu_bar (falling back to the
    estimator data's); all-ones thetas when there is no usable mu_bar."""
    mu_bar = getattr(d, "mu_bar", None)
    if mu_bar is None and d.estimator is not None:
        mu_bar = getattr(d.estimator.data, "mu_bar", None)
    try:
        return d.theta(mu_bar or {})
    except KeyError:
        return torch.ones((d.op.A_diag.shape[0],), dtype=d.dtype, device=d.device)


def _wide_estimator(est, dtype):
    """The estimator with its tensors and flux reconstruction in ``dtype``
    (the certified step's wide-precision indicators)."""
    ed = est.data
    fl = ed.flux
    wide = {f.name: getattr(ed, f.name).to(dtype) for f in dataclasses.fields(ed)
            if isinstance(getattr(ed, f.name), torch.Tensor)}
    wide["flux"] = FluxReconstructor(fl.space, fl.kappa_fn, fl.ipdg, dtype=dtype,
                                     device=fl.device)
    return EllipticEstimator(dataclasses.replace(ed, **wide),
                             est.alpha_first_component_only)


def make_online_step(d: StationaryBlockModel, tol: float = 1e-6,
                     maxiter: int = 400, with_estimate: bool = True,
                     positive_form: bool = True,
                     fixed_preconditioner: bool = True,
                     matrix_free=None, certify: bool = False,
                     refinements: int = 2, two_level: bool = True,
                     coarse_modes: int = 6, coarse_space: str = "modal",
                     jacobi_storage: str = None):
    """Online step ``(theta, theta_f, mu) -> (U[, indicators])`` on the
    model's device and dtype.

    Single query: theta [Q], theta_f [Qf], mu with scalar-like leaves.
    Batched: theta [B, Q], theta_f [B, Qf], mu leaves [B, ...] — one call,
    the same per-lane results as single queries.

    ``matrix_free``: True (the stencil operator, ``ops/matrixfree.py``),
    False (theta-assembled diagonal blocks) or 'affine'
    (:class:`~pylrbms_tpu_torch.la.block.AffineBlockApply`: the affine
    stacks stream once per CG iteration for all lanes).  None resolves as in
    the reference: the stencil at >= 16384 dofs, else False.

    ``certify`` (for f32 models): U is polished by ``refinements`` rounds
    of mixed-precision refinement (residual in f64 with the step's
    operator, correction solved in the model dtype) and the indicators are
    evaluated on the f64 U (returned in f64).  A no-op for f64 models.

    ``fixed_preconditioner``: block-Jacobi factors frozen at mu_bar.
    ``two_level`` with ``coarse_space`` 'modal' | 'geneo' | 'harvested'
    (``coarse_modes`` columns): a coarse level fixed at mu_bar.
    ``jacobi_storage``: None (auto: 'bf16' on CUDA, native on CPU), 'bf16'
    or 'native'.

    The step carries ``step.arrays`` (the tensors it reads at every call,
    keyed as the reference's ``step.arrays``; ``"stencils"`` holds the
    affine stencils of the stencil form) and ``step.iters_probe``.
    Lane-batched calls share one solve for the stencil form and for the
    affine form with a fixed preconditioner; the other forms answer the
    lanes one by one.
    """
    pin_precision()
    st = d.op.static
    dev = d.device
    arrays = {"A_diag": d.op.A_diag, "C_R_io": d.op.C_R_io,
              "C_R_oi": d.op.C_R_oi, "C_U_io": d.op.C_U_io,
              "C_U_oi": d.op.C_U_oi, "rhs_q": d.rhs_q}
    if matrix_free is None:
        matrix_free = (d.space.K * d.space.N >= STENCIL_STEP_MIN_DOFS
                       and d.estimator is not None
                       and getattr(d.estimator.data, "lambda_funcs", None) is not None)
    if matrix_free not in (False, True, "affine"):
        raise ValueError(f"matrix_free must be True, False, 'affine' or None, "
                         f"got {matrix_free!r}")
    if matrix_free is True:
        arrays["stencils"] = d.mf_operator().stencils
    if jacobi_storage is None:
        jacobi_storage = "bf16" if dev.type == "cuda" else "native"
    if jacobi_storage not in ("bf16", "native"):
        raise ValueError(f"jacobi_storage must be 'bf16' or 'native', got {jacobi_storage!r}")
    Minv, C, Cinv = _frozen_preconditioner(
        d, _resolve_theta_bar(d), two_level and d.space.K > 1, coarse_space,
        coarse_modes, factors=fixed_preconditioner)
    if fixed_preconditioner:
        arrays["Minv_bar"] = Minv.to(torch.bfloat16) if jacobi_storage == "bf16" else Minv
    if C is not None:
        arrays["C_coarse"], arrays["Cinv_bar"] = C, Cinv
    est = d.estimator
    with_estimate = with_estimate and est is not None
    est_keys = ()
    if with_estimate:
        ed = est.data
        arrays["E_bar"] = ed.E_bar
        est_keys = ("E_bar",)
        if not positive_form:
            arrays.update(BB=ed.BB, M_aa=ed.M_aa, M_ab=ed.M_ab,
                          d_vec=ed.d_vec, R_dd=ed.R_dd, L2=ed.L2)
            est_keys += ("BB", "M_aa", "M_ab", "d_vec", "R_dd", "L2")
    wide = torch.float64
    certify = certify and d.dtype != wide
    est_w = _wide_estimator(est, wide) if certify and with_estimate else est

    def _solver(theta):
        """(operator at theta, solve(rhs, **kw)) of the configured form."""
        if matrix_free is True:
            A = StencilOperator(d.space, arrays["stencils"]).assemble(theta)
            return A, lambda rhs, **kw: A.solve_pcg(
                rhs, tol=tol, maxiter=maxiter, block_factors=arrays.get("Minv_bar"),
                coarse_inv=arrays.get("Cinv_bar"), coarse_basis=arrays.get("C_coarse"), **kw)
        if matrix_free == "affine":
            A = AffineBlockApply(st, arrays["A_diag"], arrays["C_R_io"],
                                 arrays["C_R_oi"], arrays["C_U_io"],
                                 arrays["C_U_oi"], theta)
        else:
            mixq = lambda C: torch.einsum("q,qefij->efij", theta, C)   # noqa: E731
            A = AssembledBlockOp(st, torch.einsum("q,qkij->kij", theta, arrays["A_diag"]),
                                 mixq(arrays["C_R_io"]), mixq(arrays["C_R_oi"]),
                                 mixq(arrays["C_U_io"]), mixq(arrays["C_U_oi"]))
        return A, lambda rhs, **kw: A.solve_pcg(
            rhs, tol=tol, maxiter=maxiter, factors=arrays.get("Minv_bar"),
            coarse_inv=arrays.get("Cinv_bar"), coarse_basis=arrays.get("C_coarse"), **kw)

    def _core(theta, theta_f, mu):
        b = torch.einsum("...q,qkn->...kn", theta_f, arrays["rhs_q"])
        A, solve = _solver(theta)
        U = solve(b)
        base = U.dtype
        if certify:
            # mixed-precision refinement: wide residual, base correction
            Aw = cast(A, wide)
            Uw, bw = U.to(wide), b.to(wide)
            for _ in range(refinements):
                Uw = Uw + solve((bw - Aw.apply(Uw)).to(base)).to(wide)
            U = Uw
        if not with_estimate:
            return U.to(base)
        batched = U.ndim == 3
        Ub = U if batched else U[None]
        tensors = {k: arrays[k].to(U.dtype) for k in est_keys}
        if positive_form:
            nc, r, df = est_w.local_quantities_positive(Ub, mu, tensors=tensors)
        else:
            nc, r, df = est_w.local_quantities(Ub, mu, tensors=tensors)
        ind = nc + r + df
        return U.to(base), (ind if batched else ind[0])

    shared_lanes = matrix_free is True or (matrix_free == "affine" and fixed_preconditioner)

    def _args(theta, theta_f):
        return (torch.as_tensor(theta, device=dev).to(d.dtype),
                torch.as_tensor(theta_f, device=dev).to(d.dtype))

    def step(theta, theta_f, mu=None):
        """Single query: (theta [Q], theta_f [Qf], mu) -> (U [K, N], ind [K]).
        Batched: (thetas [B, Q], theta_fs [B, Qf], mu with [B, ...] leaves)
        -> (U [B, K, N], ind [B, K]) in one call."""
        mu = {} if mu is None else mu
        theta, theta_f = _args(theta, theta_f)
        if theta.ndim == 1 or shared_lanes:
            return _core(theta, theta_f, mu)
        outs = [_core(theta[i], theta_f[i],
                      {k: torch.as_tensor(v)[i] for k, v in mu.items()})
                for i in range(theta.shape[0])]
        if not with_estimate:
            return torch.stack(outs)
        return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]))

    def iters_probe(theta, theta_f):
        """PCG iteration count of the step's solve (the largest over the
        lanes for a batched theta: the lock-step count of a shared solve)."""
        theta, theta_f = _args(theta, theta_f)
        if theta.ndim == 2 and not shared_lanes:
            return max(iters_probe(t, tf) for t, tf in zip(theta, theta_f))
        b = torch.einsum("...q,qkn->...kn", theta_f, arrays["rhs_q"])
        _, it = _solver(theta)[1](b, return_iters=True)
        return int(it.max())

    step.iters_probe = iters_probe
    step.arrays = arrays
    return step
