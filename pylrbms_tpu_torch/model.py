"""Stationary and instationary block models and the online step.

The port of ``pylrbms_tpu/model.py`` (2D and 3D hex): the
:class:`StationaryBlockModel` container (theta, rhs, assemble, the detailed
solve — dense, block-Jacobi PCG, or the matrix-free two-level stencil PCG
at scale — with its post-checks, caching and frozen preconditioner,
estimate, and the dense oversampled-patch corrector solve of the online
enrichment) and :func:`make_online_step`, the LRBMS online step
``(theta, theta_f, mu) -> (U, indicators)`` for one query or for B queries
in one call (``vmap`` becomes an explicit leading lane axis); and
:class:`InstationaryBlockModel`, the implicit-Euler trajectory on top of it
(dense LU, block-Jacobi PCG or the matrix-free stencil PCG by size; B
parameter lanes in one call with :meth:`InstationaryBlockModel.solve_batch`).
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
                       block_jacobi_factors, geneo_coarse_basis,
                       harvested_coarse_basis, neumann_blocks, prepare_coarse,
                       reblock, unblock)
from .ops.hopper_kernels import block_matvec
from .ops.matrixfree import (StencilOperator, assemble_swipdg_stencil, cast,
                             mass_stencil)
from .ops.matrixfree3d import (StencilOperator3, assemble_swipdg_stencil3,
                               mass_stencil3)
from .ops.ir import diag_of_blocks, solve_ir
from .ops.halodense import halo_from_assembled
from .parameters import (CubicParameterSpace, evaluate_coefficients,
                         parse_parameter)
from .estimators import EllipticEstimator, ParabolicEstimator
from .utils.timers import GLOBAL_TIMINGS

# dof counts from which the reference takes the stencil operator: in the
# online step (matrix_free=None) and in solve's 'auto' (mf_pcg)
STENCIL_STEP_MIN_DOFS = 16384
MF_SOLVE_MIN_DOFS = 32768
# the implicit-Euler trajectory takes a dense global LU up to this many dofs,
# block-Jacobi PCG up to MF_SOLVE_MIN_DOFS and the stencil PCG above
TRAJ_DENSE_MAX_DOFS = 6144


def _stencil_kit(space):
    """(stencil assembler, stencil operator class, mass stencil builder) of
    the space's dimension."""
    if getattr(space, "dim", 2) == 3:
        return assemble_swipdg_stencil3, StencilOperator3, mass_stencil3
    return assemble_swipdg_stencil, StencilOperator, mass_stencil


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
        """The affine stencil operator of this model (assembled once; the
        hex stencil on 3D spaces)."""
        if self._mf_sop is None:
            with self._mf_lock:
                if self._mf_sop is None:
                    dtype = self.op.A_diag.dtype
                    mk, Op, _ = _stencil_kit(self.space)
                    self._mf_sop = Op(self.space, tuple(
                        mk(self.space, lf, None, dtype=dtype, device=self.device)
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
        """Apply the inverse of the block-diagonal L2 product to V [..., K, N]
        (one solve per subdomain block with the lanes as its columns)."""
        K, N = self.space.K, self.space.N
        X = V.reshape(-1, K, N).permute(1, 2, 0)                     # [K, N, lanes]
        return torch.linalg.solve(self.products["l2"], X).permute(2, 0, 1).reshape(V.shape)

    @property
    def l2_product(self):
        return self.products["l2"]

    def unblock(self, U):
        return unblock(U)

    def reblock(self, u):
        return reblock(u, self.space.K, self.space.N)

    def visualize(self, U, filename: str):
        """VTU output of a solution U [K, N] (numpy or a tensor on any
        device; <-> ``DuneDiscretization.visualize``); returns the file's
        name."""
        from .utils.vtk import write_dg_vtu, write_hex_vtu
        write = write_hex_vtu if getattr(self.space, "dim", 2) == 3 else write_dg_vtu
        return write(self.space, U, filename)

    @property
    def solution_shape(self):
        return (self.space.K, self.space.N)

    def shape_functions(self, subdomain: int, order: int = 0):
        """Initial local RB functions [n_vec, N]: order 0 = the constant,
        order 1 adds the nodal interpolants of x, y, x*y (3D: x, y, z, the
        reference's truncation to the P1 part)."""
        if order not in (0, 1):
            raise ValueError(f"order must be 0 or 1, got {order}")
        sp = self.space
        vecs = [np.ones(sp.N)]
        if order == 1:
            dim = getattr(sp, "dim", 2)
            xn = sp.node_coords_phys()[subdomain].reshape(sp.N, dim)
            if dim == 3:
                vecs += [xn[:, 0], xn[:, 1], xn[:, 2]]
            else:
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
        quadruples; physical-boundary faces keep the true Dirichlet terms.
        In 3D the patch is the 3x3x3 neighbourhood with six side strips and
        the x/y/z quadruples."""
        grid, sp = self.grid, self.space
        members = grid.neighborhood_of(subdomain)
        m = len(members)
        pos = {ii: i for i, ii in enumerate(members)}
        N = sp.N
        st = self.op.static
        side_rows = st.side_rows
        # per axis: (hi side, lo side, quadruple stem, pair index map, step)
        if st.dim3:
            dims = (grid.kx, grid.ky, grid.kz)
            orients = (("right", "left", "X", st.left_k, st.right_k, 1),
                       ("top", "bottom", "Y", st.low_k, st.up_k, grid.kx),
                       ("far", "near", "Z", st.near_k, st.far_k, grid.kx * grid.ky))
        else:
            dims = (grid.kx, grid.ky)
            orients = (("right", "left", "R", st.left_k, st.right_k, 1),
                       ("top", "bottom", "U", st.low_k, st.up_k, grid.kx))
        emaps = [{(int(lo), int(hi)): e for e, (lo, hi) in enumerate(zip(lo_k, hi_k))}
                 for _h, _l, _f, lo_k, hi_k, _s in orients]
        side_neighbor = {}
        for hi, lo, _f, _lk, _hk, step in orients:
            side_neighbor[hi], side_neighbor[lo] = +step, -step
        mem_t = torch.as_tensor(members, device=self.device)

        def host(t):
            return t.detach().to("cpu", torch.float64).numpy()

        def on_boundary(ii):
            c = grid.subdomain_coords(ii)
            out = {}
            for a, (hi, lo, *_r) in enumerate(orients):
                out[lo], out[hi] = c[a] == 0, c[a] == dims[a] - 1
            return out

        mats = []
        for comp in self.components:
            A = np.zeros((m * N, m * N))
            A_loc = host(comp.A_loc[mem_t])
            D_side = {side: host(comp.D_side[side][mem_t]) for side in side_rows}
            quads = {f"{fam}_{q}": host(getattr(comp, f"{fam}_{q}"))
                     for _h, _l, fam, *_r in orients
                     for q in ("in_in", "in_out", "out_in", "out_out")}
            for ii in members:
                i = pos[ii]
                blk = A_loc[i].copy()
                on_bnd = on_boundary(ii)
                for side, rows in side_rows.items():
                    if on_bnd[side] or ii + side_neighbor[side] not in pos:
                        Ds = D_side[side][i]                     # [F, nb, nb]
                        for f in range(rows.shape[0]):
                            blk[np.ix_(rows[f], rows[f])] += Ds[f]
                A[i * N:(i + 1) * N, i * N:(i + 1) * N] += blk
            # intra-patch interface terms (minus side = right/top/far)
            for ii in members:
                i = pos[ii]
                on_bnd = on_boundary(ii)
                for (hi, lo, fam, _lk, _hk, _s), emap in zip(orients, emaps):
                    jj = ii + side_neighbor[hi]
                    if on_bnd[hi] or jj not in pos:
                        continue
                    j = pos[jj]
                    e = emap[(ii, jj)]
                    rm, rp = side_rows[hi], side_rows[lo]
                    q_ii, q_io, q_oi, q_oo = (quads[f"{fam}_{q}"][e] for q in
                                              ("in_in", "in_out", "out_in", "out_out"))
                    for f in range(rm.shape[0]):
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
    wide["flux"] = type(fl)(fl.space, fl.kappa_fn, fl.ipdg, dtype=dtype, device=fl.device)
    return EllipticEstimator(dataclasses.replace(ed, **wide),
                             est.alpha_first_component_only)


def make_online_step(d: StationaryBlockModel, tol: float = 1e-6,
                     maxiter: int = 400, with_estimate: bool = True,
                     positive_form: bool = True,
                     fixed_preconditioner: bool = True,
                     matrix_free=None, certify: bool = False,
                     refinements: int = 2, two_level: bool = True,
                     coarse_modes: int = 6, coarse_space: str = "modal",
                     jacobi_storage: str = None, enrichment: dict = None):
    """Online step ``(theta, theta_f, mu) -> (U[, indicators])`` on the
    model's device and dtype.

    ``enrichment`` (the keyword settings of :func:`_enrichment_step`, or
    None: the detailed step below) makes it the reduced step of
    :func:`_enrichment_step` instead; the other keywords then do not
    apply.

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

    Each call is a ``step`` span of ``utils/timers.GLOBAL_TIMINGS`` that
    holds, per solve, the spans ``operator.assemble`` (the rhs and the
    operator at theta), ``solve`` (with the refinements of ``certify``) and
    ``estimate`` (the indicators); no-ops while the timings are off.
    """
    if enrichment is not None:
        return _enrichment_step(d, **enrichment)
    pin_precision()
    st = d.op.static
    dev = d.device
    arrays = {"A_diag": d.op.A_diag, **d.op.couplings(), "rhs_q": d.rhs_q}
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
    if with_estimate:
        # the estimator's U- and mu-independent tables, built here (set-up),
        # not in the first call
        if positive_form:
            est_w.tables(wide if certify else d.dtype, dev)
        else:
            est_w.data.flux.tables(est_w.data.lambda_funcs)

    sop = [None]

    def _stencil_op():
        """The affine stencil operator of ``arrays["stencils"]`` (rebuilt
        when they are replaced), kept with its folded components."""
        if sop[0] is None or sop[0].stencils is not arrays["stencils"]:
            sop[0] = _stencil_kit(d.space)[1](d.space, arrays["stencils"])
        return sop[0]

    if matrix_free is True:
        # the stencil operator's own set-up (a lane kernel's folded
        # components), here, not in the first call
        _stencil_op().prepare((d.dtype, wide) if certify else (d.dtype,), dev)

    def _solver(theta):
        """(operator at theta, solve(rhs, **kw)) of the configured form."""
        if matrix_free is True:
            A = _stencil_op().assemble(theta)
            return A, lambda rhs, **kw: A.solve_pcg(
                rhs, tol=tol, maxiter=maxiter, block_factors=arrays.get("Minv_bar"),
                coarse_inv=arrays.get("Cinv_bar"), coarse_basis=arrays.get("C_coarse"), **kw)
        if matrix_free == "affine":
            A = AffineBlockApply(st, arrays["A_diag"], theta=theta,
                                 **{n + "_q": arrays[n] for n in st.names()})
        else:
            A = AssembledBlockOp(st, torch.einsum("q,qkij->kij", theta, arrays["A_diag"]),
                                 **{n: torch.einsum("q,qefij->efij", theta, arrays[n])
                                    for n in st.names()})
        return A, lambda rhs, **kw: A.solve_pcg(
            rhs, tol=tol, maxiter=maxiter, factors=arrays.get("Minv_bar"),
            coarse_inv=arrays.get("Cinv_bar"), coarse_basis=arrays.get("C_coarse"), **kw)

    def _core(theta, theta_f, mu):
        with GLOBAL_TIMINGS.span("operator.assemble"):
            b = torch.einsum("...q,qkn->...kn", theta_f, arrays["rhs_q"])
            A, solve = _solver(theta)
        with GLOBAL_TIMINGS.span("solve"):
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
        with GLOBAL_TIMINGS.span("estimate"):
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
        with GLOBAL_TIMINGS.span("step"):
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


def _enrichment_step(d: StationaryBlockModel, *, training: int, greedy_target: float,
                     max_extensions: int, order: int, target: float,
                     marking_doerfler_theta: float, marking_max_age: int,
                     enrichment_steps: int):
    """The LRBMS reduced online step with adaptive online enrichment:
    ``(theta, theta_f, mu) -> (U, indicators)``, one query or B lanes
    answered one after the other.

    Built once here: the offline reduced model, the weak greedy over
    ``training`` uniform parameters to ``greedy_target`` (at most
    ``max_extensions`` extensions from order-``order`` bases).  A query is an
    episode of :class:`~pylrbms_tpu_torch.online_enrichment.AdaptiveEnrichment`
    (target ``target``, Doerfler ``marking_doerfler_theta``, age
    ``marking_max_age``, at most ``enrichment_steps`` rounds, batched
    correctors) from the offline state, which the episode puts back: no
    query sees another's enrichment.  The parameter comes from ``mu``;
    theta and theta_f must be its coefficients (else ValueError).

    Returns U [B, K, N] (the reconstruction of the final reduced Galerkin
    solution) and indicators [B, K] (eta_nc + eta_r + eta_df of it), or
    [K, N] and [K] for one query, in the model's dtype.  Each call is one
    ``step`` span of ``GLOBAL_TIMINGS`` around the episodes' ``enrich: ...``
    spans and counters.  The step carries ``arrays`` (the offline reduced
    tensors), ``iters_probe(theta, theta_f, mu)`` (the most PCG iterations
    of a corrector solve over the queries' episodes), ``enrichment`` (the
    AdaptiveEnrichment) and ``offline`` (its OfflineState)."""
    from .greedy import weak_greedy
    from .online_enrichment import AdaptiveEnrichment
    res = weak_greedy(d, d.parameter_space.sample_uniformly(training),
                      target_error=greedy_target, max_extensions=max_extensions, order=order)
    online = AdaptiveEnrichment(None, d, d.space, res.reductor, res.rd,
                                target_error=target,
                                marking_doerfler_theta=marking_doerfler_theta,
                                marking_max_age=marking_max_age)
    offline = online.offline_state()
    arrays = {n: getattr(res.rd, n) for n in res.rd._ARRAY_FIELDS
              if getattr(res.rd, n) is not None}

    def queries(theta, theta_f, mu):
        """The queries' parameters on the host, each held to its theta."""
        if mu is None:
            raise ValueError("the enrichment step reads each query's parameter from mu")
        theta = torch.as_tensor(theta, dtype=torch.float64).cpu()
        theta_f = torch.as_tensor(theta_f, dtype=torch.float64).cpu()
        host = {k: torch.as_tensor(v).to("cpu", torch.float64) for k, v in mu.items()}
        lanes = theta.ndim == 2
        out = []
        for i in range(theta.shape[0] if lanes else 1):
            m = d.parse_parameter({k: v[i] for k, v in host.items()} if lanes else host)
            given = torch.cat((theta[i], theta_f[i]) if lanes else (theta, theta_f))
            want = torch.cat([evaluate_coefficients(c, m, device="cpu")
                              for c in (d.lambda_coeffs, d.f_coeffs)])
            if not torch.allclose(given, want, rtol=1e-12, atol=0.0):
                raise ValueError(f"theta, theta_f {given.tolist()} are not the "
                                 f"coefficients of mu {m}")
            out.append(m)
        return out, lanes

    def step(theta, theta_f, mu=None):
        """(theta [B, Q], theta_f [B, Qf], mu with [B, ...] leaves) ->
        (U [B, K, N], indicators [B, K]); single: [K, N], [K]."""
        with GLOBAL_TIMINGS.span("step"):
            ms, lanes = queries(theta, theta_f, mu)
            outs = [online.episode(m, offline, enrichment_steps) for m in ms]
            U = torch.stack([o[0] for o in outs]).to(d.dtype)
            ind = torch.stack([o[1] for o in outs]).to(d.dtype)
            return (U, ind) if lanes else (U[0], ind[0])

    def iters_probe(theta, theta_f, mu=None):
        """The most PCG iterations of a corrector solve over the episodes
        of the queries (0 where no round enriched)."""
        most = 0
        for m in queries(theta, theta_f, mu)[0]:
            online.episode(m, offline, enrichment_steps)
            most = max([most] + online.corrector_iters)
        return most

    step.iters_probe = iters_probe
    step.arrays = arrays
    step.enrichment, step.offline = online, offline
    return step


@dataclass
class InstationaryBlockModel:
    """Implicit-Euler time stepping of a stationary block model: per step
    (M + dt A(mu)) u^{n+1} = M u^n + dt f(t_{n+1}), u^0 = 0.

    Time enters through the ``'_t'`` parameter of the rhs coefficients,
    evaluated on the host in float64 at t = (n + 1) dt (one copy to the
    device per trajectory); G = M + dt A(mu) is
    time-independent, so its factorization or preconditioner is built once
    per mu and reused over the nt steps.  ``last_solve_iters`` holds the
    Krylov counts per step of the last PCG trajectory ([nt], or [B, nt]
    after :meth:`solve_batch`; None after a dense solve)."""
    stationary: StationaryBlockModel
    T: float
    nt: int
    mass: Optional[torch.Tensor] = None        # [K, N, N] block-diagonal L2 mass
    name: str = "InstationaryBlockModel"
    last_solve_iters: Optional[torch.Tensor] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.mass is None:
            self.mass = self.stationary.products["l2"]

    # ---- passthroughs
    def parse_parameter(self, mu):
        return self.stationary.parse_parameter(mu)

    @property
    def parameter_space(self):
        return self.stationary.parameter_space

    @property
    def products(self):
        return self.stationary.products

    def operator_apply(self, U, mu):
        return self.stationary.operator_apply(U, mu)

    def rhs(self, mu):
        return self.stationary.rhs(mu)

    def l2_solve(self, V):
        return self.stationary.l2_solve(V)

    def unblock(self, U):
        return unblock(U)

    def mass_apply(self, u):
        """M u for u [..., K, N]: one :func:`block_matvec` launch (G = 1, the
        lanes of u as its lanes)."""
        ub = u.reshape((-1,) + u.shape[-2:]).contiguous()
        return block_matvec(self.mass[None].contiguous(), ub).reshape(u.shape)

    def estimate(self, U, mu, decompose: bool = False):
        """The parabolic estimate of a trajectory U [nt+1, K, N]:
        (eta, (nc, r, df, time_res, tdnc)); the groups are always returned
        (``decompose`` is the reference's signature)."""
        mu = self.parse_parameter(mu)
        return ParabolicEstimator(self.stationary.estimator.data).estimate(U, mu, d=self)

    # ---- trajectories
    def _theta_f_steps(self, mu, dt: float):
        """theta_f at t = (n + 1) dt for the nt steps, [nt, Qf] (or
        [nt, B, Qf] for lane-batched mu): the '_t' coefficients are evaluated
        on the host in float64 (the channels' 0/1 switch sin(4 pi t) > 0 is
        decided there) and moved to the device in one copy, so the time loop
        waits for no host value."""
        st = self.stationary
        return torch.stack([
            evaluate_coefficients(st.f_coeffs, dict(mu, _t=(n + 1.0) * dt), st.dtype, "cpu")
            for n in range(self.nt)]).to(st.device)

    def _euler_operator(self, A: AssembledBlockOp, dt: float) -> AssembledBlockOp:
        """G = M + dt A as a block operator (every coupling family scaled,
        the z pairs too in 3D)."""
        return AssembledBlockOp(A.static, self.mass + dt * A.A_diag,
                                **{n: dt * C for n, C in A.couplings().items()})

    def _uses_stencil(self) -> bool:
        st = self.stationary
        return (st.estimator is not None
                and bool(getattr(st.estimator.data, "lambda_funcs", None)))

    def solve(self, mu):
        """Trajectory [nt+1, K, N]: a dense global LU of G up to
        :data:`TRAJ_DENSE_MAX_DOFS` dofs, block-Jacobi PCG on the block
        operator G (tol 1e-10, maxiter 500) up to :data:`MF_SOLVE_MIN_DOFS`,
        and the matrix-free :meth:`_solve_mf` above."""
        st = self.stationary
        mu = self.parse_parameter(mu)
        dt = self.T / self.nt
        K, N = st.space.K, st.space.N
        if K * N > MF_SOLVE_MIN_DOFS and self._uses_stencil():
            return self._solve_mf(mu, dt)
        G = self._euler_operator(st.assemble(mu), dt)
        its = []
        if K * N <= TRAJ_DENSE_MAX_DOFS:
            lu, piv = torch.linalg.lu_factor(G.to_dense())

            def solve_step(rhs):
                return torch.linalg.lu_solve(lu, piv, rhs.reshape(-1, 1)).reshape(K, N)
        else:
            factors = G.block_jacobi_factors()

            def solve_step(rhs):
                x, it = G.solve_pcg(rhs, tol=1e-10, maxiter=500, factors=factors,
                                    return_iters=True)
                its.append(it)
                return x

        theta_f = self._theta_f_steps(mu, dt)
        u = torch.zeros((K, N), dtype=st.dtype, device=st.device)
        traj = [u]
        for n in range(self.nt):
            f = torch.einsum("q,qkn->kn", theta_f[n], st.rhs_q)
            u = solve_step(self.mass_apply(u) + dt * f)
            traj.append(u)
        self.last_solve_iters = torch.stack(its) if its else None
        return torch.stack(traj)

    def _solve_mf(self, mu, dt, tol: float = 1e-10, maxiter: int = 500,
                  two_level: bool = None, coarse_modes: int = 16,
                  coarse_space: str = "harvested", precision: str = None,
                  extrapolate: bool = True, return_iters: bool = False,
                  inner: str = None, mesh=None):
        """Matrix-free implicit Euler: G = M + dt A as one stencil family
        (the mass is its first component, :func:`mass_stencil`), the M
        apply is the mass component alone, the per-mu block-Jacobi factors
        of G are applied in f32 through ``precond_dot``; ``two_level``
        (default: above 32 768 dofs) adds the harvested coarse level on G,
        frozen at the first theta per (dt, coarse_space, coarse_modes) and
        applied in f32.  Each step warm-starts from u + (u - u_prev)
        (``extrapolate``) or u.  ``precision`` 'f64' (default) runs f64 PCG,
        'mixed' the f32 iterative refinement of ``ops/ir.solve_ir``, whose
        f32 inner operator is the stencil (``inner`` 'stencil', the default)
        or, with ``inner='halo'``, the halo-dense form of the dense G built
        once per mu (``ops/halodense.py``: one gather and one batched
        product per apply); the f64 residuals keep the stencil.  Returns the
        trajectory (and the iterations per step with ``return_iters``).

        With ``mesh`` (a :class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh`)
        the trajectory runs K-sharded: G and M are banded stencils (one halo
        exchange per apply), the block factors are built for the rank's
        band only, the coarse level (built on every rank) is applied as in
        ``mesh.mf_solve``, and the result is this rank's band
        [nt+1, Kb, N] (``inner='halo'`` is not sharded)."""
        st = self.stationary
        mu = self.parse_parameter(mu)
        G_sop, M_op = self._mf_parab_setup(mesh)
        theta = st.theta(mu)
        theta_G = torch.cat([torch.ones_like(theta[:1]), dt * theta])
        band = None if mesh is None else mesh.band(st.space.K)
        bf = self._parab_factors(dt * theta, band)
        if two_level is None:
            two_level = st.space.K * st.space.N > MF_SOLVE_MIN_DOFS
        C = ci = None
        if two_level:
            C, ci = self._mf_parab_coarse(dt, theta, coarse_space, coarse_modes)
            C = C if band is None else C[band[0]:band[1]]
        precision = self._resolve_traj_precision(precision)
        inner = self._resolve_traj_inner(inner, precision)
        traj, its = self._mf_traj(G_sop, M_op, theta_G, bf, C, ci, mu, dt, tol,
                                  maxiter, precision, extrapolate, inner, mesh=mesh)
        self.last_solve_iters = its
        return (traj, its) if return_iters else traj

    @staticmethod
    def _resolve_traj_inner(inner, precision):
        """The f32 inner operator of the mixed trajectory: 'stencil' unless
        'halo' is asked for (the reference's default picks the halo form
        only off the CPU; here it stays opt-in)."""
        inner = "stencil" if inner is None else inner
        if inner not in ("stencil", "halo"):
            raise ValueError(f"unknown trajectory inner form {inner!r}")
        if inner == "halo" and precision != "mixed":
            raise ValueError("inner='halo' requires precision='mixed'")
        return inner

    @staticmethod
    def _resolve_traj_precision(precision):
        precision = "f64" if precision is None else precision
        if precision not in ("f64", "mixed"):
            raise ValueError(f"unknown trajectory precision {precision!r}")
        return precision

    def _mf_parab_setup(self, mesh=None):
        """(G_sop, M_op): the stencil family of G = M + dt A (the mass
        first, built once per stationary model) and the assembled mass;
        with ``mesh`` both are the rank's banded stencils."""
        st = self.stationary
        sop = st.mf_operator()
        _, Op, mk_mass = _stencil_kit(st.space)
        with st._mf_lock:
            m_st = st._mf_cache.get("mass_stencil")
            if m_st is None:
                m_st = st._mf_cache["mass_stencil"] = mk_mass(st.space, sop.stencils[0])
        G_sop = Op(st.space, (m_st,) + tuple(sop.stencils))
        M_sop = Op(st.space, (m_st,))
        if mesh is not None:
            G_sop, M_sop = mesh.shard_stencil(G_sop), mesh.shard_stencil(M_sop)
        M_op = M_sop.assemble(torch.ones((1,), dtype=m_st.vol.dtype, device=m_st.vol.device))
        return G_sop, M_op

    def _parab_factors(self, dt_theta, band=None):
        """Block-Jacobi factors of M + dt A(theta) for dt_theta [Q], or one
        set per lane for [B, Q]; with ``band`` = (k0, k1) those of
        subdomains [k0, k1) only."""
        k = slice(None) if band is None else slice(*band)
        A_diag = self.stationary.op.A_diag[:, k]
        return block_jacobi_factors(
            self.mass[k] + torch.einsum("...q,qkij->...kij", dt_theta.to(A_diag), A_diag))

    def _parab_diag_q(self):
        """[1+Q, K, N] diagonals of (mass, A_1..A_Q): with theta_G they
        give diag(G(theta)), the Jacobi scaling of the mixed solve."""
        st = self.stationary
        with st._mf_lock:
            dq = st._mf_cache.get("parab_diag_q")
            if dq is None:
                dq = st._mf_cache["parab_diag_q"] = torch.cat(
                    [torch.diagonal(self.mass, dim1=-2, dim2=-1)[None],
                     diag_of_blocks(st.op.A_diag)])
        return dq

    def _mf_parab_coarse(self, dt, theta, coarse_space, coarse_modes):
        """The harvested two-level coarse space on G = M + dt A(theta),
        frozen at the first theta seen per (dt, coarse_space, coarse_modes):
        (C [K, N, m], inverse of the coarse matrix)."""
        st = self.stationary
        key = ("parab_precond", float(dt), coarse_space, int(coarse_modes))
        with st._mf_lock:
            pre = st._mf_cache.get(key)
            if pre is None:
                G0 = self._euler_operator(st.op.assemble(theta), dt)
                C_np = harvested_coarse_basis(G0, G0.block_jacobi_factors(), st.space,
                                              n_harvest=coarse_modes, extra_modal=3)
                pre = st._mf_cache[key] = prepare_coarse(G0, C_np)
        return pre

    def _mf_traj(self, G_sop, M_op, theta_G, bf, C, ci, mu, dt, tol, maxiter,
                 precision, extrapolate, inner="stencil", mesh=None):
        """The trajectory loop for theta_G [1+Q] (one mu) or [B, 1+Q] (B
        lanes of one per-lane frozen PCG, mu with [B, ...] leaves).
        Returns (trajectory [(B,) nt+1, K, N], iterations [(B,) nt]); with
        ``mesh`` the operators, ``bf`` and ``C`` are the rank's bands and so
        is the trajectory."""
        st = self.stationary
        K, N = st.space.K, st.space.N
        rhs_q, diag_q, ir_kw = st.rhs_q, self._parab_diag_q, {}
        if mesh is not None:
            if inner == "halo":
                raise ValueError("inner='halo' is not K-sharded")
            k0, k1 = mesh.band(K)
            rhs_q = rhs_q[:, k0:k1]
            diag_q = lambda: self._parab_diag_q()[:, k0:k1]          # noqa: E731
            ir_kw = dict(comm=mesh, band=(k0, K))
            K = k1 - k0
        lanes = tuple(theta_G.shape[:-1])
        G = G_sop.assemble(theta_G)
        if precision == "mixed":
            if lanes:
                raise ValueError("the mixed trajectory takes one mu at a time")
            dvec = torch.einsum("q,qkn->kn", theta_G, diag_q())
            if inner == "halo":
                G_dense = self._euler_operator(st.op.assemble(theta_G[1:] / dt), dt)
                G32 = halo_from_assembled(G_dense, dtype=torch.float32)
            else:
                G32 = cast(G, torch.float32)
        theta_f = self._theta_f_steps(mu, dt)
        u = u_prev = torch.zeros(lanes + (K, N), dtype=st.dtype, device=st.device)
        traj, its = [u], []
        for n in range(self.nt):
            f = torch.einsum("...q,qkn->...kn", theta_f[n], rhs_q)
            rhs = M_op.apply(u) + dt * f
            x0 = u + (u - u_prev) if extrapolate else u
            if precision == "mixed":
                u_next, it32, _, it64 = solve_ir(
                    G, G32, rhs, dvec, tol=tol, maxiter=maxiter, block_factors=bf,
                    coarse_basis=C, coarse_inv=ci, x0=x0, return_info=True, **ir_kw)
                it = it32 + it64
            else:
                u_next, it = G.solve_pcg(rhs, tol=tol, maxiter=maxiter, block_factors=bf,
                                         coarse_basis=C, coarse_inv=ci, coarse_f32=True,
                                         x0=x0, return_iters=True)
            u_prev, u = u, u_next
            traj.append(u)
            its.append(it)
        return torch.stack(traj, dim=len(lanes)), torch.stack(its, dim=-1)

    def solve_batch(self, mus, shared_preconditioner: bool = True,
                    tol: float = 1e-10, maxiter: int = 500,
                    two_level: bool = None, coarse_modes: int = 16,
                    coarse_space: str = "harvested", precision: str = None,
                    extrapolate: bool = True, inner: str = None, mesh=None):
        """B implicit-Euler trajectories in one call: [B, nt+1, K, N].

        The lanes run one per-lane frozen chunked PCG through the
        lane-batched stencil of G (lane b's iterate sequence is its own);
        the coarse level is frozen at ``mus[0]`` (per dt) and the block
        factors are shared at mu_bar (``shared_preconditioner``) or built
        exactly per mu (B x [K, N, N], folded into one ``precond_dot``
        launch per apply).  ``precision='mixed'`` answers the lanes one by
        one.  ``mesh``: K-sharded as in :meth:`_solve_mf` (the lanes share
        the banded G stencil; the rank's band [B, nt+1, Kb, N] returned)."""
        st = self.stationary
        if not self._uses_stencil():
            raise NotImplementedError("solve_batch needs the matrix-free stencil path "
                                      "(estimator data with lambda_funcs)")
        dt = self.T / self.nt
        mus = [self.parse_parameter(m) for m in mus]
        G_sop, M_op = self._mf_parab_setup(mesh)
        band = None if mesh is None else mesh.band(st.space.K)
        thetas = torch.stack([st.theta(m) for m in mus])                  # [B, Q]
        theta_G = torch.cat([torch.ones_like(thetas[:, :1]), dt * thetas], dim=1)
        if two_level is None:
            two_level = st.space.K * st.space.N > MF_SOLVE_MIN_DOFS
        C = ci = None
        if two_level:
            C, ci = self._mf_parab_coarse(dt, thetas[0], coarse_space, coarse_modes)
            C = C if band is None else C[band[0]:band[1]]
        if shared_preconditioner:
            bf = self._parab_factors(dt * _resolve_theta_bar(st), band)
        else:
            bf = self._parab_factors(dt * thetas, band)                   # [B, K, N, N]
        precision = self._resolve_traj_precision(precision)
        inner = self._resolve_traj_inner(inner, precision)
        if precision == "mixed":
            outs = [self._mf_traj(G_sop, M_op, theta_G[b],
                                  bf if shared_preconditioner else bf[b], C, ci, mus[b],
                                  dt, tol, maxiter, precision, extrapolate, inner, mesh=mesh)
                    for b in range(len(mus))]
            traj, its = torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        else:
            stacked = {k: torch.stack([torch.as_tensor(m[k]) for m in mus]) for k in mus[0]}
            traj, its = self._mf_traj(G_sop, M_op, theta_G, bf, C, ci, stacked, dt, tol,
                                      maxiter, precision, extrapolate, mesh=mesh)
        self.last_solve_iters = its
        return traj
