"""Stationary block model and the online step.

The port of the main-path part of ``pylrbms_tpu/model.py``: the
:class:`StationaryBlockModel` container (theta, rhs, assemble, dense/PCG
solve, estimate) and :func:`make_online_step`, the LRBMS online step
``(theta, theta_f, mu) -> (U, indicators)`` for one query or for B queries
in one call (``vmap`` becomes an explicit leading lane axis).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from pylrbms_tpu.config import validate_solver_options

from .utils.precision import pin_precision
from .la.block import (AffineBlockOp, AssembledBlockOp, AffineBlockApply,
                       geneo_coarse_basis, harvested_coarse_basis, neumann_blocks,
                       prepare_coarse, unblock)
from .parameters import (CubicParameterSpace, evaluate_coefficients,
                         parse_parameter)
from .estimators import EllipticEstimator

_STENCIL_TODO = ("the matrix-free stencil operator (ops/matrixfree.py) is not "
                 "ported yet (ROADMAP slice 1 item 8)")


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
    device: torch.device = torch.device("cpu")
    name: str = "StationaryBlockModel"

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

    def solve(self, mu, inverse_options=None):
        """Detailed solve: 'dense' (global LU) or 'pcg' (block-Jacobi PCG);
        'auto' is dense up to 6144 dofs and PCG up to 32768 (above that the
        reference switches to the stencil operator, not ported yet)."""
        options = validate_solver_options(inverse_options, "inverse_options") \
            or self.solver_options or {}
        mu = self.parse_parameter(mu)
        n = self.space.K * self.space.N
        kind = options.get("type", "auto")
        if kind == "mf_pcg" or (kind == "auto" and n > 32768):
            raise NotImplementedError(_STENCIL_TODO)
        return self.assemble(mu).solve(self.rhs(mu), options)

    def estimate(self, U, mu, decompose: bool = False, paper_convention: bool = False):
        mu = self.parse_parameter(mu)
        return self.estimator.estimate(U, mu, decompose=decompose,
                                       paper_convention=paper_convention)

    def unblock(self, U):
        return unblock(U)


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


def make_online_step(d: StationaryBlockModel, tol: float = 1e-6,
                     maxiter: int = 400, with_estimate: bool = True,
                     positive_form: bool = True,
                     fixed_preconditioner: bool = True,
                     matrix_free=None, two_level: bool = True,
                     coarse_modes: int = 6, coarse_space: str = "modal",
                     jacobi_storage: str = None):
    """Online step ``(theta, theta_f, mu) -> (U[, indicators])`` on the
    model's device and dtype.

    Single query: theta [Q], theta_f [Qf], mu with scalar-like leaves.
    Batched: theta [B, Q], theta_f [B, Qf], mu leaves [B, ...] — one call,
    the same per-lane results as single queries.

    ``matrix_free``: False (theta-assembled diagonal blocks) or 'affine'
    (:class:`~pylrbms_tpu_torch.la.block.AffineBlockApply`: the affine
    stacks stream once per CG iteration for all lanes — the batched-serving
    form).  None resolves as in the reference: the stencil operator at
    >= 16384 dofs (not ported yet: raises), else False.

    ``fixed_preconditioner``: block-Jacobi factors frozen at mu_bar.
    ``two_level`` with ``coarse_space`` 'modal' | 'geneo' | 'harvested'
    (``coarse_modes`` columns): a coarse level fixed at mu_bar.
    ``jacobi_storage``: None (auto: 'bf16' on CUDA, native on CPU), 'bf16'
    or 'native'.

    The step carries ``step.arrays`` (the tensors it reads at every call,
    keyed as the reference's ``step.arrays``) and ``step.iters_probe``.
    Lane-batched calls share one solve when ``matrix_free='affine'`` and the
    preconditioner is fixed; the other forms answer the lanes one by one.
    """
    pin_precision()
    st = d.op.static
    dev = d.device
    arrays = {"A_diag": d.op.A_diag, "C_R_io": d.op.C_R_io,
              "C_R_oi": d.op.C_R_oi, "C_U_io": d.op.C_U_io,
              "C_U_oi": d.op.C_U_oi, "rhs_q": d.rhs_q}
    if matrix_free is None:
        matrix_free = (d.space.K * d.space.N >= 16384
                       and d.estimator is not None
                       and getattr(d.estimator.data, "lambda_funcs", None) is not None)
    if matrix_free is True:
        raise NotImplementedError(_STENCIL_TODO)
    if matrix_free not in (False, "affine"):
        raise ValueError(f"matrix_free must be False, 'affine' or None, got {matrix_free!r}")
    if jacobi_storage is None:
        jacobi_storage = "bf16" if dev.type == "cuda" else "native"
    if jacobi_storage not in ("bf16", "native"):
        raise ValueError(f"jacobi_storage must be 'bf16' or 'native', got {jacobi_storage!r}")
    theta_bar = _resolve_theta_bar(d)
    A_bar = d.op.assemble(theta_bar)
    Minv = None
    if fixed_preconditioner or (two_level and coarse_space == "harvested"):
        Minv = A_bar.block_jacobi_factors()
    if fixed_preconditioner:
        arrays["Minv_bar"] = Minv.to(torch.bfloat16) if jacobi_storage == "bf16" else Minv
    if two_level and d.space.K > 1:
        if coarse_space == "geneo":
            C_np = geneo_coarse_basis(neumann_blocks(d, theta_bar),
                                      d.products["l2"], coarse_modes)
        elif coarse_space == "harvested":
            C_np = harvested_coarse_basis(A_bar, Minv, d.space,
                                          n_harvest=coarse_modes, extra_modal=3)
        else:
            C_np = AssembledBlockOp.coarse_modes_basis(d.space, coarse_modes)
        arrays["C_coarse"], arrays["Cinv_bar"] = prepare_coarse(A_bar, C_np)
    est = d.estimator
    with_estimate = with_estimate and est is not None
    if with_estimate:
        ed = est.data
        arrays["E_bar"] = ed.E_bar
        if not positive_form:
            arrays.update(BB=ed.BB, M_aa=ed.M_aa, M_ab=ed.M_ab,
                          d_vec=ed.d_vec, R_dd=ed.R_dd, L2=ed.L2)

    def _operator(theta):
        if matrix_free == "affine":
            return AffineBlockApply(st, arrays["A_diag"], arrays["C_R_io"],
                                    arrays["C_R_oi"], arrays["C_U_io"],
                                    arrays["C_U_oi"], theta)
        mixq = lambda C: torch.einsum("q,qefij->efij", theta, C)   # noqa: E731
        return AssembledBlockOp(st, torch.einsum("q,qkij->kij", theta, arrays["A_diag"]),
                                mixq(arrays["C_R_io"]), mixq(arrays["C_R_oi"]),
                                mixq(arrays["C_U_io"]), mixq(arrays["C_U_oi"]))

    def _solve(theta, theta_f, **kw):
        b = torch.einsum("...q,qkn->...kn", theta_f, arrays["rhs_q"])
        return _operator(theta).solve_pcg(
            b, tol=tol, maxiter=maxiter, factors=arrays.get("Minv_bar"),
            coarse_inv=arrays.get("Cinv_bar"), coarse_basis=arrays.get("C_coarse"), **kw)

    def _core(theta, theta_f, mu):
        U = _solve(theta, theta_f)
        if not with_estimate:
            return U
        batched = U.ndim == 3
        Ub = U if batched else U[None]
        if positive_form:
            nc, r, df = est.local_quantities_positive(Ub, mu, tensors=arrays)
        else:
            nc, r, df = est.local_quantities(Ub, mu, tensors=arrays)
        ind = nc + r + df
        return U, (ind if batched else ind[0])

    shared_lanes = matrix_free == "affine" and fixed_preconditioner

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
        _, it = _solve(theta, theta_f, return_iters=True)
        return int(it.max())

    step.iters_probe = iters_probe
    step.arrays = arrays
    return step
