"""Offline weak-greedy basis construction, batched over the training set.

The port of ``pylrbms_tpu/greedy.py``: ``weak_greedy`` and the parabolic
``pod_greedy``.  The greedy's inner loop — "estimate the reduced error for
every training parameter" — is ONE lane-batched evaluation over the whole
training set: the reduced solves are one batched dense ``[B, R, R]`` LU, the
localized estimator and the residual Gramian forms are batched einsums, and
the direct FOM residual goes through the lane-batched stencil operator.
With a :class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh` the sweep is
split over the ranks by training parameter (it is embarrassingly parallel
in mu): each rank evaluates its share of the lanes and the surrogates are
all-gathered, so every rank takes the same argmax.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .reductor import LRBMSReductor, ExtensionError, ParabolicLRBMSReductor
from .utils.checkpoint import load_greedy_state, save_greedy_state
from .utils.logging import getLogger
from .utils.timers import GLOBAL_TIMINGS

# dof count above which the Gramian form of the residual gives way to the
# direct FOM residual
RESIDUAL_FOM_MIN_DOFS = 32768


@dataclass
class GreedyResult:
    reductor: LRBMSReductor
    rd: object
    max_etas: List[float]
    chosen_mus: List[dict]
    fom_solves: int


def _stack_mus(mus):
    """list of parameter dicts -> dict of stacked tensors (leading axis B)."""
    return {k: torch.stack([torch.as_tensor(mu[k]) for mu in mus]) for k in mus[0].keys()}


def _pad_lanes(mus_stacked, n: int):
    """The lane axis padded to a multiple of ``n`` by TILING (so that a
    batch smaller than the pad still splits evenly); returns (padded
    stacked mus, original B)."""
    B = next(iter(mus_stacked.values())).shape[0]
    pad = (-B) % n
    if pad:
        reps = 1 + -(-pad // B)
        mus_stacked = {k: torch.cat([torch.as_tensor(v)] * reps)[:B + pad]
                       for k, v in mus_stacked.items()}
    return mus_stacked, B


def _shard_batch(mesh, mus_stacked):
    """This rank's share of the training lanes: :func:`_pad_lanes` to the
    mesh size, then cut into contiguous parts.  Returns (this rank's
    stacked mus, original B)."""
    padded, B = _pad_lanes(mus_stacked, mesh.size)
    return {k: mesh.put(v, mesh.shard_k(0)) for k, v in padded.items()}, B


def batched_estimates(rd, mus_stacked, criterion: str = "estimator", mesh=None):
    """Error surrogate [B] for every training parameter in one lane-batched
    evaluation.  criterion='residual' uses the algebraic-residual dual norm
    via the projected Gramians (N-independent; goes to 0 as ROM -> FOM);
    'residual_fom' evaluates ||b - A(mu) V c||_2 DIRECTLY through the
    matrix-free stencil operator — numerically exact where the expanded
    quadratic form cancels below floating-point noise (high-contrast
    problems at scale); 'estimator' uses the LRBMS total-error estimator
    (floored by the discretization error: the certification quantity).

    With ``mesh`` each rank evaluates its share of the lanes
    (:func:`_shard_batch`) and the [B] surrogates are all-gathered: every
    rank returns the same tensor."""
    if mesh is not None:
        mine, B = _shard_batch(mesh, mus_stacked)
        part = batched_estimates(rd, mine, criterion).to(mesh.device)
        return mesh.gather(part.contiguous(), mesh.shard_k(0))[:B]
    if criterion == "residual" and rd.G_AA is None:
        # the reductor skipped the algebraic-residual Gramians
        criterion = "residual_fom"
    mu = rd.parse_parameter(mus_stacked)
    c = rd.solve(mu)                                     # [B, K, r_max]
    if criterion == "residual":
        return rd.residual_norm(c, mu)
    if criterion == "estimator":
        return rd.estimate_lanes(c, mu)[0]
    if criterion != "residual_fom":
        raise ValueError(f"unknown criterion {criterion!r}")
    d = rd.d
    U = rd.reconstruct(c).to(d.rhs_q.dtype)              # [B, K, N]
    theta, b = d.theta(mu), d.rhs(mu)
    if theta.ndim == 1:
        theta = theta.expand(U.shape[0], -1)
    r = b - d.mf_operator().assemble(theta).apply(U)
    return torch.linalg.norm(r.reshape(r.shape[0], -1), dim=1)


def weak_greedy(d, training_set, target_error: float = 1e-4,
                max_extensions: int = 50, products=None,
                reductor: Optional[LRBMSReductor] = None,
                order: int = 0, criterion: str = "residual",
                checkpoint_path: Optional[str] = None,
                resume: bool = False,
                snapshot_options: Optional[dict] = None, mesh=None) -> GreedyResult:
    """Weak greedy: until the worst surrogate error over the training set
    drops below target_error, pick the worst parameter, FOM-solve it, extend
    the local bases blockwise, re-project.  Parameters whose snapshot adds
    nothing are retired from the selection.

    With ``checkpoint_path`` the bases + selection state are written
    atomically after every extension; ``resume=True`` continues from that
    file (skipping the already-performed FOM snapshot solves).

    ``snapshot_options`` are the ``inverse_options`` for the FOM snapshot
    solves, merged onto the model's own.  Default precision is 1e-8: a
    snapshot only feeds the basis through Gram-Schmidt, so accuracy far
    below the greedy's own surrogate target buys nothing, while the default
    model precision (1e-10) lengthens the Krylov tail (the preconditioner
    is frozen at mu_bar, so the tail flattens for far-away mus).

    ``mesh`` (a SubdomainMesh) splits the surrogate sweep over its ranks
    (:func:`batched_estimates`); every rank holds the same surrogates, picks
    the same worst parameter and runs the same (replicated) snapshot solve,
    extension and re-reduction.  Pass a reductor with ``mesh=`` to run the
    re-reductions K-sharded too."""
    logger = getLogger("pylrbms.greedy")
    snapshot_options = {**(d.solver_options or {}), "precision": 1e-8,
                        **(snapshot_options or {})}
    if (criterion == "residual" and d.space.K * d.space.N > RESIDUAL_FOM_MIN_DOFS
            and d.estimator is not None
            and getattr(d.estimator.data, "lambda_funcs", None)):
        # at scale (and high contrast) the Gramian form of the residual
        # cancels below floating-point noise; evaluate it directly
        criterion = "residual_fom"
        logger.info("greedy: using direct FOM-residual criterion at scale")
    mus = [d.parse_parameter(mu) for mu in training_set]
    max_etas, chosen_idx = [], []
    retired = np.zeros(len(mus), dtype=bool)
    it0 = 0
    red = None
    if resume and checkpoint_path is not None:
        p = checkpoint_path if checkpoint_path.endswith(".npz") else checkpoint_path + ".npz"
        if os.path.exists(p):
            red, it0, retired, max_etas, chosen_idx = load_greedy_state(
                d, p, products=products)
            retired = retired.copy()
            logger.info(f"greedy: resumed from {p} at iteration {it0} "
                        f"(RB size {sum(b.shape[0] for b in red.bases)})")
    if red is None:
        red = reductor or LRBMSReductor(d, products=products, order=order)
    if criterion != "residual" and reductor is None:
        # the direct-residual criteria never read the algebraic-residual
        # Gramians (G_bb/G_Ab/G_AA): force the LEAN projection so every
        # (re-)reduction skips them AND runs the incremental image-cache
        # path.  Only applied to reductors this function OWNS (created here
        # or checkpoint-loaded) — a caller-supplied reductor may read the
        # Gramians afterwards.
        red.force_lean = True
    elif criterion != "residual" and not red.force_lean:
        logger.info("greedy: caller-supplied reductor keeps Gramian projections; set "
                    "reductor.force_lean=True for the lean/incremental re-reduction path")
    # overlap the frozen-preconditioner build of the snapshot solves with the
    # initial reduction and the first surrogate sweep; joined before the
    # first FOM solve
    prep_t = d.prepare_solver(inverse_options=snapshot_options, background=True)
    T = GLOBAL_TIMINGS
    with T.span('greedy: initial reduction') as _s:
        rd = red.reduce()
        _s["sync"] = rd.A_red
    stacked = _stack_mus(mus)
    chosen = [mus[i] for i in chosen_idx]
    solves = 0
    for it in range(it0, max_extensions):
        with T.span('greedy: surrogate sweep'):
            # the host copy blocks: the span also absorbs device work the
            # preceding re-reduction left in flight
            etas = batched_estimates(rd, stacked, criterion, mesh=mesh).detach().cpu().numpy()
        sel = np.where(retired, -np.inf, etas)
        worst = int(np.argmax(sel))
        max_eta = float(etas[worst])
        max_etas.append(max_eta)
        logger.info(f"greedy iter {it}: max {criterion} {max_eta:.3e} at "
                    f"training index {worst} (RB size {rd.solution_dim})")
        if max_eta <= target_error or retired.all():
            break
        if prep_t is not None:
            with T.span('greedy: solver preparation (join)'):
                prep_t.join()
            prep_t = None
        with T.span('greedy: FOM snapshot solve') as _s:
            U = d.solve(mus[worst], inverse_options=snapshot_options)
            _s["sync"] = U
        if d.last_solve_iters is not None:
            logger.info(f"greedy: snapshot solve {int(d.last_solve_iters)} Krylov iterations "
                        f"(precision {snapshot_options.get('precision', 1e-10):.0e})")
        solves += 1
        chosen.append(mus[worst])
        chosen_idx.append(worst)
        try:
            with T.span('greedy: basis extension (GS)'):
                red.extend_basis(U)
        except ExtensionError:
            logger.info(f"greedy: snapshot at index {worst} added nothing; retiring it")
            retired[worst] = True
            continue
        with T.span('greedy: re-reduction (projection)') as _s:
            rd = red.reduce()
            _s["sync"] = rd.A_red
        if checkpoint_path is not None:
            save_greedy_state(red, checkpoint_path, it=it + 1, retired=retired,
                              max_etas=max_etas, chosen_idx=chosen_idx)
    if prep_t is not None:
        prep_t.join()
    return GreedyResult(reductor=red, rd=rd, max_etas=max_etas,
                        chosen_mus=chosen, fom_solves=solves)


def pod_greedy(im, training_set, target_error: float = 1e-4,
               max_extensions: int = 20, products=None, pod_modes: int = 1,
               order: int = 0, checkpoint_path: Optional[str] = None,
               resume: bool = False) -> GreedyResult:
    """POD-greedy for the parabolic LRBMS model ``im``: until the worst
    projected parabolic ROM estimate over the training set drops below
    ``target_error``, pick the worst parameter, solve its FOM trajectory,
    subtract the ROM reconstruction, and extend each local basis with the
    ``pod_modes`` leading POD modes of the local error trajectory in the
    local energy product (a host eigh of the [nt+1, nt+1] snapshot
    correlation).  The sweep is one batched reduced solve and B projected
    estimates.  The estimate is floored by the FOM discretization error.

    ``checkpoint_path`` / ``resume``: as :func:`weak_greedy` (bases and
    selection state after every extension)."""
    logger = getLogger("pylrbms.pod_greedy")
    d = im.stationary
    mus = [d.parse_parameter(mu) for mu in training_set]
    max_ests: List[float] = []
    chosen_idx: List[int] = []
    it0 = 0
    red = None
    if resume and checkpoint_path is not None:
        p = checkpoint_path if checkpoint_path.endswith(".npz") else checkpoint_path + ".npz"
        if os.path.exists(p):
            red, it0, _, max_ests, chosen_idx = load_greedy_state(
                d, p, products=products, cls=ParabolicLRBMSReductor)
            logger.info(f"pod-greedy: resumed from {p} at iteration {it0} "
                        f"(RB size {sum(b.shape[0] for b in red.bases)})")
    if red is None:
        red = ParabolicLRBMSReductor(d, products=products, order=order)
    T = GLOBAL_TIMINGS
    with T.span('pod-greedy: initial reduction') as _s:
        rd = red.reduce().attach_instationary(im)
        _s["sync"] = rd.A_red
    chosen = [mus[i] for i in chosen_idx]
    fom_solves = 0

    def _save(it_next):
        if checkpoint_path is not None:
            save_greedy_state(red, checkpoint_path, it=it_next,
                              retired=np.zeros(len(mus), dtype=bool),
                              max_etas=max_ests, chosen_idx=chosen_idx)

    for it in range(it0, max_extensions):
        with T.span('pod-greedy: surrogate sweep'):
            cs = rd.solve_batch(mus)
            ests = rd.estimate_batch(cs, mus).detach().cpu().numpy()
        worst = int(np.argmax(ests))
        max_ests.append(float(ests[worst]))
        logger.info(f"pod-greedy iter {it}: max estimate {ests[worst]:.3e} "
                    f"at training index {worst} (RB size {int(red.basis_sizes().sum())})")
        if ests[worst] <= target_error:
            _save(it + 1)
            break
        mu_w = mus[worst]
        with T.span('pod-greedy: FOM trajectory solve') as _s:
            U = im.solve(mu_w)                                 # [nt+1, K, N]
            _s["sync"] = U
        fom_solves += 1
        chosen.append(mu_w)
        chosen_idx.append(worst)
        with T.span('pod-greedy: POD of the error trajectory'):
            E = U.detach().cpu().numpy() - red.reconstruct(cs[worst]).cpu().numpy()
            modes = np.zeros((pod_modes,) + E.shape[1:])       # [m, K, N]
            for k in range(d.space.K):
                Ek = E[:, k, :]
                w, Vv = np.linalg.eigh(Ek @ red.products[k] @ Ek.T)
                idx = np.argsort(w)[::-1][:pod_modes]
                idx = idx[w[idx] > max(float(w.max()), 0.0) * 1e-12]
                modes[:idx.size, k] = Vv[:, idx].T @ Ek
        try:
            with T.span('pod-greedy: basis extension (GS)'):
                red.extend_basis(modes)
        except ExtensionError:
            logger.info("pod-greedy: no local basis grew — stopping")
            _save(it + 1)
            break
        with T.span('pod-greedy: re-reduction (projection)') as _s:
            rd = red.reduce().attach_instationary(im)
            _s["sync"] = rd.A_red
        _save(it + 1)
    return GreedyResult(reductor=red, rd=rd, max_etas=max_ests,
                        chosen_mus=chosen, fom_solves=fom_solves)
