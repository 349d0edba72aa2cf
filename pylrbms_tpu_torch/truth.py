"""Self-hosted truth references: large f64 solves with no direct solver.

The port of ``pylrbms_tpu/truth.py`` (its docstring and
``docs/results/truth_solver.txt`` give the method and the findings that
shaped it).  The replacement for scipy's splu on 3D SPE10 references past
the SuperLU ceiling, built on the stencil representation:

- fine level: subdomain-block factors from the stencil's exact dense
  diagonal blocks (``AssembledStencil3.dense_subdomain_blocks``), inverted
  SPD-safely by a Jacobi-scaled batched eigh with an eigenvalue floor
  (:func:`spd_block_inverse`), or per-cell factors where the blocks do not
  fit;
- coarse level: a Chebyshev-harvested basis filtered through the same
  preconditioned operator (:func:`harvested_coarse_cell`), its Galerkin
  matrix from 27-colored stencil applies (:func:`coarse_galerkin_mf`) and
  an SPD-safe f64 pseudo-inverse (:func:`prepare_coarse_mf`);
- the solve: an f64 PCG recurrence with f32-applied factors and an f64
  coarse apply, as chunks of ``chunk_iters`` iterations with the Krylov
  state kept on the device across chunks and frozen by a device-side
  select once converged (one host read per chunk), or the f32-inner
  iterative refinement (``recurrence='f32ir'``).

The subdomain-block factor applies (the PCG's preconditioner, the f32 IR
inner preconditioner and the harvest filter at 32 lanes) go through the
hand-written :func:`~pylrbms_tpu_torch.ops.hopper_kernels.block_matvec`;
the per-cell applies stay torch ops, as the reference's are XLA einsums.
At the reference's ``jax.default_backend()`` gate in
:func:`spd_block_inverse` the port takes the CPU branch (eigh in the
blocks' own dtype).  The reference's jitted loops are Python loops here.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .discretize_elliptic_block_swipdg import _affine
from .la.block import AssembledBlockOp
from .la.krylov import default_chunk
from .ops import hopper_kernels as hk
from .ops.ir import cast_f32
from .ops.matrixfree import bmv
from .parameters import as_functional, evaluate_coefficients, parse_parameter
from .utils.logging import getLogger
from .utils.precision import device as _device, pin_precision

logger = getLogger("pylrbms.truth")


def _sync(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _cell_shape(space):
    s = space.s
    if getattr(space, "dim", 2) == 3:
        return (space.K, s, s, s, space.nb)
    return (space.K, s, s, getattr(space, "T", 1) * space.nb)


def _cell_precond_fn(space):
    """(factors, r) -> z closure for cell-block factors (dim-generic);
    r [..., K, N]."""
    shape = _cell_shape(space)

    def M(factors, r):
        return bmv(factors, r.reshape(r.shape[:-2] + shape)).reshape(r.shape)

    return M


def _block_apply(F, r):
    """``einsum('knm,km->kn', F, r)`` for r [..., K, N] through one
    :func:`block_matvec` launch (the lanes of r as its lanes)."""
    rb = r.reshape((-1,) + r.shape[-2:]).contiguous()
    return hk.block_matvec(F.unsqueeze(0), rb).reshape(r.shape)


def harvested_coarse_cell(S, cell_factors, space, n_harvest: int = 32,
                          extra_modal: int = 6, rounds: int = 2,
                          deg: int = 30, seed: int = 0,
                          block_factors=None) -> np.ndarray:
    """Chebyshev-harvested slow modes of the preconditioned stencil
    operator.  The filter preconditioner is the cell factors, or the
    subdomain ``block_factors`` [K, N, N] when given (then every filter
    apply is one :func:`block_matvec` launch over the ``n_harvest``
    lanes).  The random starts come from ``np.random.default_rng(seed)``,
    as in the reference.  Returns [K, N, extra_modal + n_harvest]
    (float64 numpy, per-subdomain orthonormal)."""
    K, N = space.K, space.N
    if block_factors is not None:
        Mc = _block_apply
        cell_factors = block_factors
    else:
        Mc = _cell_precond_fn(space)
    if n_harvest == 0:
        C = AssembledBlockOp.coarse_modes_basis(space, extra_modal)
        return np.stack([np.linalg.qr(C[k])[0] for k in range(K)])
    dt, dev = cell_factors.dtype, cell_factors.device

    def pa(X):
        return Mc(cell_factors, S.apply(X))

    def randn(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dt, device=dev)

    rng = np.random.default_rng(seed)
    v = randn(K, N)
    lam = torch.zeros((), dtype=dt, device=dev)
    for _ in range(30):
        w = pa(v)
        lam = torch.sqrt(torch.sum(w * w))
        v = w / torch.clamp(lam, min=1e-300)
    # the reference's 1.3 margin: a 30-step power iteration undershoots
    # lambda_max of the cell-preconditioned operator, and any mode above the
    # Chebyshev band is amplified exponentially
    bnd = 1.3 * float(lam)
    a = (0.25 / 2.05) * bnd
    e = (bnd + a) / 2.0
    c = (bnd - a) / 2.0

    def filt(V, e_, c_):
        Vm1, Vc = V, (pa(V) - e_ * V) / c_
        for _ in range(deg - 1):
            Vm1, Vc = Vc, 2.0 * (pa(Vc) - e_ * Vc) / c_ - Vm1
        return Vc

    V = randn(n_harvest, K, N)
    ec = (torch.tensor(e, dtype=dt, device=dev), torch.tensor(c, dtype=dt, device=dev))
    for _ in range(rounds):
        Vh = filt(V, *ec).double().cpu().numpy()
        if not np.isfinite(Vh).all():
            ec = (ec[0] + ec[1], 2.0 * ec[1])
            Vh = filt(randn(n_harvest, K, N), *ec).double().cpu().numpy()
        Q, _ = np.linalg.qr(Vh.reshape(n_harvest, -1).T)
        V = torch.as_tensor(Q.T.reshape(n_harvest, K, N), dtype=dt, device=dev)
    cols = [np.moveaxis(V.double().cpu().numpy(), 0, -1)]
    if extra_modal:
        cols.insert(0, AssembledBlockOp.coarse_modes_basis(space, extra_modal))
    C = np.concatenate(cols, axis=-1)
    return np.stack([np.linalg.qr(C[k])[0] for k in range(K)])


def _lattice_coords(space):
    grid = space.grid
    kx, ky = grid.kx, grid.ky
    kz = getattr(grid, "kz", 1)
    k = np.arange(space.K)
    return k % kx, (k // kx) % ky, k // (kx * ky), kx, ky, kz


def coarse_galerkin_mf(S, C) -> torch.Tensor:
    """Full [K*m, K*m] Galerkin coarse matrix (float64, on S's device) from
    colored stencil applies: a 3-periodic coloring of the subdomain lattice
    (27 colors in 3D, 9 in 2D) makes each 7-point neighbor of a subdomain
    the unique member of its color in the neighborhood, so
    ``C_k^T (A C_masked)_k`` separates into exact Galerkin entries.  Cost:
    n_colors applies of m lanes each, in the stencil's dtype."""
    space = S.space
    K, N, m = C.shape
    ix, iy, iz, kx, ky, kz = _lattice_coords(space)
    dim3 = getattr(space, "dim", 2) == 3
    color = (ix % 3) + 3 * (iy % 3) + (9 * (iz % 3) if dim3 else 0)
    offs = [0, +1, -1, +kx, -kx] + ([+kx * ky, -kx * ky] if dim3 else [])
    dev = S.vol.device
    Cd = torch.as_tensor(np.asarray(C, np.float64), device=dev)
    Ac = torch.zeros((K, m, K, m), dtype=torch.float64, device=dev)
    for col in range(27 if dim3 else 9):
        mask = color == col
        if not mask.any():
            continue
        mask_t = torch.as_tensor(mask, dtype=torch.float64, device=dev)
        Xm = (Cd * mask_t[:, None, None]).permute(2, 0, 1).to(S.vol.dtype)
        Y = S.apply(Xm.contiguous()).to(torch.float64)            # [m, K, N]
        # Ac[(k, i), (k', j)] = C[k, :, i] . Y[j, k], k' the unique color-col
        # subdomain in k's 7-point neighborhood
        blk = torch.einsum("kni,jkn->kij", Cd, Y)                # [K, m, m]
        for off in offs:
            kk = np.arange(K) + off
            valid = (kk >= 0) & (kk < K)
            if off in (+1, -1):
                valid &= (ix + off >= 0) & (ix + off < kx)
            elif off in (+kx, -kx):
                valid &= (iy + np.sign(off) >= 0) & (iy + np.sign(off) < ky)
            elif off != 0:
                valid &= (iz + np.sign(off) >= 0) & (iz + np.sign(off) < kz)
            kk = np.where(valid, kk, 0)
            rows = np.nonzero(valid & (color[kk] == col))[0]
            if rows.size == 0:
                continue
            r_t = torch.as_tensor(rows, device=dev)
            Ac[r_t, :, torch.as_tensor(kk[rows], device=dev), :] += blk[r_t]
    return Ac.reshape(K * m, K * m)


def prepare_coarse_mf(S, C):
    """Condition the basis to unit-energy columns and take the SPD-safe f64
    pseudo-inverse (eigenvalues below 1e-12 of the largest dropped) of the
    colored-apply Galerkin matrix, on S's device.  Returns (C_cond
    [K, N, m], Ac_inv [K*m, K*m]) as float64 tensors."""
    C = np.asarray(C, np.float64)
    Ac = coarse_galerkin_mf(S, C)
    K, N, m = C.shape
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Ac)), min=1e-300))
    Ct = torch.as_tensor(C, device=Ac.device) / d.reshape(K, m)[:, None, :]
    Ac = Ac / d[:, None] / d[None, :]
    sd = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Ac)), min=1e-300))
    Ssym = 0.5 * (Ac + Ac.T) * sd[:, None] * sd[None, :]
    del Ac
    w, V = torch.linalg.eigh(Ssym)
    del Ssym
    wmax = max(float(w.max()), 1e-300)
    keep = w > 1e-12 * wmax
    Vk = V[:, keep]
    Ac_inv = ((Vk / w[keep]) @ Vk.T) * sd[:, None] * sd[None, :]
    return Ct, Ac_inv


class SolveOnlyModel:
    """Minimal model for truth solves at >= 400k dofs: space, rhs and one
    stencil assembled per (mu, dtype) — none of the dense [K, N, N]
    per-subdomain tensors of ``discretize``.  Runs on ``device`` (default:
    the current CUDA device).  ``dtype`` is accepted as the reference's is
    and, like it, unused: the rhs is assembled in f64 and each stencil in
    the dtype :meth:`stencil_at` is given."""

    def __init__(self, gpd, order: int = 1, dtype=torch.float64, device=None):
        from .ops import assembly3d as asm3
        from .ops.spaces3d import BlockDGSpace3D
        pin_precision()
        self.device = _device(device)
        self.space = BlockDGSpace3D(gpd["grid"], order=order)
        self._lambda_funcs, lambda_coeffs = _affine(gpd["lambda"])
        f_funcs, f_coeffs = _affine(gpd["f"])
        self.parameter_type = gpd.get("parameter_type")
        self._lambda_coeffs = [as_functional(c) for c in lambda_coeffs]
        self._f_coeffs = [as_functional(c) for c in f_coeffs]
        self.op = None
        self.rhs_q = torch.stack([asm3.volume_functional(self.space, ff, torch.float64,
                                                         self.device) for ff in f_funcs])

    def parse_parameter(self, mu):
        return parse_parameter(self.parameter_type, mu)

    def theta(self, mu):
        return evaluate_coefficients(self._lambda_coeffs, self.parse_parameter(mu),
                                     torch.float64, self.device)

    def rhs(self, mu):
        th_f = evaluate_coefficients(self._f_coeffs, self.parse_parameter(mu),
                                     torch.float64, self.device)
        return torch.einsum("q,qkn->kn", th_f, self.rhs_q)

    def stencil_at(self, mu, dtype):
        """One assembled stencil at lam_mu(x) = sum_q theta_q lam_q(x): no
        affine component family and no second copy (at this size the device
        holds one f64 stencil beside the factors, not Q of them)."""
        from .ops.matrixfree3d import AssembledStencil3, assemble_swipdg_stencil3
        theta = self.theta(mu).cpu().numpy()
        funcs = self._lambda_funcs

        def lam_mu(x):
            out = None
            for t, lf in zip(theta, funcs):
                v = float(t) * lf(x)
                out = v if out is None else out + v
            return out

        c = assemble_swipdg_stencil3(self.space, lam_mu, None, dtype=dtype,
                                     device=self.device)
        return AssembledStencil3(space=self.space, vol=c.vol, X=c.X, Y=c.Y, Z=c.Z,
                                 IX=c.IX, IY=c.IY, IZ=c.IZ, D_side=c.D_side)


def spd_block_inverse(D, floor_rel: float = 1e-4):
    """SPD-guaranteed approximate block inverse by a Jacobi-scaled eigh:
    ``Binv = S V max(w, floor)^-1 V^T S`` with ``floor = floor_rel * w_max``.

    The LU inverse of a block with internal condition ~1e6 applied in f32
    loses symmetry and definiteness and makes CG's residual grow; the eigh
    form is symmetric PSD at any accuracy, and the floor (1e-4, not 1e-6)
    keeps the stiff-mode amplification within what an f32 application
    resolves (the reference's findings 2-3).  The eigh runs in the blocks'
    dtype, in chunks of ``c = 2e9 / (N*N*4)`` blocks (its workspace is
    several [c, N, N] copies)."""
    dvec = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
    sca = 1.0 / torch.sqrt(torch.clamp(dvec, min=1e-300))
    K, N = D.shape[0], D.shape[-1]
    c = max(1, min(K, int(2e9 / max(N * N * 4, 1))))
    out = torch.empty_like(D)
    for lo in range(0, K, c):
        sl = slice(lo, lo + c)
        cs = D[sl] * sca[sl, :, None] * sca[sl, None, :]
        w, V = torch.linalg.eigh(cs)
        del cs
        wmax = torch.max(w, dim=-1, keepdim=True).values
        winv = 1.0 / torch.maximum(w, floor_rel * torch.clamp(wmax, min=1e-300))
        out[sl] = (V * winv[..., None, :]) @ V.transpose(-1, -2)
        del V
    return out.mul_(sca[:, :, None]).mul_(sca[:, None, :])


def _dot64(u, v):
    return torch.sum(u.to(torch.float64) * v.to(torch.float64))


def _coarse_apply(C, ci, r):
    """C ci C^T r for r [K, N] (C [K, N, m], ci [K*m, K*m])."""
    xc = (ci @ torch.einsum("knm,kn->km", C, r).reshape(-1)).reshape(C.shape[0], C.shape[2])
    return torch.einsum("knm,km->kn", C, xc)


def _pcg_safe(matvec, M, b, tol, maxiter):
    """Safeguarded f32 PCG: freezes on curvature or rz breakdown and returns
    the best-residual iterate (an unguarded f32 recurrence breaks down and
    explodes at Q2-442k conditioning).  Dots accumulate in f64.  The state
    is frozen by a device-side select once done; the host reads the done
    flag once per chunk and leaves early (the frozen state would not
    change).  Returns (best x, iterations)."""
    atol2 = (tol ** 2) * torch.clamp(_dot64(b, b), min=1e-300)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    st = [x, r, z, z, _dot64(r, z), torch.zeros((), dtype=torch.int64, device=b.device),
          torch.ones((), dtype=torch.bool, device=b.device), x, _dot64(r, r)]

    def body(st):
        x, r, z, p, rz, it, ok, xb, rnb = st
        Ap = matvec(p)
        pAp = _dot64(p, Ap)
        ok_new = ok & (pAp > 0) & (rz > 0)
        alpha = torch.where(ok_new, rz / torch.where(pAp > 0, pAp, 1.0), 0.0).to(b.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rzn = _dot64(r, z)
        beta = torch.where(ok_new & (rz > 0), rzn / torch.where(rz > 0, rz, 1.0),
                           0.0).to(b.dtype)
        p = torch.where(ok_new, z + beta * p, p)
        rn = _dot64(r, r)
        better = ok_new & (rn < rnb)
        return [x, r, z, p, rzn, it + 1, ok_new, torch.where(better, x, xb),
                torch.where(better, rn, rnb)]

    def done(st):
        return ~(st[6] & (_dot64(st[1], st[1]) > atol2))

    chunk = default_chunk(b.device)
    i = 0
    while i < maxiter and not bool(done(st)):
        for _ in range(min(chunk, maxiter - i)):
            fin = done(st)
            st = [torch.where(fin, a, n) for a, n in zip(st, body(st))]
        i += chunk
    return st[7], st[5]


def _solve_f32ir(S, S32, BF, F32, C, ci, b, dvec, tol, maxiter, verbose, space):
    """Iterative refinement for the near-isotropic configs: a safeguarded
    f32 PCG (inner tol 1e-5, 3000 iterations) on the Jacobi-scaled system
    per round, one f64 residual pair per round, at most 40 rounds; stops
    on tol or when a round does not halve the residual."""
    f32 = torch.float32
    cell_shape = _cell_shape(space)
    s64 = 1.0 / torch.sqrt(torch.clamp(torch.abs(dvec), min=1e-300))
    s32 = s64.to(f32)
    si32 = (1.0 / s64).to(f32)
    C32, ci32 = C.to(f32), ci.to(f32)

    def Mf(r):
        if BF is not None:
            fine = _block_apply(BF, r)
        else:
            fine = bmv(F32, r.reshape(cell_shape)).reshape(r.shape)
        return fine + _coarse_apply(C32, ci32, r)

    def matvec32(v):
        return s32 * S32.apply(s32 * v)

    def M32(r):
        return si32 * Mf(si32 * r)

    def round_(x):
        r = b - S.apply(x)                          # the round's f64 pair
        rt = s64 * r
        nrm = torch.clamp(torch.max(torch.abs(rt)), min=1e-300)
        dxt, k = _pcg_safe(matvec32, M32, (rt / nrm).to(f32), 1e-5, 3000)
        x_new = x + nrm * s64 * dxt.to(b.dtype)
        r_new = b - S.apply(x_new)
        return x_new, torch.sum(r_new * r_new), k

    t0 = time.perf_counter()
    bn = float(torch.linalg.norm(b.reshape(-1)))
    atol = tol * max(bn, 1e-300)
    x = torch.zeros_like(b)
    it_total, rd, rn_prev = 0, 0, np.inf
    while it_total < maxiter and rd < 40:
        x, rn2, k = round_(x)
        rn = float(torch.sqrt(rn2))
        it_total += int(k)
        rd += 1
        if verbose:
            logger.info(f"truth IR round {rd}: |r|/|b| {rn / bn:.2e} (+{int(k)} f32 its)")
        if rn <= atol * 1.001:
            break
        if rn > 0.5 * rn_prev:
            logger.info("truth_solve(f32ir): stalled — stopping")
            break
        rn_prev = rn
    _sync(x)
    t_solve = time.perf_counter() - t0
    rel = float(torch.linalg.norm((b - S.apply(x)).reshape(-1))) / max(bn, 1e-300)
    info = dict(relres=rel, it32=it_total, rounds=rd, it64=0, t_solve=t_solve)
    if verbose:
        logger.info(f"truth_solve(f32ir): relres {rel:.2e}, f32 its {it_total} "
                    f"({rd} rounds), solve {t_solve:.1f} s")
    if not np.isfinite(rel) or rel > max(1e3 * tol, 1e-6):
        raise RuntimeError(f"truth_solve did not converge: relres {rel}")
    return x.double().cpu().numpy(), info


def truth_solve(d, mu, tol: float = 1e-10, maxiter: int = 20000,
                n_harvest: int = 32, extra_modal: int = 6,
                rounds: int = 2, verbose: bool = True,
                precond: str = None, jacobi_storage: str = None,
                chunk_iters: int = None, recurrence: str = "f64"):
    """f64-accurate FOM solve through the stencil-only mixed-precision path;
    ``d`` a :class:`SolveOnlyModel` (one stencil per (mu, dtype)) or a
    model with ``mf_operator()`` (its assembled stencil, cast to f32 for
    the preconditioner build).  Returns (U [K, N] float64 numpy, info: relres,
    it32, rounds, it64, t_assemble, t_coarse, t_solve, and the parts
    t_blocks and t_eigh of t_assemble (0 on the cell route) and t_harvest
    of t_coarse).

    ``precond``: 'block' (subdomain-block Jacobi, the contrast- and
    anisotropy-robust choice; [K, N, N] of factors) | 'cell' (per-cell
    blocks) | None = 'block' when the f32 factors take <= 9e9 bytes.
    ``jacobi_storage='bf16'`` stores the block factors in bf16 after the
    harvest (half the per-iteration factor bytes).  ``recurrence``: 'f64'
    (the f64 PCG in chunks of ``chunk_iters``, default
    ``max(64, min(512, 512 * 131072 / (K N)))``: the reference's formula,
    which sets the stall cadence and the reported counts; stops at tol or
    after 6 chunks without a 5% gain) | 'f32ir'."""
    st = d
    space = st.space
    mu = st.parse_parameter(mu)
    theta = st.theta(mu)
    K, N = space.K, space.N
    if precond is None:
        precond = "block" if K * N * N * 4 <= 9e9 else "cell"
    # the f32 stencil and preconditioner build (with the eigh transient)
    # and the f64 stencil never coexist on a solve-only model
    t0 = time.perf_counter()
    if hasattr(st, "stencil_at"):
        S32 = st.stencil_at(mu, torch.float32)
    else:
        sop = st.mf_operator()
        S32 = cast_f32(sop.assemble(theta))
    _sync(S32.vol)
    if verbose:
        logger.info(f"truth: f32 stencil assembled ({time.perf_counter() - t0:.1f} s)")
    t_blocks = t_eigh = 0.0
    if precond == "block":
        t1 = time.perf_counter()
        D32 = S32.dense_subdomain_blocks()
        _sync(D32)
        t_blocks = time.perf_counter() - t1
        if verbose:
            logger.info(f"truth: dense blocks built ({time.perf_counter() - t0:.1f} s)")
        dvec = torch.abs(torch.diagonal(D32, dim1=-2, dim2=-1))      # IR scaling
        t1 = time.perf_counter()
        BF = spd_block_inverse(D32)
        del D32
        _sync(BF)
        t_eigh = time.perf_counter() - t1
        if verbose:
            logger.info(f"truth: SPD block inverse done ({time.perf_counter() - t0:.1f} s)")
        F32 = None
    else:
        BF = None
        F32 = S32.cell_jacobi_factors()
        dvec = torch.abs(torch.diagonal(S32.cell_blocks(), dim1=-2, dim2=-1)).reshape(K, N)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    C_np = harvested_coarse_cell(S32, F32, space, n_harvest=n_harvest,
                                 extra_modal=extra_modal, rounds=rounds,
                                 block_factors=BF)
    t_harvest = time.perf_counter() - t0
    if verbose:
        logger.info(f"truth: harvested basis done ({t_harvest:.1f} s)")
    C, ci = prepare_coarse_mf(S32, C_np)
    _sync(ci)
    t_coarse = time.perf_counter() - t0
    if verbose:
        logger.info(f"truth: coarse Galerkin + inverse done ({t_coarse:.1f} s)")
    if BF is not None and jacobi_storage == "bf16":
        BF = BF.to(torch.bfloat16)          # after the harvest: the solve's
        #                                     factor stream only
    if hasattr(st, "stencil_at"):
        if recurrence != "f32ir":
            del S32
            S32 = None
        S = st.stencil_at(mu, torch.float64)
    else:
        S = sop.assemble(theta)
    b = st.rhs(mu).to(torch.float64)
    timings = dict(t_assemble=t_asm, t_coarse=t_coarse, t_blocks=t_blocks, t_eigh=t_eigh,
                   t_harvest=t_harvest)
    if recurrence == "f32ir":
        U, info = _solve_f32ir(S, S32, BF, F32, C, ci, b, dvec, tol, maxiter, verbose, space)
        info.update(timings)
        return U, info
    cell_shape = _cell_shape(space)
    if chunk_iters is None:
        chunk_iters = int(max(64, min(512, 512 * 131072 / (K * N))))
    f32 = torch.float32

    def M(r):
        if BF is not None:
            fine = _block_apply(BF, r.to(f32)).to(r.dtype)
        else:
            fine = bmv(F32, r.reshape(cell_shape).to(f32)).to(r.dtype).reshape(r.shape)
        return fine + _coarse_apply(C, ci, r)

    def body(state):
        x, r, z, p, rz = state
        Ap = S.apply(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rzn = torch.sum(r * z)
        return [x, r, z, z + (rzn / rz) * p, rzn]

    t0 = time.perf_counter()
    bn = float(torch.linalg.norm(b.reshape(-1)))
    atol = tol * max(bn, 1e-300)
    z0 = M(b)
    state = [torch.zeros_like(b), b, z0, z0, torch.sum(b * z0)]
    it_total, rd, rn_best, since_best = 0, 0, np.inf, 0
    while it_total < maxiter:
        # chunk_iters iterations, each frozen by a device-side select once
        # r.r <= atol^2; the host reads |r| once per chunk
        for _ in range(chunk_iters):
            done = torch.sum(state[1] * state[1]) <= atol * atol
            state = [torch.where(done, a, n) for a, n in zip(state, body(state))]
        rn = float(torch.sqrt(torch.sum(state[1] * state[1])))
        it_total += chunk_iters
        rd += 1
        if verbose:
            logger.info(f"truth chunk {rd}: |r|/|b| {rn / bn:.2e}")
        if rn <= atol * 1.001:
            break
        if rn < 0.95 * rn_best:
            rn_best, since_best = rn, 0
        else:
            since_best += 1
            if since_best >= 6:
                logger.info(f"truth_solve: stalled (best |r|/|b| {rn_best / bn:.2e}) "
                            "— stopping")
                break
    x = state[0]
    _sync(x)
    t_solve = time.perf_counter() - t0
    rel = float(torch.linalg.norm((b - S.apply(x)).reshape(-1))) / max(bn, 1e-300)
    info = dict(relres=rel, it32=it_total, rounds=rd, it64=it_total, t_solve=t_solve,
                **timings)
    if verbose:
        logger.info(f"truth_solve: relres {rel:.2e}, f32 its {info['it32']} "
                    f"({info['rounds']} rounds, f64 polish {info['it64']}), assemble "
                    f"{t_asm:.1f} s, coarse {t_coarse:.1f} s, solve {t_solve:.1f} s")
    if not np.isfinite(rel) or rel > max(1e3 * tol, 1e-6):
        raise RuntimeError(f"truth_solve did not converge: relres {rel}")
    return x.double().cpu().numpy(), info
