"""Affine block operator algebra + solvers (main-path part).

The port of ``pylrbms_tpu/la/block.py``:

  A(mu) = sum_q theta_q(mu) * [ diag blocks  A_diag[q]  (K, N, N)
                              + couplings    C_*[q]     (E, s, nb, nb) ]

Couplings live only on the interface boundary layer and are stored
block-diagonal per face.  The diagonal-block products go through the
hand-written :func:`~pylrbms_tpu_torch.ops.hopper_kernels.block_matvec`
and the block-Jacobi apply of PCG through the fused
:func:`~pylrbms_tpu_torch.ops.hopper_kernels.precond_dot`; the interface
gather/scatter-add and the coarse matvec stay plain torch.

Of every backend gate of the JAX module the CPU branch is taken: there are
no f64-on-TPU workarounds (f32 inversion of f64 blocks, Newton-Schulz or
refined dense solves) — an H100 has native f64 LU.  The host-side steps stay
numpy/scipy with the same seeded RNG draws, QRs and eigh pseudo-inverse as
the reference, so the coarse bases match it to rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.hopper_kernels import block_matvec, precond_dot
from ..ops.swipdg import edge_lists, fold_diag
from ..ops.swipdg3d import edge_lists3, fold_diag3, SIDES as SIDES3
from ..ops.assembly import add_at
from ..ops.matrixfree import coarse_level
from .krylov import lane_dot, pcg_chunked


@dataclass(eq=False)
class BlockOpStatic:
    """Static index metadata shared by all affine components.

    2D grids use the R (x-pairs) and U (y-pairs) coupling families; the 3D
    'hex' family adds the W (z-pairs) family (``near_k``/``far_k``,
    ``side_rows['near'/'far']``).  Interface strips are [E, F, nb, nb] with
    F faces per subdomain interface (s in 2D, s^2 in 3D)."""
    K: int
    N: int
    s: int
    nb: int
    kx: int
    ky: int
    side_rows: dict            # side -> [F, nb] dof indices (numpy)
    left_k: np.ndarray         # [E_R]
    right_k: np.ndarray
    low_k: np.ndarray          # [E_U]
    up_k: np.ndarray
    kz: int = 1
    near_k: np.ndarray = None  # [E_W] (3D z-pairs; None in 2D)
    far_k: np.ndarray = None
    _flat: dict = field(default_factory=dict, repr=False)

    @property
    def dim3(self) -> bool:
        return self.near_k is not None

    @staticmethod
    def from_space(space) -> "BlockOpStatic":
        if getattr(space, "dim", 2) == 3:
            return BlockOpStatic.from_space3(space)
        side_rows = {side: space.side_dofs(side).reshape(space.s, space.nb)
                     for side in ("left", "right", "bottom", "top")}
        left_k, right_k, low_k, up_k = edge_lists(space.grid)
        return BlockOpStatic(K=space.K, N=space.N, s=space.s, nb=space.nb,
                             kx=space.grid.kx, ky=space.grid.ky,
                             side_rows=side_rows, left_k=left_k, right_k=right_k,
                             low_k=low_k, up_k=up_k)

    @staticmethod
    def from_space3(space) -> "BlockOpStatic":
        F = space.s * space.s
        side_rows = {side: space.side_dofs(side).reshape(F, space.nb)
                     for side in SIDES3}
        xlo, xhi, ylo, yhi, zlo, zhi = edge_lists3(space.grid)
        return BlockOpStatic(K=space.K, N=space.N, s=space.s, nb=space.nb,
                             kx=space.grid.kx, ky=space.grid.ky,
                             kz=space.grid.kz, side_rows=side_rows,
                             left_k=xlo, right_k=xhi, low_k=ylo, up_k=yhi,
                             near_k=zlo, far_k=zhi)

    def families(self):
        """(name, rows_out side, rows_in side, k_out, k_in) per coupling
        family; ``name`` is the coupling tensor's attribute stem."""
        fams = (("C_R_io", "right", "left", self.left_k, self.right_k),
                ("C_R_oi", "left", "right", self.right_k, self.left_k),
                ("C_U_io", "top", "bottom", self.low_k, self.up_k),
                ("C_U_oi", "bottom", "top", self.up_k, self.low_k))
        if self.dim3:
            fams += (("C_W_io", "far", "near", self.near_k, self.far_k),
                     ("C_W_oi", "near", "far", self.far_k, self.near_k))
        return fams

    def names(self):
        """The coupling tensors' attribute stems, in ``families()`` order."""
        return tuple(f[0] for f in self.families())

    def flat_rows(self, device):
        """Per family the flat ``[K*N]`` indices (out, in), each [E, s, nb],
        as tensors on ``device`` (built once per device)."""
        key = str(torch.device(device))
        if key not in self._flat:
            sr, N = self.side_rows, self.N
            self._flat[key] = {
                name: (torch.as_tensor(k_out[:, None, None] * N + sr[ro][None], device=device),
                       torch.as_tensor(k_in[:, None, None] * N + sr[ri][None], device=device))
                for name, ro, ri, k_out, k_in in self.families()}
        return self._flat[key]


def _couple(y, xb, C, flat_out, flat_in, coef=None):
    """y [b, K, N] += coupling C applied to xb [b, K, N]; C [E, s, nb, nb],
    or the affine stack [Q, E, s, nb, nb] contracted with coef [b, Q]."""
    if flat_out.numel() == 0:
        return y
    b = xb.shape[0]
    xi = xb.reshape(b, -1)[:, flat_in]                         # [b, E, s, nb]
    if coef is None:
        upd = torch.einsum("efij,befj->befi", C, xi)
    else:
        upd = torch.einsum("bq,qefij,befj->befi", coef, C, xi)
    y.view(b, -1).index_add_(1, flat_out.reshape(-1), upd.reshape(b, -1))
    return y


@dataclass
class AffineBlockOp:
    """Affine family of block operators (diag + interface couplings)."""
    static: BlockOpStatic
    A_diag: torch.Tensor        # [Q, K, N, N]
    C_R_io: torch.Tensor        # [Q, E_R, s, nb, nb]
    C_R_oi: torch.Tensor
    C_U_io: torch.Tensor
    C_U_oi: torch.Tensor
    C_W_io: torch.Tensor = None  # [Q, E_W, F, nb, nb] (3D z-pairs; None in 2D)
    C_W_oi: torch.Tensor = None

    @property
    def Q(self) -> int:
        return self.A_diag.shape[0]

    @staticmethod
    def from_components(space, comps, dtype=torch.float64) -> "AffineBlockOp":
        """The affine family of ``comps``.  ``dtype`` is accepted as the
        reference's is and, like it, unused: the stacks keep the
        components' dtype."""
        st = BlockOpStatic.from_space(space)
        stack = lambda f: torch.stack([f(c) for c in comps])   # noqa: E731
        if st.dim3:
            return AffineBlockOp(st, stack(lambda c: fold_diag3(space, c)),
                                 stack(lambda c: c.X_in_out), stack(lambda c: c.X_out_in),
                                 stack(lambda c: c.Y_in_out), stack(lambda c: c.Y_out_in),
                                 stack(lambda c: c.Z_in_out), stack(lambda c: c.Z_out_in))
        return AffineBlockOp(st, stack(lambda c: fold_diag(space, c)),
                             stack(lambda c: c.R_in_out), stack(lambda c: c.R_out_in),
                             stack(lambda c: c.U_in_out), stack(lambda c: c.U_out_in))

    def couplings(self) -> dict:
        """{name: [Q, E, F, nb, nb]} for every coupling family."""
        return {name: getattr(self, name) for name in self.static.names()}

    def assemble(self, theta) -> "AssembledBlockOp":
        """sum_q theta_q * components (theta [Q])."""
        theta = torch.as_tensor(theta).to(self.A_diag)
        return AssembledBlockOp(
            static=self.static,
            A_diag=torch.einsum("q,qkij->kij", theta, self.A_diag),
            **{name: torch.einsum("q,qefij->efij", theta, C)
               for name, C in self.couplings().items()})


def _lanes(x, st):
    single = x.ndim == 2
    return single, (x[None] if single else x.reshape((-1, st.K, st.N))).contiguous()


@dataclass
class AssembledBlockOp:
    static: BlockOpStatic
    A_diag: torch.Tensor        # [K, N, N]
    C_R_io: torch.Tensor        # [E_R, F, nb, nb]
    C_R_oi: torch.Tensor
    C_U_io: torch.Tensor
    C_U_oi: torch.Tensor
    C_W_io: torch.Tensor = None  # [E_W, F, nb, nb] (3D; None in 2D)
    C_W_oi: torch.Tensor = None

    def couplings(self) -> dict:
        """{name: [E, F, nb, nb]} for every coupling family."""
        return {name: getattr(self, name) for name in self.static.names()}

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [K, N] (or [..., K, N]) -> A x."""
        st = self.static
        single, xb = _lanes(x, st)
        y = block_matvec(self.A_diag[None], xb)
        flat = st.flat_rows(xb.device)
        for name, *_ in st.families():
            y = _couple(y, xb, getattr(self, name), *flat[name])
        return y[0] if single else y.reshape(x.shape)

    def to_dense(self) -> torch.Tensor:
        """Global [K*N, K*N] matrix."""
        st = self.static
        K, N = st.K, st.N
        G = torch.zeros((K, K, N, N), dtype=self.A_diag.dtype, device=self.A_diag.device)
        ar = torch.arange(K, device=G.device)
        G[ar, ar] = self.A_diag
        sr = st.side_rows
        for name, ro, ri, k_r, k_c in st.families():
            if k_r.size:
                add_at(G, (k_r[:, None, None, None], k_c[:, None, None, None],
                           sr[ro][None, :, :, None], sr[ri][None, :, None, :]),
                       getattr(self, name))
        return G.permute(0, 2, 1, 3).reshape(K * N, K * N)

    def solve_dense(self, b: torch.Tensor) -> torch.Tensor:
        """Direct global LU solve; b [K, N] or [..., K, N]."""
        st = self.static
        bb = b.to(self.A_diag.dtype).reshape(-1, st.K * st.N)
        x = torch.linalg.solve(self.to_dense(), bb.T).T
        return x.reshape(b.shape)

    def block_jacobi_factors(self):
        """Jacobi-scaled explicit inverses of the diagonal blocks [K, N, N]."""
        return block_jacobi_factors(self.A_diag)

    @staticmethod
    def coarse_modes_basis(space, modes: int = 3) -> np.ndarray:
        """Per-subdomain coarse basis [K, N, modes] (nodal interpolants of
        centered-scaled monomials): 1 | x, y | xy, x^2, y^2 (modes <= 6);
        in 3D 1 | x, y, z | xy, xz, yz, x^2, y^2, z^2 (modes <= 10)."""
        K, N = space.K, space.N
        dim = getattr(space, "dim", 2)
        if space.s < 2:
            modes = min(modes, dim + 1)
        modes = min(modes, 10 if dim == 3 else 6)
        C = np.ones((K, N, modes))
        if modes > 1:
            xn = space.node_coords_phys().reshape(K, N, dim)
            org = space.subdomain_origins
            w = space.s * np.array([space.hx, space.hy, getattr(space, "hz", 0.0)][:dim])
            ctr = org + w / 2.0
            Xl = (xn - ctr[:, None, :]) / w
            if dim == 3:
                x, y, z = Xl[..., 0], Xl[..., 1], Xl[..., 2]
                cols = [x, y, z, x * y, x * z, y * z, x * x, y * y, z * z]
            else:
                x, y = Xl[..., 0], Xl[..., 1]
                cols = [x, y, x * y, x * x, y * y]
            for j in range(1, modes):
                C[:, :, j] = cols[j - 1]
        return C

    def coarse_matrix(self) -> torch.Tensor:
        """Galerkin coarse matrix on the subdomain-constant space:
        A0[k, k'] = 1_k^T A 1_k'  ([K, K])."""
        st = self.static
        K = st.K
        A0 = torch.zeros((K * K,), dtype=self.A_diag.dtype, device=self.A_diag.device)
        ar = torch.arange(K, device=A0.device)
        A0[ar * K + ar] = self.A_diag.sum(dim=(1, 2))
        for name, _ro, _ri, k_r, k_c in st.families():
            if k_r.size:
                A0.index_add_(0, torch.as_tensor(k_r * K + k_c, device=A0.device),
                              getattr(self, name).sum(dim=(1, 2, 3)))
        return A0.reshape(K, K)

    def coarse_matrix_general(self, C) -> torch.Tensor:
        """Galerkin coarse matrix on a per-subdomain basis C [K, N, m]:
        Ac[(k,i),(k',j)] = C_k[:,i]^T A_{kk'} C_k'[:,j]  ([K*m, K*m]),
        block-sparse from the diagonal blocks and the interface strips."""
        st = self.static
        C = torch.as_tensor(C).to(self.A_diag)
        K, N, m = C.shape
        diag = torch.einsum("kni,knl,klj->kij", C, self.A_diag, C)
        Ac = torch.zeros((K, K, m, m), dtype=C.dtype, device=C.device)
        ar = torch.arange(K, device=C.device)
        Ac[ar, ar] = diag
        Cf = C.reshape(K * N, m)
        flat = st.flat_rows(C.device)
        for name, _ro, _ri, k_out, k_in in st.families():
            if k_out.size == 0:
                continue
            f_out, f_in = flat[name]
            blk = torch.einsum("esai,esab,esbj->eij", Cf[f_out], getattr(self, name), Cf[f_in])
            Ac.view(K * K, m, m).index_add_(
                0, torch.as_tensor(k_out * K + k_in, device=C.device), blk)
        return Ac.permute(0, 2, 1, 3).reshape(K * m, K * m)

    def geneo_basis(self, M_diag, modes: int = 6) -> np.ndarray:
        """Spectral (GenEO-style) coarse basis of this assembled operator;
        see :func:`geneo_coarse_basis`."""
        return geneo_coarse_basis(self.A_diag, M_diag, modes)

    def solve_pcg(self, b, tol: float = 1e-12, maxiter: int = 2000, factors=None,
                  two_level: bool = False, coarse_inv=None, coarse_basis=None,
                  return_iters: bool = False, coarse_f32: bool = False):
        """Block-Jacobi preconditioned CG, optionally with an additive coarse
        level; see :func:`solve_pcg`."""
        return solve_pcg(self, b, tol, maxiter, factors, two_level, coarse_inv,
                         coarse_basis, return_iters, coarse_f32)

    def solve(self, b, options: dict | None = None):
        options = options or {}
        kind = options.get("type", "auto")
        if kind == "auto":
            kind = "dense" if self.static.K * self.static.N <= 6144 else "pcg"
        if kind in ("dense", "direct"):
            return self.solve_dense(b)
        return self.solve_pcg(b, tol=options.get("precision", 1e-12),
                              maxiter=options.get("max_iter", 2000))


def block_jacobi_factors(A_diag: torch.Tensor) -> torch.Tensor:
    """Jacobi-scaled explicit inverses of diagonal blocks [..., K, N, N]:
    M^-1 = S inv(S A S) S with S = diag(A)^{-1/2}."""
    dvec = torch.abs(torch.diagonal(A_diag, dim1=-2, dim2=-1))
    s = 1.0 / torch.sqrt(torch.clamp(dvec, min=1e-300))
    S = s[..., :, None] * s[..., None, :]
    return torch.linalg.inv(A_diag * S) * S


def solve_pcg(op, b, tol=1e-12, maxiter=2000, factors=None, two_level=False,
              coarse_inv=None, coarse_basis=None, return_iters=False,
              coarse_f32=False):
    """Block-Jacobi preconditioned CG on ``op`` (an :class:`AssembledBlockOp`
    or :class:`AffineBlockApply`) for b [K, N] or lanes [B, K, N].

    ``factors`` (default: the operator's own block-Jacobi factors) may be
    stored in bfloat16; the fused ``precond_dot`` kernel then widens each
    element and accumulates in the vector's type.  An additive coarse level:
    ``two_level`` builds the subdomain-constant one from ``op``
    (``coarse_matrix()`` inverted in f64); ``coarse_inv`` passes a prebuilt
    inverse, [K, K] for subdomain constants (applied as the basis of ones)
    or [K*m, K*m] together with ``coarse_basis`` [K, N, m].  The coarse
    level is applied in f32 when the operator is f32 or ``coarse_f32`` is
    set, else in the operator dtype.  The CG scalar is
    ``rz.sum(-1) + r . z_c`` — the reference's ``vdot(r, M(r))`` up to
    summation order.  Returns x (and the per-lane iteration counts with
    ``return_iters``)."""
    st = op.static
    dt = op.A_diag.dtype
    b = b.to(dt)
    Ainv = factors if factors is not None else op.block_jacobi_factors()
    if Ainv.dtype != torch.bfloat16:
        Ainv = Ainv.to(dt)
    Ainv = Ainv.contiguous()
    single, bb = _lanes(b, st)

    if two_level and coarse_inv is None:
        coarse_inv = torch.linalg.inv(op.coarse_matrix().to(torch.float64))
    coarse = None
    if coarse_inv is not None:
        cdt = torch.float32 if (dt == torch.float32 or coarse_f32) else dt
        if coarse_basis is None:
            # subdomain constants as the one-column basis of ones: the same
            # arithmetic as a caller's ones basis, not a second route
            coarse_basis = torch.ones((st.K, st.N, 1), dtype=cdt, device=bb.device)
        coarse = coarse_level(coarse_inv, coarse_basis, cdt)

    def M(r):
        z, rz = precond_dot(Ainv, r)
        if coarse is None:
            return z, rz.sum(-1)
        zc = coarse(r)
        return z + zc, rz.sum(-1) + lane_dot(r, zc)

    x, it = pcg_chunked(op.apply, M, bb, tol, maxiter)
    if single:
        x, it = x[0], it[0]
    else:
        x = x.reshape(b.shape)
    return (x, it) if return_iters else x


@dataclass(eq=False)
class AffineBlockApply:
    """Affine-family apply y = sum_q theta_q (A_q x) without materializing
    A(theta): one :func:`block_matvec` launch with G=Q streams the affine
    stacks once per CG iteration for all lanes, with a per-lane theta
    ([B, Q], or [Q] shared)."""
    static: BlockOpStatic
    A_q: torch.Tensor           # [Q, K, N, N]
    C_R_io_q: torch.Tensor      # [Q, E_R, F, nb, nb]
    C_R_oi_q: torch.Tensor
    C_U_io_q: torch.Tensor
    C_U_oi_q: torch.Tensor
    theta: torch.Tensor         # [Q] or [B, Q]
    C_W_io_q: torch.Tensor = None  # [Q, E_W, F, nb, nb] (3D; None in 2D)
    C_W_oi_q: torch.Tensor = None

    @property
    def A_diag(self):          # duck-typing for the shared solve_pcg
        return self.A_q

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x [K, N] (or [B, K, N]) -> A(theta) x, affine-contracted."""
        st = self.static
        single, xb = _lanes(x, st)
        th = self.theta.to(xb.dtype)
        coef = (th.expand(xb.shape[0], -1) if th.ndim == 1 else th).contiguous()
        y = block_matvec(self.A_q, xb, coef)
        flat = st.flat_rows(xb.device)
        for name, *_ in st.families():
            y = _couple(y, xb, getattr(self, name + "_q"), *flat[name], coef=coef)
        return y[0] if single else y.reshape(x.shape)

    def block_jacobi_factors(self):
        """Factors of the theta-contracted diagonal blocks (single theta)."""
        if self.theta.ndim != 1:
            raise ValueError("block_jacobi_factors needs a single theta [Q]")
        A_diag = torch.einsum("q,qkij->kij", self.theta.to(self.A_q.dtype), self.A_q)
        return block_jacobi_factors(A_diag)

    solve_pcg = AssembledBlockOp.solve_pcg


def to_scipy_csr(op: AssembledBlockOp):
    """Export the assembled block operator as a float64 scipy CSR matrix
    without materializing the dense global matrix (CPU baselines/oracles)."""
    import scipy.sparse as sp
    st = op.static
    K, N = st.K, st.N
    blocks = [[None] * K for _ in range(K)]
    A_diag = op.A_diag.detach().to("cpu", torch.float64).numpy()
    for k in range(K):
        blocks[k][k] = sp.csr_matrix(A_diag[k])
    sr = st.side_rows
    for name, ro, ri, k_r, k_c in st.families():
        C = getattr(op, name).detach().to("cpu", torch.float64).numpy()
        rows, cols = sr[ro], sr[ri]
        for e, (kr, kc) in enumerate(zip(k_r, k_c)):
            Mx = np.zeros((N, N))
            for f in range(rows.shape[0]):
                Mx[np.ix_(rows[f], cols[f])] += C[e, f]
            Bm = sp.csr_matrix(Mx)
            blocks[kr][kc] = Bm if blocks[kr][kc] is None else blocks[kr][kc] + Bm
    return sp.bmat(blocks, format="csr")


def geneo_coarse_basis(A_neumann, M_diag, modes: int = 6) -> np.ndarray:
    """Per-subdomain spectral (GenEO-style) coarse basis [K, N, modes]: the
    ``modes`` lowest generalized eigenvectors of (A^Neu_kk, M_kk),
    M-orthonormal (host scipy, float64)."""
    import scipy.linalg as sla
    A = np.asarray(_np64(A_neumann))
    M = np.asarray(_np64(M_diag))
    K, N, _ = A.shape
    m = min(modes, N)
    C = np.zeros((K, N, m))
    for k in range(K):
        Ak = 0.5 * (A[k] + A[k].T)
        Mk = 0.5 * (M[k] + M[k].T)
        _, vecs = sla.eigh(Ak, Mk, subset_by_index=[0, m - 1])
        C[k] = vecs
    return C


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def prepare_coarse(A: AssembledBlockOp, C):
    """Condition and invert a two-level coarse space for ``solve_pcg``:
    columns normalized to unit block energy, the Galerkin matrix (device, in
    the operator dtype) inverted on the host in float64 by a Jacobi-scaled
    eigh pseudo-inverse.  Returns ``(C, Ac_inv)`` on the operator's device
    (C in the operator dtype, the inverse in f64 for f64 operators and f32
    otherwise)."""
    dt, dev = A.A_diag.dtype, A.A_diag.device
    C = np.asarray(C, np.float64)
    Ad = _np64(A.A_diag)
    e = np.einsum("knm,knj,kmj->kj", Ad, C, C)                  # [K, m]
    C = C / np.sqrt(np.maximum(np.abs(e), 1e-300))[:, None, :]
    Ac = _np64(A.coarse_matrix_general(torch.as_tensor(C, dtype=dt, device=dev)))
    sd = 1.0 / np.sqrt(np.maximum(np.abs(np.diag(Ac)), 1e-300))
    S = 0.5 * (Ac + Ac.T) * sd[:, None] * sd[None, :]
    w, Qm = np.linalg.eigh(S)
    cut = 1e-12 * max(float(w.max()), 1e-300)
    winv = np.where(w > cut, 1.0 / np.maximum(w, cut), 0.0)
    inv = (Qm * winv) @ Qm.T
    inv = inv * sd[:, None] * sd[None, :]
    inv_dt = torch.float64 if dt == torch.float64 else torch.float32
    return (torch.as_tensor(C, dtype=dt, device=dev),
            torch.as_tensor(inv, dtype=inv_dt, device=dev))


def harvested_coarse_basis(A: AssembledBlockOp, factors, space,
                           n_harvest: int = 16, extra_modal: int = 3,
                           rounds: int = 3, deg: int = 30,
                           interval=None, seed: int = 0) -> np.ndarray:
    """Spectral coarse space harvested from the operator itself
    [K, N, extra_modal + n_harvest]: Chebyshev-filtered subspace iteration
    on the block-Jacobi preconditioned operator M^-1 A (the M^-1 apply is a
    :func:`block_matvec` launch with one lane per harvested vector), split
    per subdomain, plus ``extra_modal`` polynomial modes, per-subdomain QR.
    The RNG draws are the reference's (``default_rng(seed + 1)`` for the
    power iteration, ``default_rng(seed)`` for the block)."""
    K, N = space.K, space.N
    dt, dev = A.A_diag.dtype, A.A_diag.device
    Ainv = factors.to(dt)[None].contiguous()

    def pa(X):                                   # X [v, K, N]
        return block_matvec(Ainv, A.apply(X).contiguous())

    if interval is None:
        rng0 = np.random.default_rng(seed + 1)
        v = torch.as_tensor(rng0.normal(size=(K, N)), dtype=dt, device=dev)
        lam = torch.zeros((), dtype=dt, device=dev)
        for _ in range(30):
            w = pa(v[None])[0]
            lam = torch.sqrt(torch.sum(w * w))
            v = w / torch.clamp(lam, min=1e-300)
        bnd = 1.15 * float(lam)
        interval = ((0.25 / 2.05) * bnd, bnd)
    a, bnd = interval
    e = (bnd + a) / 2.0
    c = (bnd - a) / 2.0

    def filt(V, e_, c_):
        Vm1, Vc = V, (pa(V) - e_ * V) / c_
        for _ in range(deg - 1):
            Vm1, Vc = Vc, 2.0 * (pa(Vc) - e_ * Vc) / c_ - Vm1
        return Vc

    rng = np.random.default_rng(seed)
    V = torch.as_tensor(rng.normal(size=(n_harvest, K, N)), dtype=dt, device=dev)
    ec = (e, c)
    for _ in range(rounds):
        Vh = _np64(filt(V, *ec))
        if not np.isfinite(Vh).all():
            # residual spectrum above the band overwhelmed the filter —
            # widen once and refilter from fresh noise
            ec = (ec[0] + ec[1], 2.0 * ec[1])
            Vh = _np64(filt(torch.as_tensor(rng.normal(size=(n_harvest, K, N)),
                                            dtype=dt, device=dev), *ec))
            if not np.isfinite(Vh).all():
                raise FloatingPointError(
                    "harvested coarse filter overflow even after widening "
                    "the Chebyshev band — lambda_max estimate unreliable")
        Qm, _ = np.linalg.qr(Vh.reshape(n_harvest, -1).T)
        V = torch.as_tensor(Qm.T.reshape(n_harvest, K, N), dtype=dt, device=dev)
    cols = [np.moveaxis(_np64(V), 0, -1)]                       # [K, N, nh]
    if extra_modal:
        cols.insert(0, AssembledBlockOp.coarse_modes_basis(space, extra_modal))
    Cm = np.concatenate(cols, axis=-1)
    return np.stack([np.linalg.qr(Cm[k])[0] for k in range(K)])


def neumann_blocks(d, theta_bar) -> np.ndarray:
    """[K, N, N] subdomain-Neumann SWIPDG matrix at theta_bar:
    sum_q theta_bar_q * components[q].A_loc (float64 numpy)."""
    th = _np64(theta_bar)
    return sum(float(t) * _np64(c.A_loc) for t, c in zip(th, d.components))


def unblock(x):
    """[..., K, N] -> [..., K*N]."""
    return x.reshape(x.shape[:-2] + (-1,))


def reblock(x, K: int, N: int):
    """[..., K*N] -> [..., K, N]."""
    return x.reshape(x.shape[:-1] + (K, N))
