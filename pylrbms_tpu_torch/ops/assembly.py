"""Batched assembly: volume and SWIPDG face blocks.

The port of ``pylrbms_tpu/ops/assembly.py`` (see its docstring for the
SWIPDG affine-factor integrands).  The quadrature-point geometry is computed
in float64 numpy from the reference's static tables and moved to the
requested device/dtype; the integrals are torch einsums.  JAX's functional
``A.at[idx].add(v)`` becomes :func:`add_at`, an in-place ``index_add_`` on
the flattened trailing axes (repeated indices accumulate).

All three 2D element families are covered: ``tri`` and ``quad`` share
cell-invariant tables, ``crisscross`` has per-cell tables ``[s, s, T, ...]``
that :func:`vol_ein` folds into the volume einsums.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# relative inward shift for one-sided coefficient evaluation at faces
# (handles discontinuous checkerboard/indicator coefficients robustly)
_EVAL_EPS = 1e-6


@dataclass(frozen=True)
class IPDGParams:
    """Copy of ``pylrbms_tpu.ops.assembly.IPDGParams`` (the reference module
    imports jax)."""
    beta: float = 1.0
    sigma_inner_by_order: tuple = (4.0, 8.0, 20.0, 38.0, 50.0)
    sigma_boundary_by_order: tuple = (4.0, 14.0, 38.0, 74.0, 100.0)

    def sigma_inner(self, order: int) -> float:
        return self.sigma_inner_by_order[min(order, len(self.sigma_inner_by_order) - 1)]

    def sigma_boundary(self, order: int) -> float:
        return self.sigma_boundary_by_order[min(order, len(self.sigma_boundary_by_order) - 1)]


DEFAULT_IPDG = IPDGParams()


def tensor(a, dtype=torch.float64, device=None) -> torch.Tensor:
    """numpy/array-like -> tensor on ``device`` with ``dtype``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def add_at(A: torch.Tensor, index, vals: torch.Tensor) -> torch.Tensor:
    """``A[..., *index] += vals`` in place, repeated indices accumulating
    (<-> ``A.at[..., *index].add(vals)``).  ``index`` is a tuple of
    broadcastable integer numpy arrays addressing the trailing
    ``len(index)`` axes of the contiguous ``A``."""
    nd = len(index)
    lead, tail = A.shape[:A.ndim - nd], A.shape[A.ndim - nd:]
    idx = [np.asarray(i, np.int64) for i in index]
    bshape = np.broadcast_shapes(*(i.shape for i in idx))
    flat = np.ravel_multi_index(tuple(np.broadcast_to(i, bshape) for i in idx), tail)
    v = vals.to(A.dtype).expand(tuple(lead) + tuple(bshape)).reshape(tuple(lead) + (-1,))
    A.view(tuple(lead) + (-1,)).index_add_(
        -1, torch.as_tensor(flat.ravel(), device=A.device), v)
    return A


def scatter_blocks(A, blocks, rows, cols):
    """A [..., N, M] += blocks [..., F, nr, nc] at (rows [F, nr], cols [F, nc])."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    return add_at(A, (rows[:, :, None], cols[:, None, :]), blocks)


def scatter_vec(b, vals, rows):
    """b [..., N] += vals [..., F, nr] at rows [F, nr]."""
    return add_at(b, (np.asarray(rows),), vals)


def vol_ein(space, expr: str) -> str:
    """Rewrite a volume einsum for per-cell tables ('crisscross'): every
    operand subscript that starts with 't' gains the 'yx' cell prefix (the
    tables are [s, s, T, ...] there)."""
    if not space.percell:
        return expr
    ins, out = expr.split("->")
    ops = [("yx" + o) if o.startswith("t") else o for o in ins.split(",")]
    return ",".join(ops) + "->" + out


# ---------------------------------------------------------------------------
# volume kernels
# ---------------------------------------------------------------------------

def vol_points(space) -> np.ndarray:
    """[K, s, s, T, nq, 2] physical volume quadrature points (float64)."""
    org = (space.subdomain_origins[:, None, None, :]
           + space.cell_origins_local[None, :, :, :])            # [K, s, s, 2]
    qp = space.vol_qp * np.array([space.hx, space.hy])   # [T, nq, 2] | [s,s,T,nq,2]
    if space.percell:
        return org[:, :, :, None, None, :] + qp[None]
    return org[:, :, :, None, None, :] + qp[None, None, None]


def volume_elliptic(space, lam_fn, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N, N]: int lam(x) grad(phi_i) . kappa(x) grad(phi_j) per subdomain."""
    xq = tensor(vol_points(space), dtype, device)              # [K,s,s,T,nq,2]
    lam = lam_fn(xq).to(dtype)                                 # [K,s,s,T,nq]
    dphi = tensor(space.vol_dphi, dtype, device)               # [T,nq,nb,2]
    w = tensor(space.vol_w, dtype, device)                     # [T,nq]
    area = space.hx * space.hy
    if kappa_fn is None:
        integ = torch.einsum(vol_ein(space, "tq,kyxtq,tqia,tqja->kyxtij"),
                             w, lam, dphi, dphi)
    else:
        kap = kappa_fn(xq).to(dtype)                           # [K,s,s,T,nq,2,2]
        integ = torch.einsum(vol_ein(space, "tq,kyxtq,tqia,kyxtqab,tqjb->kyxtij"),
                             w, lam, dphi, kap, dphi)
    return _scatter_cell_blocks(space, area * integ, dtype, device)


def volume_mass(space, weight_fn=None, dtype=torch.float64, device=None):
    """[K, N, N]: int w(x) phi_i phi_j."""
    phi = tensor(space.vol_phi, dtype, device)                 # [T,nq,nb]
    w = tensor(space.vol_w, dtype, device)
    area = space.hx * space.hy
    if weight_fn is None:
        if space.percell:
            elem = area * torch.einsum("yxtq,yxtqi,yxtqj->yxtij", w, phi, phi)
            elem = elem.expand((space.K,) + tuple(elem.shape))
        else:
            elem = area * torch.einsum("tq,tqi,tqj->tij", w, phi, phi)
            elem = elem.expand((space.K, space.s, space.s) + tuple(elem.shape))
    else:
        xq = tensor(vol_points(space), dtype, device)
        lam = weight_fn(xq).to(dtype)
        elem = area * torch.einsum(vol_ein(space, "tq,kyxtq,tqi,tqj->kyxtij"),
                                   w, lam, phi, phi)
    return _scatter_cell_blocks(space, elem, dtype, device)


def volume_functional(space, f_fn, dtype=torch.float64, device=None):
    """[K, N]: int f(x) phi_i."""
    xq = tensor(vol_points(space), dtype, device)
    f = f_fn(xq).to(dtype)                                     # [K,s,s,T,nq]
    phi = tensor(space.vol_phi, dtype, device)
    w = tensor(space.vol_w, dtype, device)
    area = space.hx * space.hy
    elem = area * torch.einsum(vol_ein(space, "tq,kyxtq,tqi->kyxti"), w, f, phi)
    return elem.reshape(space.K, space.N)                      # layout matches dof_index


def volume_scalar(space, f_fn, dtype=torch.float64, device=None):
    """[K]: int_subdomain f(x)."""
    xq = tensor(vol_points(space), dtype, device)
    f = f_fn(xq).to(dtype)
    w = tensor(space.vol_w, dtype, device)
    area = space.hx * space.hy
    return area * torch.einsum(vol_ein(space, "tq,kyxtq->k"), w, f)


def _scatter_cell_blocks(space, elem, dtype, device):
    """elem [K, s, s, T, nb, nb] -> block-diagonal-in-cells [K, N, N]."""
    K, N, nb = space.K, space.N, space.nb
    C = space.s * space.s * space.T
    rows = np.arange(N, dtype=np.int64).reshape(C, nb)
    A = torch.zeros((K, N, N), dtype=dtype, device=device)
    return scatter_blocks(A, elem.reshape(K, C, nb, nb), rows, rows)


# ---------------------------------------------------------------------------
# face kernels
# ---------------------------------------------------------------------------

def face_phys_points(space, tab, cy, cx, origins):
    """One-sided evaluation points at the face quadrature points for a batch
    of faces (float64 numpy): (x_m_eval, x_p_eval), each [K, F, nqf, 2];
    ``x_p_eval`` is None for boundary tabs.  cy, cx: [F] minus-side cell
    coords within the subdomain; origins [K, 2]."""
    scale = np.array([space.hx, space.hy])
    cell_org = np.stack([cx * space.hx, cy * space.hy], axis=-1)       # [F, 2]
    base = np.asarray(origins)[:, None, :] + cell_org[None, :, :]     # [K, F, 2]
    x = base[:, :, None, :] + (tab.pts_unit_m * scale)[None, None]
    cen_m = base[:, :, None, :] + (tab.centroid_m * scale)[None, None]
    x_m = x + _EVAL_EPS * (cen_m - x)
    if tab.phi_p is None:
        return x_m, None
    if np.allclose(tab.normal, [1.0, 0.0]):
        shift = np.array([space.hx, 0.0])
    elif np.allclose(tab.normal, [0.0, 1.0]):
        shift = np.array([0.0, space.hy])
    else:
        shift = np.zeros(2)
    cen_p = base[:, :, None, :] + (shift + tab.centroid_p * scale)[None, None]
    x_p = x + _EVAL_EPS * (cen_p - x)
    return x_m, x_p


def _omega_gamma(delta_m, delta_p):
    ssum = delta_m + delta_p
    nz = ssum != 0
    safe = torch.where(nz, ssum, torch.ones_like(ssum))
    om_m = torch.where(nz, delta_p / safe, torch.full_like(ssum, 0.5))
    om_p = torch.where(nz, delta_m / safe, torch.full_like(ssum, 0.5))
    gamma = torch.where(nz, delta_m * delta_p / safe, torch.zeros_like(ssum))
    return om_m, om_p, gamma


def _delta(kappa_fn, x, n, like):
    if kappa_fn is None:
        return torch.ones_like(like)
    return torch.einsum("...ab,a,b->...", kappa_fn(x).to(like.dtype), n, n)


def inner_face_blocks(space, tab, lam_fn, kappa_fn, x_m_eval, x_p_eval, order,
                      ipdg: IPDGParams = DEFAULT_IPDG, dtype=torch.float64,
                      device=None):
    """SWIPDG affine-factor blocks for a batch of inner faces:
    (Mmm, Mmp, Mpm, Mpp) each [K, F, nb, nb]."""
    n = tensor(tab.normal, dtype, device)
    w = tensor(tab.w, dtype, device)
    ell = tab.length
    phi_m = tensor(tab.phi_m, dtype, device)
    phi_p = tensor(tab.phi_p, dtype, device)
    dphi_m = tensor(tab.dphi_m, dtype, device)
    dphi_p = tensor(tab.dphi_p, dtype, device)
    x_m = tensor(x_m_eval, dtype, device)
    x_p = tensor(x_p_eval, dtype, device)

    lam_m = lam_fn(x_m).to(dtype)              # [K, F, nqf]
    lam_p = lam_fn(x_p).to(dtype)
    if kappa_fn is None:
        delta_m = torch.ones_like(lam_m)
        delta_p = torch.ones_like(lam_p)
        flux_m = lam_m[..., None] * torch.einsum("qja,a->qj", dphi_m, n)
        flux_p = lam_p[..., None] * torch.einsum("qja,a->qj", dphi_p, n)
    else:
        kap_m = kappa_fn(x_m).to(dtype)        # [K,F,nqf,2,2]
        kap_p = kappa_fn(x_p).to(dtype)
        delta_m = torch.einsum("...ab,a,b->...", kap_m, n, n)
        delta_p = torch.einsum("...ab,a,b->...", kap_p, n, n)
        flux_m = lam_m[..., None] * torch.einsum("kfqab,qjb,a->kfqj", kap_m, dphi_m, n)
        flux_p = lam_p[..., None] * torch.einsum("kfqab,qjb,a->kfqj", kap_p, dphi_p, n)

    om_m, om_p, gamma = _omega_gamma(delta_m, delta_p)
    pen = (ipdg.sigma_inner(order) * gamma * (om_m * lam_m + om_p * lam_p)
           / tab.pen_len ** ipdg.beta)
    wflux_m = om_m[..., None] * flux_m
    wflux_p = om_p[..., None] * flux_p

    def P(phi_i, phi_j, sgn):      # penalty term
        return sgn * ell * torch.einsum("q,kfq,qi,qj->kfij", w, pen, phi_i, phi_j)

    def Cj(wflux, phi_i, sgn):     # -{grad u}[v]: trial flux x test trace
        return sgn * ell * torch.einsum("q,kfqj,qi->kfij", w, wflux, phi_i)

    def Ci(wflux, phi_j, sgn):     # -{grad v}[u]: test flux x trial trace
        return sgn * ell * torch.einsum("q,kfqi,qj->kfij", w, wflux, phi_j)

    Mmm = P(phi_m, phi_m, +1) + Cj(wflux_m, phi_m, -1) + Ci(wflux_m, phi_m, -1)
    Mmp = P(phi_m, phi_p, -1) + Cj(wflux_p, phi_m, -1) + Ci(wflux_m, phi_p, +1)
    Mpm = P(phi_p, phi_m, -1) + Cj(wflux_m, phi_p, +1) + Ci(wflux_p, phi_m, -1)
    Mpp = P(phi_p, phi_p, +1) + Cj(wflux_p, phi_p, +1) + Ci(wflux_p, phi_p, +1)
    return Mmm, Mmp, Mpm, Mpp


def boundary_face_blocks(space, tab, lam_fn, kappa_fn, x_m_eval, order,
                         ipdg: IPDGParams = DEFAULT_IPDG, dtype=torch.float64,
                         device=None):
    """Dirichlet-penalty boundary blocks [K, F, nb, nb]."""
    n = tensor(tab.normal, dtype, device)
    w = tensor(tab.w, dtype, device)
    ell = tab.length
    phi = tensor(tab.phi_m, dtype, device)
    dphi = tensor(tab.dphi_m, dtype, device)
    x_m = tensor(x_m_eval, dtype, device)
    lam = lam_fn(x_m).to(dtype)
    if kappa_fn is None:
        delta = torch.ones_like(lam)
        flux = lam[..., None] * torch.einsum("qja,a->qj", dphi, n)
    else:
        kap = kappa_fn(x_m).to(dtype)
        delta = torch.einsum("...ab,a,b->...", kap, n, n)
        flux = lam[..., None] * torch.einsum("kfqab,qjb,a->kfqj", kap, dphi, n)
    pen = ipdg.sigma_boundary(order) * delta * lam / tab.pen_len ** ipdg.beta
    return (ell * torch.einsum("q,kfq,qi,qj->kfij", w, pen, phi, phi)
            - ell * torch.einsum("q,kfqj,qi->kfij", w, flux, phi)
            - ell * torch.einsum("q,kfqi,qj->kfij", w, flux, phi))


def penalty_face_blocks_inner(space, tab, lam_fn, kappa_fn, x_m_eval, x_p_eval,
                              order, ipdg=DEFAULT_IPDG, dtype=torch.float64,
                              device=None):
    """Penalty-only inner face blocks (the local energy DG product)."""
    n = tensor(tab.normal, dtype, device)
    w = tensor(tab.w, dtype, device)
    ell = tab.length
    phi_m = tensor(tab.phi_m, dtype, device)
    phi_p = tensor(tab.phi_p, dtype, device)
    x_m = tensor(x_m_eval, dtype, device)
    x_p = tensor(x_p_eval, dtype, device)
    lam_m = lam_fn(x_m).to(dtype)
    lam_p = lam_fn(x_p).to(dtype)
    delta_m = _delta(kappa_fn, x_m, n, lam_m)
    delta_p = _delta(kappa_fn, x_p, n, lam_p)
    om_m, om_p, gamma = _omega_gamma(delta_m, delta_p)
    pen = (ipdg.sigma_inner(order) * gamma * (om_m * lam_m + om_p * lam_p)
           / tab.pen_len ** ipdg.beta)

    def P(phi_i, phi_j, sgn):
        return sgn * ell * torch.einsum("q,kfq,qi,qj->kfij", w, pen, phi_i, phi_j)

    return P(phi_m, phi_m, +1), P(phi_m, phi_p, -1), P(phi_p, phi_m, -1), P(phi_p, phi_p, +1)


def penalty_face_blocks_boundary(space, tab, lam_fn, kappa_fn, x_m_eval,
                                 order, ipdg=DEFAULT_IPDG, dtype=torch.float64,
                                 device=None):
    """Penalty-only boundary blocks [K, F, nb, nb]."""
    n = tensor(tab.normal, dtype, device)
    w = tensor(tab.w, dtype, device)
    ell = tab.length
    phi = tensor(tab.phi_m, dtype, device)
    x_m = tensor(x_m_eval, dtype, device)
    lam = lam_fn(x_m).to(dtype)
    delta = _delta(kappa_fn, x_m, n, lam)
    pen = ipdg.sigma_boundary(order) * delta * lam / tab.pen_len ** ipdg.beta
    return ell * torch.einsum("q,kfq,qi,qj->kfij", w, pen, phi, phi)
