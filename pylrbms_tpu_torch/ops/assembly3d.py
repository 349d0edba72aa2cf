"""Batched 3D assembly kernels: hex volume terms + face geometry.

The port of ``pylrbms_tpu/ops/assembly3d.py``, the 3D counterpart of
``ops/assembly.py`` for the 'hex' grid family (``grid3d.py`` /
``ops/spaces3d.py``).  The face SWIPDG kernels of ``ops/assembly.py`` are
dimension-agnostic (they take FaceTab tables, with ``length`` = physical
face area here, and one-sided evaluation points of any dimension), so only
the volume kernels and the face point geometry are written again.

Cells are enumerated by a flat axis ``c = (cz*s + cy)*s + cx`` (T = 1),
matching the dof layout of :class:`ops.spaces3d.BlockDGSpace3D`.
"""
from __future__ import annotations

import numpy as np
import torch

from .assembly import scatter_blocks, tensor, _EVAL_EPS


# ---------------------------------------------------------------------------
# volume kernels
# ---------------------------------------------------------------------------

def vol_points(space, dtype=torch.float64, device=None) -> torch.Tensor:
    """[K, C, nq, 3] physical volume quadrature points (C = s^3), built by
    broadcasting O(K + C + nq) static tables on ``device``."""
    C = space.s ** 3
    org = (tensor(space.subdomain_origins, dtype, device)[:, None, :]
           + tensor(space.cell_origins_local.reshape(C, 3), dtype, device)[None])
    qp = tensor(space.vol_qp * np.array([space.hx, space.hy, space.hz]), dtype, device)
    return org[:, :, None, :] + qp[None, None]


def volume_elliptic(space, lam_fn, kappa_fn=None, dtype=torch.float64, device=None):
    """[K, N, N]: int lam(x) grad(phi_i) . kappa(x) grad(phi_j)."""
    xq = vol_points(space, dtype, device)                      # [K, C, nq, 3]
    lam = lam_fn(xq).to(dtype)                                 # [K, C, nq]
    dphi = tensor(space.vol_dphi, dtype, device)               # [nq, nb, 3]
    w = tensor(space.vol_w, dtype, device)                     # [nq]
    if kappa_fn is None:
        G = torch.einsum("q,qia,qja->qij", w, dphi, dphi)      # [nq, nb, nb]
        integ = torch.einsum("kcq,qij->kcij", lam, G)
    else:
        kap = kappa_fn(xq).to(dtype)                           # [K, C, nq, 3, 3]
        integ = torch.einsum("q,kcq,qia,kcqab,qjb->kcij", w, lam, dphi, kap, dphi)
    return _scatter_cell_blocks(space, space.volume * integ, dtype, device)


def volume_mass(space, weight_fn=None, dtype=torch.float64, device=None):
    """[K, N, N]: int w(x) phi_i phi_j."""
    phi = tensor(space.vol_phi, dtype, device)                 # [nq, nb]
    w = tensor(space.vol_w, dtype, device)
    C = space.s ** 3
    if weight_fn is None:
        elem = space.volume * torch.einsum("q,qi,qj->ij", w, phi, phi)
        elem = elem.expand((space.K, C) + tuple(elem.shape))
    else:
        lam = weight_fn(vol_points(space, dtype, device)).to(dtype)
        elem = space.volume * torch.einsum("q,kcq,qi,qj->kcij", w, lam, phi, phi)
    return _scatter_cell_blocks(space, elem, dtype, device)


def volume_functional(space, f_fn, dtype=torch.float64, device=None):
    """[K, N]: int f(x) phi_i."""
    f = f_fn(vol_points(space, dtype, device)).to(dtype)       # [K, C, nq]
    phi = tensor(space.vol_phi, dtype, device)
    w = tensor(space.vol_w, dtype, device)
    elem = space.volume * torch.einsum("q,kcq,qi->kci", w, f, phi)
    return elem.reshape(space.K, space.N)


def volume_scalar(space, f_fn, dtype=torch.float64, device=None):
    """[K]: int_subdomain f(x)."""
    f = f_fn(vol_points(space, dtype, device)).to(dtype)
    w = tensor(space.vol_w, dtype, device)
    return space.volume * torch.einsum("q,kcq->k", w, f)


def _scatter_cell_blocks(space, elem, dtype, device):
    """elem [K, C, nb, nb] -> block-diagonal-in-cells [K, N, N]."""
    K, N, nb = space.K, space.N, space.nb
    C = space.s ** 3
    rows = np.arange(N, dtype=np.int64).reshape(C, nb)
    A = torch.zeros((K, N, N), dtype=dtype, device=device)
    return scatter_blocks(A, elem.reshape(K, C, nb, nb), rows, rows)


# ---------------------------------------------------------------------------
# face geometry
# ---------------------------------------------------------------------------

def face_phys_points(space, tab, cz, cy, cx, origins):
    """Physical quadrature points and one-sided evaluation points (float64
    numpy) for a batch of faces given their minus-side cell coords [F] and
    origins [K, 3]: (x, x_m_eval, x_p_eval), each [K, F, nqf, 3]; the plus
    cell is shifted by one cell along the family normal (``x_p_eval`` is
    None for boundary tabs)."""
    scale = np.array([space.hx, space.hy, space.hz])
    cell_org = np.stack([np.asarray(cx) * space.hx,
                         np.asarray(cy) * space.hy,
                         np.asarray(cz) * space.hz], axis=-1)          # [F, 3]
    base = np.asarray(origins)[:, None, :] + cell_org[None, :, :]     # [K, F, 3]
    x = base[:, :, None, :] + (tab.pts_unit_m * scale)[None, None]
    cen_m = base[:, :, None, :] + (tab.centroid_m * scale)[None, None]
    x_m = x + _EVAL_EPS * (cen_m - x)
    if tab.phi_p is None:
        return x, x_m, None
    shift = np.abs(np.asarray(tab.normal)) * scale                     # one cell
    cen_p = base[:, :, None, :] + (shift + tab.centroid_p * scale)[None, None]
    x_p = x + _EVAL_EPS * (cen_p - x)
    return x, x_m, x_p
