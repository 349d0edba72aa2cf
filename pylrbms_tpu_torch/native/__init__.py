"""Native host assembler: a build-on-demand C++ extension and its Python side.

The port of ``pylrbms_tpu/native/__init__.py``: the same C++ source (its
own copy, ``swipdg_assembler.cpp``) built with g++ on first use into the
package's ``_build/`` directory; :func:`available` says whether a
toolchain built it.  A sequential host oracle of the SWIPDG assembly
(kappa = I, all reference problems), not a device path: it takes the
port's spaces and its coefficient functions (evaluated on the host in
float64) and returns scipy CSR matrices.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
from functools import lru_cache

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_NAME = "_pylrbms_torch_native"


@lru_cache(maxsize=1)
def _load():
    so = os.path.join(_BUILD, _NAME + ".so")
    src = os.path.join(_DIR, "swipdg_assembler.cpp")
    if (not os.path.exists(so)) or os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
               src, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    spec = importlib.util.spec_from_file_location(_NAME, so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def available() -> bool:
    """True when the extension builds (g++ and the Python headers present)
    and loads."""
    try:
        _load()
        return True
    except (OSError, ImportError, subprocess.CalledProcessError):
        return False


def _evaluator(lam_fn):
    """numpy points -> contiguous float64 numpy values of ``lam_fn``."""
    def ev(x):
        v = lam_fn(torch.as_tensor(np.asarray(x), dtype=torch.float64))
        return np.ascontiguousarray(v.cpu().numpy(), dtype=np.float64)
    return ev


def assemble_swipdg_p1_csr(space, lam_fn, ipdg=None):
    """scipy CSR of one affine SWIPDG component (kappa = I) on the 2D tri
    P1 space, by the native assembler.  The coefficient is tabulated at the
    quadrature points on the host and handed to C++."""
    import scipy.sparse as sp
    from ..ops.assembly import DEFAULT_IPDG, _EVAL_EPS

    ipdg = ipdg or DEFAULT_IPDG
    mod = _load()
    grid = space.grid
    Sy, Sx = grid.global_ny, grid.global_nx
    hx, hy = space.hx, space.hy
    ev = _evaluator(lam_fn)

    # volume points in global cell order [Sy, Sx, T, nqv]
    org = grid.cell_origins()                        # [Sy, Sx, 2]
    scale = np.array([hx, hy])
    xv = org[:, :, None, None, :] + (space.vol_qp * scale)[None, None]
    lam_vol = ev(xv)
    t = space.face_tabs["D"].pts_unit_m[:, 0]        # edge parameters

    def face_vals(pts_unit, org_pts, centroid, shift=(0.0, 0.0)):
        x = org_pts[..., None, :] + (pts_unit * scale)[None]
        cen = org_pts[..., None, :] + np.asarray(shift) + (centroid * scale)[None]
        return ev(x + _EVAL_EPS * (cen - x))

    cenA, cenB = space.tri_centroids[0], space.tri_centroids[1]
    ptsD = np.stack([t, t], -1)
    lam_D_m = face_vals(ptsD, org, cenA)
    lam_D_p = face_vals(ptsD, org, cenB)
    ptsVm = np.stack([np.ones_like(t), t], -1)
    lam_V_m = face_vals(ptsVm, org[:, :-1], cenA) if Sx > 1 else np.zeros((Sy, 0, len(t)))
    lam_V_p = face_vals(ptsVm, org[:, :-1], cenB, (hx, 0.0)) if Sx > 1 else lam_V_m
    ptsHm = np.stack([t, np.ones_like(t)], -1)
    lam_H_m = face_vals(ptsHm, org[:-1, :], cenB) if Sy > 1 else np.zeros((0, Sx, len(t)))
    lam_H_p = face_vals(ptsHm, org[:-1, :], cenA, (0.0, hy)) if Sy > 1 else lam_H_m
    ptsVp = np.stack([np.zeros_like(t), t], -1)
    ptsHp = np.stack([t, np.zeros_like(t)], -1)
    lam_bnd = np.concatenate([
        face_vals(ptsVp, org[:, 0], cenB),           # left [Sy, nqf]
        face_vals(ptsVm, org[:, Sx - 1], cenA),      # right
        face_vals(ptsHp, org[0, :], cenA),           # bottom [Sx, nqf]
        face_vals(ptsHm, org[Sy - 1, :], cenB),      # top
    ], axis=0)

    c = np.ascontiguousarray
    rows, cols, vals = mod.assemble_swipdg_p1(
        grid.kx, grid.ky, grid.s, hx, hy,
        ipdg.sigma_inner(space.order), ipdg.sigma_boundary(space.order), ipdg.beta,
        c(space.vol_qp), c(space.vol_w), c(t), c(space.face_tabs["D"].w),
        lam_vol, c(lam_D_m), c(lam_D_p), c(lam_V_m), c(lam_V_p), c(lam_H_m), c(lam_H_p),
        c(lam_bnd))
    ndof = grid.num_subdomains * grid.s ** 2 * 2 * 3
    A = sp.csr_matrix((vals, (rows, cols)), shape=(ndof, ndof))
    A.sum_duplicates()
    return A


def assemble_swipdg_q1_3d_csr(space, lam_fn, ipdg=None):
    """scipy CSR of one affine 3D hex SWIPDG component (kappa = I, trilinear
    Q1) by the native assembler: the integrands of the batched 3D assembly
    (face area as the integration measure, face diameter as the penalty
    length scale)."""
    import scipy.sparse as sp
    from ..ops.assembly import DEFAULT_IPDG, _EVAL_EPS
    from ..ops.spaces3d import _face_pts_unit

    ipdg = ipdg or DEFAULT_IPDG
    mod = _load()
    g = space.grid
    Sx, Sy, Sz = g.global_nx, g.global_ny, g.global_nz
    h = np.array([space.hx, space.hy, space.hz])
    ll = np.asarray(g.lower_left)
    gz, gy, gx = np.meshgrid(np.arange(Sz), np.arange(Sy), np.arange(Sx), indexing="ij")
    org = ll + np.stack([gx, gy, gz], axis=-1) * h    # [Sz, Sy, Sx, 3]
    ev = _evaluator(lam_fn)

    qv = np.asarray(space.vol_qp)                     # [nqv, 3] unit
    lam_vol = ev(org[..., None, :] + qv * h)
    uv = np.asarray(space.face_uv)
    cen = np.array([0.5, 0.5, 0.5]) * h

    def fv(fam, c01, orgs, shift=(0.0, 0.0, 0.0)):
        pts = _face_pts_unit(fam, uv, c01) * h        # [nqf, 3]
        x = orgs[..., None, :] + pts
        cenp = orgs[..., None, :] + np.asarray(shift) + cen
        return ev(x + _EVAL_EPS * (cenp - x))

    nqf = uv.shape[0]
    sx_, sy_, sz_ = (h[0], 0, 0), (0, h[1], 0), (0, 0, h[2])
    # interior faces: minus = the hi side of the minus cell; plus evaluated
    # at the same physical points, nudged toward the plus cell's centroid
    lam_X_m = fv("X", 1.0, org[:, :, :-1]) if Sx > 1 else np.zeros((Sz, Sy, 0, nqf))
    lam_X_p = fv("X", 1.0, org[:, :, :-1], sx_) if Sx > 1 else lam_X_m
    lam_Y_m = fv("Y", 1.0, org[:, :-1, :]) if Sy > 1 else np.zeros((Sz, 0, Sx, nqf))
    lam_Y_p = fv("Y", 1.0, org[:, :-1, :], sy_) if Sy > 1 else lam_Y_m
    lam_Z_m = fv("Z", 1.0, org[:-1]) if Sz > 1 else np.zeros((0, Sy, Sx, nqf))
    lam_Z_p = fv("Z", 1.0, org[:-1], sz_) if Sz > 1 else lam_Z_m
    lam_bnd = np.concatenate([
        fv("X", 0.0, org[:, :, 0]).reshape(-1, nqf),       # left  [Sz*Sy]
        fv("X", 1.0, org[:, :, Sx - 1]).reshape(-1, nqf),  # right
        fv("Y", 0.0, org[:, 0, :]).reshape(-1, nqf),       # bottom [Sz*Sx]
        fv("Y", 1.0, org[:, Sy - 1, :]).reshape(-1, nqf),  # top
        fv("Z", 0.0, org[0]).reshape(-1, nqf),             # near  [Sy*Sx]
        fv("Z", 1.0, org[Sz - 1]).reshape(-1, nqf),        # far
    ], axis=0)

    c = np.ascontiguousarray
    rows, cols, vals = mod.assemble_swipdg_q1_3d(
        g.kx, g.ky, g.kz, g.s, space.hx, space.hy, space.hz,
        ipdg.sigma_inner(space.order), ipdg.sigma_boundary(space.order), ipdg.beta,
        c(qv), c(space.vol_w), c(uv), c(space.face_tabs["X"].w),
        lam_vol, c(lam_X_m), c(lam_X_p), c(lam_Y_m), c(lam_Y_p), c(lam_Z_m), c(lam_Z_p),
        c(lam_bnd))
    ndof = space.K * space.N
    A = sp.csr_matrix((vals, (rows, cols)), shape=(ndof, ndof))
    A.sum_duplicates()
    return A
