"""Plain NumPy reference of the SPE10 model 2 online step in 3D: the field,
the SWIPDG discretization on hexahedra, the solve and the localized
estimator.

The problem (SPE10 model 2: M. A. Christie and M. J. Blunt, SPE Reservoir
Evaluation & Engineering 4(4), 2001): on the unit box,

    -div(lambda(mu) grad u) = f,  u = 0 on the boundary,
    lambda(mu) = theta_0 floor + theta_1 k,  theta = (1, mu),  f = 1,

with ``k`` cellwise constant on the mesh of :mod:`mesh3d`.  ``k`` is the
z-block ``field.layers = (lo, hi)`` of the 60 x 220 x 85 permeability
(``spe_perm.dat`` when ``SPE10_DATA`` names it, else the seeded
channelized surrogate of :func:`surrogate_layer`, one layer a z-layer),
sampled at each cell's centre (nearest raster cell), divided by its
largest value and clipped from below at ``1 / field.max_contrast``;
``floor = min(k) / 2``.  ``mu_bar = mu_hat = 1``: lambda_bar = lambda_hat
= floor + k.

Discretization: SWIPDG with trilinear (Q1) elements, kappa = I, on every
face of the mesh (a subdomain interface is a face like any other):

    a(u, v) = sum_T int_T lambda grad u . grad v
              - sum_e int_e ({lambda grad u . n} [v] + {lambda grad v . n} [u])
              + sum_e int_e p_e [u] [v],

* ``{w} = (w_minus + w_plus) / 2`` on an inner face, w itself on a
  boundary face; ``[u] = u_minus - u_plus`` with ``n`` from minus to plus,
  ``u`` with the outward ``n`` on the boundary;
* the penalty on an inner face ``p_e = sigma_inner gamma (lambda_minus +
  lambda_plus) / 2 / d_e`` with ``gamma = 1/2`` and sigma_inner = 8; on a
  boundary face ``p_e = sigma_boundary lambda / d_e`` with sigma_boundary =
  14 (the upstream P1/Q1 settings, beta = 1); ``d_e`` is the face's
  diameter, its diagonal;
* lambda on a face is each side's own cell value.

Departures from the published SWIPDG (Ern, Stephansen and Zunino 2009),
which the program makes and the reference follows: the face weights and
gamma come from n.kappa.n alone, without lambda, so they are 1/2 and 1/2
for kappa = I (a harmonic lambda weighting would make the weights and the
penalty depend on the contrast across the face); the penalty takes the
arithmetic mean of the two lambdas; ``d_e`` is the face diagonal, not
the face area over a cell extent.  Quadrature: 3 Gauss points a direction
in cells and on faces, exact for every integrand here (cellwise-constant
lambda, Q1 and RT0 functions).

Estimator (per subdomain, squared local quantities):

    eta_nc = int lambda_bar |grad (u - I_os u)|^2           (broken)
    eta_r  = C_P / min lambda_hat * H^2 * int (f - div t)^2,  C_P = 1/pi^2
    eta_df = int |lambda(mu) grad u + t|^2 / lambda_hat

``I_os`` the Oswald interpolant (at each vertex of the mesh the mean of
the values of the cells around it, 0 on the boundary), ``t`` the RT0 flux
on hexahedra (``t . e_a`` linear in x_a on a cell, constant flux through
each face) whose flux through a face is the SWIPDG numerical flux
``int_e (-{lambda grad u . n} + p_e [u])`` (boundary: ``-lambda grad u .
n + p_e u``) and ``H`` the subdomain's diagonal.  The indicator of a
subdomain is ``eta_nc + eta_r + eta_df``.

Nothing here reads the system under test: the arrays it is given are the
answers to judge.
"""
from __future__ import annotations

import math
import os

import numpy as np
import scipy.sparse as sp

from .mesh3d import Mesh3D, cube_rule, face_rule, q1, q1_grad

SIGMA_INNER, SIGMA_BOUNDARY, GAMMA = 8.0, 14.0, 0.5
MU_BAR = MU_HAT = 1.0
POINCARE = 1.0 / math.pi ** 2
POINTS = 3                                  # Gauss points per direction
SPE10_SHAPE = (85, 220, 60)                 # (nz, ny, nx) of the published field


def surrogate_layer(layer: int, nx: int = 60, ny: int = 220) -> np.ndarray:
    """[ny, nx] seeded channelized log-normal surrogate of one SPE10
    layer: smoothed Gaussian noise spanning 10^(+-2.5), three sinuous
    channels of 10^4 on top, shifted by 10^-1.5."""
    rng = np.random.default_rng(1000 + layer)
    y, x = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx), indexing="ij")
    logk = rng.normal(0.0, 1.0, (ny, nx))
    for _ in range(6):
        logk = 0.2 * (np.roll(logk, 1, 0) + np.roll(logk, -1, 0)
                      + np.roll(logk, 1, 1) + np.roll(logk, -1, 1)) + 0.2 * logk
    logk = 2.5 * logk / max(np.abs(logk).max(), 1e-12)
    for c, (y0, amp, wid) in enumerate([(0.2, 0.05, 0.02), (0.5, 0.08, 0.015),
                                        (0.8, 0.04, 0.025)]):
        logk += 4.0 * np.exp(-((y - y0 - amp * np.sin(6.28 * (x + 0.3 * c))) / wid) ** 2)
    return 10.0 ** (logk - 1.5)


def permeability(layers) -> np.ndarray:
    """[nz, ny, nx] = [hi - lo, 220, 60] block of the field."""
    lo, hi = int(layers[0]), int(layers[1])
    path = os.environ.get("SPE10_DATA")
    if path and os.path.exists(path):
        nz, ny, nx = SPE10_SHAPE
        return np.fromfile(path, sep=" ")[:nz * ny * nx].reshape(SPE10_SHAPE)[lo:hi]
    return np.stack([surrogate_layer(z) for z in range(lo, hi)])


def cell_field(mesh: Mesh3D, layers, max_contrast: float) -> np.ndarray:
    """[nz, ny, nx] k on the mesh's cells: the block sampled at the cell
    centres, normalized to a largest value of 1, clipped at 1/max_contrast."""
    perm = permeability(layers)
    idx = [np.clip(((np.arange(n) + 0.5) / n * m).astype(int), 0, m - 1)
           for n, m in zip(mesh.shape, perm.shape)]
    k = perm[np.ix_(*idx)]
    k = k / k.max()
    return np.maximum(k, 1.0 / max_contrast)


def build(cfg: dict) -> "Spe10Q1":
    """The reference problem of a configuration file."""
    if cfg.get("order", 1) != 1:
        raise ValueError("the reference discretizes with Q1 elements only")
    if cfg["theta"] != {"const": [1.0, 0.0], "per_mu": [0.0, 1.0]} or cfg["theta_f"] != [1.0]:
        raise ValueError("the reference's coefficients are theta = (1, mu), theta_f = (1,)")
    fld = cfg["field"]
    mesh = Mesh3D.from_config(cfg["grid"])
    return Spe10Q1(mesh, cell_field(mesh, fld["layers"], fld["max_contrast"]))


class Spe10Q1:
    """The discrete SPE10 3D problem on one mesh, in float64."""

    def __init__(self, mesh: Mesh3D, k: np.ndarray):
        self.mesh = m = mesh
        self.k = k.reshape(-1)                                      # [C] raster order
        self.floor = 0.5 * float(self.k.min())
        self.cell = m.cells()
        self.dofs = m.dofs(*self.cell)                              # [C, 8]
        self.sub = m.subdomain_of(*self.cell)                       # [C]
        self.h = m.h
        vp, self.vol_w = cube_rule(POINTS)
        self.vol_phi, self.vol_xi = q1(vp), vp                      # [q, 8], [q, 3]
        self.vol_grad = q1_grad(vp) / self.h                        # [q, 8, 3] physical
        self.stiff = m.volume * np.einsum("q,qia,qja->ij", self.vol_w,
                                          self.vol_grad, self.vol_grad)
        self.faces = [self._inner(a) for a in range(3)]
        self.bfaces = [self._boundary(a, side) for a in range(3) for side in (0, 1)]
        comps = [np.full_like(self.k, self.floor), self.k]
        self.A_q = [self._assemble(lam) for lam in comps]
        per_dof = np.broadcast_to(m.volume * (self.vol_w @ self.vol_phi), self.dofs.shape)
        self.b = np.bincount(self.dofs.ravel(), per_dof.ravel(), m.K * m.N)

    # ---- faces ----------------------------------------------------------
    def _face_geometry(self, a):
        h = self.h
        t = [b for b in range(3) if b != a]
        return float(h[t[0]] * h[t[1]]), float(math.hypot(h[t[0]], h[t[1]]))

    def _inner(self, a):
        """Faces normal to axis a between two cells: the minus cell (lower
        along a), the plus cell and the side tables: values and normal
        derivatives (along +e_a) [q, 8] of each side at the face points."""
        m = self.mesh
        gx, gy, gz = self.cell
        g = (gx, gy, gz)
        keep = g[a] < m.shape[2 - a] - 1
        minus = np.flatnonzero(keep)
        step = (1, m.shape[2], m.shape[2] * m.shape[1])[a]
        pm, w = face_rule(POINTS, a, 1.0)
        pp, _ = face_rule(POINTS, a, 0.0)
        area, diam = self._face_geometry(a)
        return {"minus": minus, "plus": minus + step, "w": w, "area": area, "diam": diam,
                "phi": (q1(pm), q1(pp)),
                "dn": (q1_grad(pm)[..., a] / self.h[a], q1_grad(pp)[..., a] / self.h[a])}

    def _boundary(self, a, side):
        """Faces normal to axis a on the domain boundary, side 0 (low) or 1
        (high): the cells, values and outward normal derivatives [q, 8]."""
        m = self.mesh
        g = self.cell[a]
        cells = np.flatnonzero(g == (0 if side == 0 else m.shape[2 - a] - 1))
        p, w = face_rule(POINTS, a, float(side))
        out = 1.0 if side == 1 else -1.0
        area, diam = self._face_geometry(a)
        return {"cells": cells, "w": w, "area": area, "diam": diam, "out": out, "axis": a,
                "phi": q1(p), "dn": out * q1_grad(p)[..., a] / self.h[a]}

    # ---- assembly -------------------------------------------------------
    def _assemble(self, lam):
        """Sparse [K*N, K*N] SWIPDG matrix of the cellwise diffusion lam [C]."""
        m = self.mesh
        rows, cols, vals = [], [], []

        def add(r, c, v):                      # r, c [F, 8]; v [F, 8, 8]
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        add(self.dofs, self.dofs, lam[:, None, None] * self.stiff)
        for f in self.faces:
            lam_s = (lam[f["minus"]], lam[f["plus"]])
            pen = SIGMA_INNER * GAMMA * 0.5 * (lam_s[0] + lam_s[1]) / f["diam"]
            d = (self.dofs[f["minus"]], self.dofs[f["plus"]])
            sign = (1.0, -1.0)
            wa = f["w"] * f["area"]
            for S in range(2):
                for T in range(2):
                    phi_t_dn = np.einsum("q,qi,qj->ij", wa, f["phi"][S], f["dn"][T])
                    dn_phi = np.einsum("q,qi,qj->ij", wa, f["dn"][S], f["phi"][T])
                    pp = np.einsum("q,qi,qj->ij", wa, f["phi"][S], f["phi"][T])
                    v = (-0.5 * sign[S] * lam_s[T][:, None, None] * phi_t_dn
                         - 0.5 * sign[T] * lam_s[S][:, None, None] * dn_phi
                         + sign[S] * sign[T] * pen[:, None, None] * pp)
                    add(d[S], d[T], v)
        for f in self.bfaces:
            lam_b = lam[f["cells"]]
            wa = f["w"] * f["area"]
            r = np.einsum("q,qi,qj->ij", wa, f["phi"], f["dn"])
            pp = np.einsum("q,qi,qj->ij", wa, f["phi"], f["phi"])
            v = (lam_b[:, None, None] * (-(r + r.T))
                 + (SIGMA_BOUNDARY * lam_b / f["diam"])[:, None, None] * pp)
            d = self.dofs[f["cells"]]
            add(d, d, v)
        n = m.K * m.N
        A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n))
        A.sum_duplicates()
        return A

    def lam(self, mu):
        """[C] lambda(mu) on the cells."""
        return self.floor + mu * self.k

    def matrix(self, mu):
        return (self.A_q[0] + mu * self.A_q[1]).tocsc()

    # ---- estimator ------------------------------------------------------
    def oswald_error(self, u):
        """u - I_os(u) at the cells' vertices [C, 8] for u [K*N]."""
        m = self.mesh
        nz, ny, nx = m.shape
        vid = m.vertex_ids(*self.cell)                              # [C, 8]
        nv = (nz + 1) * (ny + 1) * (nx + 1)
        uc = u[self.dofs]
        avg = np.bincount(vid.ravel(), uc.ravel(), nv) / np.maximum(
            np.bincount(vid.ravel(), None, nv), 1)
        iz, iy, ix = np.unravel_index(vid, (nz + 1, ny + 1, nx + 1))
        on_bnd = (ix == 0) | (ix == nx) | (iy == 0) | (iy == ny) | (iz == 0) | (iz == nz)
        return uc - np.where(on_bnd, 0.0, avg[vid])

    def face_fluxes(self, u, mu):
        """[C, 3, 2] RT0 dofs of t on every cell: the flux along +e_a through
        its low (0) and high (1) face normal to axis a."""
        lam = self.lam(mu)
        uc = u[self.dofs]                                           # [C, 8]
        out = np.zeros((len(uc), 3, 2))
        for a, f in enumerate(self.faces):
            lm, lp = lam[f["minus"]], lam[f["plus"]]
            um, up = (uc[c] @ phi.T for c, phi in zip((f["minus"], f["plus"]), f["phi"]))
            gm, gp = (uc[c] @ dn.T for c, dn in zip((f["minus"], f["plus"]), f["dn"]))
            pen = SIGMA_INNER * GAMMA * 0.5 * (lm + lp) / f["diam"]
            integrand = (-0.5 * (lm[:, None] * gm + lp[:, None] * gp)
                         + pen[:, None] * (um - up))
            flux = f["area"] * integrand @ f["w"]
            out[f["minus"], a, 1] = flux
            out[f["plus"], a, 0] = flux
        for f in self.bfaces:
            c = f["cells"]
            lb = lam[c]
            integrand = (-lb[:, None] * (uc[c] @ f["dn"].T)
                         + (SIGMA_BOUNDARY * lb / f["diam"])[:, None] * (uc[c] @ f["phi"].T))
            flux = f["out"] * f["area"] * integrand @ f["w"]        # along +e_a
            out[c, f["axis"], 0 if f["out"] < 0 else 1] = flux
        return out

    def indicators(self, u, mu):
        """[K] eta_nc + eta_r + eta_df of the field u [K, N] (or [K*N])."""
        m = self.mesh
        u = np.asarray(u, np.float64).reshape(-1)
        V = m.volume
        lam_bar, lam_hat = self.lam(MU_BAR), self.lam(MU_HAT)

        uo = self.oswald_error(u)
        nc = lam_bar * np.einsum("ci,ij,cj->c", uo, self.stiff, uo)

        F = self.face_fluxes(u, mu)                                 # [C, 3, 2]
        div = ((F[:, :, 1] - F[:, :, 0]) / V).sum(-1)               # [C]
        r = V * (1.0 - div) ** 2                                    # f = 1
        # t . e_a = (h_a / V) (F_lo (1 - xi_a) + F_hi xi_a) at the volume points
        xi = self.vol_xi                                            # [q, 3]
        t = (self.h / V) * (F[:, None, :, 0] * (1.0 - xi) + F[:, None, :, 1] * xi)
        gu = np.einsum("ci,qia->cqa", u[self.dofs], self.vol_grad)
        z = self.lam(mu)[:, None, None] * gu + t
        df = V * ((z ** 2).sum(-1) @ self.vol_w) / lam_hat

        per_sub = lambda v: np.bincount(self.sub, v, m.K)           # noqa: E731
        min_ev = np.full(m.K, np.inf)
        np.minimum.at(min_ev, self.sub, lam_hat)
        scale = POINCARE / min_ev * m.subdomain_diameter ** 2
        return per_sub(nc) + per_sub(r) * scale + per_sub(df)
