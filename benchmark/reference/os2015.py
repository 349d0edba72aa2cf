"""Plain NumPy reference of the OS2015 online step: the SWIPDG
discretization, the solve and the localized estimator.

The problem (Ohlberger and Schindler, SIAM J. Sci. Comput. 37(6), 2015,
section 5): on the domain of the configuration, with
``c(x) = cos(pi x0 / 2) cos(pi x1 / 2)``,

    -div(lambda(mu) grad u) = f,  u = 0 on the boundary,
    lambda(mu) = theta_0 (1 + c) + theta_1 (-c),  theta = (1, mu),
    f = theta_f (pi^2 / 2) c,  theta_f = (1,),

with ``mu_bar = mu_hat = 1``, so ``lambda_bar = lambda_hat = 1``.

Discretization: symmetric weighted interior penalty DG (SWIPDG) with P1
elements on the mesh of :mod:`mesh`; with the identity as the diffusion
tensor, the face weights are 1/2 and the penalty on an inner face is
``sigma_inner * (1/2) * lambda / |e|``, on a boundary face
``sigma_boundary * lambda / |e|`` (beta = 1), sigma = 8 and 14 for P1, the
upstream pylrbms / dune-gdt OS2015 settings.

Estimator (per subdomain, squared local quantities, kappa = I):

    eta_nc = int lambda_bar |grad (u - I_os u)|^2           (broken)
    eta_r  = C_P / min lambda_hat * H^2 * int (f - div t)^2,  C_P = 1/pi^2
    eta_df = int |lambda(mu) grad u + t|^2 / lambda_hat

where ``I_os`` is the Oswald interpolant (vertex means of the incident
elements' values, 0 on the boundary), ``t`` the RT0 flux whose normal flux
through a face is the SWIPDG numerical flux ``-{lambda grad u . n} +
penalty [u]`` and ``H`` the subdomain diameter.  The indicator of a
subdomain is ``eta_nc + eta_r + eta_df``.

Nothing here reads the system under test: the arrays it is given are the
answers to judge.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp

from .mesh import Mesh, barycentric, gauss_legendre_01, p1_gradients, triangle_rule

SIGMA_INNER, SIGMA_BOUNDARY = 8.0, 14.0      # P1 penalties (beta = 1)
MU_BAR = MU_HAT = 1.0
POINCARE = 1.0 / math.pi ** 2
VOL_POINTS, FACE_POINTS = 6, 6                # Gauss points per direction


def c_fn(x):
    return np.cos(0.5 * np.pi * x[..., 0]) * np.cos(0.5 * np.pi * x[..., 1])


def lambda_q(x):
    """[2, ...] the affine diffusion components at points x [..., 2]."""
    c = c_fn(x)
    return np.stack([1.0 + c, -c])


def theta(mu):
    return np.array([1.0, mu])


def lam(mu, x):
    return np.tensordot(theta(mu), lambda_q(x), axes=1)


def f_fn(x):
    return 0.5 * np.pi ** 2 * c_fn(x)


def build(cfg: dict) -> "Os2015":
    """The reference problem of a configuration file."""
    if cfg.get("order", 1) != 1:
        raise ValueError("the reference discretizes with P1 elements only")
    if cfg["theta"] != {"const": [1.0, 0.0], "per_mu": [0.0, 1.0]} or cfg["theta_f"] != [1.0]:
        raise ValueError("the reference's coefficients are theta = (1, mu), theta_f = (1,)")
    return Os2015(Mesh.from_config(cfg["grid"], cfg["domain"]))


class Faces:
    """Every face of the mesh: inner faces with a minus and a plus triangle
    and the normal from minus to plus, boundary faces with the outward
    normal.  Triangles are (gx, gy, t) arrays, faces their end points."""

    def __init__(self, mesh: Mesh):
        m = mesh
        gx, gy = (v.ravel() for v in m.cells())
        hx, hy = m.hx, m.hy
        o = np.stack([m.lower_left[0] + gx * hx, m.lower_left[1] + gy * hy], -1)
        right, up = gx < m.nx - 1, gy < m.ny - 1
        # (minus cells, minus t, plus cells, plus t, a, b, normal):
        # the diagonal (t0 below, t1 above), x = const (t0 of gx, t1 of
        # gx + 1) and y = const (t1 of gy, t0 of gy + 1)
        inner = [((gx, gy), 0, (gx, gy), 1, o, o + [hx, hy],
                  np.array([-hy, hx]) / math.hypot(hx, hy)),
                 ((gx[right], gy[right]), 0, (gx[right] + 1, gy[right]), 1,
                  o[right] + [hx, 0.0], o[right] + [hx, hy], np.array([1.0, 0.0])),
                 ((gx[up], gy[up]), 1, (gx[up], gy[up] + 1), 0,
                  o[up] + [0.0, hy], o[up] + [hx, hy], np.array([0.0, 1.0]))]
        self.m = self._tris([(c, t) for c, t, *_ in inner])
        self.p = self._tris([(c, t) for _, _, c, t, *_ in inner])
        self.a = np.concatenate([f[4] for f in inner])
        self.b = np.concatenate([f[5] for f in inner])
        self.n = np.concatenate([np.broadcast_to(f[6], f[4].shape) for f in inner])
        sides = [(gx == 0, 1, [0.0, 0.0], [0.0, hy], [-1.0, 0.0]),
                 (gx == m.nx - 1, 0, [hx, 0.0], [hx, hy], [1.0, 0.0]),
                 (gy == 0, 0, [0.0, 0.0], [hx, 0.0], [0.0, -1.0]),
                 (gy == m.ny - 1, 1, [0.0, hy], [hx, hy], [0.0, 1.0])]
        self.bt = self._tris([((gx[k], gy[k]), t) for k, t, *_ in sides])
        self.ba = np.concatenate([o[k] + a for k, _, a, _, _ in sides])
        self.bb = np.concatenate([o[k] + b for k, _, _, b, _ in sides])
        self.bn = np.concatenate([np.broadcast_to(np.array(n), (k.sum(), 2))
                                  for k, *_, n in sides])

    @staticmethod
    def _tris(parts):
        """[(cells (gx, gy), t), ...] -> concatenated (gx, gy, t)."""
        gx = np.concatenate([c[0] for c, _ in parts])
        gy = np.concatenate([c[1] for c, _ in parts])
        t = np.concatenate([np.full(len(c[0]), t) for c, t in parts])
        return gx, gy, t


class Os2015:
    """The discrete OS2015 problem on one mesh, in float64."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.faces = Faces(mesh)
        m = mesh
        gx, gy = m.cells()
        self.tri = (np.repeat(gx.ravel(), 2), np.repeat(gy.ravel(), 2),
                    np.tile([0, 1], gx.size))                       # every triangle
        self.verts = m.vertices(*self.tri)                          # [T, 3, 2]
        self.grads = p1_gradients(self.verts)                       # [T, 3, 2]
        self.dofs = m.dofs(*self.tri)                               # [T, 3]
        self.sub = m.subdomain_of(self.tri[0], self.tri[1])         # [T]
        bary, self.vol_w = triangle_rule(VOL_POINTS)
        self.vol_x = np.einsum("qi,tia->tqa", bary, self.verts)     # [T, q, 2]
        self.vol_bary = bary
        self.face_t, self.face_w = gauss_legendre_01(FACE_POINTS)
        self.A_q = [self._assemble(k) for k in range(2)]
        self.b = self._rhs()

    # ---- assembly -----------------------------------------------------
    def _face_side(self, gx, gy, t, x):
        """(dofs [F, 3], values [F, q, 3], gradients [F, 3, 2]) of the
        triangles (gx, gy, t) at face points x [F, q, 2]."""
        verts = self.mesh.vertices(gx, gy, t)
        return self.mesh.dofs(gx, gy, t), barycentric(verts, x), p1_gradients(verts)

    def _assemble(self, k):
        """Sparse [K*N, K*N] SWIPDG matrix of the diffusion component k."""
        m, F = self.mesh, self.faces
        rows, cols, vals = [], [], []

        def add(r, c, v):
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        lam_v = lambda_q(self.vol_x)[k]                             # [T, q]
        vol = m.area * (self.vol_w * lam_v).sum(-1)                # int lambda over T
        add(self.dofs, self.dofs, vol[:, None, None]
            * np.einsum("tia,tja->tij", self.grads, self.grads))

        # inner faces: -{lambda grad u . n}[v] - {lambda grad v . n}[u] + pen [u][v]
        ell = np.linalg.norm(F.b - F.a, axis=-1)                    # [F]
        x = F.a[:, None] + self.face_t[None, :, None] * (F.b - F.a)[:, None]
        lf = lambda_q(x)[k]                                         # [F, q]
        wl = self.face_w * ell[:, None]                             # [F, q]
        pen = SIGMA_INNER * 0.5 * lf / ell[:, None]
        sides = [self._face_side(*F.m, x), self._face_side(*F.p, x)]
        sign = (1.0, -1.0)
        for si, (di, phi_i, g_i) in enumerate(sides):
            for sj, (dj, phi_j, g_j) in enumerate(sides):
                dn_i = np.einsum("fia,fa->fi", g_i, F.n)            # grad phi_i . n
                dn_j = np.einsum("fja,fa->fj", g_j, F.n)
                v = (-0.5 * sign[si] * np.einsum("fq,fj,fqi->fij", wl * lf, dn_j, phi_i)
                     - 0.5 * sign[sj] * np.einsum("fq,fi,fqj->fij", wl * lf, dn_i, phi_j)
                     + sign[si] * sign[sj] * np.einsum("fq,fqi,fqj->fij", wl * pen, phi_i, phi_j))
                add(di, dj, v)

        # boundary faces: -lambda grad u . n v - lambda grad v . n u + pen u v
        ell = np.linalg.norm(F.bb - F.ba, axis=-1)
        x = F.ba[:, None] + self.face_t[None, :, None] * (F.bb - F.ba)[:, None]
        lf = lambda_q(x)[k]
        wl = self.face_w * ell[:, None]
        pen = SIGMA_BOUNDARY * lf / ell[:, None]
        d, phi, g = self._face_side(*F.bt, x)
        dn = np.einsum("fia,fa->fi", g, F.bn)
        v = (-np.einsum("fq,fj,fqi->fij", wl * lf, dn, phi)
             - np.einsum("fq,fi,fqj->fij", wl * lf, dn, phi)
             + np.einsum("fq,fqi,fqj->fij", wl * pen, phi, phi))
        add(d, d, v)
        n = m.K * m.N
        A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n))
        A.sum_duplicates()
        return A

    def _rhs(self):
        m = self.mesh
        b = np.zeros(m.K * m.N)
        fv = f_fn(self.vol_x)                                       # [T, q]
        np.add.at(b, self.dofs, m.area * np.einsum("q,tq,qi->ti", self.vol_w, fv, self.vol_bary))
        return b

    def matrix(self, mu):
        th = theta(mu)
        return (th[0] * self.A_q[0] + th[1] * self.A_q[1]).tocsc()

    # ---- estimator ----------------------------------------------------
    def oswald_error(self, u):
        """u - I_os(u) at the triangles' nodes [T, 3] for u [K*N]."""
        m = self.mesh
        ix = np.rint((self.verts[..., 0] - m.lower_left[0]) / m.hx).astype(np.int64)
        iy = np.rint((self.verts[..., 1] - m.lower_left[1]) / m.hy).astype(np.int64)
        vid = iy * (m.nx + 1) + ix                                  # [T, 3]
        nv = (m.nx + 1) * (m.ny + 1)
        uT = u[self.dofs]
        sums = np.bincount(vid.ravel(), uT.ravel(), nv)
        counts = np.bincount(vid.ravel(), None, nv)
        avg = sums / np.maximum(counts, 1)
        on_bnd = (ix == 0) | (ix == m.nx) | (iy == 0) | (iy == m.ny)
        return uT - np.where(on_bnd, 0.0, avg[vid])

    def flux(self, u, mu):
        """RT0 flux of u: (S [T], P [T, 2]) with t(x) = (S x - P) / (2|T|)
        on each triangle (S the outward flux through its boundary)."""
        m, F = self.mesh, self.faces
        nt = len(self.sub)
        tid = lambda gx, gy, t: (gy * m.nx + gx) * 2 + t          # noqa: E731
        S, P = np.zeros(nt), np.zeros((nt, 2))

        def deposit(tri, a, b, flux):
            k = tid(*tri)
            opp = self.verts[k].sum(1) - a - b                      # vertex off the face
            np.add.at(S, k, flux)
            np.add.at(P, k, flux[:, None] * opp)

        ell = np.linalg.norm(F.b - F.a, axis=-1)
        x = F.a[:, None] + self.face_t[None, :, None] * (F.b - F.a)[:, None]
        lf = lam(mu, x)
        um, up = (self._trace(tri, u, x) for tri in (F.m, F.p))
        g = [np.einsum("fia,fi,fa->f", self.grads[tid(*tri)], u[self.mesh.dofs(*tri)], F.n)
             for tri in (F.m, F.p)]
        pen = SIGMA_INNER * 0.5 * lf / ell[:, None]
        integrand = -0.5 * lf * (g[0] + g[1])[:, None] + pen * (um - up)
        flux = ell * (integrand * self.face_w).sum(-1)              # along n: minus -> plus
        deposit(F.m, F.a, F.b, flux)
        deposit(F.p, F.a, F.b, -flux)

        ell = np.linalg.norm(F.bb - F.ba, axis=-1)
        x = F.ba[:, None] + self.face_t[None, :, None] * (F.bb - F.ba)[:, None]
        lf = lam(mu, x)
        ub = self._trace(F.bt, u, x)
        gb = np.einsum("fia,fi,fa->f", self.grads[tid(*F.bt)], u[self.mesh.dofs(*F.bt)], F.bn)
        integrand = -lf * gb[:, None] + SIGMA_BOUNDARY * lf / ell[:, None] * ub
        deposit(F.bt, F.ba, F.bb, ell * (integrand * self.face_w).sum(-1))
        return S, P

    def _trace(self, tri, u, x):
        verts = self.mesh.vertices(*tri)
        return np.einsum("fqi,fi->fq", barycentric(verts, x), u[self.mesh.dofs(*tri)])

    def indicators(self, u, mu):
        """[K] eta_nc + eta_r + eta_df of the field u [K, N] (or [K*N])."""
        m = self.mesh
        u = np.asarray(u, np.float64).reshape(-1)
        area = m.area
        x = self.vol_x
        lam_bar, lam_hat = lam(MU_BAR, x), lam(MU_HAT, x)          # [T, q]

        uo = self.oswald_error(u)
        g_o = np.einsum("tia,ti->ta", self.grads, uo)
        nc = area * (self.vol_w * lam_bar).sum(-1) * (g_o ** 2).sum(-1)

        S, P = self.flux(u, mu)
        t_x = (S[:, None, None] * x - P[:, None, :]) / (2.0 * area)  # [T, q, 2]
        gu = np.einsum("tia,ti->ta", self.grads, u[self.dofs])
        z = lam(mu, x)[..., None] * gu[:, None, :] + t_x
        df = area * (self.vol_w * (z ** 2).sum(-1) / lam_hat).sum(-1)

        res = f_fn(x) - (S / area)[:, None]
        r = area * (self.vol_w * res ** 2).sum(-1)
        per_sub = lambda v: np.bincount(self.sub, v, m.K)          # noqa: E731
        min_ev = np.full(m.K, np.inf)
        np.minimum.at(min_ev, self.sub, lam_hat.min(-1))
        scale = POINCARE / min_ev * m.subdomain_diameter ** 2
        return per_sub(nc) + per_sub(r) * scale + per_sub(df)
