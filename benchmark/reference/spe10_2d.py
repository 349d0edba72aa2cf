"""Plain NumPy reference of SPE10 model 2 in 2D: the field, the SWIPDG
discretization on triangles, the solve, the localized estimator and the
oversampled patch systems of online enrichment.

The problem (SPE10 model 2: M. A. Christie and M. J. Blunt, SPE Reservoir
Evaluation & Engineering 4(4), 2001; its use for the localized reduced
basis method: M. Ohlberger and F. Schindler, SIAM J. Sci. Comput. 37(6),
2015): on the unit square,

    -div(lambda(mu) grad u) = f,  u = 0 on the boundary,
    lambda(mu) = theta_0 floor + theta_1 k,  theta = (1, mu),  f = 1,

with ``k`` cellwise constant on the mesh of :mod:`mesh`: horizontal layer
``field.layer`` (default 42) of the 60 x 220 x 85 permeability
(``spe_perm.dat`` when ``SPE10_DATA`` names it, else the seeded
channelized surrogate of :func:`.spe10_3d.surrogate_layer`), sampled at
each cell's centre (nearest raster cell), divided by its largest value and,
only where the configuration gives ``field.max_contrast``, clipped from
below at its inverse; ``floor = min(k) / 2``.  ``mu_bar = mu_hat = 1``:
lambda_bar = lambda_hat = floor + k.

Discretization: the SWIPDG of :mod:`.os2015` (P1 on the diagonal split,
sigma_inner = 8, sigma_boundary = 14, face weights 1/2), with lambda on a
face each side's own cell value: the flux average is
``{lambda grad u . n} = (lambda_minus grad u_minus + lambda_plus grad u_plus)
. n / 2`` and the inner penalty ``sigma_inner (1/2) (lambda_minus +
lambda_plus) / 2 / |e|``; on a boundary face the cell's own lambda.  The
face weights and the 1/2 come from n.kappa.n alone (kappa = I), as the
program makes them; the published SWIPDG weighs by lambda.

Estimator: that of :mod:`.os2015`, each lambda cellwise.  :meth:`parts`
gives the squared local quantities (eta_nc, eta_r, eta_df) apart,
:meth:`indicators` their sum.

Patch systems (:meth:`patch_matrix`): the SWIPDG of a union of subdomains
with zero Dirichlet data on its whole boundary, assembled afresh: the
volume terms of its cells, the inner faces with both sides in it, and on
every face of its boundary (a physical one, or one whose other side lies
outside) the boundary terms from its own side with the outward normal.

Nothing here reads the system under test: the arrays it is given are the
answers to judge.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .mesh import Mesh
from .os2015 import MU_BAR, MU_HAT, POINCARE, SIGMA_BOUNDARY, SIGMA_INNER, Os2015
from .spe10_3d import permeability

LAYER = 42


def cell_field(mesh: Mesh, layer: int = LAYER, max_contrast: float | None = None) -> np.ndarray:
    """[ny, nx] k on the mesh's cells: the layer sampled at the cell centres,
    normalized to a largest value of 1, clipped at 1/max_contrast if given."""
    perm = permeability((layer, layer + 1))[0]                  # [220, 60]
    iy = np.clip(((np.arange(mesh.ny) + 0.5) / mesh.ny * perm.shape[0]).astype(int),
                 0, perm.shape[0] - 1)
    ix = np.clip(((np.arange(mesh.nx) + 0.5) / mesh.nx * perm.shape[1]).astype(int),
                 0, perm.shape[1] - 1)
    k = perm[np.ix_(iy, ix)]
    k = k / k.max()
    return k if max_contrast is None else np.maximum(k, 1.0 / max_contrast)


def build(cfg: dict) -> "Spe10Tri":
    """The reference problem of a configuration file."""
    if cfg.get("order", 1) != 1:
        raise ValueError("the reference discretizes with P1 elements only")
    if cfg["theta"] != {"const": [1.0, 0.0], "per_mu": [0.0, 1.0]} or cfg["theta_f"] != [1.0]:
        raise ValueError("the reference's coefficients are theta = (1, mu), theta_f = (1,)")
    fld = cfg.get("field", {})
    mesh = Mesh.from_config(cfg["grid"], cfg["domain"])
    return Spe10Tri(mesh, cell_field(mesh, fld.get("layer", LAYER), fld.get("max_contrast")))


class Spe10Tri(Os2015):
    """The discrete SPE10 2D problem on one mesh, in float64."""

    def __init__(self, mesh: Mesh, k: np.ndarray):
        self.k = np.asarray(k, np.float64)                          # [ny, nx]
        self.floor = 0.5 * float(self.k.min())
        super().__init__(mesh)

    # ---- the field -----------------------------------------------------
    def lam_q(self, q: int, tri) -> np.ndarray:
        """Component q of lambda on the triangles ``tri`` = (gx, gy, t)."""
        gx, gy = tri[0], tri[1]
        return np.full(np.shape(gx), self.floor) if q == 0 else self.k[gy, gx]

    def lam(self, mu: float, tri) -> np.ndarray:
        return self.lam_q(0, tri) + mu * self.lam_q(1, tri)

    # ---- assembly -----------------------------------------------------
    def _assemble(self, q, keep=None):
        """Sparse [K*N, K*N] SWIPDG matrix of component q; with ``keep`` (a
        mask [T] of the triangles of a patch) the patch's own assembly, zero
        off its dofs."""
        m, F = self.mesh, self.faces
        tid = lambda tri: (tri[1] * m.nx + tri[0]) * 2 + tri[2]      # noqa: E731
        keep = np.ones(len(self.sub), bool) if keep is None else keep
        rows, cols, vals = [], [], []

        def add(r, c, v):
            rows.append(np.broadcast_to(r[:, :, None], v.shape).ravel())
            cols.append(np.broadcast_to(c[:, None, :], v.shape).ravel())
            vals.append(v.ravel())

        lam_v = self.lam_q(q, self.tri)[keep]
        add(self.dofs[keep], self.dofs[keep], (m.area * lam_v)[:, None, None]
            * np.einsum("tia,tja->tij", self.grads[keep], self.grads[keep]))

        ell = np.linalg.norm(F.b - F.a, axis=-1)                    # [F]
        x = F.a[:, None] + self.face_t[None, :, None] * (F.b - F.a)[:, None]
        in_m, in_p = keep[tid(F.m)], keep[tid(F.p)]
        both = in_m & in_p
        # inner faces: -{lambda grad u . n}[v] - {lambda grad v . n}[u] + pen [u][v]
        sel = lambda tri, f: tuple(a[f] for a in tri)               # noqa: E731
        lm, lp = self.lam_q(q, sel(F.m, both)), self.lam_q(q, sel(F.p, both))
        wl = self.face_w * ell[both, None]                          # [F, q]
        pen = (SIGMA_INNER * 0.5 * 0.5 * (lm + lp) / ell[both])[:, None]
        sides = [(*self._face_side(*sel(F.m, both), x[both]), lm),
                 (*self._face_side(*sel(F.p, both), x[both]), lp)]
        sign = (1.0, -1.0)
        n = F.n[both]
        for si, (di, phi_i, g_i, l_i) in enumerate(sides):
            for sj, (dj, phi_j, g_j, l_j) in enumerate(sides):
                dn_i = np.einsum("fia,fa->fi", g_i, n) * l_i[:, None]   # lambda grad phi_i . n
                dn_j = np.einsum("fja,fa->fj", g_j, n) * l_j[:, None]
                v = (-0.5 * sign[si] * np.einsum("fq,fj,fqi->fij", wl, dn_j, phi_i)
                     - 0.5 * sign[sj] * np.einsum("fq,fi,fqj->fij", wl, dn_i, phi_j)
                     + sign[si] * sign[sj] * np.einsum("fq,fqi,fqj->fij", wl * pen, phi_i, phi_j))
                add(di, dj, v)

        # boundary faces: -lambda grad u . n v - lambda grad v . n u + pen u v;
        # the physical boundary, and the faces a patch cuts (its own side)
        cut_m, cut_p = in_m & ~in_p, in_p & ~in_m
        bnd = [(F.bt, F.ba, F.bb, F.bn, keep[tid(F.bt)]),
               (F.m, F.a, F.b, F.n, cut_m), (F.p, F.a, F.b, -F.n, cut_p)]
        for tri, a, b, nrm, f in bnd:
            if not f.any():
                continue
            tri, a, b, nrm = sel(tri, f), a[f], b[f], nrm[f]
            ell = np.linalg.norm(b - a, axis=-1)
            x = a[:, None] + self.face_t[None, :, None] * (b - a)[:, None]
            lb = self.lam_q(q, tri)
            wl = self.face_w * ell[:, None]
            d, phi, g = self._face_side(*tri, x)
            dn = np.einsum("fia,fa->fi", g, nrm) * lb[:, None]
            pen = (SIGMA_BOUNDARY * lb / ell)[:, None]
            add(d, d, -np.einsum("fq,fj,fqi->fij", wl, dn, phi)
                - np.einsum("fq,fi,fqj->fij", wl, dn, phi)
                + np.einsum("fq,fqi,fqj->fij", wl * pen, phi, phi))
        size = m.K * m.N
        A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(size, size))
        A.sum_duplicates()
        return A

    def _rhs(self):
        m = self.mesh
        b = np.zeros(m.K * m.N)
        np.add.at(b, self.dofs, np.full(self.dofs.shape, m.area / 3.0))   # f = 1
        return b

    def patch_matrix(self, mu: float, subdomains) -> tuple:
        """(dofs [n] of the union of ``subdomains``, ascending; dense
        [n, n] float64 SWIPDG matrix of the union with zero Dirichlet data
        on its whole boundary)."""
        m = self.mesh
        subs = np.asarray(sorted(subdomains))
        keep = np.isin(self.sub, subs)
        A = self._assemble(0, keep) + mu * self._assemble(1, keep)
        dofs = (subs[:, None] * m.N + np.arange(m.N)).reshape(-1)
        return dofs, A.tocsr()[dofs][:, dofs].toarray()

    # ---- estimator ----------------------------------------------------
    def flux(self, u, mu):
        """RT0 flux of u: (S [T], P [T, 2]) with t(x) = (S x - P) / (2|T|)
        on each triangle (S the outward flux through its boundary)."""
        m, F = self.mesh, self.faces
        nt = len(self.sub)
        tid = lambda tri: (tri[1] * m.nx + tri[0]) * 2 + tri[2]      # noqa: E731
        S, P = np.zeros(nt), np.zeros((nt, 2))

        def deposit(tri, a, b, flux):
            k = tid(tri)
            opp = self.verts[k].sum(1) - a - b                      # vertex off the face
            np.add.at(S, k, flux)
            np.add.at(P, k, flux[:, None] * opp)

        ell = np.linalg.norm(F.b - F.a, axis=-1)
        x = F.a[:, None] + self.face_t[None, :, None] * (F.b - F.a)[:, None]
        lm, lp = self.lam(mu, F.m), self.lam(mu, F.p)
        um, up = (self._trace(tri, u, x) for tri in (F.m, F.p))
        g = [np.einsum("fia,fi,fa->f", self.grads[tid(tri)], u[m.dofs(*tri)], F.n)
             for tri in (F.m, F.p)]
        pen = SIGMA_INNER * 0.5 * 0.5 * (lm + lp) / ell
        integrand = (-0.5 * (lm * g[0] + lp * g[1]))[:, None] + pen[:, None] * (um - up)
        flux = ell * (integrand * self.face_w).sum(-1)              # along n: minus -> plus
        deposit(F.m, F.a, F.b, flux)
        deposit(F.p, F.a, F.b, -flux)

        ell = np.linalg.norm(F.bb - F.ba, axis=-1)
        x = F.ba[:, None] + self.face_t[None, :, None] * (F.bb - F.ba)[:, None]
        lb = self.lam(mu, F.bt)
        ub = self._trace(F.bt, u, x)
        gb = np.einsum("fia,fi,fa->f", self.grads[tid(F.bt)], u[m.dofs(*F.bt)], F.bn)
        integrand = (-lb * gb)[:, None] + (SIGMA_BOUNDARY * lb / ell)[:, None] * ub
        deposit(F.bt, F.ba, F.bb, ell * (integrand * self.face_w).sum(-1))
        return S, P

    def parts(self, u, mu):
        """([K] eta_nc, [K] eta_r, [K] eta_df) of the field u [K, N] (or
        [K*N]): the squared local quantities."""
        m = self.mesh
        u = np.asarray(u, np.float64).reshape(-1)
        area = m.area
        x = self.vol_x
        lam_bar, lam_hat = self.lam(MU_BAR, self.tri), self.lam(MU_HAT, self.tri)   # [T]

        uo = self.oswald_error(u)
        g_o = np.einsum("tia,ti->ta", self.grads, uo)
        nc = area * lam_bar * (g_o ** 2).sum(-1)

        S, P = self.flux(u, mu)
        t_x = (S[:, None, None] * x - P[:, None, :]) / (2.0 * area)  # [T, q, 2]
        gu = np.einsum("tia,ti->ta", self.grads, u[self.dofs])
        z = self.lam(mu, self.tri)[:, None, None] * gu[:, None, :] + t_x
        df = area * (self.vol_w * (z ** 2).sum(-1)).sum(-1) / lam_hat

        res = 1.0 - (S / area)[:, None]
        r = area * (self.vol_w * res ** 2).sum(-1)
        per_sub = lambda v: np.bincount(self.sub, v, m.K)          # noqa: E731
        min_ev = np.full(m.K, np.inf)
        np.minimum.at(min_ev, self.sub, lam_hat)
        scale = POINCARE / min_ev * m.subdomain_diameter ** 2
        return per_sub(nc), per_sub(r) * scale, per_sub(df)

    def indicators(self, u, mu):
        """[K] eta_nc + eta_r + eta_df of the field u [K, N] (or [K*N])."""
        nc, r, df = self.parts(u, mu)
        return nc + r + df

