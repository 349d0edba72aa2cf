"""RT0 hex diffusive flux reconstruction (3D), batched over all faces.

The port of ``pylrbms_tpu/ops/fluxreco3d.py``: per affine diffusion
component reconstruct t_q in tensor RT0 on hexes from the face moments of
:class:`~pylrbms_tpu_torch.ops.fluxreco.FluxReconstructor` (its integrands
are dimension-agnostic and reused); only the bookkeeping — three face
families X/Y/Z and six boundary sides — is 3D.
"""
from __future__ import annotations

import numpy as np
import torch

from .assembly import IPDGParams, DEFAULT_IPDG
from .fluxreco import FluxReconstructor


class FluxReconstructor3D(FluxReconstructor):
    """``apply(lam_fn, U)`` -> [..., K, N_rt] local RT0 hex dofs.  The flat
    global layout is X [Sz*Sy*(Sx+1)], Y [Sz*(Sy+1)*Sx], Z [(Sz+1)*Sy*Sx],
    each face with ``nm`` moments, then any interior dofs."""

    nm = 1
    required_order = 1

    def __init__(self, space, kappa_fn=None, ipdg: IPDGParams = DEFAULT_IPDG,
                 dtype=torch.float64, device=None):
        if space.order != self.required_order:
            raise ValueError(f"{type(self).__name__} expects an order-"
                             f"{self.required_order} DG space")
        self.space = space
        self.kappa_fn = kappa_fn
        self.ipdg = ipdg
        self.dtype = dtype
        self.device = device
        g = space.grid
        self.Sx, self.Sy, self.Sz = g.global_nx, g.global_ny, g.global_nz
        self.rt_l2g = torch.as_tensor(self._local_to_global(space), device=device)
        gz, gy, gx = np.meshgrid(np.arange(self.Sz), np.arange(self.Sy),
                                 np.arange(self.Sx), indexing="ij")
        self.cell_org = (np.asarray(g.lower_left)
                         + np.stack([gx, gy, gz], axis=-1) * self.scale)  # [Sz,Sy,Sx,3]

    @property
    def scale(self) -> np.ndarray:
        g = self.space.grid
        return np.array([g.hx, g.hy, g.hz])

    def _u_block_to_cells(self, U):
        sp, g = self.space, self.space.grid
        lead = U.shape[:-2]
        U = U.reshape(lead + (g.kz, g.ky, g.kx, sp.s, sp.s, sp.s, sp.nb))
        U = torch.movedim(U, -4, -6)
        U = torch.movedim(U, -3, -4)
        return U.reshape(lead + (self.Sz, self.Sy, self.Sx, sp.nb))

    def apply_global(self, lam_fn, U):
        """U [..., K, N] -> global RT dofs [..., N_rt_global]."""
        sp = self.space
        nb, nm = sp.nb, self.nm
        S = (self.Sz, self.Sy, self.Sx)
        uc = self._u_block_to_cells(U)             # [..., Sz, Sy, Sx, nb]
        out_dt = torch.promote_types(uc.dtype, self.dtype)
        lead = uc.shape[:-4]
        org = self.cell_org
        parts = []
        # (family, cell axis of [Sz, Sy, Sx], lo side, hi side)
        for fam, ax, lo, hi in (("X", 2, "left", "right"), ("Y", 1, "bottom", "top"),
                                ("Z", 0, "near", "far")):
            n = S[ax]
            fshape = list(S)
            fshape[ax] = n + 1
            dof = torch.zeros(lead + tuple(fshape) + (nm,), dtype=out_dt, device=uc.device)
            ua = -4 + ax                            # the axis in uc [..., Sz, Sy, Sx, nb]
            da = -4 + ax                            # the axis in dof [..., ., ., ., nm]
            if n > 1:
                x_m, x_p = self._phys_pts(sp.face_tabs[fam],
                                          np.take(org, np.arange(n - 1), axis=ax).reshape(-1, 3))
                um = uc.narrow(ua, 0, n - 1)
                up = uc.narrow(ua, 1, n - 1)
                inner = self._face_moment_inner(fam, lam_fn,
                                                um.reshape(lead + (-1, nb)),
                                                up.reshape(lead + (-1, nb)), x_m, x_p)
                dof.narrow(da, 1, n - 1).copy_(inner.reshape(um.shape[:-1] + (nm,)))
            for side, c, f in ((lo, 0, 0), (hi, n - 1, n)):
                x, _ = self._phys_pts(sp.face_tabs["bnd_" + side],
                                      np.take(org, c, axis=ax).reshape(-1, 3))
                ub = uc.select(ua, c)
                dof.select(da, f).copy_(self._face_moment_boundary(
                    side, lam_fn, ub.reshape(lead + (-1, nb)), x
                ).reshape(ub.shape[:-1] + (nm,)))
            parts.append(dof.reshape(lead + (-1,)))
        parts += self._extra_parts(lam_fn, uc, out_dt)
        return torch.cat([p.to(out_dt) for p in parts], dim=-1)
