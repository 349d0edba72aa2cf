"""Localized a-posteriori error estimators (elliptic and parabolic; 2D
and 3D hex, orders 1-2).

The port of ``pylrbms_tpu/estimators.py`` — the
OS2015/RS2017 localized estimator

  eta_nc_sq[ii] = || u - I_os(u) ||^2_{lambda_bar, ii}
  eta_r_sq[ii]  = (C_P / lambda_min,ii) H_ii^2 * int (f(mu) - div t)^2
  eta_df_sq[ii] = int (lam(mu) k grad u + t) . (lam_hat k)^{-1} (...)
  eta = (1/sqrt(alpha(mu,mu_bar))) * ( sqrt(gamma(mu,mu_bar)) ||eta_nc_sq||
        + (1/sqrt(alpha(mu,mu_hat))) ||eta_r_sq + eta_df_sq|| )

with the reference's as-executed quirks (alpha from the first component
only; squared locals entering the norms), and :class:`ParabolicEstimator`
for implicit-Euler trajectories.  U may carry a leading lane axis
and mu lane-batched leaves; theta and theta_f then carry the lane axis too
(``[B, Q]``), which is what the batched online step feeds in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .parameters import evaluate_coefficients
from .ops.oswald import OswaldOperator
from .ops.fluxreco import FluxReconstructor
from .ops.rt1 import rt_tab_any_order
from .ops.rt1hex import rt_tab_any_order3
from .ops import assembly as asm
from .ops import assembly3d as asm3
from .utils.timers import GLOBAL_TIMINGS


@dataclass
class EstimatorData:
    """All precomputed per-subdomain tensors the estimator needs."""
    E_bar: torch.Tensor         # [K, N, N] elliptic product at lambda_bar
    L2: torch.Tensor            # [K, N, N]
    M_aa: torch.Tensor          # [Q, Q, K, N, N]   (None on lean models)
    BB: torch.Tensor            # [K, Nrt, Nrt]     (None on lean models)
    M_ab: torch.Tensor          # [Q, K, N, Nrt]    (None on lean models)
    A_div: torch.Tensor         # [N, Nrt]
    R_dd: torch.Tensor          # [K, Nrt, Nrt]     (None on lean models)
    d_vec: torch.Tensor         # [Qf, K, Nrt]
    rf_qq: torch.Tensor         # [Qf, Qf, K]
    min_ev: torch.Tensor        # [K]
    diam: torch.Tensor          # [K]
    oswald: OswaldOperator
    flux: FluxReconstructor
    lambda_funcs: list
    lambda_coeffs: list
    f_coeffs: list
    mu_bar: dict
    mu_hat: dict
    parameter_type: Optional[dict]
    f_funcs: list = None
    lambda_hat: object = None


# position of the K axis of each per-subdomain estimator tensor
K_AXIS = {"E_bar": 0, "L2": 0, "BB": 0, "R_dd": 0, "min_ev": 0, "diam": 0,
          "M_aa": 2, "M_ab": 1, "d_vec": 1, "rf_qq": 2}


def _tensor_getter(data, tensors, band):
    """name -> the caller's tensor, else the data's (cut to ``band`` =
    (k0, k1) along its K axis when a band is asked for)."""
    tensors = tensors or {}

    def get(name):
        if name in tensors:
            return tensors[name]
        v = getattr(data, name)
        if band is None:
            return v
        return v.narrow(K_AXIS[name], band[0], band[1] - band[0])
    return get


def _band_rows(band, *vs):
    """The band's subdomain rows of [..., K, n] tensors (all of them
    without a band)."""
    if band is None:
        return vs
    return tuple(v[..., band[0]:band[1], :] for v in vs)


def _volume_tables(data, dtype, device) -> dict:
    """The positive form's U- and mu-independent volume tables: the
    quadrature weights, basis gradients and the degree-matched RT tab
    (``chi``, ``div_q`` at the quadrature points, the cell gather ``idx`` of
    the local RT dofs) with lambda_q, lambda_hat and f_q at the physical
    quadrature points ([K, ...] leading)."""
    sp = data.flux.space
    if getattr(sp, "dim", 2) == 3:
        xq = asm3.vol_points(sp, dtype, device)                # [K, C, nq, 3]
        chi, idx, div_q, _nrt = rt_tab_any_order3(sp)          # chi [nq, nf, 3]
        div_q = np.ascontiguousarray(div_q)
    else:
        xq = asm.tensor(asm.vol_points(sp), dtype, device)     # [K, s, s, T, nq, 2]
        chi, idx, div_q, _nrt = rt_tab_any_order(sp)
    return {"w": asm.tensor(sp.vol_w, dtype, device),
            "dphi": asm.tensor(sp.vol_dphi, dtype, device),
            "chi": asm.tensor(chi, dtype, device),
            "div_q": asm.tensor(div_q, dtype, device),
            "idx": torch.as_tensor(idx.reshape(-1), device=device),
            "nf": idx.shape[-1],
            "lam_q": torch.stack([lf(xq).to(dtype) for lf in data.lambda_funcs]),
            "lam_hat": data.lambda_hat(xq).to(dtype),
            "f_q": torch.stack([ff(xq).to(dtype) for ff in data.f_funcs])}


# the subdomain axis of the point-valued volume tables
_POINT_K_AXIS = {"lam_q": 1, "lam_hat": 0, "f_q": 1}


def _band_tables(tables, band):
    """The tables with their point values cut to the band's subdomains (a
    view: no copy, no upload)."""
    if band is None:
        return tables
    return {**tables, **{n: tables[n].narrow(a, band[0], band[1] - band[0])
                         for n, a in _POINT_K_AXIS.items()}}


def _contract(theta, stacked):
    """sum_q theta[..., q] * stacked[q, ...] with theta [Q] or [B, Q]."""
    return torch.tensordot(theta, stacked, dims=([-1], [0]))


def aggregate_eta(est, mu, eta_nc, eta_r, eta_df, decompose: bool = False,
                  paper_convention: bool = False, norm=None):
    """Aggregate the squared local quantities [B, K] into eta (and with
    ``decompose`` the [K, B] triples and marking indicators) for one mu.
    ``norm`` is the 2-norm over the subdomains; a caller that holds a band
    of K passes its all-reduced norm (``parallel.mesh.psum_norm``)."""
    a_bar = est.alpha(mu, est.data.mu_bar)
    g_bar = est.gamma(mu, est.data.mu_bar)
    a_hat = est.alpha(mu, est.data.mu_hat)
    if paper_convention:
        eta_nc = torch.sqrt(torch.clamp(eta_nc, min=0.0))
        eta_r = torch.sqrt(torch.clamp(eta_r, min=0.0))
        eta_df = torch.sqrt(torch.clamp(eta_df, min=0.0))

    if norm is None:
        def norm(v):
            return torch.sqrt(torch.sum(v * v))

    eta = (torch.sqrt(g_bar) * norm(eta_nc)
           + (1.0 / torch.sqrt(a_hat)) * norm(eta_r + eta_df)) / torch.sqrt(a_bar)
    if not decompose:
        return eta
    nc, r, df = (torch.movedim(v, 0, -1) for v in (eta_nc, eta_r, eta_df))
    indicators = (2.0 / a_bar) * (g_bar * nc ** 2 + (1.0 / a_hat) * (r + df) ** 2)
    return eta, (nc, r, df), indicators


class EllipticEstimator:
    poincare_constant = 1.0 / math.pi ** 2      # C_P

    def __init__(self, data: EstimatorData, alpha_first_component_only: bool = True):
        self.data = data
        self.alpha_first_component_only = alpha_first_component_only
        self._tables = {}

    def tables(self, dtype, device):
        """The U- and mu-independent tables of an evaluation in ``dtype`` on
        ``device``, built on first use and kept (each build counts one
        ``estimate.table_builds`` of ``GLOBAL_TIMINGS``): the flux
        reconstruction's face tables and, where the data has f and
        lambda_hat, the positive form's volume tables (:func:`_volume_tables`)."""
        d = self.data
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (dtype, device, tuple(d.lambda_funcs), tuple(d.f_funcs or ()), d.lambda_hat)
        got = self._tables.get(key)
        if got is None:
            GLOBAL_TIMINGS.count("estimate.table_builds")
            d.flux.tables(d.lambda_funcs)
            got = self._tables[key] = (
                None if d.f_funcs is None or d.lambda_hat is None
                else _volume_tables(d, dtype, device))
        return got

    def _ratios(self, mu, mu_ref):
        # a mu of plain numbers (or none, {}) names no device: take the model's
        bare = not any(isinstance(v, torch.Tensor) for v in (mu or {}).values())
        th = evaluate_coefficients(self.data.lambda_coeffs, mu,
                                   device=self.data.diam.device if bare else None)
        th_ref = evaluate_coefficients(self.data.lambda_coeffs, mu_ref,
                                       device=th.device)
        return th / th_ref

    def alpha(self, mu, mu_ref):
        r = self._ratios(mu, mu_ref)
        if self.alpha_first_component_only:
            return r[..., 0]     # reference early-return quirk
        return torch.min(r, dim=-1).values

    def gamma(self, mu, mu_ref):
        return torch.max(self._ratios(mu, mu_ref), dim=-1).values

    def reconstruct_flux(self, U, mu=None, per_component: bool = False):
        """Affine flux reconstruction; [..., K, Nrt] (or [Q, ..., K, Nrt]);
        an ``estimate.flux`` span of ``GLOBAL_TIMINGS``."""
        d = self.data
        with GLOBAL_TIMINGS.span("estimate.flux"):
            t_q = d.flux.apply_components(d.lambda_funcs, U)          # [Q, ..., N_rt_global]
            if per_component:
                return d.flux.restrict(t_q)
            theta = evaluate_coefficients(d.lambda_coeffs, mu, dtype=t_q.dtype,
                                          device=t_q.device)           # [Q] | [B, Q]
            th = theta.movedim(-1, 0)                                  # [Q(, B)]
            th = th.reshape(th.shape + (1,) * (t_q.ndim - th.ndim))
            return d.flux.restrict((th * t_q).sum(0))

    def local_quantities(self, U, mu, tensors: dict | None = None,
                         elliptic_reconstruction: bool = False, d_model=None,
                         band=None):
        """Matrix-form squared local quantities; U [..., K, N] -> each
        [..., K] (needs the non-lean estimator tensors).

        ``band`` = (k0, k1): the quantities of subdomains [k0, k1) only
        (U is still the whole field: the Oswald interpolation and the flux
        reconstruction read the neighbors); ``tensors`` then holds the
        band's tensors, and any missing one is cut from the data.

        ``elliptic_reconstruction`` adds the parabolic extension of the
        residual part, per subdomain (``d_model`` supplies the operator, the
        rhs and the inverse mass):
          eta_r += (M^-1 B u)^T L2 (M^-1 B u) - (M^-1 F)^T L2 (M^-1 F)
                   - 2 (M^-1 (B u - F))^T L2 div(t)."""
        d = self.data
        g = _tensor_getter(d, tensors, band)
        dtype, dev = U.dtype, U.device
        theta = evaluate_coefficients(d.lambda_coeffs, mu, dtype=dtype, device=dev)
        theta_f = evaluate_coefficients(d.f_coeffs, mu, dtype=dtype, device=dev)
        t = self.reconstruct_flux(U, mu)
        U_o = d.oswald.apply(U)
        U, t, U_o = _band_rows(band, U, t, U_o)
        eta_nc = torch.einsum("...kn,knm,...km->...k", U_o, g("E_bar"), U_o)
        rf = torch.einsum("...p,...r,prk->...k", theta_f, theta_f, g("rf_qq"))
        r_fd = torch.einsum("...p,pkn,...kn->...k", theta_f, g("d_vec"), t)
        r_dd = torch.einsum("...kn,knm,...km->...k", t, g("R_dd"), t)
        eta_r = rf - 2.0 * r_fd + r_dd
        if elliptic_reconstruction:
            if d_model is None:
                raise ValueError("elliptic_reconstruction needs the model (d_model=)")
            if band is not None:
                raise ValueError("the elliptic reconstruction is evaluated on all subdomains")
            L2 = g("L2")
            BU_R = d_model.l2_solve(d_model.operator_apply(U, mu))
            F_R = d_model.l2_solve(d_model.rhs(mu)).expand(U.shape)
            div_t = torch.einsum("nr,...kr->...kn", d.A_div, t)

            def form(a, b):
                return torch.einsum("...kn,knm,...km->...k", a, L2, b)

            eta_r = (eta_r + form(BU_R, BU_R) - form(F_R, F_R)
                     - 2.0 * form(BU_R - F_R, div_t))
        scale = (self.poincare_constant / g("min_ev")) * g("diam") ** 2
        eta_r = eta_r * scale
        aa = torch.einsum("...p,...r,prknm,...kn,...km->...k",
                          theta, theta, g("M_aa"), U, U)
        bb = torch.einsum("...kn,knm,...km->...k", t, g("BB"), t)
        ab = torch.einsum("...p,pknm,...kn,...km->...k", theta, g("M_ab"), U, t)
        return eta_nc, eta_r, aa + bb + 2.0 * ab

    def local_quantities_positive(self, U, mu, tensors: dict | None = None, band=None):
        """Cancellation-free evaluation of the squared local quantities as
        manifestly non-negative integrals (kappa = I; the Oswald witness
        u - I_os(u) in an ``estimate.oswald`` span of ``GLOBAL_TIMINGS``):

          eta_r_sq  ~ int (f(mu) - div t)^2,
          eta_df_sq = int (lam(mu) k grad u + t) . (lam_hat k)^{-1} (...).

        ``band``: as in :meth:`local_quantities`.
        """
        d = self.data
        sp = d.flux.space
        if getattr(sp, "dim", 2) == 3:
            return self._local_quantities_positive3(U, mu, tensors, band)
        dtype, dev = U.dtype, U.device
        g = _tensor_getter(d, tensors, band)
        theta = evaluate_coefficients(d.lambda_coeffs, mu, dtype=dtype, device=dev)
        theta_f = evaluate_coefficients(d.f_coeffs, mu, dtype=dtype, device=dev)

        E_bar = g("E_bar").to(dtype)
        t_loc = self.reconstruct_flux(U, mu)                   # [..., K, Nrt]
        with GLOBAL_TIMINGS.span("estimate.oswald"):
            U_o = d.oswald.apply(U)
        U, t_loc, U_o = _band_rows(band, U, t_loc, U_o)
        eta_nc = torch.einsum("...kn,knm,...km->...k", U_o, E_bar, U_o)

        tb = _band_tables(self.tables(dtype, dev), band)
        w = tb["w"]
        area = sp.hx * sp.hy
        lam_mu = _contract(theta, tb["lam_q"])                 # [..., K,s,s,T,nq]

        # per-cell tables on 'crisscross'; the degree-matched RT basis (RT0
        # for order 1, RT1 for order 2) with div at the quadrature points
        ein = lambda e: asm.vol_ein(sp, e)                     # noqa: E731
        Uc = U.reshape(U.shape[:-2] + (U.shape[-2], sp.s, sp.s, sp.T, sp.nb))
        gu = torch.einsum(ein("...kyxtj,tqja->...kyxtqa"), Uc, tb["dphi"])
        t_cell = t_loc[..., tb["idx"]].reshape(
            t_loc.shape[:-1] + (sp.s, sp.s, sp.T, tb["nf"]))
        t_q = torch.einsum(ein("...kyxte,tqea->...kyxtqa"), t_cell, tb["chi"])
        z = lam_mu[..., None] * gu + t_q                       # kappa = I
        df_int = (z * z).sum(-1) / tb["lam_hat"]
        eta_df = area * torch.einsum(ein("tq,...kyxtq->...k"), w, df_int)

        f_mu = _contract(theta_f, tb["f_q"])
        div_t = torch.einsum(ein("...kyxte,tqe->...kyxtq"), t_cell, tb["div_q"])
        res = f_mu - div_t
        scale = ((self.poincare_constant / g("min_ev")) * g("diam") ** 2).to(dtype)
        eta_r = area * torch.einsum(ein("tq,...kyxtq->...k"), w, res * res) * scale
        return eta_nc, eta_r, eta_df

    def _local_quantities_positive3(self, U, mu, tensors: dict | None = None, band=None):
        """3D hex variant of :meth:`local_quantities_positive` (the same
        manifestly non-negative integrals; kappa = I)."""
        d = self.data
        sp = d.flux.space
        dtype, dev = U.dtype, U.device
        g = _tensor_getter(d, tensors, band)
        theta = evaluate_coefficients(d.lambda_coeffs, mu, dtype=dtype, device=dev)
        theta_f = evaluate_coefficients(d.f_coeffs, mu, dtype=dtype, device=dev)

        E_bar = g("E_bar").to(dtype)
        t_loc = self.reconstruct_flux(U, mu)                   # [..., K, Nrt]
        with GLOBAL_TIMINGS.span("estimate.oswald"):
            U_o = d.oswald.apply(U)
        U, t_loc, U_o = _band_rows(band, U, t_loc, U_o)
        eta_nc = torch.einsum("...kn,knm,...km->...k", U_o, E_bar, U_o)

        tb = _band_tables(self.tables(dtype, dev), band)
        w = tb["w"]
        lam_mu = _contract(theta, tb["lam_q"])                 # [..., K, C, nq]

        C = sp.s ** 3
        Uc = U.reshape(U.shape[:-2] + (U.shape[-2], C, sp.nb))
        gu = torch.einsum("...kcj,qja->...kcqa", Uc, tb["dphi"])
        t_cell = t_loc[..., tb["idx"]].reshape(t_loc.shape[:-1] + (C, tb["nf"]))
        t_q = torch.einsum("...kce,qea->...kcqa", t_cell, tb["chi"])
        z = lam_mu[..., None] * gu + t_q                       # kappa = I
        df_int = (z * z).sum(-1) / tb["lam_hat"]
        eta_df = sp.volume * torch.einsum("q,...kcq->...k", w, df_int)

        f_mu = _contract(theta_f, tb["f_q"])
        div_t = torch.einsum("...kce,qe->...kcq", t_cell, tb["div_q"])
        res = f_mu - div_t
        scale = ((self.poincare_constant / g("min_ev")) * g("diam") ** 2).to(dtype)
        eta_r = sp.volume * torch.einsum("q,...kcq->...k", w, res * res) * scale
        return eta_nc, eta_r, eta_df

    def estimate(self, U, mu, decompose: bool = False,
                 paper_convention: bool = False, d=None,
                 elliptic_reconstruction: bool = False):
        """U [K, N] or [B, K, N] at one mu.  Returns eta and, with
        ``decompose``, the local triples [K, B] and indicators [K, B].
        ``elliptic_reconstruction`` (the parabolic residual extension, with
        the model ``d``) needs the matrix-form tensors of a non-lean model."""
        Ub = U[None] if U.ndim == 2 else U
        if self.data.M_aa is None and not elliptic_reconstruction:
            eta_nc, eta_r, eta_df = self.local_quantities_positive(Ub, mu)
        elif self.data.M_aa is None:
            raise ValueError(
                "lean models (discretize(lean=True)) carry no matrix-form "
                "estimator tensors; the elliptic-reconstruction (parabolic) "
                "estimate needs them: discretize with lean=False")
        else:
            eta_nc, eta_r, eta_df = self.local_quantities(
                Ub, mu, elliptic_reconstruction=elliptic_reconstruction, d_model=d)
        return aggregate_eta(self, mu, eta_nc, eta_r, eta_df, decompose,
                             paper_convention=paper_convention)


class ParabolicEstimator(EllipticEstimator):
    """The parabolic estimator of an implicit-Euler trajectory U
    [nt+1, K, N]; needs the model ``d`` (an ``InstationaryBlockModel``: its
    operator, rhs, inverse mass and time grid).

    The elliptic parts (with the elliptic-reconstruction extension) are
    evaluated at ``_t = 0`` unless mu carries a time, and scaled by
    2 sqrt(dt/3); the time-stepping residual is dt/3 ||B(u^{n+1}-u^n)||^2_{M^-1}
    per step; the time-derivative nonconformity is the Oswald error of the
    increments in the E_bar product over dt."""

    def estimate(self, U, mu, d=None, decompose: bool = False):
        if d is None:
            raise ValueError("the parabolic estimate needs the model (d=)")
        data = self.data
        mu = dict(mu)
        mu.setdefault("_t", 0.0)
        dt = d.T / d.nt
        eta, (nc, r, df), _ = super().estimate(
            U, mu, decompose=True, d=d, elliptic_reconstruction=True)
        dU = U[1:] - U[:-1]
        BdU = d.operator_apply(dU, mu)
        MinvBdU = d.l2_solve(BdU)
        time_res = torch.sqrt(dt / 3.0 * torch.einsum("bkn,bkn->b", MinvBdU, BdU))
        c = 2.0 * math.sqrt(dt / 3.0)
        eta = eta * c
        nc, r, df = nc * c, r * c, df * c
        U_o = data.oswald.apply(U)
        dU_o = U_o[1:] - U_o[:-1]
        tdnc = torch.einsum("bkn,knm,bkm->kb", dU_o, data.E_bar, dU_o) / dt
        tdnc = torch.sqrt(torch.clamp(tdnc, min=0.0))
        est = (torch.linalg.norm(torch.atleast_1d(eta)) + torch.linalg.norm(time_res)
               + torch.linalg.norm(tdnc))
        return est, (nc, r, df, time_res, tdnc)
