"""Experimental-order-of-convergence studies with table rendering.

The port of ``pylrbms_tpu/EOC.py``: per level solve, compare against a
higher-order (p=2) reference solution on the finest grid through the
nested prolongation (``ops/prolong.py``), and print norms, estimator
indicators and estimates with EOC columns and estimator efficiencies, in
plain column formatting.

* accuracies: h (max element diameter), H (max subdomain diameter), dt
* norms: L2 and elliptic_mu_bar against the prolonged reference solution
* indicators: ||eta_nc||, ||eta_r||, ||eta_df|| (+ R_T, partial_t_nc in time)
* estimate: eta with efficiency = norm / estimate

The reference solves run on ``device`` (default: the current CUDA
device); pass ``device="cpu"`` together with a CPU ``disc``.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .discretize_elliptic_swipdg import discretize as discretize_elliptic_swipdg
from .discretize_parabolic_swipdg import discretize as discretize_parabolic_swipdg
from .ops.prolong import prolong


def default_refine(cfg: dict) -> dict:
    """Halve h by one extra refinement level."""
    out = dict(cfg)
    out["num_refinements"] = cfg.get("num_refinements", 2) + 1
    return out


class EocStudy:
    level_info_title = "level"
    accuracies: Sequence[str] = ()
    norms: Sequence[str] = ()
    indicators: Sequence[str] = ()
    estimates: Sequence = ()
    max_levels = 2

    # --- per-level hooks -------------------------------------------------
    def solve(self, level):
        raise NotImplementedError

    def level_info(self, level):
        raise NotImplementedError

    def accuracy(self, level, aid):
        raise NotImplementedError

    def compute_norm(self, level, nid):
        raise NotImplementedError

    def compute_indicator(self, level, iid):
        raise NotImplementedError

    def compute_estimate(self, level, eid):
        raise NotImplementedError

    # --- the study loop --------------------------------------------------
    def run(self, only_these: Optional[Sequence[str]] = None):
        acc = [a for a in self.accuracies if not only_these or a in only_these]
        norms = [n for n in self.norms if not only_these or n in only_these]
        inds = [i for i in self.indicators if not only_these or i in only_these]
        ests = [e for e in self.estimates if not only_these or e[0] in only_these]
        self.data: Dict[int, dict] = getattr(self, "data", {}) or {}
        eoc_heads = [f"EOC({a})" if len(acc) > 1 else "EOC" for a in acc]

        headers = [self.level_info_title] + list(acc)
        for n in norms + inds:
            headers += [n] + eoc_heads
        for eid, _ in ests:
            headers += [f"{eid} eff."] + eoc_heads
        widths = [max(12, len(h) + 1) for h in headers]
        print("  ".join(h.rjust(w) for h, w in zip(headers, widths)))
        print("  ".join("-" * w for w in widths))

        prev: Dict[str, float] = {}
        prev_acc: Dict[str, float] = {}
        for level in range(self.max_levels + 1):
            self.data.setdefault(level, {})
            self.solve(level)
            row = [str(self.level_info(level))]
            accs = {a: float(self.accuracy(level, a)) for a in acc}
            row += [f"{accs[a]:.2e}" for a in acc]

            lv = self.data[level]
            lv["accuracy"] = accs

            def eoc(key, value):
                cells = []
                for a in acc:
                    if level == 0 or prev.get(key) in (None, 0.0):
                        cells.append("----")
                    else:
                        den = math.log(accs[a] / prev_acc[a])
                        e = math.log(value / prev[key]) / den if den != 0 else math.inf
                        lv.setdefault("eoc", {}).setdefault(key, e)
                        cells.append(f"{e:.2f}" if den != 0 else "inf")
                return cells

            new_prev = {}
            for n in norms:
                v = float(self.compute_norm(level, n))
                self.data[level].setdefault("norm", {})[n] = v
                row += [f"{v:.2e}"] + eoc(n, v)
                new_prev[n] = v
            for i in inds:
                v = float(self.compute_indicator(level, i))
                self.data[level].setdefault("indicator", {})[i] = v
                row += [f"{v:.2e}"] + eoc(i, v)
                new_prev[i] = v
            for eid, nid in ests:
                v = float(self.compute_estimate(level, eid))
                nv = float(self.compute_norm(level, nid))
                self.data[level].setdefault("estimate", {})[eid] = v
                lv.setdefault("eff", {})[eid] = nv / v
                row += [f"{nv / v:.2f}"] + eoc(eid, v)
                new_prev[eid] = v
            prev = new_prev
            prev_acc = accs
            print("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        return self.data


class _LevelStudy(EocStudy):
    """The per-level state shared by the stationary and instationary
    studies: configs, models, solutions and prolongations per level (the
    reference is level -1)."""

    def _setup(self, gp_initializer, disc, base_cfg, refine, mu, p_ref,
               max_levels, device):
        self.max_levels = max_levels
        self.data = {}
        self._gpd, self._d, self._data, self._U, self._U_ref, self._cfg, self._cache = \
            {}, {}, {}, {}, {}, {}, {}
        self._init = gp_initializer
        self._disc = disc
        self.mu = mu
        self.p_ref = p_ref
        self.device = device
        self._cfg[0] = dict(base_cfg)
        for lvl in range(1, max_levels + 1):
            self._cfg[lvl] = refine(self._cfg[lvl - 1])

    def level_info(self, level):
        g = self._gpd[level]["grid"]
        return f"{g.num_elements}/{g.num_subdomains}"

    def accuracy(self, level, aid):
        g = self._gpd[level]["grid"]
        if aid == "h":
            return g.max_entity_diameter()
        if aid == "H":
            return g.subdomain_diameter()
        if aid == "dt":
            return self._cfg[level]["dt"]
        raise KeyError(aid)

    def _level_space(self, level):
        return self._data[level].get("block_space") or self._data[level]["space"]

    def compute_indicator(self, level, iid):
        return self._estimates(level)[iid]

    def compute_estimate(self, level, eid):
        return self._estimates(level)[eid]


class StationaryEocStudy(_LevelStudy):
    """The stationary study: the p_ref reference on the finest grid is the
    monolithic model, or above ``ref_block_threshold`` dofs a lean block
    model on the same mesh re-laid out into more, smaller subdomains and
    solved on the host by scipy ``splu``."""

    level_info_title = "|grid|/|Grid|"
    accuracies = ("h", "H")
    norms = ("L2", "elliptic_mu_bar")
    indicators = ("eta_nc", "eta_r", "eta_df")
    estimates = (("eta", "elliptic_mu_bar"),)
    max_levels = 2
    ref_block_threshold = 20000

    def __init__(self, gp_initializer: Callable, disc: Callable, base_cfg: dict,
                 refine: Callable = default_refine, mu=1, p_ref: int = 2,
                 max_levels: int = 2, paper_convention: bool = False, device=None):
        # paper convention (OS2015 tables): unsquared local quantities
        self.paper_convention = paper_convention
        self._setup(gp_initializer, disc, base_cfg, refine, mu, p_ref, max_levels, device)
        self._cfg[-1] = dict(self._cfg[self.max_levels])

    def solve(self, level):
        if level in self._U:
            return
        self._gpd[level] = self._init(self._cfg[level])
        self._d[level], self._data[level] = self._disc(self._gpd[level])
        self._U[level] = self._d[level].solve(self._d[level].parse_parameter(self.mu))

    def _ref_dofs(self, cfg) -> int:
        """p_ref dof count of a config without building the space."""
        from . import basis as B
        gt = cfg.get("grid_type", "tri")
        half = cfg["half_num_fine_elements_per_subdomain_and_dim"]
        s = half * 2 ** cfg.get("num_refinements", 2)
        k = int(np.prod(cfg["num_subdomains"]))
        T = 1 if gt == "quad" else 2
        return k * s * s * T * B.num_basis(self.p_ref, "Q" if gt == "quad" else "A")

    def _reference(self):
        if -1 in self._U:
            return
        if self._ref_dofs(self._cfg[-1]) > self.ref_block_threshold:
            # re-lay out the same fine mesh into more, smaller subdomains
            # (double k, halve s) until the dense per-block tensors are
            # modest, discretize a lean block p_ref model and splu its CSR
            cfg_ref = dict(self._cfg[-1])
            half = cfg_ref["half_num_fine_elements_per_subdomain_and_dim"]
            while (half * 2 ** cfg_ref.get("num_refinements", 2) > 8
                   and cfg_ref.get("num_refinements", 2) > 0):
                cfg_ref["num_subdomains"] = [2 * k for k in cfg_ref["num_subdomains"]]
                cfg_ref["num_refinements"] = cfg_ref.get("num_refinements", 2) - 1
            self._gpd[-1] = self._init(cfg_ref)
            from .discretize_elliptic_block_swipdg import discretize as discretize_block
            import scipy.sparse.linalg as spla
            from .la.block import to_scipy_csr
            d_ref, data = discretize_block(self._gpd[-1], order=self.p_ref, lean=True,
                                           device=self.device)
            self._d[-1], self._data[-1] = d_ref, data
            mu = d_ref.parse_parameter(self.mu)
            A = to_scipy_csr(d_ref.assemble(mu)).tocsc()
            b = d_ref.rhs(mu).detach().to("cpu", torch.float64).numpy().ravel()
            x = spla.splu(A).solve(b)
            self._U[-1] = torch.as_tensor(x.reshape(d_ref.space.K, d_ref.space.N),
                                          dtype=d_ref.dtype, device=d_ref.device)
            return
        self._gpd[-1] = self._init(self._cfg[-1])
        self._d[-1], self._data[-1] = discretize_elliptic_swipdg(
            self._gpd[-1], self.p_ref, device=self.device)
        d_ref = self._d[-1]
        self._U[-1] = d_ref.solve(d_ref.parse_parameter(self.mu))

    def _prolonged(self, level):
        if level in self._U_ref:
            return self._U_ref[level]
        self._reference()
        U = self._U[level]
        if "reductor" in self._data[level]:
            U = self._data[level]["reductor"].reconstruct(U)
        ref = self._U[-1]
        self._U_ref[level] = prolong(self._level_space(level),
                                     U.to(ref.device, ref.dtype), self._d[-1].space)
        return self._U_ref[level]

    def compute_norm(self, level, nid):
        self._reference()
        diff = self._U[-1] - self._prolonged(level)
        prods = self._d[-1].products
        # the block-layout reference names the volume elliptic form at
        # mu_bar 'elliptic_bar', the monolithic one 'elliptic_mu_bar'
        P = (prods["l2"] if nid == "L2"
             else prods.get("elliptic_mu_bar", prods.get("elliptic_bar")))
        return float(torch.sqrt(torch.einsum("kn,knm,km->", diff, P, diff)))

    def _estimates(self, level):
        if level not in self._cache:
            mu = self._d[level].parse_parameter(self.mu)
            eta, (nc, r, df), _ = self._d[level].estimate(
                self._U[level], mu, decompose=True,
                paper_convention=self.paper_convention)
            self._cache[level] = {
                "eta_nc": float(torch.linalg.norm(nc)),
                "eta_r": float(torch.linalg.norm(r)),
                "eta_df": float(torch.linalg.norm(df)),
                "eta": float(eta)}
        return self._cache[level]


class InstationaryEocStudy(_LevelStudy):
    """Adds dt accuracy, L_oo / L2-in-time x L2 / elliptic-in-space norms
    (P1-in-time) and the parabolic indicator set."""

    level_info_title = "|grid|/|Grid|/nt"
    accuracies = ("h", "H", "dt")
    norms = tuple(f"{t} - {s}" for t, s in
                  itertools.product(["L_oo", "L2"], ["L2", "elliptic_mu_bar"]))
    indicators = ("eta_nc", "eta_r", "eta_df", "R_T", "partial_t_nc")
    estimates = (("eta", "L2 - elliptic_mu_bar"),)
    max_levels = 2

    def __init__(self, gp_initializer, disc, base_cfg, refine, reference_cfg,
                 mu=1, p_ref: int = 2, max_levels: int = 2, device=None):
        self._setup(gp_initializer, disc, base_cfg, refine, mu, p_ref, max_levels, device)
        self._cfg[-1] = dict(reference_cfg)
        self._T = float(base_cfg["T"])

    def solve(self, level):
        if level in self._U:
            return
        self._gpd[level] = self._init(self._cfg[level])
        nt = int(self._T / self._cfg[level]["dt"])
        self._d[level], self._data[level] = self._disc(self._gpd[level], self._T, nt)
        self._U[level] = self._d[level].solve(self._d[level].parse_parameter(self.mu))

    def level_info(self, level):
        return f"{super().level_info(level)}/{self._U[level].shape[0] - 1}"

    def _reference(self):
        if -1 in self._U:
            return
        self._gpd[-1] = self._init(self._cfg[-1])
        nt = int(self._T / self._cfg[-1]["dt"])
        self._d[-1], self._data[-1] = discretize_parabolic_swipdg(
            self._gpd[-1], self._T, nt, self.p_ref, device=self.device)
        self._U[-1] = self._d[-1].solve(self._d[-1].parse_parameter(self.mu))

    def _prolonged(self, level):
        """Prolong in space, then P1-interpolate in time onto the reference
        time grid."""
        if level in self._U_ref:
            return self._U_ref[level]
        self._reference()
        ref = self._U[-1]
        U = prolong(self._level_space(level), self._U[level].to(ref.device, ref.dtype),
                    self._d[-1].stationary.space)
        nt_c, nt_f = U.shape[0] - 1, ref.shape[0] - 1
        tf = np.linspace(0.0, self._T, nt_f + 1)
        tc = np.linspace(0.0, self._T, nt_c + 1)
        idx = np.clip(np.searchsorted(tc, tf, side="right") - 1, 0, nt_c - 1)
        w = torch.as_tensor((tf - tc[idx]) / (tc[idx + 1] - tc[idx]),
                            dtype=U.dtype, device=U.device)[:, None, None]
        ii = torch.as_tensor(idx, device=U.device)
        self._U_ref[level] = U[ii] * (1 - w) + U[ii + 1] * w
        return self._U_ref[level]

    def compute_norm(self, level, nid):
        self._reference()
        diff = self._U[-1] - self._prolonged(level)
        t_id, s_id = (p.strip() for p in nid.split("-"))
        P = self._d[-1].products["l2" if s_id == "L2" else "elliptic_mu_bar"]
        sq = torch.einsum("bkn,knm,bkm->b", diff, P, diff)
        if t_id == "L_oo":
            return float(torch.sqrt(torch.max(sq)))
        # L2 in time of the piecewise-linear interpolant of the norms:
        # 2-point Gauss on each interval
        dt = self._T / (sq.shape[0] - 1)
        g = 0.5 / math.sqrt(3.0)
        acc = 0.0
        for pt in (0.5 - g, 0.5 + g):
            vals = (1 - pt) * torch.sqrt(sq[:-1]) + pt * torch.sqrt(sq[1:])
            acc = acc + 0.5 * torch.sum(vals ** 2) * dt
        return float(torch.sqrt(acc))

    def _estimates(self, level):
        if level not in self._cache:
            mu = self._d[level].parse_parameter(self.mu)
            est, (nc, r, df, rt, tdnc) = self._d[level].estimate(self._U[level], mu)
            self._cache[level] = {
                "eta_nc": float(torch.linalg.norm(nc)),
                "eta_r": float(torch.linalg.norm(r)),
                "eta_df": float(torch.linalg.norm(df)),
                "R_T": float(torch.linalg.norm(rt)),
                "partial_t_nc": float(torch.linalg.norm(tdnc)),
                "eta": float(est)}
        return self._cache[level]
