"""Prolongation and the EOC studies in the port, against the JAX package on
CPU float64.

Mirrors the prolongation and EOC cases of tests/test_parabolic_and_eoc.py
and tests/test_eoc_blockref.py: prolongation is an exact embedding (L2
norms equal across levels, 1e-12) on tri and crisscross; ``prolong`` equals
JAX's on all three families and order pairs (1e-12 relative to the field's
max |.|); the paper-convention ``StationaryEocStudy`` (p_ref = 2) prints
its table, its norms, indicators and estimate equal JAX's (1e-8 relative;
one JAX study at the base config nref 0, the port's at nref 1 too), and at
nref 1 the indicators are first order (EOC in (0.7, 1.4)) with an
efficiency constant to 25%; the block reference (a lean p = 2 block model
solved by scipy ``splu``) equals the monolithic one (1e-9); a small
``InstationaryEocStudy`` runs to its end with finite, falling errors and
its level 0 equals JAX's (1e-8 relative).
Blocks stay at N <= 48 (P2, s = 2); the K = 1 references are one matrix.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pylrbms_tpu.grid import make_grid as jax_make_grid  # noqa: E402
from pylrbms_tpu.ops.spaces import BlockDGSpace as JaxSpace  # noqa: E402
from pylrbms_tpu.ops.prolong import prolong as jax_prolong  # noqa: E402
from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402
from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize as jax_discretize  # noqa: E402
from pylrbms_tpu.EOC import StationaryEocStudy as JaxStationaryEocStudy  # noqa: E402
from pylrbms_tpu.EOC import InstationaryEocStudy as JaxInstationaryEocStudy  # noqa: E402
from pylrbms_tpu.problems.thermalblock import init_grid_and_problem as jax_thermalblock  # noqa: E402
from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize as jax_parabolic  # noqa: E402

from pylrbms_tpu_torch.grid import make_grid  # noqa: E402
from pylrbms_tpu_torch.ops.spaces import BlockDGSpace  # noqa: E402
from pylrbms_tpu_torch.ops.prolong import prolong, prolongation_gather  # noqa: E402
from pylrbms_tpu_torch.ops import assembly as asm  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem as os2015  # noqa: E402
from pylrbms_tpu_torch.problems.thermalblock import init_grid_and_problem as thermalblock  # noqa: E402
from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.discretize_parabolic_block_swipdg import discretize as parabolic  # noqa: E402
from pylrbms_tpu_torch.EOC import (InstationaryEocStudy, StationaryEocStudy,  # noqa: E402
                                   default_refine)

DOMAIN = ((-1, -1), (1, 1))
COLUMNS = ("h", "elliptic_mu_bar", "eta_nc", "eta_r", "eta_df", "eta")


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def cfg(nref):
    return {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
            "num_refinements": nref}


@pytest.mark.parametrize("gt", ["tri", "crisscross"])
def test_prolongation_is_exact_embedding(gt):
    coarse = BlockDGSpace(make_grid(DOMAIN, [2, 2], 1, num_refinements=1, grid_type=gt), order=1)
    fine = BlockDGSpace(make_grid(DOMAIN, [2, 2], 1, num_refinements=2, grid_type=gt), order=2)
    Uc = torch.tensor(np.random.default_rng(3).normal(size=(coarse.K, coarse.N)))
    Uf = prolong(coarse, Uc, fine)
    Mc, Mf = asm.volume_mass(coarse), asm.volume_mass(fine)
    nc = float(torch.einsum("kn,knm,km->", Uc, Mc, Uc))
    nf = float(torch.einsum("kn,knm,km->", Uf, Mf, Uf))
    assert abs(nc - nf) < 1e-12 * max(abs(nc), 1.0)


@pytest.mark.parametrize("gt", ["tri", "crisscross", "quad"])
@pytest.mark.parametrize("orders", [(1, 1), (1, 2), (2, 2)])
def test_prolong_equals_jax(gt, orders):
    oc, of = orders
    spaces = []
    for mk, Space in ((make_grid, BlockDGSpace), (jax_make_grid, JaxSpace)):
        spaces.append((Space(mk(DOMAIN, [2, 2], 1, num_refinements=1, grid_type=gt), order=oc),
                       Space(mk(DOMAIN, [2, 2], 1, num_refinements=2, grid_type=gt), order=of)))
    (ct, ft), (cj, fj) = spaces
    U = np.random.default_rng(5).normal(size=(2, ct.K, ct.N))
    assert rel(prolong(ct, torch.tensor(U), ft), jax_prolong(cj, jnp.asarray(U), fj)) <= 1e-12
    src, wts = prolongation_gather(ct, ft)
    assert src.shape == (ft.K * ft.N,) and wts.shape == (ft.K * ft.N, ct.nb)


def _study(nref, max_levels=1, **kw):
    return StationaryEocStudy(os2015, lambda g: discretize(g, device="cpu"), cfg(nref),
                              default_refine, mu=1, p_ref=2, max_levels=max_levels,
                              paper_convention=True, device="cpu", **kw)


def test_paper_convention_eoc_table_equals_jax(capsys):
    data = _study(0).run(COLUMNS)
    out = capsys.readouterr().out
    assert "EOC" in out and "eta eff." in out
    sj = JaxStationaryEocStudy(jax_os2015, lambda g: jax_discretize(g), cfg(0), default_refine,
                               mu=1, p_ref=2, max_levels=1, paper_convention=True)
    dj = sj.run(COLUMNS)
    for lvl in (0, 1):
        for group in ("norm", "indicator", "estimate"):
            assert data[lvl][group].keys() == dj[lvl][group].keys()
            for name, v in data[lvl][group].items():
                assert v == pytest.approx(dj[lvl][group][name], rel=1e-8), (lvl, group, name)


def test_paper_convention_eoc_first_order_and_constant_efficiency():
    """From s = 2 on (nref 1) the indicators are first order in h and the
    efficiency is level-constant: the shape of OS2015's Table 1."""
    data = _study(1).run(COLUMNS)
    for ind in ("eta_nc", "eta_r", "eta_df"):
        rate = math.log(data[1]["indicator"][ind] / data[0]["indicator"][ind]) / math.log(0.5)
        assert 0.7 < rate < 1.4, f"{ind} paper-mode EOC {rate}"
    effs = [data[lvl]["norm"]["elliptic_mu_bar"] / data[lvl]["estimate"]["eta"]
            for lvl in (0, 1)]
    assert abs(effs[1] / effs[0] - 1.0) < 0.25, effs
    assert all(e < 1.0 for e in effs)


def test_block_reference_matches_monolithic():
    """Above ``ref_block_threshold`` dofs the reference is a lean p = 2
    block model solved by scipy splu: its norms equal the monolithic
    reference's."""
    vals = {}
    for name, thr in (("monolithic", 10 ** 9), ("block", 0)):
        study = _study(0)
        study.ref_block_threshold = thr
        for lvl in (0, 1):
            study.solve(lvl)
        vals[name] = [study.compute_norm(lvl, nid) for lvl in (0, 1)
                      for nid in ("L2", "elliptic_mu_bar")]
        assert ("block_space" in study._data[-1]) == (name == "block")
    a, b = np.asarray(vals["monolithic"]), np.asarray(vals["block"])
    assert np.all(a > 0)
    assert (np.abs(a - b) / np.abs(a)).max() < 1e-9


def _refine_dt(c):
    out = default_refine(c)
    out["dt"] = c["dt"] / 2
    return out


def test_instationary_eoc_study_equals_jax(capsys):
    """The thermal block, P1 on 2x2 subdomains against a P2 reference two
    levels finer, dt halved per level: the table runs to its end with
    finite, falling errors, and its level 0 equals JAX's (1e-8 relative)."""
    def disc(gpd, T, nt):
        im, data = parabolic(gpd, T, nt, device="cpu")
        return im, {"block_space": data["block_space"]}

    def jax_disc(gpd, T, nt):
        im, data = jax_parabolic(gpd, T, nt)
        return im, {"block_space": data["block_space"]}

    base = dict(cfg(0), T=0.5, dt=0.125)
    ref = _refine_dt(_refine_dt(base))
    columns = ("h", "dt", "L2 - L2", "L2 - elliptic_mu_bar", "eta_nc", "eta_r", "eta_df",
               "R_T", "partial_t_nc", "eta")
    data = InstationaryEocStudy(thermalblock, disc, base, _refine_dt, ref, mu=(1, 1, 1, 1),
                                max_levels=1, device="cpu").run(columns)
    assert "|grid|/|Grid|/nt" in capsys.readouterr().out
    # JAX's level 0 against the same reference (one JAX model fewer)
    dj = JaxInstationaryEocStudy(jax_thermalblock, jax_disc, base, _refine_dt, ref,
                                 mu=(1, 1, 1, 1), max_levels=0).run(columns)
    for group in ("norm", "indicator", "estimate"):
        for name, v in data[0][group].items():
            assert v == pytest.approx(dj[0][group][name], rel=1e-8), (group, name)
    for lvl in (0, 1):
        vals = [v for g in ("norm", "indicator", "estimate") for v in data[lvl][g].values()]
        assert all(np.isfinite(v) and v >= 0 for v in vals), data[lvl]
    for nid in ("L2 - L2", "L2 - elliptic_mu_bar"):
        assert data[1]["norm"][nid] < data[0]["norm"][nid]
