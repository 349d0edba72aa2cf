"""The port's 2D convergence and efficiency study scripts against the JAX
package's on CPU float64: order 2 on the 2D families, the instationary
thermal-block EOC, the channels demo and the 2D SPE10 efficiency study
(the 3D studies: tests/test_torch_scripts_studies3d.py).

Each case runs the JAX script's pipeline (its module-level functions and
config where it has them, else the JAX package pieces its ``main`` calls)
and the port's script on the same small configuration: two levels, blocks
of N <= 96.  Tolerance rel 1e-8 for every f64 quantity,
except the SPE10 efficiency studies' eta_r: zero in exact arithmetic
(cellwise-constant coefficient on a resolved raster, f = 1) and printed at
rounding level (~1e-7 against indicators of ~1-10), where two
implementations agree only in being at that level: both at most 1e-6 of
the row's largest indicator (``_results.ROUNDING_REL``); their eta, which
holds eta_r, to rel 1e-8 plus the two eta_r (at mu = 1: alpha = gamma =
1).  Where a case's levels are rows of a CPU-written file, the columns
that do not depend on the finest-level reference are held to the file.
"""
import pathlib
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))

from pylrbms_tpu_torch.scripts import _results  # noqa: E402
from pylrbms_tpu_torch.scripts import (  # noqa: E402
    p2_convergence_study as p2, parabolic as channels,
    parabolic_convergence_study as pconv, spe10_efficiency_study as eff2)

TOL = 1e-8


def close(a, b, tol=TOL):
    return abs(float(a) - float(b)) <= tol * abs(float(b))


def _jnorm(v):
    return float(np.sqrt(np.sum(np.asarray(v, np.float64) ** 2)))


def close_eta(a, b, r_a, r_b):
    """eta's rel 1e-8, widened by its rounding-level eta_r part: at mu = mu_bar
    = mu_hat (alpha = gamma = 1) eta moves by at most as much as ||eta_r||."""
    return abs(float(a) - float(b)) <= TOL * abs(float(b)) + abs(r_a) + abs(r_b)


def _compare_studies(port_data, jax_data, rounding=()):
    for lvl in sorted(jax_data):
        for group in ("norm", "indicator", "estimate"):
            got = port_data[lvl].get(group, {})
            assert got.keys() == jax_data[lvl].get(group, {}).keys()
            for k, v in got.items():
                ref = jax_data[lvl][group][k]
                if k in rounding:
                    scale = max(port_data[lvl]["indicator"][n] for n in _results.ROUNDING_SCALE)
                    assert abs(v) <= _results.ROUNDING_REL * scale
                    assert abs(ref) <= _results.ROUNDING_REL * scale
                elif group == "estimate" and rounding:
                    r_p, r_j = (dd[lvl]["indicator"]["eta_r"] for dd in (port_data, jax_data))
                    assert close_eta(v, ref, r_p, r_j), (lvl, k, v, ref)
                else:
                    assert close(v, ref), (lvl, group, k, v, ref)


# ------------------------------------------------------------------ row 7

def test_p2_study_matches_jax():
    import p2_convergence_study as js
    from pylrbms_tpu.problems.non_parametric import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg import discretize
    families = (("tri", (0, 1)), ("quad", (0, 1)), ("crisscross", (1,)))
    out = p2.main(families=families, half=1, device="cpu")
    for family, nrefs in families:
        for nref, row in zip(nrefs, out[family]):
            m, data = discretize(init_grid_and_problem(dict(
                num_subdomains=[2, 2], half_num_fine_elements_per_subdomain_and_dim=1,
                num_refinements=nref, grid_type=family)), order=2)
            U = m.solve({})
            eta, (nc, r, df), _ = m.estimator.estimate(U, {}, decompose=True,
                                                       paper_convention=True)
            assert close(row["energy err"], js.true_energy_err(data["space"], U))
            assert close(row["eta"], eta), (family, nref)
            for k, v in (("eta_nc", nc), ("eta_r", r), ("eta_df", df)):
                assert close(row[k], _jnorm(v)), (family, nref, k)


# ------------------------------------------------------------------ row 8

def test_parabolic_eoc_study_matches_jax():
    import parabolic_convergence_study as js
    from pylrbms_tpu.EOC import InstationaryEocStudy
    from pylrbms_tpu.problems.thermalblock import init_grid_and_problem
    out = pconv.main(0, device="cpu")
    base = {'num_subdomains': [2, 2], 'half_num_fine_elements_per_subdomain_and_dim': 1,
            'num_refinements': 0, 'grid_type': 'tri', 'T': 1}
    base['dt'] = 0.1 * init_grid_and_problem(base)['grid'].max_entity_diameter()
    ref = js.refine(base)
    dj = InstationaryEocStudy(init_grid_and_problem, js.discretize, base, js.refine, ref,
                              mu=(1, 1, 1, 1), max_levels=0).run(
        ('h', 'eta_nc', 'eta_r', 'eta_df', 'R_T', 'partial_t_nc'))
    assert out["levels"] == ["8/4/7"]
    _compare_studies(out["data"], dj)
    # level 0 is the file's first row: held to its printed digits
    table = _results.parse_tables(_results.read("parabolic_convergence_study.txt"))[0]
    rows = _results.study_rows(out["data"], out["levels"])
    table.rows = table.rows[:1]
    assert _results.check_rows(table, rows) == []


# ------------------------------------------------------------------ row 9

def test_channels_demo_matches_jax():
    from pylrbms_tpu.problems.artificial_channels import init_grid_and_problem
    from pylrbms_tpu.discretize_parabolic_block_swipdg import discretize
    from pylrbms_tpu.reductor import ParabolicLRBMSReductor
    kw = dict(T=1.0, nt=5, subdomains=(2, 2), half=1, nref=1)
    d, _ = discretize(init_grid_and_problem({
        'num_subdomains': [2, 2], 'half_num_fine_elements_per_subdomain_and_dim': 1,
        'num_refinements': 1, 'grid_type': 'tri'}), kw["T"], kw["nt"])
    mu = d.parameter_space.sample_randomly(1, seed=11)[0]
    U = d.solve(mu)
    red = ParabolicLRBMSReductor(d.stationary)
    red.extend_basis(np.asarray(U))
    rd = red.reduce().attach_instationary(d)
    u = rd.solve(mu)
    ests = {"FOM": d.estimate(U, mu), "ROM": rd.estimate(u, mu)}
    out = channels.main(**kw, device="cpu")
    for tag, (est, parts) in ests.items():
        assert close(out[tag]["total"], est), tag
        for k, p in zip(("nc", "r", "df", "rt", "tdnc"), parts):
            assert close(out[tag][k], _jnorm(p)), (tag, k)
    # one snapshot of the same trajectory: both reduction errors at rounding level
    assert out["reduction_error"] < 1e-9


# ------------------------------------------------------------------ row 12

def test_spe10_efficiency_study_matches_jax_and_the_file():
    import spe10_efficiency_study as js
    from pylrbms_tpu.EOC import StationaryEocStudy, default_refine
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem
    out = eff2.main(max_levels=1, mus=(1.0,), device="cpu")
    init = partial(init_grid_and_problem, raster=js.RASTER, raster_mode="nearest",
                   max_contrast=js.MAX_CONTRAST)
    dj = StationaryEocStudy(init, js.discretize, js.CONFIG, default_refine,
                            mu={'switch': 1.0}, max_levels=1, paper_convention=True).run(
        ('h', 'elliptic_mu_bar', 'eta_nc', 'eta_r', 'eta_df', 'eta'))
    _compare_studies(out[1.0]["data"], dj, rounding=("eta_r",))
    # levels 0-1 are the file's first two rows (mu = 1.0); their indicators
    # do not depend on the reference (the file's is one level finer)
    table = _results.parse_tables(_results.read("spe10_efficiency_study.txt"))[0]
    table.rows = table.rows[:2]
    rows = _results.study_rows(out[1.0]["data"], out[1.0]["levels"])
    cols = [c for c in table.header if "eta_" in c or c in ("h", "|grid|/|Grid|")]
    assert _results.check_rows(table, rows, columns=cols, rounding=("eta_r",)) == []
