"""The port's 3D study scripts against the JAX package's on CPU float64:
the Q1 and Q2 hex EOC studies (academic3d) and the native-3D SPE10
efficiency study's ``--smoke`` pipeline.

Each case runs the JAX package pieces the script's ``main`` calls and the
port's script on the same small configuration (Q1 s <= 2, N <= 64; Q2
s = 1, N = 27).  Tolerance rel 1e-8 for every f64 quantity, except the
SPE10 study's eta_r: zero in exact arithmetic (cellwise-constant
coefficient on a resolved raster, f = 1) and printed at rounding level, so
both sides are held to at most ``_results.ROUNDING_REL`` of the row's
largest indicator, and eta (which holds eta_r) to rel 1e-8 widened by the
two eta_r.  Levels that are rows of a CPU-written file are held to it.
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
    academic3d_convergence_study as a3, q2_3d_convergence_study as q2,
    spe10_3d_efficiency_study as eff3)

TOL = 1e-8


def close(a, b, tol=TOL):
    return abs(float(a) - float(b)) <= tol * abs(float(b))


def _jnorm(v):
    return float(np.sqrt(np.sum(np.asarray(v, np.float64) ** 2)))


def close_eta(a, b, r_a, r_b):
    """eta's rel 1e-8, widened by its rounding-level eta_r part: at mu = mu_bar
    = mu_hat (alpha = gamma = 1) eta moves by at most as much as ||eta_r||."""
    return abs(float(a) - float(b)) <= TOL * abs(float(b)) + abs(r_a) + abs(r_b)


# ------------------------------------------------------------------ rows 10, 11

def test_academic3d_study_matches_jax():
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize
    out = a3.main(2, device="cpu")
    mu = {"diffusion": 1.0}
    for nref, row in enumerate(out):
        gpd = init_grid_and_problem({"num_subdomains": [2, 2, 2],
                                     "half_num_fine_elements_per_subdomain_and_dim": 1,
                                     "num_refinements": nref})
        d, _ = discretize(gpd)
        U = d.solve(mu)
        eta, (nc, r, df), _ = d.estimate(U, mu, decompose=True, paper_convention=True)
        assert row["h"] == pytest.approx(gpd["grid"].max_entity_diameter(), rel=1e-14)
        assert close(row["eta"], eta)
        for k, v in (("eta_nc", nc), ("eta_r", r), ("eta_df", df)):
            assert close(row[k], _jnorm(v)), (nref, k)
    # levels 0 and 1 are the file's first rows: held to their printed digits
    table = _results.parse_tables(_results.read("academic3d_convergence_study.txt"))[0]
    table.rows = table.rows[:2]
    assert _results.check_rows(table, out) == []


def test_q2_3d_study_matches_jax():
    import q2_3d_convergence_study as js
    from pylrbms_tpu.problems.academic3d import init_grid_and_problem
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize
    levels = ((1, 0, False), (2, 0, False))
    out = q2.main(levels=levels, device="cpu")
    mu = {"diffusion": 1.0}
    for (ns, nref, lean), row in zip(levels, out["rows"]):
        d, _ = discretize(init_grid_and_problem(
            {'num_subdomains': [ns] * 3, 'half_num_fine_elements_per_subdomain_and_dim': 1,
             'num_refinements': nref}), order=2, lean=lean)
        U = d.solve(mu)
        eta, (nc, r, df), _ = d.estimator.estimate(U, mu, decompose=True,
                                                   paper_convention=True)
        assert close(row["|e|_E"], js.true_energy_err(d.space, U))
        assert close(row["eta"], eta)
        for k, v in (("eta_nc", nc), ("eta_r", r), ("eta_df", df)):
            assert close(row[k], _jnorm(v)), (ns, k)
    assert set(out["eoc"]) == {"eta", "|e|_E", "eta_nc", "eta_r", "eta_df"}


# ------------------------------------------------------------------ row 17

def test_spe10_3d_efficiency_smoke_matches_jax():
    """The study's pipeline (``--smoke``'s shape: two Q1 levels against a Q2
    reference, mu = 1) at 2x2x2 subdomains, raster (2, 2, 2)."""
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla
    from pylrbms_tpu.problems.spe10 import init_grid_and_problem_3d
    from pylrbms_tpu.discretize_elliptic_block_swipdg3d import discretize
    from pylrbms_tpu.ops.prolong import prolong
    from pylrbms_tpu.la.block import to_scipy_csr
    raster = (2, 2, 2)
    config = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1}
    ref_config = dict(config, num_subdomains=[4, 4, 4], num_refinements=0)
    out = eff3.main(mus=(1.0,), levels=(0, 1), raster=raster, config=config,
                    ref_config=ref_config, device="cpu")
    init = partial(init_grid_and_problem_3d, raster=raster, raster_mode="nearest",
                   max_contrast=eff3.MAX_CONTRAST)

    def splu(d, mu):
        A = to_scipy_csr(d.assemble(mu)).tocsc()
        return spla.splu(A).solve(np.asarray(d.rhs(mu), np.float64).ravel())

    d_ref, _ = discretize(init(dict(ref_config)), order=2, lean=True)
    mu_r = d_ref.parse_parameter({"switch": 1.0})
    U_ref = jnp.asarray(splu(d_ref, mu_r).reshape(d_ref.space.K, d_ref.space.N))
    for nref, row in zip((0, 1), out[1.0]):
        d, _ = discretize(init(dict(config, num_refinements=nref)))
        mu = d.parse_parameter({"switch": 1.0})
        U = jnp.asarray(splu(d, mu).reshape(d.space.K, d.space.N))
        eta, (nc, r, df), _ = d.estimate(U, mu, decompose=True, paper_convention=True)
        diff = U_ref - prolong(d.space, U, d_ref.space)
        err = float(jnp.sqrt(jnp.einsum("kn,knm,km->", diff, d_ref.products["elliptic_bar"],
                                        diff)))
        assert close(row["|e|_ell"], err), nref
        assert close_eta(row["eta"], eta, row["eta_r"], _jnorm(r)), nref
        for k, v in (("eta_nc", nc), ("eta_df", df)):
            assert close(row[k], _jnorm(v)), (nref, k)
        scale = max(row["eta_nc"], row["eta_df"])
        assert row["eta_r"] <= _results.ROUNDING_REL * scale
        assert _jnorm(r) <= _results.ROUNDING_REL * scale
