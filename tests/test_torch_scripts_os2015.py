"""The port's OS2015 convergence studies (Tables 1-3 of OS2015, plain,
``--crisscross`` and ``--paper``, and the reduced model's tables) against
the JAX package's scripts on CPU float64, at two levels (2x2 subdomains,
half 2: N = 24 and 96).

The JAX side is the script's own ``StationaryEocStudy`` with its
``discretize`` and module-level ``config``; every norm, indicator and
estimate of the port's tables agrees to rel 1e-8.  The plain variant
compares all four tables; the crisscross and paper variants their first
study (Tables 1 and 2 at mu_hat = 1), since each JAX study costs ~12 s here.
"""
import copy
import pathlib
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))

from pylrbms_tpu.EOC import StationaryEocStudy, default_refine  # noqa: E402
from pylrbms_tpu.problems.os2015 import init_grid_and_problem as jax_os2015  # noqa: E402

from pylrbms_tpu_torch.scripts import _results  # noqa: E402
from pylrbms_tpu_torch.scripts import OS2015_convergence_study as port  # noqa: E402
from pylrbms_tpu_torch.scripts import (  # noqa: E402
    OS2015_convergence_study_as_reduced as as_reduced)

TABLES = (('h', 'elliptic_mu_bar', 'eta_nc', 'eta_df'), ('h', 'eta_r', 'eta'),
          ('h', 'eta_df', 'eta'), ('h', 'elliptic_mu_bar', 'eta_nc', 'eta'))


def _compare(port_table, jax_data):
    for lvl in (0, 1):
        for group in ("norm", "indicator", "estimate"):
            got = port_table["data"][lvl].get(group, {})
            assert got.keys() == jax_data[lvl].get(group, {}).keys()
            for k, v in got.items():
                ref = jax_data[lvl][group][k]
                assert abs(v - ref) <= 1e-8 * abs(ref), (lvl, group, k, v, ref)


@pytest.mark.parametrize("variant", ["plain", "crisscross", "paper"])
def test_os2015_tables_match_jax(variant):
    import OS2015_convergence_study as js
    crisscross, paper = variant == "crisscross", variant in ("crisscross", "paper")
    cfg = dict(js.config, grid_type="crisscross") if crisscross else js.config
    out = port.main(1, paper_convention=paper, crisscross=crisscross, device="cpu")
    assert [t["levels"] for t in out] == [["32/4", "128/4"]] * 4

    def study(init):
        return StationaryEocStudy(init, js.discretize, cfg, default_refine, mu=1,
                                  max_levels=1, paper_convention=paper)

    s = study(jax_os2015)
    _compare(out[0], copy.deepcopy(s.run(TABLES[0])))
    _compare(out[1], s.run(TABLES[1]))
    if variant == "plain":
        _compare(out[2], study(partial(jax_os2015, mu_bar=1, mu_hat=0.1)).run(TABLES[2]))
        _compare(out[3], study(partial(jax_os2015, mu_bar=0.1, mu_hat=0.1)).run(TABLES[3]))
    # the efficiencies the tables print: the elliptic norm over eta
    for t in out:
        for lvl in (0, 1):
            d = t["data"][lvl]
            if "norm" in d:
                for eid, e in d.get("eff", {}).items():
                    assert np.isclose(e, d["norm"]["elliptic_mu_bar"] / d["estimate"][eid],
                                      rtol=1e-14)


# ------------------------------------------------------------------ row 6

def test_reduced_os2015_tables_match_jax():
    import OS2015_convergence_study_as_reduced as js
    cols = ('h', 'elliptic_mu_bar', 'eta_nc', 'eta_df', 'eta')
    dj = StationaryEocStudy(jax_os2015, js.discretize_reduced, js.config, default_refine,
                            mu=1, max_levels=1).run(cols)
    out = as_reduced.main(1, device="cpu")
    assert out["levels"] == ["32/4", "128/4"]
    for lvl in (0, 1):
        for group in ("norm", "indicator", "estimate"):
            assert out["data"][lvl][group].keys() == dj[lvl][group].keys()
            for k, v in out["data"][lvl][group].items():
                ref = dj[lvl][group][k]
                assert abs(v - ref) <= 1e-8 * abs(ref), (lvl, group, k)
    # both levels are in the CPU-written file: held to its printed digits
    assert _results.hold_studies("OS2015_convergence_study_as_reduced.txt", [out]) == []
