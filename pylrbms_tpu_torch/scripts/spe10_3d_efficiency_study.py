"""SPE10 estimator efficiency in native 3D on the card: the port of
``scripts/spe10_3d_efficiency_study.py``.

True energy error against a degree-elevated Q2 reference on the finest
grid (exact nested Q1 -> Q2 prolongation), paper-convention eta,
efficiency = error / eta.  The permeability block (z-layers 40-44) is
pooled to a (2, 8, 8) nearest raster, clipped to contrast 1e4.  Reference
and level solves: host scipy ``splu`` (or ``--truth-file`` /
``--level-file``: saved solutions of ``spe10_3d_truth``).  ``--smoke``:
levels 0-1 against an 8x8x2, nref 1 Q2 reference at mu = 1;
``--finer-ref``: 2:1 cells, raster (4, 8, 8), reference one refinement
finer than the finest level (442 368 dofs: needs ``--truth-file``).

    python -m pylrbms_tpu_torch.scripts.spe10_3d_efficiency_study --smoke [--device cpu]

:func:`main` returns per mu the rows as printed (full precision).
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

RASTER = (2, 8, 8)
MAX_CONTRAST = 1e4
CONFIG = {"num_subdomains": [8, 8, 2],
          "half_num_fine_elements_per_subdomain_and_dim": 1}
LEVELS = (0, 1, 2)
REF_CONFIG = {"num_subdomains": [16, 16, 4],
              "half_num_fine_elements_per_subdomain_and_dim": 1,
              "num_refinements": 1}
SMOKE = dict(levels=(0, 1), ref_config={"num_subdomains": [8, 8, 2],
                                        "half_num_fine_elements_per_subdomain_and_dim": 1,
                                        "num_refinements": 1}, mus=(1.0,))
FINER_REF = dict(raster=(4, 8, 8), config={"num_subdomains": [8, 8, 4],
                                           "half_num_fine_elements_per_subdomain_and_dim": 1},
                 levels=(0, 1, 2),
                 ref_config={"num_subdomains": [16, 16, 8],
                             "half_num_fine_elements_per_subdomain_and_dim": 1,
                             "num_refinements": 1})


def _splu_solve(d, mu):
    import scipy.sparse.linalg as spla
    from ..la.block import to_scipy_csr
    A = to_scipy_csr(d.assemble(mu)).tocsc()
    b = d.rhs(mu).double().cpu().numpy().ravel()
    return spla.splu(A).solve(b)


def main(mus=(1.0, 0.3), smoke=False, finer_ref=False, truth_file=None, level_file=None,
         raster=RASTER, config=CONFIG, levels=LEVELS, ref_config=REF_CONFIG, device=None):
    from ..discretize_elliptic_block_swipdg3d import discretize
    from ..ops.prolong import prolong
    from ..problems.spe10 import init_grid_and_problem_3d, load_spe10_block, pool_log_mean3d
    from ..utils.precision import device as _device

    dev = _device(device)
    if smoke:
        levels, ref_config, mus = SMOKE["levels"], SMOKE["ref_config"], SMOKE["mus"]
    if finer_ref:
        raster, config = FINER_REF["raster"], FINER_REF["config"]
        levels, ref_config = FINER_REF["levels"], FINER_REF["ref_config"]
    init = partial(init_grid_and_problem_3d, raster=raster,
                   raster_mode="nearest", max_contrast=MAX_CONTRAST)
    field = pool_log_mean3d(load_spe10_block(), *raster, mode="nearest")
    field = np.maximum(field / field.max(), 1.0 / MAX_CONTRAST)
    print("SPE10 model-2 NATIVE-3D estimator-efficiency study "
          "(paper convention)")
    print(f"field: z-layers 40-44 pooled to {tuple(raster)} (nearest), contrast "
          f"after clip = {field.max() / field.min():.2e}")
    print("reference: Q2 hex SWIPDG on the finest grid (RT_[1]-capable "
          "space; host splu), exact nested Q1->Q2 prolongation")
    print("efficiency column = ||u_ref - u_h||_elliptic(mu_bar) / eta  "
          "(the norm the OS2015 bound controls; the penalty-inclusive DG "
          "norm is the last column)")
    print()

    t0 = time.perf_counter()
    gpd_ref = init(dict(ref_config))
    d_ref, _ = discretize(gpd_ref, order=2, lean=True, device=dev)
    E_ref = d_ref.products["elliptic_bar"]
    E_ref_pen = d_ref.products["energy_mu_bar"]
    ref_dofs = d_ref.space.K * d_ref.space.N
    print(f"[Q2 reference discretized: {ref_dofs} dofs, "
          f"{time.perf_counter() - t0:.1f} s]")
    d_lvl = {}
    for nref in levels:
        gpd = init(dict(config, num_refinements=nref))
        d_lvl[nref] = (gpd, discretize(gpd, device=dev)[0])

    truth = np.load(truth_file) if truth_file else None
    lvl = np.load(level_file) if level_file else None
    out = {}
    for mu_val in mus:
        print(f"--- mu (switch) = {mu_val} ---")
        t0 = time.perf_counter()
        mu_ref = d_ref.parse_parameter({"switch": mu_val})
        if truth is not None:
            # the truth solve may use another block layout of the same cell
            # mesh: relayout through the exact same-mesh prolongation
            from ..ops.spaces3d import BlockDGSpace3D
            x = np.asarray(truth[f"u_{mu_val}"], np.float64)
            gpd_t = init({"num_subdomains": [int(v) for v in truth["subs"]],
                          "half_num_fine_elements_per_subdomain_and_dim": 1,
                          "num_refinements": int(truth["nref"])})
            sp_t = BlockDGSpace3D(gpd_t["grid"], order=int(truth["order"]))
            U_ref = prolong(sp_t, torch.as_tensor(x.reshape(sp_t.K, sp_t.N), device=dev),
                            d_ref.space)
            print("  [Q2 reference loaded from --truth-file]")
        else:
            x = _splu_solve(d_ref, mu_ref)
            U_ref = torch.as_tensor(x.reshape(d_ref.space.K, d_ref.space.N), device=dev)
            print(f"  [Q2 reference solved (splu): {time.perf_counter() - t0:.1f} s]")

        rows = []
        for nref in levels:
            gpd, d = d_lvl[nref]
            mu = d.parse_parameter({"switch": mu_val})
            n_dofs = d.space.K * d.space.N
            if lvl is not None and n_dofs > 131072:
                U = torch.as_tensor(np.asarray(lvl[f"u_{mu_val}"], np.float64).reshape(
                    d.space.K, d.space.N), device=dev)
                print(f"  [level {n_dofs}-dof solve loaded from --level-file]")
            elif lvl is None and n_dofs > 200000:
                print(f"  [skipping {n_dofs}-dof level: past the splu "
                      "ceiling and no --level-file given]")
                continue
            else:
                U = torch.as_tensor(_splu_solve(d, mu).reshape(d.space.K, d.space.N),
                                    device=dev)
            eta, (nc, r, df), _ = d.estimate(U, mu, decompose=True, paper_convention=True)
            diff = U_ref - prolong(d.space, U, d_ref.space)
            err = float(torch.sqrt(torch.einsum("kn,knm,km->", diff, E_ref, diff)))
            err_pen = float(torch.sqrt(torch.einsum("kn,knm,km->", diff, E_ref_pen, diff)))
            n2 = lambda v: float(torch.sqrt(torch.sum(v.double() ** 2)))  # noqa: E731
            rows.append((gpd["grid"].max_entity_diameter(), n_dofs, err, float(eta),
                         n2(nc), n2(r), n2(df), err_pen))

        print(f"  {'h':>9} {'dofs':>7} {'|e|_ell':>10} {'eoc':>5} "
              f"{'eta':>10} {'eoc':>5} {'eff':>6} {'eta_nc':>10} "
              f"{'eta_r':>10} {'eta_df':>10} {'|e|_DG+pen':>11}")
        table = []
        for i, (h, dofs, err, eta, nc, r, df, err_pen) in enumerate(rows):
            if i == 0:
                e1 = e2 = "  --"
                v1 = v2 = None
            else:
                hp_, _, errp, etap = rows[i - 1][:4]
                v1 = np.log(errp / err) / np.log(hp_ / h)
                v2 = np.log(etap / eta) / np.log(hp_ / h)
                e1, e2 = f"{v1:5.2f}", f"{v2:5.2f}"
            print(f"  {h:9.3e} {dofs:7d} {err:10.4e} {e1:>5} {eta:10.4e} "
                  f"{e2:>5} {err / eta:6.3f} {nc:10.4e} {r:10.4e} "
                  f"{df:10.4e} {err_pen:11.4e}")
            table.append({"h": h, "dofs": dofs, "|e|_ell": err, "EOC:|e|_ell": v1, "eta": eta,
                          "EOC:eta": v2, "eff": err / eta, "eta_nc": nc, "eta_r": r,
                          "eta_df": df, "|e|_DG+pen": err_pen})
        print()
        out[mu_val] = table
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true", help="levels 0-1, small reference, mu 1")
    p.add_argument("--finer-ref", action="store_true",
                   help="2:1 cells, reference one refinement finer (442 368 dofs)")
    p.add_argument("--truth-file", default=None, help="NPZ of the Q2 reference solutions")
    p.add_argument("--level-file", default=None, help="NPZ of the finest level's solutions")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(smoke=a.smoke, finer_ref=a.finer_ref, truth_file=a.truth_file,
                level_file=a.level_file, device=a.device)


if __name__ == "__main__":
    cli()
