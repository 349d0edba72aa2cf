"""Order-2 estimator convergence on the card: the port of ``scripts/p2_convergence_study.py``.

The degree-matched RT1 reconstruction (``ops/rt1.py``) on the three 2D
families (tri, crisscross, quad) against the manufactured solution
u = cos(pi x/2) cos(pi y/2) on [-1, 1]^2 (the non-parametric problem): the
true energy error and the paper-convention eta with its indicators, all
decaying at order 2 with level-constant efficiency.

    python -m pylrbms_tpu_torch.scripts.p2_convergence_study [--device cpu]

:func:`main` returns, per family, the rows as printed (full precision);
``half`` overrides the families' half (2, crisscross 1).
"""
from __future__ import annotations

import argparse

import numpy as np

FAMILIES = (("tri", (0, 1, 2)), ("crisscross", (1, 2, 3)), ("quad", (0, 1, 2)))


def true_energy_err(sp, U):
    from ..ops import assembly as asm
    xq = asm.vol_points(sp)
    w = np.asarray(sp.vol_w)
    dphi = np.asarray(sp.vol_dphi)
    Uc = np.asarray(U.double().cpu().numpy()).reshape(sp.K, sp.s, sp.s, sp.T, sp.nb)
    gs = "kyxtj,yxtqja->kyxtqa" if sp.percell else "kyxtj,tqja->kyxtqa"
    gu = np.einsum(gs, Uc, dphi)
    gex = np.stack(
        [-0.5 * np.pi * np.sin(0.5 * np.pi * xq[..., 0]) * np.cos(0.5 * np.pi * xq[..., 1]),
         -0.5 * np.pi * np.cos(0.5 * np.pi * xq[..., 0]) * np.sin(0.5 * np.pi * xq[..., 1])],
        -1)
    d = gu - gex
    ws = "yxtq,kyxtqa,kyxtqa->" if sp.percell else "tq,kyxtqa,kyxtqa->"
    return float(np.sqrt(sp.hx * sp.hy * np.einsum(ws, w, d, d)))


def main(families=FAMILIES, half=None, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.non_parametric import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    out = {}
    for family, nrefs in families:
        print(f"\n== {family} family, order 2 "
              f"(eta/indicators: paper convention) ==")
        print(f"{'h':>8} {'energy err':>11} {'EOC':>5} {'eta':>11} {'EOC':>5}"
              f" {'eff':>5} {'eta_nc':>10} {'eta_r':>10} {'eta_df':>10}")
        prev, rows = None, []
        for nref in nrefs:
            if half is None:
                half_ = 2 if family != "crisscross" else 1
            else:
                half_ = half
            cfg = dict(num_subdomains=[2, 2],
                       half_num_fine_elements_per_subdomain_and_dim=half_,
                       num_refinements=nref, grid_type=family)
            m, data = discretize(init_grid_and_problem(cfg), order=2, device=dev)
            sp = data["space"]
            U = m.solve({})
            eta, (nc, r, df), _ = m.estimator.estimate(
                U, {}, decompose=True, paper_convention=True)
            err = true_energy_err(sp, U)
            eta = float(eta)
            nrm = lambda v: float(np.sqrt(np.sum(v.double().cpu().numpy() ** 2)))  # noqa: E731
            eoc_e = np.log2(prev[0] / err) if prev else float("nan")
            eoc_n = np.log2(prev[1] / eta) if prev else float("nan")
            row = {"h": sp.hx, "energy err": err, "EOC:energy err": eoc_e, "eta": eta,
                   "EOC:eta": eoc_n, "eff": eta / err, "eta_nc": nrm(nc), "eta_r": nrm(r),
                   "eta_df": nrm(df)}
            print(f"{sp.hx:8.4f} {err:11.4e} {eoc_e:5.2f} {eta:11.4e}"
                  f" {eoc_n:5.2f} {eta / err:5.2f}"
                  f" {row['eta_nc']:10.3e} {row['eta_r']:10.3e} {row['eta_df']:10.3e}")
            rows.append(row)
            prev = (err, eta)
        out[family] = rows
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == "__main__":
    cli()
