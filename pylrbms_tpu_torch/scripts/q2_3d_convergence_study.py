"""Q2 hex (RT_[1]) estimator convergence on the card: the port of
``scripts/q2_3d_convergence_study.py``.

The degree-matched RT_[1] hex reconstruction (``ops/rt1hex.py``) against
u = cos(pi x/2) cos(pi y/2) cos(pi z/2) on [-1, 1]^3 (the 3D academic
problem at mu = 1): true energy error and paper-convention eta with its
indicators on (2x2x2, nref 0), (2x2x2, nref 1), (4x4x4, nref 1, lean).

    python -m pylrbms_tpu_torch.scripts.q2_3d_convergence_study [--device cpu]

:func:`main` returns the rows as printed and the EOC per refinement step.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

LEVELS = ((2, 0, False), (2, 1, False), (4, 1, True))


def true_energy_err(sp, U):
    from ..ops import assembly3d as asm3
    xq = asm3.vol_points(sp, torch.float64).numpy()
    w = np.asarray(sp.vol_w)
    dphi = np.asarray(sp.vol_dphi)
    Uc = U.double().cpu().numpy().reshape(sp.K, sp.s ** 3, sp.nb)
    gu = np.einsum("kcj,qja->kcqa", Uc, dphi)
    px = 0.5 * np.pi
    c, s = np.cos, np.sin
    gex = np.stack([
        -px * s(px * xq[..., 0]) * c(px * xq[..., 1]) * c(px * xq[..., 2]),
        -px * c(px * xq[..., 0]) * s(px * xq[..., 1]) * c(px * xq[..., 2]),
        -px * c(px * xq[..., 0]) * c(px * xq[..., 1]) * s(px * xq[..., 2])],
        -1)
    d = gu - gex
    return float(np.sqrt(sp.volume * np.einsum("q,kcqa,kcqa->", w, d, d)))


def main(levels=LEVELS, device=None):
    from ..discretize_elliptic_block_swipdg3d import discretize
    from ..problems.academic3d import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    mu = {"diffusion": 1.0}
    rows, out = [], []
    print("Q2 hex (RT_[1] flux) on the 3D academic problem, mu = 1")
    print(f"{'h':>8} {'dofs':>8} {'|e|_E':>10} {'eta':>10} {'eta_nc':>10} "
          f"{'eta_r':>10} {'eta_df':>10} {'eff':>6}")
    for ns, nref, lean in levels:
        gpd = init_grid_and_problem(
            {'num_subdomains': [ns] * 3,
             'half_num_fine_elements_per_subdomain_and_dim': 1,
             'num_refinements': nref})
        d, _ = discretize(gpd, order=2, lean=lean, device=dev)
        U = d.solve(mu)
        eta, (nc, r, df), _ = d.estimator.estimate(U, mu, decompose=True,
                                                   paper_convention=True)
        parts = [float(torch.sqrt(torch.sum(v.double() ** 2))) for v in (nc, r, df)]
        err = true_energy_err(d.space, U)
        h = gpd["grid"].hx
        rows.append((h, float(eta), err) + tuple(parts))
        dofs = d.space.K * d.space.N
        print(f"{h:8.4f} {dofs:8d} {err:10.3e} "
              f"{float(eta):10.3e} {parts[0]:10.3e} {parts[1]:10.3e} "
              f"{parts[2]:10.3e} {float(eta) / err:6.2f}")
        out.append({"h": h, "dofs": dofs, "|e|_E": err, "eta": float(eta), "eta_nc": parts[0],
                    "eta_r": parts[1], "eta_df": parts[2], "eff": float(eta) / err})
    rows = np.array(rows)
    hr = np.log(rows[:-1, 0] / rows[1:, 0])
    names = ("eta", "|e|_E", "eta_nc", "eta_r", "eta_df")
    eocs = {}
    print("\nEOC per refinement step:")
    for j, name in enumerate(names, start=1):
        eoc = np.log(rows[:-1, j] / rows[1:, j]) / hr
        eocs[name] = [float(v) for v in eoc]
        print(f"  {name:>7}: " + "  ".join(f"{v:.2f}" for v in eoc))
    return {"rows": out, "eoc": eocs}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == "__main__":
    cli()
