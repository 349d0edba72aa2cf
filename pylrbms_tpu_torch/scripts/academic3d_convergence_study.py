"""Q1 hex convergence on the card: the port of ``scripts/academic3d_convergence_study.py``.

Per refinement level (2x2x2 subdomains, half 1, nref 0..levels-1), the Q1
SWIPDG solve of the 3D academic problem at mu = 1 (exact solution
u = cos(pi x/2) cos(pi y/2) cos(pi z/2)), the paper-convention estimate, the
true energy error by quadrature and the efficiency eta / |||e|||.

    python -m pylrbms_tpu_torch.scripts.academic3d_convergence_study [levels] [--device cpu]

:func:`main` returns the rows as printed (full precision).
"""
from __future__ import annotations

import argparse

import numpy as np


def main(levels=3, device=None):
    from ..discretize_elliptic_block_swipdg3d import discretize
    from ..ops import assembly3d as asm3
    from ..problems.academic3d import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    mu = {"diffusion": 1.0}
    rows = []
    for nref in range(levels):
        gpd = init_grid_and_problem(
            {"num_subdomains": [2, 2, 2],
             "half_num_fine_elements_per_subdomain_and_dim": 1,
             "num_refinements": nref})
        d, _ = discretize(gpd, device=dev)
        sp = d.space
        U = d.solve(mu)
        eta, (nc, r, df), _ = d.estimate(U, mu, decompose=True,
                                         paper_convention=True)
        # true energy error by quadrature (lambda == 1 at mu = 1)
        xq = asm3.vol_points(sp).numpy()
        dphi = np.asarray(sp.vol_dphi)
        Uc = U.double().cpu().numpy().reshape(sp.K, sp.s ** 3, sp.nb)
        gu = np.einsum("kci,qia->kcqa", Uc, dphi)
        p2 = np.pi / 2
        cx, sx = np.cos(p2 * xq[..., 0]), np.sin(p2 * xq[..., 0])
        cy, sy = np.cos(p2 * xq[..., 1]), np.sin(p2 * xq[..., 1])
        cz, sz = np.cos(p2 * xq[..., 2]), np.sin(p2 * xq[..., 2])
        gex = -p2 * np.stack([sx * cy * cz, cx * sy * cz, cx * cy * sz], -1)
        diff = gu - gex
        err = float(np.sqrt(sp.volume * np.einsum("q,kcqa,kcqa->",
                                                  np.asarray(sp.vol_w), diff, diff)))
        h = gpd["grid"].max_entity_diameter()
        norm2 = lambda v: float(np.sqrt(np.sum(v.double().cpu().numpy() ** 2)))  # noqa: E731
        rows.append((h, float(eta), err, norm2(nc), norm2(r), norm2(df)))

    print(f"{'h':>9} {'|||e|||':>10} {'eoc':>5} {'eta':>10} {'eoc':>5} "
          f"{'eff':>6} {'eta_nc':>10} {'eta_r':>10} {'eta_df':>10}")
    out = []
    for i, (h, eta, err, nc, r, df) in enumerate(rows):
        if i == 0:
            e1 = e2 = "  --"
            v1 = v2 = None
        else:
            hp_, etap, errp = rows[i - 1][:3]
            v1 = np.log(errp / err) / np.log(hp_ / h)
            v2 = np.log(etap / eta) / np.log(hp_ / h)
            e1, e2 = f"{v1:5.2f}", f"{v2:5.2f}"
        print(f"{h:9.3e} {err:10.4e} {e1:>5} {eta:10.4e} {e2:>5} "
              f"{eta / err:6.2f} {nc:10.4e} {r:10.4e} {df:10.4e}")
        out.append({"h": h, "|||e|||": err, "EOC:|||e|||": v1, "eta": eta, "EOC:eta": v2,
                    "eff": eta / err, "eta_nc": nc, "eta_r": r, "eta_df": df})
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("levels", type=int, nargs="?", default=3)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(a.levels, device=a.device)


if __name__ == "__main__":
    cli()
