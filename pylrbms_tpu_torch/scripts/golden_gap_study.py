"""Golden-triple gap attribution on the card: the port of ``scripts/golden_gap_study.py``.

Sweeps the OS2015 [4, 4], half 1, mu = 1 triple over the mesh level (nref
0, 1, 2) and the aggregation convention (as executed: the norm of the
squared locals; paper: the square root of their sum), and once at nref 1
without the Oswald interpolant's Dirichlet-vertex zeroing.  Writes the
attribution text that ``docs/results/golden_gap_attribution.md`` holds
(its generated part) to ``--out`` (default
``results_out/golden_gap_attribution.md``; never into ``docs/results/``).

    python -m pylrbms_tpu_torch.scripts.golden_gap_study [--out FILE] [--device cpu]

:func:`main` returns the sweep rows ``(nref, h, as-executed, paper)``, the
paper triple without the zeroing and the text.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

GOLDEN = {"nc": 1.66e-01, "r": 1.45e-01, "df": 3.55e-01}


def triple(nref, oswald_boundary_zeroing=True, device=None):
    """(as-executed triple, paper-convention triple, h) at refinement nref."""
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.os2015 import init_grid_and_problem
    gpd = init_grid_and_problem({
        "num_subdomains": [4, 4],
        "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": nref, "grid_type": "tri"})
    d, _ = discretize(gpd, device=device)
    mu = d.parse_parameter(1.)
    U = d.solve(mu)
    est = d.estimator
    osw = est.data.oswald
    saved = osw.interior_mask
    if not oswald_boundary_zeroing:
        osw.interior_mask = torch.ones_like(saved)
    try:
        nc_sq, r_sq, df_sq = (v[0].double().cpu().numpy()
                              for v in est.local_quantities(U[None], mu))
    finally:
        osw.interior_mask = saved
    executed = {k: float(np.linalg.norm(v))
                for k, v in (("nc", nc_sq), ("r", r_sq), ("df", df_sq))}
    paper = {k: float(np.sqrt(np.maximum(v, 0.0).sum()))
             for k, v in (("nc", nc_sq), ("r", r_sq), ("df", df_sq))}
    h = (gpd["grid"].upper_right[0] - gpd["grid"].lower_left[0]) / gpd["grid"].global_nx
    return executed, paper, h


def main(out="results_out/golden_gap_attribution.md", device=None):
    from ..utils.precision import device as _device
    dev = _device(device)
    rows = []
    for nref in (0, 1, 2):
        ex, pa, h = triple(nref, device=dev)
        rows.append((nref, h, ex, pa))
    _, pa_nozero, _ = triple(1, oswald_boundary_zeroing=False, device=dev)

    lines = []
    w = lines.append
    w("# Golden-triple gap attribution (OS2015 [4,4], half=1, mu=1)")
    w("")
    w("Reference goldens (``linearelliptic_block_swipdg_decomp.py:41-43``): "
      "eta_nc=1.66e-01, eta_r=1.45e-01, eta_df=3.55e-01.")
    w("")
    w("## Sweep: mesh level x aggregation convention")
    w("")
    w("| s/subdom | h | convention | eta_nc | eta_r | eta_df | vs golden (nc, r, df) |")
    w("|---|---|---|---|---|---|---|")
    for nref, h, ex, pa in rows:
        s = 2 ** nref
        for conv, t in (("as-executed (norm of squared locals)", ex),
                        ("paper (sqrt of summed squares)", pa)):
            ratios = ", ".join(f"{t[k] / GOLDEN[k]:.2f}x" for k in ("nc", "r", "df"))
            w(f"| {s} | {h:.3f} | {conv} | {t['nc']:.4e} | {t['r']:.4e} "
              f"| {t['df']:.4e} | {ratios} |")
    w("")
    _, h1, ex1, pa1 = rows[1]
    w("## Findings")
    w("")
    w(f"1. **Matched cell**: s=2 (h={h1:.3f}) x paper convention: "
      f"eta_r {pa1['r'] / GOLDEN['r']:.3f}x, eta_df {pa1['df'] / GOLDEN['df']:.3f}x, "
      f"eta_nc {pa1['nc'] / GOLDEN['nc']:.3f}x of the goldens.  "
      "'half_num_fine_elements_per_subdomain_and_dim' = half the "
      "per-subdomain fine-cell count (s = 2*half); the goldens use UNSQUARED "
      "locals (the committed estimator squares them — the goldens predate "
      "that refactor; the same script's reductor import is also stale, "
      "reference ``...decomp.py:11``).")
    w("")
    w(f"2. **Mesh scaling**: the squared locals scale ~h^2 per level "
      f"(measured {rows[0][2]['df'] / rows[1][2]['df']:.2f}x df per halving), "
      "so neighboring mesh levels are 4x off and cannot match — the mesh "
      "identification is unambiguous.")
    w("")
    w(f"3. **eta_nc remainder** ({pa1['nc'] / GOLDEN['nc']:.2f}x): the "
      "triangulation — an independent unstructured numpy/scipy SWIPDG oracle "
      "(scripts/crisscross_oracle.py) reproduces this pipeline on the uniform "
      "Kuhn-diagonal mesh and lands on the reference golden on the "
      "crisscross mesh (the pattern of dune's ALU_2D_SIMPLEX_CONFORMING "
      "newest-vertex bisection); run "
      "`python -m pylrbms_tpu_torch.scripts.linearelliptic_block_swipdg_decomp "
      "--crisscross --paper-convention` for the triple in-pipeline.")
    w("")
    w("Generated by pylrbms_tpu_torch/scripts/golden_gap_study.py.")
    text = "\n".join(lines) + "\n"
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
    print(text)
    return {"rows": rows, "paper_nozero": pa_nozero, "text": text}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="results_out/golden_gap_attribution.md",
                   help="where the attribution text goes ('' = print only)")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(a.out, device=a.device)


if __name__ == "__main__":
    cli()
