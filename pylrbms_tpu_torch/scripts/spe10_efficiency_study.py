"""SPE10 estimator efficiency on the card: the port of ``scripts/spe10_efficiency_study.py``.

True energy error against a p=2 reference on the finest grid (nested
prolongation), paper-convention eta, efficiency = error / eta over 3
levels and 2 parameters.  The permeability is the SPE10 model-2 layer
pooled to a 16x16 nearest raster (every level resolves the same
coefficient), clipped to contrast 1e4.  ``--deep``: 8x8 subdomains and 4
levels (a 196 608-dof p=2 reference).

    python -m pylrbms_tpu_torch.scripts.spe10_efficiency_study [--deep] [--device cpu]

:func:`main` returns per mu the study's data and level infos.
"""
from __future__ import annotations

import argparse
from functools import partial

import numpy as np

CONFIG = {'num_subdomains': [4, 4],
          'half_num_fine_elements_per_subdomain_and_dim': 2,
          'num_refinements': 0,
          'grid_type': 'tri'}
RASTER = (16, 16)
MAX_CONTRAST = 1e4


def discretize(grid_and_problem_data, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    d, data = discretize(grid_and_problem_data, device=device)
    return d, {'block_space': data['block_space'], 'unblock': d.unblock}


def main(max_levels=2, mus=(1.0, 0.3), layer=42, deep=False, config=None, device=None):
    from ..EOC import StationaryEocStudy, default_refine
    from ..problems.spe10 import init_grid_and_problem, load_spe10_layer, pool_log_mean
    from ..utils.precision import device as _device

    dev = _device(device)
    cfg = dict(config or CONFIG)
    if deep:
        # 4 levels with smaller subdomains: coarsest 8x8 subdomains x s=2
        # -> 16x16 cells (the raster scale), refining to 128x128 cells
        cfg = dict(cfg, num_subdomains=[8, 8])
        max_levels = 3
    perm = pool_log_mean(load_spe10_layer(layer), *RASTER, mode="nearest")
    perm = perm / perm.max()
    perm = np.maximum(perm, 1.0 / MAX_CONTRAST)
    print("SPE10 model-2 estimator-efficiency study (paper convention)")
    print(f"field: layer {layer} pooled to {RASTER[0]}x{RASTER[1]} "
          f"(nearest — keeps the pointwise contrast), contrast after clip = "
          f"{perm.max() / perm.min():.2e}")
    print("reference: p=2 monolithic SWIPDG on the finest grid, nested "
          "prolongation; norm = elliptic energy at mu_bar")
    print("efficiency column = ||u_ref - u_h||_energy / eta  (constant "
          "across levels <=> the estimator is reliable at a fixed factor "
          "on SPE10, the BASELINE 'estimator-efficiency parity' clause)")
    print()
    init = partial(init_grid_and_problem, raster=RASTER,
                   raster_mode="nearest", max_contrast=MAX_CONTRAST)
    out = {}
    for mu in mus:
        print(f"--- mu (switch) = {mu} ---")
        study = StationaryEocStudy(init, partial(discretize, device=dev), cfg, default_refine,
                                   mu={'switch': mu}, max_levels=max_levels,
                                   paper_convention=True, device=dev)
        data = study.run(('h', 'elliptic_mu_bar', 'eta_nc', 'eta_r', 'eta_df', 'eta'))
        out[mu] = {"data": data, "levels": [study.level_info(lv) for lv in sorted(data)]}
        print()
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--deep", action="store_true",
                   help="8x8 subdomains, 4 levels (196 608-dof p=2 reference)")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return main(deep=a.deep, device=a.device)


if __name__ == '__main__':
    cli()
