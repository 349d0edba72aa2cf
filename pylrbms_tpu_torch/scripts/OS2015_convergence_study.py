"""OS2015 Tables 1-3 on the card: the port of ``scripts/OS2015_convergence_study.py``.

EOC studies of the block SWIPDG P1 discretization (OS2015, pp.
A2885-A2886) through ``EOC.StationaryEocStudy``: 2x2 subdomains, half 2,
levels nref 0..max_levels against a p=2 reference on the finest grid.
``--crisscross`` takes the reference's triangulation; ``--paper`` the
unsquared locals (first-order indicators).

    python -m pylrbms_tpu_torch.scripts.OS2015_convergence_study \\
        [--crisscross] [--paper] [--device cpu]

:func:`main` returns the four studies' data (``EocStudy.run``) and their
level infos, in the order printed.
"""
from __future__ import annotations

import argparse
import copy
from functools import partial

config = {'num_subdomains': [2, 2],
          'half_num_fine_elements_per_subdomain_and_dim': 2,
          'num_refinements': 0,
          'grid_type': 'tri'}


def discretize(grid_and_problem_data, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    d, data = discretize(grid_and_problem_data, device=device)
    return d, {'block_space': data['block_space'], 'unblock': d.unblock}


def _run(study, columns):
    """One table: a copy of the study's data (a study object accumulates
    the columns of every table run on it)."""
    data = copy.deepcopy(study.run(columns))
    return {"data": data, "levels": [study.level_info(lv) for lv in sorted(data)]}


def main(max_levels=2, paper_convention=False, crisscross=False, device=None):
    from ..EOC import StationaryEocStudy, default_refine
    from ..problems.os2015 import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    cfg = dict(config, grid_type='crisscross') if crisscross else config
    disc = partial(discretize, device=dev)
    print('M. Ohlberger, F. Schindler, 2015, Error control for the Localized Reduced')
    print('Basis Multiscale method with adaptive on-line enrichment — Block SWIPDG P1')
    if paper_convention:
        print('(paper convention: unsquared locals -> first-order indicators,')
        print(' level-constant efficiency — shape-comparable to p. A2885 Table 1)')
    print()

    def study(init):
        return StationaryEocStudy(init, disc, cfg, default_refine, mu=1,
                                  max_levels=max_levels,
                                  paper_convention=paper_convention, device=dev)

    out = []
    s = study(init_grid_and_problem)
    print("Table 1 columns (h, elliptic norm, eta_nc, eta_df):")
    out.append(_run(s, ('h', 'elliptic_mu_bar', 'eta_nc', 'eta_df')))
    print()
    print("Table 2 (mu_hat=1): eta_r and eta")
    out.append(_run(s, ('h', 'eta_r', 'eta')))
    print()
    print("Table 2 (mu_hat=0.1): eta_df and eta")
    out.append(_run(study(partial(init_grid_and_problem, mu_bar=1, mu_hat=0.1)),
                    ('h', 'eta_df', 'eta')))
    print()
    print("Table 3 (mu_bar=mu_hat=0.1):")
    out.append(_run(study(partial(init_grid_and_problem, mu_bar=0.1, mu_hat=0.1)),
                    ('h', 'elliptic_mu_bar', 'eta_nc', 'eta')))
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--crisscross', action='store_true')
    p.add_argument('--paper', action='store_true')
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(paper_convention=a.paper, crisscross=a.crisscross, device=a.device)


if __name__ == '__main__':
    cli()
