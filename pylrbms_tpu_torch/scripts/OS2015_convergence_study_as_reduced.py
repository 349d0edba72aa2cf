"""OS2015 EOC tables of the reduced model on the card: the port of
``scripts/OS2015_convergence_study_as_reduced.py``.

Per level, an ``LRBMSReductor`` from the snapshot at mu = 1 and the study
run on its reduced model (2x2 subdomains, half 2; p=2 reference).

    python -m pylrbms_tpu_torch.scripts.OS2015_convergence_study_as_reduced \\
        [--paper] [--device cpu]

:func:`main` returns the study's data and level infos.
"""
from __future__ import annotations

import argparse
from functools import partial

config = {'num_subdomains': [2, 2],
          'half_num_fine_elements_per_subdomain_and_dim': 2,
          'num_refinements': 0,
          'grid_type': 'tri'}


def discretize_reduced(grid_and_problem_data, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..reductor import ExtensionError, LRBMSReductor
    d, data = discretize(grid_and_problem_data, device=device)
    reductor = LRBMSReductor(d)
    try:
        reductor.extend_basis(d.solve(d.parse_parameter(1.)))
    except ExtensionError:
        pass
    rd = reductor.reduce()

    class _RdAdapter:
        """Expose the reduced model through the EOC-study interface."""
        space = d.space

        def parse_parameter(self, mu):
            return d.parse_parameter(mu)

        def solve(self, mu):
            return rd.solve(mu)

        def estimate(self, u, mu, decompose=False, paper_convention=False):
            return rd.estimate(u, mu, decompose=decompose,
                               paper_convention=paper_convention)

    return _RdAdapter(), {'block_space': d.space, 'reductor': reductor,
                          'unblock': d.unblock}


def main(max_levels=1, paper_convention=False, device=None):
    from ..EOC import StationaryEocStudy, default_refine
    from ..problems.os2015 import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    print('OS2015 tables for the reduced model (snapshots at mu=1)'
          + (' — paper convention' if paper_convention else ''))
    study = StationaryEocStudy(init_grid_and_problem, partial(discretize_reduced, device=dev),
                               config, default_refine, mu=1, max_levels=max_levels,
                               paper_convention=paper_convention, device=dev)
    data = study.run(('h', 'elliptic_mu_bar', 'eta_nc', 'eta_df', 'eta'))
    return {"data": data, "levels": [study.level_info(lv) for lv in sorted(data)]}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--paper', action='store_true')
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(paper_convention=a.paper, device=a.device)


if __name__ == '__main__':
    cli()
