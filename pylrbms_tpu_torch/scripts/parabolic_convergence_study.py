"""Instationary EOC on the thermal block on the card: the port of
``scripts/parabolic_convergence_study.py``.

``EOC.InstationaryEocStudy`` at mu = (1, 1, 1, 1), 2x2 subdomains, half 1,
T = 1, dt = 0.1 h per level, against a reference max_levels + 1
refinements finer.

    python -m pylrbms_tpu_torch.scripts.parabolic_convergence_study [--device cpu]

:func:`main` returns the study's data and level infos.
"""
from __future__ import annotations

import argparse
from functools import partial


def refine(cfg):
    from ..problems.thermalblock import init_grid_and_problem
    out = dict(cfg)
    out['num_refinements'] = cfg.get('num_refinements', 2) + 1
    out['dt'] = 0.1 * init_grid_and_problem(out)['grid'].max_entity_diameter()
    return out


def discretize(grid_and_problem_data, T, nt, device=None):
    from ..discretize_parabolic_block_swipdg import discretize
    d, data = discretize(grid_and_problem_data, T, nt, device=device)
    return d, {'block_space': data['block_space'], 'unblock': d.unblock}


def main(max_levels=1, device=None):
    from ..EOC import InstationaryEocStudy
    from ..problems.thermalblock import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    base_cfg = {'num_subdomains': [2, 2],
                'half_num_fine_elements_per_subdomain_and_dim': 1,
                'num_refinements': 0,
                'grid_type': 'tri',
                'T': 1}
    base_cfg['dt'] = 0.1 * init_grid_and_problem(base_cfg)['grid'].max_entity_diameter()
    reference_cfg = dict(base_cfg)
    for _ in range(max_levels + 1):
        reference_cfg = refine(reference_cfg)

    mu = (1, 1, 1, 1)
    print(f'Thermalblock, mu={mu}, Block SWIPDG P1, dt = 0.1*h')
    study = InstationaryEocStudy(init_grid_and_problem, partial(discretize, device=dev),
                                 base_cfg, refine, reference_cfg, mu=mu,
                                 max_levels=max_levels, device=dev)
    data = study.run(('h', 'eta_nc', 'eta_r', 'eta_df', 'R_T', 'partial_t_nc'))
    return {"data": data, "levels": [study.level_info(lv) for lv in sorted(data)]}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == '__main__':
    cli()
