"""The demo pipeline on the card: the port of ``scripts/online_adaptive_lrbms.py``.

Phase 1: OS2015 problem init (4x4 subdomains, half 2, nref 1); phase 2:
block discretize, detailed solve (PCG 1e-10) and estimate at mu = 1;
phase 3: reduction (``ParallelLRBMSReductor``, order 0, one snapshot),
reduced against detailed estimate; phase 4: ``AdaptiveEnrichment`` over 5
random mus (``sample_randomly(5, seed=7)``).

    python -m pylrbms_tpu_torch.scripts.online_adaptive_lrbms [--device cpu]

:func:`main` returns the printed numbers: the detailed and reduced eta and,
per online mu, the final eta and the RB size.
"""
from __future__ import annotations

import argparse

from ..config import LRBMSConfig, SolverConfig

CFG = LRBMSConfig.from_dict({
    'num_subdomains': [4, 4],
    'half_num_fine_elements_per_subdomain_and_dim': 2,
    'initial_RB_order': 0,
    'enrichment_target_error': 1e-2,
    'marking_doerfler_theta': 0.33,
    'marking_max_age': 4,
    'num_refinements': 1})
config = CFG.flat_dict()

solver_options = SolverConfig(type='pcg', max_iter=400, precision=1e-10,
                              post_check_solves_system=None).as_dict()


def main(num_online_mus: int = 5, enrichment_steps: int = 3, device=None, config=config):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..online_enrichment import AdaptiveEnrichment
    from ..problems.os2015 import init_grid_and_problem
    from ..reductor import ExtensionError, ParallelLRBMSReductor
    from ..utils.logging import getLogger, set_log_levels
    from ..utils.precision import device as _device

    dev = _device(device)
    set_log_levels({'pylrbms': 'INFO'})
    logger = getLogger('online_adaptive_lrbms')
    # Phase 1: problem
    grid_and_problem_data = init_grid_and_problem(config)

    # Phase 2: FOM + detailed solve & estimate
    d, d_data = discretize(grid_and_problem_data, solver_options, device=dev)
    mu = d.parse_parameter(1.)
    with logger.block('detailed solve + estimate'):
        U = d.solve(mu)
        eta, _, _ = d.estimate(U, mu, decompose=True)
    logger.info(f'detailed eta = {float(eta):.3e}')

    # Phase 3: reduction
    reductor = ParallelLRBMSReductor(d, order=config['initial_RB_order'])
    try:
        reductor.extend_basis(U)
    except ExtensionError:
        pass
    rd = reductor.reduce()
    u = rd.solve(mu)
    eta_red = float(rd.estimate(u, mu))
    logger.info(f'reduced eta = {eta_red:.3e} (detailed {float(eta):.3e})')

    # Phase 4: online adaptive enrichment over random mus
    online = AdaptiveEnrichment(grid_and_problem_data, d, d.space, reductor, rd,
                                target_error=config['enrichment_target_error'],
                                marking_doerfler_theta=config['marking_doerfler_theta'],
                                marking_max_age=config['marking_max_age'])
    online_out = []
    for i, mu_i in enumerate(d.parameter_space.sample_randomly(num_online_mus, seed=7)):
        u_i, rd_i, _ = online.solve(mu_i, enrichment_steps=enrichment_steps)
        eta_i = float(online.estimate(rd_i.solve(mu_i), mu_i))
        logger.info(f'online mu #{i}: final eta {eta_i:.3e}, RB size {rd_i.solution_dim}')
        online_out.append((eta_i, int(rd_i.solution_dim)))
    return {"eta": float(eta), "eta_red": eta_red, "online": online_out, "online_model": online}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--device', default=None, help="torch device (default: the current CUDA "
                                                  "device; raises without CUDA)")
    a = p.parse_args(argv)
    return main(device=a.device)


if __name__ == '__main__':
    cli()
