"""The SPE10 north-star pipeline on the card: the port of ``scripts/spe10_greedy.py``.

Offline: weak greedy over a uniform training set (each iteration one
batched surrogate evaluation over the training set and one FOM solve).
Online: adaptive local enrichment (3 steps) at random unseen parameters.
The recorded full-width run is ``--subdomains 16 16 --half 2 --nref 2
--training 8 --target 1e-2 --online-mus 3`` (K=256, N=384, 98 304 dofs).

    python -m pylrbms_tpu_torch.scripts.spe10_greedy --subdomains 16 16 --nref 2 \\
        --target 1e-2 [--device cpu]

:func:`main` returns the greedy's max surrogate per iteration, its FOM
solves and RB size, and per online mu the eta and RB size.
"""
from __future__ import annotations

import argparse

import torch


def main(num_subdomains=(8, 8), half=2, nref=1, training=8, target=1e-3,
         online_mus=3, dtype="float64", checkpoint=None, resume=False, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..greedy import weak_greedy
    from ..online_enrichment import AdaptiveEnrichment
    from ..problems.spe10 import init_grid_and_problem
    from ..utils.logging import getLogger, set_log_levels
    from ..utils.precision import device as _device
    from ..utils.timers import GLOBAL_TIMINGS as T

    dev = _device(device)
    T.enable()
    set_log_levels({'pylrbms': 'INFO'})
    logger = getLogger('spe10_greedy')
    cfg = {'num_subdomains': list(num_subdomains),
           'half_num_fine_elements_per_subdomain_and_dim': half,
           'num_refinements': nref}
    gpd = init_grid_and_problem(cfg)
    with T.span('discretize'):
        d, _ = discretize(gpd, dtype=getattr(torch, dtype), device=dev)
    logger.info(f'grid: {gpd["grid"].num_elements} elements, '
                f'{gpd["grid"].num_subdomains} subdomains, '
                f'{d.space.K * d.space.N} dofs')

    training_set = d.parameter_space.sample_uniformly(training)
    with T.span('offline greedy'):
        res = weak_greedy(d, training_set, target_error=target,
                          max_extensions=20, checkpoint_path=checkpoint,
                          resume=resume)
    logger.info(f'greedy: {len(res.max_etas)} iterations, '
                f'{res.fom_solves} FOM solves, final surrogate '
                f'{res.max_etas[-1]:.3e}, RB size {res.rd.solution_dim}')

    online = AdaptiveEnrichment(gpd, d, d.space, res.reductor, res.rd,
                                target_error=target,
                                marking_doerfler_theta=0.33, marking_max_age=4)
    online_out = []
    for i, mu in enumerate(d.parameter_space.sample_randomly(online_mus, seed=3)):
        with T.span(f'online mu #{i}'):
            u, rd, _ = online.solve(mu, enrichment_steps=3)
        eta = float(online.estimate(rd.solve(mu), mu))
        logger.info(f'online mu #{i}: eta {eta:.3e} RB size {rd.solution_dim}')
        online_out.append((eta, int(rd.solution_dim)))
    print(T.report())
    T.disable()
    return {"max_etas": [float(v) for v in res.max_etas], "fom_solves": int(res.fom_solves),
            "rb_size": int(res.rd.solution_dim), "online": online_out, "result": res}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--subdomains', type=int, nargs=2, default=[8, 8])
    p.add_argument('--half', type=int, default=2)
    p.add_argument('--nref', type=int, default=1)
    p.add_argument('--training', type=int, default=8)
    p.add_argument('--target', type=float, default=1e-3)
    p.add_argument('--online-mus', type=int, default=3)
    p.add_argument('--checkpoint', default=None,
                   help='path for per-iteration offline state (.npz)')
    p.add_argument('--resume', action='store_true')
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(tuple(a.subdomains), a.half, a.nref, a.training, a.target,
                online_mus=a.online_mus, checkpoint=a.checkpoint, resume=a.resume,
                device=a.device)


if __name__ == '__main__':
    cli()
