"""Artificial-channels parabolic demo on the card: the port of ``scripts/parabolic.py``.

FOM implicit-Euler trajectory, 1-snapshot ``ParabolicLRBMSReductor``, FOM
and ROM estimates with their 5 indicator groups; ``--pod N`` adds the
POD-greedy.  The reference's own configuration is
``--subdomains 8 8 --nt 100``.

    python -m pylrbms_tpu_torch.scripts.parabolic [--subdomains 8 8] [--nt 100] \\
        [--pod N --training M] [--device cpu]

:func:`main` returns the reduction error and the FOM and ROM estimates
with their groups (each group's norm).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(T=1.0, nt=20, subdomains=(4, 4), half=1, nref=1, pod=0, training=0, device=None):
    from ..discretize_parabolic_block_swipdg import discretize
    from ..problems.artificial_channels import init_grid_and_problem
    from ..reductor import ParabolicLRBMSReductor
    from ..utils.precision import device as _device

    dev = _device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    config = {'num_subdomains': list(subdomains),
              'half_num_fine_elements_per_subdomain_and_dim': half,
              'num_refinements': nref,
              'grid_type': 'tri'}
    grid_and_problem_data = init_grid_and_problem(config)
    t0 = time.perf_counter()
    d, d_data = discretize(grid_and_problem_data, T, nt, device=dev)
    print(f'discretize: {time.perf_counter() - t0:.1f} s '
          f'(K={d.stationary.space.K}, N={d.stationary.space.N}, nt={nt})')

    mu = d.parameter_space.sample_randomly(1, seed=11)[0]
    t0 = time.perf_counter()
    U = d.solve(mu)
    sync()
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    d.solve(mu)
    sync()
    print(f'FOM trajectory solve: {time.perf_counter() - t0:.2f} s warm '
          f'({t_cold:.1f} s cold), {nt} implicit-Euler steps')

    reductor = ParabolicLRBMSReductor(d.stationary)
    reductor.extend_basis(U)
    rd = reductor.reduce().attach_instationary(d)

    u = rd.solve(mu)
    UU = reductor.reconstruct(u)
    red_err = float(torch.linalg.norm((U - UU).reshape(-1)) / torch.linalg.norm(U.reshape(-1)))
    print('Relative model reduction error:', red_err)

    out = {"reduction_error": red_err}

    def report(tag, est, parts):
        nrm = [float(torch.linalg.norm(p.reshape(-1))) for p in parts]
        print(f'Estimated error {tag}:')
        print('  total estimate:                    {:.6e}'.format(float(est)))
        print('  elliptic nonconformity indicator:  {:.6e}'.format(nrm[0]))
        print('  elliptic residual indicator:       {:.6e}'.format(nrm[1]))
        print('  elliptic diffusive flux indicator: {:.6e}'.format(nrm[2]))
        print('  time stepping residual:            {:.6e}'.format(nrm[3]))
        print('  time derivative nonconformity:     {:.6e}'.format(nrm[4]))
        out[tag] = dict(zip(("total", "nc", "r", "df", "rt", "tdnc"), [float(est)] + nrm))

    est, parts = d.estimate(U, mu)
    report('FOM', est, parts)
    t0 = time.perf_counter()
    est, parts = rd.estimate(u, mu)
    report('ROM', est, parts)
    print(f'ROM solve+estimate: {time.perf_counter() - t0:.2f} s')

    if pod:
        from ..greedy import pod_greedy
        train = d.parameter_space.sample_uniformly(training or 5)
        t0 = time.perf_counter()
        res = pod_greedy(d, train, target_error=1e-6, max_extensions=pod,
                         pod_modes=2)
        print(f'POD-greedy: {len(res.max_etas)} iterations, '
              f'{res.fom_solves} FOM trajectory solves, '
              f'max estimate {res.max_etas[0]:.3e} -> {res.max_etas[-1]:.3e}, '
              f'{time.perf_counter() - t0:.1f} s')
        out["pod_max_etas"] = list(res.max_etas)
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--T', type=float, default=1.0)
    p.add_argument('--nt', type=int, default=20)
    p.add_argument('--subdomains', type=int, nargs=2, default=[4, 4])
    p.add_argument('--half', type=int, default=1)
    p.add_argument('--nref', type=int, default=1)
    p.add_argument('--pod', type=int, default=0,
                   help='run pod_greedy with this many extensions')
    p.add_argument('--training', type=int, default=0)
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(T=a.T, nt=a.nt, subdomains=tuple(a.subdomains), half=a.half,
                nref=a.nref, pod=a.pod, training=a.training, device=a.device)


if __name__ == '__main__':
    cli()
