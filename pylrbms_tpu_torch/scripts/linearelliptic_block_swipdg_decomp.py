"""The reference's acceptance script on the card: the port of
``scripts/linearelliptic_block_swipdg_decomp.py``.

OS2015 detailed solve at mu = 1 (4x4 subdomains, half 1, nref 1),
decomposed estimate, reduction from 5 uniform snapshots, reduced against
detailed solution, timed reduced solve and estimate.  ``--crisscross`` takes
the reference's triangulation and ``--paper-convention`` the unsquared
locals: together they reproduce the reference's golden triple
1.66e-01 / 1.45e-01 / 3.55e-01.

    python -m pylrbms_tpu_torch.scripts.linearelliptic_block_swipdg_decomp \\
        [--crisscross] [--paper-convention] [--device cpu]

:func:`main` returns the detailed triple and eta, the reduced ones and the
largest relative reduction error over the snapshots.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

config = {'num_subdomains': [4, 4],
          'half_num_fine_elements_per_subdomain_and_dim': 1,
          'num_refinements': 1,
          'grid_type': 'tri'}


def _norm(v) -> float:
    return float(np.linalg.norm(np.asarray(v.cpu() if hasattr(v, "cpu") else v, np.float64)))


def main(crisscross: bool = False, paper_convention: bool = False, device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.os2015 import init_grid_and_problem
    from ..reductor import ExtensionError, LRBMSReductor
    from ..utils.precision import device as _device

    dev = _device(device)
    cfg = dict(config, grid_type='crisscross') if crisscross else config
    PAPER = paper_convention
    grid_and_problem_data = init_grid_and_problem(cfg)
    d, d_data = discretize(grid_and_problem_data, device=dev)
    mu = d.parse_parameter(1.)

    U = d.solve(mu)
    print('estimating error:')
    eta, (local_eta_nc, local_eta_r, local_eta_df), _ = d.estimate(
        U, mu, decompose=True, paper_convention=PAPER)
    golden_mode = PAPER and cfg['grid_type'] == 'crisscross'

    def _suffix(golden):
        return f'  (reference golden: {golden})' if golden_mode else ''
    fom = {"eta_nc": _norm(local_eta_nc), "eta_r": _norm(local_eta_r),
           "eta_df": _norm(local_eta_df), "eta": float(eta)}
    print('  nonconformity indicator:  {:.6e}'.format(fom["eta_nc"]) + _suffix('1.66e-01'))
    print('  residual indicator:       {:.6e}'.format(fom["eta_r"]) + _suffix('1.45e-01'))
    print('  diffusive flux indicator: {:.6e}'.format(fom["eta_df"]) + _suffix('3.55e-01'))
    print('  estimated error:          {:.6e}'.format(fom["eta"]))

    reductor = LRBMSReductor(d)
    U_snap = []
    mus = d.parameter_space.sample_uniformly(2)[:5]
    for mu_i in mus:
        snapshot = d.solve(mu_i)
        U_snap.append(snapshot.double().cpu().numpy())
        try:
            reductor.extend_basis(snapshot)
        except ExtensionError:
            pass
    rd = reductor.reduce()

    errs = []
    for mu_i, U_i in zip(mus, U_snap):
        u = rd.solve(mu_i)
        UU = reductor.reconstruct(u).double().cpu().numpy()
        errs.append(np.linalg.norm(UU - U_i) / np.linalg.norm(U_i))
    print('max relative reduction error over snapshots: {:.3e}'.format(max(errs)))

    tic = time.time()
    u = rd.solve(mu)
    print('red solve time: ', time.time() - tic)
    tic = time.time()
    eta, (local_eta_nc, local_eta_r, local_eta_df), _ = rd.estimate(
        u, mu, decompose=True, paper_convention=PAPER)
    print('red est time: ', time.time() - tic)
    rom = {"eta_nc": _norm(local_eta_nc), "eta_r": _norm(local_eta_r),
           "eta_df": _norm(local_eta_df), "eta": float(eta)}
    print('  nonconformity indicator:  {:.6e}'.format(rom["eta_nc"]))
    print('  residual indicator:       {:.6e}'.format(rom["eta_r"]))
    print('  diffusive flux indicator: {:.6e}'.format(rom["eta_df"]))
    print('  estimated error:          {:.6e}'.format(rom["eta"]))
    return {"fom": fom, "rom": rom, "max_reduction_error": float(max(errs))}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--crisscross', action='store_true',
                   help="the reference's triangulation (ALU-conform bisection)")
    p.add_argument('--paper-convention', action='store_true',
                   help='unsquared local quantities (the goldens)')
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(a.crisscross, a.paper_convention, device=a.device)


if __name__ == '__main__':
    cli()
