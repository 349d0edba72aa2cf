"""Detailed solve and VTU output on the card: the port of ``scripts/mpi_elliptic.py``.

OS2015 at mu = 0.5 (4x4 subdomains, half 2, nref 1), PCG to 1e-10, and the
solution written as a VTU file.

    python -m pylrbms_tpu_torch.scripts.mpi_elliptic [--out DIR] [--device cpu]

The file goes to ``--out`` (default ``vtu_out/``, which ``.gitignore``
lists).  :func:`main` returns the solution and the file's path.
"""
from __future__ import annotations

import argparse
import os

config = {'num_subdomains': [4, 4],
          'half_num_fine_elements_per_subdomain_and_dim': 2,
          'num_refinements': 1}


def main(out_dir: str = "vtu_out", device=None):
    from ..discretize_elliptic_block_swipdg import discretize
    from ..problems.os2015 import init_grid_and_problem
    from ..utils.precision import device as _device

    dev = _device(device)
    gpd = init_grid_and_problem(config)
    d, _ = discretize(gpd, solver_options={'type': 'pcg', 'precision': 1e-10,
                                           'max_iter': 400}, device=dev)
    mu = d.parse_parameter(0.5)
    U = d.solve(mu)
    os.makedirs(out_dir, exist_ok=True)
    out = d.visualize(U, os.path.join(out_dir, 'mpi_elliptic_solution'))
    print('wrote', out)
    return {"U": U, "path": out, "d": d}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('--out', default='vtu_out', help='directory of the VTU file')
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    return main(a.out, device=a.device)


if __name__ == '__main__':
    cli()
