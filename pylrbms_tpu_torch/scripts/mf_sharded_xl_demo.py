"""The K-sharded matrix-free solve on the card: the port of ``scripts/mf_sharded_xl_demo.py``.

The academic 3D problem at mu = 0.5 on 8x8x4 hex subdomains (``--dofs-scale
xl``: s = 8, 1 048 576 dofs; ``small``: s = 4, 131 072 dofs), f64: the
stencil operator, cell-block Jacobi and the subdomain-constant coarse
level, solved by PCG to 1e-8 (restarted from its iterate every 500
iterations) through ``parallel/mesh.SubdomainMesh.mf_solve`` over
``--world`` ranks, each holding a band of z-layers.  Rank 0 also solves
unsharded and compares.

    python -m pylrbms_tpu_torch.scripts.mf_sharded_xl_demo [--dofs-scale small] \\
        [--world 2 --backend gloo] [--device cpu]

Several ranks on one card need ``--backend gloo`` (NCCL refuses two ranks
on one device).  :func:`main` returns rank 0's result: iterations and
relative residual sharded and unsharded, the sharded U against the
unsharded one, seconds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SUBDOMAINS = (8, 8, 4)
HALF = {"xl": 8, "small": 4}


def _restarted(solve, relres, rounds=20):
    """PCG in restarts of at most 500 iterations from the last iterate."""
    U, total, r = None, 0, float("inf")
    for _ in range(rounds):
        U, it = solve(U)
        total += int(it)
        r = relres(U)
        if r < 1e-8 or int(it) == 0:
            break
    return U, total, r


def rank_solve(subdomains, half):
    """One rank's part (a module-level function: the rank launcher imports
    it): build, shard over the default group, solve; rank 0 solves the
    whole system too and compares."""
    from ..ops import assembly3d as asm3
    from ..ops.matrixfree3d import (StencilOperator3, assemble_swipdg_stencil3,
                                    stencil_coarse_matrix)
    from ..ops.spaces3d import BlockDGSpace3D
    from ..parallel.mesh import SubdomainMesh
    from ..problems.academic3d import init_grid_and_problem

    mesh = SubdomainMesh.create()
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    gpd = init_grid_and_problem(
        {'num_subdomains': list(subdomains),
         'half_num_fine_elements_per_subdomain_and_dim': half,
         'num_refinements': 0})
    sp = BlockDGSpace3D(gpd["grid"])
    stencils = tuple(assemble_swipdg_stencil3(sp, lf, None, dtype=torch.float64, device=dev)
                     for lf in gpd["lambda"]["functions"])
    rhs = asm3.volume_functional(sp, gpd["f"], torch.float64, dev)
    sop = StencilOperator3(sp, stencils)
    theta = torch.tensor([1.0, 0.5], dtype=torch.float64, device=dev)
    sync()
    t_asm = time.perf_counter() - t0

    t0 = time.perf_counter()
    A_full = sop.assemble(theta)
    ci = torch.linalg.inv(stencil_coarse_matrix(A_full).double())
    bsop = mesh.shard_stencil(sop)
    A_band = bsop.assemble(theta)
    k0 = mesh.shard_k(0)
    b = mesh.put(rhs, k0)
    bn = float(torch.linalg.norm(rhs.reshape(-1)))
    sync()
    t_pre = time.perf_counter() - t0

    def relres_band(U):
        loc = torch.sum((b - A_band.apply(U)) ** 2)
        return float(torch.sqrt(mesh.sum(loc))) / bn

    t0 = time.perf_counter()
    U, its, r = _restarted(
        lambda x0: mesh.mf_solve(bsop, theta, b, coarse_inv=ci, tol=1e-8, maxiter=500,
                                 x0=x0),
        relres_band)
    sync()
    t_solve = time.perf_counter() - t0
    U_all = mesh.gather(U, k0)
    out = {"K": sp.K, "N": sp.N, "world": mesh.size, "its": its, "relres": r,
           "t_assembly": t_asm, "t_precond": t_pre, "t_solve": t_solve}
    if mesh.rank == 0:
        t0 = time.perf_counter()
        U1, its1, r1 = _restarted(
            lambda x0: A_full.solve_pcg(rhs, tol=1e-8, maxiter=500, coarse_inv=ci,
                                        return_iters=True, x0=x0),
            lambda x: float(torch.linalg.norm((rhs - A_full.apply(x)).reshape(-1))) / bn)
        sync()
        out.update(its_unsharded=its1, relres_unsharded=r1,
                   t_solve_unsharded=time.perf_counter() - t0,
                   u_vs_unsharded=float((U_all - U1).abs().max() / U1.abs().max()))
    if mesh.rank == 0 and sp.K * sp.N <= 200000:
        out["U"] = U_all.cpu().numpy()
    return out


def main(argv=None, device=None, subdomains=SUBDOMAINS, half=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dofs-scale", choices=("small", "xl"), default="xl",
                    help="small: 131k dofs (s=4); xl: 1M dofs (s=8)")
    ap.add_argument("--world", type=int, default=1, help="ranks (z-layers % world == 0)")
    ap.add_argument("--backend", default=None,
                    help="nccl | gloo (default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    from ..utils.precision import device as _device
    from .distributed_smoke import launch
    dev = _device(device if device is not None else args.device)
    half = HALF[args.dofs_scale] if half is None else half
    t0 = time.perf_counter()
    payloads = launch(rank_solve, args.world, args=(tuple(subdomains), half),
                      device=str(dev), backend=args.backend, timeout_s=1800)
    res = payloads[0]["result"]
    res["launches"] = [p["launches"] for p in payloads]
    res["peak_bytes"] = [p["peak_bytes"] for p in payloads]
    print(f"K={res['K']}, N={res['N']}, {res['K'] * res['N']} dofs f64, world {res['world']} "
          f"({args.backend or 'default backend'}) on {dev}")
    print(f"assembly: {res['t_assembly']:.1f} s; preconditioner (cell-Jacobi + constant "
          f"coarse): {res['t_precond']:.1f} s")
    print(f"sharded XL solve: {res['t_solve']:.1f} s, {res['its']} PCG iterations, "
          f"relres {res['relres']:.1e}")
    print(f"unsharded: {res['its_unsharded']} iterations, relres "
          f"{res['relres_unsharded']:.1e}, {res['t_solve_unsharded']:.1f} s; sharded U vs "
          f"unsharded: max rel {res['u_vs_unsharded']:.2e}")
    print(f"ranks' launches {time.perf_counter() - t0:.1f} s in all; OK")
    return res


if __name__ == "__main__":
    main()
