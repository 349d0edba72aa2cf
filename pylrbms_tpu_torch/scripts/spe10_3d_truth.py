"""Truth references past the SuperLU ceiling, on the card.

The port's counterpart of ``scripts/spe10_3d_truth.py`` (same ``CONFIGS``
and flags): solves 3D SPE10 configurations f64-accurately through the
stencil-only mixed-precision path (``pylrbms_tpu_torch/truth.py``) and
prints residuals, iterations and seconds per stage.

    python -m pylrbms_tpu_torch.scripts.spe10_3d_truth --config 442k-q2 \\
        --mus 1.0,0.3 --save truth442k.npz

runs on the current CUDA device.  Configs:
65k (z-thin Q1, the adversarial efficiency-study level), 131k-q1,
221k-q2 (the default study's Q2 reference), 442k-q2 (the measured SuperLU
wall; ``docs/results/ref442k.npz`` holds the JAX package's solutions),
524k-q1, 1m-q1 (64x64x32 cells), 1.8m-q2.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

CONFIGS = {
    # name: (raster, subdomains, nref, order, harvest, rounds, solve_only,
    #        recurrence)
    # solve_only=True uses truth.SolveOnlyModel (one stencil and the rhs,
    # no dense [K, N, N] tensors); recurrence 'f64' (the f64 PCG, required
    # on the z-thin configs) | 'f32ir' (f32 inner IR, the near-isotropic
    # configs)
    "65k": ((2, 8, 8), [8, 8, 2], 2, 1, 32, 2, False, "f64"),
    "131k-q1": ((4, 8, 8), [8, 8, 4], 2, 1, 32, 2, False, "f64"),
    "221k-q2": ((2, 8, 8), [16, 16, 4], 1, 2, 32, 2, False, "f64"),
    "442k-q2": ((4, 8, 8), [8, 8, 4], 2, 2, 32, 2, True, "f64"),
    "524k-q1": ((2, 8, 8), [8, 8, 2], 3, 1, 32, 2, True, "f64"),
    "1m-q1": ((4, 8, 8), [8, 8, 4], 3, 1, 32, 2, True, "f64"),
    "1.8m-q2": ((2, 8, 8), [8, 8, 2], 3, 2, 24, 2, True, "f64"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="221k-q2", choices=sorted(CONFIGS))
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--mus", type=str, default=None,
                    help="comma-separated mus to solve and save (overrides --mu)")
    ap.add_argument("--max-contrast", type=float, default=1e4)
    ap.add_argument("--save", type=str, default=None,
                    help="save the solutions as NPZ (key u_<mu>)")
    ap.add_argument("--check-splu", action="store_true",
                    help="also solve with host splu and compare (below the SuperLU "
                         "wall, full models only)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="override the Krylov chunk size (chunk_iters)")
    ap.add_argument("--harvest", type=int, default=None,
                    help="override the config's n_harvest (0 = modal-only coarse)")
    ap.add_argument("--recurrence", choices=("f64", "f32ir"), default=None,
                    help="override the config's Krylov recurrence")
    ap.add_argument("--tol", type=float, default=1e-10)
    args = ap.parse_args(argv)
    (raster, subs, nref, order, nh, rounds, solve_only, recurrence) = CONFIGS[args.config]
    if args.harvest is not None:
        nh = args.harvest
    if args.recurrence is not None:
        recurrence = args.recurrence

    import torch
    from ..problems.spe10 import init_grid_and_problem_3d
    from ..truth import SolveOnlyModel, truth_solve
    from ..utils.precision import device as _device

    dev = _device(None)
    print(f"# truth-solve {args.config} on {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    gpd = init_grid_and_problem_3d(
        {"num_subdomains": subs, "half_num_fine_elements_per_subdomain_and_dim": 1,
         "num_refinements": nref},
        raster=raster, raster_mode="nearest", max_contrast=args.max_contrast)
    if solve_only:
        d = SolveOnlyModel(gpd, order=order, device=dev)
    else:
        from ..discretize_elliptic_block_swipdg3d import discretize
        d, _ = discretize(gpd, order=order, lean=True, device=dev)
    K, N = d.space.K, d.space.N
    print(f"{'solve-only assembly' if solve_only else 'discretize'}: {K * N} dofs "
          f"(K={K}, N={N}, order={order}), {time.perf_counter() - t0:.1f} s")
    mus = [float(m) for m in args.mus.split(",")] if args.mus else [args.mu]
    saved = {}
    U = mu = None
    for mv in mus:
        mu = {"switch": mv}
        t0 = time.perf_counter()
        U, info = truth_solve(d, mu, tol=args.tol, n_harvest=nh, rounds=rounds, verbose=True,
                              recurrence=recurrence, chunk_iters=args.chunk)
        print(f"mu={mv}: relres {info['relres']:.2e}; f32 its {info['it32']} "
              f"({info['rounds']} rounds, f64 polish {info['it64']}); assemble "
              f"{info['t_assemble']:.1f} s, coarse {info['t_coarse']:.1f} s, solve "
              f"{info['t_solve']:.1f} s, total {time.perf_counter() - t0:.1f} s")
        saved[f"u_{mv}"] = U
    if len(mus) == 1:
        # warm repeat (the steady economics once everything is built once)
        t0 = time.perf_counter()
        _, info2 = truth_solve(d, {"switch": mus[0] * 0.999}, tol=args.tol, n_harvest=nh,
                               rounds=rounds, verbose=False, recurrence=recurrence)
        print(f"warm second mu: solve {info2['t_solve']:.1f} s (+ coarse "
              f"{info2['t_coarse']:.1f} s), relres {info2['relres']:.2e}, total "
              f"{time.perf_counter() - t0:.1f} s")
    if args.save:
        np.savez_compressed(args.save, config=args.config, max_contrast=args.max_contrast,
                            subs=np.asarray(subs), nref=nref, order=order,
                            raster=np.asarray(raster), **saved)
        print(f"saved {args.save}")
    if args.check_splu:
        import scipy.sparse.linalg as spla
        from ..la.block import to_scipy_csr
        t0 = time.perf_counter()
        mu = d.parse_parameter(mu)
        A = to_scipy_csr(d.assemble(mu)).tocsc()
        u_ref = spla.splu(A).solve(d.rhs(mu).double().cpu().numpy().ravel())
        rel = np.abs(U.reshape(-1) - u_ref).max() / max(np.abs(u_ref).max(), 1e-300)
        print(f"splu check: factorize+solve {time.perf_counter() - t0:.1f} s; "
              f"|U - U_splu|_inf rel {rel:.2e}")


if __name__ == "__main__":
    main()
