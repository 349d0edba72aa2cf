"""The SPE10 parabolic north-star on the card: the port of ``scripts/spe10_parabolic.py``.

Implicit-Euler heat flow through the SPE10 model-2 permeability slice at
the 98 304-dof greedy configuration (16x16 subdomains, half 2, nref 2,
T = 1, nt = 20): the trajectory (matrix-free warm-started PCG per step,
frozen two-level preconditioner), its final step's implicit-Euler
residual, the parabolic estimate, a host scipy ``splu`` implicit Euler as
the baseline (``--skip-host`` drops it), ``--batch B`` lane-batched
trajectories, and ``--rom``: the certified snapshot ROM.  The recorded run
is ``--rom --rom-snapshots 4``.

    python -m pylrbms_tpu_torch.scripts.spe10_parabolic --rom --rom-snapshots 4 \\
        [--device cpu]

:func:`main` returns the residual, eta, the host agreement and the ROM's
eta and error (those that ran).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdomains", type=int, nargs=2, default=(16, 16))
    ap.add_argument("--half", type=int, default=2)
    ap.add_argument("--nref", type=int, default=2)
    ap.add_argument("--T", type=float, default=1.0)
    ap.add_argument("--nt", type=int, default=20)
    ap.add_argument("--mu", type=float, default=0.5)
    ap.add_argument("--skip-host", action="store_true",
                    help="skip the scipy splu baseline")
    ap.add_argument("--rom", action="store_true",
                    help="snapshot-reduce the parabolic model and run the "
                         "certified ROM (projected N-independent estimate)")
    ap.add_argument("--rom-snapshots", type=int, default=8,
                    help="trajectory snapshots kept for the reduced basis "
                         "(evenly strided; GS truncates dependents)")
    ap.add_argument("--batch", type=int, default=0,
                    help="also run B lane-batched FOM trajectories in one "
                         "call (solve_batch) and report ms/step/mu")
    ap.add_argument("--batch-exact-precond", action="store_true",
                    help="per-mu block-Jacobi factors in the batched run "
                         "(default: one frozen factor set shared across "
                         "the batch)")
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None, device=None):
    args = _parser().parse_args(argv)
    from ..discretize_parabolic_block_swipdg import discretize
    from ..problems.spe10 import init_grid_and_problem
    from ..utils.logging import getLogger
    from ..utils.precision import device as _device

    dev = _device(device if device is not None else args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    log = getLogger("pylrbms.spe10_parabolic")
    out = {}
    cfg = {"num_subdomains": list(args.subdomains),
           "half_num_fine_elements_per_subdomain_and_dim": args.half,
           "num_refinements": args.nref}
    t0 = time.perf_counter()
    im, data = discretize(init_grid_and_problem(cfg), T=args.T, nt=args.nt, device=dev)
    st = im.stationary
    K, N = st.space.K, st.space.N
    log.info(f"discretize: {time.perf_counter() - t0:.1f} s — {K} subdomains,"
             f" {K * N} dofs, nt={args.nt}, dt={args.T / args.nt:g}")

    mu = im.parse_parameter({"switch": args.mu})
    t0 = time.perf_counter()
    traj = im.solve(mu)
    sync()
    t_cold = time.perf_counter() - t0
    # warm run at a different parameter (the frozen preconditioner is
    # reused; only the per-mu assembly re-runs)
    mu2 = im.parse_parameter({"switch": 0.9 * args.mu})
    t0 = time.perf_counter()
    traj2 = im.solve(mu2)
    sync()
    t_warm = time.perf_counter() - t0
    log.info(f"trajectory [{args.nt} implicit-Euler steps]: first "
             f"{t_cold:.1f} s (with the preconditioner build), warm {t_warm:.2f} s "
             f"({t_warm / args.nt * 1e3:.0f} ms/step)")
    out.update(t_first=t_cold, t_warm=t_warm)

    # self-check: the final step satisfies its implicit-Euler equation
    dt = args.T / args.nt
    A = st.assemble(mu2)
    M = st.products["l2"]
    u_prev, u_last = traj2[-2], traj2[-1]
    f = st.rhs(mu2)
    lhs = torch.einsum("knm,km->kn", M, u_last) + dt * A.apply(u_last)
    rhs = torch.einsum("knm,km->kn", M, u_prev) + dt * f
    rel = float(torch.linalg.norm((lhs - rhs).reshape(-1))
                / torch.linalg.norm(rhs.reshape(-1)))
    log.info(f"final-step implicit-Euler residual: {rel:.2e}")
    assert rel < 1e-6, rel
    out["euler_residual"] = rel

    # parabolic estimator over the trajectory (the certification quantity)
    t0 = time.perf_counter()
    eta, _parts = im.estimate(traj2, mu2)
    eta = float(eta)
    log.info(f"parabolic estimate: {time.perf_counter() - t0:.1f} s, eta = {eta:.6e}")
    out["eta"] = eta

    if not args.skip_host:
        import scipy.sparse as sps
        import scipy.sparse.linalg as spla
        from ..la.block import to_scipy_csr
        t0 = time.perf_counter()
        A_csr = to_scipy_csr(A)
        M_np = M.double().cpu().numpy()
        M_csr = sps.block_diag([M_np[k] for k in range(K)], format="csc")
        G = (M_csr + dt * A_csr).tocsc()
        t_asm = time.perf_counter() - t0
        t0 = time.perf_counter()
        lu = spla.splu(G)
        t_fac = time.perf_counter() - t0
        b_np = f.double().cpu().numpy().reshape(-1)
        u = np.zeros(K * N)
        t0 = time.perf_counter()
        for _ in range(args.nt):
            u = lu.solve(M_csr @ u + dt * b_np)
        t_steps = time.perf_counter() - t0
        err = np.abs(u - traj2[-1].double().cpu().numpy().reshape(-1)).max() / max(
            np.abs(u).max(), 1e-300)
        log.info(f"host splu baseline: assemble {t_asm:.1f} s + factorize "
                 f"{t_fac:.1f} s + {args.nt} steps {t_steps:.1f} s = "
                 f"{t_asm + t_fac + t_steps:.1f} s; final-state agreement "
                 f"{err:.2e}")
        log.info(f"device vs host (factorize+steps): "
                 f"{(t_fac + t_steps) / t_warm:.1f}x")
        out["host_agreement"] = float(err)

    if args.batch:
        B = args.batch
        shared = not args.batch_exact_precond
        mus_b = [im.parse_parameter({"switch": m}) for m in np.linspace(0.3, 0.95, B)]
        t0 = time.perf_counter()
        im.solve_batch(mus_b, shared_preconditioner=shared)
        sync()
        t_bcold = time.perf_counter() - t0
        mus_b2 = [im.parse_parameter({"switch": m}) for m in np.linspace(0.35, 0.9, B)]
        t0 = time.perf_counter()
        Ub2 = im.solve_batch(mus_b2, shared_preconditioner=shared)
        sync()
        t_bwarm = time.perf_counter() - t0
        lane = B // 2
        ref = im.solve(mus_b2[lane])
        rel_b = float((Ub2[lane] - ref).abs().max() / ref.abs().max())
        log.info(
            f"batched trajectories [B={B}, "
            f"{'shared' if shared else 'per-mu'} block-Jacobi]: first "
            f"{t_bcold:.1f} s, warm {t_bwarm:.2f} s = "
            f"{t_bwarm / args.nt * 1e3 / B:.1f} ms/step/mu "
            f"({t_warm / (t_bwarm / B):.1f}x the single-mu trajectory per "
            f"query); lane vs single-mu solve: {rel_b:.2e}")
        assert rel_b < 1e-8, rel_b
        out["batch_lane"] = rel_b

    if args.rom:
        # certified parabolic ROM: snapshot basis from the mu-trajectories,
        # implicit Euler on the reduced system, N-independent projected
        # estimate
        from ..reductor import ParabolicLRBMSReductor
        nsnap = min(args.rom_snapshots, args.nt + 1)
        sel = torch.as_tensor(np.unique(np.linspace(0, args.nt, nsnap).astype(int)))
        t0 = time.perf_counter()
        red = ParabolicLRBMSReductor(st)
        red.extend_basis(torch.cat([traj[sel.to(traj.device)], traj2[sel.to(traj.device)]]))
        rd = red.reduce().attach_instationary(im)
        t_red = time.perf_counter() - t0
        r_max = int(rd.r_max)
        log.info(f"reduce: {t_red:.1f} s — {len(sel)} snapshots, "
                 f"r_max={r_max} ({K * r_max} reduced dofs)")
        c = rd.solve(mu2)
        sync()
        t0 = time.perf_counter()
        c = rd.solve(mu2)
        sync()
        t_rom = time.perf_counter() - t0
        eta_rom, _ = rd.estimate(c, mu2, projected=True)
        t0 = time.perf_counter()
        eta_rom, _ = rd.estimate(c, mu2, projected=True)
        eta_rom = float(eta_rom)
        t_est = time.perf_counter() - t0
        U_rec = red.reconstruct(c)
        err = float((U_rec[-1] - traj2[-1].double()).abs().max() / traj2[-1].abs().max())
        log.info(f"ROM trajectory [{args.nt} steps]: warm {t_rom * 1e3:.1f} ms"
                 f" ({t_rom / args.nt * 1e3:.2f} ms/step, "
                 f"{t_warm / t_rom:.0f}x the FOM trajectory); projected "
                 f"estimate {t_est * 1e3:.1f} ms, eta = {eta_rom:.6e} "
                 f"(FOM eta = {eta:.6e}); final-state rel err "
                 f"(training-mu reconstruction) {err:.2e}")
        out.update(rom_eta=eta_rom, rom_error=err, r_max=r_max)
    return out


if __name__ == "__main__":
    main()
