"""SPE10 model-2 in native 3D on the card: the port of ``scripts/spe10_3d.py``.

A z-block of the permeability tensor (layers 40-44, contrast clipped to
1e4) on the 3D hex family: problem init, block SWIPDG discretize, detailed
solve (two-level PCG, or ``--mf``: the matrix-free two-level solve),
estimate, snapshot ROM; ``--greedy`` runs the weak greedy (then
``--online-mus`` enrichment, to ``--online-target-rel`` * eta_FOM when
given), ``--parabolic NT`` the implicit-Euler trajectory
(``--parabolic-batch B`` adds B lanes), ``--xl`` the stencil-only build and
solve (cell-free: subdomain-block Jacobi from the stencil's own diagonal
blocks plus the subdomain-constant coarse level).  The recorded runs:

    --subdomains 8 8 4 --half 1 --nref 2 --lean --mf        (131 072 dofs)
    --nref 2                                                 (16 384 dofs)
    --nref 2 --greedy 5 --training 6 --online-mus 3
    --nref 2 --greedy 2 --training 6 --online-mus 3 --online-target-rel 1.05
    --subdomains 8 8 4 --half 2 --nref 1 --lean --mf --skip-estimate \\
        --parabolic 20 --parabolic-batch 4
    --subdomains 8 8 4 --half 3 --nref 1 --xl                (442 368 dofs)

    python -m pylrbms_tpu_torch.scripts.spe10_3d [flags] [--device cpu]

:func:`main` returns the numbers it prints (residuals: ``relres`` as the
max-norm ratio, ``relres2`` as ||b - A U|| / ||b||, which the solve's
precision bounds; etas, the greedy's surrogates, the online etas, the
trajectory's residual).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subdomains", type=int, nargs=3, default=[4, 4, 2])
    ap.add_argument("--half", type=int, default=1)
    ap.add_argument("--nref", type=int, default=1)
    ap.add_argument("--contrast", type=float, default=1e4)
    ap.add_argument("--layers", type=int, nargs=2, default=[40, 44])
    ap.add_argument("--lean", action="store_true",
                    help="skip the MOR estimator tensors (FOM-only)")
    ap.add_argument("--order", type=int, default=1, choices=(1, 2),
                    help="polynomial order: 1 (trilinear Q1) or 2 (Q2 with "
                         "the RT_[1] hex estimator)")
    ap.add_argument("--mf", action="store_true",
                    help="matrix-free two-level FOM solve")
    ap.add_argument("--greedy", type=int, default=0,
                    help="run the weak greedy (this many max extensions) "
                         "over a --training-sized uniform training set")
    ap.add_argument("--training", type=int, default=6)
    ap.add_argument("--online-mus", type=int, default=0,
                    help="after --greedy: run this many online adaptive "
                         "enrichment parameters (3 rounds each)")
    ap.add_argument("--online-target-rel", type=float, default=0.0,
                    help="run each online enrichment to its own termination "
                         "at target = REL * eta_FOM(mu) instead of 3 rounds")
    ap.add_argument("--skip-estimate", action="store_true",
                    help="skip the FOM estimate")
    ap.add_argument("--parabolic", type=int, default=0, metavar="NT",
                    help="also run the native-3D implicit-Euler trajectory "
                         "with this many steps (T=1.0)")
    ap.add_argument("--parabolic-batch", type=int, default=0,
                    help="additionally run B lane-batched 3D trajectories "
                         "(solve_batch)")
    ap.add_argument("--xl", action="store_true",
                    help="stencil-only build + solve (no affine dense "
                         "per-subdomain family)")
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None, device=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.parabolic_batch and not args.parabolic:
        ap.error("--parabolic-batch requires --parabolic NT")
    from ..discretize_elliptic_block_swipdg3d import discretize
    from ..problems.spe10 import init_grid_and_problem_3d
    from ..reductor import LRBMSReductor
    from ..utils.precision import device as _device

    dev = _device(device if device is not None else args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    dtype = torch.float64
    out = {}

    t0 = time.perf_counter()
    gpd = init_grid_and_problem_3d(
        {"num_subdomains": args.subdomains,
         "half_num_fine_elements_per_subdomain_and_dim": args.half,
         "num_refinements": args.nref},
        layers=tuple(args.layers), max_contrast=args.contrast)
    g = gpd["grid"]
    print(f"grid: {g.kx}x{g.ky}x{g.kz} subdomains, s={g.s} "
          f"({g.num_elements} hexes)")

    if args.xl:
        return main_xl(gpd, args.order, dev, t0)

    d, _ = discretize(gpd, dtype=dtype, lean=args.lean, order=args.order, device=dev)
    sp = d.space
    print(f"discretize: {time.perf_counter()-t0:.1f} s  "
          f"(K={sp.K}, N={sp.N}, {sp.K*sp.N} dofs)")

    mu = {"switch": 1.0}
    t0 = time.perf_counter()
    if args.mf:
        opts = {"type": "mf_pcg", "precision": 1e-8, "max_iter": 4000,
                "coarse_space": "harvested", "coarse_modes": 12,
                "return_iters": True}
        mup = d.parse_parameter(mu)
        U, it = d._mf_solve(d.theta(mup), d.rhs(mup), opts)
        sync()
        t_solve = time.perf_counter() - t0
        t1 = time.perf_counter()
        U2, _ = d._mf_solve(d.theta(mup), d.rhs(mup), opts)
        sync()
        print(f"  (warm repeat solve: {(time.perf_counter()-t1)*1e3:.0f} ms)")
        A = d.op.assemble(d.theta(mup))
        b = d.rhs(mup)
    else:
        mup = d.parse_parameter(mu)
        A = d.op.assemble(d.theta(mup))
        b = d.rhs(mup)
        U, it = A.solve_pcg(b, tol=1e-8, maxiter=4000, two_level=True,
                            return_iters=True)
        sync()
        t_solve = time.perf_counter() - t0
    res = A.apply(U) - b
    r = float(res.abs().max() / b.abs().max())
    r2 = float(torch.linalg.norm(res.reshape(-1)) / torch.linalg.norm(b.reshape(-1)))
    print(f"FOM solve: {t_solve*1e3:.0f} ms, {int(it)} CG iterations, "
          f"rel residual {r:.1e} (2-norm {r2:.1e})")
    out.update(fom_its=int(it), relres=r, relres2=r2, t_solve=t_solve)

    if not args.skip_estimate:
        t0 = time.perf_counter()
        eta = float(d.estimate(U, mu, paper_convention=True))
        print(f"FOM estimate: eta = {eta:.4e}  "
              f"({time.perf_counter()-t0:.1f} s)")
        t0 = time.perf_counter()
        float(d.estimate(U, mu, paper_convention=True))
        print(f"  (warm repeat estimate: {time.perf_counter()-t0:.1f} s)")
        out["eta"] = eta

    if args.parabolic:
        from ..model import InstationaryBlockModel
        nt = args.parabolic
        im = InstationaryBlockModel(stationary=d, T=1.0, nt=nt)
        dt = im.T / nt
        mup = d.parse_parameter(mu)
        t0 = time.perf_counter()
        im.solve(mup)
        sync()
        t_cold = time.perf_counter() - t0
        mup2 = d.parse_parameter({"switch": 0.8})
        t0 = time.perf_counter()
        traj2 = im.solve(mup2)
        sync()
        t_pwarm = time.perf_counter() - t0
        print(f"3D trajectory [{nt} implicit-Euler steps]: first "
              f"{t_cold:.1f} s (with the preconditioner build), warm {t_pwarm:.2f} s "
              f"({t_pwarm / nt * 1e3:.0f} ms/step)")
        # self-check: the final step satisfies its implicit-Euler equation
        A2 = d.op.assemble(d.theta(mup2))
        M = im.mass
        u_prev, u_last = traj2[-2], traj2[-1]
        f2 = d.rhs(mup2)
        lhs = torch.einsum("knm,km->kn", M, u_last) + dt * A2.apply(u_last)
        rhs2 = torch.einsum("knm,km->kn", M, u_prev) + dt * f2
        rel = float(torch.linalg.norm((lhs - rhs2).reshape(-1))
                    / torch.linalg.norm(rhs2.reshape(-1)))
        print(f"3D final-step implicit-Euler residual: {rel:.2e}")
        assert rel < 1e-6, rel
        out.update(euler_residual=rel, t_traj_warm=t_pwarm)
        if args.parabolic_batch:
            B = args.parabolic_batch
            mus_b = [d.parse_parameter({"switch": m}) for m in np.linspace(0.3, 0.95, B)]
            t0 = time.perf_counter()
            im.solve_batch(mus_b)
            sync()
            t_bcold = time.perf_counter() - t0
            mus_b2 = [d.parse_parameter({"switch": m}) for m in np.linspace(0.35, 0.9, B)]
            t0 = time.perf_counter()
            Ub2 = im.solve_batch(mus_b2)
            sync()
            t_bwarm = time.perf_counter() - t0
            lane = B // 2
            ref = im.solve(mus_b2[lane])
            rel_b = float((Ub2[lane] - ref).abs().max() / ref.abs().max())
            print(f"3D batched trajectories [B={B}]: first {t_bcold:.1f} s, "
                  f"warm {t_bwarm:.2f} s = "
                  f"{t_bwarm / nt * 1e3 / B:.1f} ms/step/mu "
                  f"({t_pwarm / (t_bwarm / B):.1f}x the single-mu "
                  f"trajectory per query); lane vs single-mu: {rel_b:.2e}")
            assert rel_b < 1e-8, rel_b
            out["lane"] = rel_b
        if not args.lean:
            t0 = time.perf_counter()
            eta_p, _parts = im.estimate(traj2, mup2)
            print(f"3D parabolic estimate: {time.perf_counter()-t0:.1f} s, "
                  f"eta = {float(eta_p):.6e}")
            out["eta_parabolic"] = float(eta_p)

    if args.lean:
        return out

    if args.greedy:
        from ..greedy import weak_greedy
        from ..utils.timers import GLOBAL_TIMINGS as T
        T.enable()
        train = [{"switch": m} for m in np.linspace(0.1, 1.0, args.training)]
        t0 = time.perf_counter()
        with T.span("offline greedy"):
            res = weak_greedy(d, train, target_error=1e-3,
                              max_extensions=args.greedy)
        print(f"3D weak greedy: {len(res.max_etas)} iterations, "
              f"{res.fom_solves} FOM solves, surrogate "
              f"{res.max_etas[0]:.3e} -> {res.max_etas[-1]:.3e}, "
              f"RB size {int(res.rd.sizes.sum())}, "
              f"{time.perf_counter()-t0:.1f} s")
        mu_t = d.parse_parameter({"switch": 0.7})
        c = res.rd.solve(mu_t)
        eta_rom = float(res.rd.estimate(c, mu_t))
        eta_rec = float(d.estimate(res.reductor.reconstruct(c), mu_t))
        print(f"ROM vs FOM(reconstruction) estimate: {eta_rom:.4e} vs "
              f"{eta_rec:.4e} (rel diff {abs(eta_rom-eta_rec)/eta_rec:.1e})")
        out.update(max_etas=[float(v) for v in res.max_etas], fom_solves=int(res.fom_solves),
                   rb_size=int(res.rd.sizes.sum()), eta_rom=eta_rom, eta_rec=eta_rec,
                   rom_fom_gap=abs(eta_rom - eta_rec) / eta_rec)
        if args.online_mus:
            from ..online_enrichment import AdaptiveEnrichment
            rng = np.random.default_rng(3)
            rd_cur = res.rd
            online_out = []
            for i, m in enumerate(rng.uniform(0.1, 1.0, args.online_mus)):
                mu_i = {"switch": float(m)}
                eta_fom = None
                if args.online_target_rel:
                    mu_p = d.parse_parameter(mu_i)
                    eta_fom = float(d.estimate(d.solve(mu_p), mu_p))
                    target = args.online_target_rel * eta_fom
                    steps = 20
                    print(f"online mu #{i} (switch={m:.3f}): eta_FOM = "
                          f"{eta_fom:.4e}, target = {target:.4e}")
                else:
                    target, steps = 1e-3, 3
                online = AdaptiveEnrichment(gpd, d, d.space, res.reductor,
                                            rd_cur, target_error=target,
                                            marking_doerfler_theta=0.33,
                                            marking_max_age=4)
                rounds = []
                cb = lambda rd_, u_, mu_, st: rounds.append(  # noqa: E731
                    (st["eta"], st["global RB size"]))
                with T.span(f"online mu #{i}"):
                    u, rd_cur, _ = online.solve(mu_i, enrichment_steps=steps,
                                                callback=cb)
                print(f"online mu #{i} (switch={m:.3f}): "
                      f"eta {rounds[-1][0]:.3e} RB size "
                      f"{rd_cur.solution_dim} "
                      f"({len(rounds) - 1} enrichment rounds: "
                      + " -> ".join(f"{e:.3e}" for e, _ in rounds) + ")")
                online_out.append({"switch": float(m), "eta_fom": eta_fom,
                                   "eta": float(rounds[-1][0]),
                                   "rb_size": int(rd_cur.solution_dim),
                                   "rounds": len(rounds) - 1})
            out["online"] = online_out
        print(T.report())
        T.disable()
        return out

    red = LRBMSReductor(d, order=0)
    for m in (0.1, 0.4, 1.0):
        red.extend_basis(d.solve({"switch": m}))
    t0 = time.perf_counter()
    rd = red.reduce()
    print(f"reduce: {time.perf_counter()-t0:.1f} s "
          f"(RB size {int(rd.sizes.sum())})")

    mu_t = {"switch": 0.7}
    t0 = time.perf_counter()
    c = rd.solve(mu_t)
    eta_rom = float(rd.estimate(c, mu_t, paper_convention=True))
    t_rom = time.perf_counter() - t0
    Urec = red.reconstruct(c)
    eta_rec = float(d.estimate(Urec, mu_t, paper_convention=True))
    print(f"ROM online step: {t_rom*1e3:.1f} ms, eta_rom = {eta_rom:.4e} "
          f"(FOM-of-reconstruction {eta_rec:.4e}, "
          f"rel diff {abs(eta_rom-eta_rec)/eta_rec:.1e})")
    out.update(rb_size=int(rd.sizes.sum()), eta_rom=eta_rom, eta_rec=eta_rec,
               rom_fom_gap=abs(eta_rom - eta_rec) / eta_rec)
    return out


def main_xl(gpd, order, dev, t0, chunk: int = 32):
    """Stencil-only FOM at XL scale: one f64 stencil at mu (``truth``'s
    ``SolveOnlyModel``: no dense affine [K, N, N] family), the
    subdomain-block Jacobi from the stencil's own diagonal blocks
    (``stencil_diag_blocks`` in f32, Jacobi-scaled inverses of ``chunk``
    blocks at a time in f64 by ``la/block.block_jacobi_factors``, stored
    f32) and the subdomain-constant coarse level (``stencil_coarse_matrix``,
    inverted in f64); CG restarted from its iterate every 300 iterations,
    as the reference's bounded dispatches."""
    from ..la.block import block_jacobi_factors
    from ..ops.matrixfree3d import stencil_coarse_matrix, stencil_diag_blocks
    from ..truth import SolveOnlyModel
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    d = SolveOnlyModel(gpd, order=order, device=dev)
    sp = d.space
    print(f"XL: K={sp.K}, N={sp.N}, {sp.K * sp.N} dofs (stencil-only)")
    mu = {"switch": 1.0}
    A = d.stencil_at(mu, torch.float64)
    rhs = d.rhs(mu)
    sync()
    print(f"stencil assembly: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    D = stencil_diag_blocks(A)                      # [K, N, N] f32
    for lo in range(0, sp.K, chunk):
        D[lo:lo + chunk] = block_jacobi_factors(D[lo:lo + chunk].double()).float()
    factors = D
    ci = torch.linalg.inv(stencil_coarse_matrix(A).double())
    sync()
    print(f"preconditioner (f32 subdomain-block Jacobi + constant coarse): "
          f"{time.perf_counter() - t0:.1f} s")

    bn = float(torch.linalg.norm(rhs.reshape(-1)))
    t0 = time.perf_counter()
    U = torch.zeros_like(rhs)
    total_it, r, rnd = 0, float("inf"), 0
    for rnd in range(67):                           # <= ~20000 iterations
        U, it = A.solve_pcg(rhs, tol=1e-8, maxiter=300, block_factors=factors,
                            coarse_inv=ci, coarse_f32=True, return_iters=True, x0=U)
        total_it += int(it)
        r = float(torch.linalg.norm((rhs - A.apply(U)).reshape(-1))) / bn
        if r < 1e-8 or int(it) == 0:
            break
    sync()
    t_solve = time.perf_counter() - t0
    print(f"XL solve: {t_solve:.1f} s ({rnd + 1} restarts of at most 300 "
          f"iterations), {total_it} CG iterations, rel residual {r:.1e}, "
          f"{t_solve / max(total_it, 1) * 1e3:.1f} ms/iteration")
    return {"relres": r, "its": total_it, "t_solve": t_solve, "dofs": sp.K * sp.N}


if __name__ == "__main__":
    main()
