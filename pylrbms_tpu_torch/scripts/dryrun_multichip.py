"""K-sharded dry run of the distributed paths, on ``--world`` ranks.

The port of ``__graft_entry__.dryrun_multichip``: the subdomain axis is
split over the ranks (:class:`~pylrbms_tpu_torch.parallel.mesh.SubdomainMesh`,
one process per rank from ``scripts/distributed_smoke.launch``) and every
leg is held against the same computation unsharded, on rank 0, with the
reference's tolerances:

* the K-sharded online step: U, indicators and eta to rel 1e-8;
* the row-sharded SPMD solver (``parallel/spmd``): U to 1e-8;
* ``reduce(mesh=)``: every reduced array to rtol 1e-12 / atol 1e-14 of the
  unsharded ``reduce()``, the ROM solve to 1e-10;
* the K-banded corrector (``BatchedCorrector.solve(mesh=)``): 1e-8 of the
  largest correction; basis extension and re-reduction;
* ``ReducedModel.solve_sharded``: 1e-8 of ``solve``;
* ``batched_estimates(mesh=)``: 1e-12 of the unsharded sweep over the
  same lane groups, 1e-8 of one unsharded call over all lanes (a batched
  LU's rounding depends on the batch size on the card, and the estimator's
  cancellations amplify it: 5.5e-9 at world 4 on the serving grid, H100);
* the K-sharded matrix-free solve (``mesh.mf_solve``; 2D two-level, 3D
  single-level or two-level): 1e-8 of max |U|;
* the K-sharded implicit-Euler trajectory in f64 and ``precision='mixed'``
  and the K-sharded batched sweep of two mus: 1e-8 of max |U|; mixed
  against f64 to 1e-5 (a cross-precision bound, as in the reference).

Presets: ``small`` (the reference's sizes: OS2015 2 x world subdomains,
half 1, nref 0; academic3d 1 x 1 x world; the parabolic OS2015 2 x world
at T = 0.5, nt = 4), ``serving`` (OS2015 8x8, half 2, nref 2: K = 64,
N = 384, 24 576 dofs; the 2D legs, 64 training mus) and ``scale`` (the
matrix-free solve at 98 304 dofs (K = 64, N = 1536), SPE10 3D at 131 072
dofs (8x8x4: K = 256, N = 512) and the SPE10 trajectory at 98 304 dofs,
nt = 10).  Every leg reports its seconds, the PCG iterations sharded and
unsharded, per rank ms per iteration, ms of halo exchange per iteration
and the peak device memory.

    python -m pylrbms_tpu_torch.scripts.dryrun_multichip --world 2 --device cuda --backend gloo
    python -m pylrbms_tpu_torch.scripts.dryrun_multichip --world 2 --device cpu

The module also holds the single cases (``CASES``, run on every rank by
:func:`case_target`) that the parity tests hold against the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

TOL_U = 1e-8            # U, indicators, eta; SPMD; corrector; solve_sharded; mf; trajectories
TOL_RED = (1e-12, 1e-14)  # reduce(mesh=) arrays (rtol, atol)
TOL_ROM = 1e-10         # ROM solve / estimate from the sharded reduction
TOL_SWEEP = 1e-12       # batched_estimates(mesh=)
TOL_MIXED = 1e-5        # mixed against f64 trajectory (cross-precision)
REDUCED = ("A_red", "b_red", "G_nc", "AA", "ABT", "BBT", "DV", "RD", "G_bb", "G_Ab", "G_AA")


def _host(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return float(np.abs(a - b).max() / scale)


def build(spec, device):
    """(model, data) of ``spec``: {'problem': 'os2015' | 'academic3d' |
    'spe10' | 'spe10_3d', 'cfg': grid config, 'lean': bool, 'parabolic':
    {'T', 'nt'} or None}, float64 on ``device``."""
    import torch
    p, cfg = spec["problem"], dict(spec["cfg"])
    dim3 = p in ("academic3d", "spe10_3d")
    if p == "os2015":
        from ..problems.os2015 import init_grid_and_problem
        gpd = init_grid_and_problem(cfg)
    elif p == "academic3d":
        from ..problems.academic3d import init_grid_and_problem
        gpd = init_grid_and_problem(cfg)
    elif p == "spe10":
        from ..problems.spe10 import init_grid_and_problem
        gpd = init_grid_and_problem(cfg, raster=(8, 8), raster_mode="nearest", max_contrast=1e4)
    elif p == "spe10_3d":
        from ..problems.spe10 import init_grid_and_problem_3d
        gpd = init_grid_and_problem_3d(cfg, layers=(40, 44), max_contrast=1e4)
    else:
        raise ValueError(f"unknown problem {p!r}")
    kw = dict(device=device, dtype=torch.float64, lean=bool(spec.get("lean", False)))
    par = spec.get("parabolic")
    if par:
        if dim3:
            from ..discretize_parabolic_block_swipdg3d import discretize
        else:
            from ..discretize_parabolic_block_swipdg import discretize
        return discretize(gpd, T=par["T"], nt=par["nt"], **kw)
    if dim3:
        from ..discretize_elliptic_block_swipdg3d import discretize
    else:
        from ..discretize_elliptic_block_swipdg import discretize
    return discretize(gpd, **kw)


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block are not added to the wrappers'
    counts (the unsharded references and the replicated set-up of the
    legs)."""
    from ..ops import hopper_kernels as hk
    saved = {fn: (fn.launches, dict(fn.signatures)) for fn in hk.KERNELS.values()}
    try:
        yield
    finally:
        for fn, (n, sig) in saved.items():
            fn.launches, fn.signatures = n, sig


def _sync(mesh):
    import torch
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def measured(mesh, fn):
    """(fn(), report): seconds, collective counts and seconds, peak device
    memory of this rank over the call.  The ranks start the clock together
    (a barrier first: rank 0's references of the previous leg are not
    counted as the others' waiting)."""
    import torch
    _sync(mesh)
    mesh.barrier()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.reset_stats()
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    rep = {"seconds": time.perf_counter() - t0, **mesh.stats,
           "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                          if mesh.device.type == "cuda" else None)}
    return out, rep


def _per_iter(rep, iters):
    it = max(int(iters), 1)
    return {"ms_per_iter": 1e3 * rep["seconds"] / it,
            "exchange_ms_per_iter": 1e3 * rep["exchange_s"] / it,
            "allreduce_ms_per_iter": 1e3 * rep["allreduce_s"] / it}


# ---------------------------------------------------------------------------
# cases: one sharded computation each, run on every rank
# ---------------------------------------------------------------------------

def case_online_step(mesh, d, data, mu=0.5, tol=1e-10, maxiter=1000, positive_form=False):
    """The sharded online step; eta from the band's local quantities and
    all-reduced norms (never from the gathered U)."""
    from ..estimators import aggregate_eta
    from ..parallel.mesh import psum_norm
    mu = d.parse_parameter(mu)
    step = mesh.online_step(d, tol=tol, maxiter=maxiter, positive_form=positive_form)
    (U, ind), rep = measured(mesh, lambda: step(d.theta(mu), d.theta_f(mu), mu))
    eta = aggregate_eta(d.estimator, mu, *step.last_quantities,
                        norm=lambda v: psum_norm(v * v, mesh))
    U, ind = mesh.gather(U, mesh.shard_k(0)), mesh.gather(ind, mesh.shard_k(0))
    return {"U": _host(U), "ind": _host(ind), "eta": float(eta),
            "iters": step.last_iters, "report": rep}


def case_spmd(mesh, d, data, theta=(1.0, 0.5), tol=1e-10, maxiter=1000):
    import torch
    from ..parallel.spmd import SpmdOnlineSolver
    run = SpmdOnlineSolver(d, mesh).make_step(tol=tol, maxiter=maxiter)
    th = torch.tensor(theta, dtype=torch.float64)
    U, rep = measured(mesh, lambda: run(th, torch.ones(d.rhs_q.shape[0], dtype=torch.float64)))
    return {"U": _host(mesh.gather(U, mesh.shard_k(0))), "iters": run.last_iters, "report": rep}


def _reductor(d, data, bases=None, snapshots=None, products="local_energy_dg_product",
              cls=None, **kw):
    from ..reductor import LRBMSReductor
    cls = cls or LRBMSReductor
    P = data[products] if products else None
    if bases is not None:
        return cls(d, bases=[np.asarray(b) for b in bases], products=P, **kw)
    red = cls(d, products=P, order=0, **kw)
    if snapshots is not None:
        red.extend_basis(np.asarray(snapshots))
    return red


def _reduced_arrays(rd):
    return {n: _host(getattr(rd, n)) for n in REDUCED if getattr(rd, n) is not None}


def case_reduce(mesh, d, data, bases=None, snapshots=None, mu=0.55,
                products="local_energy_dg_product"):
    red = _reductor(d, data, bases, snapshots, products)
    rd, rep = measured(mesh, lambda: red.reduce(mesh=mesh))
    mu = rd.parse_parameter(mu)
    c = rd.solve(mu)
    return {"arrays": _reduced_arrays(rd), "c": _host(c), "eta": float(rd.estimate(c, mu)),
            "report": rep}


def case_parabolic_reduce(mesh, im, data, bases):
    """``ParabolicLRBMSReductor.reduce(mesh=)``: the elliptic arrays, the
    projected parabolic tensors and the reduced mass."""
    from ..reductor import ParabolicLRBMSReductor
    red = ParabolicLRBMSReductor(im.stationary, bases=[np.asarray(b) for b in bases],
                                 order=None)
    rd, rep = measured(mesh, lambda: red.reduce(mesh=mesh))
    return {"arrays": {**_reduced_arrays(rd), "M_red": _host(rd.M_red)},
            "parabolic": {n: _host(v) for n, v in rd.parabolic.items()}, "report": rep}


def case_enrichment(mesh, d, data, mu=0.4, steps=2, sharded=True):
    """``AdaptiveEnrichment`` from the order-0 basis with a reductor on
    ``mesh`` (its corrector and re-reductions inherit it): eta and the
    local basis sizes per step."""
    from ..online_enrichment import AdaptiveEnrichment
    from ..reductor import LRBMSReductor
    red = LRBMSReductor(d, order=0, mesh=mesh if sharded else None)
    log = []
    AdaptiveEnrichment(None, d, d.space, red, red.reduce(), target_error=1e-12).solve(
        mu, enrichment_steps=steps,
        callback=lambda rd, u, mu_, m: log.append((m["eta"], m["local RB sizes"])))
    return {"etas": [e for e, _ in log], "sizes": [z for _, z in log]}


def case_parallel_reductor(mesh, d, data, snapshots, products="local_energy_dg_product"):
    from ..reductor import ParallelLRBMSReductor
    red = _reductor(d, data, snapshots=snapshots, products=products, cls=ParallelLRBMSReductor)
    rd = red.reduce()
    return {"mesh_size": None if red.mesh is None else red.mesh.size,
            "arrays": _reduced_arrays(rd)}


def case_corrector(mesh, d, data, marked, mu, current, tol=1e-10, maxiter=300,
                   stencil=False):
    import torch
    from ..ops.corrector import BatchedCorrector
    corr = BatchedCorrector(d)
    if stencil:
        corr.enable_stencil()
    cur = torch.as_tensor(np.asarray(current), device=mesh.device)
    W, rep = measured(mesh, lambda: corr.solve(marked, mu, current_solution=cur, tol=tol,
                                               maxiter=maxiter, mesh=mesh))
    return {"W": _host(W), "iters": corr.last_iters, "report": rep}


def case_solve_sharded(mesh, d, data, bases, mus, products=None):
    rd = _reductor(d, data, bases=bases, products=products).reduce()
    cs, etas, its, reps = [], [], [], []
    for m in mus:
        mu = rd.parse_parameter([m])
        c, rep = measured(mesh, lambda mu=mu: rd.solve_sharded(mu, mesh))
        cs.append(_host(c))
        etas.append(float(rd.estimate(c, mu)))
        its.append(rd.last_sharded_iters)
        reps.append(rep)
    return {"c": cs, "eta": etas, "iters": its, "report": reps[0]}


def case_batched_estimates(mesh, d, data, bases, mus, criterion="estimator", products=None):
    from ..greedy import _stack_mus, batched_estimates
    rd = _reductor(d, data, bases=bases, products=products).reduce()
    stacked = _stack_mus([rd.parse_parameter([m]) for m in mus])
    etas, rep = measured(mesh, lambda: batched_estimates(rd, stacked, criterion, mesh=mesh))
    return {"etas": _host(etas), "report": rep}


def case_weak_greedy(mesh, d, data, training, extensions=3, criterion="residual",
                     target_error=1e-8):
    from ..greedy import weak_greedy
    res = weak_greedy(d, [d.parse_parameter([m]) for m in training], target_error=target_error,
                      max_extensions=extensions, criterion=criterion, mesh=mesh)
    return {"max_etas": res.max_etas, "sizes": res.reductor.basis_sizes().tolist(),
            "arrays": _reduced_arrays(res.rd)}


def _mf_inputs(mesh, d, mu, two_level, coarse_space, coarse_modes):
    """(mu, theta, block factors, coarse basis, coarse inverse) at ``mu``:
    the model's frozen preconditioner, or with ``coarse_space='constants'``
    the subdomain-constant coarse level (no basis)."""
    import torch
    from ..model import _frozen_preconditioner
    mu = d.parse_parameter(mu)
    theta = d.theta(mu)
    if coarse_space == "constants":
        A = d.op.assemble(theta)
        return (mu, theta, A.block_jacobi_factors(), None,
                torch.linalg.inv(A.coarse_matrix()) if two_level else None)
    bf, C, ci = _frozen_preconditioner(d, theta, two_level, coarse_space, coarse_modes)
    return mu, theta, bf, C, ci


def case_mf_solve(mesh, d, data, mu=0.45, tol=1e-12, maxiter=2000, two_level=True,
                  coarse_space="modal", coarse_modes=3, coarse_f32=False):
    """The K-sharded matrix-free solve; its preconditioner (replicated
    set-up, the same on every rank) is built outside the counts."""
    with uncounted():
        mu, theta, bf, C, ci = _mf_inputs(mesh, d, mu, two_level, coarse_space, coarse_modes)
    k0 = mesh.shard_k(0)
    bsop = mesh.shard_stencil(d.mf_operator())
    b = mesh.put(d.rhs(mu), k0)
    (U, it), rep = measured(mesh, lambda: mesh.mf_solve(
        bsop, theta, b, block_factors=mesh.put(bf, k0),
        coarse_basis=None if C is None else mesh.put(C, k0), coarse_inv=ci, tol=tol,
        maxiter=maxiter, coarse_f32=coarse_f32))
    return {"U": _host(mesh.gather(U, k0)), "iters": int(it), "report": rep}


def case_stencil_apply(mesh, d, data, theta, seed=3):
    import torch
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(d.space.K, d.space.N)), device=mesh.device)
    th = torch.tensor(theta, dtype=torch.float64, device=mesh.device)
    A = mesh.shard_stencil(d.mf_operator()).assemble(th)
    y = A.apply(mesh.put(x, mesh.shard_k(0)))
    return {"y": _host(mesh.gather(y, mesh.shard_k(0)))}


def case_positive_estimate(mesh, d, data, mu, U):
    import torch
    mu = d.parse_parameter(mu)
    k0, k1 = mesh.band(d.space.K)
    band = mesh.distribute_model(d)["estimator"]
    Ut = torch.as_tensor(np.asarray(U), device=mesh.device)[None]
    out = d.estimator.local_quantities_positive(Ut, mu, tensors=band, band=(k0, k1))
    return {"quantities": [_host(mesh.gather(v[0], mesh.shard_k(0))) for v in out]}


def case_trajectory(mesh, im, data, mu, mus=None, tol=1e-12, maxiter=3000, two_level=False,
                    coarse_modes=12, precisions=("f64", "mixed")):
    dt = im.T / im.nt
    out = {}
    for prec in precisions:
        (traj, its), rep = measured(mesh, lambda prec=prec: im._solve_mf(
            im.parse_parameter(mu), dt, tol=tol, maxiter=maxiter, two_level=two_level,
            coarse_modes=coarse_modes, precision=prec, extrapolate=False, return_iters=True,
            mesh=mesh))
        out[prec] = {"traj": _host(mesh.gather(traj, mesh.shard_k(1))),
                     "iters": int(its.sum()), "report": rep}
    if mus:
        traj, rep = measured(mesh, lambda: im.solve_batch(
            mus, tol=tol, maxiter=maxiter, two_level=two_level, coarse_modes=coarse_modes,
            extrapolate=False, mesh=mesh))
        out["batch"] = {"traj": _host(mesh.gather(traj, mesh.shard_k(2))),
                        "iters": int(im.last_solve_iters.max(dim=0).values.sum()),
                        "report": rep}
    return out


CASES = {"online_step": case_online_step, "spmd": case_spmd, "reduce": case_reduce,
         "parabolic_reduce": case_parabolic_reduce, "enrichment": case_enrichment,
         "parallel_reductor": case_parallel_reductor, "corrector": case_corrector,
         "solve_sharded": case_solve_sharded, "batched_estimates": case_batched_estimates,
         "weak_greedy": case_weak_greedy, "mf_solve": case_mf_solve,
         "stencil_apply": case_stencil_apply, "positive_estimate": case_positive_estimate,
         "trajectory": case_trajectory}


def case_target(name, spec, kwargs):
    """Rank entry of one case: the mesh over all ranks, the model of
    ``spec`` on the rank's device, ``CASES[name](mesh, model, data,
    **kwargs)``."""
    from ..parallel.mesh import SubdomainMesh
    mesh = SubdomainMesh.create()
    model, data = build(spec, mesh.device)
    return CASES[name](mesh, model, data, **kwargs)


# ---------------------------------------------------------------------------
# the dry run: legs with their unsharded references on rank 0
# ---------------------------------------------------------------------------

def _check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")
    return err


def _leg(mesh, name, out, iters_ref=None, errors=None):
    rep = out.get("report", {})
    return {"leg": name, "rank": mesh.rank, "iters": out.get("iters"),
            "iters_unsharded": iters_ref, "errors": errors or {}, **rep,
            **(_per_iter(rep, out["iters"]) if isinstance(out.get("iters"), int) else {})}


def legs_2d(mesh, d, data, n_mus: int, timed: bool):
    """Online step, SPMD, reduce, corrector (+ extension and re-reduction),
    solve_sharded and the sharded sweep on the 2D model ``d``; references
    on rank 0.  Returns the per-leg reports of this rank."""
    import torch
    from ..greedy import _pad_lanes, _stack_mus, batched_estimates
    from ..ops.corrector import BatchedCorrector
    from ..reductor import ExtensionError
    mesh.timed = timed
    ref = mesh.rank == 0
    reps = []
    mu = d.parse_parameter(0.5)
    theta, theta_f = d.theta(mu), d.theta_f(mu)

    out = case_online_step(mesh, d, data, mu=0.5, tol=1e-10, maxiter=1000)
    err, it_ref = {}, None
    if ref:
        with uncounted():
            A = d.op.assemble(theta)
            b = torch.einsum("q,qkn->kn", theta_f, d.rhs_q)
            U_ref, it_ref = A.solve_pcg(b, tol=1e-10, maxiter=1000, return_iters=True)
            nc, r, df = d.estimator.local_quantities(U_ref[None], mu)
            ind_ref = _host((nc + r + df)[0])
            eta_ref = float(d.estimate(U_ref, mu))
            U_ref = _host(U_ref)
        err = {"U": _check("online step U", _rel(out["U"], U_ref), TOL_U),
               "ind": _check("online step indicators", _rel(out["ind"], ind_ref), TOL_U),
               "eta": _check("online step eta", abs(out["eta"] - eta_ref) / abs(eta_ref), TOL_U)}
        it_ref = int(it_ref)
    reps.append(_leg(mesh, "online step", out, it_ref, err))
    U_sh = out["U"]

    out = case_spmd(mesh, d, data, theta=tuple(_host(theta)), tol=1e-10, maxiter=1000)
    err = {"U": _check("SPMD U", _rel(out["U"], U_ref), TOL_U)} if ref else {}
    reps.append(_leg(mesh, "SPMD solver", out, it_ref, err))

    # replicated set-up, outside the counts: unsharded snapshot solves,
    # rank 0's values on every rank (the bases are host state)
    with uncounted():
        snaps = torch.stack([d.solve(d.parse_parameter(v)) for v in (0.3, 1.0)])
        snaps = _host(mesh.broadcast(snaps))
        red = _reductor(d, data, snapshots=snaps, products="local_energy_dg_product")
    rd, rep = measured(mesh, lambda: red.reduce(mesh=mesh))
    mu_r = rd.parse_parameter(0.55)
    with uncounted():
        c = rd.solve(mu_r)
    err = {}
    if ref:
        with uncounted():
            rd_ref = red.reduce(mesh=None)
            c_ref = rd_ref.solve(mu_r)
            for n in REDUCED:
                a, b_ = getattr(rd, n), getattr(rd_ref, n)
                if b_ is not None:
                    a, b_ = _host(a), _host(b_)
                    ok = np.allclose(a, b_, rtol=TOL_RED[0], atol=TOL_RED[1])
                    err[n] = float(np.abs(a - b_).max())
                    if not ok:
                        raise AssertionError(f"reduce(mesh=) {n}: max diff {err[n]:.3e}")
            err["c"] = _check("ROM solve", _rel(_host(c), _host(c_ref)), TOL_ROM)
    reps.append(_leg(mesh, "reduce(mesh=)", {"report": rep}, None, err))

    # the corrector against the ROM's reconstruction, then extension + re-reduction
    K = d.space.K
    marked = [0, K // 2 + 1, K - 1]
    with uncounted():
        cur = rd.reconstruct(c)
        corr = BatchedCorrector(d)
    W, rep = measured(mesh, lambda: corr.solve(marked, mu_r, current_solution=cur, mesh=mesh))
    err, it_ref = {}, None
    if ref:
        with uncounted():
            corr_ref = BatchedCorrector(d)
            W_ref = corr_ref.solve(marked, mu_r, current_solution=cur)
            it_ref = corr_ref.last_iters
        err = {"W": _check("corrector W", _rel(_host(W), _host(W_ref)), TOL_U)}
    reps.append(_leg(mesh, "corrector(mesh=)", {"report": rep, "iters": corr.last_iters},
                     it_ref, err))
    with uncounted():
        for i, ii in enumerate(marked):
            try:
                red.extend_basis_local(ii, _host(W[i]))
            except ExtensionError:
                pass
    rd2 = red.reduce(mesh=mesh)

    mus = np.linspace(0.1, 1.0, 3)
    err, it = {}, None
    for m in mus:
        mu_m = rd2.parse_parameter([float(m)])
        c_sh, rep = measured(mesh, lambda mu_m=mu_m: rd2.solve_sharded(mu_m, mesh))
        it = rd2.last_sharded_iters
        if ref:
            with uncounted():
                c_ref = rd2.solve(mu_m)
            err[f"c({m:.2f})"] = _check("solve_sharded", _rel(_host(c_sh), _host(c_ref)), TOL_U)
    reps.append(_leg(mesh, "solve_sharded", {"report": rep, "iters": it}, None, err))

    train = [rd2.parse_parameter([float(m)]) for m in np.linspace(0.1, 1.0, n_mus)]
    stacked = _stack_mus(train)
    etas, rep = measured(mesh, lambda: batched_estimates(rd2, stacked, "estimator", mesh=mesh))
    err = {}
    if ref:
        # the unsharded sweep over the same lane groups isolates the
        # sharding (TOL_SWEEP); one call over all lanes differs by the
        # library's batch-size-dependent rounding, which the estimator's
        # cancellations amplify (TOL_U)
        with uncounted():
            padded, B = _pad_lanes(stacked, mesh.size)
            n = next(iter(padded.values())).shape[0] // mesh.size
            etas_grp = torch.cat([batched_estimates(rd2, {k: v[i * n:(i + 1) * n]
                                                          for k, v in padded.items()},
                                                    "estimator")
                                  for i in range(mesh.size)])[:B]
            etas_one = batched_estimates(rd2, stacked, "estimator")
        err = {"etas": _check("batched_estimates", _rel(_host(etas), _host(etas_grp)),
                              TOL_SWEEP),
               "etas (one call)": _check("batched_estimates, one unsharded call",
                                         _rel(_host(etas), _host(etas_one)), TOL_U)}
    reps.append(_leg(mesh, f"batched_estimates(mesh=) x{n_mus}", {"report": rep}, None, err))
    del U_sh
    return reps


def legs_mf(mesh, d, label, mu, tol, two_level, coarse_space, coarse_modes, coarse_f32, timed):
    """The K-sharded matrix-free solve against the unsharded one (rank 0)."""
    mesh.timed = timed
    out = case_mf_solve(mesh, d, None, mu=mu, tol=tol, maxiter=3000, two_level=two_level,
                        coarse_space=coarse_space, coarse_modes=coarse_modes,
                        coarse_f32=coarse_f32)
    err, it_ref = {}, None
    if mesh.rank == 0:
        with uncounted():
            mu_, theta, bf, C, ci = _mf_inputs(mesh, d, mu, two_level, coarse_space, coarse_modes)
            U_ref, it_ref = d.mf_operator().assemble(theta).solve_pcg(
                d.rhs(mu_), tol=tol, maxiter=3000, block_factors=bf, coarse_basis=C,
                coarse_inv=ci, coarse_f32=coarse_f32, return_iters=True)
        err = {"U": _check(f"{label} U", _rel(out["U"], _host(U_ref)), TOL_U)}
        it_ref = int(it_ref)
    return [_leg(mesh, label, out, it_ref, err)]


def legs_trajectory(mesh, im, label, mu, mus, tol, two_level, coarse_modes, timed):
    """The K-sharded trajectory (f64, mixed) and the batched sweep against
    the unsharded ones (rank 0)."""
    mesh.timed = timed
    out = case_trajectory(mesh, im, None, mu, mus=mus, tol=tol, maxiter=3000,
                          two_level=two_level, coarse_modes=coarse_modes)
    reps = []
    dt = im.T / im.nt
    refs = {}
    if mesh.rank == 0:
        with uncounted():
            for prec in ("f64", "mixed"):
                traj, its = im._solve_mf(im.parse_parameter(mu), dt, tol=tol, maxiter=3000,
                                         two_level=two_level, coarse_modes=coarse_modes,
                                         precision=prec, extrapolate=False, return_iters=True)
                refs[prec] = (_host(traj), int(its.sum()))
            refs["batch"] = (_host(im.solve_batch(mus, tol=tol, maxiter=3000,
                                                  two_level=two_level,
                                                  coarse_modes=coarse_modes,
                                                  extrapolate=False)),
                             int(im.last_solve_iters.max(dim=0).values.sum()))
        _check(f"{label} mixed vs f64", _rel(refs["mixed"][0], refs["f64"][0]), TOL_MIXED)
    for key, name in (("f64", "trajectory f64"), ("mixed", "trajectory mixed"),
                      ("batch", f"batched sweep B={len(mus)}")):
        err, it_ref = {}, None
        if mesh.rank == 0:
            err = {"traj": _check(f"{label} {name}", _rel(out[key]["traj"], refs[key][0]),
                                  TOL_U)}
            it_ref = refs[key][1]
        reps.append(_leg(mesh, f"{label} {name}", out[key], it_ref, err))
    return reps


PRESETS = ("small", "serving", "scale")


def dryrun_target(preset: str, world: int):
    """Rank entry of the dry run: the legs of ``preset``; returns this
    rank's leg reports."""
    from ..parallel.mesh import SubdomainMesh
    mesh = SubdomainMesh.create()
    timed = mesh.device.type == "cuda"
    reps = []
    if preset == "small":
        d, data = build({"problem": "os2015", "cfg": _cfg([2, world], 1, 0)}, mesh.device)
        reps += legs_2d(mesh, d, data, n_mus=8, timed=timed)
        d3, _ = build({"problem": "academic3d", "cfg": _cfg([1, 1, world], 1, 1)}, mesh.device)
        reps += legs_mf(mesh, d3, "3D matrix-free single-level", 0.5, 1e-10, False, "modal", 3,
                        False, timed)
        im, _ = build({"problem": "os2015", "cfg": _cfg([2, world], 1, 1),
                       "parabolic": {"T": 0.5, "nt": 4}}, mesh.device)
        reps += legs_trajectory(mesh, im, "parabolic", 0.6, [0.4, 0.7], 1e-12, False, 12, timed)
    elif preset == "serving":
        d, data = build({"problem": "os2015", "cfg": _cfg([8, 8], 2, 2)}, mesh.device)
        reps += legs_2d(mesh, d, data, n_mus=64, timed=timed)
    elif preset == "scale":
        d, _ = build({"problem": "os2015", "cfg": _cfg([8, 8], 2, 3), "lean": True}, mesh.device)
        reps += legs_mf(mesh, d, "2D matrix-free two-level (98 304 dofs)", 0.5, 1e-10, True,
                        "harvested", 16, True, timed)
        del d
        d3, _ = build({"problem": "spe10_3d", "cfg": _cfg([8, 8, 4], 1, 2), "lean": True},
                      mesh.device)
        reps += legs_mf(mesh, d3, "SPE10 3D matrix-free two-level (131 072 dofs)", 1.0, 1e-10,
                        True, "harvested", 12, True, timed)
        del d3
        im, _ = build({"problem": "spe10", "cfg": _cfg([16, 16], 2, 2),
                       "parabolic": {"T": 1.0, "nt": 10}}, mesh.device)
        reps += legs_trajectory(mesh, im, "SPE10 trajectory (98 304 dofs, nt=10)", [1.0],
                                [[1.0], [0.5]], 1e-10, True, 12, timed)
    else:
        raise ValueError(f"unknown preset {preset!r}; one of {PRESETS}")
    mesh.barrier()
    return reps


def _cfg(subs, half, nref):
    return {"num_subdomains": list(subs),
            "half_num_fine_elements_per_subdomain_and_dim": half, "num_refinements": nref}


def run(world: int, device=None, backend: str = None, preset: str = "small",
        timeout_s: float = 900.0):
    """Launch the dry run on ``device`` (None: the current card; raises
    without CUDA); returns the launcher's payloads (each with the rank's
    leg reports in ``result``).  Raises on any failed leg or rank."""
    from .distributed_smoke import launch
    return launch(dryrun_target, world, args=(preset, world), device=device, backend=backend,
                  timeout_s=timeout_s)


def format_legs(payloads):
    """One line per leg: rank 0's numbers with every rank's ms/iteration,
    exchange ms/iteration and peak memory."""
    lines = []
    for i, leg in enumerate(payloads[0]["result"]):
        ranks = [p["result"][i] for p in payloads]

        def col(key, scale=1.0, fmt="{:.3f}"):
            return "/".join("-" if r.get(key) is None else fmt.format(r[key] * scale)
                            for r in ranks)
        errs = ", ".join(f"{k} {v:.1e}" for k, v in leg["errors"].items())
        lines.append(
            f"{leg['leg']}: {leg['seconds']:.3f} s, iterations {leg['iters']} sharded / "
            f"{leg['iters_unsharded']} unsharded; per rank ms/iter {col('ms_per_iter')}, "
            f"exchange ms/iter {col('exchange_ms_per_iter')}, all-reduce ms/iter "
            f"{col('allreduce_ms_per_iter')} (rank 0: {leg['exchanges']} exchanges of "
            f"{leg['exchange_bytes'] / max(leg['exchanges'], 1) / 1e3:.1f} KB received, "
            f"{leg['allreduces']} all-reduces, {leg['gathers']} all-gathers), peak MB "
            f"{col('peak_bytes', 2.0 ** -20, '{:.0f}')}; errors: {errs or '-'}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the current card) or 'cpu'")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--json", default=None, help="write the leg reports to this file")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    payloads = run(args.world, args.device, args.backend, args.preset)
    for line in format_legs(payloads):
        print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump([p["result"] for p in payloads], f, indent=1, default=str)
    print(f"dryrun_multichip({args.world}, {args.device or 'cuda'}, {args.backend or 'default'}, "
          f"{args.preset}): OK in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
