"""Rank launcher, the gloo/CUDA probe and the two-rank distributed smoke.

:func:`launch` runs a function on ``world`` ranks, one spawned process
each: every rank joins a process group through a ``file://`` store in a
fresh temporary directory (no port to clash over), with a timeout on the
rendezvous and on every collective, binds its device, runs the function
and reports its result, its kernel launches (``launch_signature_counts``
of ``ops/hopper_kernels``, which the parent never sees) and its peak device
memory through a queue.  If a rank raises, dies or the deadline passes, the
launcher kills every rank and raises :class:`RankError`.  The function must
be a module-level function of an importable module: the ranks import it
(and never the caller's ``__main__``); they run with one CPU thread.

:func:`probe_gloo_cuda` reports which gloo operations accept CUDA float64
tensors with two ranks on one card, point-to-point on CUDA tensors
included (in a launch of its own: it may abort the ranks).

The smoke (<-> ``scripts/distributed_smoke.py`` of the JAX package) runs
two ranks: an all_reduce and an all_gather of rank-dependent values, then
one K-sharded online step (OS2015, 2x4 subdomains, K = 8) against the
unsharded step to 1e-8.

    python -m pylrbms_tpu_torch.scripts.distributed_smoke --device cuda --backend gloo
    python -m pylrbms_tpu_torch.scripts.distributed_smoke --device cpu   # gloo
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback


class RankError(RuntimeError):
    """A rank raised, died or did not finish in time."""


def _rank_main(target, rank, world, init_method, device, backend, timeout_s, args, out):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from ..ops import hopper_kernels as hk
        from ..parallel.mesh import initialize_distributed
        dev = initialize_distributed(init_method, world, rank, backend=backend,
                                     device=device, timeout_s=timeout_s)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        hk.reset_launch_counts()
        result = target(*args)
        payload = {"rank": rank, "ok": True, "result": result,
                   "launches": hk.launch_signature_counts(),
                   "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}
    except BaseException:          # noqa: BLE001 — reported to the parent
        payload = {"rank": rank, "ok": False, "error": traceback.format_exc()}
    out.put(payload)
    try:
        if payload["ok"]:
            dist.destroy_process_group()
    except Exception:              # noqa: BLE001
        pass


def launch(target, world: int, args=(), device=None, backend: str = None,
           timeout_s: float = 900.0):
    """Run ``target(*args)`` on ``world`` ranks (spawned processes) on
    ``device`` (all ranks share it; None is the current card and raises
    without CUDA, ``"cpu"`` runs on the CPU) over ``backend`` (None: nccl
    for CUDA, gloo for the CPU).  Returns the ranks' payloads in rank
    order: dicts with ``result``, ``launches`` and ``peak_bytes``.  Raises
    :class:`RankError` (after killing every rank) when a rank fails or
    ``timeout_s`` passes."""
    from ..utils.precision import device as _device
    device = str(_device(device))
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pylrbms-ranks-")
    init_method = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world, init_method, device, backend, timeout_s,
                               tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, dead_since = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankError(f"ranks {sorted(set(range(world)) - set(results))} did not "
                                f"finish within {timeout_s:.0f} s")
            try:
                item = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in results and not p.is_alive()]
                if gone:
                    dead_since = dead_since or time.monotonic()
                    if time.monotonic() - dead_since > 10.0:
                        raise RankError(f"ranks {gone} exited without a result "
                                        f"(exit codes {[procs[r].exitcode for r in gone]})")
                continue
            if not item["ok"]:
                raise RankError(f"rank {item['rank']} failed:\n{item['error']}")
            results[item["rank"]] = item
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the gloo / CUDA probe
# ---------------------------------------------------------------------------

def _probe_target(cuda_p2p: bool):
    """Without ``cuda_p2p``: each gloo collective on f64 CUDA tensors and
    point-to-point through host buffers (the mesh's staging), 'ok',
    'wrong' or the error.  With it: point-to-point on the CUDA tensors
    alone (which may abort the process)."""
    import torch
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    val = torch.full((4,), float(rank + 1), dtype=torch.float64, device=dev)
    report = {}

    def check(name, fn):
        try:
            report[name] = "ok" if fn() else "wrong"
        except Exception as e:     # noqa: BLE001 — the answer of the probe
            report[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def all_reduce():
        t = val.clone()
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def broadcast():
        t = val.clone()
        dist.broadcast(t, 0)
        return bool((t == 1.0).all())

    def all_gather():
        parts = [torch.empty_like(val) for _ in range(world)]
        dist.all_gather(parts, val)
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def p2p(on_device):
        def run():
            src = val if on_device else val.cpu()
            got = torch.empty_like(src)
            ops = [dist.P2POp(dist.isend, src, (rank + 1) % world),
                   dist.P2POp(dist.irecv, got, (rank - 1) % world)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return bool((got.to(dev) == (rank - 1) % world + 1).all())
        return run

    if cuda_p2p:
        check(CUDA_P2P, p2p(True))
        return report
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather),
                     ("batch_isend_irecv (host buffers)", p2p(False))):
        check(name, fn)
    return report


CUDA_P2P = "batch_isend_irecv (CUDA tensors)"


def probe_gloo_cuda(world: int = 2, timeout_s: float = 120.0) -> dict:
    """Which gloo operations accept float64 CUDA tensors, ``world`` ranks
    on the current card: {op: 'ok' | 'wrong' | error}, rank 0's report
    (the ranks run the same operations).  Point-to-point on CUDA tensors
    runs in a launch of its own: ranks that abort there are reported as
    ``'rank failure: ...'``."""
    report = launch(_probe_target, world, args=(False,), device="cuda", backend="gloo",
                    timeout_s=timeout_s)[0]["result"]
    try:
        report[CUDA_P2P] = launch(_probe_target, world, args=(True,), device="cuda",
                                  backend="gloo", timeout_s=timeout_s)[0]["result"][CUDA_P2P]
    except RankError as e:
        report[CUDA_P2P] = f"rank failure: {str(e).splitlines()[0]}"
    return report


# ---------------------------------------------------------------------------
# the smoke
# ---------------------------------------------------------------------------

def _smoke_target():
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..discretize_elliptic_block_swipdg import discretize
    from ..parallel.mesh import SubdomainMesh
    from ..problems.os2015 import init_grid_and_problem

    mesh = SubdomainMesh.create()
    rank, world = mesh.rank, mesh.size
    local = torch.tensor([float(rank + 1)], dtype=torch.float64, device=mesh.device)
    total = float(mesh.sum(local))
    assert total == world * (world + 1) / 2, total
    gathered = mesh.gather(local, mesh.shard_k(0)).cpu().numpy()
    assert np.array_equal(gathered, np.arange(1, world + 1)), gathered

    gpd = init_grid_and_problem({"num_subdomains": [2, 4],
                                 "half_num_fine_elements_per_subdomain_and_dim": 1,
                                 "num_refinements": 1})
    d, _ = discretize(gpd, device=mesh.device)     # deterministic: the same on every rank
    theta = torch.tensor([1.0, 0.5], dtype=torch.float64)
    theta_f = torch.tensor([1.0], dtype=torch.float64)
    mu = d.parse_parameter(0.5)
    A = d.op.assemble(theta.to(mesh.device))
    b = torch.einsum("q,qkn->kn", theta_f.to(mesh.device), d.rhs_q)
    U_ref = A.solve_pcg(b, tol=1e-10, maxiter=500)
    nc, r, df = d.estimator.local_quantities(U_ref[None], mu)
    ind_ref = (nc + r + df)[0]

    step = mesh.online_step(d, tol=1e-10, maxiter=500)
    U, ind = step(theta, theta_f, mu)
    U = mesh.gather(U, mesh.shard_k(0))
    ind = mesh.gather(ind, mesh.shard_k(0))
    err_u = float((U - U_ref).abs().max() / U_ref.abs().max())
    err_i = float((ind - ind_ref).abs().max() / ind_ref.abs().max())
    assert err_u <= 1e-8 and err_i <= 1e-8, (err_u, err_i)
    # a rank runs the port alone: neither JAX nor the JAX package is loaded
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pylrbms_tpu"))
    if foreign:
        raise RuntimeError(f"a rank imported {foreign[:5]}")
    dist.barrier()
    return {"allreduce": total, "err_u": err_u, "err_ind": err_i, "K": d.space.K,
            "device": str(mesh.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the current card) or 'cpu'")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    out = launch(_smoke_target, args.world, device=args.device, backend=args.backend,
                 timeout_s=300)
    res = out[0]["result"]
    print(f"distributed smoke: OK ({args.world} ranks on {res['device']}, K={res['K']} "
          f"sharded; allreduce {res['allreduce']}, online step == unsharded: "
          f"U {res['err_u']:.2e}, indicators {res['err_ind']:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
