"""A/B of the stencil apply's block-product forms on one GPU.

    python3 -m pylrbms_tpu_torch.stencil_apply_probe

The 3x3 block products of :meth:`AssembledStencil.apply
<pylrbms_tpu_torch.ops.matrixfree.AssembledStencil.apply>` go through
:func:`~pylrbms_tpu_torch.ops.matrixfree.bmv`, a multiply and a sum over the
last axis.  This probe times that form against the einsum form
(``einsum('...ij,...j->...i')``, which torch lowers to a batched gemv), by
swapping ``matrixfree.bmv`` for the einsum in turns "mul, einsum, einsum,
mul", at the serving config (8x8 subdomains, half 2, nref 2, f32; B=256
queries mu = linspace(0.1, 1, 256)):

1. one apply (CUDA events, median of 20): lane-batched fields (theta
   [256, Q]), one lane, the lane-free component stencils applied and then
   mixed by theta per lane, and the theta-mix of the fields itself;
2. the reference's default online step (the stencil form; harvested
   coarse space with 12 modes, tol 1e-6): per-query ms (median of 5
   batched B=256 calls / 256) and single-query ms (median of 5);
3. ``StationaryBlockModel.solve`` at 98 304 dofs
   (8x8 subdomains, half 2, nref 3, f64, 'auto' at precision 1e-10, frozen
   preconditioner built first), the median of 3 solves.

Every line carries the card's name and power limit.  Exits non-zero
without CUDA.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from .discretize_elliptic_block_swipdg import discretize
from .model import make_online_step
from .ops import hopper_kernels, matrixfree
from .problems.os2015 import init_grid_and_problem
from .utils.precision import pin_precision

SERVING = {"num_subdomains": [8, 8],
           "half_num_fine_elements_per_subdomain_and_dim": 2,
           "num_refinements": 2}
SCALE = dict(SERVING, num_refinements=3)
B = 256
MUL = matrixfree.bmv


def einsum_bmv(A, v):
    """The einsum form of :func:`~pylrbms_tpu_torch.ops.matrixfree.bmv`."""
    return torch.einsum("...ij,...j->...i", A, v)


FORMS = {"mul": MUL, "einsum": einsum_bmv}
TURNS = ("mul", "einsum", "einsum", "mul")


def event_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def wall_median(fn, reps=5) -> float:
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def in_turns(name, measure, unit, smi):
    """Run ``measure()`` once per turn with that turn's block product."""
    got = {form: [] for form in FORMS}
    for form in TURNS:
        matrixfree.bmv = FORMS[form]
        try:
            got[form].append(measure())
        finally:
            matrixfree.bmv = MUL
    print(f"{name}: " + "; ".join(f"{form} {', '.join(f'{v:.4f}' for v in vals)} {unit}"
                                  for form, vals in got.items())
          + f" (turns {', '.join(TURNS)}) [{smi}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("stencil_apply_probe: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    pin_precision()
    hopper_kernels.load()
    run(torch.device("cuda", 0), smi)
    return 0


def run(dev, smi):
    """The probe's measurements on ``dev`` (see the module docstring)."""
    d, _ = discretize(init_grid_and_problem(SERVING), device=dev, dtype=torch.float32)
    mus = np.linspace(0.1, 1.0, B)
    thetas = torch.as_tensor(np.stack([np.ones(B), mus], 1), dtype=torch.float32, device=dev)
    theta_fs = torch.ones((B, 1), dtype=torch.float32, device=dev)
    mus_b = {"diffusion": thetas[:, 1:]}
    sop = d.mf_operator()
    x = torch.randn((B, d.space.K, d.space.N), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    A_lanes = sop.assemble(thetas)
    A_one = sop.assemble(thetas[0])
    Q = thetas.shape[1]
    A_comp = [sop.assemble(torch.eye(Q, device=dev)[q]) for q in range(Q)]

    def lane_free():
        return sum(thetas[:, q, None, None] * A_comp[q].apply(x) for q in range(Q))

    y = A_lanes.apply(x)
    matrixfree.bmv = einsum_bmv
    try:
        y_einsum = A_lanes.apply(x)
    finally:
        matrixfree.bmv = MUL
    err = max(float((y - y_einsum).abs().max()), float((y - lane_free()).abs().max()))
    print(f"apply forms agree: max |other form - mul| / max |mul| = "
          f"{err / float(y.abs().max()):.3e}", flush=True)
    in_turns(f"apply B={B} lane-batched fields", lambda: event_ms(lambda: A_lanes.apply(x)),
             "ms", smi)
    in_turns("apply one lane", lambda: event_ms(lambda: A_one.apply(x[0])), "ms", smi)
    in_turns(f"apply B={B} lane-free components mixed per lane", lambda: event_ms(lane_free),
             "ms", smi)
    print(f"theta-mix of the fields, B={B}: {event_ms(lambda: sop.assemble(thetas)):.4f} ms "
          f"[{smi}]", flush=True)

    step = make_online_step(d, tol=1e-6, maxiter=400, coarse_space="harvested",
                            coarse_modes=12)
    in_turns(f"stencil step per-query (B={B})",
             lambda: wall_median(lambda: step(thetas, theta_fs, mus_b)) / B * 1e3, "ms", smi)
    in_turns("stencil step single query",
             lambda: wall_median(lambda: step(thetas[0], theta_fs[0],
                                              {"diffusion": thetas[:1, 1]})) * 1e3, "ms", smi)
    del step, A_lanes, A_comp, sop, d
    torch.cuda.empty_cache()

    ds, _ = discretize(init_grid_and_problem(SCALE), device=dev, dtype=torch.float64, lean=True)
    opts = {"precision": 1e-10}
    ds.prepare_solver(0.5, inverse_options=opts)
    in_turns(f"solve {ds.space.K * ds.space.N} dofs f64 mf_pcg",
             lambda: wall_median(lambda: ds.solve(0.5, inverse_options=opts), reps=3), "s", smi)


if __name__ == "__main__":
    sys.exit(main())
