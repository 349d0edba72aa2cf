"""Readings that set a cell's correctness limits (not part of a run).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--faults <name> ... --fault-seeds 1 2] [--control-seeds 1 2 3] [--seconds 6]

In one process, at the cell's own size and load: the program's readings
are the ``checks`` of ``harness.run`` for each seed (a window of
``--seconds``); each fault of ``benchmark.faults`` is planted and read the
same way for each fault seed; then the control, the reference computed in
TF32 in the program's place (``reference/solve.py``), answers the same
sample of the same traffic for each control seed.  Prints one JSON line per
reading and a summary: the largest program reading (the lower reading),
the smallest control reading (the upper one) and each fault's smallest.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import torch

from . import check, faults, harness, spec
from .reference.solve import Tf32Control
from .traffic import ClosedLoop, Sample

PLANTS = {**faults.FAULTS, **faults.TOLERANCES}


def _reading(cell, seed, seconds, overrides=None) -> dict:
    result, _ = harness.run(cell, seed, seconds, False, "cuda:0", time.perf_counter(), overrides)
    return {"correct": result["correct"], "failed": result["failed"],
            **{k: c["value"] for k, c in result["checks"].items()}}


def control_reading(cfg, tr, problem, seed, device) -> dict:
    """The control's numbers on the sample a run with ``seed`` would check."""
    control = Tf32Control(problem, cfg["program"]["step"]["tol"], device)
    gen, sample = ClosedLoop(tr, seed), Sample(tr, seed)
    for i in range(sample.k):
        mus = gen.mus(i)
        sample.offer(i, (mus, control(mus), None))
    answers = [(mu, u, control.indicators(u, mu)) for mu, u, _ in sample.answers()]
    return check.numbers(problem, answers)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(PLANTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    wl = spec.workload(args.workload)
    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    rows = []

    def emit(who, seed, got):
        rows.append((who, got))
        print(json.dumps({"who": who, "seed": seed, **got}), flush=True)

    for seed in args.seeds:
        emit("program", seed, _reading(args.workload, seed, args.seconds))
    for name in args.faults:
        for seed in args.fault_seeds:
            with contextlib.ExitStack() as stack:
                overrides = PLANTS[name](lambda obj, attr, value: stack.enter_context(
                    mock.patch.object(obj, attr, value)))
                emit(name, seed, _reading(args.workload, seed, args.seconds, overrides))
    problem = check.reference(cfg)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        got = control_reading(cfg, tr, problem, seed, "cuda:0")
        emit("control", seed, {**got, "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    def pick(who, agg):
        vals = [g for w, g in rows if w == who]
        return {k: agg(g[k] for g in vals) for k in check.NUMBERS} if vals else None

    summary = {"lower": pick("program", max), "control": pick("control", min),
               **{name: pick(name, min) for name in args.faults}}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
