"""Per-layer numbers from the program's own spans and counter
(``pylrbms_tpu_torch.utils.timers``), shared by the readers in ``metrics/``.

It runs only in a traced run, when the first reader that needs it asks,
after the trace.  It makes two short sets of extra calls on the first
``CALLS`` parameter batches of the traced calls (``ctx.batches``), each
call synchronized; ``ctx.batches``, the sample and the failure count never
see them:

(a) with the program's ``GLOBAL_TIMINGS`` recording and no profiler: each
    span's host wall time and the ``pcg.bodies`` counter, per call;
(b) under ``torch.profiler`` with CPU and CUDA activities, no stacks, the
    timings off: every span is then a ``user_annotation`` on the host
    thread.  A device operation (kernel, copy, fill) belongs to the spans
    open at its launch, the ``cuda_runtime`` event of the same correlation
    id, as in ``trace.kernel_owners``; a host sync is a blocking CUDA
    runtime call inside a ``step`` span.

The result is kept on ``ctx`` (``ctx.layers``), so both sets run once a
run, and recording is off afterwards.  Without a card (b) is skipped; a
program without the spans (no ``Timings.enable``) skips (a), and (b) finds
no ``step`` annotation: the readers then return None.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

import torch

from .trace import BLOCKED, DEVICE_CATS, Trace, _profile

CALLS = 4
STEP = "step"
SPANS = (STEP, "operator.assemble", "solve", "operator.apply", "precond.apply", "estimate",
         "estimate.flux")
BODIES = "pcg.bodies"
# CUDA runtime calls that block the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
TIMERS = "pylrbms_tpu_torch.utils.timers"


def of(ctx) -> dict:
    """{"program": (a) or None, "device": (b) or None}, measured once a run."""
    got = getattr(ctx, "layers", None)
    if got is None:
        got = ctx.layers = measure(ctx)
    return got


def measure(ctx) -> dict:
    batches = ctx.batches[:CALLS]
    out = {"program": None, "device": None}
    if not batches:
        return out
    system = ctx.system

    def calls():
        for mus in batches:
            system(mus)
            if system.device.type == "cuda":
                torch.cuda.synchronize(system.device)

    timings = importlib.import_module(TIMERS).GLOBAL_TIMINGS
    if hasattr(timings, "enable"):
        out["program"] = _program(calls, timings)
    if system.device.type == "cuda":
        out["device"] = attribute(_profile(calls))
    return out


def _program(calls, timings) -> dict | None:
    timings.clear()
    timings.enable()
    try:
        calls()
    finally:
        timings.disable()
    n = sum(1 for r in timings.records if r.name == STEP and r.parent is None)
    host_ms = defaultdict(float)
    for r in timings.records:
        if r.end_ns is not None:
            host_ms[r.name] += 1e-6 * (r.end_ns - r.start_ns)
    bodies = sum(c for name, c, _ in timings.counts if name == BODIES)
    timings.clear()
    if n == 0:
        return None
    return {"calls": n, "host_ms": {k: v / n for k, v in host_ms.items()}, "bodies": bodies / n}


def _open_spans(spans: list):
    """A function of a time (us) that gives the names of the spans of
    ``spans`` (properly nested Chrome trace events) open then, outermost
    first."""
    times, chains, stack = [], [], []

    def close(until):
        while stack and stack[-1][0] <= until:
            end = stack.pop()[0]
            times.append(end)
            chains.append(tuple(name for _, name in stack))

    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        close(e["ts"])
        stack.append((e["ts"] + e["dur"], e["name"]))
        times.append(e["ts"])
        chains.append(tuple(name for _, name in stack))
    close(float("inf"))

    def at(t):
        i = bisect.bisect_right(times, t) - 1
        return chains[i] if i >= 0 else ()
    return at


def attribute(events: list) -> dict | None:
    """Per call of the profiled ``events``: device ms and device ops of each
    span (its children included), of ``pcg_self`` (``solve`` outside its
    operator and preconditioner applies), the host syncs inside ``step``
    and inside each span, and the device's busy ms.  None when no ``step``
    span was traced."""
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == STEP]
    if not steps:
        return None
    tid = steps[0]["tid"]
    open_at = _open_spans([e for e in events if e.get("cat") == "user_annotation"
                           and e["name"] in SPANS and e["tid"] == tid])
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and e["tid"] == tid]
    launch = {e["args"]["correlation"]: e["ts"] for e in runtime
              if "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e["name"] != BLOCKED]
    ms, ops = defaultdict(float), defaultdict(int)
    for e in device:
        ts = launch.get(e.get("args", {}).get("correlation"))
        names = set(open_at(ts)) if ts is not None else set()
        if "solve" in names and not names & {"operator.apply", "precond.apply"}:
            names.add("pcg_self")
        for name in names:
            ms[name] += 1e-3 * e["dur"]
            ops[name] += 1
    syncs = defaultdict(int)
    for e in runtime:
        if e["name"] in SYNCS:
            for name in set(open_at(e["ts"])):
                syncs[name] += 1
    busy_s = Trace(device=[(e["name"], e["ts"], e["dur"]) for e in device]).busy_s
    n = len(steps)
    return {"calls": n, "device_ms": {k: v / n for k, v in ms.items()},
            "ops": {k: v / n for k, v in ops.items()}, "syncs": syncs[STEP] / n,
            "syncs_in": {k: v / n for k, v in syncs.items()}, "busy_ms": 1e3 * busy_s / n}


def program(ctx, key: str):
    """(a)'s number ``key`` ("bodies", or a span's host ms), or None."""
    got = of(ctx)["program"]
    if got is None:
        return None
    return got["host_ms"].get(key) if key in SPANS else got.get(key)


def device(ctx, key: str, *spans: str):
    """(b)'s number ``key``, summed over ``spans`` where given, or None."""
    got = of(ctx)["device"]
    if got is None:
        return None
    if not spans:
        return got.get(key)
    return sum(got[key].get(s, 0.0) for s in spans)
