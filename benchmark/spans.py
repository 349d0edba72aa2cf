"""Per-layer numbers of the program's spans and counters that
``benchmark/layers.py`` does not read: every counter of
``GLOBAL_TIMINGS`` per call (``stencil.applies``, ``stencil.lane_applies``)
and the device work launched inside any span (``estimate.oswald``,
``operator.apply``).

Like ``layers.py`` it runs only in a traced run, when the first reader that
needs it asks, after the trace, on the first ``layers.CALLS`` parameter
batches of the traced calls, each call synchronized: (a) the calls with the
program's timings recording, for the counters; (b) the calls under
``torch.profiler`` (CPU and CUDA, the timings off), where a device
operation belongs to every span open at its launch (the ``cuda_runtime``
event of the same correlation id).  The result is kept on ``ctx``
(``ctx.spans``).  A program without a counter or a span gives nothing for
it, and its readers return None.
"""
from __future__ import annotations

import importlib
from collections import defaultdict

import torch

from .layers import CALLS, STEP, TIMERS, _open_spans
from .trace import BLOCKED, DEVICE_CATS, _profile


def of(ctx) -> dict:
    """{"counters": {name: per call} or None, "device_ms": {span: per call}
    or None}, measured once a run."""
    got = getattr(ctx, "spans", None)
    if got is None:
        got = ctx.spans = measure(ctx)
    return got


def measure(ctx) -> dict:
    batches = ctx.batches[:CALLS]
    out = {"counters": None, "device_ms": None}
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
        timings.clear()
        timings.enable()
        try:
            calls()
        finally:
            timings.disable()
        n = sum(1 for r in timings.records if r.name == STEP and r.parent is None)
        totals = dict(timings.counters)
        timings.clear()
        out["counters"] = {k: v / n for k, v in totals.items()} if n else None
    if system.device.type == "cuda":
        out["device_ms"] = inside(_profile(calls))
    return out


def inside(events: list) -> dict | None:
    """{span: device ms per call of the operations launched while it was
    open}, over the ``step`` spans of the profiled ``events``; None when no
    ``step`` span was traced."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in notes if e["name"] == STEP]
    if not steps:
        return None
    tid = steps[0]["tid"]
    open_at = _open_spans([e for e in notes if e["tid"] == tid])
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and e["tid"] == tid
              and "correlation" in e.get("args", {})}
    ms = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e["name"] == BLOCKED:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        for name in set(open_at(ts)) if ts is not None else ():
            ms[name] += 1e-3 * e["dur"]
    return {k: v / len(steps) for k, v in ms.items()}


def counter(ctx, name: str):
    """Counter ``name`` per call, or None."""
    got = of(ctx)["counters"]
    return None if got is None else got.get(name)


def device_ms(ctx, span: str):
    """Device ms per call launched inside ``span``, or None."""
    got = of(ctx)["device_ms"]
    return None if got is None else got.get(span)
