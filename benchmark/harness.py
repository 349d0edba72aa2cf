"""One run of one cell: set-up, the measured (or traced) window, the
metric readers and the correctness check.

Set-up builds the system under test from the cell's configuration, makes
the traffic's warm-up calls, moves every object it made out of the
collector's reach (``gc.freeze``) and ends at the first timed call.  The
window is a closed loop: each call sends one batch of queries, waits until
its answers are on the device, and the next call follows.  A traced run
profiles ``trace_calls`` such calls instead (device activity only), after
a measured window like an untraced run's where a reader of the cell asks
for one (``WINDOW`` in its file); then one call traced with Python stacks
tells which kernel belongs to which wrapper, and ``gap_calls`` traced with
CPU operators what the host did while the card idled.  After the window the readers named in
``BENCHMARK.json`` for the cell take their numbers; then the program's
state is freed and the plain reference judges a sample of the window's
answers.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from . import check, spec
from .system import OnlineStep
from .trace import CALL, Trace, idle_gaps, kernel_owners, traced_window
from .traffic import WARMUP, ClosedLoop, Sample


@dataclass
class Context:
    """What a metric reader may read."""
    system: OnlineStep
    setup_s: float
    window_s: float = 0.0
    calls: int = 0
    queries: int = 0
    latencies_s: list = field(default_factory=list)
    window_latencies_s: list = field(default_factory=list)   # a traced run's measured window
    batches: list = field(default_factory=list)       # the window's parameters, per call
    trace: Trace = None
    launches: dict = field(default_factory=dict)      # hand-kernel launches in the window


def _merge(base: dict, extra: dict | None) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        overrides: dict | None = None) -> tuple:
    """Returns (result dict, check lines).  ``overrides`` are merged into the
    cell's configuration, traffic and cell files: a test's tiny size, or a
    fault that ``benchmark.faults`` plants through the configuration."""
    overrides = overrides or {}
    bench = spec.benchmark()
    wl = _merge(spec.workload(cell), overrides.get("workload"))
    cfg = _merge(spec.config(wl["config"]), overrides.get("config"))
    tr = _merge(spec.traffic(wl["traffic"]), overrides.get("traffic"))
    entries = spec.metrics_of(bench, cell, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in entries}

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    system = OnlineStep(cfg, dev)
    gen = ClosedLoop(tr, seed)
    for i in range(int(tr["warmup_calls"])):
        system(gen.mus(i, WARMUP))
    sync()
    gc.collect()
    gc.freeze()                           # the set-up's objects stay out of later collections
    ctx = Context(system=system, setup_s=time.perf_counter() - t_start)

    sample = Sample(tr, seed)
    failed = torch.zeros((), dtype=torch.int64, device=dev)

    def call(i):
        mus = gen.mus(i)
        t0 = time.perf_counter()
        U, ind = system(mus)
        sync()
        ctx.latencies_s.append(time.perf_counter() - t0)
        return mus, U, ind

    def keep(i, mus, U, ind):
        nonlocal failed
        failed = failed + (~(torch.isfinite(U).all(-1).all(-1) & torch.isfinite(ind).all(-1))).sum()
        sample.offer(i, (mus, U, ind))
        ctx.batches.append(mus)

    def window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            keep(ctx.calls, *call(ctx.calls))
            ctx.calls += 1
        ctx.window_s = time.perf_counter() - t0

    if trace:
        if any(r.window for r in readers.values()):
            window()
            ctx.window_latencies_s, ctx.latencies_s, ctx.batches = ctx.latencies_s, [], []
        ctx.trace = _traced(system, gen, tr, call, keep, ctx)
    else:
        window()
    ctx.queries = ctx.calls * gen.batch_size
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    for m in entries:
        value = readers[m["name"]](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    answers = sample.answers()
    result = {"correct": False, "attempted": ctx.queries, "failed": int(failed),
              "metrics": metrics, "device": _device(dev, peak, ctx.trace)}
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.gaps}
    system.release()                      # the program's state goes before the reference runs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    correct, checks = check.judge(check.reference(cfg), answers, wl["limits"])
    result["correct"] = correct and result["failed"] == 0
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def _traced(system, gen, tr, call, keep, ctx) -> Trace:
    """Profile ``trace_calls`` calls, first.  The kernels' owners and the
    idle gaps' host operations come from calls on the warm-up stream, made
    after the window and kept out of it."""
    def extra():
        system(gen.mus(0, WARMUP))

    def named():
        for _ in range(int(tr["gap_calls"])):
            with torch.profiler.record_function(CALL):
                extra()
                _sync(system)

    system.reset_launches()
    outs = []
    first = ctx.calls                      # the traced calls follow a measured window's

    def calls(n):
        for i in range(first, first + n):
            outs.append(call(i))

    t = traced_window(calls, int(tr["trace_calls"]), {})
    ctx.launches = system.launches()
    t.owners = kernel_owners(extra)
    t.gaps = idle_gaps(named)
    for i, out in enumerate(outs, first):  # after the trace: no harness work inside it
        keep(i, *out)
        ctx.calls += 1
    ctx.window_s = t.window_s
    return t


def _sync(system) -> None:
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)


def _device(dev, peak, trace) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info
