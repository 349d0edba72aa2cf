"""Device trace of a few calls (``torch.profiler``) and its reduction.

A trace is exported as a Chrome trace into a temporary file, read back and
deleted.  Device operations are the kernels, copies and fills on the card.

The traced window records device activity alone (no CPU operators, which
would add the profiler's own host work to every launch); it is timed by
the host clock from the first call's submission to the last call's
synchronized answers, and every device operation of the trace belongs to
it.  Which host operation left the card idle is read from a few more calls
traced with CPU operators as well (each a ``benchmark.call`` range of the
harness's own), kept out of the window since that tracing slows the host.

Which device kernels belong to a hand kernel of the program is read from
one more call traced with Python stacks: a kernel belongs to the wrapper
(``block_matvec``, ``precond_dot``) whose Python frame was running when its
launch was made (CUDA runtime event and kernel share a correlation id).
That call is kept out of the window, since the stack tracing slows the host.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

CALL = "benchmark.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
WRAPPERS = ("block_matvec", "precond_dot")
# CUPTI's record of the host blocked on a full launch queue: not device work
BLOCKED = "Command Buffer Full"
IDLE_HOST = "host Python (no torch op running)"


def _profile(fn, cpu=True, with_stack=False) -> list:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if cpu else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    acts = acts or [ProfilerActivity.CPU]          # no card: nothing of a device to read
    with profile(activities=acts, with_stack=with_stack) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def kernel_owners(fn) -> dict:
    """{device kernel name: wrapper name} of the kernels ``fn`` launched
    from inside a wrapper's Python frame."""
    events = _profile(fn, with_stack=True)
    frames = defaultdict(list)                      # thread -> [(start, end, wrapper)]
    for e in events:
        if e.get("cat") == "python_function":
            fname = e["name"].rsplit(": ", 1)[-1]
            if fname in WRAPPERS and "hopper_kernels" in e["name"]:
                frames[e["tid"]].append((e["ts"], e["ts"] + e["dur"], fname))
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    owners = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for start, end, wrapper in frames.get(launch["tid"], ()):
            if start <= launch["ts"] <= end:
                owners[e["name"]] = wrapper
    return owners


@dataclass
class Trace:
    window_s: float = 0.0
    calls: int = 0
    device: list = field(default_factory=list)      # (name, start_us, dur_us)
    gaps: list = field(default_factory=list)        # (host op, seconds)
    owners: dict = field(default_factory=dict)      # kernel name -> wrapper

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (union of intervals)."""
        busy, end = 0.0, None
        for _, ts, dur in sorted(self.device, key=lambda d: d[1]):
            lo, hi = ts, ts + dur
            if end is None or lo > end:
                busy += hi - lo
                end = hi
            elif hi > end:
                busy += hi - end
                end = hi
        return busy * 1e-6

    def top_ops(self, n=10) -> list:
        total = defaultdict(float)
        for name, _, dur in self.device:
            total[name] += dur * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def kernel(self, wrapper: str):
        """(events, device seconds) of the kernels owned by ``wrapper``."""
        durs = [dur for name, _, dur in self.device if self.owners.get(name) == wrapper]
        return len(durs), sum(durs) * 1e-6


def traced_window(calls, n: int, owners: dict) -> Trace:
    """Trace ``calls(n)``, which makes ``n`` calls and waits for each
    answer, recording device activity only."""
    held = {}

    def timed():
        t0 = time.perf_counter()
        calls(n)
        held["window_s"] = time.perf_counter() - t0

    events = _profile(timed, cpu=False)
    device = [(e["name"], e["ts"], e["dur"]) for e in events
              if e.get("cat") in DEVICE_CATS and e["name"] != BLOCKED]
    return Trace(window_s=held["window_s"], calls=n, device=device, owners=owners)


def idle_gaps(fn) -> list:
    """The longest idle stretches of the card while ``fn`` makes calls, each
    inside a ``record_function(CALL)``, named by the host operation running."""
    events = _profile(fn)
    calls = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == CALL]
    if not calls:
        return []
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    tid = calls[0]["tid"]
    device = [(e["name"], e["ts"], e["dur"]) for e in events
              if e.get("cat") in DEVICE_CATS and e["name"] != BLOCKED and t0 <= e["ts"] <= t1]
    host = [e for e in events if e.get("cat") in HOST_CATS and e["tid"] == tid
            and e["name"] != CALL]
    return _gaps(device, host, t0, t1)


def _gaps(device, host, t0, t1, n=10) -> list:
    """The ``n`` longest stretches of the window with no device operation,
    each named by the innermost host operation running at its middle."""
    stretches, end = [], t0
    for _, ts, dur in sorted(device, key=lambda d: d[1]):
        if ts > end:
            stretches.append((end, ts))
        end = max(end, ts + dur)
    if t1 > end:
        stretches.append((end, t1))
    stretches.sort(key=lambda g: g[0] - g[1])
    out = []
    for lo, hi in stretches[:n]:
        mid = 0.5 * (lo + hi)
        running = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = max(running, key=lambda e: e["ts"])["name"] if running else IDLE_HOST
        out.append([name, (hi - lo) * 1e-6])
    return out
