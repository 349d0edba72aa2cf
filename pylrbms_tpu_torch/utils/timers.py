"""Structured timers.

The port of ``pylrbms_tpu/utils/timers.py``: ``Timings`` collects named wall
clock spans and can dump a table.  CUDA launches are asynchronous, so a span
that should include its device work hands a CUDA tensor over (``sync=`` or
``out["sync"] = tensor`` inside the block) and the span synchronizes that
tensor's device before it stops the clock; CPU tensors need no wait.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _wait(obj) -> None:
    """Wait for the device work behind a CUDA tensor; a no-op otherwise."""
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        torch.cuda.synchronize(obj.device)


class Timings:
    def __init__(self):
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """``sync`` (or ``out["sync"]`` set inside the block) is a tensor to
        wait for before the span stops."""
        t0 = time.perf_counter()
        out = {}
        yield out
        _wait(sync)
        _wait(out.get("sync"))
        self.spans[name].append(time.perf_counter() - t0)

    def clear(self) -> None:
        self.spans.clear()

    def report(self) -> str:
        # the median is the headline column: one stalled call moves mean and
        # max but not the median
        lines = [f"{'span':40s} {'calls':>6s} {'total[s]':>10s} "
                 f"{'median[ms]':>11s} {'min[ms]':>10s} {'max[ms]':>10s}"]
        for name, ts in sorted(self.spans.items()):
            st = sorted(ts)
            n = len(st)
            med = st[n // 2] if n % 2 else 0.5 * (st[n // 2 - 1] + st[n // 2])
            lines.append(f"{name:40s} {n:6d} {sum(ts):10.3f} {1e3 * med:11.2f} "
                         f"{1e3 * min(ts):10.2f} {1e3 * max(ts):10.2f}")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({k: {"calls": len(v), "total_s": sum(v)}
                           for k, v in self.spans.items()})


GLOBAL_TIMINGS = Timings()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block — host ops, and the card's kernels
    and copies where CUDA is available — written as a Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json`` under ``log_dir`` (open it in
    Perfetto or chrome://tracing); the counterpart of the reference's XLA
    trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
