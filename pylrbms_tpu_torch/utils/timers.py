"""Structured timers: named spans and counters, off until switched on.

The port of ``pylrbms_tpu/utils/timers.py``.  ``Timings`` records named
wall-clock spans and counters while it is on (``enable()``, ``disable()``).
``GLOBAL_TIMINGS``, which the library's own spans use (the online step, the
PCG loop, the estimator, the greedy, the enrichment loop), starts off; a
``Timings()`` that a caller builds starts on.

Off, ``span()`` returns one shared no-op context: it reads no clock,
allocates nothing and never synchronizes the device, and ``count()``
returns at once.  On, each span records its name, start and end
(``time.perf_counter_ns``), its parent span and the number of the call it
belongs to: the count of root spans, so every call of the online step
(whose ``step`` span is the root) carries one number.  CUDA launches are
asynchronous, so a span that should include its device work hands a CUDA
tensor over (``sync=`` or ``out["sync"] = tensor`` inside the block); when
on, the span waits for that tensor's device before it stops the clock.

Whenever a ``torch.profiler`` is recording, on or off, a span also opens
``torch.profiler.record_function(name)``: it appears in the profiler's
trace as a ``user_annotation`` over the host operations and launches made
inside it, on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler


def _wait(obj) -> None:
    """Wait for the device work behind a CUDA tensor; a no-op otherwise."""
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        torch.cuda.synchronize(obj.device)


class _Off:
    """The one span of a Timings that is off: enters and leaves without a
    clock read, and drops ``out["sync"] = ...``."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setitem__(self, key, value):
        pass


_OFF = _Off()


class _Record:
    """One span as recorded: times in ns, ``parent`` the enclosing record."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "call")

    def __init__(self, name, start_ns, parent, call):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.call = parent, call


class _Span:
    """A span that records (``timings`` set) and/or annotates a running
    profiler (``annotate``)."""
    __slots__ = ("timings", "name", "sync", "annotate", "out", "rec", "fn")

    def __init__(self, timings, name, sync, annotate):
        self.timings, self.name, self.sync, self.annotate = timings, name, sync, annotate

    def __enter__(self):
        if self.annotate:
            self.fn = _profiler.record_function(self.name)
            self.fn.__enter__()
        if self.timings is None:
            return _OFF
        self.out = {}
        self.rec = self.timings._open(self.name)
        return self.out

    def __exit__(self, *exc):
        try:
            if self.timings is not None:
                try:
                    if exc[0] is None:
                        _wait(self.sync)
                        _wait(self.out.get("sync"))
                finally:
                    self.timings._close(self.rec)
        finally:
            if self.annotate:
                self.fn.__exit__(*exc)
        return False


class Timings:
    def __init__(self, on: bool = True):
        self.on = on
        self.records: List[_Record] = []          # spans, in the order they opened
        self.counts: List[tuple] = []             # (name, n, enclosing record or None)
        self._calls = itertools.count()
        self._local = threading.local()           # each thread's stack of open spans

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, sync=None):
        """A context for one span of ``name``; ``sync`` (or ``out["sync"]``
        set inside the block) is a tensor to wait for before it stops."""
        annotate = _profiler._is_profiler_enabled
        if not self.on:
            return _Span(None, name, None, True) if annotate else _OFF
        return _Span(self, name, sync, annotate)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``, inside the innermost open span."""
        if self.on:
            stack = self._stack()
            self.counts.append((name, n, stack[-1] if stack else None))

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _open(self, name: str) -> _Record:
        stack = self._stack()
        parent = stack[-1] if stack else None
        call = parent.call if parent is not None else next(self._calls)
        rec = _Record(name, time.perf_counter_ns(), parent, call)
        stack.append(rec)
        self.records.append(rec)
        return rec

    def _close(self, rec: _Record) -> None:
        rec.end_ns = time.perf_counter_ns()
        self._stack().pop()

    @property
    def spans(self) -> Dict[str, List[float]]:
        """{name: [seconds of each closed span]}."""
        out = defaultdict(list)
        for r in self.records:
            if r.end_ns is not None:
                out[r.name].append(1e-9 * (r.end_ns - r.start_ns))
        return out

    @property
    def counters(self) -> Dict[str, int]:
        """{name: total of the counter}."""
        out = defaultdict(int)
        for name, n, _ in self.counts:
            out[name] += n
        return out

    def clear(self) -> None:
        self.records.clear()
        self.counts.clear()
        self._calls = itertools.count()

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
        lines += [f"{name:40s} {total:6d} (counter)" for name, total in sorted(self.counters.items())]
        return "\n".join(lines)

    def as_json(self) -> str:
        out = {k: {"calls": len(v), "total_s": sum(v)} for k, v in self.spans.items()}
        out.update({k: {"count": v} for k, v in self.counters.items()})
        return json.dumps(out)


GLOBAL_TIMINGS = Timings(on=False)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block — host ops, and the card's kernels
    and copies where CUDA is available — written as a Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json`` under ``log_dir`` (open it in
    Perfetto or chrome://tracing); the counterpart of the reference's XLA
    trace.  Every span opened inside it, on or off, is a ``user_annotation``
    there."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()
