"""The per-layer numbers read from the program's spans and counter
(``benchmark/layers.py``): a tiny traced run on the CPU, the attribution of
device operations on hand-made trace events, a program without the spans,
and on the card the device parts against the profiled calls' busy time."""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark import layers, spec
from benchmark.tests.conftest import CELLS, run_tiny
from benchmark.traffic import Sample

PROGRAM = {"pcg_bodies_per_call", "solve_host_ms_per_call", "estimate_host_ms_per_call"}
DEVICE = {"host_syncs_per_call", "operator_device_ms_per_call", "pcg_self_device_ms_per_call",
          "pcg_ops_per_body", "estimate_device_ms_per_call"}
PARTS = ("operator.assemble", "operator.apply", "precond.apply", "pcg_self", "estimate")


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_run_reads_the_programs_spans_and_counter(cell):
    result, _ = run_tiny(cell, trace=True)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] is True
    assert PROGRAM <= set(m) and not DEVICE & set(m)     # no card: no device trace
    assert all(m[k] > 0 for k in PROGRAM)
    # one body a convergence read on the CPU: the bodies are the iterations
    assert m["pcg_bodies_per_call"] == m["pcg_iters"]
    assert all(spec.reader(name)(types.SimpleNamespace(layers={"program": None, "device": None}))
               is None for name in PROGRAM | DEVICE)


def test_the_helper_runs_once_and_leaves_the_window_as_it_was(monkeypatch):
    from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS
    seen, offered = [], []
    measure, offer = layers.measure, Sample.offer

    def spy(ctx):
        before = (list(ctx.batches), ctx.calls)
        out = measure(ctx)
        seen.append((before, (list(ctx.batches), ctx.calls)))
        return out

    monkeypatch.setattr(layers, "measure", spy)
    monkeypatch.setattr(Sample, "offer",
                        lambda self, i, item: offered.append(i) or offer(self, i, item))
    result, _ = run_tiny(CELLS[0], trace=True)
    assert len(seen) == 1
    (batches0, calls0), (batches1, calls1) = seen[0]
    assert calls0 == calls1 == len(offered) == result["attempted"] // 4
    assert len(batches0) == len(batches1) and all(a is b for a, b in zip(batches0, batches1))
    assert not GLOBAL_TIMINGS.on and not GLOBAL_TIMINGS.records


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """A program whose timings have no switch (as before the spans) gives
    no number from (a) and no ``step`` annotation to (b): the readers
    return None and the run reports the other metrics."""
    monkeypatch.setitem(sys.modules, "no_switch_timers",
                        types.SimpleNamespace(GLOBAL_TIMINGS=types.SimpleNamespace(spans={})))
    monkeypatch.setattr(layers, "TIMERS", "no_switch_timers")
    result, _ = run_tiny(CELLS[1], trace=True)
    assert result["correct"] is True and "pcg_iters" in result["metrics"]
    assert not (PROGRAM | DEVICE) & set(result["metrics"])
    assert layers.attribute([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}]) is None


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def test_device_operations_belong_to_the_spans_open_at_their_launch():
    spans = [("step", 0, 100), ("operator.assemble", 1, 4), ("solve", 10, 50),
             ("operator.apply", 12, 8), ("precond.apply", 22, 8), ("estimate", 70, 25),
             ("estimate.flux", 71, 9)]
    events = [_x("user_annotation", n, ts, d) for n, ts, d in spans]
    # launches (host ts) and their kernels (device ts, dur): one in each span,
    # one in the step outside every child, one after the step
    launches = [(2, 1.0), (13, 2.0), (23, 3.0), (40, 4.0), (72, 5.0), (90, 6.0), (98, 7.0),
                (150, 8.0)]
    for c, (host, ms) in enumerate(launches):
        events.append(_x("cuda_runtime", "cudaLaunchKernel", host, 0.5, correlation=c))
        events.append(_x("kernel", f"k{c}", 1e4 * (c + 1), 1e3 * ms, correlation=c))
    events += [_x("cuda_runtime", "cudaStreamSynchronize", 45, 1),
               _x("cuda_runtime", "cudaMemcpyAsync", 46, 1),
               _x("cuda_runtime", "cudaStreamSynchronize", 120, 1),
               _x("kernel", "Command Buffer Full", 5e3, 10.0)]
    got = layers.attribute(events)
    ms = got["device_ms"]
    assert got["calls"] == 1 and got["syncs"] == 1
    assert got["syncs_in"] == {"step": 1, "solve": 1}
    assert (ms["operator.assemble"], ms["operator.apply"], ms["precond.apply"],
            ms["pcg_self"], ms["solve"]) == (1.0, 2.0, 3.0, 4.0, 9.0)
    assert (ms["estimate.flux"], ms["estimate"], ms["step"]) == (5.0, 11.0, 28.0)
    assert got["ops"]["solve"] == 3 and got["ops"]["step"] == 7
    assert got["busy_ms"] == pytest.approx(36.0)          # the kernel after the step too
    assert sum(ms[k] for k in PARTS) == ms["step"] - 7.0   # less the step's own launch


def test_an_untraced_run_never_imports_the_helper():
    code = ("import sys\n"
            "from benchmark.tests.conftest import CELLS, run_tiny\n"
            "for cell in CELLS:\n"
            "    run_tiny(cell)\n"
            "print('benchmark.layers' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == "False"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_device_parts_add_up_to_the_busy_time(card, cell):
    """At the cell's size: the device ms of the operator, preconditioner and
    PCG-self parts, the estimate and the assembly come within 5% of the
    profiled calls' busy time."""
    from benchmark.harness import Context
    from benchmark.system import OnlineStep
    from benchmark.traffic import WARMUP, ClosedLoop
    wl = spec.workload(cell)
    system = OnlineStep(spec.config(wl["config"]), card)
    gen = ClosedLoop(spec.traffic(wl["traffic"]), 2 ** 31 + 4099)
    for i in range(2):
        system(gen.mus(i, WARMUP))
    torch.cuda.synchronize(card)
    ctx = Context(system=system, setup_s=0.0, batches=[gen.mus(i) for i in range(layers.CALLS)])
    got = layers.of(ctx)
    dev, prog = got["device"], got["program"]
    parts = sum(dev["device_ms"].get(k, 0.0) for k in PARTS)
    print(json.dumps({"cell": cell, "parts_ms": parts, **dev, **prog}))
    assert dev["calls"] == prog["calls"] == layers.CALLS
    assert abs(parts - dev["busy_ms"]) <= 0.05 * dev["busy_ms"]
    assert prog["bodies"] >= system.iterations(ctx.batches[0]) and dev["syncs"] >= 1
    assert layers.of(ctx) is got
    system.release()
