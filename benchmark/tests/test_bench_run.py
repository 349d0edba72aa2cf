"""The one command, end to end: on the CPU at a tiny size with the plain
kernels (the look for a chip skipped), and as the command itself."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import CELLS, run_tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_end_to_end_on_the_cpu(cell, trace):
    result, lines = run_tiny(cell, trace=trace)
    assert list(result)[:5] == list(KEYS) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % 4 == 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"] and any(line.startswith(f"check {name}:") for line in lines)
    stencil = "stencil" in cell
    if trace:
        # the CPU has no device trace: the program's counter is read, and the
        # stencil cell's tail of the window measured before the trace
        assert set(result["metrics"]) == {"pcg_iters"} | ({"call_tail_p95_ms"} if stencil else set())
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert set(result["metrics"]) == {"queries_per_s", "setup_s"} | \
            (set() if stencil else {"call_p95_ms"})
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


def test_the_command_refuses_to_run_without_cuda():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_a_traced_run_with_a_window_reader_measures_the_window_first(monkeypatch):
    """The traced calls follow the window's: the sample and the failure
    count see every call, and only the traced calls' batches are probed."""
    from benchmark import harness
    probed = []
    real = harness.OnlineStep.iterations
    monkeypatch.setattr(harness.OnlineStep, "iterations",
                        lambda self, mus: probed.append(mus) or real(self, mus))
    result, _ = run_tiny(CELLS[1], trace=True)
    tail = result["metrics"]["call_tail_p95_ms"]["value"]
    assert result["attempted"] > 4 * 2 and tail > 0
    assert len(probed) == 2               # the tiny traffic's trace_calls


def test_no_jax_and_no_jax_package_is_loaded():
    """A whole run (tiny, CPU) loads neither JAX nor the JAX package;
    names are compared whole, so pylrbms_tpu_torch passes."""
    code = ("import sys, time, json\n"
            "from benchmark.tests.conftest import CELLS, run_tiny\n"
            "from benchmark.run import loaded_forbidden\n"
            "for cell in CELLS:\n"
            "    run_tiny(cell)\n"
            "    run_tiny(cell, trace=True)\n"
            "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
            "print(json.dumps([loaded_forbidden(), 'pylrbms_tpu_torch' in tops]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    forbidden, port_loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert forbidden == [] and port_loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark.run import loaded_forbidden
    monkeypatch.setitem(sys.modules, "pylrbms_tpu_torchx", sys)
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "pylrbms_tpu.model", sys)
    assert loaded_forbidden() == ["pylrbms_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                           "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", "1"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


def test_the_command_runs_one_cpu_thread():
    code = ("import os, benchmark.run\n"
            "print([os.environ[v] for v in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', "
            "'OPENBLAS_NUM_THREADS')])\n")
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["['1',", "'1',", "'1']"]
