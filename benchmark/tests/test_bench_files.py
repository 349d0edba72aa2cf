"""Every part of the benchmark is found by the name ``BENCHMARK.json``
gives it, and the file keeps to the benchmark's rules."""
import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        (entry["config"], entry["traffic"], entry["chips"])
    cfg = spec.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert spec.traffic(wl["traffic"])["kind"] == "closed_loop"
    assert set(wl["limits"]) == {"u_err", "ind_err"}
    assert 0 < len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_readers_found_by_name(metric):
    assert callable(spec.reader(metric))


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "queries_per_s", "call_p95_ms"} == e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.loads((spec.ROOT / c["file"]).read_text())["source"].startswith(
            c["source"].split()[0])


def test_per_layer_lists_only_cells_that_report_it():
    lists = {m["name"]: m["workloads"] for m in BENCH["per_layer"]}
    assert lists["block_matvec_roofline"] == ["os2015_tri_affine.sweep_b256"]
    assert lists["call_tail_p95_ms"] == ["os2015_tri_stencil.sweep_b1024"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_its_per_layer_metrics_move(cell):
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, False)}
    per_layer = spec.metrics_of(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert all(m["moves"] in e2e for m in per_layer)


def test_the_stencil_tail_is_read_per_layer_only():
    """The stencil cell's window holds too few calls for a bounded 95th
    percentile; the tail is reported per layer there, under another name."""
    p95 = next(m for m in BENCH["end_to_end"] if m["name"] == "call_p95_ms")
    assert p95["workloads"] == ["os2015_tri_affine.sweep_b256"]
    assert spec.reader("call_tail_p95_ms").window and not spec.reader("call_p95_ms").window


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.workload("no_such_cell")
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")
