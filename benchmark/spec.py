"""Finds the benchmark's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Each part sits in a file of its own under this folder:

* ``workloads/<cell>.json``: the cell (its configuration, its traffic mix
  and the limits of its correctness check);
* ``configs/<config>.json``: the deployment as it is run;
* ``traffic/<traffic>.json``: the parameters of the traffic mix;
* ``metrics/<metric>.py``: a reader with ``read(ctx) -> float | None``;
  ``WINDOW = True`` there makes a traced run measure a window first.

A later cell or metric is added by adding files; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _file(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def _json(kind: str, name: str) -> dict:
    return json.loads(_file(kind, name, ".json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``; its ``window`` says
    whether it reads a measured window in a traced run."""
    path = _file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.read.window = bool(getattr(module, "WINDOW", False))
    return module.read


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    without a trace, its per-layer metrics with one."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
