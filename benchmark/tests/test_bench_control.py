"""The check fails what it must: the control (the reference computed in
TF32 in the program's place) and a run with the timed path broken.

Faults of this cell kind (``benchmark/faults.py``): a solve that returns
its state unchanged; half of the batch left out (its answers taken from the
other half); an answer altered where it is produced, in every lane or in
the batch's last tile of lanes alone.  The cells run on one card, so there
is no exchange between chips to leave out."""
import numpy as np
import pytest
import torch

from benchmark import check, spec
from benchmark.calibrate import control_reading
from benchmark.faults import FAULTS, TOLERANCES
from benchmark.reference.solve import to_tf32
from benchmark.tests.conftest import CELLS, TINY_GRID, run_tiny
from benchmark.traffic import Sample


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 3])
def test_control_is_not_correct(cell, seed):
    wl = spec.workload(cell)
    cfg = dict(spec.config(wl["config"]), grid=dict(TINY_GRID))
    tr = dict(spec.traffic(wl["traffic"]), batch=4)
    got = control_reading(cfg, tr, check.reference(cfg), seed, "cpu")
    assert any(got[k] > wl["limits"][k] for k in check.NUMBERS), got


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -12, 3.0])
    assert to_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, 3.0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    result, _ = run_tiny(cell, seed=2 ** 31 + 29)
    assert result["correct"] is True, result["checks"]
    assert FAULTS[fault](monkeypatch.setattr) == {}
    result, _ = run_tiny(cell, seed=2 ** 31 + 29)
    assert result["correct"] is False, result["checks"]
    assert np.isfinite(result["checks"]["u_err"]["value"]) or fault == "state_unchanged"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_step_stopped_at_1e_2_is_not_correct_on_the_card(card, cell):
    """At the cell's own size: the float32 floor hides a stop at 1e-3 or
    tighter, and ``ind_err`` sees one at 1e-2."""
    import time
    from benchmark import harness
    overrides = TOLERANCES["tol_1e-02"](None)
    result, _ = harness.run(cell, 2 ** 31 + 41, 2.0, False, card, time.perf_counter(), overrides)
    assert result["correct"] is False, result["checks"]


def test_the_sample_reads_every_tile_of_lanes():
    tr = {"sample": {"calls": 4, "tile": 128, "per_tile": 1}}
    sample = Sample(tr, 2 ** 31 + 7)
    mus = np.random.default_rng(1).uniform(0.1, 1.0, 256)
    for _ in range(20):
        lanes = sample.lanes_of(mus)
        assert {int(np.argmin(mus)), int(np.argmax(mus))} <= set(lanes) and len(lanes) <= 4
        assert any(j < 128 for j in lanes) and any(j >= 128 for j in lanes)
