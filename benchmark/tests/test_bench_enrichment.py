"""The enrichment cell end to end on the CPU at a tiny size: 3 x 2
subdomains of 4 x 4 cells (K = 6, N = 96), one query a call, the plain
kernels; the check against ``reference/spe10_2d.py``, and the enrichment
layer's program counters and span in a traced run (the device metrics need
the card).  ``ind_err`` keeps the cell's limit; ``u_err`` is the reduced
model's own error, which depends on the size: 1.0-2.0e-3 at this one
against 2.0-3.8e-4 at the cell's 16 x 16, so the tiny run is held to 5e-3."""
import time

import pytest
import torch

from benchmark import harness

CELL = "spe10_2d_lrbms.enrich_b1"
TINY = {"config": {"grid": {"num_subdomains": [3, 2],
                            "half_num_fine_elements_per_subdomain_and_dim": 2,
                            "num_refinements": 1}},
        "traffic": {"warmup_calls": 1, "trace_calls": 2, "gap_calls": 1, "sample": {"calls": 3}},
        "workload": {"limits": {"u_err": 5e-3}}}


@pytest.mark.parametrize("trace", [False, True])
def test_the_enrichment_cell_on_the_cpu(trace):
    torch.set_num_threads(2)
    result, _ = harness.run(CELL, 2 ** 31 + 17, 1.0, trace, "cpu", time.perf_counter(), TINY)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    metrics = result["metrics"]
    if trace:
        assert metrics["enrich_rounds_per_query"]["value"] == 3.0
        assert 0 < metrics["corrector_iters_per_round"]["value"] < 300
        assert metrics["basis_extension_host_ms_per_call"]["value"] > 0
        assert "corrector_device_ms_per_call" not in metrics      # no device trace here
    else:
        assert set(metrics) == {"queries_per_s", "setup_s"}
