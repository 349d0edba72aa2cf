"""Faults of the timed path, planted to show that ``correct`` comes out
false (``benchmark/tests/test_bench_control.py`` on the CPU,
``benchmark.calibrate --faults`` at a cell's own size on the card).

Each fault is ``plant(setattr) -> overrides``: it patches the program
through ``setattr(obj, name, value)`` (``monkeypatch.setattr``, or
``mock.patch.object`` under an ``ExitStack``) and returns overrides for
``harness.run``.  The cells run
on one card, so there is no exchange between chips to leave out.
"""
from __future__ import annotations

import sys

import torch


def _patch_solves(setattr, fn):
    """Replace the PCG in every module of the program that calls it."""
    from pylrbms_tpu_torch.la import krylov
    original = krylov.pcg_chunked
    for name, mod in list(sys.modules.items()):
        if name.startswith("pylrbms_tpu_torch") and getattr(mod, "pcg_chunked", None) is original:
            setattr(mod, "pcg_chunked", fn)


def _patch_step(setattr, alter):
    """Wrap the online step the harness builds: ``alter(U, ind) -> (U, ind)``."""
    import pylrbms_tpu_torch.model as model
    make = model.make_online_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def faulty(theta, theta_f, mu=None):
            return alter(*step(theta, theta_f, mu))
        faulty.iters_probe, faulty.arrays = step.iters_probe, step.arrays
        return faulty
    setattr(model, "make_online_step", wrapped)


def _unchanged(matvec, M, b, tol, maxiter, x0=None, chunk=None, comm=None):
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    return x, torch.zeros(b.shape[:-2], dtype=torch.int64, device=b.device)


def _half_left_out(U, ind):
    h = U.shape[0] // 2
    return torch.cat([U[:h], U[:h]]), torch.cat([ind[:h], ind[:h]])


def _last_tile_altered(U, ind, tile=128):
    lo = U.shape[0] - min(tile, U.shape[0] // 2)
    return torch.cat([U[:lo], U[lo:] * 1.01]), ind


def _patched(patch):
    def plant(setattr):
        import pylrbms_tpu_torch.model  # noqa: F401  (load the modules the patches reach)
        import pylrbms_tpu_torch.ops.matrixfree  # noqa: F401
        patch(setattr)
        return {}
    return plant


def _tolerance(tol):
    def plant(setattr):
        return {"config": {"program": {"step": {"tol": tol}}}}
    return plant


FAULTS = {
    "state_unchanged": _patched(lambda st: _patch_solves(st, _unchanged)),
    "half_batch_left_out": _patched(lambda st: _patch_step(st, _half_left_out)),
    "answer_altered_U": _patched(lambda st: _patch_step(st, lambda U, ind: (U * 1.01, ind))),
    "answer_altered_indicators": _patched(
        lambda st: _patch_step(st, lambda U, ind: (U, ind * 1.05))),
    "last_tile_altered_U": _patched(lambda st: _patch_step(st, _last_tile_altered)),
}
# the step stopped early, read on the card: at float32 a stop at 1e-3 or
# tighter gives the same answers, one at 1e-2 fails ``ind_err`` (PERF.md)
TOLERANCES = {f"tol_{t:.0e}": _tolerance(t) for t in (1e-5, 1e-4, 1e-3, 1e-2)}

