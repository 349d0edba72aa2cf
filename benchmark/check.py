"""The comparison that decides ``correct``.

Two numbers, each against the limit the cell's file gives:

* ``u_err``: over the checked answers, the largest ||U - U_ref|| / ||U_ref||
  (2-norms), U_ref the float64 solution of the reference's own
  discretization at the query's parameter;
* ``ind_err``: over the checked answers, the largest
  max_k |ind_k - ref_k| / max_k ref_k, ref the reference estimator's
  indicators (float64) of the answer's own U: the estimator is judged on
  what the solver handed it.

An answer with a value that is not finite fails both.
"""
from __future__ import annotations

import importlib

import numpy as np

from .reference.solve import exact

NUMBERS = ("u_err", "ind_err")


def reference(cfg: dict):
    """The configuration's plain reference problem (``reference/<name>.py``)."""
    module = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return module.build(cfg)


def numbers(problem, answers) -> dict:
    """``answers``: [(mu, U [K, N], indicators [K])] in any float type."""
    u_err = ind_err = 0.0
    for mu, U, ind in answers:
        U = np.asarray(U, np.float64).reshape(-1)
        ind = np.asarray(ind, np.float64).reshape(-1)
        if not (np.isfinite(U).all() and np.isfinite(ind).all()):
            return {"u_err": float("inf"), "ind_err": float("inf")}
        u_ref = exact(problem, mu)
        u_err = max(u_err, float(np.linalg.norm(U - u_ref) / np.linalg.norm(u_ref)))
        ref = problem.indicators(U, mu)
        ind_err = max(ind_err, float(np.abs(ind - ref).max() / np.abs(ref).max()))
    return {"u_err": u_err, "ind_err": ind_err}


def judge(problem, answers, limits: dict):
    """(correct, {name: {"value", "limit"}})."""
    got = numbers(problem, answers)
    checks = {k: {"value": got[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
