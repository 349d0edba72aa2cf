"""Parabolic block SWIPDG discretizer.

The port of ``pylrbms_tpu/discretize_parabolic_block_swipdg.py``: the
elliptic block model, its L2 mass and implicit-Euler time stepping with the
parabolic estimator (:class:`~pylrbms_tpu_torch.model.InstationaryBlockModel`).
"""
from __future__ import annotations

from .discretize_elliptic_block_swipdg import discretize as discretize_ell
from .model import InstationaryBlockModel


def discretize(grid_and_problem_data, T: float, nt: int, **kw):
    """-> (InstationaryBlockModel, data); ``kw`` go to the elliptic
    discretizer (``device=``, ``dtype=``, ``lean=``, ...)."""
    d, data = discretize_ell(grid_and_problem_data, **kw)
    im = InstationaryBlockModel(stationary=d, T=float(T), nt=int(nt))
    data = dict(data)
    data["stationary"] = d
    return im, data
