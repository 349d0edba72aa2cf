"""Monolithic parabolic SWIPDG discretizer (K = 1).

The port of ``pylrbms_tpu/discretize_parabolic_swipdg.py``: the monolithic
elliptic discretizer wrapped into implicit Euler.
"""
from __future__ import annotations

from .discretize_elliptic_swipdg import discretize as discretize_stationary
from .model import InstationaryBlockModel


def discretize(grid_and_problem_data, T: float, nt: int, polorder: int = 1, **kw):
    d, data = discretize_stationary(grid_and_problem_data, polorder, **kw)
    im = InstationaryBlockModel(stationary=d, T=float(T), nt=int(nt))
    return im, data
