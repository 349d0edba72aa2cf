"""Parabolic block SWIPDG discretizer on the 3D hex family.

The port of ``pylrbms_tpu/discretize_parabolic_block_swipdg3d.py``: the 3D
elliptic block model, its L2 mass and implicit-Euler time stepping
(:class:`~pylrbms_tpu_torch.model.InstationaryBlockModel`, whose dense and
matrix-free G = M + dt A paths carry the z-coupling family) with the
parabolic estimator.
"""
from __future__ import annotations

from .discretize_elliptic_block_swipdg3d import discretize as discretize_ell
from .model import InstationaryBlockModel


def discretize(grid_and_problem_data, T: float, nt: int, **kw):
    """-> (InstationaryBlockModel, data); ``kw`` go to the 3D elliptic
    discretizer (``device=``, ``dtype=``, ``lean=``, ``order=``, ...)."""
    d, data = discretize_ell(grid_and_problem_data, **kw)
    im = InstationaryBlockModel(stationary=d, T=float(T), nt=int(nt))
    data = dict(data)
    data["stationary"] = d
    return im, data
