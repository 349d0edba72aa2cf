"""Alias module: the reference's name for :mod:`.non_parametric`
(``python/dune/pylrbms/non_parametric_problem.py``) so migrating imports keep working."""
from .non_parametric import *          # noqa: F401,F403
from .non_parametric import init_grid_and_problem  # noqa: F401
