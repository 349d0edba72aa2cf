"""Alias module: the reference's name for :mod:`.thermalblock`
(``python/dune/pylrbms/thermalblock_problem.py``) so migrating imports keep working."""
from .thermalblock import *          # noqa: F401,F403
from .thermalblock import init_grid_and_problem  # noqa: F401
