"""Alias module: the reference's name for :mod:`.local_thermalblock`
(``python/dune/pylrbms/local_thermalblock_problem.py``) so migrating imports keep working."""
from .local_thermalblock import *          # noqa: F401,F403
from .local_thermalblock import init_grid_and_problem  # noqa: F401
