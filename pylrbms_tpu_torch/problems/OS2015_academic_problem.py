"""Alias module: the reference's name for :mod:`.os2015`
(``python/dune/pylrbms/OS2015_academic_problem.py``) so migrating imports keep working."""
from .os2015 import *          # noqa: F401,F403
from .os2015 import init_grid_and_problem  # noqa: F401
