"""Alias module: the reference's name for :mod:`.artificial_channels`
(``python/dune/pylrbms/artificial_channels_problem.py``) so migrating imports keep working."""
from .artificial_channels import *          # noqa: F401,F403
from .artificial_channels import init_grid_and_problem  # noqa: F401
