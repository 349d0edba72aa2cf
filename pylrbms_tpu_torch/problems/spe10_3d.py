"""SPE10 model 2 in 3D as a configuration entry: the z-block of layers
40-44 with the contrast clipped to 1e4 (the defaults of
``scripts/spe10_3d.py``), built from a grid configuration alone.

``init_grid_and_problem(config)`` takes the keys every problem takes
(``num_subdomains`` with three entries, ``half_num_fine_elements_per_
subdomain_and_dim``, ``num_refinements``, ``grid_type`` 'hex') and returns
:func:`~pylrbms_tpu_torch.problems.spe10.init_grid_and_problem_3d` of it:
cellwise-constant diffusion lambda(mu) = floor + mu * k on the unit box,
parameter ``switch`` in [0.1, 1], f = 1, all-Dirichlet boundary.  The
field is ``spe_perm.dat`` where ``SPE10_DATA`` names it, else the seeded
channelized surrogate of :mod:`~pylrbms_tpu_torch.problems.spe10`.
"""
from __future__ import annotations

from .spe10 import init_grid_and_problem_3d

LAYERS = (40, 44)
MAX_CONTRAST = 1e4


def init_grid_and_problem(config, mu_bar=(1,), mu_hat=(1,)):
    """The SPE10 3D block of layers :data:`LAYERS` at contrast
    :data:`MAX_CONTRAST` on the hex grid of ``config``."""
    return init_grid_and_problem_3d(config, layers=LAYERS, mu_bar=mu_bar, mu_hat=mu_hat,
                                    max_contrast=MAX_CONTRAST)
