"""3D thermal-block problem (beyond the 2D-only reference).

The port of ``pylrbms_tpu/problems/thermalblock3d.py``.

The classic checkerboard lifted to 3D: a 2 x 2 x 2 block partition of
[-1, 1]^3, one indicator diffusion component per block with
``ProjectionParameterFunctional`` coefficients — 8 independent parameters,
the multi-parameter MOR stress case for the 3D hex family (the 2D version
mirrors ``thermalblock_problem.py``).
"""
from itertools import product

import numpy as np
import torch

from ..grid3d import make_grid3d
from ..grid import make_boundary_info
from ..functions import ScalarFunction, make_expression_function_1x1
from ..parameters import ProjectionParameterFunctional
from ..config import validate_config

NB = 2          # blocks per dim


def _block_indicator3d(lower_left, upper_right, values, name="checkerboard3d"):
    """Piecewise-constant on the NB^3 block partition; values[iz][iy][ix]."""
    ll = np.asarray(lower_left, dtype=float)
    ur = np.asarray(upper_right, dtype=float)
    vals = np.asarray(values, dtype=float)       # [NB, NB, NB] (iz, iy, ix)

    def fn(x):
        fx = (x[..., 0] - ll[0]) / (ur[0] - ll[0]) * NB
        fy = (x[..., 1] - ll[1]) / (ur[1] - ll[1]) * NB
        fz = (x[..., 2] - ll[2]) / (ur[2] - ll[2]) * NB
        ix = torch.clamp(torch.floor(fx).long(), 0, NB - 1)
        iy = torch.clamp(torch.floor(fy).long(), 0, NB - 1)
        iz = torch.clamp(torch.floor(fz).long(), 0, NB - 1)
        return torch.as_tensor(vals, dtype=x.dtype, device=x.device)[iz, iy, ix]

    return ScalarFunction(fn, name=name, order=0)


def init_grid_and_problem(config, mu_bar=None, mu_hat=None):
    config = validate_config(config)
    lower_left, upper_right = [-1, -1, -1], [1, 1, 1]
    n_par = NB ** 3
    mu_bar = tuple(mu_bar) if mu_bar is not None else (1.0,) * n_par
    mu_hat = tuple(mu_hat) if mu_hat is not None else (1.0,) * n_par
    grid = make_grid3d((lower_left, upper_right),
                       config["num_subdomains"],
                       config["half_num_fine_elements_per_subdomain_and_dim"],
                       num_refinements=config.get("num_refinements", 1))

    def factory(ix, iy, iz):
        values = np.zeros((NB, NB, NB))
        values[iz, iy, ix] = 1.0
        return _block_indicator3d(lower_left, upper_right, values,
                                  name=f"diffusion_{ix}_{iy}_{iz}")

    blocks = list(product(range(NB), range(NB), range(NB)))   # (ix, iy, iz)
    diffusion_functions = [factory(ix, iy, iz) for ix, iy, iz in blocks]
    parameter_type = {"diffusion": (NB, NB, NB)}
    coefficients = [ProjectionParameterFunctional("diffusion", (NB, NB, NB),
                                                  (iz, iy, ix))
                    for ix, iy, iz in blocks]
    f = make_expression_function_1x1(
        "x", "0.75*pi*pi*cos(0.5*pi*x[0])*cos(0.5*pi*x[1])*cos(0.5*pi*x[2])",
        order=2, name="f")

    def lam_at(mu):
        values = np.zeros((NB, NB, NB))
        marr = np.asarray(tuple(mu)).reshape(NB, NB, NB)
        for ix, iy, iz in blocks:
            values[iz, iy, ix] = marr[iz, iy, ix]
        return _block_indicator3d(lower_left, upper_right, values)

    return {
        "grid": grid,
        "boundary_info": make_boundary_info(
            grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": diffusion_functions,
                   "coefficients": coefficients},
        "lambda_bar": lam_at(mu_bar),
        "lambda_hat": lam_at(mu_hat),
        "kappa": None,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": mu_bar,
        "mu_hat": mu_hat,
        "mu_min": tuple(min(0.1, b, h) for b, h in zip(mu_bar, mu_hat)),
        "mu_max": tuple(max(1, b, h) for b, h in zip(mu_bar, mu_hat)),
        "parameter_range": (min((0.1,) + mu_bar + mu_hat),
                            max((1,) + mu_bar + mu_hat)),
    }
