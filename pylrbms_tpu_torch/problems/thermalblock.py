"""Thermal-block problem (the port of ``pylrbms_tpu/problems/thermalblock.py``).

Classic 2x2 checkerboard: 4 indicator diffusion components with
``ProjectionParameterFunctional`` coefficients using row-flipped coordinates
(``thermalblock_problem.py:36-50``); parameter type {'diffusion': (2, 2)}.
"""
from itertools import product

import numpy as np

from ..grid import make_grid, make_boundary_info
from ..functions import (make_checkerboard_function_1x1,
                         make_constant_function_2x2,
                         make_expression_function_1x1)
from ..parameters import ProjectionParameterFunctional
from ..config import validate_config


def init_grid_and_problem(config, mu_bar=(1, 1, 1, 1), mu_hat=(1, 1, 1, 1)):
    config = validate_config(config)
    lower_left, upper_right = [-1, -1], [1, 1]
    grid = make_grid((lower_left, upper_right),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))
    XB, YB = 2, 2

    def factory(ix, iy):
        values = [[0.0]] * (XB * YB)
        values[ix + XB * iy] = [1.0]
        return make_checkerboard_function_1x1(lower_left, upper_right, [XB, YB],
                                              values, name=f"diffusion_{ix}_{iy}")

    diffusion_functions = [factory(ix, iy) for ix, iy in product(range(XB), range(YB))]
    parameter_type = {"diffusion": (YB, XB)}
    coefficients = [ProjectionParameterFunctional("diffusion", (YB, XB),
                                                  (YB - y - 1, x))
                    for x in range(XB) for y in range(YB)]
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f = make_expression_function_1x1(
        "x", "0.5*pi*pi*cos(0.5*pi*x[0])*cos(0.5*pi*x[1])", order=2, name="f")

    def lam_at(mu):
        mu = tuple(mu)
        values = [[0.0]] * (XB * YB)
        counter = 0
        for ix in range(YB):
            for iy in range(XB):
                values[ix + XB * iy] = [float(coefficients[counter].evaluate(
                    {"diffusion": np.asarray(mu).reshape(YB, XB)}))]
                counter += 1
        return make_checkerboard_function_1x1(lower_left, upper_right, [XB, YB], values)

    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": diffusion_functions, "coefficients": coefficients},
        "lambda_bar": lam_at(mu_bar),
        "lambda_hat": lam_at(mu_hat),
        "kappa": kappa,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": mu_bar,
        "mu_hat": mu_hat,
        "mu_min": tuple(min(0.1, b, h) for b, h in zip(mu_bar, mu_hat)),
        "mu_max": tuple(max(1, b, h) for b, h in zip(mu_bar, mu_hat)),
        "parameter_range": (min((0.1,) + tuple(mu_bar) + tuple(mu_hat)),
                            max((1,) + tuple(mu_bar) + tuple(mu_hat))),
    }
