"""Local thermal-block (the port of ``pylrbms_tpu/problems/local_thermalblock.py``).

6x6 checkerboard where only cells 7 and 25 are parametric; coefficient
``1.1 + sin(diffusion)`` (``local_thermalblock_problem.py:36-51``).
"""
import numpy as np

from ..grid import make_grid, make_boundary_info
from ..functions import (make_checkerboard_function_1x1,
                         make_constant_function_2x2,
                         make_expression_function_1x1)
from ..parameters import ExpressionParameterFunctional
from ..config import validate_config


def init_grid_and_problem(config):
    config = validate_config(config)
    lower_left, upper_right = [-1, -1], [1, 1]
    grid = make_grid((lower_left, upper_right),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))

    def make_values(background, foreground):
        values = [[background]] * 36
        for ii in (7, 25):
            values[ii] = [foreground]
        return values

    diffusion_functions = [
        make_checkerboard_function_1x1(lower_left, upper_right, [6, 6],
                                       make_values(1.0, 0.0), name="lambda_0"),
        make_checkerboard_function_1x1(lower_left, upper_right, [6, 6],
                                       make_values(0.0, 1.0), name="lambda_1"),
    ]
    parameter_type = {"diffusion": (1,)}
    coefficients = [ExpressionParameterFunctional("1.", parameter_type),
                    ExpressionParameterFunctional("1.1 + sin(diffusion)", parameter_type)]
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f = make_expression_function_1x1(
        "x", "0.5*pi*pi*cos(0.5*pi*x[0])*cos(0.5*pi*x[1])", order=2, name="f")
    lam_barhat = make_checkerboard_function_1x1(lower_left, upper_right, [6, 6],
                                                make_values(1.0, 1.1))
    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": diffusion_functions, "coefficients": coefficients},
        "lambda_bar": lam_barhat,
        "lambda_hat": lam_barhat,
        "kappa": kappa,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": (0,),
        "mu_hat": (0,),
        "mu_min": (0,),
        "mu_max": (np.pi,),
        "parameter_range": (0, np.pi),
    }
