"""Artificial channels (the port of ``pylrbms_tpu/problems/artificial_channels.py``).

High-contrast channel network from box indicators: 4 horizontal channels,
fixed + parametrically 'switched' vertical connections; parameter
'switch' in [0.01, 1]; time-dependent rhs coefficient
``sin(4 pi t) > 0`` via '_t' — the parabolic showcase
(``artificial_channels_problem.py:38-98``).
"""
from ..grid import make_grid, make_boundary_info
from ..functions import (make_constant_function_1x1, make_constant_function_2x2,
                         make_indicator_function_1x1)
from ..parameters import (ExpressionParameterFunctional,
                          ProjectionParameterFunctional)
from ..config import validate_config


def _horizontal_channels(value):
    return [[[[1/16, 1/8 - 1/32], [1 - 1/16, 1/8 + 1/32]], value],
            [[[1/16, 3/8 - 1/32], [1 - 1/16, 3/8 + 1/32]], value],
            [[[1/16, 5/8 - 1/32], [1 - 1/16, 5/8 + 1/32]], value],
            [[[1/16, 7/8 - 1/32], [1 - 1/16, 7/8 + 1/32]], value]]


def _fixed_vertical(value):
    return [[[[1/16, 1/8 + 1/32], [1/4 - 1/16, 3/8 - 1/32]], value],
            [[[1/16, 5/8 + 1/32], [1/4 - 1/16, 7/8 - 1/32]], value],
            [[[3/4 + 1/16, 1/8 + 1/32], [1 - 1/16, 3/8 - 1/32]], value],
            [[[3/4 + 1/16, 5/8 + 1/32], [1 - 1/16, 7/8 - 1/32]], value]]


def _switched_vertical(value):
    return [[[[1/16, 3/8 + 1/32], [1/4 - 1/16, 5/8 - 1/32]], value],
            [[[3/4 + 1/16, 3/8 + 1/32], [1 - 1/16, 5/8 - 1/32]], value]]


def init_grid_and_problem(config, mu_bar=(1,), mu_hat=(1,)):
    config = validate_config(config)
    lower_left, upper_right = [0, 0], [1, 1]
    mu_min = min((0.01,) + tuple(mu_bar) + tuple(mu_hat))
    mu_max = max((1,) + tuple(mu_bar) + tuple(mu_hat))
    grid = make_grid((lower_left, upper_right),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))

    horizontal = make_indicator_function_1x1(_horizontal_channels(1), "horizontal")
    fixed_vert = make_indicator_function_1x1(_fixed_vertical(1), "fixed_vertical")
    switched_vert = make_indicator_function_1x1(_switched_vertical(1), "switched_vertical")
    background = (make_constant_function_1x1(1) - horizontal - fixed_vert - switched_vert)

    parameter_type = {"switch": (1,)}
    lambda_functions = [background, horizontal, fixed_vert, switched_vert]
    lambda_coefficients = [
        ExpressionParameterFunctional(str(mu_min), parameter_type),
        ExpressionParameterFunctional(str(mu_max), parameter_type),
        ExpressionParameterFunctional(str(mu_max), parameter_type),
        ProjectionParameterFunctional("switch", (1,), (0,)),
    ]
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f_functions = [
        make_indicator_function_1x1(
            [[[[1/16, 5/8 + 1/32], [1/4 - 1/16, 7/8 - 1/32]], 1]], "top_left"),
        make_indicator_function_1x1(
            [[[[3/4 + 1/16, 1/8 + 1/32], [1 - 1/16, 3/8 - 1/32]], 1],
             [[[3/4 + 1/16, 5/8 + 1/32], [1 - 1/16, 7/8 - 1/32]], 1]], "right"),
    ]
    f_coefficients = [
        ExpressionParameterFunctional("sin(2 * 2 * pi * _t) > 0", {"_t": ()}),
        ExpressionParameterFunctional("-1", None),
    ]

    def create_lambda(mu):
        return (make_constant_function_1x1(mu_min)
                - make_indicator_function_1x1(_horizontal_channels(mu_min))
                - make_indicator_function_1x1(_fixed_vertical(mu_min))
                - make_indicator_function_1x1(_switched_vertical(mu_min))
                + make_indicator_function_1x1(_horizontal_channels(mu_max))
                + make_indicator_function_1x1(_fixed_vertical(mu_max))
                + make_indicator_function_1x1(_switched_vertical(float(mu[0]))))

    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": lambda_functions, "coefficients": lambda_coefficients},
        "lambda_bar": create_lambda(mu_bar),
        "lambda_hat": create_lambda(mu_hat),
        "kappa": kappa,
        "f": {"functions": f_functions, "coefficients": f_coefficients},
        "parameter_type": parameter_type,
        "mu_bar": mu_bar,
        "mu_hat": mu_hat,
        "mu_min": (mu_min,),
        "mu_max": (mu_max,),
        "parameter_range": (mu_min, mu_max),
    }
