"""Non-parametric smoke problem (the port of ``pylrbms_tpu/problems/non_parametric.py``).

Constant lambda = 1 (the reference builds an expression function and then
overwrites it with the constant, ``non_parametric_problem.py:34-36`` — we
keep the net effect); parameter_type None.  At lambda=1 the exact solution is
u = cos(pi x/2) cos(pi y/2).
"""
from ..grid import make_grid, make_boundary_info
from ..functions import (make_constant_function_1x1, make_constant_function_2x2,
                         make_expression_function_1x1)
from ..config import validate_config

COS = "(cos(0.5*pi*x[0])*cos(0.5*pi*x[1]))"


def init_grid_and_problem(config, mu_bar=1, mu_hat=1, mpi_comm=None):
    config = validate_config(config)
    grid = make_grid(((-1, -1), (1, 1)),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))
    lam = make_constant_function_1x1(1, name="lambda")
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f = make_expression_function_1x1("x", f"0.5*pi*pi*{COS}", order=2, name="f")
    lam_bar = make_expression_function_1x1("x", f"1+(1-{mu_bar})*{COS}", order=2)
    lam_hat = make_expression_function_1x1("x", f"1+(1-{mu_hat})*{COS}", order=2)
    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": lam,
        "lambda_bar": lam_bar,
        "lambda_hat": lam_hat,
        "kappa": kappa,
        "f": f,
        "parameter_type": None,
        "mu_bar": None,
        "mu_hat": None,
        "mu_min": None,
        "mu_max": None,
        "parameter_range": (min(0.1, mu_bar, mu_hat), max(1, mu_bar, mu_hat)),
    }
