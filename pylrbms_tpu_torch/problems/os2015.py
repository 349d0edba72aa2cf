"""OS2015 academic problem (the port of ``pylrbms_tpu/problems/os2015.py``).

2-term affine diffusion on [-1,1]^2:
  lambda(mu) = (1 + c(x)) - mu * c(x),  c = cos(pi x/2) cos(pi y/2)
  kappa = I, f = pi^2/2 * c
At mu = 1: lambda == 1 and u = c is the exact solution.
"""
from ..grid import make_grid, make_boundary_info
from ..config import validate_config
from ..functions import (make_expression_function_1x1,
                         make_constant_function_2x2)
from ..parameters import ExpressionParameterFunctional

COS = "(cos(0.5*pi*x[0])*cos(0.5*pi*x[1]))"


def init_grid_and_problem(config, mu_bar=1, mu_hat=1, mpi_comm=None):
    config = validate_config(config)
    grid = make_grid(((-1, -1), (1, 1)),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))
    parameter_type = {"diffusion": (1,)}
    diffusion_functions = [
        make_expression_function_1x1("x", f"1+{COS}", order=2, name="lambda_0"),
        make_expression_function_1x1("x", f"-1*{COS}", order=2, name="lambda_1"),
    ]
    coefficients = [ExpressionParameterFunctional("1.", parameter_type),
                    ExpressionParameterFunctional("diffusion", parameter_type)]
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f = make_expression_function_1x1("x", f"0.5*pi*pi*{COS}", order=2, name="f")
    mbc = f"1+(1-{mu_bar})*{COS}"
    mhc = f"1+(1-{mu_hat})*{COS}"
    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": diffusion_functions, "coefficients": coefficients},
        "lambda_bar": make_expression_function_1x1("x", mbc, order=2, name="lambda_bar"),
        "lambda_hat": make_expression_function_1x1("x", mhc, order=2, name="lambda_hat"),
        "kappa": kappa,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": (mu_bar,),
        "mu_hat": (mu_hat,),
        "mu_min": (min(0.1, mu_bar, mu_hat),),
        "mu_max": (max(1, mu_bar, mu_hat),),
        "parameter_range": (min(0.1, mu_bar, mu_hat), max(1, mu_bar, mu_hat)),
    }
