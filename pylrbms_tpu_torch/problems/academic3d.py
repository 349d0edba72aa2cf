"""3D academic problem — the OS2015 construction lifted to [-1,1]^3.

The port of ``pylrbms_tpu/problems/academic3d.py``.

Beyond the 2D-only reference (<-> ``OS2015_academic_problem.py`` in 2D):
2-term affine diffusion
  lambda(mu) = (1 + c(x)) - mu * c(x),
  c = cos(pi x/2) cos(pi y/2) cos(pi z/2),
  kappa = I, f = 3/4 * pi^2 * c   (-Laplace(c) = 3 (pi/2)^2 c).
At mu = 1: lambda == 1 and u = c is the exact solution (all-Dirichlet zero
boundary on the cube).
"""
from ..grid3d import make_grid3d
from ..grid import make_boundary_info
from ..functions import make_expression_function_1x1
from ..parameters import ExpressionParameterFunctional
from ..config import validate_config

COS3 = "(cos(0.5*pi*x[0])*cos(0.5*pi*x[1])*cos(0.5*pi*x[2]))"


def init_grid_and_problem(config, mu_bar=1, mu_hat=1, mpi_comm=None):
    config = validate_config(config)
    grid = make_grid3d(((-1, -1, -1), (1, 1, 1)),
                       config["num_subdomains"],
                       config["half_num_fine_elements_per_subdomain_and_dim"],
                       num_refinements=config.get("num_refinements", 1))
    parameter_type = {"diffusion": (1,)}
    diffusion_functions = [
        make_expression_function_1x1("x", f"1+{COS3}", order=2, name="lambda_0"),
        make_expression_function_1x1("x", f"-1*{COS3}", order=2, name="lambda_1"),
    ]
    coefficients = [ExpressionParameterFunctional("1.", parameter_type),
                    ExpressionParameterFunctional("diffusion", parameter_type)]
    f = make_expression_function_1x1("x", f"0.75*pi*pi*{COS3}", order=2, name="f")
    mbc = f"1+(1-{mu_bar})*{COS3}"
    mhc = f"1+(1-{mu_hat})*{COS3}"
    return {
        "grid": grid,
        "boundary_info": make_boundary_info(
            grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": diffusion_functions,
                   "coefficients": coefficients},
        "lambda_bar": make_expression_function_1x1("x", mbc, order=2,
                                                   name="lambda_bar"),
        "lambda_hat": make_expression_function_1x1("x", mhc, order=2,
                                                   name="lambda_hat"),
        "kappa": None,          # identity (scalar path)
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": (mu_bar,),
        "mu_hat": (mu_hat,),
        "mu_min": (min(0.1, mu_bar, mu_hat),),
        "mu_max": (max(1, mu_bar, mu_hat),),
        "parameter_range": (min(0.1, mu_bar, mu_hat), max(1, mu_bar, mu_hat)),
    }
