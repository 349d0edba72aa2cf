"""Monolithic (non-block) SWIPDG discretizer: the EOC reference solver.

The port of ``pylrbms_tpu/discretize_elliptic_swipdg.py``: one DG space of
order ``polorder`` over the whole fine mesh, the affine system and the 'l2' /
'elliptic_mu_bar' / 'elliptic_q' product operators, assembled in one pass.
It is the block machinery with a single 1x1 'subdomain' covering the full
mesh: the monolithic view is the K=1 special case of the batched design.
"""
from __future__ import annotations

import torch

from .config import validate_solver_options
from .grid import Grid
from .la.block import AffineBlockOp
from .model import StationaryBlockModel
from .ops import assembly as asm
from .ops.assembly import IPDGParams, DEFAULT_IPDG
from .ops.spaces import BlockDGSpace
from .ops.swipdg import assemble_swipdg_component
from .parameters import (CubicParameterSpace, as_functional, evaluate_coefficients,
                         parse_parameter)
from .utils.precision import pin_precision, device as _device
from .discretize_elliptic_block_swipdg import _affine


def monolithic_grid(grid: Grid) -> Grid:
    if grid.global_nx != grid.global_ny:
        raise ValueError("the monolithic view needs a square mesh")
    return Grid(lower_left=grid.lower_left, upper_right=grid.upper_right,
                kx=1, ky=1, s=grid.global_nx, grid_type=grid.grid_type)


def discretize(grid_and_problem_data: dict, polorder: int = 1, solver_options=None,
               ipdg: IPDGParams = DEFAULT_IPDG, dtype=torch.float64, device=None):
    pin_precision()
    dev = _device(device)
    solver_options = validate_solver_options(solver_options)
    gpd = grid_and_problem_data
    grid = monolithic_grid(gpd["grid"])
    space = BlockDGSpace(grid, order=polorder)
    kw = dict(dtype=dtype, device=dev)

    lambda_funcs, lambda_coeffs = _affine(gpd["lambda"])
    f_funcs, f_coeffs = _affine(gpd["f"])
    kappa = gpd.get("kappa")
    parameter_type = gpd.get("parameter_type")
    mu_bar = parse_parameter(parameter_type, gpd.get("mu_bar")) \
        if gpd.get("mu_bar") is not None else {}
    lambda_coeffs = [as_functional(c) for c in lambda_coeffs]
    f_coeffs = [as_functional(c) for c in f_coeffs]

    comps = [assemble_swipdg_component(space, lf, kappa, ipdg, **kw) for lf in lambda_funcs]
    op = AffineBlockOp.from_components(space, comps)
    rhs_q = torch.stack([asm.volume_functional(space, ff, **kw) for ff in f_funcs])
    L2 = asm.volume_mass(space, None, **kw)
    elliptic_q = [asm.volume_elliptic(space, lf, kappa, **kw) for lf in lambda_funcs]
    th_bar = (evaluate_coefficients(lambda_coeffs, mu_bar, **kw) if mu_bar
              else torch.ones(len(lambda_funcs), **kw))
    elliptic_mu_bar = sum(c * E for c, E in zip(th_bar, elliptic_q))

    parameter_range = gpd.get("parameter_range")
    pspace = (CubicParameterSpace(parameter_type, parameter_range[0], parameter_range[1])
              if parameter_type else None)
    model = StationaryBlockModel(
        grid=grid, space=space, op=op, lambda_coeffs=lambda_coeffs, rhs_q=rhs_q,
        f_coeffs=f_coeffs, estimator=None, parameter_space=pspace,
        parameter_type=parameter_type, components=comps,
        products={"l2": L2, "elliptic_mu_bar": elliptic_mu_bar, "elliptic_q": elliptic_q},
        solver_options=solver_options, dtype=dtype, device=dev, name="MonolithicSwipdg")
    return model, {"space": space, "grid": grid}
