"""Block SWIPDG discretizer on the 3D hex family — the LRBMS FOM in 3D.

The port of ``pylrbms_tpu/discretize_elliptic_block_swipdg3d.py`` (Q1 and
Q2): the same tensors as the 2D discretizer — affine operator components
(diagonal blocks and the X/Y/Z interface quadruples), affine rhs, local
products, the estimator tensors and constants, the Oswald and
flux-reconstruction operators — on the hex block space, with a leading
subdomain axis on ``device`` in ``dtype``.  The accelerator f32 estimator
switch of the reference is not ported: every tensor is assembled in
``dtype`` (its CPU branch).

Returns ``(model, data)`` with the containers of the 2D discretizer, so the
estimator, the solvers and the reduction run on the 3D tensors unchanged.
"""
from __future__ import annotations

import torch

from .config import validate_solver_options
from .utils.precision import pin_precision, device as _device
from .ops.spaces3d import BlockDGSpace3D
from .ops import assembly3d as asm3
from .ops import products3d as prod3
from .ops.swipdg3d import assemble_swipdg_component3
from .ops.oswald3d import Oswald3D
from .ops.fluxreco3d import FluxReconstructor3D
from .ops.rt1hex import FluxReconstructorRT1Hex
from .ops.assembly import IPDGParams, DEFAULT_IPDG
from .la.block import AffineBlockOp
from .estimators import EstimatorData, EllipticEstimator
from .model import StationaryBlockModel
from .parameters import (CubicParameterSpace, parse_parameter,
                         evaluate_coefficients, as_functional)
from .discretize_elliptic_block_swipdg import _affine


def discretize(grid_and_problem_data: dict, solver_options=None, mpi_comm=None,
               ipdg: IPDGParams = DEFAULT_IPDG, dtype=torch.float64,
               device=None, lean: bool = False, order: int = 1):
    """``lean=True`` skips the O(Q^2 K N^2) matrix-form estimator tensors
    (M_aa / M_ab / BB / R_dd); the positive-form estimator path stays
    fully functional.

    ``order=2`` builds the pipeline on the Q2 block space with the
    degree-matched RT_[1] hex flux reconstruction and order-2 Oswald
    interpolation (``ops/rt1hex.py``)."""
    pin_precision()
    dev = _device(device)
    solver_options = validate_solver_options(solver_options)
    gpd = grid_and_problem_data
    grid = gpd["grid"]
    space = BlockDGSpace3D(grid, order=order)
    kw = dict(dtype=dtype, device=dev)

    lambda_funcs, lambda_coeffs = _affine(gpd["lambda"])
    f_funcs, f_coeffs = _affine(gpd["f"])
    kappa = gpd.get("kappa")
    lambda_bar, lambda_hat = gpd["lambda_bar"], gpd["lambda_hat"]
    parameter_type = gpd.get("parameter_type")
    mu_bar = parse_parameter(parameter_type, gpd.get("mu_bar")) \
        if gpd.get("mu_bar") is not None else {}
    mu_hat = parse_parameter(parameter_type, gpd.get("mu_hat")) \
        if gpd.get("mu_hat") is not None else {}

    comps = [assemble_swipdg_component3(space, lf, kappa, ipdg, **kw)
             for lf in lambda_funcs]
    op = AffineBlockOp.from_components(space, comps)
    rhs_q = torch.stack([asm3.volume_functional(space, ff, **kw) for ff in f_funcs])
    L2 = asm3.volume_mass(space, None, **kw)
    E_bar = asm3.volume_elliptic(space, lambda_bar, kappa, **kw)
    th_bar = (evaluate_coefficients(lambda_coeffs, mu_bar, **kw) if mu_bar
              else torch.ones(len(lambda_funcs), **kw))
    energy = torch.zeros_like(L2)
    for lf, c in zip(lambda_funcs, th_bar):
        energy = energy + c * (asm3.volume_elliptic(space, lf, kappa, **kw)
                               + prod3.penalty_product(space, lf, kappa, ipdg, **kw))
    A_div = prod3.divergence_matrix(space, **kw)
    if lean:
        M_aa = BB = M_ab = R_dd = None
    else:
        M_aa = torch.stack([
            torch.stack([prod3.df_aa(space, lu, lv, lambda_hat, kappa, **kw)
                         for lv in lambda_funcs])
            for lu in lambda_funcs])                              # [Q, Q, K, N, N]
        BB = prod3.df_bb(space, lambda_hat, kappa, **kw)
        M_ab = torch.stack([prod3.df_ab(space, lv, lambda_hat, kappa, **kw)
                            for lv in lambda_funcs])
        R_dd = torch.einsum("nr,knm,ms->krs", A_div, L2, A_div)
    d_vec = torch.einsum("nr,qkn->qkr", A_div, rhs_q)
    rf_qq = torch.stack([
        torch.stack([asm3.volume_scalar(space, lambda x, fu=fu, fv=fv: fu(x) * fv(x), **kw)
                     for fv in f_funcs])
        for fu in f_funcs])                                       # [Qf, Qf, K]
    min_ev = prod3.min_diffusion_ev(space, lambda_hat, kappa, **kw)
    diam = torch.full((space.K,), grid.subdomain_diameter(), **kw)

    est_data = EstimatorData(
        E_bar=E_bar, L2=L2, M_aa=M_aa, BB=BB, M_ab=M_ab, A_div=A_div,
        R_dd=R_dd, d_vec=d_vec, rf_qq=rf_qq, min_ev=min_ev, diam=diam,
        oswald=Oswald3D(space, **kw),
        flux=(FluxReconstructor3D if order == 1 else FluxReconstructorRT1Hex)(
            space, kappa, ipdg, **kw),
        lambda_funcs=lambda_funcs,
        lambda_coeffs=[as_functional(c) for c in lambda_coeffs],
        f_coeffs=[as_functional(c) for c in f_coeffs],
        mu_bar=mu_bar, mu_hat=mu_hat, parameter_type=parameter_type,
        f_funcs=f_funcs, lambda_hat=lambda_hat)
    estimator = EllipticEstimator(est_data)

    parameter_range = gpd.get("parameter_range")
    pspace = (CubicParameterSpace(parameter_type, parameter_range[0], parameter_range[1])
              if parameter_type else None)

    model = StationaryBlockModel(
        grid=grid, space=space, op=op,
        lambda_coeffs=[as_functional(c) for c in lambda_coeffs],
        rhs_q=rhs_q, f_coeffs=[as_functional(c) for c in f_coeffs],
        estimator=estimator, parameter_space=pspace,
        parameter_type=parameter_type, components=comps,
        products={"l2": L2, "energy_mu_bar": energy, "elliptic_bar": E_bar},
        solver_options=solver_options, dtype=dtype, device=dev)

    data = {
        "space": space,
        "block_space": space,
        "grid": grid,
        "local_energy_dg_product": energy,
        "estimator_data": est_data,
        "unblock": model.unblock,
    }
    return model, data
