"""SPE10 model-2 problem, 2D layers and 3D blocks (the port of
``pylrbms_tpu/problems/spe10.py``).

A horizontal layer of the 60 x 220 x 85 permeability tensor on the
unit-normalized domain, cellwise-constant diffusion, with a 2-term affine
split lambda(mu) = lambda_low + mu * lambda_contrast so the MOR machinery has
a parameter to act on.

Data: reads the standard ``spe_perm.dat`` if a path is given or named by the
``SPE10_DATA`` environment variable; otherwise a deterministic synthetic
channelized log-permeability field (seeded numpy) with the same size,
contrast (~O(1e7)) and banded structure.  The 3D block stacks one surrogate
layer per z-layer.
"""
from __future__ import annotations

import os

import numpy as np

from ..grid import make_grid, make_boundary_info
from ..grid3d import make_grid3d
from ..functions import (make_cellwise_function_1x1, make_cellwise_function3d,
                         make_constant_function_1x1, make_constant_function_2x2)
from ..parameters import ExpressionParameterFunctional
from ..config import validate_config

SPE10_NX, SPE10_NY, SPE10_NZ = 60, 220, 85


def load_spe10_layer(layer: int = 42, path: str | None = None,
                     nx: int = SPE10_NX, ny: int = SPE10_NY) -> np.ndarray:
    """[ny, nx] horizontal-permeability layer (kx component)."""
    path = path or os.environ.get("SPE10_DATA")
    if path and os.path.exists(path):
        vals = np.fromfile(path, sep=" ")
        kx = vals[: nx * ny * SPE10_NZ].reshape(SPE10_NZ, ny, nx)
        return kx[layer]
    return _synthetic_spe10_layer(layer, nx, ny)


def _synthetic_spe10_layer(seed: int, nx: int, ny: int) -> np.ndarray:
    """Deterministic channelized log-normal surrogate with SPE10-like
    contrast (~1e-3 .. 1e4)."""
    rng = np.random.default_rng(1000 + seed)
    y, x = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx), indexing="ij")
    logk = rng.normal(0.0, 1.0, (ny, nx))
    # smooth: a few passes of neighbor averaging
    for _ in range(6):
        logk = 0.2 * (np.roll(logk, 1, 0) + np.roll(logk, -1, 0)
                      + np.roll(logk, 1, 1) + np.roll(logk, -1, 1)) + 0.2 * logk
    logk = 2.5 * logk / max(np.abs(logk).max(), 1e-12)
    # channels: high-permeability streaks
    for c, (y0, amp, wid) in enumerate([(0.2, 0.05, 0.02), (0.5, 0.08, 0.015),
                                        (0.8, 0.04, 0.025)]):
        channel = np.exp(-((y - y0 - amp * np.sin(6.28 * (x + 0.3 * c))) / wid) ** 2)
        logk += 4.0 * channel
    return 10.0 ** (logk - 1.5)


def pool_log_mean(perm: np.ndarray, ry: int, rx: int,
                  mode: str = "log-mean") -> np.ndarray:
    """Block pooling of a permeability raster to [ry, rx], so that the
    coefficient is EXACTLY representable on every grid level whose cell
    counts are multiples of ry/rx (all levels then solve the SAME problem).

    ``mode='log-mean'``: geometric mean per block (the natural homogenized
    coarsening; it smooths the contrast away at coarse rasters).
    ``mode='nearest'``: the block-center value (keeps the field's pointwise
    contrast)."""
    ny, nx = perm.shape
    if mode == "nearest":
        cy = ((np.arange(ry) + 0.5) / ry * ny).astype(int)
        cx = ((np.arange(rx) + 0.5) / rx * nx).astype(int)
        return perm[np.clip(cy, 0, ny - 1)[:, None],
                    np.clip(cx, 0, nx - 1)[None, :]]
    iy = np.minimum((np.arange(ny) * ry) // ny, ry - 1)
    ix = np.minimum((np.arange(nx) * rx) // nx, rx - 1)
    out = np.zeros((ry, rx))
    cnt = np.zeros((ry, rx))
    np.add.at(out, (iy[:, None], ix[None, :]), np.log(perm))
    np.add.at(cnt, (iy[:, None], ix[None, :]), 1.0)
    return np.exp(out / np.maximum(cnt, 1.0))


def pool_log_mean3d(perm: np.ndarray, rz: int, ry: int, rx: int,
                    mode: str = "log-mean") -> np.ndarray:
    """3D analogue of :func:`pool_log_mean`: pool a [nz, ny, nx] block to
    [rz, ry, rx] so every grid level whose cell counts are multiples of the
    raster resolves the SAME coefficient exactly (3D efficiency study)."""
    nz, ny, nx = perm.shape
    if mode == "nearest":
        cz = np.clip(((np.arange(rz) + 0.5) / rz * nz).astype(int), 0, nz - 1)
        cy = np.clip(((np.arange(ry) + 0.5) / ry * ny).astype(int), 0, ny - 1)
        cx = np.clip(((np.arange(rx) + 0.5) / rx * nx).astype(int), 0, nx - 1)
        return perm[cz[:, None, None], cy[None, :, None], cx[None, None, :]]
    iz = np.minimum((np.arange(nz) * rz) // nz, rz - 1)
    iy = np.minimum((np.arange(ny) * ry) // ny, ry - 1)
    ix = np.minimum((np.arange(nx) * rx) // nx, rx - 1)
    out = np.zeros((rz, ry, rx))
    cnt = np.zeros((rz, ry, rx))
    np.add.at(out, (iz[:, None, None], iy[None, :, None], ix[None, None, :]),
              np.log(perm))
    np.add.at(cnt, (iz[:, None, None], iy[None, :, None], ix[None, None, :]),
              1.0)
    return np.exp(out / np.maximum(cnt, 1.0))


def init_grid_and_problem(config, layer: int = 42, mu_bar=(1,), mu_hat=(1,),
                          max_contrast: float = None, raster=None,
                          raster_mode: str = "log-mean"):
    """config needs num_subdomains / half_num...; the permeability raster is
    resampled (nearest) onto the fine grid.  ``max_contrast`` optionally
    clips the normalized field to [1/max_contrast, 1] (the raw contrast of
    ~1e6-1e7 makes the linear systems brutal).  ``raster=(ry, rx)`` first
    pools the field to that blockwise raster (:func:`pool_log_mean`)."""
    config = validate_config(config)
    grid = make_grid(((0, 0), (1, 1)),
                     config["num_subdomains"],
                     config["half_num_fine_elements_per_subdomain_and_dim"],
                     num_refinements=config.get("num_refinements", 2),
                     grid_type=config.get("grid_type", "tri"))
    perm = load_spe10_layer(layer)
    if raster is not None:
        perm = pool_log_mean(perm, raster[0], raster[1], mode=raster_mode)
    ny, nx = perm.shape
    # nearest resample to the fine raster
    iy = (np.arange(grid.global_ny) + 0.5) / grid.global_ny * ny
    ix = (np.arange(grid.global_nx) + 0.5) / grid.global_nx * nx
    cells = perm[np.clip(iy.astype(int), 0, ny - 1)[:, None],
                 np.clip(ix.astype(int), 0, nx - 1)[None, :]]
    cells = cells / cells.max()
    if max_contrast is not None:
        cells = np.maximum(cells, 1.0 / max_contrast)
    lam_hi = make_cellwise_function_1x1(grid, cells, name="spe10_perm")
    floor = float(cells.min()) * 0.5
    lam_low = make_constant_function_1x1(floor, name="perm_floor")

    parameter_type = {"switch": (1,)}
    coefficients = [ExpressionParameterFunctional("1.", parameter_type),
                    ExpressionParameterFunctional("switch", parameter_type)]
    kappa = make_constant_function_2x2([[1.0, 0.0], [0.0, 1.0]], name="kappa")
    f = make_constant_function_1x1(1.0, name="f")

    def lam_at(mu):
        return make_cellwise_function_1x1(grid, floor + float(mu[0]) * cells)

    return {
        "grid": grid,
        "boundary_info": make_boundary_info(grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": [lam_low, lam_hi], "coefficients": coefficients},
        "lambda_bar": lam_at(mu_bar),
        "lambda_hat": lam_at(mu_hat),
        "kappa": kappa,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": mu_bar,
        "mu_hat": mu_hat,
        "mu_min": (0.1,),
        "mu_max": (1.0,),
        "parameter_range": (0.1, 1.0),
    }


# ---------------------------------------------------------------------------
# 3D (model-2 native): a [nz, ny, nx] sub-block of the permeability tensor
# ---------------------------------------------------------------------------

def load_spe10_block(layers=(40, 44), path: str | None = None,
                     nx: int = SPE10_NX, ny: int = SPE10_NY) -> np.ndarray:
    """[nz, ny, nx] horizontal-permeability block (kx component) for the
    z-layer range ``layers = (lo, hi)``; falls back to the deterministic
    synthetic surrogate per layer in this zero-egress environment."""
    lo, hi = int(layers[0]), int(layers[1])
    path = path or os.environ.get("SPE10_DATA")
    if path and os.path.exists(path):
        vals = np.fromfile(path, sep=" ")
        kx = vals[: nx * ny * SPE10_NZ].reshape(SPE10_NZ, ny, nx)
        return kx[lo:hi]
    return np.stack([_synthetic_spe10_layer(z, nx, ny) for z in range(lo, hi)])


def init_grid_and_problem_3d(config, layers=(40, 44), mu_bar=(1,), mu_hat=(1,),
                             max_contrast: float = None, raster=None,
                             raster_mode: str = "log-mean"):
    """SPE10 model-2 in native 3D (beyond the 2D-only reference): a z-block
    of the 60 x 220 x 85 field on the unit-normalized box, cellwise-constant
    diffusion on the hex grid, 2-term affine split
    lambda(mu) = floor + mu * perm (parameter 'switch', as in 2D)."""
    config = validate_config(config)

    grid = make_grid3d(((0, 0, 0), (1, 1, 1)),
                       config["num_subdomains"],
                       config["half_num_fine_elements_per_subdomain_and_dim"],
                       num_refinements=config.get("num_refinements", 1))
    perm = load_spe10_block(layers)
    if raster is not None:
        perm = pool_log_mean3d(perm, raster[0], raster[1], raster[2],
                               mode=raster_mode)
    nz, ny, nx = perm.shape
    iz = (np.arange(grid.global_nz) + 0.5) / grid.global_nz * nz
    iy = (np.arange(grid.global_ny) + 0.5) / grid.global_ny * ny
    ix = (np.arange(grid.global_nx) + 0.5) / grid.global_nx * nx
    cells = perm[np.clip(iz.astype(int), 0, nz - 1)[:, None, None],
                 np.clip(iy.astype(int), 0, ny - 1)[None, :, None],
                 np.clip(ix.astype(int), 0, nx - 1)[None, None, :]]
    cells = cells / cells.max()
    if max_contrast is not None:
        cells = np.maximum(cells, 1.0 / max_contrast)
    lam_hi = make_cellwise_function3d(grid, cells, name="spe10_perm3d")
    floor = float(cells.min()) * 0.5
    lam_low = make_constant_function_1x1(floor, name="perm_floor")

    parameter_type = {"switch": (1,)}
    coefficients = [ExpressionParameterFunctional("1.", parameter_type),
                    ExpressionParameterFunctional("switch", parameter_type)]
    f = make_constant_function_1x1(1.0, name="f")

    def lam_at(mu):
        return make_cellwise_function3d(grid, floor + float(mu[0]) * cells)

    return {
        "grid": grid,
        "boundary_info": make_boundary_info(
            grid, {"type": "xt.grid.boundaryinfo.alldirichlet"}),
        "lambda": {"functions": [lam_low, lam_hi], "coefficients": coefficients},
        "lambda_bar": lam_at(mu_bar),
        "lambda_hat": lam_at(mu_hat),
        "kappa": None,
        "f": f,
        "parameter_type": parameter_type,
        "mu_bar": mu_bar,
        "mu_hat": mu_hat,
        "mu_min": (0.1,),
        "mu_max": (1.0,),
        "parameter_range": (0.1, 1.0),
    }
