"""Coefficient / data functions evaluated at quadrature points.

The port of the 2D part of ``pylrbms_tpu/functions.py``: expression and
constant functions and their algebra, the checkerboard and box-indicator
functions of the thermal-block and channel problems, and the
cellwise-constant data field of the SPE10 problem.  A function is a
callable ``f(x)`` on a tensor ``x`` of shape ``(..., 2)`` returning ``(...,)``
(scalar) or ``(..., 2, 2)`` (matrix) on ``x``'s device and dtype.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


class ScalarFunction:
    """Scalar field on the domain; supports +, -, * with scalars/functions."""

    def __init__(self, fn: Callable, name: str = "function", order: int = 2):
        self._fn = fn
        self.name = name
        self.order = order  # polynomial-degree hint (quadrature sizing)

    def __call__(self, x):
        return self._fn(x)

    def __add__(self, other):
        other = as_scalar_function(other)
        return ScalarFunction(lambda x: self(x) + other(x),
                              name=f"({self.name}+{other.name})",
                              order=max(self.order, other.order))

    def __sub__(self, other):
        other = as_scalar_function(other)
        return ScalarFunction(lambda x: self(x) - other(x),
                              name=f"({self.name}-{other.name})",
                              order=max(self.order, other.order))

    def __rsub__(self, other):
        return as_scalar_function(other) - self

    def __mul__(self, other):
        other = as_scalar_function(other)
        return ScalarFunction(lambda x: self(x) * other(x),
                              name=f"({self.name}*{other.name})",
                              order=self.order + other.order)

    __radd__ = __add__
    __rmul__ = __mul__

    def __neg__(self):
        return ScalarFunction(lambda x: -self(x), name=f"(-{self.name})",
                              order=self.order)

    def __repr__(self):
        return f"ScalarFunction({self.name})"


class MatrixFunction:
    """2x2 matrix field (the diffusion tensor kappa)."""

    def __init__(self, fn: Callable, name: str = "matrix_function", order: int = 0):
        self._fn = fn
        self.name = name
        self.order = order

    def __call__(self, x):
        return self._fn(x)

    def __repr__(self):
        return f"MatrixFunction({self.name})"


def as_scalar_function(obj) -> ScalarFunction:
    if isinstance(obj, ScalarFunction):
        return obj
    if isinstance(obj, (int, float)):
        return make_constant_function_1x1(float(obj))
    raise TypeError(f"cannot interpret {obj!r} as scalar function")


_EXPR_NS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs, "pi": math.pi,
}


def make_expression_function_1x1(variable_or_expr, expr=None, order: int = 2,
                                 name: str = "expression") -> ScalarFunction:
    """Expression function over 'x', e.g. '1+(cos(0.5*pi*x[0])*cos(0.5*pi*x[1]))';
    callers may pass (expr,) or ('x', expr) positionally."""
    if expr is None:
        expr = variable_or_expr
    code = compile(expr, "<expr_function>", "eval")

    def fn(x):
        ns = dict(_EXPR_NS)
        ns["x"] = [x[..., i] for i in range(x.shape[-1])]
        val = eval(code, {"__builtins__": {}}, ns)
        return torch.as_tensor(val, dtype=x.dtype, device=x.device) \
            + torch.zeros_like(x[..., 0])

    return ScalarFunction(fn, name=name, order=order)


def make_constant_function_1x1(value: float, name: str = "constant") -> ScalarFunction:
    value = float(value)
    return ScalarFunction(
        lambda x: torch.full(x.shape[:-1], value, dtype=x.dtype, device=x.device),
        name=name, order=0)


def make_constant_function_2x2(matrix, name: str = "constant_matrix") -> MatrixFunction:
    mat = np.asarray(matrix, dtype=float)
    assert mat.shape == (2, 2)

    def fn(x):
        m = torch.as_tensor(mat, dtype=x.dtype, device=x.device)
        return m.expand(x.shape[:-1] + (2, 2))

    return MatrixFunction(fn, name=name, order=0)


def make_cellwise_function_1x1(grid, cell_values, name: str = "cellwise") -> ScalarFunction:
    """Piecewise constant per fine cell (SPE10-style data fields):
    ``cell_values[Sy, Sx]`` on the grid's global quad-cell raster."""
    vals = np.asarray(cell_values, dtype=float)

    def fn(x):
        fx = (x[..., 0] - grid.lower_left[0]) / grid.hx
        fy = (x[..., 1] - grid.lower_left[1]) / grid.hy
        ix = torch.clamp(torch.floor(fx).long(), 0, grid.global_nx - 1)
        iy = torch.clamp(torch.floor(fy).long(), 0, grid.global_ny - 1)
        return torch.as_tensor(vals, dtype=x.dtype, device=x.device)[iy, ix]

    return ScalarFunction(fn, name=name, order=0)


def make_checkerboard_function_1x1(lower_left, upper_right, num_elements,
                                   values, name: str = "checkerboard") -> ScalarFunction:
    """Checkerboard with dune-xt cell ordering: index = ix + nx*iy.
    ``values`` may be a flat list or a list of 1-element lists (dune style)."""
    ll = np.asarray(lower_left, dtype=float)
    ur = np.asarray(upper_right, dtype=float)
    nx, ny = int(num_elements[0]), int(num_elements[1])
    vals = np.asarray([v[0] if isinstance(v, (list, tuple)) else v for v in values],
                      dtype=float).reshape(ny, nx)  # vals[iy, ix]

    def fn(x):
        fx = (x[..., 0] - ll[0]) / (ur[0] - ll[0]) * nx
        fy = (x[..., 1] - ll[1]) / (ur[1] - ll[1]) * ny
        ix = torch.clamp(torch.floor(fx).long(), 0, nx - 1)
        iy = torch.clamp(torch.floor(fy).long(), 0, ny - 1)
        return torch.as_tensor(vals, dtype=x.dtype, device=x.device)[iy, ix]

    return ScalarFunction(fn, name=name, order=0)


def make_indicator_function_1x1(boxes_and_values: Sequence,
                                name: str = "indicator") -> ScalarFunction:
    """Sum of closed box indicators: ``[[[ll, ur], value], ...]``."""
    parsed = [(np.asarray(box[0], dtype=float), np.asarray(box[1], dtype=float),
               float(value)) for box, value in boxes_and_values]

    def fn(x):
        out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for ll, ur, value in parsed:
            inside = ((x[..., 0] >= ll[0]) & (x[..., 0] <= ur[0]) &
                      (x[..., 1] >= ll[1]) & (x[..., 1] <= ur[1]))
            out = out + value * inside.to(x.dtype)
        return out

    return ScalarFunction(fn, name=name, order=0)


def make_cellwise_function3d(grid, cell_values, name: str = "cellwise3d") -> ScalarFunction:
    """Piecewise constant per fine hex cell (SPE10 model-2 3D blocks):
    ``cell_values[Sz, Sy, Sx]`` on the 3D grid's global cell raster."""
    vals = np.asarray(cell_values, dtype=float)
    cache = {}

    def fn(x):
        key = (x.dtype, x.device)
        if key not in cache:
            cache[key] = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
        fx = (x[..., 0] - grid.lower_left[0]) / grid.hx
        fy = (x[..., 1] - grid.lower_left[1]) / grid.hy
        fz = (x[..., 2] - grid.lower_left[2]) / grid.hz
        ix = torch.clamp(torch.floor(fx).long(), 0, grid.global_nx - 1)
        iy = torch.clamp(torch.floor(fy).long(), 0, grid.global_ny - 1)
        iz = torch.clamp(torch.floor(fz).long(), 0, grid.global_nz - 1)
        return cache[key][iz, iy, ix]

    return ScalarFunction(fn, name=name, order=0)
