"""Coefficient / data functions evaluated at quadrature points.

The port of ``pylrbms_tpu/functions.py`` for the functions the OS2015 slice
uses: expression and constant functions and their algebra, and the
cellwise-constant data field of the SPE10 problem.  A function is a
callable ``f(x)`` on a tensor ``x`` of shape ``(..., 2)`` returning ``(...,)``
(scalar) or ``(..., 2, 2)`` (matrix) on ``x``'s device and dtype.
"""
from __future__ import annotations

import math
from typing import Callable

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
