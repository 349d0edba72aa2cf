"""Parameter system: parameter types, parameter functionals, parameter spaces.

The port of ``pylrbms_tpu/parameters.py``.  A parameter ("mu") is a dict
``{component_name: tensor}``.  Unlike the JAX version, which only ever sees a
scalar mu (batching comes from ``vmap``), every functional here also accepts
leaves with a leading lane axis: a component of shape ``shape`` may arrive as
``[B, *shape]``, and the functional then returns ``[B]``;
:func:`evaluate_coefficients` stacks those into ``[B, Q]``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .utils.precision import device as _device


Mu = Dict[str, "torch.Tensor"]
ParameterType = Optional[Dict[str, Tuple[int, ...]]]


def _normalize_shape(shape) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def _lane_view(v, shape: Tuple[int, ...]) -> torch.Tensor:
    """``v`` as ``[*lanes, *shape]``: a leaf whose trailing dims already are
    ``shape`` keeps its leading lane dims; anything else is reshaped to
    ``shape`` (no lanes)."""
    v = _as_tensor(v)
    n = len(shape)
    if v.ndim >= n and tuple(v.shape[v.ndim - n:]) == shape:
        return v
    return v.reshape(shape)


def parse_parameter(parameter_type: ParameterType, mu) -> Mu:
    """Turn a scalar / tuple / dict into a canonical parameter dict of
    float64 CPU tensors (<-> pyMOR's ``Parametric.parse_parameter``)."""
    if parameter_type is None or len(parameter_type) == 0:
        return {}
    if isinstance(mu, dict):
        out = {}
        for k, shape in parameter_type.items():
            if k not in mu:
                raise ValueError(f"missing parameter component {k!r}")
            out[k] = _lane_view(mu[k], _normalize_shape(shape))
        for k, v in mu.items():
            if k not in out:
                out[k] = _as_tensor(v)
        return out
    keys = sorted(parameter_type.keys())
    flat = np.atleast_1d(np.asarray(mu, dtype=float)).ravel()
    total = sum(int(np.prod(_normalize_shape(parameter_type[k])) or 1) for k in keys)
    if flat.size == 1 and total > 1:
        flat = np.full(total, flat[0])
    if flat.size != total:
        raise ValueError(f"cannot parse parameter of size {flat.size} for type {parameter_type}")
    out = {}
    off = 0
    for k in keys:
        shape = _normalize_shape(parameter_type[k])
        n = int(np.prod(shape) or 1)
        out[k] = torch.as_tensor(flat[off:off + n].reshape(shape))
        off += n
    return out


class ParameterFunctional:
    """Base class: callable mu -> scalar, or ``[B]`` for lane-batched mu."""

    parameter_type: ParameterType = None

    def evaluate(self, mu: Mu):
        raise NotImplementedError

    def __call__(self, mu: Mu):
        return self.evaluate(mu)


class ConstantParameterFunctional(ParameterFunctional):
    def __init__(self, value: float):
        self.value = float(value)
        self.parameter_type = None

    def evaluate(self, mu: Mu):
        return torch.tensor(self.value, dtype=torch.float64)

    def __repr__(self):
        return f"Const({self.value})"


_EXPR_NAMESPACE = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs, "pi": math.pi,
    "min": torch.minimum, "max": torch.maximum,
}


class ExpressionParameterFunctional(ParameterFunctional):
    """theta(mu) given as an expression string over the parameter components
    (``'1.'``, ``'diffusion'``, ``'1.1 + sin(diffusion)'``).  Scalar-like
    components are exposed as scalars (``[B]`` for lane-batched mu);
    boolean results are cast to float."""

    def __init__(self, expression: str, parameter_type: ParameterType = None):
        self.expression = expression
        self.parameter_type = parameter_type
        self._code = compile(expression, "<theta>", "eval")

    def evaluate(self, mu: Mu):
        ns = dict(_EXPR_NAMESPACE)
        if self.parameter_type:
            for k, shape in self.parameter_type.items():
                shape = _normalize_shape(shape)
                v = _lane_view(mu[k], shape)
                lanes = v.shape[:v.ndim - len(shape)]
                ns[k] = v.reshape(lanes) if int(np.prod(shape) or 1) == 1 else v
        for k, v in (mu or {}).items():
            if k not in ns:
                va = _as_tensor(v)
                ns[k] = va.reshape(()) if va.numel() == 1 else va
        val = eval(self._code, {"__builtins__": {}}, ns)
        val = _as_tensor(val)
        if val.dtype == torch.bool:
            val = val.to(torch.float64)
        return val

    def __repr__(self):
        return f"Expr({self.expression!r})"


class ProjectionParameterFunctional(ParameterFunctional):
    """theta(mu) = mu[component_name][coordinates]."""

    def __init__(self, component_name: str, component_shape, coordinates: Tuple[int, ...]):
        self.component_name = component_name
        self.component_shape = _normalize_shape(component_shape)
        self.coordinates = tuple(int(c) for c in coordinates)
        self.parameter_type = {component_name: self.component_shape}

    def evaluate(self, mu: Mu):
        v = _lane_view(mu[self.component_name], self.component_shape)
        return v[(Ellipsis,) + self.coordinates]

    def __repr__(self):
        return f"Proj({self.component_name}{list(self.coordinates)})"


class ProductParameterFunctional(ParameterFunctional):
    """Product of functionals and/or numbers."""

    def __init__(self, factors: Sequence[Union[ParameterFunctional, float, int]]):
        self.factors = list(factors)
        pt: Dict[str, Tuple[int, ...]] = {}
        for f in self.factors:
            if isinstance(f, ParameterFunctional) and f.parameter_type:
                pt.update(f.parameter_type)
        self.parameter_type = pt or None

    def evaluate(self, mu: Mu):
        val = torch.tensor(1.0, dtype=torch.float64)
        for f in self.factors:
            val = val * (_as_tensor(f.evaluate(mu)) if isinstance(f, ParameterFunctional)
                         else float(f))
        return val

    def __repr__(self):
        return "Prod(" + ", ".join(map(repr, self.factors)) + ")"


def as_functional(coeff) -> ParameterFunctional:
    if isinstance(coeff, ParameterFunctional):
        return coeff
    return ConstantParameterFunctional(float(coeff))


def _mu_device(mu) -> torch.device:
    """The device of mu's first tensor, else the port's default device."""
    for v in (mu or {}).values():
        if isinstance(v, torch.Tensor):
            return v.device
    return _device(None)


def evaluate_coefficients(coeffs: Sequence, mu: Mu, dtype=torch.float64,
                          device=None) -> torch.Tensor:
    """Stack theta_q(mu) into ``[Q]``, or ``[B, Q]`` for lane-batched mu
    (constant functionals broadcast over the lanes)."""
    device = _mu_device(mu) if device is None else torch.device(device)
    vals = [_on(as_functional(c).evaluate(mu), device, dtype) for c in coeffs]
    return torch.stack(torch.broadcast_tensors(*vals), dim=-1)


def _on(v, device, dtype) -> torch.Tensor:
    """``v`` on ``device`` in ``dtype``.  A host scalar (a constant
    coefficient) is filled there: a copy from pageable host memory would
    make the host wait for the device."""
    v = _as_tensor(v)
    if v.ndim == 0 and v.device.type == "cpu" and device.type != "cpu":
        return torch.full((), v.item(), dtype=dtype, device=device)
    return v.to(device=device, dtype=dtype)


def merge_parameter_types(*pts: ParameterType) -> ParameterType:
    """Union of parameter types (a later type's shape wins); None if empty."""
    out: Dict[str, Tuple[int, ...]] = {}
    for pt in pts:
        if pt:
            for k, v in pt.items():
                out[k] = _normalize_shape(v)
    return out or None


class CubicParameterSpace:
    """Hypercube parameter space with uniform/random sampling."""

    def __init__(self, parameter_type: ParameterType, minimum: float, maximum: float):
        self.parameter_type = {k: _normalize_shape(v) for k, v in (parameter_type or {}).items()}
        self.minimum = float(minimum)
        self.maximum = float(maximum)

    @property
    def _keys(self):
        return sorted(self.parameter_type.keys())

    @property
    def dim(self) -> int:
        return sum(int(np.prod(s) or 1) for s in self.parameter_type.values())

    def sample_uniformly(self, counts: int):
        """Cartesian grid of `counts` points per scalar component."""
        import itertools
        pts = np.linspace(self.minimum, self.maximum, counts)
        return [self._from_flat(np.asarray(c))
                for c in itertools.product(pts, repeat=self.dim)]

    def sample_randomly(self, count: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        return [self._from_flat(rng.uniform(self.minimum, self.maximum, self.dim))
                for _ in range(count)]

    def _from_flat(self, flat: np.ndarray) -> Mu:
        out = {}
        off = 0
        for k in self._keys:
            shape = self.parameter_type[k]
            n = int(np.prod(shape) or 1)
            out[k] = torch.as_tensor(flat[off:off + n].reshape(shape))
            off += n
        return out

    def parse_parameter(self, mu) -> Mu:
        return parse_parameter(self.parameter_type, mu)
