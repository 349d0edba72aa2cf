"""Carry tensors from numpy into the port.

:func:`arrays_from_numpy` turns the reference online step's tensors
(``step.arrays`` of ``pylrbms_tpu.model.make_online_step``, each taken as
``np.asarray`` by the caller) into torch tensors on a given device and
dtype, :func:`stencils_from_numpy` its affine stencils
(``step.arrays["stencils"]``, or a stencil operator's ``.stencils``) and
:func:`precond_from_numpy` the frozen preconditioner ``(bf, C, ci)`` of the
reference's matrix-free model solve, :func:`bases_from_numpy` the local
reduced bases of a reference reductor and :func:`reduced_from_numpy` the
tensors of a reference ``ReducedModel``, so that both implementations can
be fed identical state, and :func:`instationary_from_numpy` builds the
port's implicit-Euler model from a reference model's time grid and mass.
This module imports no jax: array leaves are read with
``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype) -> torch.Tensor:
    """One array -> tensor in ``dtype``; ``ml_dtypes`` bfloat16 stays bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.tensor(a).to(dtype).to(device)


def arrays_from_numpy(d: dict, device=None, dtype=torch.float64) -> dict:
    """{name: float numpy array} -> {name: tensor} in ``dtype``, except
    bfloat16 arrays (``ml_dtypes`` bfloat16, e.g. bf16-stored block-Jacobi
    factors), which stay bfloat16."""
    return {name: _tensor(a, device, dtype) for name, a in d.items()}


def stencils_from_numpy(stencils, device=None, dtype=torch.float64) -> tuple:
    """A sequence of stencils (objects with the ``SwipdgStencil`` fields
    vol, D, V, H, R, U, or the 3D ``SwipdgStencil3`` fields vol, X, Y, Z,
    IX, IY, IZ — tuples of 4 arrays — and the D_side dict) -> a tuple of
    the port's :class:`~pylrbms_tpu_torch.ops.matrixfree.SwipdgStencil` or
    :class:`~pylrbms_tpu_torch.ops.matrixfree3d.SwipdgStencil3`."""
    from .ops.matrixfree import SwipdgStencil
    from .ops.matrixfree3d import SwipdgStencil3

    def conv(a):
        return _tensor(a, device, dtype)

    def one(s):
        cls, fams = ((SwipdgStencil3, ("X", "Y", "Z", "IX", "IY", "IZ"))
                     if hasattr(s, "IX") else (SwipdgStencil, ("D", "V", "H", "R", "U")))
        return cls(vol=conv(s.vol),
                   **{f: tuple(conv(a) for a in getattr(s, f)) for f in fams},
                   D_side={k: conv(a) for k, a in s.D_side.items()})

    return tuple(one(s) for s in stencils)


def precond_from_numpy(pre, device=None, dtype=torch.float64) -> tuple:
    """The frozen matrix-free preconditioner ``(block factors, coarse basis,
    coarse inverse)`` -> tensors; None entries (one-level) stay None."""
    return tuple(None if a is None else _tensor(a, device, dtype) for a in pre)


def bases_from_numpy(d, bases, **kwargs):
    """A reference ``LRBMSReductor.bases`` list (one ``[r_k, N]`` array per
    subdomain, each taken as ``np.asarray``) -> an
    :class:`~pylrbms_tpu_torch.reductor.LRBMSReductor` on the model ``d``
    with the same bases (no shape functions are added)."""
    from .reductor import LRBMSReductor
    return LRBMSReductor(d, bases=[np.asarray(b, np.float64) for b in bases],
                         order=None, **kwargs)


def reduced_from_numpy(reductor, fields: dict):
    """The array fields of a reference ``ReducedModel``
    (``ReducedModel._ARRAY_FIELDS`` as numpy; absent or None Gramians stay
    None; ``"parabolic"``, a dict of the projected parabolic tensors, when
    present) -> a :class:`~pylrbms_tpu_torch.reductor.ReducedModel` over
    ``reductor``, in float64 on its model's device.  With ``"M_red"`` (the
    reduced mass of a reference ``ReducedParabolicModel``) the result is a
    :class:`~pylrbms_tpu_torch.reductor.ReducedParabolicModel` around it.
    The padded width is read off ``A_red``; the sizes are the reductor's."""
    from .reductor import ReducedModel, ReducedParabolicModel
    d = reductor.d
    K = d.space.K
    r_max = int(np.asarray(fields["A_red"]).shape[-1]) // K
    nbhd_idx, _, _ = reductor._bucket_rows(d.grid, K, r_max)

    def conv(a):
        return None if a is None else _tensor(a, d.device, torch.float64)

    tensors = {n: conv(fields.get(n)) for n in ReducedModel._ARRAY_FIELDS}
    pb = fields.get("parabolic")
    rd = ReducedModel(reductor=reductor, sizes=reductor.basis_sizes(), r_max=r_max,
                      nbhd_idx=nbhd_idx, **tensors,
                      parabolic=None if pb is None else {k: conv(v) for k, v in pb.items()})
    if fields.get("M_red") is None:
        return rd
    return ReducedParabolicModel(rd, conv(fields["M_red"]))


def instationary_from_numpy(stationary, T: float, nt: int, mass=None):
    """The port's :class:`~pylrbms_tpu_torch.model.InstationaryBlockModel`
    on the port's ``stationary`` model with a reference model's time grid
    ``(T, nt)`` and its mass (``[K, N, N]`` as numpy; None: the stationary
    model's L2 product)."""
    from .model import InstationaryBlockModel
    return InstationaryBlockModel(
        stationary=stationary, T=float(T), nt=int(nt),
        mass=None if mass is None else _tensor(mass, stationary.device, stationary.dtype))
