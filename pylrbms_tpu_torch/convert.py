"""Carry tensors from numpy into the port.

:func:`arrays_from_numpy` turns the reference online step's tensors
(``step.arrays`` of ``pylrbms_tpu.model.make_online_step``, each taken as
``np.asarray`` by the caller) into torch tensors on a given device and
dtype, so that both implementations can be fed identical state.  This
module imports no jax: the caller hands it numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def arrays_from_numpy(d: dict, device=None, dtype=torch.float64) -> dict:
    """{name: float numpy array} -> {name: tensor} in ``dtype``, except
    bfloat16 arrays (``ml_dtypes`` bfloat16, e.g. bf16-stored block-Jacobi
    factors), which stay bfloat16."""
    out = {}
    for name, a in d.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(a).to(dtype)
        out[name] = t.to(device)
    return out
