"""Checkpoint / resume of offline MOR state (the port's own copy of
``pylrbms_tpu/utils/checkpoint.py``; numpy only).

Absent in the reference (SURVEY.md §5.4: "Offline results (bases, reduced
ops) are never persisted") but required for greedy at SPE10 scale.  Stores
the local bases + metadata as an .npz; `save_reductor`/`load_reductor`
round-trip an LRBMSReductor against an existing model.
"""
from __future__ import annotations

import json

import numpy as np


def save_reductor(reductor, path: str):
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {f"basis_{ii}": b for ii, b in enumerate(reductor.bases)}
    meta = {"K": len(reductor.bases),
            "sizes": [int(b.shape[0]) for b in reductor.bases],
            "N": int(reductor.d.space.N)}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def load_reductor(d, path: str, products=None, solver_options=None):
    from ..reductor import LRBMSReductor
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as zz:
        meta = json.loads(str(zz["__meta__"]))
        bases = [zz[f"basis_{ii}"] for ii in range(meta["K"])]
    assert meta["N"] == d.space.N, "checkpoint does not match the discretization"
    return LRBMSReductor(d, bases=bases, products=products,
                         solver_options=solver_options, order=None)


def save_greedy_state(reductor, path: str, *, it: int, retired, max_etas,
                      chosen_idx):
    """Greedy resume point: local bases + selection state, one atomic .npz
    per iteration (overwrites).  Lets an interrupted SPE10-scale offline run
    continue without redoing FOM snapshot solves."""
    import os
    import tempfile
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {f"basis_{ii}": b for ii, b in enumerate(reductor.bases)}
    meta = {"K": len(reductor.bases),
            "sizes": [int(b.shape[0]) for b in reductor.bases],
            "N": int(reductor.d.space.N), "it": int(it)}
    fd, tmp = tempfile.mkstemp(suffix=".npz",
                               dir=os.path.dirname(path) or ".")
    os.close(fd)
    np.savez_compressed(tmp, __meta__=json.dumps(meta),
                        __retired__=np.asarray(retired, dtype=bool),
                        __max_etas__=np.asarray(max_etas, dtype=np.float64),
                        __chosen_idx__=np.asarray(chosen_idx, dtype=np.int64),
                        **arrays)
    os.replace(tmp, path)
    return path


def load_greedy_state(d, path: str, products=None, solver_options=None,
                      cls=None):
    """-> (reductor, it, retired, max_etas, chosen_idx).

    ``cls``: reductor class to rebuild (default ``LRBMSReductor``; the
    parabolic POD-greedy resumes with ``ParabolicLRBMSReductor``)."""
    if cls is None:
        from ..reductor import LRBMSReductor as cls
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as zz:
        meta = json.loads(str(zz["__meta__"]))
        bases = [zz[f"basis_{ii}"] for ii in range(meta["K"])]
        retired = np.asarray(zz["__retired__"], dtype=bool)
        max_etas = list(np.asarray(zz["__max_etas__"], dtype=float))
        chosen_idx = list(np.asarray(zz["__chosen_idx__"], dtype=int))
    assert meta["N"] == d.space.N, "checkpoint does not match the discretization"
    red = cls(d, bases=bases, products=products,
              solver_options=solver_options, order=None)
    return red, int(meta["it"]), retired, max_etas, chosen_idx
