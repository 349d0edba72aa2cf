"""Entry points of the port: the one-card online step and the multi-rank dry run.

The port of the repository's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, example_args)``: one LRBMS online step of the
  OS2015 block SWIPDG model (2x2 subdomains, half 1, nref 1, f32) —
  assemble theta(mu), block-Jacobi PCG at tol 1e-8 (maxiter 500), the
  localized estimate (U and the per-subdomain indicators).  ``fn(theta,
  theta_f)`` takes the OS2015 thetas ``(1, mu)`` and ``(1,)``.
* :func:`dryrun_multichip` runs the K-sharded dry run
  (``scripts/dryrun_multichip``) on ``n_devices`` ranks.

Both run on the card unless ``device="cpu"`` is passed::

    from pylrbms_tpu_torch.graft_entry import entry
    fn, args = entry()
    U, indicators = fn(*args)
"""
from __future__ import annotations

import torch

from .utils.precision import device as _device


def _build(kx, ky, half, nref, dtype, device):
    from .discretize_elliptic_block_swipdg import discretize
    from .problems.os2015 import init_grid_and_problem
    gpd = init_grid_and_problem({"num_subdomains": [kx, ky],
                                 "half_num_fine_elements_per_subdomain_and_dim": half,
                                 "num_refinements": nref})
    d, _ = discretize(gpd, device=device, dtype=dtype)
    return d


def _online_step(d, tol=1e-8, maxiter=500):
    """``(theta, theta_f) -> (U, indicators)`` with OS2015's mu read off
    theta = (1, mu); ``step.iters_probe(theta, theta_f)`` gives the PCG
    iterations of that solve."""
    from .model import make_online_step
    inner = make_online_step(d, tol=tol, maxiter=maxiter)

    def step(theta, theta_f):
        return inner(theta, theta_f, {"diffusion": theta[1:2]})

    step.iters_probe = inner.iters_probe
    return step


def entry(device=None, dtype=torch.float32):
    """-> ``(fn, example_args)``: one online FOM step on ``device`` (None:
    the current card; raises without CUDA).  ``dtype`` is the reference's
    f32 unless a caller asks for another."""
    dev = _device(device)
    d = _build(2, 2, 1, 1, dtype, dev)
    fn = _online_step(d)
    mu = 0.5
    example_args = (torch.tensor([1.0, mu], dtype=dtype, device=dev),
                    torch.tensor([1.0], dtype=dtype, device=dev))
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None, backend: str = None):
    """The K-sharded dry run (``scripts/dryrun_multichip.run``, preset
    'small') on ``n_devices`` ranks sharing ``device`` (None: the current
    card) over ``backend`` (None: nccl on CUDA, gloo on the CPU; several
    ranks on one card need 'gloo').  Returns the ranks' payloads; raises on
    a failed leg or rank."""
    from .scripts.dryrun_multichip import run
    return run(n_devices, device=device, backend=backend)
