"""pylrbms_tpu_torch — the PyTorch/CUDA port of :mod:`pylrbms_tpu`.

The JAX package stays the reference; this package mirrors its module layout
for the ported slices (2D tri P1 block SWIPDG): discretize ->
``make_online_step`` -> single or batched queries, and the detailed solve,
with the matrix-free stencil operator at scale; the localized reduced basis
method on top (``reductor.LRBMSReductor`` / ``ReducedModel``,
``greedy.weak_greedy``, ``online_enrichment.AdaptiveEnrichment`` with the
batched patch correctors of ``ops/corrector.py``); the OS2015 and SPE10
problems and the monolithic K=1 discretizer.  It runs on an NVIDIA H100
with two hand-written CUDA kernels
(:mod:`pylrbms_tpu_torch.ops.hopper_kernels`).

Rules of the package: it imports ``torch`` and neither ``jax`` nor
``pylrbms_tpu``; it keeps its own copies of the reference's numpy host
modules (``grid``, ``basis``, ``quadrature``, ``config``, ``ops.spaces``) for
the static index tables; every constructor and entry point takes
``device=`` and ``dtype=``, and the device defaults to ``cuda`` (pass
``device="cpu"`` on a machine without a card).

Typical use::

    from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize
    from pylrbms_tpu_torch.model import make_online_step
    d, _ = discretize(init_grid_and_problem(cfg), device="cuda",
                      dtype=torch.float32)
    step = make_online_step(d, matrix_free="affine")
    U, indicators = step(thetas, theta_fs, {"diffusion": mus})

    from pylrbms_tpu_torch.greedy import weak_greedy
    d64, _ = discretize(init_grid_and_problem(cfg), device="cuda")
    res = weak_greedy(d64, d64.parameter_space.sample_uniformly(6))
    c, eta, indicators = res.rd.online_step(0.5)
"""
from .utils.precision import init_cpu_vector_math

init_cpu_vector_math()
