"""pylrbms_tpu_torch — the PyTorch/CUDA port of :mod:`pylrbms_tpu`.

The JAX package stays the reference; this package mirrors its module layout
for the ported slice (the OS2015 2D tri P1 block-SWIPDG online step:
discretize -> ``make_online_step`` -> single or batched queries, and the
detailed solve, with the matrix-free stencil operator at scale) and runs
on an NVIDIA H100 with two hand-written CUDA kernels
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
"""
