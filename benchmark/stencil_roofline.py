"""The benchmark's own count of the stencil apply's work (``y = A(theta_b)
x_b`` for every lane b, the operator held as per-cell and per-face blocks)
and its bound on the card.

Counts follow the mathematics of the apply and not the route the program
takes, so an apply built another way (fused, or folding the diagonal face
blocks into the cell blocks) reads against the same bound:

* operations: 2 per multiply-add of the block product, one nb x nb block
  per cell (its own, the volume and every face term on it folded) and two
  per face between cells (minus to plus and plus to minus): ``2 B nb^2
  (C + 2 F)`` for B lanes, C cells and F inner faces (subdomain interfaces
  among them; boundary faces fold into their cell's block);
* bytes: each input read once and each output written once: the Q affine
  component stencils once an apply (``Q nb^2 (C + 2 F)`` numbers), x read
  and A x written once a lane (``2 B K N``), and theta (``B Q``).

Peaks (NVIDIA's data sheet, H100 SXM at 700 W): HBM3 at 3.35 TB/s
(``roofline.HBM_BYTES_PER_S``); 67 TFLOP/s for float32 outside the tensor
cores, the rate of a multiply and a sum that are no matrix product
(``roofline.PEAK_OPS_PER_S["float32"]`` is the TF32 tensor rate).
"""
from __future__ import annotations

from .roofline import BYTES, HBM_BYTES_PER_S, _name

F32_SIMT_OPS_PER_S = 67e12


def mesh_counts(space) -> tuple:
    """(C, F): the cells of a 2D or 3D block space (triangles count one
    each) and its inner faces, subdomain interfaces included."""
    g = space.grid
    if getattr(space, "dim", 2) == 3:
        nx, ny, nz = g.global_nx, g.global_ny, g.global_nz
        return (nx * ny * nz,
                (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1))
    nx, ny, T = g.global_nx, g.global_ny, space.T
    # T = 2: the two triangles of a square share its diagonal
    return T * nx * ny, (T - 1) * nx * ny + (nx - 1) * ny + nx * (ny - 1)


def counts(C: int, F: int, nb: int, Q: int, K: int, N: int, mdt, vdt, B: float):
    """(operations, bytes) of one apply to B lanes."""
    blocks = nb * nb * (C + 2 * F)
    ops = 2 * B * blocks
    nbytes = Q * blocks * BYTES[_name(mdt)] + (2 * B * K * N + B * Q) * BYTES[_name(vdt)]
    return ops, nbytes


def bound_s(*shape) -> float:
    """Least seconds the card could take for one apply (``counts``' arguments)."""
    ops, nbytes = counts(*shape)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_SIMT_OPS_PER_S)


def shape_of(system):
    """``counts``' arguments but the lanes for the stencil step of a
    ``benchmark.system.OnlineStep``, or None when it holds no stencils."""
    stencils = system.step.arrays.get("stencils") if system.step is not None else None
    if not stencils:
        return None
    sp = system.model.space
    C, F = mesh_counts(sp)
    return C, F, sp.nb, len(stencils), sp.K, sp.N, stencils[0].vol.dtype, system.dtype
