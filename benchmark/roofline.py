"""The benchmark's own count of a hand kernel's work and the card's peaks.

Counts follow the mathematics of the call and not the route the kernel
takes, so a kernel built another way reads against the same bound:

* operations: 2 per multiply-add of ``y = sum_g coef_g A_g x``
  (block_matvec) or of ``z = F r`` and ``rz = r . z`` (precond_dot);
* bytes: each input read once and each output written once, at the dtypes
  the step passes in.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 at
3.35 TB/s; dense TF32 tensor rate (495 TFLOP/s) for f32 vectors, f64
tensor rate (67 TFLOP/s) for f64 vectors.  The program's own
``hopper_kernels.bound`` triples the f32 operations for the 3xTF32 split its
kernels use today; this bound does not, so it does not move when the split
does.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "float64": 67e12}
BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def counts(kernel: str, G: int, K: int, N: int, B: int, mdt, vdt):
    """(operations, bytes) of one launch."""
    sm, sv = BYTES[_name(mdt)], BYTES[_name(vdt)]
    if kernel == "block_matvec":
        ops = 2 * G * K * N * N * B
        nbytes = G * K * N * N * sm + 2 * B * K * N * sv + (B * G * sv if G > 1 else 0)
    elif kernel == "precond_dot":
        ops = 2 * K * N * N * B + 2 * K * N * B
        nbytes = K * N * N * sm + 2 * B * K * N * sv + B * K * sv
    else:
        raise ValueError(f"no count for kernel {kernel!r}")
    return ops, nbytes


def bound_s(kernel: str, G: int, K: int, N: int, B: int, mdt, vdt) -> float:
    """Least seconds the card could take for one launch."""
    ops, nbytes = counts(kernel, G, K, N, B, mdt, vdt)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[_name(vdt)])


def share_pct(kernel: str, launches: dict, n_events: int, device_s: float):
    """Percent of the roofline: the mean bound of the kernel's launches
    (``{signature: launches}``, program counters over the traced window)
    over the mean device time of its ``n_events`` events in the trace.
    None when either side saw nothing."""
    n = sum(launches.values())
    if n == 0 or n_events == 0 or device_s <= 0:
        return None
    bound = sum(c * bound_s(kernel, *sig) for sig, c in launches.items())
    return 100.0 * (bound / n) / (device_s / n_events)
