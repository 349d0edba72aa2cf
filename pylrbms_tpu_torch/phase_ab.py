"""Seconds of chosen ``chip_smoke.py`` phases in one checkout, on one GPU.

    cd CHECKOUT && PYTHONPATH=. python3 PATH/TO/phase_ab.py LABEL 12,22,26,27

Run by path from the root of any checkout, this file's own or an older one
(it imports that checkout's ``chip_smoke`` and ``pylrbms_tpu_torch`` and
builds its kernels).  Runs phases 12 (parabolic scale), 22 (3D MOR), 26
(distributed) and 27 (scripts), or the ones named, each through
``chip_smoke.run_phase`` (seconds and peak device memory, every gate of the
phase held), and prints the launches per path.  To compare two commits in
one call, unpack the parent with ``git archive`` into a gitignored
directory and run this file from both roots in turns (parent, change,
change, parent).  Exits non-zero without CUDA.
"""
from __future__ import annotations

import sys
import time

import torch


def main(argv=None) -> int:
    label, which = (argv or sys.argv[1:])[:2]
    if not torch.cuda.is_available():
        print("phase_ab: CUDA is not available; this probe runs only on a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs                              # the checkout's smoke run
    from pylrbms_tpu_torch.ops import hopper_kernels as hk
    from pylrbms_tpu_torch.utils.precision import pin_precision

    pin_precision()
    smi = cs.smi_line()
    t0 = time.perf_counter()
    hk.build()
    hk.load()
    print(f"{label} build {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    dev = torch.device("cuda", 0)
    phases = {"12": ("parabolic scale", cs.parabolic_scale_phase),
              "22": ("3D MOR", cs.mor3d_phase)}
    paths = {}
    for ph in which.split(","):
        name = f"{label} {ph}"
        if ph in phases:
            path, fn = phases[ph]
            paths[path] = cs.run_phase(torch, dev, name, fn, hk, torch, dev, smi)
        elif ph == "26":
            cs.run_phase(torch, dev, name, cs.distributed_phase, hk, torch, dev, smi, paths)
        elif ph == "27":
            cs.run_phase(torch, dev, name, cs.scripts_phase, hk, torch, dev, smi, paths)
        else:
            raise ValueError(f"phase_ab: no phase {ph!r} (12, 22, 26, 27)")
    print(f"{label} launches: { {k: v[0] for k, v in paths.items()} }", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
