"""How often a process's first MKL vector-math call, made by several intra-op
threads at once, comes out of another kernel than the one torch asks for.

Each child process sets ``--threads`` intra-op threads and makes its first
call of ``torch.cos`` on a float64 tensor of ``2048 * threads``
elements, which torch's CPU build hands to MKL's VML in chunks of 2048, one
chunk per thread and all at once.  The child holds the result against
VML's high-accuracy kernel called afterwards on one thread.  With
``--import-port`` the child imports ``pylrbms_tpu_torch`` first, whose
import makes the first call of each VML-backed function on one element
(``utils.precision.init_cpu_vector_math``).  The mismatching elements are
also held against MKL's AVX2 enhanced-performance kernel, run in a process
restricted to AVX2.

    python -m pylrbms_tpu_torch.scripts.vml_first_call --processes 640 --threads 8
    python -m pylrbms_tpu_torch.scripts.vml_first_call --processes 640 --threads 8 --import-port

Needs torch's CPU build with MKL (the VML entry points in libtorch_cpu).
Prints one JSON line: processes run, mismatches, and how many of those
equal the AVX2 enhanced-performance kernel bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# VML's float64 cosine is called through its Fortran entry point (exported by
# libtorch_cpu) with an explicit accuracy mode: 2 high accuracy (the mode
# torch asks for), 3 enhanced performance
VML_EP = 3

CHILD = r"""
import ctypes, os, sys
import numpy as np
import torch
threads, port, out = int(sys.argv[1]), sys.argv[2] == "1", sys.argv[3]
torch.set_num_threads(threads)
if port:
    import pylrbms_tpu_torch  # noqa: F401
x = torch.linspace(-1.5, 1.5, 2048 * threads, dtype=torch.float64)
y = torch.cos(x)
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
a = x.numpy().copy()
r = np.empty_like(a)
lib.VMDCOS_(ctypes.byref(ctypes.c_int(a.size)), a.ctypes.data_as(ctypes.c_void_p),
            r.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ctypes.c_longlong(2)))
if not np.array_equal(y.numpy(), r):
    np.savez(out, x=a, y=y.numpy(), ha=r)
"""

KERNEL = r"""
import ctypes, os, sys
import numpy as np
import torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
d = np.load(sys.argv[1])
a = np.ascontiguousarray(d["x"])
r = np.empty_like(a)
lib.VMDCOS_(ctypes.byref(ctypes.c_int(a.size)), a.ctypes.data_as(ctypes.c_void_p),
            r.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ctypes.c_longlong(int(sys.argv[2]))))
np.save(sys.argv[3], r)
"""


def vml_cos(x, mode: int, instructions: str):
    """VML's cosine at accuracy ``mode`` on ``x``, in a process whose MKL is
    restricted to ``instructions`` (e.g. 'AVX2')."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/in.npz", x=x)
        subprocess.run([sys.executable, "-c", KERNEL, f"{tmp}/in.npz", str(mode),
                        f"{tmp}/out.npy"], check=True,
                       env=dict(os.environ, MKL_ENABLE_INSTRUCTIONS=instructions))
        return np.load(f"{tmp}/out.npy")


def main(argv=None) -> int:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=320)
    ap.add_argument("--parallel", type=int, default=16, help="children run at once")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--import-port", action="store_true")
    args = ap.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    bad, ep, done = 0, 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        while done < args.processes:
            n = min(args.parallel, args.processes - done)
            outs = [f"{tmp}/bad_{done + i}.npz" for i in range(n)]
            procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(args.threads),
                                       "1" if args.import_port else "0", out], env=env)
                     for out in outs]
            for p in procs:
                if p.wait() != 0:
                    raise RuntimeError("a child process failed")
            done += n
            for out in outs:
                if os.path.exists(out):
                    bad += 1
                    d = np.load(out)
                    off = d["y"] != d["ha"]
                    r = vml_cos(d["x"], VML_EP, "AVX2")
                    ep += int(bool(np.array_equal(d["y"][off], r[off])))
    print(json.dumps({"threads": args.threads,
                      "import_port": args.import_port, "processes": done,
                      "mismatches": bad, "mismatches_from_avx2_ep_kernel": ep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
