"""The studies too long for ``chip_smoke.py``'s time limit, on the card: each
script run as its own process, timed, its output kept under
``results_out/long_studies/`` and held to its ``docs/results/`` file where
the file has a table for it.

* ``spe10_3d --subdomains 8 8 4 --half 3 --nref 1 --xl`` (442 368 dofs):
  the restarted PCG's relative residual <= 1e-8 (its own target); the
  iterations printed beside the file's (``spe10_3d_tpu.txt``);
* ``spe10_efficiency_study --deep``: its two tables against the file's
  ``--deep`` tables (``spe10_efficiency_study.txt``), every printed cell to
  one unit in its last digit, eta_r at rounding level;
* ``spe10_3d_efficiency_study --finer-ref --truth-file
  docs/results/ref442k.npz``: the file records no such table, so the run
  is only required to finish.

    python -m pylrbms_tpu_torch.scripts.long_studies [xl deep finer_ref]

Runs on the current CUDA device (each study raises without CUDA).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time

from . import _results as R

OUT = "results_out/long_studies"
STUDIES = {
    "xl": ["spe10_3d", "--subdomains", "8", "8", "4", "--half", "3", "--nref", "1", "--xl"],
    "deep": ["spe10_efficiency_study", "--deep"],
    "finer_ref": ["spe10_3d_efficiency_study", "--finer-ref", "--truth-file",
                  os.path.join(R.RESULTS_DIR, "ref442k.npz")],
}


def _hold_xl(text):
    m = re.search(r"(\d+) CG iterations, rel residual ([0-9.e+-]+)", text)
    if m is None:
        return ["xl: no solve line in the output"]
    its, relres = int(m.group(1)), float(m.group(2))
    fname, line, text_its = R.TPU_COUNTS["spe10_3d.xl.its"]
    print(f"  xl: {its} iterations (the file's {text_its}, {fname}:{line}; not held), "
          f"relres {relres:.1e} (<= 1e-8)")
    return [] if relres <= 1e-8 else [f"xl: relres {relres!r} > 1e-8"]


def _hold_deep(text):
    fname = "spe10_efficiency_study.txt"
    run, ref = R.parse_tables(text), R.parse_tables(R.read(fname))[2:4]
    if len(run) != len(ref):
        return [f"deep: {len(run)} tables against the file's {len(ref)}"]
    bad = []
    for i, (t, f) in enumerate(zip(run, ref)):
        rows = [{n: (c if "/" in c or set(c) == {"-"} else float(c))
                 for n, c in zip(t.header, r)} for r in t.rows]
        bad += R.check_rows(f, rows, f"deep table {i}", rounding=R.ROUNDING_LEVEL[fname])
    print(f"  deep: {sum(len(t.rows) for t in run)} rows against {fname}'s --deep tables: "
          f"{'ok' if not bad else f'{len(bad)} off'}")
    return bad


HOLD = {"xl": _hold_xl, "deep": _hold_deep, "finer_ref": lambda text: []}


def main(names=None):
    os.makedirs(OUT, exist_ok=True)
    failed = []
    for name in names or list(STUDIES):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"pylrbms_tpu_torch.scripts.{STUDIES[name][0]}",
                            *STUDIES[name][1:]], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        with open(os.path.join(OUT, f"{name}.log"), "w") as f:
            f.write(r.stdout + r.stderr)
        bad = HOLD[name](r.stdout) if r.returncode == 0 else [f"{name}: exit {r.returncode}"]
        print(f"{name}: {seconds:.2f} s, exit {r.returncode}, {'ok' if not bad else 'FAILED'}",
              flush=True)
        for b in bad[:20]:
            print(f"    {b}")
        failed += bad
    return failed


if __name__ == "__main__":
    sys.exit(1 if main(sys.argv[1:]) else 0)
