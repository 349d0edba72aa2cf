"""The result files of ``docs/results/`` as numbers the port is held to.

Two kinds of file:

* written on the CPU in float64 (the OS2015 tables, ``P2_``,
  ``academic3d_``, ``q2_3d_``, ``parabolic_convergence_``, the SPE10
  efficiency studies, ``golden_gap_attribution.md``): their tables are
  parsed here (:func:`parse_tables`, :func:`parse_markdown_tables`,
  :func:`parse_labelled`), and :func:`check_rows` holds a run's values to
  every value cell to its printed digits (``|a - b|`` at most one unit in
  the last printed digit of ``b``) and every EOC cell to +-0.02;
* written on a TPU (``*_tpu.txt``, ``spe10_3d_enrichment_to_target.txt``,
  ``xl_sharded_virtual.txt``): only their accuracy values are held, from
  :data:`TPU_VALUES`, each with the file and line it comes from.  A
  ``"value"`` is an estimate, error or ROM-vs-FOM quantity that the same
  mathematics reproduces: held at ``rtol``.  A ``"bound"`` is a solver's
  stopping residual or an agreement measure at solver level (a relres
  under a tolerance, a lane against its single solve): it depends on the
  iteration a solver stopped at and on its route (the TPU runs polished
  some solves in f64 after f32 inner iterations, ``ops/ir.py``, where the
  port takes the JAX package's CPU branch, f64 PCG), so the port's value
  is held to the bound the solve guarantees, each stated beside it (the
  file's own value passes it).  Counts and times are never held.

Nothing here writes into ``docs/results/``.
"""
from __future__ import annotations

import contextlib
import math
import os
import re
from typing import Dict, List, Optional, Sequence

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                           "docs", "results")

_NUM = r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"
_CELL = re.compile(rf"^(?:{_NUM}|nan|inf|-+|\d+(?:/\d+)+)$")
_EOC_NAMES = ("EOC", "eoc")


def read(name: str) -> str:
    with open(os.path.join(RESULTS_DIR, name)) as f:
        return f.read()


class Table:
    """One parsed table: column names (an EOC column is named
    ``'EOC:<column before it>'``), the rows' cells as printed, and the
    1-based line of its first row in the file."""

    def __init__(self, header: List[str], rows: List[List[str]], line: int):
        self.header, self.rows, self.line = header, rows, line

    def __repr__(self):
        return f"Table(line {self.line}, {len(self.rows)} rows, {self.header})"


def _name_columns(names: Sequence[str]) -> List[str]:
    out, last = [], None
    for n in names:
        if n in _EOC_NAMES or n.startswith("EOC("):
            out.append(f"EOC:{last}")
        else:
            out.append(n)
            last = n
    return out


def _is_row(line: str) -> bool:
    toks = line.split()
    return len(toks) >= 3 and all(_CELL.match(t) for t in toks) \
        and not all(set(t) == {"-"} for t in toks)


def parse_tables(text: str) -> List[Table]:
    """Every whitespace-aligned table of ``text``: a run of rows whose cells
    are all numbers (or ``nan``, ``--``/``----``, level info ``32/4``), under
    a header line (a dashed rule between them is skipped).  Columns are
    right-aligned: the header is cut at the end of each cell of the first
    row, so a name with a space (``energy err``) stays one name."""
    lines = text.splitlines()
    tables, i = [], 0
    while i < len(lines):
        if not _is_row(lines[i]):
            i += 1
            continue
        j = i
        while j < len(lines) and _is_row(lines[j]) and \
                len(lines[j].split()) == len(lines[i].split()):
            j += 1
        h = i - 1
        if h >= 0 and set(lines[h].strip()) <= {"-", " "} and lines[h].strip():
            h -= 1
        head = lines[h] if h >= 0 else ""
        ends = [m.end() for m in re.finditer(r"\S+", lines[i])]
        starts = [0] + ends[:-1]
        names = [head[a:b].strip() for a, b in zip(starts, ends)]
        tables.append(Table(_name_columns(names), [lines[k].split() for k in range(i, j)],
                            i + 1))
        i = j
    return tables


def parse_markdown_tables(text: str) -> List[Table]:
    """Every ``| a | b |`` table of a markdown text (the rule row skipped)."""
    lines = text.splitlines()
    tables, i = [], 0
    cells = lambda s: [c.strip() for c in s.strip().strip("|").split("|")]  # noqa: E731
    while i < len(lines):
        if lines[i].lstrip().startswith("|") and i + 1 < len(lines) \
                and re.match(r"^\s*\|(\s*-+\s*\|)+\s*$", lines[i + 1]):
            head, j = cells(lines[i]), i + 2
            rows = []
            while j < len(lines) and lines[j].lstrip().startswith("|"):
                rows.append(cells(lines[j]))
                j += 1
            tables.append(Table(head, rows, i + 3))
            i = j
        else:
            i += 1
    return tables


def parse_labelled(text: str) -> Dict[str, List[str]]:
    """Lines ``name: v1  v2 ...`` whose values are all numbers (the EOC
    block of ``q2_3d_convergence_study.txt``): name -> printed values."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^\s*(\S+):\s+(.*)$", line)
        if m and m.group(2).split() and all(re.fullmatch(_NUM, t) for t in m.group(2).split()):
            out[m.group(1)] = m.group(2).split()
    return out


def unit(cell: str) -> float:
    """One unit in the last printed digit of ``cell``."""
    mant, _, exp = cell.lower().partition("e")
    dec = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** ((int(exp) if exp else 0) - dec)


def within(a, cell: str, eoc: bool = False) -> bool:
    """``a`` agrees with the printed ``cell``: +-0.02 for an EOC cell, else
    at most one unit in its last printed digit; ``nan`` only with nan, a
    dash cell (a first row's EOC) with anything, level info as text."""
    if set(cell) == {"-"}:
        return True
    if "/" in cell:
        return str(a) == cell
    if cell in ("nan", "inf"):
        return a is not None and math.isnan(a) if cell == "nan" else a == math.inf
    if a is None or not math.isfinite(a):
        return False
    tol = 0.02 if eoc else unit(cell)
    return abs(a - float(cell)) <= tol * (1 + 1e-9)


# Columns that are zero in exact arithmetic and printed at rounding level:
# the SPE10 efficiency studies' eta_r (cellwise-constant coefficient on a
# resolved raster, f == 1: div t = f holds exactly and the residual
# indicator vanishes, the files' own reading).  Their printed digits are
# summation noise (~1e-7 against indicators of ~1-100), which no other
# implementation or device reproduces: such a cell is held to
# ``|value| <= ROUNDING_REL * max(row's ROUNDING_SCALE columns)``, in the
# file and in the run, and its EOC (of noise) is not compared.
ROUNDING_LEVEL = {"spe10_efficiency_study.txt": ("eta_r",),
                  "spe10_3d_efficiency_study.txt": ("eta_r",)}
ROUNDING_SCALE = ("eta_nc", "eta_df")
ROUNDING_REL = 1e-6


def check_rows(table: Table, rows: Sequence[Dict[str, object]], label: str = "",
               columns: Optional[Sequence[str]] = None,
               rounding: Sequence[str] = ()) -> List[str]:
    """Hold ``rows`` (one dict per table row: column name -> value) to the
    table; returns the mismatches as text (empty: all agree).  ``columns``
    restricts the check to those columns (default: every column);
    ``rounding`` names rounding-level columns (see :data:`ROUNDING_LEVEL`)."""
    bad = []
    if len(rows) != len(table.rows):
        return [f"{label}: {len(rows)} rows against the file's {len(table.rows)}"]
    for i, (row, cells) in enumerate(zip(rows, table.rows)):
        scale_f = max(float(c) for n, c in zip(table.header, cells) if n in ROUNDING_SCALE) \
            if rounding else 0.0
        for name, cell in zip(table.header, cells):
            if columns is not None and name not in columns:
                continue
            if name not in row:
                bad.append(f"{label} row {i} column {name!r}: no value")
                continue
            a = row[name]
            a = a if isinstance(a, str) or a is None else float(a)
            if name in rounding:
                scale = max(float(row[n]) for n in ROUNDING_SCALE if n in row)
                ok = abs(a) <= ROUNDING_REL * scale and abs(float(cell)) <= ROUNDING_REL * scale_f
                if not ok:
                    bad.append(f"{label} row {i} column {name!r}: {a!r} (file {cell}) not at "
                               f"rounding level ({ROUNDING_REL:.0e} x {scale:.3e})")
                continue
            if name.startswith("EOC:") and name[4:] in rounding:
                continue
            if not within(a, cell, eoc=name.startswith("EOC:")):
                bad.append(f"{label} row {i} column {name!r}: {a!r} against the file's {cell}")
    return bad


def study_rows(data: dict, level_info: Sequence[str]) -> List[Dict[str, object]]:
    """Rows of an EOC study's table (``EOC.EocStudy.run``'s data) keyed as
    :func:`parse_tables` names the columns: the level info, the accuracy,
    each norm and indicator with its EOC, each estimate's efficiency
    (``'<eid> eff.'``) with the estimate's EOC."""
    rows = []
    for level in sorted(data):
        lv = data[level]
        row = {"|grid|/|Grid|": level_info[level], "|grid|/|Grid|/nt": level_info[level]}
        row.update(lv.get("accuracy", {}))
        for group in ("norm", "indicator"):
            for k, v in lv.get(group, {}).items():
                row[k] = v
                row[f"EOC:{k}"] = lv.get("eoc", {}).get(k)
        for eid, v in lv.get("estimate", {}).items():
            row[f"{eid} eff."] = lv["eff"][eid]
            row[f"EOC:{eid} eff."] = lv.get("eoc", {}).get(eid)
        rows.append(row)
    return rows


# The accuracy values of the files written on a TPU.  key -> (file, line,
# text at that line, value, kind, tolerance).  "value": held at rtol (1e-3 where
# the file says the run was f64; else the file's own tolerance or 1e-2);
# "bound": the port's value must be <= the last entry (the bound; its
# source is stated beside each, and the file's own value passes it);
# "f32 branch": printed beside the port's, not held (see the entry).
TPU_VALUES = {
    # scripts/parabolic.py --subdomains 8 8 --nt 100 (f64)
    "parabolic.rom_error": ("parabolic_tpu.txt", 17, "4.7e-06", 4.7e-06, "bound",
                            4.7e-06),                  # the file's value
    "parabolic.fom.total": ("parabolic_tpu.txt", 25, "1.328064e-01", 1.328064e-01, "value", 1e-3),
    "parabolic.rom.total": ("parabolic_tpu.txt", 25, "1.328062e-01", 1.328062e-01, "value", 1e-3),
    "parabolic.fom.nc": ("parabolic_tpu.txt", 26, "9.844020e-05", 9.844020e-05, "value", 1e-3),
    "parabolic.rom.nc": ("parabolic_tpu.txt", 26, "9.843974e-05", 9.843974e-05, "value", 1e-3),
    "parabolic.fom.r": ("parabolic_tpu.txt", 27, "7.446216e-04", 7.446216e-04, "value", 1e-3),
    "parabolic.rom.r": ("parabolic_tpu.txt", 27, "7.446237e-04", 7.446237e-04, "value", 1e-3),
    "parabolic.fom.df": ("parabolic_tpu.txt", 28, "5.167620e-03", 5.167620e-03, "value", 1e-3),
    "parabolic.rom.df": ("parabolic_tpu.txt", 28, "5.167581e-03", 5.167581e-03, "value", 1e-3),
    "parabolic.fom.rt": ("parabolic_tpu.txt", 29, "1.538311e-02", 1.538311e-02, "value", 1e-3),
    "parabolic.rom.rt": ("parabolic_tpu.txt", 29, "1.538312e-02", 1.538312e-02, "value", 1e-3),
    "parabolic.fom.tdnc": ("parabolic_tpu.txt", 30, "1.118988e-01", 1.118988e-01, "value", 1e-3),
    "parabolic.rom.tdnc": ("parabolic_tpu.txt", 30, "1.118987e-01", 1.118987e-01, "value", 1e-3),
    # scripts/spe10_greedy.py --subdomains 16 16 --half 2 --nref 2 --training 8
    # --target 1e-2 --online-mus 3 (f64 Krylov)
    "spe10_greedy.max_eta0": ("spe10_greedy_tpu.txt", 17, "3.652e-01", 3.652e-01, "value", 1e-3),
    "spe10_greedy.max_eta1": ("spe10_greedy_tpu.txt", 18, "1.282e-02", 1.282e-02, "value", 1e-3),
    "spe10_greedy.max_eta2": ("spe10_greedy_tpu.txt", 19, "6.877e-04", 6.877e-04, "value", 1e-3),
    "spe10_greedy.online_eta0": ("spe10_greedy_tpu.txt", 21, "5.836e+02", 5.836e+02, "value", 1e-3),
    "spe10_greedy.online_eta1": ("spe10_greedy_tpu.txt", 21, "2.443e+02", 2.443e+02, "value", 1e-3),
    "spe10_greedy.online_eta2": ("spe10_greedy_tpu.txt", 22, "2.799e+01", 2.799e+01, "value", 1e-3),
    # scripts/spe10_scale.py --matrix-free --dtype float64 (tol 1e-6)
    "spe10_scale.relres": ("spe10_scale_tpu.txt", 14, "9.5e-07", 9.5e-07, "bound",
                           1e-6),                      # the file's "tol 1e-6"
    # scripts/spe10_parabolic.py --rom --rom-snapshots 4 (f64)
    # (the trajectory's per-step PCG stops at ||r|| <= 1e-10 ||b||, the
    # tolerance of ``_solve_mf`` in both packages)
    "spe10_parabolic.euler_residual": ("spe10_parabolic_tpu.txt", 27, "7.78e-11", 7.78e-11,
                                       "bound", 1e-10),
    "spe10_parabolic.eta": ("spe10_parabolic_tpu.txt", 28, "1.062040e+00", 1.062040e+00,
                            "value", 1e-3),
    # (two solutions of one trajectory at that tolerance: the bound of the
    # script's own lane-vs-single check, ``assert rel_b < 1e-8``)
    "spe10_parabolic.host_agreement": ("spe10_parabolic_tpu.txt", 33, "2.92e-10", 2.92e-10,
                                       "bound", 1e-8),
    "spe10_parabolic.rom_eta": ("spe10_parabolic_tpu.txt", 50, "1.064227e+00", 1.064227e+00,
                                "value", 1e-3),
    "spe10_parabolic.rom_error": ("spe10_parabolic_tpu.txt", 51, "3.81e-04", 3.81e-04,
                                  "value", 1e-2),
    # scripts/spe10_3d.py --subdomains 8 8 4 --half 1 --nref 2 --lean --mf (f64)
    # (relres: the script's precision 1e-8 bounds ||b - A U|| / ||b||, which
    # the port's script returns as ``relres2``; the file prints the max-norm
    # ratio, 1.4e-9 after the TPU's f64 polish)
    "spe10_3d.scale.relres": ("spe10_3d_tpu.txt", 25, "1.4e-09", 1.4e-09, "bound", 1e-8),
    # (not held: the TPU run took the JAX package's at-scale accelerator
    # branch, positive-form estimator integrals in f32 above 32 768 dofs,
    # estimators.py:368-379, which the port does not take; forced on the
    # CPU at 55 296 dofs that branch gives 2.24e+03 where the f64 one and
    # the port give 3.55, tests/test_torch_scripts_tpu_files.py)
    "spe10_3d.scale.eta": ("spe10_3d_tpu.txt", 32, "2.2489e+03", 2.2489e+03, "f32 branch",
                           None),
    # scripts/spe10_3d.py --nref 2 (4x4x2, s=4, f64, full MOR tensors)
    # (the max-norm ratio, both runs by the same f64 two-level PCG to 1e-8)
    "spe10_3d.relres": ("spe10_3d_tpu.txt", 60, "3e-7", 3e-7, "bound", 3e-7),
    "spe10_3d.eta": ("spe10_3d_tpu.txt", 61, "5.2167", 5.2167, "value", 1e-3),
    "spe10_3d.eta_rom": ("spe10_3d_tpu.txt", 64, "6.1713", 6.1713, "value", 1e-3),
    "spe10_3d.rom_fom_gap": ("spe10_3d_tpu.txt", 65, "1.2e-7", 1.2e-7, "bound", 1.2e-7),
    # scripts/spe10_3d.py --nref 2 --greedy 5 --training 6 --online-mus 3 (f64)
    "spe10_3d_greedy.surrogate0": ("spe10_3d_greedy_tpu.txt", 33, "9.311e-02", 9.311e-02,
                                   "value", 1e-3),
    "spe10_3d_greedy.surrogate1": ("spe10_3d_greedy_tpu.txt", 33, "2.563e-02", 2.563e-02,
                                   "value", 1e-3),
    "spe10_3d_greedy.surrogate2": ("spe10_3d_greedy_tpu.txt", 33, "3.652e-03", 3.652e-03,
                                   "value", 1e-3),
    "spe10_3d_greedy.surrogate3": ("spe10_3d_greedy_tpu.txt", 33, "1.680e-04", 1.680e-04,
                                   "value", 1e-3),
    "spe10_3d_greedy.eta_rom": ("spe10_3d_greedy_tpu.txt", 36, "7.6188e+00", 7.6188e+00,
                                "value", 1e-3),
    "spe10_3d_greedy.eta_rec": ("spe10_3d_greedy_tpu.txt", 36, "7.6188e+00", 7.6188e+00,
                                "value", 1e-3),
    "spe10_3d_greedy.rom_fom_gap": ("spe10_3d_greedy_tpu.txt", 36, "5.9e-09", 5.9e-09,
                                    "bound", 5.9e-09),
    "spe10_3d_greedy.online_eta0": ("spe10_3d_greedy_tpu.txt", 38, "3.002e+01", 3.002e+01,
                                    "value", 1e-3),
    "spe10_3d_greedy.online_eta1": ("spe10_3d_greedy_tpu.txt", 39, "1.803e+01", 1.803e+01,
                                    "value", 1e-3),
    "spe10_3d_greedy.online_eta2": ("spe10_3d_greedy_tpu.txt", 40, "6.320e+00", 6.320e+00,
                                    "value", 1e-3),
    # scripts/spe10_3d.py --subdomains 8 8 4 --half 2 --nref 1 --lean --mf
    # --skip-estimate --parabolic 20 --parabolic-batch 4 (f64)
    # (the per-step tolerance 1e-10 as in 2D, the file's 1.17e-13 after the
    # TPU's f64 polish; the lanes: the script's own ``assert rel_b < 1e-8``)
    "spe10_3d_parabolic.euler_residual": ("spe10_3d_parabolic_tpu.txt", 19, "1.17e-13",
                                          1.17e-13, "bound", 1e-10),
    "spe10_3d_parabolic.lane": ("spe10_3d_parabolic_tpu.txt", 25, "2.95e-12", 2.95e-12,
                                "bound", 1e-8),
    # scripts/spe10_3d.py --nref 2 --greedy 2 --training 6 --online-mus 3
    # --online-target-rel 1.05 (f64)
    "spe10_3d_target.eta_fom0": ("spe10_3d_enrichment_to_target.txt", 38, "3.0051e+01",
                                 3.0051e+01, "value", 1e-3),
    "spe10_3d_target.eta0": ("spe10_3d_enrichment_to_target.txt", 40, "3.003e+01", 3.003e+01,
                             "value", 1e-3),
    "spe10_3d_target.eta_fom1": ("spe10_3d_enrichment_to_target.txt", 43, "1.8021e+01",
                                 1.8021e+01, "value", 1e-3),
    "spe10_3d_target.eta1": ("spe10_3d_enrichment_to_target.txt", 44, "1.808e+01", 1.808e+01,
                             "value", 1e-3),
    "spe10_3d_target.eta_fom2": ("spe10_3d_enrichment_to_target.txt", 45, "6.3139e+00",
                                 6.3139e+00, "value", 1e-3),
    "spe10_3d_target.eta2": ("spe10_3d_enrichment_to_target.txt", 46, "6.325e+00", 6.325e+00,
                             "value", 1e-3),
    # scripts/mf_sharded_xl_demo.py (virtual 8-device mesh, f64, tol 1e-8:
    # restarted until the relres is under it)
    "xl_sharded.relres": ("xl_sharded_virtual.txt", 22, "8.9e-9", 8.9e-9, "bound", 1e-8),
}
# The channels' rhs switch ``sin(4 pi t) > 0`` (problems/artificial_channels)
# is evaluated at t = (n + 1) dt, which lands on its zeros t = j / 4 when nt
# is a multiple of 4; there its sign is rounding noise.  The port decides it
# on the host in f64 (on at 1/4 and 3/4, off at 1/2 and 1); the JAX package
# decides it inside its jitted time loop, where XLA folds dt into 4 pi: off,
# on, on, on on the CPU, and off, on, off, on in the TPU run of
# parabolic_tpu.txt (the one pattern of the 16 that reproduces that file's
# six estimates, to 4.2e-7 on the CPU).  Holding the port to that file
# imposes the file's decisions at the ties (:func:`channels_switch_at_ties`).
CHANNELS_SWITCH = "sin(2 * 2 * pi * _t) > 0"
CHANNELS_TIES_TPU = {0.25: False, 0.5: True, 0.75: False, 1.0: True}
CHANNELS_TIES_JAX_CPU = {0.25: False, 0.5: True, 0.75: True, 1.0: True}


@contextlib.contextmanager
def channels_switch_at_ties(decisions):
    """Within the block, the channels' switch takes ``decisions`` (t -> on)
    at those times (to 1e-9) and its own value elsewhere."""
    import torch
    from ..parameters import ExpressionParameterFunctional as E
    evaluate = E.evaluate

    def at_ties(self, mu):
        t = (mu or {}).get("_t")
        if self.expression == CHANNELS_SWITCH and t is not None and torch.numel(
                torch.as_tensor(t)) == 1:
            for tie, on in decisions.items():
                if abs(float(t) - tie) < 1e-9:
                    return torch.tensor(float(on), dtype=torch.float64)
        return evaluate(self, mu)

    E.evaluate = at_ties
    try:
        yield
    finally:
        E.evaluate = evaluate


# iteration counts printed beside the port's (never held)
TPU_COUNTS = {
    "spe10_greedy.rb_size": ("spe10_greedy_tpu.txt", 19, "768"),
    "spe10_3d.scale.its": ("spe10_3d_tpu.txt", 24, "56"),
    "spe10_3d.its": ("spe10_3d_tpu.txt", 60, "132"),
    "spe10_3d_greedy.iterations": ("spe10_3d_greedy_tpu.txt", 32, "4"),
    "spe10_3d_greedy.rb_size": ("spe10_3d_greedy_tpu.txt", 34, "128"),
    "xl_sharded.its": ("xl_sharded_virtual.txt", 22, "177"),
    "spe10_3d.xl.its": ("spe10_3d_tpu.txt", 85, "194"),
}


def hold_tpu(values: Dict[str, float], log=print) -> List[str]:
    """Hold ``values`` (key of :data:`TPU_VALUES` -> the port's value) to the
    TPU files; logs each beside the file's and returns the failures."""
    bad = []
    for key, v in values.items():
        fname, line, _, ref, kind, tol = TPU_VALUES[key]
        if kind == "f32 branch":
            log(f"  {key}: {v:.6e} vs {fname}:{line} {ref:.6e}, not held (the file's value "
                f"is the JAX package's f32 accelerator branch)")
            continue
        if kind == "value":
            ok = v is not None and math.isfinite(v) and abs(v - ref) <= tol * abs(ref)
            how = f"rel {abs(v - ref) / abs(ref):.2e} (tol {tol:.0e})"
        else:
            ok = v is not None and math.isfinite(v) and v <= tol
            how = f"bound <= {tol:.3g}"
        log(f"  {key}: {v:.6e} vs {fname}:{line} {ref:.6e}, {how} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{key}: {v!r} against {fname}:{line} {ref!r} ({kind})")
    return bad


# ---------------------------------------------------------------------------
# one script's output against its file (CPU-written files)
# ---------------------------------------------------------------------------

def numbers(text: str) -> List[str]:
    return re.findall(_NUM, text)


def hold_studies(fname: str, studies: Sequence[dict], tables: Sequence[int] = None) -> List[str]:
    """EOC-harness studies (``{"data", "levels"}`` each, in the file's
    table order; ``tables`` picks the file's tables) against the file."""
    ts = parse_tables(read(fname))
    idx = list(range(len(studies))) if tables is None else list(tables)
    bad = []
    for s, i in zip(studies, idx):
        bad += check_rows(ts[i], study_rows(s["data"], s["levels"]), f"{fname} table {i}",
                          rounding=ROUNDING_LEVEL.get(fname, ()))
    return bad


def hold_rows(fname: str, tables: Sequence[Sequence[dict]], idx: Sequence[int] = None) -> List[str]:
    """Row dicts (one list per table, in the file's order) against the file."""
    ts = parse_tables(read(fname))
    idx = list(range(len(tables))) if idx is None else list(idx)
    bad = []
    for rows, i in zip(tables, idx):
        bad += check_rows(ts[i], rows, f"{fname} table {i}",
                          rounding=ROUNDING_LEVEL.get(fname, ()))
    return bad


def hold_q2_3d(out: dict) -> List[str]:
    fname = "q2_3d_convergence_study.txt"
    bad = hold_rows(fname, [out["rows"]])
    for name, cells in parse_labelled(read(fname)).items():
        vals = out["eoc"].get(name, [])
        if len(vals) != len(cells) or not all(within(v, c, eoc=True)
                                               for v, c in zip(vals, cells)):
            bad.append(f"{fname} EOC {name}: {vals} against the file's {cells}")
    return bad


GOLDEN_GAP = "golden_gap_attribution.md"

# the acceptance script's detailed values (OS2015 [4, 4], half 1, nref 1,
# mu = 1, tri, squared locals), as tests/test_scripts.py:15-16 asserts them
DECOMP_GOLDEN = {"eta_nc": 1.303846e-02, "eta_r": 5.775504e-03,
                 "eta_df": 3.356385e-02, "eta": 5.058341e-02}


def hold_golden_gap(rows, text: str) -> List[str]:
    """``golden_gap_study``'s sweep (``(nref, h, as-executed, paper)``) and
    text against ``golden_gap_attribution.md``: every cell of the sweep
    table and the measured numbers of findings 1-3 to their printed
    digits."""
    file_text = read(GOLDEN_GAP)
    table = parse_markdown_tables(file_text)[0]
    bad = []
    port_rows = []
    for nref, h, ex, pa in rows:
        for t in (ex, pa):
            port_rows.append([float(2 ** nref), h, t["nc"], t["r"], t["df"],
                              [t[k] / v for k, v in (("nc", 1.66e-01), ("r", 1.45e-01),
                                                     ("df", 3.55e-01))]])
    if len(port_rows) != len(table.rows):
        return [f"{GOLDEN_GAP}: {len(port_rows)} sweep rows against {len(table.rows)}"]
    for i, (p, cells) in enumerate(zip(port_rows, table.rows)):
        s, h, nc, r, df, ratios = p
        pairs = [(s, cells[0]), (h, cells[1]), (nc, cells[3]), (r, cells[4]), (df, cells[5])]
        pairs += list(zip(ratios, [c.rstrip("x") for c in cells[6].replace(" ", "").split(",")]))
        for a, c in pairs:
            if not within(float(a), c):
                bad.append(f"{GOLDEN_GAP} sweep row {i}: {a!r} against {c}")
    # findings 1-3: the numbers the study measures (the leading ones)
    for lead, n in (("1. **Matched cell**", 6), ("2. **Mesh scaling**", 3),
                    ("3. **eta_nc remainder**", 2)):
        fl = next(ln for ln in file_text.splitlines() if ln.startswith(lead))
        pl = next((ln for ln in text.splitlines() if ln.startswith(lead)), "")
        fn, pn = numbers(fl)[:n], numbers(pl)[:n]
        if len(pn) != n or not all(within(float(a), c) for a, c in zip(pn, fn)):
            bad.append(f"{GOLDEN_GAP} finding {lead[:2]}: {pn} against the file's {fn}")
    return bad
