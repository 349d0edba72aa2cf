"""``pylrbms_tpu_torch/scripts/_results.py`` on the committed result files of
``docs/results/``: every EOC table of the CPU-written files parses to its
row and column count, every TPU-file value the port is held to stands at
the line it cites, and the "one unit in the last printed digit" rule
accepts the files' own values and rejects values one unit further off."""
import math

import pytest

from pylrbms_tpu_torch.scripts import _results as R

# file -> (rows, columns) of each parsed table, in the file's order
CPU_TABLES = {
    "OS2015_convergence_study.txt": [(3, 8), (3, 6), (3, 6), (3, 8)],
    "OS2015_convergence_study_crisscross.txt": [(3, 8), (3, 6), (3, 6), (3, 8)],
    "OS2015_convergence_study_paper.txt": [(3, 8), (3, 6), (3, 6), (3, 8)],
    "OS2015_convergence_study_as_reduced.txt": [(2, 10)],
    "P2_convergence_study.txt": [(3, 9)] * 3,
    "parabolic_convergence_study.txt": [(2, 12)],
    "academic3d_convergence_study.txt": [(3, 9)],
    "q2_3d_convergence_study.txt": [(3, 8)],
    "spe10_efficiency_study.txt": [(3, 12), (3, 12), (4, 12), (4, 12)],
    "spe10_3d_efficiency_study.txt": [(3, 10), (3, 10), (3, 11), (3, 11)],
}


def _value_cells():
    """(file, column, cell) of every numeric cell of the CPU-written tables."""
    out = []
    for fname in CPU_TABLES:
        for t in R.parse_tables(R.read(fname)):
            for row in t.rows:
                for name, cell in zip(t.header, row):
                    if "/" not in cell and set(cell) != {"-"} and cell != "nan":
                        out.append((fname, name, cell))
    return out


@pytest.mark.parametrize("fname", sorted(CPU_TABLES))
def test_cpu_written_tables_parse(fname):
    tables = R.parse_tables(R.read(fname))
    assert [(len(t.rows), len(t.header)) for t in tables] == CPU_TABLES[fname]
    for t in tables:
        assert all(len(r) == len(t.header) for r in t.rows)
        assert all(h for h in t.header), t.header
        # an EOC column follows the quantity it is the rate of
        for j, h in enumerate(t.header):
            if h.startswith("EOC:"):
                assert t.header[j - 1] == h[4:]


def test_q2_3d_eoc_block_and_golden_gap_tables_parse():
    eoc = R.parse_labelled(R.read("q2_3d_convergence_study.txt"))
    assert sorted(eoc) == sorted(["eta", "|e|_E", "eta_nc", "eta_r", "eta_df"])
    assert all(len(v) == 2 for v in eoc.values())
    sweep = R.parse_markdown_tables(R.read(R.GOLDEN_GAP))[0]
    assert len(sweep.rows) == 6 and len(sweep.header) == 7


@pytest.mark.parametrize("key", sorted(R.TPU_VALUES))
def test_tpu_values_stand_at_their_lines(key):
    fname, line, text, value, kind, tol = R.TPU_VALUES[key]
    assert text in R.read(fname).splitlines()[line - 1], (key, fname, line)
    assert float(text) == value
    assert kind in ("value", "bound", "f32 branch")
    # a relative tolerance for a value; a bound the file's own value passes
    if kind != "f32 branch":
        assert 0 < tol < 0.1 if kind == "value" else value <= tol


@pytest.mark.parametrize("key", sorted(R.TPU_COUNTS))
def test_tpu_counts_stand_at_their_lines(key):
    fname, line, text = R.TPU_COUNTS[key]
    assert text in R.read(fname).splitlines()[line - 1], (key, fname, line)


def test_one_unit_rule_accepts_the_files_values_and_rejects_one_unit_further():
    cells = _value_cells()
    assert len(cells) > 300
    for fname, name, cell in cells:
        v = float(cell)
        if name.startswith("EOC:"):
            assert R.within(v, cell, eoc=True) and R.within(v + 0.02, cell, eoc=True)
            assert not R.within(v + 0.03, cell, eoc=True), (fname, cell)
            continue
        u = R.unit(cell)
        assert R.within(v, cell) and R.within(v + u, cell) and R.within(v - u, cell)
        assert not R.within(v + 2 * u, cell), (fname, name, cell)
        assert not R.within(v - 2 * u, cell), (fname, name, cell)


def test_unit_and_special_cells():
    assert R.unit("1.60e+01") == pytest.approx(0.1)
    assert R.unit("2.443e+02") == pytest.approx(0.1)
    assert R.unit("0.2500") == pytest.approx(1e-4)
    assert R.unit("13824") == 1.0
    assert R.within(math.nan, "nan") and not R.within(1.0, "nan")
    assert R.within(None, "----") and R.within("32/4", "32/4") and not R.within("8/4", "32/4")
    assert not R.within(math.inf, "1.0")


def test_check_rows_reports_the_cell_that_is_off():
    t = R.parse_tables(R.read("academic3d_convergence_study.txt"))[0]
    rows = [{n: (None if set(c) == {"-"} else float(c)) for n, c in zip(t.header, r)}
            for r in t.rows]
    assert R.check_rows(t, rows) == []
    rows[1]["eta"] *= 1.01
    bad = R.check_rows(t, rows, "a3")
    assert len(bad) == 1 and "row 1 column 'eta'" in bad[0]
    assert R.check_rows(t, rows[:2], "a3") == ["a3: 2 rows against the file's 3"]


def test_rounding_level_columns():
    """The SPE10 efficiency studies' eta_r is zero in exact arithmetic: held
    to <= ROUNDING_REL of the row's eta_nc, eta_df, in the file and in the
    run, with its EOC (of rounding noise) not compared."""
    t = R.parse_tables(R.read("spe10_efficiency_study.txt"))[0]
    row = {n: float(c) for n, c in zip(t.header[1:], t.rows[1][1:])}
    row["|grid|/|Grid|"] = t.rows[1][0]
    row["EOC:eta_r"] = 5.0
    t.rows = t.rows[1:2]
    for eta_r, n_bad in ((3.0e-6, 0), (4.0e-7, 0), (1.0e-3, 1)):
        row["eta_r"] = eta_r
        assert len(R.check_rows(t, [row], rounding=("eta_r",))) == n_bad
    assert len(R.check_rows(t, [row])) >= 2


def test_hold_tpu_value_and_bound():
    log = []
    assert R.hold_tpu({"spe10_3d.eta": 5.2167 * (1 + 9e-4)}, log=log.append) == []
    assert len(R.hold_tpu({"spe10_3d.eta": 5.2167 * (1 + 2e-3)}, log=log.append)) == 1
    assert R.hold_tpu({"xl_sharded.relres": 1e-9}, log=log.append) == []
    assert len(R.hold_tpu({"xl_sharded.relres": 1e-7}, log=log.append)) == 1
    assert len(R.hold_tpu({"xl_sharded.relres": math.nan}, log=log.append)) == 1
    assert len(log) == 5


def test_decomp_golden_is_the_jax_tests_golden():
    from tests.test_scripts import GOLDEN
    assert R.DECOMP_GOLDEN == GOLDEN


def test_long_studies_hold_the_deep_tables_and_the_xl_residual():
    from pylrbms_tpu_torch.scripts import long_studies
    text = R.read("spe10_efficiency_study.txt")
    deep = text[text.index("4-level --deep variant"):]
    assert long_studies._hold_deep(deep) == []
    off = deep.replace("5.70e+00", "5.80e+00", 1)
    assert len(long_studies._hold_deep(off)) == 1
    line = "XL solve: 26.8 s (1 restarts of at most 300 iterations), 192 CG iterations, "
    assert long_studies._hold_xl(line + "rel residual 9.8e-09, 139.4 ms/iteration") == []
    assert len(long_studies._hold_xl(line + "rel residual 2.0e-08, 139.4 ms/iteration")) == 1
