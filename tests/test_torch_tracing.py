"""Spans and counters of the port (``pylrbms_tpu_torch.utils.timers``) in the
online step and the PCG loop, on the CPU at a tiny size, for the affine and
the stencil form, batched and single-query:

* off (the default of ``GLOBAL_TIMINGS``): a step call records nothing,
  reads no clock and waits for no device; every span is one shared no-op;
* U and the indicators are bitwise equal with the timings on and off;
* on: the eight spans nest as ``step`` > ``operator.assemble`` | ``solve``
  (> ``operator.apply`` | ``precond.apply``) | ``estimate`` (>
  ``estimate.flux`` | ``estimate.oswald``), each call's spans carry one
  call number, the ``pcg.bodies`` counter is the iterations rounded up to
  the chunk, and ``stencil.applies`` counts the ``operator.apply`` spans of
  a stencil call (``stencil.lane_applies`` their lanes), in 2D and on the
  3D hex stencil;
* under a CPU ``torch.profiler`` the spans are ``user_annotation`` events
  that enclose the aten operations launched in them.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pylrbms_tpu_torch.discretize_elliptic_block_swipdg import discretize  # noqa: E402
from pylrbms_tpu_torch.la import krylov  # noqa: E402
from pylrbms_tpu_torch.model import make_online_step  # noqa: E402
from pylrbms_tpu_torch.problems.os2015 import init_grid_and_problem  # noqa: E402
from pylrbms_tpu_torch.utils import timers  # noqa: E402
from pylrbms_tpu_torch.utils.timers import GLOBAL_TIMINGS, Timings  # noqa: E402

CFG = {"num_subdomains": [2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
       "num_refinements": 1}
FORMS = {"affine": dict(matrix_free="affine", coarse_space="harvested", coarse_modes=4),
         "stencil": dict(matrix_free=True, coarse_space="harvested", coarse_modes=4)}
PARENT = {"step": None, "operator.assemble": "step", "solve": "step", "estimate": "step",
          "operator.apply": "solve", "precond.apply": "solve", "estimate.flux": "estimate",
          "estimate.oswald": "estimate"}
MUS = np.array([0.15, 0.6, 1.0])
STENCIL_COUNTERS = {"stencil.applies", "stencil.lane_applies"}
CFG3 = {"num_subdomains": [2, 2, 2], "half_num_fine_elements_per_subdomain_and_dim": 1,
        "num_refinements": 1}
CASES = [(form, batched) for form in FORMS for batched in (True, False)]


@pytest.fixture(scope="module")
def steps():
    d, _ = discretize(init_grid_and_problem(CFG), device="cpu")
    return {form: make_online_step(d, **kw) for form, kw in FORMS.items()}


@pytest.fixture(scope="module")
def step3d():
    """The 3D hex stencil step of the SPE10 block (K = 8, N = 64)."""
    from pylrbms_tpu_torch.discretize_elliptic_block_swipdg3d import discretize as disc3
    from pylrbms_tpu_torch.problems.spe10_3d import init_grid_and_problem as spe10_3d
    d, _ = disc3(spe10_3d(CFG3), device="cpu", dtype=torch.float32)
    return make_online_step(d, **FORMS["stencil"])


def args3d(batched):
    th, tf, mu = args(batched)
    return th, tf, {"switch": mu["diffusion"].float()}


@pytest.fixture(autouse=True)
def timings_off():
    """Every test starts and ends with the global timings off and empty."""
    GLOBAL_TIMINGS.disable()
    GLOBAL_TIMINGS.clear()
    yield
    GLOBAL_TIMINGS.disable()
    GLOBAL_TIMINGS.clear()


def args(batched):
    if batched:
        return (np.stack([np.ones_like(MUS), MUS], 1), np.ones((len(MUS), 1)),
                {"diffusion": torch.tensor(MUS[:, None])})
    return (np.array([1.0, MUS[1]]), np.array([1.0]), {"diffusion": torch.tensor([MUS[1]])})


def recorded(step, batched, calls=1, make=args):
    GLOBAL_TIMINGS.enable()
    try:
        outs = [step(*make(batched)) for _ in range(calls)]
    finally:
        GLOBAL_TIMINGS.disable()
    return outs


@pytest.mark.parametrize("form,batched", CASES)
def test_off_a_step_records_nothing_reads_no_clock_and_never_waits(steps, form, batched,
                                                                  monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span off read the clock or waited")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(timers, "_wait", refuse)
    U, ind = steps[form](*args(batched))
    assert torch.isfinite(U).all() and torch.isfinite(ind).all()
    assert not GLOBAL_TIMINGS.records and not GLOBAL_TIMINGS.counts
    with GLOBAL_TIMINGS.span("a", sync=U) as out:
        out["sync"] = U                   # dropped: nothing to wait for
    assert GLOBAL_TIMINGS.span("a") is GLOBAL_TIMINGS.span("b", sync=U)
    GLOBAL_TIMINGS.count("pcg.bodies", 16)
    assert not GLOBAL_TIMINGS.records and not GLOBAL_TIMINGS.counts


@pytest.mark.parametrize("form,batched", CASES)
def test_answers_are_bitwise_equal_with_the_timings_on_and_off(steps, form, batched):
    U0, ind0 = steps[form](*args(batched))
    (U1, ind1), = recorded(steps[form], batched)
    assert GLOBAL_TIMINGS.records
    assert torch.equal(U0, U1) and torch.equal(ind0, ind1)


@pytest.mark.parametrize("form,batched", CASES)
def test_on_the_spans_nest_and_carry_one_number_per_call(steps, form, batched):
    recorded(steps[form], batched, calls=2)
    recs = GLOBAL_TIMINGS.records
    assert {r.name for r in recs} == set(PARENT)
    for r in recs:
        assert (r.parent.name if r.parent else None) == PARENT[r.name], r.name
        assert r.end_ns >= r.start_ns and (r.parent is None or r.parent.call == r.call)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["step", "step"]
    assert [r.call for r in roots] == [0, 1]
    assert {r.call for r in recs} == {0, 1}
    # one solve a call: the lanes share it
    assert [r.call for r in recs if r.name == "solve"] == [0, 1]
    spans = GLOBAL_TIMINGS.spans
    assert len(spans["step"]) == 2 and "pcg.bodies" in GLOBAL_TIMINGS.report()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("chunk", [1, 4])
def test_pcg_bodies_are_the_iterations_rounded_up_to_the_chunk(steps, form, chunk,
                                                               monkeypatch):
    monkeypatch.setattr(krylov, "default_chunk", lambda device: chunk)
    step = steps[form]
    theta, theta_f, _ = args(True)
    iters = step.iters_probe(theta, theta_f)
    recorded(step, True)
    counts = [(n, span) for name, n, span in GLOBAL_TIMINGS.counts if name == "pcg.bodies"]
    others = {name for name, _, _ in GLOBAL_TIMINGS.counts} - {"pcg.bodies"}
    assert others == (STENCIL_COUNTERS if form == "stencil" else set())
    assert counts and all(n == chunk and span.name == "solve" for n, span in counts)
    bodies = GLOBAL_TIMINGS.counters["pcg.bodies"]
    assert iters <= bodies < iters + chunk and bodies % chunk == 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_annotations_around_their_ops(steps, form, on, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    a = args(True)
    if on:
        GLOBAL_TIMINGS.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps[form](*a)
    GLOBAL_TIMINGS.disable()
    assert bool(GLOBAL_TIMINGS.records) == on
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    cats = {e["name"]: e.get("cat") for e in json.loads((tmp_path / "trace.json").read_text())
            ["traceEvents"] if e.get("name") in PARENT}
    assert cats == dict.fromkeys(PARENT, "user_annotation")
    events = list(prof.events())
    spans = [e for e in events if e.name in PARENT]
    assert {e.name for e in spans} == set(PARENT)
    ops = [e for e in events if e.name.startswith("aten::")]

    def inside(e, s):
        return (s.time_range.start <= e.time_range.start
                and e.time_range.end <= s.time_range.end)

    step = next(s for s in spans if s.name == "step")
    assert all(inside(e, step) for e in ops)
    for s in spans:
        parent = PARENT[s.name]
        assert parent is None or any(inside(s, p) for p in spans if p.name == parent), s.name
        assert any(inside(e, s) for e in ops), s.name


def test_threads_keep_their_own_nesting():
    T = Timings()

    def work(tag):
        for _ in range(200):
            with T.span(f"outer {tag}"):
                with T.span(f"inner {tag}"):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(T.records) == 4 * 400
    for r in T.records:
        if r.name.startswith("inner"):
            assert r.parent.name == "outer" + r.name[len("inner"):]
        else:
            assert r.parent is None
    assert len({r.call for r in T.records}) == 800


def test_a_callers_timings_start_on_and_count():
    T = Timings()
    assert T.on and not GLOBAL_TIMINGS.on
    T.count("c")
    with T.span("a"):
        T.count("c", 2)
    assert T.counters == {"c": 3} and '"c": {"count": 3}' in T.as_json()
    assert [s.name if s else None for _, _, s in T.counts] == [None, "a"]
    T.disable()
    T.count("c")
    assert T.counters == {"c": 3}


def _stencil_case(steps, step3d, dim):
    return (steps["stencil"], args) if dim == 2 else (step3d, args3d)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("batched", [True, False])
def test_stencil_applies_count_the_operator_apply_spans(steps, step3d, dim, batched):
    step, make = _stencil_case(steps, step3d, dim)
    recorded(step, batched, calls=2, make=make)
    applies = [r for r in GLOBAL_TIMINGS.records if r.name == "operator.apply"]
    counted = [(name, n, span) for name, n, span in GLOBAL_TIMINGS.counts
               if name in STENCIL_COUNTERS]
    totals = GLOBAL_TIMINGS.counters
    assert applies and totals["stencil.applies"] == len(applies)
    assert totals["stencil.lane_applies"] == len(applies) * (len(MUS) if batched else 1)
    # each count sits in the apply span that made it
    assert {span.name for _, _, span in counted} == {"operator.apply"}


@pytest.mark.parametrize("dim", [2, 3])
def test_the_oswald_span_nests_in_estimate(steps, step3d, dim):
    step, make = _stencil_case(steps, step3d, dim)
    recorded(step, True, make=make)
    recs = GLOBAL_TIMINGS.records
    oswald = [r for r in recs if r.name == "estimate.oswald"]
    assert len(oswald) == 1 and oswald[0].parent.name == "estimate"
    assert {r.name for r in recs} == set(PARENT)


def test_off_the_3d_step_counts_nothing_and_waits_for_nothing(step3d, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span off read the clock or waited")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(timers, "_wait", refuse)
    U, ind = step3d(*args3d(True))
    assert torch.isfinite(U).all() and torch.isfinite(ind).all()
    assert not GLOBAL_TIMINGS.records and not GLOBAL_TIMINGS.counts
