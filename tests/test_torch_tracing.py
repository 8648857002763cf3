"""The port's spans on the CPU (quest_tpu_torch.profiling.annotate): their
nesting, the always-on totals and NVTX ranges, the records kept of a
profiler session, the shared clock with torch.profiler, the bounded
buffer, several threads at once, the spans the package opens at its
layer boundaries on 10-qubit registers, and the benchmark's readers of
them (portbench/spans.py, portbench/metrics) on hand-built traces."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import byname, harness
from portbench import spans as PS
from portbench.devtrace import Trace
from quest_tpu_torch import calculations as K
from quest_tpu_torch import evolution as EV
from quest_tpu_torch import measurement as MS
from quest_tpu_torch import profiling as P
from quest_tpu_torch import state as ST
from quest_tpu_torch.circuit import random_circuit

pytestmark = pytest.mark.dtype_agnostic

N = 10


@pytest.fixture(autouse=True)
def _fresh_spans():
    P.reset_spans()
    yield
    P.reset_spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _names(records):
    return [r["name"] for r in records]


# ---------------------------------------------------------------------------
# the span API
# ---------------------------------------------------------------------------


def _nest():
    with P.annotate("outer"):
        with P.annotate("mid"):
            with P.annotate("inner"):
                pass
        with P.annotate("mid"):
            pass


@pytest.mark.parametrize("name, parent, depth", [
    ("outer", None, 0),
    ("mid", "outer", 1),
    ("inner", "mid", 2),
])
def test_spans_nest_under_their_parents(name, parent, depth):
    _profiled(_nest)
    recs = [r for r in P.spans() if r["name"] == name]
    assert recs and all(r["parent"] == parent and r["depth"] == depth
                        for r in recs)
    assert all(r["t0_ns"] <= r["t1_ns"] for r in recs)
    # a child lies inside its parent
    if parent is not None:
        assert all(any(p["name"] == parent and p["t0_ns"] <= r["t0_ns"]
                       and r["t1_ns"] <= p["t1_ns"] for p in P.spans())
                   for r in recs)


@pytest.mark.parametrize("profiled", [False, True])
def test_totals_always_and_records_only_while_a_profiler_runs(profiled):
    (_profiled if profiled else lambda f: f())(_nest)
    totals = P.span_totals()
    assert {k: v["calls"] for k, v in totals.items()} == \
        {"outer": 1, "mid": 2, "inner": 1}
    assert all(v["seconds"] >= 0.0 for v in totals.values())
    assert totals["outer"]["seconds"] >= totals["inner"]["seconds"]
    assert _names(P.spans()) == (["inner", "mid", "mid", "outer"]
                                 if profiled else [])
    assert P.spans_dropped() == 0


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_a_span_off_the_card_has_no_device_time(device):
    def run():
        with P.annotate("host", device=device):
            torch.ones(8).sum()
    _profiled(run)
    rec, = P.spans()
    assert rec["device_ms"] is None and rec["thread"] == threading.get_ident()


def test_an_exception_closes_the_span():
    def run():
        with pytest.raises(ValueError):
            with P.annotate("fails"):
                raise ValueError("raised inside")
        with P.annotate("after"):
            pass
    _profiled(run)
    fails, after = P.spans()
    assert after["parent"] is None and after["depth"] == 0
    assert P.span_totals()["fails"]["calls"] == 1


@pytest.mark.parametrize("name", ["first", "second"])
def test_a_span_shares_the_profilers_clock(name):
    """A span's t0_ns / t1_ns bracket the record_function region the
    profiler stamps for it, within 1 ms: the clock the benchmark's
    device trace is read on."""
    def run():
        for n in ("first", "second"):
            with P.annotate(n):
                torch.randn(32, 32) @ torch.randn(32, 32)
    prof = _profiled(run)
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == name]
    rec, = [r for r in P.spans() if r["name"] == name]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert abs(start - rec["t0_ns"]) < 1_000_000
    assert abs(end - rec["t1_ns"]) < 1_000_000
    assert rec["t0_ns"] <= start and end <= rec["t1_ns"]


@pytest.mark.parametrize("buffer, spans", [(4, 3), (4, 4), (4, 10), (1, 5)])
def test_the_buffer_is_bounded_and_counts_what_it_drops(buffer, spans):
    P.reset_spans(buffer)

    def run():
        for i in range(spans):
            with P.annotate(f"s{i}"):
                pass
    _profiled(run)
    # the newest are kept
    assert _names(P.spans()) == [f"s{i}" for i in
                                 range(max(0, spans - buffer), spans)]
    assert P.spans_dropped() == max(0, spans - buffer)
    assert sum(v["calls"] for v in P.span_totals().values()) == spans
    P.reset_spans()
    assert P.spans() == [] and P.spans_dropped() == 0


@pytest.mark.parametrize("profiled", [False, True])
def test_an_nvtx_range_opens_with_or_without_a_profiler(monkeypatch,
                                                        profiled):
    """Where CUDA is present every span is an NVTX range, for an Nsight
    timeline that no torch profiler records."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    (_profiled if profiled else lambda f: f())(_nest)
    assert calls == [("push", "outer"), ("push", "mid"), ("push", "inner"),
                     ("pop",), ("pop",), ("push", "mid"), ("pop",),
                     ("pop",)]


def _session(tag):
    with P.annotate(f"{tag}.a"):
        with P.annotate(f"{tag}.b"):
            pass


@pytest.mark.parametrize("how", ["trace", "profile", "straddled"])
def test_each_profiler_session_starts_its_records_anew(tmp_path, how):
    """Two profiler sessions in one process: the second's records are
    its own, and the first's totals stay. `trace` starts a session
    itself; around other profilers, the first span to end under one
    after a span ended without one does; a span open across the
    session's start does not throw its records away."""
    if how == "trace":
        for tag in ("one", "two"):
            with P.trace(str(tmp_path), device="cpu"):
                _session(tag)
    else:
        _profiled(lambda: _session("one"))
        with P.annotate("between"):
            pass
        if how == "profile":
            _profiled(lambda: _session("two"))
        else:
            prof = profile(activities=[ProfilerActivity.CPU])
            with P.annotate("straddles"):
                prof.__enter__()
                _session("two")
            prof.__exit__(None, None, None)
    assert _names(P.spans()) == ["two.b", "two.a"]
    assert P.span_totals()["one.a"]["calls"] == 1


@pytest.mark.parametrize("profiled", [False, True])
def test_threads_record_at_once(profiled):
    """16 threads, 300 nested pairs each, the interpreter switching
    threads every microsecond: no call is lost from the totals, and
    each thread's records name their own parents."""
    threads, each = 16, 300
    errors = []
    # all alive together, so no thread id is reused
    together = threading.Barrier(threads, timeout=60)

    def work():
        try:
            together.wait()
            for _ in range(each):
                with P.annotate("t.outer"):
                    with P.annotate("t.inner"):
                        pass
            together.wait()
        except Exception as e:          # pragma: no cover - reported
            errors.append(e)

    def run():
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        (_profiled if profiled else lambda f: f())(run)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    totals = P.span_totals()
    assert totals["t.outer"]["calls"] == totals["t.inner"]["calls"] \
        == threads * each
    recs = P.spans()
    if profiled:
        assert len(recs) == 2 * threads * each
        assert len({r["thread"] for r in recs}) == threads
        assert all(r["parent"] == ("t.outer" if r["name"] == "t.inner"
                                   else None) for r in recs)
    else:
        assert recs == []


# ---------------------------------------------------------------------------
# the package's spans on 10-qubit registers
# ---------------------------------------------------------------------------


def _sampled_circuit():
    c = random_circuit(N, 3, seed=5)
    q = ST.create_qureg(N, device="cpu")
    q = c.apply_fused(q)
    s = MS.sample(q, 128, torch.Generator().manual_seed(3))
    K.calc_linear_xeb(q, s)


def _density_readout():
    q = ST.create_density_qureg(5, device="cpu")
    K.calc_total_prob(q)
    K.calc_purity(q)


def _quench():
    from quest_tpu_torch.ops import expec as E
    for cached in (EV._plan_trotter, EV._trotter_circuit_cached,
                   E._plan_cached):
        cached.cache_clear()      # the plans are built here, not found
    codes = np.array([[3, 3] + [0] * (N - 2), [0, 3, 3] + [0] * (N - 3),
                      [1] + [0] * (N - 1), [0] * (N - 1) + [1]])
    coeffs = np.array([1.0, 0.9, 0.5, 0.4])
    EV.run_evolution((codes, coeffs), 0.05, 3, state=ST.create_qureg(
        N, device="cpu"), energy_every=1)


@pytest.mark.parametrize("job, expect", [
    (_sampled_circuit, {"plan.fused": None, "plan.fusion": "plan.fused",
                        "plan.sweep": "plan.fused",
                        "plan.upload": "plan.fused",
                        "readout.sample": None,
                        "readout.linear_xeb": None}),
    (_density_readout, {"readout.total_prob": None,
                        "readout.purity": None}),
    (_quench, {"evolution.chunk": None, "expec.value": None,
               "plan.trotter": None, "plan.expec": None}),
])
def test_the_layer_boundaries_open_their_spans(job, expect):
    _profiled(job)
    recs = P.spans()
    names = set(_names(recs))
    assert names == set(expect), names
    for name, parent in expect.items():
        assert all(r["parent"] == parent for r in recs if r["name"] == name)
    # no span is left open
    assert P.span_totals().keys() == names


def test_the_quench_opens_a_span_a_chunk_and_an_energy():
    """3 chunks of one step and 4 energies (the initial one, then one
    after each chunk), alternating; each plan built once."""
    _profiled(_quench)
    order = [n for n in _names(P.spans())
             if n in ("evolution.chunk", "expec.value")]
    assert order == ["expec.value"] + ["evolution.chunk",
                                       "expec.value"] * 3
    totals = P.span_totals()
    assert totals["plan.expec"]["calls"] == 1
    assert totals["plan.trotter"]["calls"] >= 1


def test_plan_spans_open_on_cache_misses_only():
    codes = np.array([[3, 3, 0, 0], [1, 0, 0, 0], [0, 0, 1, 1]])
    from quest_tpu_torch.ops import expec as E
    E.plan_expec(codes.tolist(), 4, density=False)
    before = P.span_totals()["plan.expec"]["calls"]
    E.plan_expec(codes.tolist(), 4, density=False)
    assert P.span_totals()["plan.expec"]["calls"] == before


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

MS_NS = 1_000_000
MAIN = threading.main_thread().ident


def _span(name, t0, t1, parent=None, device_ms=None, thread=MAIN):
    return {"name": name, "parent": parent, "depth": 0, "thread": thread,
            "t0_ns": t0 * MS_NS, "t1_ns": t1 * MS_NS, "device_ms": device_ms}


def _trace(ops, lo=0, hi=100):
    t = Trace.__new__(Trace)
    t.lo, t.hi, t.phases = lo * MS_NS, hi * MS_NS, []
    t.ops = [("k", a * MS_NS, b * MS_NS, "kernel") for a, b in ops]
    return t


def _record(ops, jobs=2):
    return harness.Record(trace=_trace(ops), jobs=jobs, window_s=0.1)


# a quench-like window of 100 ms: device busy 0-10, 20-30, 50-60, 80-95
OPS = [(0, 10), (20, 30), (50, 60), (80, 95)]
SPANS = [
    _span("evolution.chunk", 2, 12, device_ms=9.0),
    # gap 10-20 (midpoint 15) falls in this energy
    _span("expec.value", 12, 35, device_ms=20.0),
    # a span inside it is innermost for its own stretch only
    _span("plan.expec", 13, 14, "expec.value"),
    # gap 30-50 (midpoint 40) falls under no span
    _span("evolution.chunk", 45, 58, device_ms=11.0),
    # gap 60-80 (midpoint 70) in this energy; gap 95-100 (97.5) under none
    _span("expec.value", 62, 79, device_ms=16.0),
    # another thread's span, open over the gap 30-50, takes no idle
    _span("plan.fused", 35, 50, thread=MAIN + 1),
    # a span that ends after the window counts for nothing
    _span("expec.value", 90, 120, device_ms=100.0),
]


@pytest.fixture
def program(monkeypatch):
    """The program's spans and totals as the readers find them."""
    state = {"spans": list(SPANS), "totals": {}}
    monkeypatch.setattr(P, "spans", lambda: state["spans"])
    monkeypatch.setattr(P, "span_totals", lambda: state["totals"])
    return state


def _read(metric, rec):
    return byname.module("metrics", metric).read(rec)


@pytest.mark.parametrize("metric, want", [
    ("quench.energy_idle", 100.0 * (10 + 20) / 100),
    ("quench.energy_device_ms", (20.0 + 16.0) / 2),
    ("quench.trotter_device_ms", (9.0 + 11.0) / 2),
])
def test_quench_readers(program, metric, want):
    assert _read(metric, _record(OPS)) == pytest.approx(want)


def test_idle_gaps_go_to_the_innermost_span_by_midpoint(program):
    idle = PS.idle_by_span(_record(OPS))
    assert idle == {"expec.value": [pytest.approx(0.030), 2],
                    PS.NO_SPAN: [pytest.approx(0.025), 2]}
    # the energy's idle is a part of the device's
    busy = _trace(OPS).busy_s()
    assert sum(s for s, _ in idle.values()) == pytest.approx(0.1 - busy)
    program["spans"] = [_span("expec.value", 12, 18)]
    assert PS.idle_by_span(_record(OPS)) == {
        "expec.value": [pytest.approx(0.010), 1],
        PS.NO_SPAN: [pytest.approx(0.045), 3]}


@pytest.mark.parametrize("spans, want", [
    ([(0, 10, "a"), (2, 5, "b")], [(0, 2, "a"), (2, 5, "b"), (5, 10, "a")]),
    ([(0, 4, "a"), (4, 8, "b")], [(0, 4, "a"), (4, 8, "b")]),
    ([(0, 10, "a"), (1, 9, "b"), (2, 3, "c"), (5, 6, "c")],
     [(0, 1, "a"), (1, 2, "b"), (2, 3, "c"), (3, 5, "b"), (5, 6, "c"),
      (6, 9, "b"), (9, 10, "a")]),
])
def test_innermost_stretches(spans, want):
    got = PS.innermost([_span(n, a, b) for a, b, n in spans])
    assert got == [(a * MS_NS, b * MS_NS, n) for a, b, n in want]


@pytest.mark.parametrize("spans, jobs, want", [
    ([_span("readout.sample", 1, 5, device_ms=30.0),
      _span("readout.linear_xeb", 5, 7, device_ms=2.0)], 2, 16.0),
    # a readout inside another counts once
    ([_span("readout.purity", 1, 5, device_ms=4.0),
      _span("readout.total_prob", 2, 3, "readout.purity", device_ms=1.0)],
     1, 4.0),
    ([_span("readout.total_prob", 1, 5, device_ms=1.5),
      _span("expec.value", 5, 9, device_ms=9.0)], 3, 0.5),
])
def test_readout_ms_sums_a_jobs_readouts(program, spans, jobs, want):
    program["spans"] = spans
    assert _read("readout_ms", _record(OPS, jobs)) == pytest.approx(want)


@pytest.mark.parametrize("totals, want", [
    ({"plan.fused": {"calls": 1, "seconds": 0.5},
      "plan.fusion": {"calls": 1, "seconds": 0.3},
      "plan.trotter": {"calls": 2, "seconds": 0.25},
      "plan.expec": {"calls": 1, "seconds": 0.125},
      "evolution.chunk": {"calls": 9, "seconds": 4.0}}, 875.0),
    ({"plan.fused": {"calls": 1, "seconds": 0.25}}, 250.0),
    ({"evolution.chunk": {"calls": 1, "seconds": 0.25}}, None),
])
def test_build_ms_sums_the_builds_not_their_children(program, totals, want):
    program["totals"] = totals
    got = _read("build_ms", _record(OPS))
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("metric", ["quench.energy_idle",
                                    "quench.energy_device_ms",
                                    "quench.trotter_device_ms",
                                    "readout_ms", "build_ms"])
def test_readers_report_nothing_without_spans(monkeypatch, metric):
    """A program without spans (no profiling.spans or span_totals), a
    run with no span of the metric's, or an untraced record: None."""
    rec = _record(OPS)
    monkeypatch.setattr(P, "spans", lambda: [_span("other", 1, 2)])
    monkeypatch.setattr(P, "span_totals", lambda: {})
    assert _read(metric, rec) is None
    assert _read(metric, harness.Record()) is None
    monkeypatch.delattr(P, "spans")
    monkeypatch.delattr(P, "span_totals")
    assert _read(metric, rec) is None
