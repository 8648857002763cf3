"""The port's fault injection (quest_tpu_torch/resilience/faults.py) and
its metrics registry (quest_tpu_torch/serve/metrics.py), mirroring
tests/test_resilience.py:84-153: deterministic, seeded and matched hit
counting, loud validation, the QUEST_FAULT_PLAN grammar and knob, the
one-flag zero-cost guard, the site catalog equal to the reference's, and
the sites the port fires (sharded.dispatch, checkpoint.*, durable.*).
The port's module is its own copy: the same plan string must behave the
same in both packages."""

import numpy as np
import pytest

from quest_tpu.resilience import faults as jfaults
from quest_tpu.serve import metrics as jmetrics

from quest_tpu_torch import env as TE
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch.parallel import make_amp_mesh
from quest_tpu_torch.parallel.sharded import apply_circuit_sharded
from quest_tpu_torch.resilience import FaultPlan, InjectedFault, faults
from quest_tpu_torch.serve import metrics

pytestmark = pytest.mark.dtype_agnostic


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


def _hits(plan, site, n, ctx=None):
    out = []
    for _ in range(n):
        try:
            plan.check(site, ctx or {})
            out.append(0)
        except Exception:
            out.append(1)
    return out


def test_fault_plan_is_deterministic():
    plan = FaultPlan()
    plan.inject("serve.dispatch", error=RuntimeError("boom"), after_n=2,
                every_n=2, times=2)
    assert _hits(plan, "serve.dispatch", 10) == [0, 0, 0, 1, 0, 1, 0, 0, 0, 0]
    assert plan.fired("serve.dispatch") == 2
    assert plan.fired() == 2


def test_fault_plan_probabilistic_replay_is_deterministic():
    def fires(seed, mod):
        return _hits(mod.FaultPlan().inject("serve.demux", p=0.5, seed=seed),
                     "serve.demux", 32)
    assert fires(3, faults) == fires(3, faults)
    assert fires(3, faults) != fires(4, faults)
    assert 0 < sum(fires(3, faults)) < 32
    # the same seeded sequence as the reference's module
    assert fires(3, faults) == fires(3, jfaults)


def test_fault_plan_match_gates_the_hit_count():
    plan = FaultPlan()
    plan.inject("serve.dispatch", match=lambda ctx: ctx.get("tag") == "bad")
    plan.check("serve.dispatch", {"tag": "good"})
    with pytest.raises(InjectedFault):
        plan.check("serve.dispatch", {"tag": "bad"})


def test_fault_plan_validates_loudly():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan().inject("serve.not_a_site")
    with pytest.raises(ValueError, match="after_n"):
        FaultPlan().inject("serve.demux", after_n=-1)
    with pytest.raises(ValueError, match="every_n"):
        FaultPlan().inject("serve.demux", every_n=0)
    with pytest.raises(ValueError, match="times"):
        FaultPlan().inject("serve.demux", times=0)
    with pytest.raises(ValueError, match="p must be"):
        FaultPlan().inject("serve.demux", p=1.5)


def test_parse_plan_grammar_and_knob(monkeypatch):
    plan = faults.parse_plan(
        "serve.dispatch:error=RuntimeError:after=2:times=1;"
        "serve.worker_loop:every=3:seed=7")
    assert not plan.empty
    for bad in ("serve.nope", "serve.demux:after=x",
                "serve.demux:error=NotAnError", "serve.demux:wat=1",
                "serve.demux:p=maybe", "serve.demux:times"):
        with pytest.raises(ValueError):
            faults.parse_plan(bad)
        with pytest.raises(ValueError):
            jfaults.parse_plan(bad)
    k = TE.KNOBS["QUEST_FAULT_PLAN"]
    assert k.scope != "keyed" and k.default is None
    assert isinstance(k.parse("serve.demux:times=1"), FaultPlan)
    monkeypatch.setenv("QUEST_FAULT_PLAN", "serve.not_a_site")
    with pytest.raises(ValueError):
        TE.knob_value("QUEST_FAULT_PLAN")


def test_install_from_env_arms_the_plan_once(monkeypatch):
    monkeypatch.setattr(faults, "_ENV_INSTALLED", False)
    faults.install(None)
    monkeypatch.setenv("QUEST_FAULT_PLAN", "durable.step:times=1")
    faults.install_from_env()
    assert faults.ACTIVE and faults.current() is not None
    first = faults.current()
    faults.install_from_env()                # once per process
    assert faults.current() is first


def test_empty_plan_keeps_the_flag_off():
    with faults.active(FaultPlan()):
        assert faults.ACTIVE is False
    plan = FaultPlan().inject("serve.demux", times=1)
    with faults.active(plan):
        assert faults.ACTIVE is True
    assert faults.ACTIVE is False


def test_site_catalog_is_the_reference_catalog():
    assert faults.SITES == jfaults.SITES
    assert issubclass(InjectedFault, RuntimeError)


def test_sharded_dispatch_site_fires():
    mesh = make_amp_mesh(2, devices=["cpu"] * 2)
    c = Circuit(4).h(0).cnot(0, 3)
    q = TS.create_qureg(4, device="cpu")
    plan = FaultPlan().inject("sharded.dispatch", times=1)
    seen = []
    plan.inject("sharded.dispatch", error=RuntimeError,
                match=lambda ctx: seen.append(ctx) or False)
    with faults.active(plan):
        with pytest.raises(InjectedFault):
            apply_circuit_sharded(q, c.ops, mesh)
        out = apply_circuit_sharded(q, c.ops, mesh)
    assert plan.fired("sharded.dispatch") == 1
    assert seen[0] == {"num_qubits": 4, "num_ops": 2}
    assert abs(TS.to_dense(out)[0] - 2 ** -0.5) < 1e-6


# -- the metrics registry the durable executor records into -------------------


def test_registry_snapshot_schema_matches_the_reference():
    for mod in (metrics, jmetrics):
        r = mod.Registry()
        r.counter("c").inc()
        r.counter("c").inc(2)
        g = r.gauge("g")
        g.set(5)
        g.dec(2)
        g.inc(0.5)
        for x in range(1, 101):
            r.histogram("h").observe(float(x))
        snap = r.snapshot()
        assert snap["counters"] == {"c": 3}
        assert snap["gauges"] == {"g": 3.5}
        h = snap["histograms"]["h"]
        assert h["count"] == 100 and h["mean"] == pytest.approx(50.5)
        assert (h["p50"], h["p95"], h["p99"]) == (51.0, 95.0, 99.0)
        assert r.histogram("h").sum == pytest.approx(5050.0)
    assert metrics.snapshot() == metrics.REGISTRY.snapshot()
    empty = metrics.Registry().histogram("e").summary()
    assert empty == {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                     "p99": 0.0}
    assert metrics.RESERVOIR == jmetrics.RESERVOIR


def test_durable_knobs_parse_like_the_reference(monkeypatch):
    from quest_tpu import env as JE
    for name, good, bad in (("QUEST_DURABLE_EVERY", "4", "0"),
                            ("QUEST_INTEGRITY", "0", "2"),
                            ("QUEST_INTEGRITY_TOL", "0.5", "-1"),
                            ("QUEST_CHECKPOINT_KEEP", "3", "0"),
                            ("QUEST_DURABLE_ELASTIC", "1", "yes")):
        assert TE.KNOBS[name].scope != "keyed"
        assert TE.KNOBS[name].default == JE.KNOBS[name].default
        monkeypatch.setenv(name, good)
        assert TE.knob_value(name) == JE.knob_value(name)
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError) as mine:
            TE.knob_value(name)
        with pytest.raises(ValueError) as ref:
            JE.knob_value(name)
        assert str(mine.value) == str(ref.value)
        monkeypatch.delenv(name)
    # none of them enters a program cache key
    keyed = dict(TE.engine_mode_key())
    assert not {"QUEST_DURABLE_EVERY", "QUEST_FAULT_PLAN"} & set(keyed)
    assert np.isclose(TE.knob_value("QUEST_INTEGRITY_TOL"), 1e-3)
