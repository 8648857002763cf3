"""The port's plan IR, autotuner and plan cache (quest_tpu_torch/plan.py).

Against the JAX package where the answer does not depend on the chip:
`Circuit.plan_stats()` (a view of plan.build_plan) gives the reference's
scheduler counters, flat/planned op counts and banded pass model, and
its fused record under band_plan.TPU_GEOMETRY equals the reference's
pallas_band record; the transpile axis and explain()'s transpile line
equal the reference's. The port's own answers: the H100 per-gate and
banded prices are the card's readings over the flagship's op and pass
counts, with provenance, and autotune prices with them; ties go to the
incumbent (Circuit.apply's dispatch); the cache round-trips by value in a
throwaway directory and counts stale and corrupt entries as the
reference does; the port's key differs from the reference's plan_key;
sweep_chunk follows QUEST_HBM_BYTES; the sharded search answers and
build_plan(devices=) gives the comm record; TrotterCircuit.plan_stats and
variational.sweep(chunk='auto') answer."""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import evolution as JEV
from quest_tpu import plan as JP
from quest_tpu.circuit import Circuit as JCircuit
from quest_tpu.circuit import random_circuit as jrandom_circuit
from quest_tpu.ops import pallas_band as PB

from quest_tpu_torch import circuit as TC
from quest_tpu_torch import env
from quest_tpu_torch import evolution as EV
from quest_tpu_torch import plan as P
from quest_tpu_torch import variational as V
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.entry import flagship_circuit, gallery_qasm, tfim_sum
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F

pytestmark = pytest.mark.dtype_agnostic

HBM = str(80 * (1 << 30))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Fresh counters, a throwaway plan cache, an 80 GiB memory figure and
    the reference's default driver (its per-process cache, restored)."""
    P.reset_cache_stats()
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.delenv("QUEST_PLAN_CACHE", raising=False)
    monkeypatch.setenv("QUEST_HBM_BYTES", HBM)
    monkeypatch.setattr(PB, "_DRIVER_EFFECTIVE", "pipelined")
    yield
    P.reset_cache_stats()


def _small(cls, n=6):
    c = cls(n).h(0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c.rz(2, 0.25).rx(1, 0.5).cz(0, 3)


def _pair(name):
    """(port circuit, reference circuit) built the same way."""
    if name.startswith("rcs"):
        n = int(name[3:])
        return random_circuit(n, 3, seed=n), jrandom_circuit(n, 3, seed=n)
    if name.startswith("noisy"):
        cs = (random_circuit(6, 2, seed=2), jrandom_circuit(6, 2, seed=2))
        for c in cs:
            c.damping(1, 0.1).depolarising(3, 0.05)
        return cs
    if name.startswith("gallery-"):
        cls, n = name.split("-")[1:]
        text = gallery_qasm(int(n))[cls]
        return (Circuit.from_qasm(text, transpile=False),
                JCircuit.from_qasm(text, transpile=False))
    return _small(Circuit), _small(JCircuit)


CASES = [("small", False), ("rcs8", False), ("rcs12", False),
         ("rcs14", False), ("noisy", True), ("rcs6", True),
         ("gallery-qft-10", False), ("gallery-qaoa-11", False),
         ("gallery-adder-10", False), ("gallery-rcs-12", False)]


@pytest.mark.parametrize("scheduled", [True, False])
@pytest.mark.parametrize("name,density", CASES)
def test_plan_stats_equal_reference(name, density, scheduled, monkeypatch):
    if not scheduled:
        monkeypatch.setenv("QUEST_SCHEDULE", "0")
    mine, ref = _pair(name)
    got = P.build_plan(mine, density=density,
                       budgets=BP.TPU_GEOMETRY).stats()
    want = ref.plan_stats(density=density)
    for key in ("scheduled", "flat_ops", "planned_ops", "scheduler",
                "banded", "fused", "transpile"):
        assert got.get(key) == want.get(key), key
    # the default record is the Hopper plan
    hop = mine.plan_stats(density=density)
    assert hop["banded"] == got["banded"]
    if "fused" in hop:
        assert hop["fused"]["pipeline_driver"] == "decoupled"


def test_batched_record_below_and_above_the_kernel_tier():
    for n in (6, 12):
        c = random_circuit(n, 2, seed=1)
        rec = c.plan_stats(batch=5)["batched"]
        assert rec["batch"] == rec["bucket"] == rec["states_per_sweep"] == 5
        if n < 10:
            assert rec["hbm_sweeps"] == \
                c.plan_stats()["banded"]["full_state_passes"]
        else:
            assert rec["hbm_sweeps"] == c.plan_stats()["fused"]["hbm_sweeps"]


def test_plan_stats_rejects_dynamic_circuits():
    c = Circuit(3).h(0).measure(0)
    with pytest.raises(Exception, match="mid-circuit"):
        c.plan_stats()
    with pytest.raises(Exception, match="mid-circuit"):
        P.autotune(c)


# ---------------------------------------------------------------------------
# the card's prices
# ---------------------------------------------------------------------------

def test_h100_prices_are_card_readings_over_the_flagship_counts():
    model = TC._COST_MODELS["h100"]
    assert model["pergate_op"] == pytest.approx(1276.7 / 166 * 4, rel=1e-12)
    assert model["banded_pass"] == pytest.approx(164.7 / 18 * 4, rel=1e-12)
    for key in ("pergate_provenance", "banded_provenance"):
        assert "PERF.md" in model[key]
        assert "NVIDIA H100 80GB HBM3, 700 W" in model[key]
    # the counts the derivation divides by: the flagship's flat ops and
    # its full-state passes under the banded engine's own model
    c = flagship_circuit()
    st = c.plan_stats()
    assert st["flat_ops"] == 166
    assert st["banded"]["full_state_passes"] == 18
    assert st["banded"]["band_passes"] == 12 and \
        st["banded"]["diag_runs"] == 6


def test_autotune_prices_with_the_h100_entries(monkeypatch):
    monkeypatch.setenv("QUEST_TRANSPILE", "0")
    model = TC._COST_MODELS["h100"]
    for n in (8, 12, 16):
        c = random_circuit(n, 3, seed=n)
        plan = P.autotune(c, persist=False)
        st = c.plan_stats()
        scale = (1 << n) / (1 << 30)
        cand = plan.candidates
        assert cand["pergate"]["total_ms"] == pytest.approx(
            st["flat_ops"] * model["pergate_op"] * scale, rel=1e-5,
            abs=1e-6)          # the record keeps 6 decimals of a ms
        assert cand["banded"]["total_ms"] == pytest.approx(
            st["banded"]["full_state_passes"] * model["banded_pass"]
            * scale, rel=1e-5, abs=1e-6)
        if n >= 10:
            parts = BP.maybe_sweep(BP.segment_plan(
                F.plan(c._planned_flat(n, False), n,
                       bands=BP.plan_bands(n)), n), n)
            lo, hi = TC._estimate_ms(parts, n, model)
            assert cand["fused"]["total_ms"] == pytest.approx(
                (lo + hi) / 2, rel=1e-5, abs=1e-6)
        assert not any(k.startswith("sharded") for k in cand)
        assert set(P.ENGINES) >= {k.split(":")[0] for k in cand}


@pytest.mark.parametrize("autoroute", ["1", "0"])
def test_incumbent_follows_apply_and_wins_ties(autoroute, monkeypatch):
    monkeypatch.setenv("QUEST_APPLY_AUTOROUTE", autoroute)
    small, big = random_circuit(6, 2, seed=3), random_circuit(8, 10, seed=3)
    assert len(small.ops) <= TC.PERGATE_COMPILE_WARN_OPS < len(big.ops)
    assert P._incumbent_engine(small) == "pergate"
    assert P._incumbent_engine(big) == ("banded" if autoroute == "1"
                                        else "pergate")
    noisy = random_circuit(8, 10, seed=3).damping(0, 0.1)
    assert P._incumbent_engine(noisy) == "pergate"
    for c in (small, big):
        plan = P.autotune(c, persist=False)
        assert plan.incumbent == P._incumbent_engine(c)
        inc = plan.candidates[plan.incumbent]
        assert P._rank(plan.cost) <= P._rank(inc)
        if P._rank(plan.cost) == P._rank(inc):
            assert plan.engine == plan.incumbent
    # a tie: every candidate priced alike keeps the incumbent
    monkeypatch.setattr(P, "_rank", lambda cost: (0,))
    assert P.autotune(big, persist=False).engine == P._incumbent_engine(big)


def test_advisory_and_f64_candidates_are_never_selected():
    c = random_circuit(12, 3, seed=4)
    plan = P.autotune(c, dtype=np.float64, persist=False)
    assert plan.candidates["fused"]["selectable"] is False
    assert not plan.engine.startswith("fused")
    assert any(not v["selectable"] for k, v in plan.candidates.items()
               if k.startswith("banded:"))


def test_transpile_axis_and_knob(monkeypatch):
    text = gallery_qasm(10)["qaoa"]
    c = Circuit.from_qasm(text, transpile=False)
    plan = P.autotune(c, persist=False)
    assert plan.transpile["ops_out"] < plan.transpile["ops_in"]
    assert any(k.endswith(":transpiled") for k in plan.candidates)
    monkeypatch.setenv("QUEST_TRANSPILE", "1")
    forced = P.autotune(c, persist=False)
    assert forced.engine.endswith(":transpiled")
    assert forced.transpile["chosen"]
    monkeypatch.setenv("QUEST_TRANSPILE", "0")
    off = P.autotune(c, persist=False)
    assert off.transpile is None
    assert not any(k.endswith(":transpiled") for k in off.candidates)


@pytest.mark.parametrize("cls", ["qft", "qaoa", "rcs", "adder"])
def test_compiled_for_runs_the_chosen_engine(cls, monkeypatch):
    """The chosen engine's program of the (maybe transpiled) stream gives
    the raw stream's state (f32 1e-5 x max|amp|)."""
    monkeypatch.setenv("QUEST_TRANSPILE", "1")
    n = 10
    c = Circuit.from_qasm(gallery_qasm(n)[cls], transpile=False)
    plan = P.autotune(c, persist=False)
    fn = P.compiled_for(c, plan, device="cpu")
    v = torch.zeros((2, 1 << n))
    v[0, 0] = 1.0
    got = fn(v.clone())
    want = c.compiled_banded(n, device="cpu")(v.clone())
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ---------------------------------------------------------------------------
# keys and the cache
# ---------------------------------------------------------------------------

def test_plan_key_is_value_addressed_and_the_ports_own():
    kw = dict(density=False, dtype=np.float32, batch=None)
    k1 = P.plan_key(_small(Circuit), **kw)
    assert k1 == P.plan_key(_small(Circuit), **kw) and isinstance(k1, str)
    assert P.plan_key(_small(Circuit).rx(0, 0.125), **kw) != k1
    assert P.plan_key(_small(Circuit), density=True, dtype=np.float32,
                      batch=None) != k1
    assert P.plan_key(_small(Circuit), density=False, dtype=np.float64,
                      batch=None) != k1
    assert P.plan_key(_small(Circuit), density=False, dtype=np.float32,
                      batch=4) != k1
    assert P.plan_key(_small(Circuit), kind="NVIDIA H100 80GB HBM3",
                      **kw) != k1
    ref = JP.plan_key(_small(JCircuit), density=False, dtype=np.float32,
                      batch=None, devices=None)
    assert ref != k1
    assert P.device_kind("cpu") == "cpu"


def test_plan_cache_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("QUEST_PLAN_CACHE_DIR")
    path = P.plan_cache_dir(create=False)
    assert path.endswith(os.path.join("build", "quest_tpu_torch_plans"))
    assert ".jax_cache" not in path
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", "/elsewhere/plans")
    assert P.plan_cache_dir(create=False) == "/elsewhere/plans"


def test_plan_round_trips_through_the_cache_by_value(tmp_path):
    plan = P.autotune(_small(Circuit))
    assert plan.source == "search"
    st = P.cache_stats()
    assert st["searches"] == 1 and st["stores"] == 1 and st["misses"] == 1
    loaded = P.load_plan(plan.key)
    assert loaded is not None and loaded.source == "cache"
    assert json.loads(json.dumps(dataclasses.asdict(
        dataclasses.replace(loaded, source="search")))) == \
        json.loads(json.dumps(dataclasses.asdict(plan)))
    again = P.autotune(_small(Circuit))
    assert again.source == "cache" and again.engine == plan.engine
    assert P.cache_stats()["searches"] == 1
    assert P.cache_stats()["hits"] == 1
    assert os.listdir(tmp_path / "plans") == [f"plan-{plan.key}.json"]


def _damage(tmp_path, key, fn):
    path = tmp_path / "plans" / f"plan-{key}.json"
    meta = json.loads(path.read_text())
    path.write_text(fn(meta))


@pytest.mark.parametrize("damage,counter", [
    (lambda m: json.dumps(dict(m, engine="pergate" if m["engine"] != "pergate"
                               else "banded")), "corrupt"),
    (lambda m: json.dumps(dict(m, version=P.PLAN_FORMAT_VERSION + 1)),
     "stale"),
    (lambda m: "{not json", "corrupt"),
    (lambda m: json.dumps(dict(m, key="0" * 64, plan_digest=P._self_digest(
        dict(m, key="0" * 64)))), "corrupt"),
])
def test_damaged_entries_are_skipped_loudly(damage, counter, tmp_path,
                                            capsys):
    plan = P.autotune(_small(Circuit))
    _damage(tmp_path, plan.key, damage)
    P.reset_cache_stats()
    again = P.autotune(_small(Circuit))
    assert again.source == "search"
    assert counter.upper() in capsys.readouterr().err
    st = P.cache_stats()
    assert st[counter] == 1 and st["searches"] == 1
    assert P.autotune(_small(Circuit)).source == "cache"


def test_cache_knob_and_keyed_mode(monkeypatch):
    c = _small(Circuit)
    k_on = P.plan_key(c, density=False, dtype=np.float32, batch=None)
    monkeypatch.setenv("QUEST_PLAN_CACHE", "0")
    assert P.autotune(c).source == "search"
    assert P.autotune(c).source == "search"
    st = P.cache_stats()
    assert st["hits"] == 0 and st["stores"] == 0 and st["searches"] == 2
    monkeypatch.delenv("QUEST_PLAN_CACHE")
    for knob, value in (("QUEST_SCHEDULE", "0"), ("QUEST_TRANSPILE", "0")):
        monkeypatch.setenv(knob, value)
        assert P.plan_key(c, density=False, dtype=np.float32,
                          batch=None) != k_on
        monkeypatch.delenv(knob)
    unkeyed = Circuit(2)
    unkeyed.ops.append(TC.GateOp("parity", (0,), operand=torch.tensor(
        0.3, requires_grad=True)))
    assert P.plan_key(unkeyed, density=False, dtype=np.float32,
                      batch=None) is None


@pytest.mark.parametrize("raw,want", [("x", ValueError), ("2", ValueError),
                                      ("0", False), ("1", True)])
def test_plan_cache_knob_parses_loudly(raw, want, monkeypatch):
    monkeypatch.setenv("QUEST_PLAN_CACHE", raw)
    if want is ValueError:
        with pytest.raises(ValueError, match="QUEST_PLAN_CACHE"):
            env.knob_value("QUEST_PLAN_CACHE")
    else:
        assert env.knob_value("QUEST_PLAN_CACHE") is want


@pytest.mark.parametrize("raw", ["auto", "0", "1", "2", "on"])
def test_transpile_knob_parses_loudly_and_is_keyed(raw, monkeypatch):
    monkeypatch.setenv("QUEST_TRANSPILE", raw)
    if raw in ("auto", "0", "1"):
        assert ("QUEST_TRANSPILE", raw) in env.engine_mode_key()
    else:
        with pytest.raises(ValueError, match="QUEST_TRANSPILE"):
            env.engine_mode_key()


# ---------------------------------------------------------------------------
# capacity, sharding, introspection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hbm,total,n,want", [
    (1 << 30, 100, 20, 32), (1 << 30, 10, 20, 8), (1 << 24, 100, 20, 1),
    (80 << 30, 1000, 24, 128), (80 << 30, 3, 10, 2)])
def test_sweep_chunk_follows_hbm_bytes(hbm, total, n, want, monkeypatch):
    monkeypatch.setenv("QUEST_HBM_BYTES", str(hbm))
    assert P.sweep_chunk(total, n) == want


def test_sharded_arguments_name_a10(monkeypatch, tmp_path):
    """The priced sharded search and QuESTEnv.sharding_for answer since
    ROADMAP A10b (tests/test_torch_sharded_consumers.py holds them);
    build_plan(devices=) and plan_stats(devices=) give the comm record
    (tests/test_torch_comm.py holds it equal to the reference's)."""
    from quest_tpu_torch.parallel import make_amp_mesh
    monkeypatch.setenv("QUEST_HBM_BYTES", str(16 << 30))
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", str(tmp_path))
    c = _small(Circuit)
    assert P.autotune(c, devices=4, persist=False).devices == 4
    mesh = make_amp_mesh(2, devices=["cpu"] * 2)
    assert P.autotune(c, mesh=mesh, persist=False).devices == 2
    with pytest.raises(ValueError, match="topology"):
        P.autotune(c, topology="ring")
    assert env.QuESTEnv("cpu").sharding_for(10) is None
    assert env.QuESTEnv(mesh=mesh).sharding_for(10) is mesh
    plan = P.build_plan(c, devices=2)
    assert plan.devices == 2 and plan.incumbent == "sharded-banded"
    assert plan.comm["devices"] == 2
    assert c.plan_stats(devices=2)["comm"] == plan.comm


@pytest.mark.parametrize("knob", ["auto", "0", "1"])
def test_explain_prints_its_transpile_and_plan_lines(knob, monkeypatch):
    monkeypatch.setenv("QUEST_TRANSPILE", knob)
    for n in (6, 12):
        text = gallery_qasm(n)["qaoa"]
        mine = Circuit.from_qasm(text, transpile=False).explain()
        ref = JCircuit.from_qasm(text, transpile=False).explain()
        t_mine = [ln for ln in mine.splitlines()
                  if ln.startswith("  transpile")]
        t_ref = [ln for ln in ref.splitlines()
                 if ln.startswith("  transpile")]
        assert t_mine == t_ref and len(t_mine) == 1
        plan = [ln for ln in mine.splitlines() if ln.startswith("  plan:")]
        assert len(plan) == 1 and "searched" in plan[0]
        assert "priced for cpu" in plan[0]
        # then the host line, last, as the reference orders them
        assert mine.splitlines()[-3:-1] == t_mine + plan
        host = mine.splitlines()[-1]
        assert host.startswith("  cpu fallback ")
        assert host == ref.splitlines()[-1]
    # explain never touches the plan cache
    assert P.cache_stats()["stores"] == 0


def test_trotter_plan_stats_answers():
    codes, cf = tfim_sum(6)
    mine = EV.trotter_circuit((codes, cf), 0.1, steps=2)
    ref = JEV.trotter_circuit((codes, cf), 0.1, steps=2)
    got, want = mine.plan_stats(), ref.plan_stats()
    for key in ("flat_ops", "planned_ops", "scheduler", "banded"):
        assert got[key] == want[key], key
    for key in ("steps", "order", "terms", "diag_terms", "frames",
                "diag_groups", "fusion", "baseline_hbm_sweeps_per_step"):
        assert got["trotter"][key] == want["trotter"][key], key
    assert got["trotter"] == EV.trotter_plan_stats(
        (codes, cf), 0.1, steps=2)


def test_sweep_auto_chunk_answers():
    n = 4

    def ansatz(amps, th):
        amps = V.ry(amps, n, 0, th[0])
        amps = V.cnot(amps, n, 0, 1)
        return V.rz(amps, n, 1, th[1])
    codes = np.zeros((1, n), dtype=int)
    codes[0, 1] = 3
    energy = V.expectation(ansatz, n, codes, [1.0], device="cpu")
    batch = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (5, 2)),
                         dtype=torch.float32)
    auto = V.sweep(energy, batch, chunk="auto")
    assert torch.equal(auto, V.sweep(energy, batch))
    with pytest.raises(ValueError, match="num_qubits"):
        V.sweep(lambda th: th.sum(), batch, chunk="auto")
