"""The port's knob registry and runtime audits (quest_tpu_torch.env,
quest_tpu_torch.analysis.audit) on the CPU.

Every knob parses loudly; every keyed knob carries flip values and
appears in engine_mode_key(); the registry holds the reference's scope,
layer, malformed sample and flips wherever the reference registers the
knob (with the port's reasons where it differs); the golden set rebuilds
nothing; every keyed flip misses every program cache; a knob dropped
from engine_mode_key is caught as StaleCacheError (and by QL001, the
static half); the lock-order auditor catches an inversion, counts
re-entry and finds the thread-replica ServeFleet acyclic.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import env as JE

from quest_tpu_torch import env as TE
from quest_tpu_torch.analysis import audit
from quest_tpu_torch.analysis.lint import run_lint

pytestmark = pytest.mark.dtype_agnostic

CPU = "cpu"

# the port's knobs whose scope differs from the reference's, and why
# (env.py says so beside each): the segment driver and slot count are
# read at every program build here, and the native library is loaded
# once per process when a host program's build first needs it
PORT_SCOPES = {"QUEST_FUSED_DRIVER": ("import_once", "keyed"),
               "QUEST_FUSED_NBUF": ("import_once", "keyed"),
               "QUEST_NATIVE_LIB": ("runtime", "import_once")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (the suite runs several workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TE.KNOBS))
def test_every_knob_parses_loudly(name):
    """Each knob's parser rejects its malformed sample and accepts its
    flip values."""
    knob = TE.KNOBS[name]
    assert knob.scope in ("keyed", "import_once", "runtime")
    if knob.malformed is not None:
        with pytest.raises(ValueError):
            knob.parse(knob.malformed)
    for raw in knob.flips or ():
        knob.parse(raw)


@pytest.mark.parametrize("name", sorted(TE.KNOBS))
def test_registry_fields_are_the_references(name):
    knob, ref = TE.KNOBS[name], JE.KNOBS.get(name)
    assert ref is not None, f"{name} is the port's own"
    scope = PORT_SCOPES.get(name, (ref.scope, ref.scope))
    assert (ref.scope, knob.scope) == scope
    assert knob.layer == ref.layer
    assert knob.malformed == ref.malformed
    if knob.scope == "keyed":
        assert knob.flips and len(set(map(knob.parse, knob.flips))) == 2
        if ref.flips:
            assert knob.flips == ref.flips


def test_engine_mode_key_covers_every_keyed_knob():
    keyed = {k.name for k in TE.KNOBS.values() if k.scope == "keyed"}
    assert len(keyed) == 18
    assert [name for name, _ in TE.engine_mode_key()] == sorted(keyed)
    assert not [k.name for k in TE.KNOBS.values()
                if k.scope == "keyed" and not k.flips]


# ---------------------------------------------------------------------------
# the golden set and the compile auditor
# ---------------------------------------------------------------------------


def test_golden_set_rebuilds_nothing():
    aud = audit.golden_retrace_check(device=CPU)
    assert (aud.builds, aud.kernel_builds, aud.kernel_loads) == (0, 0, 0)


def test_compile_auditor_counts_builds_and_nests():
    circuits = audit.golden_circuits()
    with audit.CompileAuditor() as outer:
        audit.run_golden(circuits, CPU)
        first = outer.builds
        with audit.CompileAuditor() as inner:
            audit.run_golden(circuits, CPU)
        assert inner.builds == 0
    # 2 circuits x the per-gate, banded and fused engines
    assert first == outer.builds == 6
    with pytest.raises(audit.StaleCacheError, match="6 program build"):
        outer.assert_no_retrace()


def test_golden_audit_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        audit.golden_retrace_check()


# ---------------------------------------------------------------------------
# knob flips
# ---------------------------------------------------------------------------


def test_knob_flip_audit_all_keyed_knobs():
    report = audit.audit_knob_flips(device=CPU)
    keyed = {k.name for k in TE.KNOBS.values() if k.scope == "keyed"}
    assert {r["knob"] for r in report} == keyed
    for r in report:
        assert all(b >= 1 for b in r["builds"].values()), r
    by = {r["knob"]: r for r in report}
    assert by["QUEST_FUSED_DRIVER"]["fused_driver"] == "grid"
    assert by["QUEST_FUSED_PIPELINE"]["fused_driver"] == "inplace"
    assert by["QUEST_MATMUL_PRECISION"]["fused_tier"] == "high"


def test_flip_audit_restores_the_knobs(monkeypatch):
    from quest_tpu_torch import precision
    monkeypatch.setenv("QUEST_SCHEDULE", "1")
    before = TE.engine_mode_key()
    audit.audit_knob_flips(["QUEST_SCHEDULE", "QUEST_MATMUL_PRECISION",
                            "QUEST_FUSED_DRIVER"], device=CPU)
    assert TE.engine_mode_key() == before
    assert precision._tier_override is None


@pytest.mark.parametrize("name", ["QUEST_SCHEDULE", "QUEST_FUSED_DRIVER",
                                  "QUEST_HOST_BLOCK"])
def test_a_knob_dropped_from_the_mode_key_is_caught(monkeypatch, name):
    """The stale-program bug at run time: a knob every program build
    reads, missing from engine_mode_key (the registry's keyed reads),
    leaves the caches hitting after a flip."""
    monkeypatch.setattr(TE, "_KEYED_READS", tuple(
        r for r in TE._KEYED_READS if r[0].name != name))
    with pytest.raises(audit.StaleCacheError, match=name):
        audit.audit_knob_flips([name], device=CPU)


def test_the_same_bug_is_caught_statically(tmp_path):
    """QL001, the static half: the read of a knob that the mode key does
    not carry (scope runtime) inside a _cached build."""
    pkg = tmp_path / "quest_tpu_torch"
    pkg.mkdir()
    f = pkg / "circuit.py"
    f.write_text("from quest_tpu_torch.env import knob_value\n\n"
                 "class Circuit:\n"
                 "    def compiled(self, n):\n"
                 "        def build():\n"
                 "            return knob_value('QUEST_PLAN_CACHE')\n"
                 "        return self._cached(('pergate', n), build)\n")
    vs = run_lint([str(f)], root=str(tmp_path))
    assert [(v.rule, v.line) for v in vs] == [("QL001", 6)], vs


def test_flip_audit_refuses_a_knob_without_flips():
    with pytest.raises(ValueError, match="no registered flip values"):
        audit.audit_knob_flips(["QUEST_SERVE_MAX_BATCH"], device=CPU)


# ---------------------------------------------------------------------------
# lock order
# ---------------------------------------------------------------------------


def test_lock_order_auditor_catches_seeded_inversion():
    aud = audit.LockOrderAuditor()
    a = aud.wrap("a", threading.Lock())
    b = aud.wrap("b", threading.Lock())

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    cycle = aud.find_cycle()
    assert cycle and cycle[0] == cycle[-1]
    with pytest.raises(audit.LockOrderError):
        aud.assert_acyclic()


def test_lock_order_auditor_counts_reentry_without_edges():
    aud = audit.LockOrderAuditor()
    r = aud.wrap("fleet", threading.RLock())
    with r:
        with r:
            pass
    assert aud.reentries.get("fleet") == 1
    assert aud.acquisitions.get("fleet") == 2
    assert aud.find_cycle() is None
    aud.assert_acyclic()


def test_fleet_workload_lock_order_is_acyclic():
    """The thread-replica fleet under audit: the fleet lock, every
    replica engine's condition and the shared registry lock, through a
    two-program workload."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.serve import ServeFleet, metrics

    rng = np.random.default_rng(7)
    n = 4
    states = rng.standard_normal((8, 2, 1 << n)).astype(np.float32)
    states /= np.sqrt((states ** 2).sum(axis=(1, 2), keepdims=True))
    ca = Circuit(n).h(0).cnot(0, 1).rz(2, 0.25)
    cb = Circuit(n).h(1).cnot(1, 2).rx(3, 0.5)

    aud = audit.LockOrderAuditor()
    reg = metrics.Registry()
    reg._lock = aud.wrap("registry", reg._lock)
    with ServeFleet(replicas=2, registry=reg, max_wait_ms=2, max_batch=4,
                    backoff_base_s=0.0, device=CPU) as fl:
        fl._lock = aud.wrap("fleet", fl._lock)
        for i, e in enumerate(fl._engines):
            e._cond = aud.wrap(f"engine{i}", e._cond)
        futs = [fl.submit(ca if i % 2 == 0 else cb, state=states[i])
                for i in range(8)]
        fl.drain(timeout_s=300)
        for f in futs:
            f.result(timeout=60)
    assert aud.acquisitions.get("fleet") and aud.acquisitions.get(
        "registry"), aud.acquisitions
    aud.assert_acyclic()
