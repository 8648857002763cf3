"""The port's serving fleet (quest_tpu_torch.serve.ServeFleet) on thread
replicas on the CPU, mirroring tests/test_fleet.py and the fleet cases of
tests/test_elastic.py.

Every fleet here runs on device="cpu". The same circuits and
numpy-seeded states go through the reference's
quest_tpu.serve.ServeFleet(replicas=2, interpret=True): raw planes and a
PauliSum observable agree within 2e-5. A durable job through the fleet,
preempted, crashed or failed over, equals a direct run_durable bit for
bit. Sheds land only on the lowest pending class; tenant quotas release
on completion. A trajectory request's uniforms are drawn once at the
fleet's submit: its draws equal run_batched's from the same generator
state whether a thread replica serves it or a failover requeue moves it,
and the client's generator advances as on one ServeEngine.

Every future, drain and join has an explicit timeout.
"""

import hashlib
import importlib.util
import io
import os
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from quest_tpu.serve import ServeFleet as JServeFleet
from quest_tpu.serve import metrics as jmetrics

from quest_tpu_torch import convert
from quest_tpu_torch import state as TS
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch.parallel import make_amp_mesh
from quest_tpu_torch.resilience import FaultPlan, faults, run_durable
from quest_tpu_torch.serve import (RejectedError, ServeEngine, ServeFleet,
                                   ShedError, TenantQuotaExceeded, metrics,
                                   warmup)
from quest_tpu_torch.serve.engine import _num_channels

from .test_torch_comm import _one_thread_per_worker  # noqa: F401
from .test_torch_durable import scattered_circuit
from .test_torch_elastic import elastic_circuit, portable_env  # noqa: F401
from .test_torch_serve import _close, _pauli_pair, _ref_circuit

pytestmark = pytest.mark.dtype_agnostic

N = 6
ND = 8          # durable jobs: below the kernel's tier, the banded engine
T_OUT = 120     # seconds any one future or drain may take


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


def _circuit_a(n: int = N) -> Circuit:
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    return c.cnot(0, 1).rz(2, 0.25).cz(1, 3).rx(0, 0.5)


def _circuit_b(n: int = N) -> Circuit:
    c = Circuit(n).h(0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c.t(1).ry(3, 0.7)


def _noisy_circuit(n: int = 4) -> Circuit:
    c = Circuit(n).h(0).cnot(0, 1)
    c.depolarising(0, 0.1).damping(1, 0.2)
    return c.ry(2, 0.3).dephasing(2, 0.15)


def _random_states(b: int, n: int = N, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    return s / np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))


def _fleet(**kw):
    kw.setdefault("registry", metrics.Registry())
    kw.setdefault("backoff_base_s", 0.0)     # tests never sleep restarts
    kw.setdefault("device", "cpu")
    return ServeFleet(**kw)


def _alone(c, states):
    fn = c.compiled_batched(1, device="cpu")
    return [fn(torch.from_numpy(np.array(s))[None])[0] for s in states]


def _sha(planes) -> str:
    return hashlib.sha256(np.asarray(planes).tobytes()).hexdigest()


def _debug_planes(n: int) -> np.ndarray:
    q = TS.init_debug_state(TS.create_qureg(n, device="cpu"))
    return q.amps.numpy().reshape(2, -1).copy()


def _durable_setup(tmp_path, layers=4):
    """The durable circuit, its |debug> input planes and the hash of a
    direct run_durable (the uninterrupted reference)."""
    circ = scattered_circuit(Circuit, ND, layers)
    s0 = _debug_planes(ND)
    q0 = TS.Qureg(amps=torch.from_numpy(s0.copy()), num_qubits=ND)
    ref = run_durable(circ, q0, str(tmp_path / "ref"), every=2)
    return circ, s0, _sha(ref.amps.reshape(2, -1).numpy())


def _drain(fl):
    fl.drain(timeout_s=T_OUT)


# ---------------------------------------------------------------------------
# against the reference's ServeFleet
# ---------------------------------------------------------------------------


def test_fleet_matches_the_reference_fleet_planes_and_pauli_sum():
    """The same circuit, states and PauliSum through both packages' 2-
    replica fleets: planes within 2e-5 x max|amp|, values within 2e-5."""
    jc = _ref_circuit(N)
    tc = convert.circuit_from_ops(jc.ops, N)
    states = _random_states(8, N, seed=61)
    jspec, tspec = _pauli_pair(N, 5)
    with JServeFleet(replicas=2, interpret=True, max_wait_ms=10_000,
                     max_batch=8, registry=jmetrics.Registry()) as jf:
        jfuts = [jf.submit(jc, state=s) for s in states[:5]]
        jfuts += [jf.submit(jc, state=s, observable=jspec)
                  for s in states[5:]]
        jf.drain(timeout_s=T_OUT)
        jout = [jf_.result(timeout=T_OUT) for jf_ in jfuts]
    with _fleet(replicas=2, max_wait_ms=10_000, max_batch=8) as fl:
        futs = [fl.submit(tc, state=s) for s in states[:5]]
        futs += [fl.submit(tc, state=s, observable=tspec)
                 for s in states[5:]]
        _drain(fl)
        tout = [f.result(timeout=T_OUT) for f in futs]
    for got, want in zip(tout[:5], jout[:5]):
        assert _close(got, torch.from_numpy(np.array(want)))
    for got, want in zip(tout[5:], jout[5:]):
        assert abs(float(got) - float(want)) <= 2e-5 * max(1.0,
                                                          abs(float(want)))


# ---------------------------------------------------------------------------
# routing: affinity, spill, demux parity
# ---------------------------------------------------------------------------


def test_fleet_results_match_single_engine_library_calls():
    """A mixed 2-circuit stream over 2 replicas resolves every future to
    the state alone through the batched program."""
    ca, cb = _circuit_a(), _circuit_b()
    states = _random_states(16, seed=3)
    want = [(_alone(ca if i % 2 == 0 else cb, [states[i]]))[0]
            for i in range(16)]
    with _fleet(replicas=2, max_wait_ms=2, max_batch=8) as fl:
        futs = [fl.submit(ca if i % 2 == 0 else cb, state=states[i])
                for i in range(16)]
        _drain(fl)
        got = [f.result(timeout=T_OUT) for f in futs]
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert _close(g, w)


def test_affinity_routes_same_program_to_one_replica():
    c = _circuit_a()
    states = _random_states(6, seed=5)
    reg = metrics.Registry()
    with _fleet(replicas=3, max_wait_ms=2, max_batch=8,
                registry=reg) as fl:
        for s in states:
            fl.submit(c, state=s).result(timeout=T_OUT)
    snap = reg.snapshot()["counters"]
    assert snap["fleet_requests_routed"] == 6
    # the first submit pins the map; the rest hit it
    assert snap["fleet_affinity_hits"] == 5
    assert snap.get("fleet_affinity_spills", 0) == 0


def test_spill_to_least_loaded_on_affinity_overload():
    c = _circuit_a()
    states = _random_states(12, seed=7)
    reg = metrics.Registry()
    # nothing dispatches before the drain, so the affinity replica's
    # queue builds until the spill bound trips
    with _fleet(replicas=2, max_wait_ms=600_000, max_batch=4,
                registry=reg) as fl:
        futs = [fl.submit(c, state=s) for s in states]
        snap = reg.snapshot()["counters"]
        _drain(fl)
        for f in futs:
            f.result(timeout=T_OUT)
    assert snap["fleet_affinity_spills"] >= 1, snap
    assert snap["fleet_requests_routed"] == 12


def test_warmup_accepts_a_fleet():
    c = _circuit_a()
    with _fleet(replicas=2, max_batch=8) as fl:
        report = warmup(fl, [c], buckets=[4])
        assert report["programs"]
        out = fl.submit(c, state=_random_states(1, seed=9)[0]).result(
            timeout=T_OUT)
    assert tuple(out.shape) == (2, 1 << N)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def _r0_popped(msg):
    return FaultPlan().inject(
        "serve.worker_loop", error=RuntimeError(msg),
        match=lambda ctx: (ctx.get("replica") == "r0"
                           and ctx["phase"] == "popped"))


def test_failed_replica_requeues_undispatched_onto_survivor():
    c = _circuit_a()
    states = _random_states(8, seed=11)
    want = _alone(c, states)
    reg = metrics.Registry()
    with faults.active(_r0_popped("card gone")):
        with _fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                    restart_max=1, registry=reg) as fl:
            futs = [fl.submit(c, state=s) for s in states]
            _drain(fl)
            got = [f.result(timeout=T_OUT) for f in futs]
    for g, w in zip(got, want):
        assert _close(g, w)
    snap = reg.snapshot()
    assert snap["counters"]["fleet_failovers"] >= 1
    assert snap["counters"]["serve_requests_served"] == 8
    assert snap["gauges"]["fleet_replicas_healthy"] == 1.0


def test_failover_rebuilds_affinity_off_the_dead_replica():
    c = _circuit_a()
    states = _random_states(4, seed=13)
    with faults.active(_r0_popped("gone")):
        with _fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                    restart_max=0) as fl:
            futs = [fl.submit(c, state=s) for s in states]
            _drain(fl)
            for f in futs:
                f.result(timeout=T_OUT)
            assert all(v != 0 for v in fl._affinity.values())
            f = fl.submit(c, state=states[0])
            _drain(fl)
            assert tuple(f.result(timeout=T_OUT).shape) == (2, 1 << N)


def test_all_replicas_failed_resolves_everything_typed():
    c = _circuit_a()
    states = _random_states(4, seed=17)
    plan = FaultPlan().inject(
        "serve.worker_loop", error=RuntimeError("total outage"),
        match=lambda ctx: ctx["phase"] == "popped")
    with faults.active(plan):
        fl = _fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                    restart_max=0)
        try:
            futs = [fl.submit(c, state=s) for s in states]
            _drain(fl)
            for f in futs:
                with pytest.raises(RejectedError):
                    f.result(timeout=T_OUT)
            assert fl.state == "failed"
            with pytest.raises(RejectedError, match="FAILED"):
                fl.submit(c, state=states[0])
        finally:
            fl.close(timeout_s=60)


def test_request_error_propagates_typed_without_requeue():
    c = _circuit_a()
    states = _random_states(2, seed=19)

    def bad_observable(planes_b):
        raise ValueError("observable shape mismatch")

    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=2, max_batch=8,
                registry=reg) as fl:
        fbad = fl.submit(c, state=states[0], observable=bad_observable)
        fgood = fl.submit(c, state=states[1])
        _drain(fl)
    with pytest.raises(ValueError, match="observable shape"):
        fbad.result(timeout=T_OUT)
    assert tuple(fgood.result(timeout=T_OUT).shape) == (2, 1 << N)
    assert reg.counter("fleet_failovers").value == 0


# ---------------------------------------------------------------------------
# trajectory draws: drawn once at the fleet's submit
# ---------------------------------------------------------------------------


def test_traj_draws_equal_run_batched_on_a_replica_and_after_a_requeue():
    """Two trajectory requests from one generator: served by a thread
    replica, and moved by a failover requeue off a dying replica, each
    draws what run_batched draws from the same generator state, and the
    generator ends where two run_batched draws leave it."""
    c = _noisy_circuit()
    g0 = torch.Generator().manual_seed(23)
    want = []
    for shots in (5, 3):
        want.append(T.run_batched(c, shots, generator=g0, device="cpu"))
    end_state = g0.get_state()
    for fail in (False, True):
        gen = torch.Generator().manual_seed(23)
        plan = _r0_popped("replica lost") if fail else FaultPlan()
        reg = metrics.Registry()
        with faults.active(plan):
            with _fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                        restart_max=0, registry=reg) as fl:
                futs = [fl.submit(c, shots=k, generator=gen)
                        for k in (5, 3)]
                _drain(fl)
                got = [f.result(timeout=T_OUT) for f in futs]
        assert torch.equal(gen.get_state(), end_state)
        for (gp, gd), (wp, wd) in zip(got, want):
            assert torch.equal(gd, wd)
            assert torch.equal(gp, wp)
        if fail:
            assert reg.counter("fleet_requeued_requests").value >= 1


# ---------------------------------------------------------------------------
# tenant admission + priority shed
# ---------------------------------------------------------------------------


def test_tenant_quota_bounds_pending_and_releases_on_completion():
    c = _circuit_a()
    states = _random_states(8, seed=23)
    with _fleet(replicas=2, max_wait_ms=600_000, max_batch=64,
                tenant_quota={"default": 64, "greedy": 2}) as fl:
        f1 = fl.submit(c, state=states[0], tenant="greedy")
        f2 = fl.submit(c, state=states[1], tenant="greedy")
        with pytest.raises(TenantQuotaExceeded, match="greedy"):
            fl.submit(c, state=states[2], tenant="greedy")
        f3 = fl.submit(c, state=states[3], tenant="polite")
        _drain(fl)
        for f in (f1, f2, f3):
            f.result(timeout=T_OUT)
        # completion released the quota
        f4 = fl.submit(c, state=states[4], tenant="greedy")
        fl.submit(c, state=states[5], tenant="greedy")
        _drain(fl)
        f4.result(timeout=T_OUT)
        assert fl._tenant_pending == {}


def test_tenant_quota_parser_grammar():
    from quest_tpu_torch.env import KNOBS
    from quest_tpu_torch.serve.admission import (DEFAULT_TENANT_QUOTA,
                                                 parse_tenant_quota)
    assert parse_tenant_quota("64") == {"default": 64}
    assert parse_tenant_quota("alice=16,bob=0,default=8") == {
        "alice": 16, "bob": 0, "default": 8}
    assert parse_tenant_quota("alice=16,bob=128") == {
        "alice": 16, "bob": 128, "default": DEFAULT_TENANT_QUOTA}
    for bad in ("alice=lots", "=4", "alice=4,alice=5", "default=0", "0"):
        with pytest.raises(ValueError):
            parse_tenant_quota(bad)
    k = KNOBS["QUEST_SERVE_TENANT_QUOTA"]
    assert k.parse("32") == {"default": 32}
    with pytest.raises(ValueError):
        k.parse("alice=lots")


def _shed_fleet(reg, **kw):
    """Queues that build (nothing dispatches before the drain) so the
    pressure crosses the threshold while victims are still evictable."""
    kw.setdefault("replicas", 2)
    kw.setdefault("max_wait_ms", 600_000)
    kw.setdefault("max_queue", 8)
    kw.setdefault("max_batch", 1024)
    kw.setdefault("shed_threshold", 0.5)
    kw.setdefault("priorities", 2)
    return _fleet(registry=reg, **kw)


def test_shed_hits_only_the_lowest_class_until_exhausted():
    c = _circuit_a()
    states = _random_states(32, seed=29)
    reg = metrics.Registry()
    with _shed_fleet(reg) as fl:
        low, low_shed = [], 0
        for i in range(12):
            try:
                low.append(fl.submit(c, state=states[i], tenant="free",
                                     priority=0))
            except ShedError as e:
                assert "pressure" in str(e)
                low_shed += 1
        assert low_shed >= 1
        high = [fl.submit(c, state=states[20 + i], tenant="paying",
                          priority=1) for i in range(4)]
        evicted = [f for f in low
                   if f.done() and isinstance(f.exception(), ShedError)]
        assert len(evicted) == 4
        for f in evicted:
            assert "pressure" in str(f.exception())
        _drain(fl)
        for f in high:
            assert tuple(f.result(timeout=T_OUT).shape) == (2, 1 << N)
    snap = reg.snapshot()["counters"]
    assert snap["shed_requests"] == low_shed + 4
    assert snap["shed_requests_p0"] == snap["shed_requests"]
    assert snap.get("shed_requests_p1", 0) == 0
    assert snap["shed_evictions"] == 4


def test_shed_reaches_higher_class_only_after_lowest_exhausted():
    c = _circuit_a()
    states = _random_states(20, seed=31)
    reg = metrics.Registry()
    with _shed_fleet(reg) as fl:
        kept, shed_p1 = [], 0
        for i in range(14):
            try:
                kept.append(fl.submit(c, state=states[i], priority=1))
            except ShedError:
                shed_p1 += 1
        assert shed_p1 >= 1
        _drain(fl)
        for f in kept:
            f.result(timeout=T_OUT)
    snap = reg.snapshot()["counters"]
    assert snap["shed_requests_p1"] == shed_p1
    assert snap.get("shed_requests_p0", 0) == 0


def test_eviction_frees_the_slot_at_the_hard_queue_bound():
    c = _circuit_a()
    states = _random_states(12, seed=53)
    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=600_000, max_queue=4,
                max_batch=1024, shed_threshold=1.0, priorities=2,
                registry=reg) as fl:
        low = [fl.submit(c, state=states[i], priority=0) for i in range(8)]
        with pytest.raises(RejectedError):
            fl.submit(c, state=states[8], priority=0)
        f_hi = fl.submit(c, state=states[9], priority=1)
        evicted = [f for f in low
                   if f.done() and isinstance(f.exception(), ShedError)]
        assert len(evicted) == 1
        _drain(fl)
        assert tuple(f_hi.result(timeout=T_OUT).shape) == (2, 1 << N)
    assert reg.counter("shed_evictions").value == 1


def test_priority_validates_against_the_knob():
    c = _circuit_a()
    with _fleet(replicas=1, priorities=2) as fl:
        for bad in (2, -1):
            with pytest.raises(ValueError, match="priority"):
                fl.submit(c, state=_random_states(1)[0], priority=bad)


# ---------------------------------------------------------------------------
# durable long jobs through the fleet
# ---------------------------------------------------------------------------


def test_durable_job_through_fleet_matches_direct_run(tmp_path):
    from quest_tpu_torch import checkpoint as ckpt
    circ, s0, ref_hash = _durable_setup(tmp_path)
    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=2, registry=reg) as fl:
        out = fl.submit(circ, state=s0, durable_dir=str(tmp_path / "job"),
                        durable_every=2).result(timeout=T_OUT)
    assert _sha(out) == ref_hash
    assert reg.counter("fleet_durable_jobs").value == 1
    assert reg.counter("serve_durable_jobs").value == 1
    assert not ckpt.step_dirs(str(tmp_path / "job"))


def test_durable_preempt_mid_chain_resumes_in_place(tmp_path):
    circ, s0, ref_hash = _durable_setup(tmp_path)
    reg = metrics.Registry()
    plan = FaultPlan().inject("durable.preempt", after_n=5, times=1)
    with faults.active(plan):
        with _fleet(replicas=2, max_wait_ms=2, registry=reg) as fl:
            out = fl.submit(circ, state=s0,
                            durable_dir=str(tmp_path / "job"),
                            durable_every=2).result(timeout=T_OUT)
    assert plan.fired("durable.preempt") == 1
    assert _sha(out) == ref_hash
    snap = reg.snapshot()["counters"]
    assert snap["durable_resumes"] >= 1
    assert snap["serve_durable_inplace_resumes"] >= 1


def test_durable_worker_crash_requeues_and_resumes_same_engine(tmp_path):
    circ, s0, ref_hash = _durable_setup(tmp_path)
    reg = metrics.Registry()
    plan = FaultPlan()
    plan.inject("durable.preempt", after_n=5, times=1)
    plan.inject("serve.dispatch", error=RuntimeError("transient"),
                match=lambda ctx: ctx.get("durable"), after_n=1,
                times=ServeEngine.DURABLE_RETRY_CAP - 1)
    with faults.active(plan):
        with ServeEngine(max_wait_ms=2, registry=reg, device="cpu",
                         backoff_base_s=0.0) as eng:
            out = eng.submit(circ, state=s0,
                             durable_dir=str(tmp_path / "job"),
                             durable_every=2).result(timeout=T_OUT)
    assert _sha(out) == ref_hash
    snap = reg.snapshot()["counters"]
    assert snap["serve_worker_restarts"] >= 1
    assert snap["durable_resumes"] >= 1


def _r0_durable_dying():
    return dict(site="serve.dispatch", error=RuntimeError("replica dying"),
                match=lambda ctx: (ctx.get("replica") == "r0"
                                   and ctx.get("durable")), after_n=1)


def test_durable_failover_resumes_on_survivor_replica(tmp_path):
    circ, s0, ref_hash = _durable_setup(tmp_path)
    reg = metrics.Registry()
    plan = FaultPlan()
    plan.inject("durable.preempt", after_n=5, times=1)
    plan.inject(**_r0_durable_dying())
    with faults.active(plan):
        with _fleet(replicas=2, max_wait_ms=2, restart_max=1,
                    registry=reg) as fl:
            out = fl.submit(circ, state=s0,
                            durable_dir=str(tmp_path / "job"),
                            durable_every=2).result(timeout=T_OUT)
    assert _sha(out) == ref_hash
    snap = reg.snapshot()["counters"]
    assert snap["fleet_failovers"] >= 1
    assert snap["durable_resumes"] >= 1


def test_bad_durable_dir_fails_typed_not_fleetwide(tmp_path):
    circ = scattered_circuit(Circuit, ND, 2)
    s0 = _debug_planes(ND)
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=2, restart_max=1,
                registry=reg) as fl:
        f = fl.submit(circ, state=s0, durable_dir=str(blocker / "nested"),
                      durable_every=1)
        with pytest.raises(OSError):
            f.result(timeout=T_OUT)
        assert fl.state == "running"
        out = fl.submit(_circuit_a(), state=_random_states(1)[0])
        _drain(fl)
        assert tuple(out.result(timeout=T_OUT).shape) == (2, 1 << N)
    assert reg.counter("serve_worker_restarts").value == 0
    assert reg.counter("fleet_failovers").value == 0


def test_outer_cancel_while_queued_propagates_to_the_replica():
    c = _circuit_a()
    states = _random_states(2, seed=59)
    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=600_000, max_batch=64,
                tenant_quota={"default": 1}, registry=reg) as fl:
        f = fl.submit(c, state=states[0], tenant="t")
        assert f.cancel()
        # the quota slot released at once
        f2 = fl.submit(c, state=states[1], tenant="t")
        _drain(fl)
        assert tuple(f2.result(timeout=T_OUT).shape) == (2, 1 << N)
    snap = reg.snapshot()["counters"]
    assert snap["serve_requests_served"] == 1
    assert snap["serve_requests_cancelled"] >= 1


def test_durable_submit_validation():
    c = _circuit_a()
    with _fleet(replicas=1) as fl:
        with pytest.raises(ValueError, match="durable"):
            fl.submit(c, shots=4, durable_dir="/tmp/x")
        with pytest.raises(ValueError, match="observable"):
            fl.submit(c, state=_random_states(1)[0], durable_dir="/tmp/x",
                      observable=lambda p: p)
        with pytest.raises(ValueError, match="durable_every"):
            fl.submit(c, state=_random_states(1)[0], durable_every=2)
        assert not fl._pending


# ---------------------------------------------------------------------------
# fleet fault sites
# ---------------------------------------------------------------------------


def test_fleet_sites_are_in_the_catalog():
    for site in ("fleet.route", "fleet.failover", "fleet.shed",
                 "fleet.requeue", "fleet.spawn", "ipc.send", "ipc.recv"):
        assert site in faults.SITES
    plan = faults.parse_plan("fleet.route:times=1;fleet.shed:after=5")
    assert not plan.empty


def test_fleet_route_site_fires_typed_in_the_submitter():
    c = _circuit_a()
    reg = metrics.Registry()
    plan = FaultPlan().inject("fleet.route", times=1)
    with faults.active(plan):
        with _fleet(replicas=2, registry=reg) as fl:
            with pytest.raises(faults.InjectedFault):
                fl.submit(c, state=_random_states(1)[0])
            fl.submit(c, state=_random_states(1)[0]).result(timeout=T_OUT)
    assert plan.fired("fleet.route") == 1
    assert reg.counter("serve_faults_injected").value == 1
    assert not fl._pending


def test_fleet_failover_site_fails_the_requeue_typed():
    c = _circuit_a()
    states = _random_states(2, seed=47)
    plan = _r0_popped("gone")
    plan.inject("fleet.failover", error=RuntimeError("failover blocked"))
    with faults.active(plan):
        with _fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                    restart_max=0) as fl:
            futs = [fl.submit(c, state=s) for s in states]
            _drain(fl)
            for f in futs:
                with pytest.raises(RuntimeError, match="failover blocked"):
                    f.result(timeout=T_OUT)
    assert plan.fired("fleet.failover") == len(states)


def test_fleet_shed_site_fires_on_the_shed_decision():
    c = _circuit_a()
    states = _random_states(12, seed=37)
    reg = metrics.Registry()
    plan = FaultPlan().inject("fleet.shed", error=RuntimeError("forced"),
                              times=1)
    with faults.active(plan):
        with _shed_fleet(reg) as fl:
            fired = 0
            for i in range(12):
                try:
                    fl.submit(c, state=states[i], priority=0)
                except ShedError:
                    pass
                except RuntimeError:
                    fired += 1
            assert fired == 1
            _drain(fl)
    assert plan.fired("fleet.shed") == 1


def test_fleet_requeue_site_fails_the_requeue_hop_typed(tmp_path):
    """tests/test_elastic.py:519: fleet.requeue fires on the failover
    re-submit hop of a durable job and resolves it typed."""
    circ = scattered_circuit(Circuit, ND, 4)
    s0 = _debug_planes(ND)
    plan = FaultPlan()
    plan.inject("durable.preempt", after_n=3, times=1)
    plan.inject(**_r0_durable_dying())
    plan.inject("fleet.requeue")
    with faults.active(plan):
        with _fleet(replicas=2, max_wait_ms=2, restart_max=1) as fl:
            fut = fl.submit(circ, state=s0,
                            durable_dir=str(tmp_path / "job"),
                            durable_every=2)
            with pytest.raises(faults.InjectedFault):
                fut.result(timeout=T_OUT)
    assert plan.fired("fleet.requeue") == 1


def test_empty_plan_keeps_fleet_sites_zero_cost():
    """A warmed fleet stream under an empty plan, and under fleet sites
    armed but silent, builds no program: every fleet check is host-side
    behind the one ACTIVE flag (the port's counterpart of the
    reference's no-retrace pin)."""
    ca, cb = _circuit_a(), _circuit_b()
    states = _random_states(16, seed=41)
    with _fleet(replicas=2, max_wait_ms=10_000, max_batch=4) as fl:
        warmup(fl, [ca, cb], buckets=[4])

        def stream():
            futs = [fl.submit(ca if i % 2 == 0 else cb, state=states[i])
                    for i in range(16)]
            _drain(fl)
            for f in futs:
                f.result(timeout=T_OUT)

        stream()
        programs = (len(ca._compiled), len(cb._compiled))
        with faults.active(FaultPlan()):
            stream()
        armed = FaultPlan()
        for site in ("fleet.route", "fleet.failover", "fleet.shed",
                     "fleet.requeue", "serve.dispatch",
                     "checkpoint.load_gang"):
            armed.inject(site, after_n=10 ** 9)
        with faults.active(armed):
            assert faults.ACTIVE
            stream()
        assert (len(ca._compiled), len(cb._compiled)) == programs


# ---------------------------------------------------------------------------
# scrape endpoint + serve_stats
# ---------------------------------------------------------------------------


def _prom_line_ok(line: str) -> bool:
    if not line or line.startswith("#"):
        return True
    return re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
                    r'-?[0-9.eE+-]+(nan|inf)?$', line) is not None


def test_scrape_is_valid_prometheus_text_and_round_trips():
    """A fleet's scrape parses as Prometheus text and round-trips through
    both packages' parse_scrape to the snapshot."""
    c = _circuit_a()
    reg = metrics.Registry()
    with _fleet(replicas=2, max_wait_ms=2, registry=reg) as fl:
        for s in _random_states(3, seed=67):
            fl.submit(c, state=s).result(timeout=T_OUT)
        text = fl.scrape()
    assert text.endswith("\n")
    for line in text.splitlines():
        assert _prom_line_ok(line), f"invalid exposition line: {line!r}"
    assert "# TYPE fleet_requests_routed counter" in text
    assert "# TYPE fleet_pressure gauge" in text
    assert "# TYPE serve_e2e_latency_s summary" in text
    snap = reg.snapshot()
    for back in (metrics.parse_scrape(text), jmetrics.parse_scrape(text)):
        assert back["counters"] == snap["counters"]
        assert back["gauges"] == snap["gauges"]
        got_h = back["histograms"]["serve_e2e_latency_s"]
        want_h = snap["histograms"]["serve_e2e_latency_s"]
        assert got_h["count"] == want_h["count"]
        for k in ("mean", "p50", "p95", "p99"):
            assert got_h[k] == pytest.approx(want_h[k])


def test_scrape_endpoint_serves_real_http():
    reg = metrics.Registry()
    reg.counter("fleet_failovers").inc(2)
    srv = metrics.serve_scrape(reg, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address[:2]
        resp = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=10)
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        body = resp.read().decode()
        assert metrics.parse_scrape(body)["counters"][
            "fleet_failovers"] == 2
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serve_stats_renders_the_fleet_section_of_a_port_scrape():
    """scripts/serve_stats.py reads the port fleet's scrape: the fleet
    section and the per-class shed series render."""
    spec = importlib.util.spec_from_file_location(
        "serve_stats", os.path.join(os.path.dirname(__file__), "..",
                                    "scripts", "serve_stats.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    c = _circuit_a()
    reg = metrics.Registry()
    with _shed_fleet(reg) as fl:
        for i, s in enumerate(_random_states(12, seed=71)):
            try:
                fl.submit(c, state=s, priority=0)
            except ShedError:
                pass
        _drain(fl)
        text = fl.scrape()
    buf = io.StringIO()
    mod.render(mod._load_snapshot(text), out=buf)
    out = buf.getvalue()
    assert "fleet/tenant" in out
    assert "fleet_replicas_healthy" in out
    assert "shed_requests_p0" in out


# ---------------------------------------------------------------------------
# knobs and stats
# ---------------------------------------------------------------------------


def test_fleet_knobs_registered_and_parse_loudly():
    from quest_tpu_torch.env import KNOBS
    for name, bad in (("QUEST_SERVE_REPLICAS", "0"),
                      ("QUEST_SERVE_TENANT_QUOTA", "alice=lots"),
                      ("QUEST_SERVE_SHED_THRESHOLD", "0"),
                      ("QUEST_SERVE_PRIORITIES", "0"),
                      ("QUEST_FLEET_PROC", "2"),
                      ("QUEST_FLEET_MIN_REPLICAS", "0"),
                      ("QUEST_FLEET_MAX_REPLICAS", "0"),
                      ("QUEST_HEARTBEAT_S", "0")):
        with pytest.raises(ValueError):
            KNOBS[name].parse(bad)
    assert KNOBS["QUEST_SERVE_REPLICAS"].parse("4") == 4
    assert KNOBS["QUEST_SERVE_SHED_THRESHOLD"].parse("0.9") == 0.9
    assert KNOBS["QUEST_SERVE_PRIORITIES"].parse("3") == 3
    # the reference's defaults
    from quest_tpu.env import KNOBS as JKNOBS
    for name in ("QUEST_SERVE_REPLICAS", "QUEST_FLEET_PROC",
                 "QUEST_FLEET_MIN_REPLICAS", "QUEST_FLEET_MAX_REPLICAS",
                 "QUEST_HEARTBEAT_S", "QUEST_SERVE_PRIORITIES"):
        assert KNOBS[name].default == JKNOBS[name].default, name


def test_fleet_knobs_configure_fleet(monkeypatch):
    monkeypatch.setenv("QUEST_SERVE_REPLICAS", "3")
    monkeypatch.setenv("QUEST_SERVE_SHED_THRESHOLD", "0.9")
    monkeypatch.setenv("QUEST_SERVE_PRIORITIES", "4")
    monkeypatch.setenv("QUEST_SERVE_TENANT_QUOTA", "alice=1,default=9")
    with _fleet(max_wait_ms=2) as fl:
        assert fl.replicas == 3
        assert fl.process is False
        assert fl.shed_threshold == 0.9
        assert fl.priorities == 4
        assert fl.tenant_quota.quota_of("alice") == 1
        assert fl.tenant_quota.quota_of("bob") == 9


def test_fleet_stats_surfaces_replica_health():
    with _fleet(replicas=2, restart_max=3) as fl:
        st = fl.stats()
        assert len(st["replicas"]) == 2
        for r in st["replicas"]:
            assert r["state"] == "running"
            assert r["restarts_remaining"] == 3
        assert st["pressure"] == 0.0
        assert st["process"] is False


def test_fleet_defaults_to_the_card():
    """No device named: a fleet serves on the card, so without one it
    refuses to start rather than drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeFleet(replicas=1, registry=metrics.Registry())


# ---------------------------------------------------------------------------
# elastic failover across meshes (tests/test_elastic.py:547)
# ---------------------------------------------------------------------------


def test_fleet_elastic_failover_across_meshes(tmp_path, portable_env):
    """The replica running a durable job sharded over 4 CPU shards dies
    past its budget mid-chain; the survivor owns a 2-shard mesh and
    resumes the chain elastically: bit for bit the uninterrupted run on
    the survivor's mesh."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.parallel import shard_qureg
    mesh4 = make_amp_mesh(4, devices=["cpu"] * 4)
    mesh2 = make_amp_mesh(2, devices=["cpu"] * 2)
    n = 10
    c = elastic_circuit(n)
    ref = run_durable(c, shard_qureg(TS.create_qureg(n, device="cpu"),
                                     mesh2),
                      str(tmp_path / "ref"), every=10, mesh=mesh2)
    want = ref.amps.gather("cpu").reshape(2, -1)
    s0 = np.zeros((2, 1 << n), dtype=np.float32)
    s0[0, 0] = 1.0
    reg = metrics.Registry()
    plan = FaultPlan()
    plan.inject("durable.preempt", after_n=12, times=1)
    plan.inject(**_r0_durable_dying())
    with faults.active(plan):
        with _fleet(replicas=2, max_wait_ms=2, restart_max=1,
                    registry=reg, durable_mesh=[mesh4, mesh2],
                    durable_elastic=True) as fl:
            out = fl.submit(c, state=s0, durable_dir=str(tmp_path / "job"),
                            durable_every=10).result(timeout=T_OUT)
    assert torch.equal(out, want)
    snap = reg.snapshot()["counters"]
    assert snap["fleet_failovers"] >= 1
    assert snap["durable_elastic_resumes"] >= 1
    assert ckpt.step_dirs(str(tmp_path / "job")) == []


def test_durable_mesh_list_must_match_replicas():
    with pytest.raises(ValueError, match="durable_mesh"):
        _fleet(replicas=2, durable_mesh=[None])


# ---------------------------------------------------------------------------
# chaos: every future resolves (tests/test_fleet.py's soak, cut to size)
# ---------------------------------------------------------------------------


def test_fleet_chaos_every_future_resolves_and_durable_is_exact(tmp_path):
    """A seeded fault plan over a 60-request mixed multi-tenant stream
    (apply, trajectory and one durable job): one replica killed past its
    restart budget mid-stream, the durable job preempted mid-chain, noise
    on dispatch and demux. Every future resolves served or typed (the
    bounded drain is the hang detector) and the durable job lands bit for
    bit on the uninterrupted run."""
    ca, cb, cn = _circuit_a(), _circuit_b(), _noisy_circuit()
    circ_d, s0, ref_hash = _durable_setup(tmp_path, layers=4)
    states = _random_states(60, seed=43)
    tenants = ("alice", "bob", "carol")
    plan = FaultPlan()
    plan.inject("serve.worker_loop", error=RuntimeError("replica lost"),
                match=lambda ctx: (ctx.get("replica") == "r1"
                                   and ctx["phase"] == "popped"),
                after_n=6)
    plan.inject("durable.preempt", after_n=5, times=1)
    plan.inject("serve.dispatch", every_n=13, times=3,
                match=lambda ctx: not ctx.get("durable"))
    plan.inject("serve.demux", p=0.03, seed=7)
    reg = metrics.Registry()
    with faults.active(plan):
        fl = _fleet(replicas=3, max_wait_ms=2, max_batch=8, restart_max=2,
                    breaker_threshold=3, breaker_cooldown_s=0.05,
                    registry=reg)
        try:
            futs, fd = [], None
            for i in range(60):
                try:
                    if i == 10:
                        fd = fl.submit(circ_d, state=s0,
                                       durable_dir=str(tmp_path / "j"),
                                       durable_every=2, tenant="alice",
                                       priority=1)
                        futs.append(fd)
                    elif i % 7 == 6:
                        futs.append(fl.submit(
                            cn, shots=1 + i % 4, seed=i,
                            tenant=tenants[i % 3]))
                    else:
                        futs.append(fl.submit(
                            ca if i % 2 == 0 else cb, state=states[i],
                            tenant=tenants[i % 3], priority=i % 2))
                except RejectedError:
                    pass              # shed or FAILED mid-stream is legal
            fl.drain(timeout_s=300)   # a TimeoutError here is a hang
            assert all(f.done() for f in futs)
            assert fd is not None
            assert _sha(fd.result(timeout=T_OUT)) == ref_hash
            assert fl.state in ("running", "failed")
        finally:
            fl.close(timeout_s=60)
    snap = reg.snapshot()["counters"]
    assert plan.fired("durable.preempt") == 1
    assert snap.get("serve_faults_injected", 0) > 0, snap
    assert snap.get("durable_resumes", 0) >= 1, snap


def test_traj_uniform_shape_is_checked_at_the_engine():
    """The engine's entry for pre-drawn uniforms refuses a draw of the
    wrong shape (what a fleet or a worker hands it must fit the
    circuit)."""
    c = _noisy_circuit()
    with ServeEngine(device="cpu", registry=metrics.Registry()) as eng:
        with pytest.raises(ValueError, match="uniforms"):
            eng._submit(c, shots=4, uniforms=torch.zeros(
                (4, _num_channels(c) + 1), dtype=torch.float64))
