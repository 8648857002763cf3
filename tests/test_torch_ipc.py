"""The port's process replicas (quest_tpu_torch.serve.ipc.ReplicaProxy and
serve/worker_main.py) and autoscaler on the CPU, mirroring
tests/test_ipc.py.

Worker processes here serve on device="cpu" (the plain PyTorch paths,
one intra-op thread each). The wire is a transport: a process fleet's
outputs equal a thread fleet's bit for bit, and a trajectory request's
draws equal run_batched's from the same generator state on a thread
replica, on a process replica, after a failover requeue and after a
SIGKILL resubmit. A SIGKILLed worker is noticed on its pipe's EOF,
respawned and handed its in-flight ledger: no future is lost. The tests
assert the losses they cause; heartbeats are slow enough (2 s, a loss
after 8 s of silence) that a healthy worker on a loaded box never misses
four. A card worker never compiles: a missing toolchain fails the boot
with the build's BuildError, raised in the parent.

Every future, drain and join has an explicit timeout.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from quest_tpu.circuit import Circuit as JCircuit

from quest_tpu_torch import convert
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.expec import PauliSum
from quest_tpu_torch.resilience import FaultPlan, faults
from quest_tpu_torch.serve import (Autoscaler, ReplicaProxy, ServeFleet,
                                   metrics)
from quest_tpu_torch.serve import ipc
from quest_tpu_torch.serve.admission import RejectedError
from quest_tpu_torch.serve.ipc import (circuit_descriptor, circuit_digest,
                                       from_wire, rebuild_circuit, to_wire,
                                       wire_exc)

from .test_torch_comm import _one_thread_per_worker  # noqa: F401

pytestmark = pytest.mark.dtype_agnostic

N = 4
HB = 2.0          # heartbeat seconds: a loss only after 8 s of silence
T_OUT = 120       # seconds any one future or drain may take


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


def _circ(n=N):
    c = Circuit(n)
    c.h(0)
    c.cnot(0, 1)
    c.rz(min(2, n - 1), 0.25)
    return c


def _noisy(n=N):
    c = Circuit(n).h(0).cnot(0, 1)
    c.depolarising(0, 0.1).damping(1, 0.2)
    return c.ry(2, 0.3).dephasing(2, 0.15)


def _states(k, n=N, seed=3):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((k, 2, 1 << n)).astype(np.float32)
    return s / np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))


def _proc_fleet(**kw):
    kw.setdefault("registry", metrics.Registry())
    kw.setdefault("device", "cpu")
    kw.setdefault("heartbeat_s", HB)
    kw.setdefault("backoff_base_s", 0.0)
    return ServeFleet(process=True, **kw)


def _thread_fleet(**kw):
    kw.setdefault("registry", metrics.Registry())
    kw.setdefault("device", "cpu")
    kw.setdefault("backoff_base_s", 0.0)
    return ServeFleet(process=False, **kw)


def _kill(proxy):
    pid = proxy.worker_pid()
    os.kill(pid, signal.SIGKILL)
    return pid


# ---------------------------------------------------------------------------
# value-keyed descriptors, tensor and exception codecs (no processes)
# ---------------------------------------------------------------------------


def test_circuit_descriptor_round_trips_by_value():
    c = _circ()
    desc = pickle.loads(pickle.dumps(circuit_descriptor(c)))
    rebuilt = rebuild_circuit(desc)
    assert rebuilt.num_qubits == c.num_qubits
    assert len(rebuilt.ops) == len(c.ops)
    assert circuit_digest(rebuilt) == circuit_digest(c)


def test_circuit_digest_is_cached_and_value_keyed():
    a, b = _circ(), _circ()
    assert a is not b
    assert circuit_digest(a) == circuit_digest(b)
    a.x(0)
    assert circuit_digest(a) != circuit_digest(b)


def test_every_served_op_kind_round_trips_by_value():
    """Every gate, channel and observable kind the serving tests submit
    crosses the wire by value: the rebuilt circuit runs to the same
    planes, and a PauliSum ships as its spec."""
    jc = JCircuit(5)
    jc.h(0).x(1).y(2).z(3).s(4).t(0).rx(1, 0.3).ry(2, 0.4).rz(3, 0.5)
    jc.cnot(0, 1).cz(1, 2).cphase(0.7, 2, 3).swap(3, 4)
    c = convert.circuit_from_ops(jc.ops, 5)
    u, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(4, 4))
                        + 1j * np.random.default_rng(2).normal(size=(4, 4)))
    c.gate(u, (0, 3))
    c.depolarising(0, 0.1).damping(1, 0.2).dephasing(2, 0.15)
    rebuilt = rebuild_circuit(pickle.loads(pickle.dumps(
        circuit_descriptor(c))))
    assert circuit_digest(rebuilt) == circuit_digest(c)
    assert [op.kind for op in rebuilt.ops] == [op.kind for op in c.ops]
    s = torch.from_numpy(_states(1, 5, seed=4)[0].copy())
    unitary = _circ(5)
    rb = rebuild_circuit(pickle.loads(pickle.dumps(
        circuit_descriptor(unitary))))
    want = unitary.compiled_batched(1, device="cpu")(s[None])
    got = rb.compiled_batched(1, device="cpu")(s[None])
    assert torch.equal(got, want)
    spec = PauliSum.of([[3, 0, 0, 0, 1], [1, 1, 0, 0, 0]], [0.5, -1.25], 5)
    assert pickle.loads(pickle.dumps(spec)) == spec


def test_tensor_codec_round_trips_results():
    """Results cross as CPU arrays and come back CPU tensors, in the
    result's own structure (planes; values; (planes, draws))."""
    planes = torch.randn(2, 16)
    draws = torch.randint(0, 4, (5, 3), dtype=torch.int32)
    for value in (planes, torch.tensor(0.25), (planes, draws), 7, None):
        back = from_wire(pickle.loads(pickle.dumps(to_wire(value))))
        if isinstance(value, tuple):
            assert isinstance(back, tuple)
            assert all(torch.equal(b, v) for b, v in zip(back, value))
        elif isinstance(value, torch.Tensor):
            assert torch.equal(back, value) and back.dtype == value.dtype
        else:
            assert back == value


def test_wire_exc_preserves_type_or_degrades_loudly():
    e = wire_exc(RejectedError("queue full"))
    assert isinstance(e, RejectedError) and "queue full" in str(e)
    b = wire_exc(_build.BuildError("nvcc not found"))
    assert isinstance(b, _build.BuildError)

    class Unpicklable(Exception):
        def __reduce__(self):
            raise TypeError("nope")

    d = wire_exc(Unpicklable("boom"))
    assert isinstance(d, RejectedError) and "Unpicklable" in str(d)


def test_frames_round_trip_and_refuse_a_poisoned_header():
    """Arrays cross out of band (their memory, not a copy inside the
    pickle) and come back writable; a poisoned header, a peer silent
    mid-frame and a torn frame each raise."""
    import socket
    a, b = socket.socketpair()
    try:
        v = np.arange(1 << 10, dtype=np.float32)   # within the socket buffer
        pieces = ipc.encode_frame({"t": "x", "v": v})
        assert len(pieces) == 3 and pieces[2].nbytes == v.nbytes
        ipc.write_frame(a, pieces)
        got = ipc.recv_frame(b)
        assert got["t"] == "x" and np.array_equal(got["v"], v)
        assert got["v"].flags.writeable
        a.sendall(ipc._HDR.pack(ipc._MAX_FRAME + 1, 0))
        with pytest.raises(ValueError, match="poisoned"):
            ipc.recv_frame(b)
        a.sendall(ipc._HDR.pack(10, 0) + b"abc")
        with pytest.raises(socket.timeout, match="silent"):
            ipc.recv_frame(b, idle_s=0.2)
        a.sendall(ipc._HDR.pack(10, 0) + b"abc")
        a.close()
        with pytest.raises(EOFError):
            ipc.recv_frame(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# one shared 2-process fleet: round trip + contract surface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proc_fleet():
    fleet = _proc_fleet(replicas=2, max_wait_ms=2, max_batch=4)
    yield fleet
    fleet.close(timeout_s=30)


def test_process_fleet_round_trip(proc_fleet):
    """Both request kinds through the pipe, and the fleet surface
    (stats, the merged scrape of the workers' heartbeat snapshots)."""
    c = _circ()
    outs = [proc_fleet.submit(c, state=s).result(timeout=T_OUT)
            for s in _states(6)]
    assert all(tuple(o.shape) == (2, 1 << N) for o in outs)
    assert all(o.device.type == "cpu" for o in outs)
    p, d = proc_fleet.submit(_noisy(), shots=8, seed=1).result(
        timeout=T_OUT)
    assert tuple(p.shape) == (8, 2, 1 << N) and d.dtype == torch.int32
    st = proc_fleet.stats()
    assert st["process"] is True
    assert all(r["state"] == "running" for r in st["replicas"])
    assert all(e.hello()["boot_s"] > 0 for e in proc_fleet._engines)
    deadline = time.monotonic() + 4 * HB + 10
    scrape = proc_fleet.scrape()
    while "serve_requests_served" not in scrape:
        assert time.monotonic() < deadline, scrape
        time.sleep(0.2)
        scrape = proc_fleet.scrape()
    assert "fleet_requests_routed" in scrape


def test_process_fleet_results_match_thread_fleet(proc_fleet):
    """The wire is a transport: the same requests give the same bits as
    thread replicas, planes and a PauliSum observable."""
    c = _circ()
    states = _states(4, seed=11)
    spec = PauliSum.of([[3, 0, 1, 0], [0, 2, 2, 0]], [0.5, -0.75], N)
    with _thread_fleet(replicas=2, max_wait_ms=2, max_batch=4) as tf:
        want = [tf.submit(c, state=s).result(timeout=T_OUT) for s in states]
        want_v = tf.submit(c, state=states[0], observable=spec).result(
            timeout=T_OUT)
    got = [proc_fleet.submit(c, state=s).result(timeout=T_OUT)
           for s in states]
    got_v = proc_fleet.submit(c, state=states[0], observable=spec).result(
        timeout=T_OUT)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(want_v, got_v)


def test_unpicklable_observable_rejected_with_guidance(proc_fleet):
    """A lambda cannot cross a process boundary: the submit fails at
    once with guidance, and leaves nothing in the ledgers."""
    with pytest.raises(ValueError, match="thread replicas"):
        proc_fleet.submit(_circ(), state=_states(1)[0],
                          observable=lambda x: x)
    assert not proc_fleet._pending
    with pytest.raises(ValueError, match="qubits"):
        proc_fleet.submit(_circ(), state=_states(1)[0],
                          observable=PauliSum.of([[3, 0, 0]], [1.0], 3))


def test_worker_checks_each_request_off_the_wire(proc_fleet):
    """The worker runs the submit checks on what arrives off the wire: a
    frame that bypassed them comes back as the typed ValueError, and the
    worker goes on serving."""
    proxy = proc_fleet._engines[0]
    fut = proxy._submit(_circ(), state=None, shots=None)
    with pytest.raises(ValueError, match="exactly one of"):
        fut.result(timeout=T_OUT)
    fut = proxy._submit(_circ(), state=_states(1)[0], durable_every=3)
    with pytest.raises(ValueError, match="durable_every"):
        fut.result(timeout=T_OUT)
    out = proxy.submit(_circ(), state=_states(1)[0]).result(timeout=T_OUT)
    assert tuple(out.shape) == (2, 1 << N)


def test_drain_round_trips_the_worker(proc_fleet):
    futs = [proc_fleet.submit(_circ(), state=s)
            for s in _states(4, seed=5)]
    proc_fleet.drain(timeout_s=T_OUT)
    assert all(f.done() for f in futs)
    for f in futs:
        f.result(timeout=T_OUT)


# ---------------------------------------------------------------------------
# supervision: SIGKILL -> respawn -> resubmit; budget -> fleet failover
# ---------------------------------------------------------------------------


def test_sigkill_respawns_and_resubmits_inflight():
    """kill -9 with requests in flight: the pipe's EOF is the loss, the
    worker respawns, the ledger is resubmitted, and every accepted
    future resolves to the bits a live replica gives the same batch."""
    reg = metrics.Registry()
    c = _circ()
    states = _states(8, seed=9)
    kw = dict(replicas=1, max_wait_ms=600_000, max_batch=64)
    with _thread_fleet(**kw) as tf:
        futs = [tf.submit(c, state=s) for s in states]
        tf.drain(timeout_s=T_OUT)
        want = [f.result(timeout=T_OUT) for f in futs]
    with _proc_fleet(registry=reg, **kw) as fleet:
        proxy = fleet._engines[0]
        futs = [fleet.submit(c, state=s) for s in states]
        old = _kill(proxy)
        fleet.drain(timeout_s=T_OUT)
        outs = [f.result(timeout=T_OUT) for f in futs]
        assert proxy.worker_pid() != old
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    snap = reg.snapshot()["counters"]
    assert snap["ipc_worker_losses"] >= 1
    assert snap["ipc_worker_respawns"] >= 1
    assert snap["ipc_resubmits"] == 8


def test_silence_not_slowness_reads_as_a_loss():
    """A worker that stops reading for less than the silence window (four
    heartbeats) is slow, not lost: a submit larger than the socket's
    buffer waits for it and completes, with no loss. One that stays
    silent past the window is lost: killed, respawned, and its request
    served by the fresh worker."""
    import threading
    n = 18                         # a 2 MiB state: over the socket buffer
    c = _circ(n)
    s = _states(1, n, seed=41)[0]
    reg = metrics.Registry()
    with _proc_fleet(replicas=1, max_wait_ms=2, max_batch=4, registry=reg,
                     heartbeat_s=1.0) as fleet:
        want = fleet.submit(c, state=s).result(timeout=T_OUT)
        pid = fleet._engines[0].worker_pid()
        os.kill(pid, signal.SIGSTOP)
        timer = threading.Timer(1.5, os.kill, (pid, signal.SIGCONT))
        timer.start()
        got = fleet.submit(c, state=s).result(timeout=T_OUT)
        timer.join(timeout=10)
        assert torch.equal(got, want)
        assert reg.counter("ipc_worker_losses").value == 0
        assert fleet._engines[0].worker_pid() == pid
        os.kill(pid, signal.SIGSTOP)        # never continued
        got = fleet.submit(c, state=s).result(timeout=T_OUT)
        assert torch.equal(got, want)
        assert fleet._engines[0].worker_pid() != pid
    assert reg.counter("ipc_worker_losses").value == 1
    assert reg.counter("ipc_worker_respawns").value == 1


def test_budget_exhaustion_fails_typed_and_fleet_requeues():
    """restart_max=0: the killed worker's proxy goes FAILED and resolves
    its requests requeue-typed; the fleet's failover serves them on the
    survivor, and the FAILED proxy rejects submits typed."""
    reg = metrics.Registry()
    c = _circ()
    states = _states(6, seed=13)
    with _proc_fleet(replicas=2, max_wait_ms=600_000, max_batch=64,
                     max_queue=32, restart_max=0, registry=reg) as fleet:
        futs = [fleet.submit(c, state=s) for s in states]
        victim = max(range(2), key=lambda i: fleet._engines[i]._pending)
        assert fleet._engines[victim]._pending >= 1
        _kill(fleet._engines[victim])
        fleet.drain(timeout_s=T_OUT)
        outs = [f.result(timeout=T_OUT) for f in futs]
        assert len(outs) == 6
        assert fleet._engines[victim].state == "failed"
        assert fleet._engines[1 - victim].state == "running"
        snap = reg.snapshot()["counters"]
        assert snap["fleet_requeued_requests"] >= 1
        assert snap["ipc_worker_losses"] == 1
        with pytest.raises(RejectedError, match="respawn budget"):
            fleet._engines[victim].submit(c, state=states[0])


def test_traj_draws_equal_everywhere_from_one_generator_state():
    """Two trajectory requests drawn from one generator state give
    run_batched's draws and planes on a thread replica, on a process
    replica whose worker is SIGKILLed with them in flight (served by the
    resubmit), and after a thread fleet's failover requeue."""
    c = _noisy()
    g = torch.Generator().manual_seed(29)
    want = [T.run_batched(c, k, generator=g, device="cpu") for k in (6, 2)]
    end = g.get_state()

    def check(got, gen):
        assert torch.equal(gen.get_state(), end)
        for (gp, gd), (wp, wd) in zip(got, want):
            assert torch.equal(gd, wd)
            assert torch.equal(gp, wp)

    # a thread replica
    gen = torch.Generator().manual_seed(29)
    with _thread_fleet(replicas=1, max_wait_ms=2, max_batch=8) as fl:
        check([fl.submit(c, shots=k, generator=gen).result(timeout=T_OUT)
               for k in (6, 2)], gen)
    # a failover requeue off a dying thread replica
    gen = torch.Generator().manual_seed(29)
    plan = FaultPlan().inject(
        "serve.worker_loop", error=RuntimeError("replica lost"),
        match=lambda ctx: (ctx.get("replica") == "r0"
                           and ctx["phase"] == "popped"))
    reg = metrics.Registry()
    with faults.active(plan):
        with _thread_fleet(replicas=2, max_wait_ms=600_000, max_batch=8,
                           restart_max=0, registry=reg) as fl:
            futs = [fl.submit(c, shots=k, generator=gen) for k in (6, 2)]
            fl.drain(timeout_s=T_OUT)
            check([f.result(timeout=T_OUT) for f in futs], gen)
    assert reg.counter("fleet_requeued_requests").value >= 1
    # a process replica, SIGKILLed with both requests queued
    gen = torch.Generator().manual_seed(29)
    reg = metrics.Registry()
    with _proc_fleet(replicas=1, max_wait_ms=600_000, max_batch=8,
                     registry=reg) as fl:
        futs = [fl.submit(c, shots=k, generator=gen) for k in (6, 2)]
        _kill(fl._engines[0])
        fl.drain(timeout_s=T_OUT)
        check([f.result(timeout=T_OUT) for f in futs], gen)
    assert reg.counter("ipc_resubmits").value >= 2


def test_proxy_rejects_durable_mesh():
    with pytest.raises(ValueError, match="durable_mesh"):
        ReplicaProxy(registry=metrics.Registry(), device="cpu",
                     durable_mesh=object())


def test_proxy_serves_on_the_card_unless_told_otherwise():
    """No device: a proxy resolves the card; without one it refuses
    before it spawns anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaProxy(registry=metrics.Registry())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeFleet(replicas=1, process=True, registry=metrics.Registry())


# ---------------------------------------------------------------------------
# a card worker never compiles
# ---------------------------------------------------------------------------


def test_missing_toolchain_fails_a_card_proxy_loudly(monkeypatch, tmp_path):
    """Before a card worker spawns, the proxy makes sure the kernel's
    library exists; with no toolchain that raises the build's
    BuildError in the caller, and no worker starts."""
    def no_nvcc():
        raise _build.BuildError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path",
                        lambda defines=(): tmp_path / "libsegment-x.so")
    spawned = []
    monkeypatch.setattr(ReplicaProxy, "_spawn",
                        lambda self, respawn: spawned.append(respawn))
    with pytest.raises(_build.BuildError, match="nvcc"):
        ReplicaProxy(registry=metrics.Registry(), device="cuda")
    assert not spawned


def test_card_worker_boot_carries_the_build_error_to_the_parent(
        monkeypatch):
    """A card worker only loads: with the kernel's library absent it
    compiles nothing, and its hello carries the BuildError, raised by
    the proxy's constructor."""
    if _build.library_path().exists():
        pytest.skip("the kernel library is built here; the worker would "
                    "load it")
    monkeypatch.setattr(ipc, "prepare_card_libraries", lambda: None)
    with pytest.raises(_build.BuildError, match="may not compile"):
        ReplicaProxy(registry=metrics.Registry(), device="cuda")


def test_build_refuses_in_a_process_that_may_not_compile(monkeypatch,
                                                         tmp_path):
    from quest_tpu_torch import native
    monkeypatch.setattr(_build, "BUILD_ALLOWED", False)
    monkeypatch.setattr(_build, "library_path",
                        lambda defines=(): tmp_path / "libsegment-x.so")
    with pytest.raises(_build.BuildError, match="may not compile"):
        _build.build()
    monkeypatch.setattr(native, "BUILD_ALLOWED", False)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libquest_host-x.so")
    with pytest.raises(_build.BuildError, match="may not compile"):
        native.build()


# ---------------------------------------------------------------------------
# fault sites: fleet.spawn / ipc.send / ipc.recv
# ---------------------------------------------------------------------------


def test_fleet_spawn_fault_makes_boot_loud():
    plan = FaultPlan().inject("fleet.spawn",
                              error=RuntimeError("no capacity"), times=1)
    with faults.active(plan):
        with pytest.raises(RuntimeError, match="no capacity"):
            _proc_fleet(replicas=1)
    assert plan.fired("fleet.spawn") == 1


def test_ipc_send_and_recv_faults_trigger_loss_recovery():
    """Armed ipc.send / ipc.recv faults fire on the framed paths and are
    handled as transport losses: respawn, resubmit, and every future
    still resolves."""
    c = _circ()
    states = _states(4, seed=17)
    reg = metrics.Registry()
    plan = (FaultPlan()
            .inject("ipc.send", error=OSError("pipe torn"), times=1,
                    match=lambda ctx: ctx.get("type") == "submit")
            .inject("ipc.recv", error=OSError("frame poisoned"), times=1,
                    match=lambda ctx: ctx.get("type") == "result"))
    with _proc_fleet(replicas=1, max_wait_ms=2, max_batch=4,
                     registry=reg) as fleet:
        want = fleet.submit(c, state=states[0]).result(timeout=T_OUT)
        with faults.active(plan):
            outs = [fleet.submit(c, state=s).result(timeout=T_OUT)
                    for s in states]
        assert torch.equal(outs[0], want)
    assert plan.fired("ipc.send") == 1
    assert plan.fired("ipc.recv") == 1
    assert reg.counter("ipc_worker_losses").value >= 2


# ---------------------------------------------------------------------------
# concurrent plan-cache warmup across worker processes
# ---------------------------------------------------------------------------

_WARM_SNIPPET = r"""
import json, sys
import numpy as np
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch import plan as P

n = int(sys.argv[1])
c = Circuit(n)
c.h(0); c.cnot(0, 1)
for q in range(n):
    c.rz(q, 0.1 * (q + 1))
for batch in (1, 2):
    P.autotune(c, state_kind="pure", dtype=np.float32, batch=batch,
               device="cpu")
print(json.dumps(P.cache_stats()))
"""


def test_concurrent_plan_cache_warmup_is_atomic(tmp_path, monkeypatch):
    """3 processes warm one QUEST_PLAN_CACHE_DIR at once: every entry
    lands whole (tmp + rename), and a second wave is loads only."""
    from quest_tpu_torch import plan as P
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", str(tmp_path))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ipc._ROOT, os.environ.get("PYTHONPATH"))
                   if p))

    def wave():
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WARM_SNIPPET, "5"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True) for _ in range(3)]
        stats = []
        for p in procs:
            out, err = p.communicate(timeout=T_OUT)
            assert p.returncode == 0, err
            stats.append(json.loads(out.strip().splitlines()[-1]))
        return stats

    cold = wave()
    # a process that starts late may load what an earlier one stored;
    # every lookup is a search or a whole entry, never a torn one
    assert sum(s["searches"] for s in cold) >= 1, cold
    assert all(s["searches"] + s["hits"] == 2 for s in cold), cold
    assert all(s["corrupt"] == 0 for s in cold), cold
    entries = [f for f in os.listdir(tmp_path) if f.startswith("plan-")]
    assert entries, "no plan-cache entries persisted"
    for f in entries:
        assert f.endswith(".json"), f
        assert P.load_plan(f[len("plan-"):-len(".json")]) is not None, f
    assert not any(".tmp." in f for f in os.listdir(tmp_path))
    warm = wave()
    assert all(s["searches"] == 0 for s in warm), warm
    assert all(s["hits"] >= 1 for s in warm), warm


# ---------------------------------------------------------------------------
# the autoscaler control loop
# ---------------------------------------------------------------------------


class _FleetStub:
    """A fleet-shaped stub: a tick is a pure function of stats() and the
    registry's counters."""

    def __init__(self, pressure=0.0, replicas=1):
        self.registry = metrics.Registry()
        self.pressure = pressure
        self._n = replicas
        self.ups = 0
        self.downs = 0

    def stats(self):
        return {"pressure": self.pressure,
                "replicas": [{"retired": False}] * self._n}

    def add_replica(self):
        self._n += 1
        self.ups += 1
        return self._n - 1

    def remove_replica(self, timeout_s=None):
        self._n -= 1
        self.downs += 1
        return 0


def _auto(fleet, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    return Autoscaler(fleet, **kw)


def test_autoscaler_hysteresis_needs_consecutive_hot_ticks():
    f = _FleetStub(pressure=0.9)
    a = _auto(f, up_ticks=3, cooldown_ticks=0)
    assert a.tick() is None and a.tick() is None
    assert a.tick() == "up" and f.ups == 1
    f.pressure = 0.5            # a neutral tick resets the streak
    a.tick()
    f.pressure = 0.9
    assert a.tick() is None and a.tick() is None
    assert a.tick() == "up"
    assert f.registry.gauge("autoscaler_pressure").value == 0.9


def test_autoscaler_shed_delta_counts_as_hot():
    f = _FleetStub(pressure=0.1)
    a = _auto(f, up_ticks=1, cooldown_ticks=0)
    f.registry.counter("shed_requests").inc()
    assert a.tick() == "up"


def test_autoscaler_cooldown_blocks_thrash():
    f = _FleetStub(pressure=0.9)
    a = _auto(f, up_ticks=1, cooldown_ticks=2)
    assert a.tick() == "up"
    assert a.tick() is None and a.tick() is None
    assert a.tick() == "up"
    assert [k for _, k in a.stats()["actions"]] == ["up", "up"]


def test_autoscaler_respects_bounds(monkeypatch):
    f = _FleetStub(pressure=0.9, replicas=4)
    a = _auto(f, up_ticks=1, cooldown_ticks=0, max_replicas=4)
    assert a.tick() is None and f.ups == 0
    f.pressure = 0.0
    f._n = 1
    a2 = _auto(f, down_ticks=1, cooldown_ticks=0, min_replicas=1)
    assert a2.tick() is None and f.downs == 0
    with pytest.raises(ValueError, match="non-empty range"):
        _auto(f, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError, match="low_water"):
        _auto(f, low_water=0.9, high_water=0.5)
    # the bounds default to the knobs
    monkeypatch.setenv("QUEST_FLEET_MIN_REPLICAS", "2")
    monkeypatch.setenv("QUEST_FLEET_MAX_REPLICAS", "3")
    assert Autoscaler(f).stats()["bounds"] == (2, 3)


def test_autoscaler_scales_down_after_sustained_calm():
    f = _FleetStub(pressure=0.0, replicas=3)
    a = _auto(f, down_ticks=3, cooldown_ticks=0)
    assert [a.tick() for _ in range(3)] == [None, None, "down"]
    assert f.downs == 1


def test_autoscaler_metronome_starts_and_stops():
    f = _FleetStub(pressure=0.9)
    a = _auto(f, up_ticks=1, cooldown_ticks=0, max_replicas=2,
              interval_s=0.05)
    with a:
        deadline = time.monotonic() + 30
        while f.ups < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
    assert f.ups == 1 and a._thread is None


def test_autoscaler_grows_and_shrinks_a_fleet_over_a_held_backlog():
    """tick() over a real thread fleet: a held backlog grows it from 1 to
    2 replicas, the drain's calm shrinks it back, and the count never
    leaves its bounds."""
    c = _circ()
    reg = metrics.Registry()
    with _thread_fleet(replicas=1, max_wait_ms=600_000, max_batch=64,
                       max_queue=8, registry=reg) as fleet:
        a = Autoscaler(fleet, min_replicas=1, max_replicas=2, up_ticks=2,
                       down_ticks=2, cooldown_ticks=1, high_water=0.5,
                       low_water=0.1)
        futs = [fleet.submit(c, state=s) for s in _states(6, seed=31)]
        seen = []
        for _ in range(4):
            a.tick()
            seen.append(fleet.replicas)
        assert max(seen) == 2
        fleet.drain(timeout_s=T_OUT)
        for f in futs:
            f.result(timeout=T_OUT)
        for _ in range(4):
            a.tick()
            seen.append(fleet.replicas)
        assert fleet.replicas == 1
        assert all(1 <= r <= 2 for r in seen)
    snap = reg.snapshot()["counters"]
    assert snap["fleet_scale_ups"] == 1 and snap["fleet_scale_downs"] == 1


def test_fleet_add_remove_replica_thread_mode():
    c = _circ()
    states = _states(4, seed=19)
    with _thread_fleet(replicas=1, max_wait_ms=2, max_batch=4) as fleet:
        assert fleet.replicas == 1
        fleet.add_replica()
        assert fleet.replicas == 2
        for f in [fleet.submit(c, state=s) for s in states]:
            f.result(timeout=T_OUT)
        fleet.remove_replica(timeout_s=60)
        assert fleet.replicas == 1
        assert len(fleet._engines) == 2         # tombstoned, not popped
        fleet.submit(c, state=states[0]).result(timeout=T_OUT)
        with pytest.raises(ValueError, match="last live replica"):
            fleet.remove_replica(timeout_s=5)


def test_scale_down_rolls_back_instead_of_losing_requests():
    ca = _circ()
    cb = Circuit(N).h(1).cnot(1, 2).rz(0, 0.3)
    states = _states(6, seed=23)
    with _thread_fleet(replicas=2, max_wait_ms=600_000, max_batch=64,
                       max_queue=32) as fleet:
        # two program families park work on both replicas
        futs = [fleet.submit(ca if i % 2 == 0 else cb, state=states[i])
                for i in range(6)]
        with pytest.raises(TimeoutError, match="rolled back"):
            fleet.remove_replica(timeout_s=0.0)
        assert fleet.replicas == 2
        assert not [r for r in fleet.stats()["replicas"] if r["retired"]]
        fleet.drain(timeout_s=T_OUT)
        for f in futs:
            f.result(timeout=T_OUT)
