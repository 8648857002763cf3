"""Process replicas: the serving fleet's dispatch boundary.

A port of quest_tpu/serve/ipc.py. Each process replica is a supervised
WORKER PROCESS (serve/worker_main.py) with its own interpreter, its own
CUDA context on the card and its own ServeEngine, fronted by a
`ReplicaProxy` that duck-types the engine surface ServeFleet routes,
sheds and fails over against: `ServeFleet(process=True)` swaps
ServeEngine for ReplicaProxy and nothing above it changes. Several
workers share the one card; their launches time-slice on it.

Wire protocol: a Unix socketpair per replica carrying length-prefixed
pickle frames (protocol 5, with the numpy arrays out of band, so an 8 MiB
state crosses as its own memory, not copied into a pickle).

    +-------------+-------------+-----------------+--------+----------+
    | 8 B, BE     | 8 B, BE     | 8 B, BE each    | pickle | buffers  |
    | pickle len  | buffers K   | K buffer lens   | stream | (arrays) |
    +-------------+-------------+-----------------+--------+----------+

parent -> worker: init, submit, cancel, drain, close
worker -> parent: hello, result, drained, hb (heartbeat), closed

Circuits travel as value-keyed descriptors: a sha256 digest of the
register size and the pickled ops plus, on the digest's first trip to a worker
boot, the ops themselves; the worker caches the rebuilt Circuit by
digest, so repeat submits reuse its compiled programs. Planes and a
trajectory request's drawn (shots, C) uniforms cross as numpy arrays;
results cross as CPU arrays and become CPU tensors again here (a CUDA
tensor is never pickled). The uniforms are drawn once, on the client's
thread (ReplicaProxy.submit, or ServeFleet.submit above it), and stay
in the proxy's in-flight ledger, so a resubmit to a respawned worker
serves the same draws.

Workers are exec-spawned (`python -m quest_tpu_torch.serve.worker_main
--fd N`), never forked: the parent may hold a CUDA context. A card
worker never compiles: before it spawns one, the proxy builds the
segment kernel's library and the native host library (each build holds
a file lock in build/, so concurrent processes build once), and the
worker only loads them; a missing toolchain fails the boot with the
build's BuildError, carried to the parent in its hello.

Supervision (resilience.Supervisor): a worker that sends nothing (no
heartbeat, no result) for `_HB_MISS` heartbeat intervals, closes its
pipe, or reports its engine FAILED
is killed and respawned under the proxy's restart budget, and every
incomplete request is resubmitted to the fresh worker. That is
serve-once across the process boundary: a dead worker delivered no
result frame for an incomplete request and never will, circuit
application is pure, and durable jobs resume from their checkpoint
chain. Budget exhausted: the proxy turns FAILED and resolves its
incomplete futures with the requeue-typed RejectedError, which the
fleet's failover moves to survivors.

Fault sites fleet.spawn / ipc.send / ipc.recv (resilience.faults) sit on
the spawn path and both directions of the pump. Counters
ipc_worker_losses, ipc_worker_respawns, ipc_resubmits.
"""

from __future__ import annotations

import os
import pickle
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.resilience import faults as _F
from quest_tpu_torch.resilience.breaker import OPEN
from quest_tpu_torch.resilience.supervisor import Supervisor
from quest_tpu_torch.serve import metrics as M
from quest_tpu_torch.serve.admission import AdmissionController, RejectedError

# frame header: the pickle stream's length and the number of out-of-band
# buffers, 8-byte big-endian each, then one 8-byte length a buffer
_HDR = struct.Struct(">QQ")
_LEN = struct.Struct(">Q")
# a length larger than this is a torn or poisoned header, not a payload
_MAX_FRAME = 1 << 34
_MAX_BUFFERS = 1 << 16
# heartbeat intervals a worker may miss before it is declared lost
_HB_MISS = 4
# seconds the proxy waits for a fresh worker's hello (interpreter, torch
# import, CUDA context, library loads, engine construction)
_BOOT_TIMEOUT_S = 120.0
# seconds past the caller's own timeout granted to a drain round trip
_RPC_SLACK_S = 5.0
# the directory holding the quest_tpu_torch package, put on the worker's
# import path whatever the parent's working directory
_ROOT = str(Path(__file__).resolve().parents[2])


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def encode_frame(payload: dict) -> list:
    """The byte pieces of one frame, to be written in order: the header,
    the pickle stream (protocol 5) and each out-of-band buffer (the
    numpy arrays' memory itself, never copied into the stream). Raises
    TypeError / pickle.PicklingError / AttributeError on an unpicklable
    payload, before anything is written."""
    bufs: list = []
    stream = pickle.dumps(payload, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = _HDR.pack(len(stream), len(raws)) + b"".join(
        _LEN.pack(r.nbytes) for r in raws)
    return [head, stream, *raws]


def write_frame(sock: socket.socket, pieces: list) -> None:
    """Write the pieces of one encoded frame. Raises OSError on a broken
    transport."""
    for piece in pieces:
        sock.sendall(piece)


def send_frame(sock: socket.socket, payload: dict) -> None:
    """Encode and write one frame."""
    write_frame(sock, encode_frame(payload))


def recv_frame(sock: socket.socket, idle_s: Optional[float] = None) -> dict:
    """Read one frame; its arrays come back over the received buffers,
    without a copy. Raises EOFError on a closed transport (mid-frame
    included: a torn frame is a loss, never a silent retry),
    socket.timeout when the peer sends nothing for `idle_s` seconds
    mid-frame (or the socket's own timeout), ValueError on a poisoned
    header."""
    n, k = _HDR.unpack(_recv_exact(sock, _HDR.size, idle_s))
    if n > _MAX_FRAME or k > _MAX_BUFFERS:
        raise ValueError(
            f"ipc frame header claims {n} bytes and {k} buffers: torn or "
            f"poisoned stream")
    lens = [_LEN.unpack_from(_recv_exact(sock, _LEN.size, idle_s))[0]
            for _ in range(k)]
    if any(m > _MAX_FRAME for m in lens):
        raise ValueError(f"ipc frame buffer lengths {lens}: torn or "
                         f"poisoned stream")
    stream = _recv_exact(sock, n, idle_s)
    bufs = [_recv_exact(sock, m, idle_s) for m in lens]
    return pickle.loads(stream, buffers=bufs)


def _recv_exact(sock: socket.socket, n: int,
                idle_s: Optional[float] = None) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if idle_s is not None and not select.select([sock], [], [],
                                                    idle_s)[0]:
            raise socket.timeout(
                f"ipc peer silent for {idle_s} s mid-frame ({got}/{n} "
                f"bytes)")
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise EOFError(f"ipc peer closed mid-frame ({got}/{n} bytes)")
        got += k
    return buf


# ---------------------------------------------------------------------------
# circuit, tensor and exception codecs
# ---------------------------------------------------------------------------


def circuit_digest(circuit) -> str:
    """The circuit's value key on the wire: sha256 over num_qubits and
    each op pickled alone (one pickle of the whole list would encode
    which ops share an operand object, which a round trip changes).
    Equal-valued circuits share one digest, so the worker's
    rebuilt-Circuit cache dedupes across clients and respawns. Cached on
    the instance and recomputed when ops are appended."""
    import hashlib
    cached = getattr(circuit, "_ipc_digest", None)
    if cached is not None and cached[0] == len(circuit.ops):
        return cached[1]
    h = hashlib.sha256(str(circuit.num_qubits).encode())
    for op in circuit.ops:
        h.update(pickle.dumps(op, protocol=pickle.HIGHEST_PROTOCOL))
    dg = h.hexdigest()
    circuit._ipc_digest = (len(circuit.ops), dg)
    return dg


def circuit_descriptor(circuit) -> dict:
    """The full shippable form (first shipment per worker boot)."""
    return {"num_qubits": circuit.num_qubits, "ops": list(circuit.ops)}


def rebuild_circuit(desc: dict):
    """Worker-side inverse of circuit_descriptor."""
    from quest_tpu_torch.circuit import Circuit
    c = Circuit(desc["num_qubits"])
    c.ops = list(desc["ops"])
    return c


class _Tensor:
    """A CPU tensor on the wire, as its numpy array (numpy pickles its
    buffer directly; a tensor's pickle goes through torch.save)."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = array

    def __reduce__(self):
        return (_Tensor, (self.array,))


def to_wire(value):
    """`value` (a result: a tensor, or a tuple / list of them, or a plain
    object) with every tensor brought to the CPU and wrapped as its numpy
    array: a CUDA tensor is never pickled."""
    if isinstance(value, torch.Tensor):
        return _Tensor(value.detach().cpu().numpy())
    if isinstance(value, (tuple, list)):
        return type(value)(to_wire(v) for v in value)
    return value


def from_wire(value):
    """Inverse of to_wire: CPU tensors over the received arrays."""
    if isinstance(value, _Tensor):
        return torch.from_numpy(value.array)
    if isinstance(value, (tuple, list)):
        return type(value)(from_wire(v) for v in value)
    return value


def wire_exc(exc: BaseException) -> BaseException:
    """An exception the wire can carry: the instance itself when it
    pickle-round-trips (the typed admission and build errors do), else a
    RejectedError naming the original — a worker error never strands a
    future for want of picklability."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RejectedError(
            f"Invalid operation: worker-side {type(exc).__name__}: {exc} "
            f"(the original does not pickle).")


class _BreakerMirror:
    """Parent-side stand-in for one worker breaker not CLOSED: the
    fleet's pressure model reads only `.state != CLOSED`, so mirroring
    the count from the heartbeat prices exactly."""

    __slots__ = ("state",)

    def __init__(self):
        self.state = OPEN


def prepare_card_libraries() -> None:
    """Make sure the segment kernel's library and the native host
    library exist before a card worker boots, building them here when
    they do not (each build holds its file lock in build/, so concurrent
    processes build once). Raises the build's error."""
    from quest_tpu_torch import native
    from quest_tpu_torch.ops import _build
    _build.build()
    native.build()


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------


class ReplicaProxy:
    """One supervised worker process behind the ServeEngine surface the
    fleet reads: submit / _submit / drain / close / reap_cancelled / plan
    / state / name / device / max_batch / traj_engine / _pending /
    _admission / _breakers / _supervisor, plus snapshot() and
    worker_pid().

    Admission runs here against the worker engine's own max_queue: the
    proxy counts every incomplete request (queued or dispatched), the
    worker only queued ones, so a submit the proxy admits is never
    queue-rejected by the worker (the fleet relies on a synchronous
    RejectedError to try the next replica).

    Keywords: `name`, `registry` (default the process-wide one; the
    worker keeps its own, shipped in its heartbeats), `heartbeat_s`
    (QUEST_HEARTBEAT_S), `restart_max` (QUEST_SERVE_RESTART_MAX, the
    process respawn budget), `backoff_base_s`; the rest passes to the
    worker's ServeEngine. `device` names where the worker serves; with
    none, the card (env.default_device)."""

    # _wlock serializes frame writes only and is never taken with _lock
    # held; the Popen handle is owned by whichever single thread holds
    # the transport (the booting constructor, or the one loss handler
    # the _respawning flag admits)
    _GUARDED_BY = {
        "_lock": ("_inflight", "_payloads", "_pending", "_state",
                  "_failure_cause", "_last_hb", "_last_snapshot",
                  "_breakers", "_shipped", "_next_id", "_generation",
                  "_respawning", "_healthy_noted", "_rpc_waiters",
                  "_hello", "_last_hb_frame", "_rx_sock"),
        "_wlock": ("_sock",),
        "<owner-thread>": ("_proc",),
    }

    def __init__(self, *, name: Optional[str] = None,
                 registry: Optional[M.Registry] = None,
                 heartbeat_s: Optional[float] = None,
                 restart_max: Optional[int] = None,
                 backoff_base_s: float = 0.05,
                 **engine_kw):
        if heartbeat_s is None:
            heartbeat_s = knob_value("QUEST_HEARTBEAT_S")
        if restart_max is None:
            restart_max = knob_value("QUEST_SERVE_RESTART_MAX")
        if engine_kw.pop("durable_mesh", None) is not None:
            raise ValueError(
                "process replicas build their own mesh in their own "
                "process; durable_mesh= is a thread-replica option")
        self.name = name or "proc"
        self.heartbeat_s = float(heartbeat_s)
        self.registry = registry if registry is not None else M.REGISTRY
        # the card unless the caller names a device: resolved here, so a
        # parent without CUDA fails now rather than in every worker
        self.device = resolve_device(engine_kw.get("device"))
        engine_kw["device"] = str(self.device)
        # the worker engine's knob resolution, mirrored so fleet routing
        # sees the same max_batch / traj_engine as on a thread replica
        max_queue = engine_kw.get("max_queue")
        if max_queue is None:
            max_queue = knob_value("QUEST_SERVE_MAX_QUEUE")
        max_batch = engine_kw.get("max_batch")
        if max_batch is None:
            max_batch = knob_value("QUEST_SERVE_MAX_BATCH")
        self.max_batch = int(max_batch)
        self.traj_engine = engine_kw.get("traj_engine")
        self._engine_kw = dict(engine_kw)
        self._admission = AdmissionController(max_queue)
        # the PROCESS restart budget (heartbeat loss, EOF, engine death),
        # apart from the worker engine's own
        self._supervisor = Supervisor(restart_max, base_s=backoff_base_s)
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        self._inflight: Dict[int, Future] = {}
        self._payloads: Dict[int, dict] = {}    # rid -> full payload
        self._rpc_waiters: Dict[int, Future] = {}
        self._pending = 0
        self._next_id = 0
        self._state = "running"
        self._failure_cause: Optional[BaseException] = None
        self._shipped: set = set()      # digests this worker boot holds
        self._breakers: Dict[tuple, _BreakerMirror] = {}
        self._last_snapshot: dict = {}
        self._last_hb_frame: dict = {}
        self._hello: dict = {}
        self._generation = 0
        self._respawning = False
        self._healthy_noted = True
        self._last_hb = time.monotonic()
        self._m_losses = self.registry.counter("ipc_worker_losses")
        self._m_respawns = self.registry.counter("ipc_worker_respawns")
        self._m_resubmits = self.registry.counter("ipc_resubmits")
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._rx_sock: Optional[socket.socket] = None
        if self.device.type == "cuda":
            prepare_card_libraries()
        self._spawn(respawn=False)
        self._start_rx(self._generation)

    # -- spawn / transport -------------------------------------------------

    def _spawn(self, respawn: bool) -> None:
        """Boot one worker process and wait for its hello. Raises on a
        failed exec or a boot that never says hello (the worker's own
        error when it sent one); the caller owns the budget decision."""
        if _F.ACTIVE:
            _F.check("fleet.spawn", replica=self.name, respawn=respawn)
        parent, child = socket.socketpair()
        env = os.environ.copy()
        # one interpreter per replica: an intra-op thread pool in every
        # worker would oversubscribe the host they share
        env["OMP_NUM_THREADS"] = "1"
        env["OPENBLAS_NUM_THREADS"] = "1"
        env["MKL_NUM_THREADS"] = "1"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        t0 = time.monotonic()
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "quest_tpu_torch.serve.worker_main",
                 "--fd", str(child.fileno())],
                pass_fds=(child.fileno(),), env=env,
                stdin=subprocess.DEVNULL)
        except OSError:
            parent.close()
            child.close()
            raise
        child.close()
        try:
            send_frame(parent, {
                "t": "init", "name": self.name,
                "heartbeat_s": self.heartbeat_s,
                "engine_kw": self._engine_kw})
            parent.settimeout(_BOOT_TIMEOUT_S)
            hello = recv_frame(parent)
            if hello.get("t") != "hello":
                raise RuntimeError(
                    f"worker {self.name} booted with {hello!r}, not hello")
            err = hello.get("error")
            if isinstance(err, BaseException):
                raise err
            if err is not None:
                raise RuntimeError(
                    f"worker {self.name} failed to build its engine: {err}")
        except BaseException:
            parent.close()
            proc.kill()
            proc.wait()
            raise
        hello["boot_s"] = time.monotonic() - t0
        # blocking from here: writes wait for a busy worker to read (a
        # timeout on a write would read as a loss), and the rx pump
        # watches for silence with select
        parent.settimeout(None)
        with self._lock:
            self._generation += 1
            self._last_hb = time.monotonic()
            self._shipped = set()
            self._healthy_noted = False
            self._hello = hello
            self._rx_sock = parent
        with self._wlock:
            self._sock = parent
        self._proc = proc

    def _start_rx(self, gen: int) -> None:
        threading.Thread(target=self._rx_main, args=(gen,),
                         name=f"ipc-rx-{self.name}", daemon=True).start()

    def _send(self, payload: dict) -> None:
        """Write one frame to the current worker (encoded before the
        write lock is taken). An OSError here is a transport loss: the
        caller decides whether it fails the request or starts loss
        handling."""
        if _F.ACTIVE:
            _F.check("ipc.send", replica=self.name, type=payload["t"])
        pieces = encode_frame(payload)
        with self._wlock:
            sock = self._sock
            if sock is None:
                raise OSError("ipc transport is down")
            # serialized writers are the framing guarantee (no
            # interleaved frames); no lock nests under this one
            write_frame(sock, pieces)

    def _send_submit(self, payload: dict) -> None:
        """Ship one submit payload, with the circuit descriptor on the
        digest's first trip to this worker boot."""
        dg = payload["digest"]
        with self._lock:
            first = dg not in self._shipped
            self._shipped.add(dg)
        wire = dict(payload)
        if not first:
            wire["circ"] = None
        self._send(wire)

    # -- engine duck-type --------------------------------------------------

    @property
    def state(self) -> str:
        """'running' | 'failed' (respawn budget exhausted) | 'closed'."""
        # quest-lint: disable=QL005(observability fast path: racy flag read, engine.state contract)
        return self._state

    def plan(self, circuit, *, batch: Optional[int] = None,
             density: bool = False, dtype=None):
        """ServeEngine.plan for a process replica, priced here: plans are
        content-addressed files on shared disk, so the parent's price and
        the worker's load are one plan."""
        from quest_tpu_torch import plan as P
        return P.autotune(circuit,
                          state_kind="density" if density else "pure",
                          dtype=np.float32 if dtype is None else dtype,
                          batch=batch, device=self.device)

    def submit(self, circuit, state=None, shots: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None,
               deadline_s: Optional[float] = None,
               observable=None, density: bool = False,
               durable_dir: Optional[str] = None,
               durable_every: Optional[int] = None) -> Future:
        """ServeEngine.submit over the wire: a trajectory request's
        uniforms are drawn here, on the caller's thread."""
        from quest_tpu_torch.serve import engine as SE
        SE.check_request(state, shots, observable=observable,
                         density=density, durable_dir=durable_dir,
                         durable_every=durable_every)
        uniforms = SE.draw_request_uniforms(circuit, shots, generator, seed)
        return self._submit(circuit, state, shots, uniforms=uniforms,
                            deadline_s=deadline_s, observable=observable,
                            density=density, durable_dir=durable_dir,
                            durable_every=durable_every)

    def _submit(self, circuit, state=None, shots: Optional[int] = None, *,
                uniforms=None, deadline_s: Optional[float] = None,
                observable=None, density: bool = False,
                durable_dir: Optional[str] = None,
                durable_every: Optional[int] = None) -> Future:
        """ServeEngine._submit over the wire: admission is checked here
        (a synchronous RejectedError), the payload ships as a value-keyed
        descriptor with its drawn uniforms, and the future resolves from
        the worker's result frame. A PauliSum observable ships as its
        spec (checked against the circuit here, resolved at the worker);
        an observable that does not pickle is refused with ValueError.
        The caller has run check_request (the worker runs it again on the
        request off the wire)."""
        if observable is not None:
            if not callable(observable):
                from quest_tpu_torch.ops.expec import resolve_observable
                resolve_observable(observable, circuit.num_qubits,
                                   density=density)
            try:
                pickle.dumps(observable)
            except (TypeError, AttributeError, pickle.PicklingError) as e:
                # AttributeError is pickle's voice for a local or lambda
                # callable ("Can't pickle local object ...")
                raise ValueError(
                    f"process replicas require a picklable observable: "
                    f"{e!r} — run this workload on thread replicas "
                    f"(ServeFleet(process=False)) or make the observable "
                    f"a module-level callable") from e
        if state is not None:
            state = torch.as_tensor(state).detach().cpu().numpy()
        if uniforms is not None:
            uniforms = torch.as_tensor(uniforms, dtype=torch.float64
                                       ).cpu().numpy()
        payload = {
            "t": "submit", "digest": circuit_digest(circuit),
            "circ": circuit_descriptor(circuit),
            "state": state, "shots": shots, "uniforms": uniforms,
            "observable": observable, "density": bool(density),
            "durable_dir": durable_dir, "durable_every": durable_every,
            "deadline_s": deadline_s,
        }
        with self._lock:
            if self._state == "closed":
                raise RejectedError(
                    "Invalid operation: submit() after close() — this "
                    "process replica is shut down.")
            if self._state == "failed":
                raise RejectedError(
                    f"Invalid operation: process replica {self.name!r} is "
                    f"FAILED — its respawn budget is exhausted; last "
                    f"cause: {self._failure_cause!r}."
                ) from self._failure_cause
            self._admission.admit(self._pending)
            rid = self._next_id
            self._next_id += 1
            payload["id"] = rid
            fut: Future = Future()
            self._inflight[rid] = fut
            self._payloads[rid] = payload
            self._pending += 1
            gen = self._generation
            respawning = self._respawning
        if respawning:
            # the loss handler owns the transport: it resubmits every
            # payload in the ledger, this one included, once the fresh
            # worker is up
            return fut
        try:
            self._send_submit(payload)
        except (TypeError, AttributeError, pickle.PicklingError) as e:
            with self._lock:
                self._drop_locked(rid)
            raise ValueError(
                f"process replicas require picklable request payloads: "
                f"{e!r} — run this workload on thread replicas "
                f"(ServeFleet(process=False))") from e
        except OSError as e:
            # the transport died under the submit: the request is in the
            # ledger, so it rides the loss handler's resubmit
            self._on_worker_loss(gen, e)
        return fut

    def reap_cancelled(self) -> int:
        """Drop in-flight requests whose futures were cancelled (the
        fleet's shed eviction) and tell the worker to reap its side.
        Returns how many."""
        with self._lock:
            gone = [rid for rid, f in self._inflight.items()
                    if f.cancelled()]
            for rid in gone:
                self._drop_locked(rid)
        for rid in gone:
            try:
                self._send({"t": "cancel", "id": rid})
            except OSError:
                break   # loss handling owns the transport now
        return len(gone)

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Flush the worker's queues: one drain round trip, bounded by
        `timeout_s` at the worker plus transport slack here."""
        with self._lock:
            if self._state == "closed":
                raise RejectedError(
                    "Invalid operation: drain() after close().")
            if self._state == "failed" or self._respawning:
                return      # futures resolve via the fail / resubmit paths
            rid = self._next_id
            self._next_id += 1
            waiter: Future = Future()
            self._rpc_waiters[rid] = waiter
        try:
            self._send({"t": "drain", "id": rid, "timeout_s": timeout_s})
            wait = None if timeout_s is None else timeout_s + _RPC_SLACK_S
            reply = waiter.result(timeout=wait)
        except OSError:
            return          # worker lost mid-drain; the loss handler runs
        except (TimeoutError, _FutureTimeout):
            raise TimeoutError(
                f"replica {self.name!r} drain() reply overdue "
                f"(timeout_s={timeout_s})") from None
        finally:
            with self._lock:
                self._rpc_waiters.pop(rid, None)
        if not reply.get("ok", False):
            err = reply.get("error")
            if isinstance(err, BaseException):
                raise err
            raise TimeoutError(str(err))

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Graceful worker shutdown: a close round trip (the worker
        drains and exits), then terminate and kill as escalation.
        Idempotent."""
        with self._lock:
            if self._state == "closed":
                return
            was_failed = self._state == "failed"
            self._state = "closed"
            leftovers = list(self._inflight.values())
            self._inflight.clear()
            self._payloads.clear()
            self._pending = 0
        proc = self._proc
        if not was_failed and proc is not None:
            try:
                self._send({"t": "close", "timeout_s": timeout_s})
            except OSError:
                pass
            try:
                proc.wait(timeout=(timeout_s if timeout_s is not None
                                   else 30.0))
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        elif proc is not None:
            proc.kill()
            proc.wait()
        with self._wlock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
        for f in leftovers:
            if not f.done() and f.set_running_or_notify_cancel():
                f.set_exception(RejectedError(
                    "Invalid operation: process replica closed with the "
                    "request incomplete."))

    # -- stats -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The worker registry's last heartbeat snapshot (what the
        fleet's merged scrape folds in)."""
        with self._lock:
            return dict(self._last_snapshot)

    def hello(self) -> dict:
        """The live worker's hello frame: its pid, `boot_s` (spawn to
        hello, read here) and, on the card, its `cuda` memory readings at
        boot."""
        with self._lock:
            return dict(self._hello)

    def heartbeat(self) -> dict:
        """The live worker's last heartbeat: health, its registry
        snapshot, the segment kernel's launch counts (`kernels`), on the
        card its memory (`cuda`), and `rx_t`, the time.monotonic() it
        arrived here."""
        with self._lock:
            return dict(self._last_hb_frame)

    def worker_pid(self) -> Optional[int]:
        """The live worker's OS pid."""
        proc = self._proc
        return None if proc is None else proc.pid

    # -- rx pump + supervision ---------------------------------------------

    def _rx_main(self, gen: int) -> None:
        """One pump per worker generation: results, heartbeats, drain
        replies; detects a loss (EOF, a poisoned frame, silence, an
        engine-FAILED heartbeat) and hands it to the loss handler. Every
        frame counts as a beat: a worker streaming results is alive even
        while its heartbeat waits behind them. Silence is _HB_MISS
        intervals without a frame, or without a byte mid-frame."""
        silence = _HB_MISS * self.heartbeat_s
        poll = max(0.05, self.heartbeat_s / 2.0)
        with self._lock:
            # this generation's socket, read once: the pump never waits on
            # the write lock, which a write to a stalled worker holds
            sock = self._rx_sock
        while True:
            with self._lock:
                if self._generation != gen or self._state == "closed":
                    return
                last_hb = self._last_hb
            try:
                if not select.select([sock], [], [], poll)[0]:
                    if time.monotonic() - last_hb > silence:
                        raise socket.timeout(
                            f"worker {self.name!r} sent nothing for "
                            f"{_HB_MISS} heartbeats (QUEST_HEARTBEAT_S="
                            f"{self.heartbeat_s})")
                    continue
                frame = recv_frame(sock, idle_s=silence)
            except (EOFError, OSError, ValueError,
                    pickle.UnpicklingError) as e:
                # socket.timeout is an OSError: silence is a loss too
                self._on_worker_loss(gen, e)
                return
            with self._lock:
                self._last_hb = time.monotonic()
            if _F.ACTIVE:
                try:
                    _F.check("ipc.recv", replica=self.name,
                             type=frame.get("t"))
                except BaseException as e:  # noqa: BLE001 - typed loss
                    self.registry.counter("serve_faults_injected").inc()
                    self._on_worker_loss(gen, e)
                    return
            if not self._on_frame(gen, frame):
                return

    def _on_frame(self, gen: int, frame: dict) -> bool:
        """Dispatch one worker frame; False ends this pump."""
        t = frame.get("t")
        if t == "result":
            with self._lock:
                fut = self._inflight.pop(frame["id"], None)
                self._payloads.pop(frame["id"], None)
                if fut is not None:
                    self._pending -= 1
                note_healthy = not self._healthy_noted
                self._healthy_noted = True
            if note_healthy:
                # the first completed request since the (re)spawn: the
                # worker serves, so the crash-loop budget refills
                self._supervisor.record_success()
            if fut is None or fut.done() or \
                    not fut.set_running_or_notify_cancel():
                return True
            if frame.get("ok"):
                fut.set_result(from_wire(frame.get("value")))
            else:
                fut.set_exception(frame.get("error"))
            return True
        if t == "hb":
            frame["rx_t"] = time.monotonic()
            with self._lock:
                self._last_snapshot = frame.get("snapshot", {})
                self._last_hb_frame = frame
                self._breakers = {
                    ("worker", i): _BreakerMirror()
                    for i in range(int(frame.get("open_breakers", 0)))}
            if frame.get("state") == "failed":
                # the worker's engine exhausted its own budget: the
                # process lives but serves nothing, so it is a loss and
                # the respawn brings a fresh engine
                self._on_worker_loss(gen, RejectedError(
                    f"worker {self.name!r} engine went FAILED "
                    f"in-process."))
                return False
            return True
        if t == "drained":
            with self._lock:
                waiter = self._rpc_waiters.pop(frame["id"], None)
            if waiter is not None and not waiter.done():
                waiter.set_result(frame)
            return True
        return True     # unknown frame types are forward-compatible

    def _drop_locked(self, rid: int) -> None:
        if self._inflight.pop(rid, None) is not None:
            self._pending -= 1
        self._payloads.pop(rid, None)

    def _on_worker_loss(self, gen: int, cause: BaseException) -> None:
        """Kill and respawn under the Supervisor budget, resubmitting
        every incomplete request to the fresh worker; budget exhausted:
        FAILED, and the incomplete futures resolve requeue-typed so the
        fleet fails them over."""
        with self._lock:
            if (self._state != "running" or self._respawning
                    or self._generation != gen):
                return
            self._respawning = True
            self._breakers = {}
            # a dead worker's drain replies never come; their callers
            # time out on their own slack
            self._rpc_waiters.clear()
        self._m_losses.inc()
        proc = self._proc
        if proc is not None:
            proc.kill()
            proc.wait()
        with self._wlock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
        while True:
            with self._lock:
                if self._state != "running":
                    self._respawning = False
                    return
            delay = self._supervisor.next_backoff()
            if delay is None:
                self._fail(cause)
                return
            if delay > 0:
                time.sleep(delay)
            try:
                self._spawn(respawn=True)
                break
            except BaseException as e:  # noqa: BLE001 - budget loop
                cause = e
        self._m_respawns.inc()
        with self._lock:
            if self._state != "running":
                # closed mid-respawn: close() resolved the ledger; reap
                # the worker just booted
                self._respawning = False
                proc, self._proc = self._proc, None
            else:
                new_gen = self._generation
                resubmit = [self._payloads[rid]
                            for rid in sorted(self._payloads)]
                # snapshot and flag-clear are atomic: a submit after this
                # block sends itself on the new socket, one before it is
                # in the snapshot
                self._respawning = False
                proc = None
        if proc is not None:
            proc.kill()
            proc.wait()
            return
        self._start_rx(new_gen)
        for payload in resubmit:
            try:
                self._send_submit(payload)
                self._m_resubmits.inc()
            except OSError as e:
                self._on_worker_loss(new_gen, e)
                return

    def _fail(self, cause: BaseException) -> None:
        with self._lock:
            if self._state != "running":
                self._respawning = False
                return
            self._state = "failed"
            self._failure_cause = cause
            self._respawning = False
            leftovers = list(self._inflight.values())
            self._inflight.clear()
            self._payloads.clear()
            self._pending = 0
        # requeue-typed (RejectedError, never DeadlineExceeded): safe to
        # re-serve, since the dead process delivered no result and never
        # will
        for f in leftovers:
            if not f.done() and f.set_running_or_notify_cancel():
                f.set_exception(RejectedError(
                    f"Invalid operation: process replica {self.name!r} "
                    f"lost its worker past the respawn budget; last "
                    f"cause: {cause!r} — the fleet requeues this request "
                    f"on a survivor."))

    def __enter__(self) -> "ReplicaProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
