"""Continuous micro-batching execution service over the batched engines.

A port of quest_tpu/serve/engine.py. Requests from many independent
clients coalesce so the card runs one batched launch where B requests
are queued, not B launches of one state:

    engine = ServeEngine()                      # knobs: QUEST_SERVE_*
    fut = engine.submit(circuit, state=planes)  # returns at once
    out = fut.result()                          # the planes after circuit

Model:

  * one daemon WORKER THREAD owns every launch; client threads only
    enqueue host payloads (and draw their own uniforms, below) and wait
    on futures.
  * requests queue per program identity — `Circuit.program_key()` /
    `trajectories.program_key()`: the same circuit object, register kind,
    plane dtype and `engine_mode_key()`. Requests with equal keys share
    launches.
  * no bucket padding: the batched programs take B at launch
    (`Circuit.compiled_batched` keys no batch size), so a coalesced apply
    batch of `len(reqs)` states launches exactly those states — one
    batched K1 sweep per segment on the card — and a trajectory batch
    runs chunks of `traj_dispatch_bucket(total, max_batch)` =
    min(total, max_batch) states, the last one at its own size.
  * an apply batch is stacked once on the host, moved to the engine's
    device in one copy, and brought back in at most one copy for all of
    its raw-planes requests; observable requests reduce on the device
    and move only their per-state values.
  * a queue dispatches when its oldest request has waited
    `QUEST_SERVE_MAX_WAIT_MS`, when `QUEST_SERVE_MAX_BATCH` states are
    pending, or when the engine drains. max_wait_ms=0 is the
    no-coalescing mode: every request launches alone.
  * randomness is a torch.Generator: a trajectory request draws its
    (shots, C) f64 uniforms at submit, on the client's thread, with
    run_batched's shot-major rule. The worker concatenates requests'
    uniforms, chunks them and splits the results back, so a request's
    draws are the same whether it rides alone or coalesced, and equal to
    run_batched(circuit, shots, generator=<the same state>)'s. The worker
    never touches a client's generator.
  * admission (serve/admission.py): a bounded queue with a loud
    RejectedError, deadlines failing with DeadlineExceeded before
    dispatch, cancellation of queued futures, drain()/close().
  * every hop records into serve.metrics (queue wait, end-to-end
    latency, counters, and batch occupancy: the states a launch ran over
    max_batch).

Resilience:

  * SUPERVISION — a worker crash restarts the worker (backoff and
    jitter, `QUEST_SERVE_RESTART_MAX` consecutive crashes). Queued
    futures survive; popped-but-undispatched requests requeue in order;
    requests whose launch had started fail with the crash (their outcome
    is unknown). Budget gone: the engine turns FAILED, every pending
    future fails with a typed RejectedError and submit() rejects.
  * WATCHDOG — with `QUEST_DISPATCH_TIMEOUT_S` > 0, a launch outliving
    it fails its batch typed DispatchTimeout, counts against its
    program's breaker, and a new worker generation replaces the wedged
    one. A CUDA launch cannot be cancelled, so the wedged thread is only
    superseded: whatever it does when it returns is discarded.
  * POISONED-BATCH ISOLATION — a failing coalesced launch splits in two
    and retries the halves (bounded depth and retries), so one bad
    request gets its own error while its batch-mates get results; a
    per-request demux error (a bad observable) fails only its own
    future.
  * DEGRADATION LADDER — a circuit breaker per program key. While it
    is closed, a primary build failure fails the requests of its
    dispatch (no split: no request's data is at fault) and counts on
    the breaker. After `QUEST_SERVE_BREAKER_THRESHOLD` consecutive ones
    it opens, and only then do the program's requests step down fused
    -> banded -> host (the native host engine, one state at a time on
    the CPU) and keep completing; after a cooldown one half-open probe
    restores fused. Each degraded dispatch is counted in
    `serve_degraded_dispatches`; health() shows the open breakers. A
    failure of the card or its toolchain (the kernel's nvcc build, a
    library load, a CUDA error) never steps down the ladder and counts
    on no breaker: it fails its dispatch.
  * FAULT INJECTION — every recovery path is provable through the named
    sites of resilience.faults (serve.worker_loop, serve.compile — checked
    at every ladder rung a dispatch builds, ctx["rung"] naming it —,
    serve.device_put, serve.dispatch, serve.demux); an empty plan costs
    one module-attribute read a site.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.resilience import faults as _F
from quest_tpu_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN, Breaker
from quest_tpu_torch.resilience.supervisor import Supervisor
from quest_tpu_torch.serve import metrics as M
from quest_tpu_torch.serve.admission import (AdmissionController,
                                             DeadlineExceeded,
                                             DispatchTimeout, RejectedError)

# the degradation ladder, most capable first: 'fused' is what the batched
# program resolves to (the segment kernel from 10 qubits), 'banded' the
# banded program over the batch, 'host' the native C++ engine
DEFAULT_LADDER = ("fused", "banded", "host")


class _Request:
    __slots__ = ("future", "kind", "state", "shots", "uniforms",
                 "observable", "expiry", "submit_t", "states", "started",
                 "dispatched", "retries", "durable_dir", "durable_every")

    def __init__(self, kind, state, shots, uniforms, observable, expiry,
                 submit_t, states, durable_dir=None, durable_every=None):
        self.future: Future = Future()
        self.kind = kind                  # 'apply' | 'traj' | 'durable'
        self.state = state                # (2, 2^n) planes (apply/durable)
        self.shots = shots                # int (traj)
        self.uniforms = uniforms          # (shots, C) f64 (traj)
        self.observable = observable
        self.expiry = expiry              # absolute monotonic or None
        self.submit_t = submit_t
        self.states = states              # batch slots this request takes
        self.started = False              # future transitioned RUNNING
        self.dispatched = False           # a launch holding it began
        self.retries = 0                  # failed launches it rode
        self.durable_dir = durable_dir
        self.durable_every = durable_every


class _BuildFailure(Exception):
    """The program of a dispatch did not build and the ladder may not
    step round it: every request of the dispatch fails with `cause`,
    without the poisoned-batch split."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _card_fault(e: BaseException) -> bool:
    """Whether a build failure is the card's or its toolchain's (the
    kernel library's nvcc build or load, a CUDA error) rather than one
    program's."""
    from quest_tpu_torch.ops._build import BuildError
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, (BuildError, OSError))
            or (accel is not None and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def traj_dispatch_bucket(total: int, max_batch: int) -> int:
    """States a trajectory launch of `total` shot slots runs at once under
    a `max_batch` bound: min(total, max_batch). The programs take any
    batch, so nothing rounds up; warmup maps declared sizes through this
    rule too."""
    return max(1, min(int(total), int(max_batch)))


def _num_channels(circuit) -> int:
    """Channels of a trajectory request: one per noise op (the
    trajectory programs' `num_channels`)."""
    return sum(1 for op in circuit.ops if op.kind == "superop")


def _draw_uniforms(shots: int, channels: int,
                   generator: torch.Generator) -> torch.Tensor:
    """A trajectory request's (shots, C) f64 uniforms from its generator,
    on the CPU: run_batched's shot-major draw."""
    return torch.rand((shots, channels), generator=generator,
                      dtype=torch.float64, device=generator.device).cpu()


def check_request(state, shots, *, observable=None, density=False,
                  durable_dir=None, durable_every=None) -> None:
    """The checks every submit makes before it draws or queues anything
    (the engine's, the fleet's and a process replica's)."""
    if (state is None) == (shots is None):
        raise ValueError(
            "submit() takes exactly one of state= (apply request) "
            "or shots= (trajectory request)")
    if durable_dir is not None:
        if state is None:
            raise ValueError(
                "durable_dir= requires a state= request; durable "
                "trajectories run through "
                "resilience.run_durable_trajectories")
        if observable is not None:
            raise ValueError(
                "durable_dir= is incompatible with observable=: the "
                "planes are the job's resume payload")
    elif durable_every is not None:
        raise ValueError("durable_every= requires durable_dir=")
    if state is None and density:
        raise ValueError("trajectory requests are statevector "
                         "unravelings; density=True is invalid")


def draw_request_uniforms(circuit, shots, generator=None, seed=None
                          ) -> Optional[torch.Tensor]:
    """A request's trajectory uniforms, drawn on the caller's thread
    (None for an apply request, which takes neither keyword): the
    (shots, C) f64 draw from `generator`, or from a CPU generator seeded
    with `seed` (default 0), shot-major as run_batched draws them."""
    if shots is None:
        if generator is not None or seed is not None:
            raise ValueError("generator= / seed= belong to shots= requests")
        return None
    if generator is not None and seed is not None:
        raise ValueError("pass generator= or seed=, not both")
    shots = int(shots)
    if shots < 1:
        raise ValueError(f"shots must be >= 1, got {shots}")
    if generator is None:
        generator = torch.Generator().manual_seed(
            0 if seed is None else int(seed))
    return _draw_uniforms(shots, _num_channels(circuit), generator)


class _Queue:
    __slots__ = ("key", "circuit", "kind", "density", "engine", "requests",
                 "pending_states")

    def __init__(self, key, circuit, kind, density, engine):
        self.key = key
        self.circuit = circuit
        self.kind = kind
        self.density = density
        self.engine = engine              # trajectory engine, or None
        self.requests: Deque[_Request] = deque()
        # sum(r.states), kept incrementally (the due check runs per pop)
        self.pending_states = 0


class ServeEngine:
    """Continuous micro-batcher over `Circuit.compiled_batched` and the
    trajectory programs. Thread-safe `submit()`; one worker thread
    coalesces, launches and demuxes. Use it as a context manager or call
    `close()`, which drains what is queued.

    Keywords override the QUEST_SERVE_* knobs for this engine (read once
    here): `max_wait_ms`, `max_queue`, `max_batch`, `restart_max`,
    `breaker_threshold`, `dispatch_timeout_s` (QUEST_DISPATCH_TIMEOUT_S).
    `device`: where the programs run (default: the CUDA card; "cpu" runs
    the plain PyTorch versions). `traj_engine` pins the trajectory engine
    ('fused' | 'banded' | 'host'; default: fused from 10 qubits, banded
    below). `registry` redirects the metrics (default: the process-wide
    one); `backoff_base_s` / `breaker_cooldown_s` set the recovery
    timings; `ladder` the degradation rungs; `name` labels this engine in
    every fault-site context (`ctx["replica"]`)."""

    # the one engine lock: `_cond` wraps `_lock`
    _GUARDED_BY = {
        "_lock|_cond": ("_queues", "_pending", "_inflight", "_drainers",
                        "_closed", "_stop", "_failure_cause", "_state",
                        "_active", "_active_failed", "_worker_gen",
                        "_worker", "_watch", "_watch_seq", "_watchdog"),
        # owned by the live worker generation (or the watchdog while that
        # worker is provably stuck)
        "<owner-thread>": ("_breakers",),
    }

    def __init__(self, *, max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 device=None,
                 traj_engine: Optional[str] = None,
                 registry: Optional[M.Registry] = None,
                 restart_max: Optional[int] = None,
                 backoff_base_s: float = 0.05,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_s: float = 0.5,
                 ladder: Optional[Tuple[str, ...]] = None,
                 name: Optional[str] = None,
                 dispatch_timeout_s: Optional[float] = None,
                 durable_mesh=None,
                 durable_elastic: Optional[bool] = None):
        if max_wait_ms is None:
            max_wait_ms = knob_value("QUEST_SERVE_MAX_WAIT_MS")
        if max_queue is None:
            max_queue = knob_value("QUEST_SERVE_MAX_QUEUE")
        if max_batch is None:
            max_batch = knob_value("QUEST_SERVE_MAX_BATCH")
        if restart_max is None:
            restart_max = knob_value("QUEST_SERVE_RESTART_MAX")
        if breaker_threshold is None:
            breaker_threshold = knob_value("QUEST_SERVE_BREAKER_THRESHOLD")
        if dispatch_timeout_s is None:
            dispatch_timeout_s = knob_value("QUEST_DISPATCH_TIMEOUT_S")
        if dispatch_timeout_s < 0:
            raise ValueError(
                f"dispatch_timeout_s must be >= 0, got {dispatch_timeout_s}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if traj_engine not in (None, "fused", "banded", "host"):
            raise ValueError(f"traj_engine must be None, 'fused', 'banded' "
                             f"or 'host', got {traj_engine!r}")
        ladder = DEFAULT_LADDER if ladder is None else tuple(ladder)
        bad = [e for e in ladder if e not in DEFAULT_LADDER]
        if bad:
            raise ValueError(f"unknown ladder engine(s) {bad}; the rungs "
                             f"are {list(DEFAULT_LADDER)}")
        self.name = name
        self.device = resolve_device(device)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_batch = int(max_batch)
        self.traj_engine = traj_engine
        self.registry = registry if registry is not None else M.REGISTRY
        # per-rider metric handles, looked up once
        self._m_served = self.registry.counter("serve_requests_served")
        self._m_e2e = self.registry.histogram("serve_e2e_latency_s")
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.ladder = ladder
        # a split deeper than log2(max_batch) cannot shrink a batch
        # further; +1 for the singleton level
        self._split_depth_cap = max(1, self.max_batch.bit_length() + 1)
        self._retry_cap = self._split_depth_cap + 1
        self._admission = AdmissionController(max_queue)
        self._supervisor = Supervisor(restart_max, base_s=backoff_base_s)
        self._breakers: Dict[tuple, Breaker] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[tuple, _Queue] = {}
        self._pending = 0
        self._inflight = 0
        self._drainers = 0                # concurrent drain() calls
        self._closed = False
        self._stop = False
        self._failure_cause: Optional[BaseException] = None
        self._state = "running"
        # what the worker holds outside the queues right now (popped
        # batches, popped expiries), so recovery can requeue or fail it
        self._active: List[Tuple[_Queue, List[_Request]]] = []
        self._active_failed: List[Tuple[_Request, BaseException]] = []
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        # durable jobs run sharded over durable_mesh (a parallel.AmpMesh)
        # when one is given; durable_elastic lets a job resume a chain
        # that a replica on another mesh left behind
        from quest_tpu_torch.parallel.mesh import refuse_process_mesh
        refuse_process_mesh(durable_mesh, "ServeEngine(durable_mesh=)")
        self.durable_mesh = durable_mesh
        self.durable_elastic = durable_elastic
        # the worker generation: the watchdog supersedes a wedged worker
        # by bumping it, and a stale thread that unsticks sees the bump
        # and exits without touching recovered state
        self._worker_gen = 0
        self._watch: Dict[int, Tuple[float, int, _Queue]] = {}
        self._watch_seq = 0
        self._watchdog: Optional[threading.Thread] = None
        _F.install_from_env()             # QUEST_FAULT_PLAN
        with self._cond:
            self._spawn_worker_locked()
            if self.dispatch_timeout_s > 0:
                self._watchdog = threading.Thread(
                    target=self._watchdog_main,
                    name="quest-serve-watchdog", daemon=True)
                self._watchdog.start()

    def _spawn_worker_locked(self) -> None:
        """Start a worker thread under a new generation (the lock held);
        a thread still running under the old one is superseded."""
        self._worker_gen += 1
        self._worker = threading.Thread(
            target=self._worker_main, args=(self._worker_gen,),
            name="quest-serve-worker", daemon=True)
        self._worker.start()

    # -- client API --------------------------------------------------------

    @property
    def state(self) -> str:
        """'running' | 'failed' (restart budget exhausted) | 'closed'."""
        # quest-lint: disable=QL005(observability fast path: racy flag read, never blocks behind a dispatch)
        if self._closed:
            return "closed"
        # quest-lint: disable=QL005(same racy-read contract as _closed above)
        return self._state

    def health(self) -> dict:
        """Liveness in one call (racy reads by design, never waiting
        behind a dispatch): state, queued requests, breakers not CLOSED,
        restarts left, and the degraded dispatches so far."""
        return {
            "state": self.state,
            "pending": self._pending,  # quest-lint: disable=QL005(observability fast path: racy read, never blocks behind a dispatch)
            "open_breakers": sum(1 for br in list(self._breakers.values())
                                 if br.state != CLOSED),
            "restarts_remaining": self._supervisor.remaining,
            "degraded_dispatches": self.registry.counter(
                "serve_degraded_dispatches").value,
        }

    def plan(self, circuit, *, batch: Optional[int] = None,
             density: bool = False, dtype=None):
        """The priced ProgramPlan this engine would dispatch `circuit`
        under (plan.autotune through the plan cache): host introspection
        only, no build, no queue."""
        from quest_tpu_torch import plan as P
        return P.autotune(circuit,
                          state_kind="density" if density else "pure",
                          dtype=np.float32 if dtype is None else dtype,
                          batch=batch, device=self.device)

    def submit(self, circuit, state=None, shots: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None,
               deadline_s: Optional[float] = None,
               observable: Optional[Callable] = None,
               density: bool = False,
               durable_dir: Optional[str] = None,
               durable_every: Optional[int] = None) -> Future:
        """Enqueue one request; returns a `concurrent.futures.Future`.

        Exactly one of `state` / `shots`:
          * `state` — (2, 2^n) planes ((2, 4^N) with `density=True`), a
            numpy array or a torch tensor on the CPU or on the engine's
            device, f32 or f64: the circuit applies through the batched
            engine and the future resolves to the output planes, a CPU
            tensor. With `observable=`, a callable reducing the device
            batch (B, 2, 2^n) to per-state values, the future resolves to
            this request's row of them. A `PauliSum` (or a (codes,
            coeffs) pair) is accepted on both request kinds and resolves
            here, at admission, to the grouped Pauli-sum reducer
            (ops/expec.resolve_observable), so a width mismatch rejects
            the submit; equal specs share one reduction per launch.
          * `shots` — that many stochastic trajectories of the circuit,
            run_batched's semantics: (planes (shots, 2, 2^n), draws
            (shots, C)) CPU tensors, or (observable values, draws). The
            (shots, C) f64 uniforms are drawn here, on the caller's
            thread, from `generator` (or a CPU generator seeded with
            `seed`, default 0), shot-major as run_batched draws them, so
            the draws equal run_batched(circuit, shots, generator=<that
            generator's state>)'s whether the request rides alone or
            coalesced.

        `durable_dir` routes a `state=` request through
        resilience.durable.run_durable at the worker: checkpoints under
        `durable_dir` every `durable_every` steps (default
        QUEST_DURABLE_EVERY), and a worker crash or preemption mid-job
        resumes from the chain instead of failing the future. Durable
        requests never coalesce and take no observable.

        `deadline_s` is relative: a request still queued when it elapses
        fails with DeadlineExceeded before any launch. Raises
        `RejectedError` when the queue is full, after `close()` ("engine
        closed"), and when the engine is FAILED."""
        check_request(state, shots, observable=observable, density=density,
                      durable_dir=durable_dir, durable_every=durable_every)
        uniforms = draw_request_uniforms(circuit, shots, generator, seed)
        return self._submit(circuit, state, shots, uniforms=uniforms,
                            deadline_s=deadline_s, observable=observable,
                            density=density, durable_dir=durable_dir,
                            durable_every=durable_every)

    def _submit(self, circuit, state=None, shots: Optional[int] = None, *,
                uniforms: Optional[torch.Tensor] = None,
                deadline_s: Optional[float] = None,
                observable: Optional[Callable] = None,
                density: bool = False,
                durable_dir: Optional[str] = None,
                durable_every: Optional[int] = None) -> Future:
        """submit() given a trajectory request's (shots, C) f64 uniforms
        already drawn: the entry of the fleet and of a process replica's
        worker, which draw once on the client's thread and carry the
        drawn tensor, so a requeue or a resubmit serves the same draws.
        The caller has run check_request."""
        if observable is not None and not callable(observable):
            from quest_tpu_torch.ops.expec import resolve_observable
            observable = resolve_observable(observable, circuit.num_qubits,
                                            density=density)
        now = time.monotonic()
        expiry = self._admission.expiry_of(deadline_s, now)
        if state is not None:
            n = circuit.num_qubits * 2 if density else circuit.num_qubits
            state = torch.as_tensor(state)
            if state.device.type != "cpu" and state.device != self.device:
                raise ValueError(
                    f"state is on {state.device}; this engine runs on "
                    f"{self.device} and takes planes there or on the CPU")
            if tuple(state.shape) != (2, 1 << n):
                raise ValueError(
                    f"state must be (2, {1 << n}) amplitude planes for "
                    f"this circuit, got {tuple(state.shape)}")
            if state.dtype not in (torch.float32, torch.float64):
                raise ValueError(f"state planes must be float32 or "
                                 f"float64, got {state.dtype}")
            qkey = circuit.program_key(
                density=density, dtype=str(state.dtype).replace("torch.",
                                                                ""))
            kind, engine_name = "apply", None
            if durable_dir is not None:
                # durable jobs run one at a time through run_durable:
                # their own queue family, never a batched launch
                kind, qkey = "durable", qkey + ("durable",)
            req = _Request(kind, state, None, None, observable, expiry, now,
                           1, durable_dir, durable_every)
        else:
            from quest_tpu_torch import trajectories as T
            shots = int(shots)
            if shots < 1 or uniforms is None:
                raise ValueError(f"a trajectory request takes shots >= 1 "
                                 f"and its drawn uniforms, got shots="
                                 f"{shots}, uniforms={type(uniforms)}")
            u = torch.as_tensor(uniforms, dtype=torch.float64)
            if tuple(u.shape) != (shots, _num_channels(circuit)):
                raise ValueError(
                    f"uniforms must be (shots, channels) = "
                    f"{(shots, _num_channels(circuit))}, got "
                    f"{tuple(u.shape)}")
            engine_name, qkey = T.program_key(circuit,
                                              engine=self.traj_engine)
            req = _Request("traj", None, shots, u.cpu(), observable, expiry,
                           now, shots)
            kind = "traj"

        with self._cond:
            if self._closed:
                self.registry.counter("serve_requests_rejected").inc()
                raise RejectedError(
                    "Invalid operation: engine closed — submit() after "
                    "ServeEngine.close(); create a new engine.")
            if self._state == "failed":
                self.registry.counter("serve_requests_rejected").inc()
                raise RejectedError(
                    f"Invalid operation: ServeEngine is FAILED — its "
                    f"worker exhausted the restart budget "
                    f"(QUEST_SERVE_RESTART_MAX="
                    f"{self._supervisor.max_restarts}); last cause: "
                    f"{self._failure_cause!r}. Create a new engine."
                ) from self._failure_cause
            try:
                self._admission.admit(self._pending)
            except Exception:
                self.registry.counter("serve_requests_rejected").inc()
                raise
            q = self._queues.get(qkey)
            if q is None:
                q = self._queues[qkey] = _Queue(qkey, circuit, kind,
                                                density, engine_name)
            q.requests.append(req)
            q.pending_states += req.states
            self._pending += 1
            # wake the worker only when this request moves its next due
            # time: a new queue, a full batch, a deadline, no coalescing
            # or a drain (a request behind others is due after them, and
            # a wake per submit makes the worker sweep the queue each time)
            if (len(q.requests) == 1 or q.pending_states >= self.max_batch
                    or req.expiry is not None or self.max_wait_s == 0.0
                    or self._drainers):
                self._cond.notify_all()
        self.registry.counter("serve_requests_submitted").inc()
        return req.future

    def reap_cancelled(self) -> int:
        """Drop cancelled requests from the queues now (the worker's own
        sweep does it at its next wake); returns how many."""
        dropped = 0
        with self._cond:
            for qkey in list(self._queues):
                q = self._queues[qkey]
                live = [r for r in q.requests if not r.future.cancelled()]
                n = len(q.requests) - len(live)
                if n:
                    q.requests = deque(live)
                    q.pending_states = sum(r.states for r in live)
                    self._pending -= n
                    dropped += n
                    self.registry.counter(
                        "serve_requests_cancelled").inc(n)
                if not q.requests:
                    del self._queues[qkey]
        return dropped

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Flush every queued request now (partial batches included) and
        block until all launches complete; submits arriving mid-drain
        are flushed too. After close() raises RejectedError; on a FAILED
        engine returns at once (the failure resolved every future)."""
        self._drain(timeout_s, _internal=False)

    def _drain(self, timeout_s: Optional[float], _internal: bool) -> None:
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cond:
            if self._stop and not _internal:
                raise RejectedError(
                    "Invalid operation: engine closed — drain() after "
                    "ServeEngine.close().")
            # a count: each drainer holds the flush mode open until its
            # own predicate turns true
            self._drainers += 1
            self._cond.notify_all()
            try:
                while self._pending or self._inflight:
                    if self._state == "failed":
                        return
                    t = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
                    if t == 0.0:
                        raise TimeoutError(
                            f"drain() timed out with {self._pending} "
                            f"pending and {self._inflight} in-flight "
                            f"batch(es)")
                    self._cond.wait(t)
            finally:
                self._drainers -= 1

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Reject new submits, drain queued work, stop the worker.
        Idempotent."""
        with self._cond:
            if self._closed and not self._worker.is_alive():
                return
            self._closed = True
        self._drain(timeout_s, _internal=True)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            worker, watchdog = self._worker, self._watchdog
        worker.join(timeout=timeout_s)
        if watchdog is not None:
            watchdog.join(timeout=timeout_s)

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resilience plumbing -----------------------------------------------

    def _fault(self, site: str, **ctx) -> None:
        """Fault hook: call sites guard it with `if _F.ACTIVE:`; a firing
        site is counted before the error propagates into the recovery
        path that owns it. Every context carries `replica`."""
        try:
            _F.check(site, replica=self.name, **ctx)
        except BaseException:
            self.registry.counter("serve_faults_injected").inc()
            raise

    def _breaker_for(self, q: _Queue) -> Breaker:
        br = self._breakers.get(q.key)
        if br is None:
            opens = self.registry.counter("serve_breaker_opens")
            closes = self.registry.counter("serve_breaker_closes")
            probes = self.registry.counter("serve_breaker_probes")
            gauge = self.registry.gauge("serve_breakers_open")

            def on_transition(old: str, new: str) -> None:
                if new == OPEN and old != OPEN:
                    opens.inc()
                    if old == CLOSED:
                        gauge.inc()
                elif old == OPEN and new == HALF_OPEN:
                    probes.inc()
                elif new == CLOSED:
                    closes.inc()
                    gauge.dec()

            br = self._breakers[q.key] = Breaker(
                self.breaker_threshold, self.breaker_cooldown_s,
                on_transition=on_transition)
        return br

    def _fail_request(self, r: _Request, exc: BaseException,
                      counter: Optional[str] = "serve_requests_failed"
                      ) -> None:
        """Resolve one future with an error, tolerating requests already
        started, cancelled or resolved (the watchdog and a superseded
        worker may race to one future: the loser's InvalidStateError
        means it is resolved either way)."""
        if r.future.done():
            return
        if not r.started:
            if not r.future.set_running_or_notify_cancel():
                self.registry.counter("serve_requests_cancelled").inc()
                return
            r.started = True
        try:
            r.future.set_exception(exc)
        except InvalidStateError:
            return
        if counter:
            self.registry.counter(counter).inc()

    def _requeue_locked(self, q: _Queue, reqs: List[_Request]) -> None:
        """Put popped-but-undispatched requests back at the front of
        their queue, in order."""
        live = self._queues.get(q.key)
        if live is None:
            live = self._queues[q.key] = q
            q.requests = deque()
            q.pending_states = 0
        live.requests.extendleft(reversed(reqs))
        live.pending_states += sum(r.states for r in reqs)
        self._pending += len(reqs)

    def _recover_locked(self, exc: BaseException
                        ) -> List[Tuple[_Request, BaseException]]:
        """Crash recovery under the lock: requeue every held request that
        never reached dispatch, and return the dispatched ones for typed
        failure outside the lock (their launch outcome is unknown).
        Durable requests requeue even after dispatch: run_durable resumes
        from their checkpoint chain, so a retry cannot double-serve."""
        doomed: List[Tuple[_Request, BaseException]] = []
        for q, reqs in self._active:
            retry = []
            for r in reqs:
                if r.future.done():
                    continue
                if r.dispatched and r.kind != "durable":
                    doomed.append((r, exc))
                else:
                    r.dispatched = False
                    retry.append(r)
            if retry:
                self._requeue_locked(q, retry)
        doomed.extend(self._active_failed)
        self._active = []
        self._active_failed = []
        self._inflight = 0
        return doomed

    def _evacuate_locked(self) -> List[_Request]:
        """FAILED transition: take every queued request out so its
        future can be failed outside the lock."""
        doomed: List[_Request] = []
        for q in self._queues.values():
            doomed.extend(q.requests)
            q.requests.clear()
            q.pending_states = 0
        self._queues.clear()
        self._pending = 0
        return doomed

    # -- worker ------------------------------------------------------------

    def _worker_main(self, my_gen: int) -> None:
        """Supervised outer loop: `_run` returns only on a clean stop;
        anything escaping it is a crash, restarted with backoff until the
        budget is gone, then the engine turns FAILED. A superseded
        generation exits silently (the watchdog ran the recovery)."""
        while True:
            try:
                self._run(my_gen)
                return
            except BaseException as e:    # noqa: BLE001 - supervised
                with self._cond:
                    if my_gen != self._worker_gen:
                        return
                if not self._handle_worker_failure(e):
                    return
                with self._cond:
                    if my_gen != self._worker_gen:
                        return

    def _handle_worker_failure(self, e: BaseException) -> bool:
        """Crash bookkeeping shared by the supervisor loop and the
        watchdog: requeue or fail held work, and turn FAILED when the
        budget is gone. Returns True when the worker should keep running
        (after its backoff), False on FAILED."""
        delay = self._supervisor.next_backoff()
        with self._cond:
            doomed = self._recover_locked(e)
            evacuated = ([] if delay is not None
                         else self._evacuate_locked())
            if delay is None:
                self._failure_cause = e
                self._state = "failed"
        # futures complete outside the lock: a client callback must not
        # deadlock against submit
        for r, exc in doomed:
            self._fail_request(
                r, exc, counter=("serve_requests_expired"
                                 if isinstance(exc, DeadlineExceeded)
                                 else "serve_requests_failed"))
        if delay is None:
            fail = RejectedError(
                f"Invalid operation: ServeEngine FAILED — its worker "
                f"crashed {self._supervisor.total_restarts + 1} time(s) "
                f"and the restart budget is exhausted; last cause: {e!r}.")
            fail.__cause__ = e
            for r in evacuated:
                self._fail_request(r, fail)
        with self._cond:
            self._cond.notify_all()
        if delay is None:
            return False
        self.registry.counter("serve_worker_restarts").inc()
        if delay:
            time.sleep(delay)
        return True

    # -- dispatch watchdog ----------------------------------------------------

    def _watch_arm(self, q: _Queue) -> Optional[int]:
        """Register the coming dispatch with the watchdog (durable jobs
        are exempt: long by design, bounded by their own retries)."""
        if self.dispatch_timeout_s <= 0 or q.kind == "durable":
            return None
        with self._cond:
            self._watch_seq += 1
            token = self._watch_seq
            self._watch[token] = (
                time.monotonic() + self.dispatch_timeout_s,
                self._worker_gen, q)
            self._cond.notify_all()
        return token

    def _watch_disarm(self, token: Optional[int]) -> None:
        if token is not None:
            with self._cond:
                self._watch.pop(token, None)

    def _watchdog_main(self) -> None:
        """When an armed dispatch outlives its deadline the worker is
        wedged inside a launch. Supersede its generation, fail the batch
        typed DispatchTimeout through the crash recovery (durable
        requests requeue, dispatched ones fail), count a failure on the
        program's breaker, and spawn a replacement worker under the
        restart budget. The stuck launch itself is left to finish: a
        CUDA launch cannot be cancelled, and its results are dropped."""
        while True:
            with self._cond:
                if self._stop:
                    return
                now = time.monotonic()
                fire, due = None, None
                for token, (deadline, gen, q) in self._watch.items():
                    if gen != self._worker_gen:
                        continue      # armed by a superseded worker
                    if now >= deadline:
                        fire = (token, q)
                        break
                    t = deadline - now
                    due = t if due is None else min(due, t)
                if fire is None:
                    self._cond.wait(due if due is not None else 0.5)
                    continue
                token, q = fire
                del self._watch[token]
                self._worker_gen += 1
                new_gen = self._worker_gen
            e = DispatchTimeout(
                f"Invalid operation: serve launch exceeded the dispatch "
                f"watchdog deadline (QUEST_DISPATCH_TIMEOUT_S="
                f"{self.dispatch_timeout_s}); the worker was replaced and "
                f"the launch outcome is unknown.")
            self.registry.counter("serve_dispatch_timeouts").inc()
            # the owning worker is stuck in the launch and the
            # replacement is not spawned yet: the breaker has no other
            # user now
            br = self._breakers.get(q.key)
            if br is not None:
                br.record_failure()
            if self._handle_worker_failure(e):
                with self._cond:
                    if new_gen == self._worker_gen and not self._stop:
                        self._spawn_worker_locked()

    def _run(self, my_gen: int) -> None:
        while True:
            if _F.ACTIVE:
                self._fault("serve.worker_loop", phase="idle")
            with self._cond:
                while True:
                    if self._stop or my_gen != self._worker_gen:
                        return
                    batches, failed, cancelled = self._pop_ready_locked()
                    if batches or failed or cancelled:
                        self._inflight += len(batches)
                        self._active = list(batches)
                        self._active_failed = list(failed)
                        break
                    self._cond.wait(self._next_due_locked())
            if _F.ACTIVE and batches:
                self._fault("serve.worker_loop", phase="popped")
            for r, exc in failed:
                self.registry.counter("serve_requests_expired").inc()
                self._fail_request(r, exc, counter=None)
            if failed or cancelled:
                # wake drain() only once the failed futures are resolved
                with self._cond:
                    self._active_failed = []
                    self._cond.notify_all()
            for q, reqs in batches:
                # raises only for an exhausted durable resume loop (into
                # the supervised restart); every other failure is split,
                # isolated and typed inside
                token = self._watch_arm(q)
                try:
                    self._dispatch(q, reqs)
                finally:
                    self._watch_disarm(token)
                with self._cond:
                    if my_gen != self._worker_gen:
                        return        # superseded mid-dispatch
                    self._inflight -= 1
                    self._active.remove((q, reqs))
                    self._cond.notify_all()
            if batches:
                with self._cond:
                    if my_gen != self._worker_gen:
                        return
                # a processed pop cycle refills the restart budget
                self._supervisor.record_success()

    def _pop_ready_locked(self):
        """Sweep expiries and cancellations, then pop every queue that is
        due (oldest request older than max_wait, max_batch states
        pending, draining or closing, or max_wait == 0). Returns
        (batches, failed, cancelled)."""
        now = time.monotonic()
        batches, failed, cancelled = [], [], []
        for qkey in list(self._queues):
            q = self._queues[qkey]
            live, expired, cancd = AdmissionController.sweep(q.requests,
                                                             now)
            if expired or cancd:
                q.requests = deque(live)
                q.pending_states = sum(r.states for r in live)
            self._pending -= len(expired) + len(cancd)
            if cancd:
                self.registry.counter("serve_requests_cancelled").inc(
                    len(cancd))
            cancelled.extend(cancd)
            failed.extend((r, DeadlineExceeded(
                "Invalid operation: the request's deadline "
                f"({r.expiry - r.submit_t:.3f}s) elapsed before "
                "dispatch; it was failed without occupying a launch."))
                for r in expired)
            while q.requests:
                due = (self._drainers or self._closed
                       or self.max_wait_s == 0.0
                       or now - q.requests[0].submit_t >= self.max_wait_s
                       or q.pending_states >= self.max_batch)
                if not due:
                    break
                if self.max_wait_s == 0.0 and not (self._drainers
                                                   or self._closed):
                    # the no-coalescing mode: one request a launch
                    take = [q.requests.popleft()]
                    filled = take[0].states
                else:
                    take, filled = [], 0
                    while q.requests and (
                            not take
                            or filled + q.requests[0].states
                            <= self.max_batch):
                        r = q.requests.popleft()
                        take.append(r)
                        filled += r.states
                q.pending_states -= filled
                self._pending -= len(take)
                batches.append((q, take))
            if not q.requests:
                del self._queues[qkey]
        return batches, failed, cancelled

    def _next_due_locked(self) -> Optional[float]:
        """Seconds until the next queue is due or a deadline expires
        (None: sleep until notified)."""
        now = time.monotonic()
        due = None
        for q in self._queues.values():
            for r in q.requests:
                t = r.submit_t + self.max_wait_s - now
                if r.expiry is not None:
                    t = min(t, r.expiry - now)
                due = t if due is None else min(due, t)
        return None if due is None else max(due, 0.0)

    # -- dispatch ----------------------------------------------------------

    def _start(self, reqs: List[_Request]) -> List[_Request]:
        """Move futures to RUNNING, dropping late cancellations (requests
        that survived a restart are RUNNING already)."""
        started = []
        for r in reqs:
            if r.started:
                started.append(r)
            elif r.future.set_running_or_notify_cancel():
                r.started = True
                started.append(r)
            else:
                self.registry.counter("serve_requests_cancelled").inc()
        return started

    def _record_batch(self, reqs, occupancy: float, t_pop: float) -> None:
        self.registry.counter("serve_batches_dispatched").inc()
        self.registry.histogram("serve_batch_occupancy").observe(occupancy)
        qw = self.registry.histogram("serve_queue_wait_s")
        for r in reqs:
            qw.observe(t_pop - r.submit_t)

    def _finish_one(self, r: _Request, result) -> None:
        if r.future.done():
            return        # failed by the watchdog: the late result drops
        try:
            r.future.set_result(result)
        except InvalidStateError:
            return
        self._m_served.inc()
        self._m_e2e.observe(time.monotonic() - r.submit_t)

    def _dispatch(self, q: _Queue, reqs: List[_Request]) -> None:
        reqs = self._start(reqs)
        if not reqs:
            return
        if q.kind == "durable":
            self._dispatch_durable(q, reqs)
            return
        self._dispatch_split(q, reqs, depth=0)

    # in-place resume attempts per durable dispatch before the failure
    # escalates into a supervised restart; each attempt re-enters
    # run_durable, which resumes from the newest checkpoint
    DURABLE_RETRY_CAP = 3

    def _dispatch_durable(self, q: _Queue, reqs: List[_Request]) -> None:
        """Each durable request through run_durable. Typed job errors
        (DurableError, IntegrityError, CheckpointError, OSError,
        ValueError, TypeError) fail only that request: a retry would fail
        alike. Anything else (a preemption, a device fault) retries in
        place up to DURABLE_RETRY_CAP times — a retry is a resume — and
        then raises into the supervised restart, which requeues it."""
        from quest_tpu_torch.checkpoint import CheckpointError
        from quest_tpu_torch.parallel.mesh import ShardedAmps
        from quest_tpu_torch.resilience.durable import (DurableError,
                                                        IntegrityError,
                                                        run_durable)
        from quest_tpu_torch.state import Qureg

        t_pop = time.monotonic()
        for r in reqs:
            if r.future.done():
                continue
            r.dispatched = True
            attempts = 0
            while True:
                try:
                    if _F.ACTIVE:
                        self._fault("serve.dispatch", reqs=[r],
                                    durable=True)
                    reg = Qureg(amps=r.state.to(self.device),
                                num_qubits=q.circuit.num_qubits,
                                is_density=q.density)
                    out = run_durable(q.circuit, reg, r.durable_dir,
                                      every=r.durable_every,
                                      mesh=self.durable_mesh,
                                      elastic=self.durable_elastic,
                                      registry=self.registry)
                    self._record_batch([r], 1.0, t_pop)
                    self.registry.counter("serve_durable_jobs").inc()
                    amps = out.amps
                    if isinstance(amps, ShardedAmps):   # durable_mesh
                        amps = amps.gather("cpu")
                    self._finish_one(r, amps.reshape(2, -1).cpu())
                    break
                except BaseException as e:  # noqa: BLE001 - laddered
                    self.registry.counter("serve_launch_failures").inc()
                    if isinstance(e, (DurableError, IntegrityError,
                                      CheckpointError, OSError,
                                      ValueError, TypeError)):
                        self._fail_request(r, e)
                        break
                    attempts += 1
                    if attempts >= self.DURABLE_RETRY_CAP:
                        raise
                    self.registry.counter(
                        "serve_durable_inplace_resumes").inc()

    def _dispatch_split(self, q: _Queue, reqs: List[_Request],
                        depth: int) -> None:
        """Poisoned-batch isolation: a failing coalesced launch splits in
        two and retries the halves, so one bad request ends alone with
        its own error while its batch-mates get results. Split depth is
        capped at log2(max_batch)+1 levels and each request rides at most
        `_retry_cap` failed launches."""
        try:
            if q.kind == "apply":
                self._dispatch_apply(q, reqs)
            else:
                self._dispatch_traj(q, reqs)
            return
        except _BuildFailure as e:
            # the program, not a rider, is at fault: nothing to isolate
            self.registry.counter("serve_launch_failures").inc()
            for r in reqs:
                self._fail_request(r, e.cause)
            return
        except BaseException as e:        # noqa: BLE001 - isolated below
            self.registry.counter("serve_launch_failures").inc()
            err = e
        survivors = [r for r in reqs if not r.future.done()]
        if not survivors:
            return
        if len(survivors) == 1 or depth + 1 >= self._split_depth_cap:
            for r in survivors:
                self._fail_request(r, err)
            return
        retryable = []
        for r in survivors:
            r.retries += 1
            if r.retries >= self._retry_cap:
                self._fail_request(r, err)
            else:
                retryable.append(r)
        if not retryable:
            return
        self.registry.counter("serve_batches_split").inc()
        mid = (len(retryable) + 1) // 2
        self._dispatch_split(q, retryable[:mid], depth + 1)
        if retryable[mid:]:
            self._dispatch_split(q, retryable[mid:], depth + 1)

    # -- program resolution: breaker and degradation ladder ----------------

    def _degraded_rungs(self, primary: str) -> Tuple[str, ...]:
        """Ladder rungs below `primary`, in preference order."""
        try:
            i = self.ladder.index(primary)
        except ValueError:
            i = 0
        return self.ladder[i + 1:]

    def _apply_program(self, q: _Queue, rung: str):
        """One rung's batched apply program: run(batch) takes the
        host-stacked (B, 2, 2^n) planes and returns the output planes
        (on the engine's device, or on the host for the host rung)."""
        n = q.circuit.num_qubits * 2 if q.density else q.circuit.num_qubits
        if rung == "host":
            # the floor: the native C++ engine, one state at a time
            step = q.circuit.compiled_host(n, q.density)

            def run_host(batch):
                out = batch.to("cpu").contiguous()
                for i in range(out.shape[0]):
                    step(out[i])
                return out
            return run_host
        fn = q.circuit.compiled_batched(
            1, density=q.density, device=self.device,
            engine="banded" if rung == "banded" else None)

        def run(batch):
            return fn(batch.to(self.device))
        return run

    def _traj_program(self, q: _Queue, rung: str):
        from quest_tpu_torch import trajectories as T
        engine = q.engine if rung == "fused" else rung
        return T._compiled_traj(q.circuit, q.circuit.num_qubits,
                                self.device, engine)

    def _resolve_program(self, q: _Queue, compile_rung) -> tuple:
        """The program of this dispatch. A closed breaker: the primary
        engine; its build failure counts on the breaker and fails the
        dispatch. An open breaker: the half-open probe once the cooldown
        is over (a healthy probe closes it), else, or when the probe
        fails, the first rung below the primary that builds. A failure
        of the card or its toolchain fails the dispatch at any rung and
        counts on no breaker. Returns (fn, primary_used, breaker);
        raises _BuildFailure."""
        br = self._breaker_for(q)
        closed = br.state == CLOSED
        primary = (q.engine if q.kind == "traj" else None) or "fused"
        err: Optional[BaseException] = None
        if br.allow_primary():
            try:
                if _F.ACTIVE:
                    self._fault("serve.compile", program=q.key,
                                rung=primary)
                return compile_rung("fused"), True, br
            except BaseException as e:   # noqa: BLE001 - typed below
                if _card_fault(e):
                    raise _BuildFailure(e) from e
                br.record_failure()
                if closed:
                    raise _BuildFailure(e) from e
                err = e
        for rung in self._degraded_rungs(primary):
            try:
                if _F.ACTIVE:
                    self._fault("serve.compile", program=q.key, rung=rung)
                fn = compile_rung(rung)
            except BaseException as e:   # noqa: BLE001 - next rung
                if _card_fault(e):
                    raise _BuildFailure(e) from e
                err = err or e
                continue
            self.registry.counter("serve_degraded_dispatches").inc()
            return fn, False, br
        raise _BuildFailure(err if err is not None else RuntimeError(
            "no dispatchable engine rung"))

    def _dispatch_apply(self, q: _Queue, reqs: List[_Request]) -> None:
        t_pop = time.monotonic()
        # quest-lint: disable=QL005(racy generation read IS the supersession design)
        gen0 = self._worker_gen     # breaker-success guard (watchdog)
        n = q.circuit.num_qubits * 2 if q.density else q.circuit.num_qubits
        fn, primary, br = self._resolve_program(
            q, lambda rung: self._apply_program(q, rung))
        if _F.ACTIVE:
            self._fault("serve.device_put", reqs=reqs)
        # stacked once on the host; the program moves it to its device in
        # one copy and runs exactly len(reqs) states (no padding)
        batch = torch.stack([r.state.to("cpu") for r in reqs])
        for r in reqs:
            r.dispatched = True
        if _F.ACTIVE:
            self._fault("serve.dispatch", reqs=reqs)
        out_dev = fn(batch)
        if out_dev.device.type == "cuda":
            torch.cuda.synchronize(out_dev.device)
        # quest-lint: disable=QL005(racy generation read IS the supersession design)
        if primary and gen0 == self._worker_gen:
            # a launch that unsticks after the watchdog fired must not
            # erase the failure it recorded on this breaker
            br.record_success()
        # at most one device-to-host copy for every raw-planes request;
        # observable requests reduce on the device
        raw_needed = any(r.observable is None for r in reqs)
        out = out_dev.reshape(len(reqs), 2, 1 << n).cpu() if raw_needed \
            else None
        self._record_batch(reqs, len(reqs) / self.max_batch, t_pop)
        obs_vals: Dict[int, torch.Tensor] = {}
        for i, r in enumerate(reqs):
            # demux is per request: one request's bad observable fails
            # only its own future
            try:
                if _F.ACTIVE:
                    self._fault("serve.demux", req=r)
                if r.observable is not None:
                    vals = obs_vals.get(id(r.observable))
                    if vals is None:
                        vals = torch.as_tensor(r.observable(
                            out_dev.reshape(len(reqs), 2, 1 << n))).cpu()
                        obs_vals[id(r.observable)] = vals
                    self._finish_one(r, vals[i])
                else:
                    self._finish_one(r, out[i])
            except BaseException as e:   # noqa: BLE001 - per request
                self.registry.counter("serve_demux_failures").inc()
                self._fail_request(r, e)

    def _dispatch_traj(self, q: _Queue, reqs: List[_Request]) -> None:
        t_pop = time.monotonic()
        # quest-lint: disable=QL005(racy generation read IS the supersession design)
        gen0 = self._worker_gen
        total = sum(r.shots for r in reqs)
        # the requests' uniforms, drawn at submit, in request order
        uniforms = torch.cat([r.uniforms for r in reqs])
        bucket = traj_dispatch_bucket(total, self.max_batch)
        fn, primary, br = self._resolve_program(
            q, lambda rung: self._traj_program(q, rung))
        spans, lo = [], 0
        for r in reqs:
            spans.append((r, lo, lo + r.shots))
            lo += r.shots
        pieces = [([], []) for _ in reqs]   # (planes | values, draws)
        dead = set()                        # requests failed in demux
        launches = 0
        if _F.ACTIVE:
            self._fault("serve.device_put", reqs=reqs)
        for r in reqs:
            r.dispatched = True
        for clo in range(0, total, bucket):
            chi = min(clo + bucket, total)
            if _F.ACTIVE:
                self._fault("serve.dispatch", reqs=reqs, chunk=launches)
            planes, draws = fn(uniforms[clo:chi])
            draws_h = draws.cpu()
            overlaps, raw_needed = [], False
            for i, (r, rlo, rhi) in enumerate(spans):
                s0, s1 = max(rlo, clo) - clo, min(rhi, chi) - clo
                if s0 >= s1 or i in dead:
                    continue
                overlaps.append((i, r, s0, s1))
                raw_needed = raw_needed or r.observable is None
            # one device-to-host copy of the chunk for every raw-planes
            # request; observables reduce the chunk on the device
            planes_h = planes.cpu() if raw_needed else None
            obs_vals: Dict[int, torch.Tensor] = {}
            for i, r, s0, s1 in overlaps:
                try:
                    if _F.ACTIVE:
                        self._fault("serve.demux", req=r)
                    if r.observable is not None:
                        vals = obs_vals.get(id(r.observable))
                        if vals is None:
                            vals = torch.as_tensor(
                                r.observable(planes)).cpu()
                            obs_vals[id(r.observable)] = vals
                        seg = vals[s0:s1]
                    else:
                        seg = planes_h[s0:s1]
                    pieces[i][0].append(seg)
                    pieces[i][1].append(draws_h[s0:s1])
                except BaseException as e:  # noqa: BLE001 - per request
                    self.registry.counter("serve_demux_failures").inc()
                    dead.add(i)
                    self._fail_request(r, e)
            launches += 1
        # quest-lint: disable=QL005(racy generation read IS the supersession design)
        if primary and gen0 == self._worker_gen:
            br.record_success()
        self.registry.counter("serve_batches_dispatched").inc(launches - 1)
        self._record_batch(reqs, total / (launches * self.max_batch), t_pop)
        for i, ((r, _, _), (pp, dd)) in enumerate(zip(spans, pieces)):
            if i in dead:
                continue
            self._finish_one(r, (torch.cat(pp) if len(pp) > 1 else pp[0],
                                 torch.cat(dd) if len(dd) > 1 else dd[0]))
