"""Multi-replica serving: routing, failover, tenancy — the fleet layer.

A port of quest_tpu/serve/fleet.py. `ServeEngine` (serve/engine.py) is
one worker thread over one set of queues: supervised, breakered,
degradable, but one replica. A `ServeFleet` owns N replicas and makes
the resilience machinery compose across them:

    fleet = ServeFleet(replicas=2)             # knobs: QUEST_SERVE_*
    fut = fleet.submit(circuit, state=planes, tenant="alice", priority=1)
    out = fut.result()

A replica is a ServeEngine in this process (thread replicas) or, with
`process=True` / QUEST_FLEET_PROC=1, a serve.ipc.ReplicaProxy fronting a
worker process with its own interpreter and its own CUDA context on the
card. Both expose the same engine surface, so nothing below branches on
the backend. Replicas serve on the card unless `device="cpu"` is given.

Three contracts:

  * ROUTING WITH FAILOVER — a request routes to the replica that has its
    program key warm (an affinity map from `program_key()` to replica),
    and spills to the least-loaded replica when the affinity replica's
    backlog runs a full launch (max_batch) deeper. When a replica turns
    FAILED, its queued-but-undispatched requests, which the engine
    resolves with RejectedError, requeue onto survivors in arrival order
    (at most 2 x replicas hops each); requests whose launch had started
    fail typed (their outcome is unknown), except durable jobs, whose
    checkpoint-chain resume makes a re-dispatch serve once. No survivor:
    every future resolves typed, never a hang.
  * TENANT ADMISSION + PRIORITY SHED — per-tenant pending quotas
    (QUEST_SERVE_TENANT_QUOTA) bound one tenant's share. Fleet pressure
    is the queued fraction of the healthy replicas' capacity plus one
    max_batch of backlog per breaker not CLOSED. At or above
    QUEST_SERVE_SHED_THRESHOLD the lowest pending priority class sheds
    with a typed ShedError: an incoming request above the lowest queued
    class evicts a queued victim of that class (cancel while queued; a
    launch is never aborted), one at or below it sheds itself.
  * DURABLE LONG JOBS — `submit(..., durable_dir=)` runs the request
    through resilience.durable.run_durable at the replica; a crash or a
    preemption mid-job resumes from the checkpoint chain, in place, after
    a supervised restart, or on a failover replica, bit for bit.

A trajectory request's (shots, C) uniforms are drawn once, here, on the
client's thread (generator= or seed=, as ServeEngine.submit draws them),
and the drawn tensor rides the request to whichever replica serves it:
a requeue or a process replica's resubmit serves the same draws, and the
client's generator advances exactly as on one ServeEngine.

Fault sites fleet.route / fleet.failover / fleet.shed / fleet.requeue
(resilience.faults) sit on these paths behind the one ACTIVE flag.

Metrics (the fleet's registry, shared by every thread replica):
counters fleet_requests_routed, fleet_affinity_hits,
fleet_affinity_spills, fleet_failovers, fleet_requeued_requests,
fleet_durable_jobs, fleet_scale_ups, fleet_scale_downs, shed_requests,
shed_requests_p{N}, shed_evictions, tenant_quota_rejections; gauges
fleet_replicas, fleet_replicas_healthy, fleet_pressure,
tenant_pending_{tenant}.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as _wait
from typing import Callable, Dict, List, Optional, Tuple

import torch

from quest_tpu_torch.env import knob_value
from quest_tpu_torch.resilience import faults as _F
from quest_tpu_torch.resilience.breaker import CLOSED as _CLOSED
from quest_tpu_torch.serve import engine as SE
from quest_tpu_torch.serve import metrics as M
from quest_tpu_torch.serve.admission import (DeadlineExceeded, RejectedError,
                                             ShedError, TenantQuota,
                                             TenantQuotaExceeded)


class _Ticket:
    """One fleet request: the user-facing future plus everything needed
    to resubmit it to another replica on failover (the drawn uniforms of
    a trajectory request, never its generator)."""

    __slots__ = ("future", "circuit", "kind", "state", "shots", "uniforms",
                 "observable", "density", "durable_dir", "durable_every",
                 "tenant", "priority", "route_key", "expiry", "submit_t",
                 "replica", "inner", "requeues", "shed_cause", "seq")

    def __init__(self, circuit, kind, state, shots, uniforms, observable,
                 density, durable_dir, durable_every, tenant, priority,
                 route_key, expiry, seq):
        self.future: Future = Future()
        self.circuit = circuit
        self.kind = kind                  # 'apply' | 'traj' | 'durable'
        self.state = state
        self.shots = shots
        self.uniforms = uniforms          # (shots, C) f64, traj only
        self.observable = observable
        self.density = density
        self.durable_dir = durable_dir
        self.durable_every = durable_every
        self.tenant = tenant
        self.priority = priority
        self.route_key = route_key        # program key for affinity
        self.expiry = expiry              # absolute monotonic or None
        self.submit_t = time.monotonic()
        self.replica: int = -1            # index currently holding it
        self.inner: Optional[Future] = None
        self.requeues = 0                 # failover hops ridden
        self.shed_cause: Optional[BaseException] = None
        self.seq = seq                    # arrival order


class ServeFleet:
    """N supervised replicas behind one thread-safe submit(): program-key
    routing, fleet-level failover, tenant quotas, priority shedding and
    durable long jobs over ServeEngine threads or worker processes.

    Keywords override the QUEST_SERVE_* / QUEST_FLEET_PROC knobs for this
    fleet: `replicas`, `process`, `tenant_quota` (a parse_tenant_quota
    dict or a bare int), `shed_threshold`, `priorities`. `registry`
    defaults to the process-wide one and is shared with every thread
    replica, so one snapshot covers the fleet; process replicas keep
    their own and the fleet's scrape merges their heartbeat snapshots.
    `durable_mesh` may be one parallel.AmpMesh or a list of one per
    replica (thread replicas only). Every other keyword passes through
    to each replica (device, max_wait_ms, max_queue, max_batch,
    traj_engine, restart_max, backoff_base_s, breaker_threshold,
    breaker_cooldown_s, ladder, dispatch_timeout_s, durable_elastic; a
    process replica also takes heartbeat_s)."""

    # the fleet RLock (reentrant: shed-eviction callbacks re-enter it)
    _GUARDED_BY = {
        "_lock": ("_affinity", "_pending", "_tenant_pending", "_seq",
                  "_rr", "_failed_noted", "_closed", "_failure_cause",
                  "_retired", "_requeue_cap"),
    }

    def __init__(self, replicas: Optional[int] = None, *,
                 process: Optional[bool] = None,
                 tenant_quota=None,
                 shed_threshold: Optional[float] = None,
                 priorities: Optional[int] = None,
                 registry: Optional[M.Registry] = None,
                 **engine_kw):
        if replicas is None:
            replicas = knob_value("QUEST_SERVE_REPLICAS")
        if int(replicas) < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if process is None:
            process = knob_value("QUEST_FLEET_PROC")
        self.process = bool(process)
        if tenant_quota is None:
            tenant_quota = knob_value("QUEST_SERVE_TENANT_QUOTA")
        if isinstance(tenant_quota, int):
            tenant_quota = {"default": tenant_quota}
        if shed_threshold is None:
            shed_threshold = knob_value("QUEST_SERVE_SHED_THRESHOLD")
        if not (0.0 < float(shed_threshold) <= 1.0):
            raise ValueError(
                f"shed_threshold must be in (0, 1], got {shed_threshold}")
        if priorities is None:
            priorities = knob_value("QUEST_SERVE_PRIORITIES")
        if int(priorities) < 1:
            raise ValueError(f"priorities must be >= 1, got {priorities}")
        self.registry = registry if registry is not None else M.REGISTRY
        self.tenant_quota = TenantQuota(tenant_quota)
        self.shed_threshold = float(shed_threshold)
        self.priorities = int(priorities)
        meshes = engine_kw.pop("durable_mesh", None)
        if not isinstance(meshes, (list, tuple)):
            meshes = [meshes] * int(replicas)
        if len(meshes) != int(replicas):
            raise ValueError(
                f"durable_mesh list has {len(meshes)} entries for "
                f"{replicas} replicas")
        if self.process and any(m is not None for m in meshes):
            raise ValueError(
                "process replicas build their own mesh in their own "
                "process; durable_mesh= is a thread-replica option")
        if isinstance(engine_kw.get("device"), torch.device):
            engine_kw["device"] = str(engine_kw["device"])
        self._engine_kw = dict(engine_kw)
        # REENTRANT: a shed eviction cancels the victim's inner future
        # under this lock, and Future.cancel() runs the victim's
        # completion callback on the cancelling thread, which re-enters
        # the lock to drop the victim from the ledger
        self._lock = threading.RLock()
        self._engines: list = self._make_replicas(meshes)
        # replicas retired by a scale-down: closed, but kept in _engines
        # as tombstones so ticket indices never dangle
        self._retired: set = set()
        # a request may hop at most once past every replica and once
        # more before it fails typed: failover can never loop
        self._requeue_cap = 2 * len(self._engines)
        # insertion-ordered and bounded: beyond the cap the stalest pin
        # falls out (its next request re-routes least-loaded)
        self._affinity: "OrderedDict[tuple, int]" = OrderedDict()
        self._affinity_cap = 4096
        # insertion-ordered pending-ticket ledger (shed victim scan,
        # tenant pending counts, drain)
        self._pending: "OrderedDict[int, _Ticket]" = OrderedDict()
        self._tenant_pending: Dict[str, int] = {}
        self._seq = 0
        self._rr = 0                      # round-robin tiebreak cursor
        self._failed_noted: set = set()   # replica deaths already tallied
        self._closed = False
        self._failure_cause: Optional[BaseException] = None
        self.registry.gauge("fleet_replicas").set(len(self._engines))
        self.registry.gauge("fleet_replicas_healthy").set(
            len(self._engines))
        self._m_routed = self.registry.counter("fleet_requests_routed")
        self._m_aff = self.registry.counter("fleet_affinity_hits")
        self._m_spill = self.registry.counter("fleet_affinity_spills")
        self._m_pressure = self.registry.gauge("fleet_pressure")

    def _make_replicas(self, meshes) -> list:
        """The initial replicas. Worker processes boot side by side (a
        boot is an interpreter start, a CUDA context and library loads);
        if any boot fails, the others close and its error raises."""
        if not self.process:
            return [self._make_replica(i, durable_mesh=m)
                    for i, m in enumerate(meshes)]
        with ThreadPoolExecutor(len(meshes)) as pool:
            futs = [pool.submit(self._make_replica, i)
                    for i in range(len(meshes))]
            _wait(futs)
        engines = [f.result() for f in futs if f.exception() is None]
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            for eng in engines:
                eng.close(timeout_s=5.0)
            raise errors[0]
        return engines

    def _make_replica(self, idx: int, durable_mesh=None):
        """Replica `idx`: a ServeEngine in this process, or a ReplicaProxy
        fronting a worker process (process=True)."""
        if self.process:
            from quest_tpu_torch.serve.ipc import ReplicaProxy
            return ReplicaProxy(registry=self.registry, name=f"r{idx}",
                                **self._engine_kw)
        return SE.ServeEngine(registry=self.registry, name=f"r{idx}",
                              durable_mesh=durable_mesh, **self._engine_kw)

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        """'running' while any replica serves | 'failed' (every replica
        exhausted its restart budget) | 'closed'."""
        # quest-lint: disable=QL005(observability fast path: racy flag read, engine.state contract)
        if self._closed:
            return "closed"
        if any(e.state == "running" for e in self._engines):
            return "running"
        return "failed"

    # the attributes serve.warmup reads off an engine: warming one
    # replica warms every thread replica (compiled programs cache on the
    # Circuit instance)
    @property
    def max_batch(self) -> int:
        return self._engines[0].max_batch

    @property
    def traj_engine(self):
        return self._engines[0].traj_engine

    @property
    def device(self) -> torch.device:
        return self._engines[0].device

    @property
    def replicas(self) -> int:
        """Live (non-retired) replica count: what the autoscaler grows
        and shrinks."""
        with self._lock:
            return len(self._engines) - len(self._retired)

    def plan(self, circuit, *, batch: Optional[int] = None,
             density: bool = False, dtype=None):
        """ServeEngine.plan for the fleet: one priced plan covers every
        replica (plans are content-addressed per circuit and mode)."""
        return self._engines[0].plan(circuit, batch=batch,
                                     density=density, dtype=dtype)

    def stats(self) -> dict:
        """Pressure, backend, the plan-cache counters and per-replica
        health (state, queued depth, restarts left, retired)."""
        from quest_tpu_torch import plan as P
        with self._lock:
            pressure = self._pressure_locked()
            retired = set(self._retired)
        return {
            "pressure": pressure,
            "process": self.process,
            "plan_cache": P.cache_stats(),
            "replicas": [
                {"name": e.name, "state": e.state, "pending": e._pending,
                 "restarts_remaining": e._supervisor.remaining,
                 "retired": i in retired}
                for i, e in enumerate(self._engines)],
        }

    # -- submit ------------------------------------------------------------

    def submit(self, circuit, state=None, shots: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None,
               deadline_s: Optional[float] = None,
               observable: Optional[Callable] = None,
               density: bool = False,
               durable_dir: Optional[str] = None,
               durable_every: Optional[int] = None,
               tenant: Optional[str] = None,
               priority: int = 0) -> Future:
        """ServeEngine.submit's semantics plus the fleet layer: `tenant`
        names the submitting tenant for quota accounting (None = the
        shared 'anon' bucket), `priority` its class in
        [0, QUEST_SERVE_PRIORITIES). A trajectory request's uniforms are
        drawn here from `generator` / `seed`. Raises TenantQuotaExceeded
        over quota, ShedError when this request sheds, RejectedError when
        the fleet is closed or FAILED or every replica refuses it."""
        if not (0 <= int(priority) < self.priorities):
            raise ValueError(
                f"priority must be in [0, {self.priorities}) "
                f"(QUEST_SERVE_PRIORITIES), got {priority}")
        SE.check_request(state, shots, observable=observable,
                         density=density, durable_dir=durable_dir,
                         durable_every=durable_every)
        uniforms = SE.draw_request_uniforms(circuit, shots, generator, seed)
        tenant = "anon" if tenant is None else str(tenant)
        kind, route_key = self._route_key(circuit, state, density,
                                          durable_dir)
        now = time.monotonic()
        expiry = None if deadline_s is None else now + float(deadline_s)
        with self._lock:
            if self._closed:
                self.registry.counter("serve_requests_rejected").inc()
                raise RejectedError(
                    "Invalid operation: fleet closed — submit() after "
                    "ServeFleet.close(); create a new fleet.")
            healthy = self._healthy_locked()
            if not healthy:
                self.registry.counter("serve_requests_rejected").inc()
                raise RejectedError(
                    f"Invalid operation: ServeFleet is FAILED — every "
                    f"replica exhausted its restart budget; last cause: "
                    f"{self._failure_cause!r}.") from self._failure_cause
            try:
                self.tenant_quota.admit(
                    tenant, self._tenant_pending.get(tenant, 0))
            except TenantQuotaExceeded:
                self.registry.counter("tenant_quota_rejections").inc()
                raise
            pressure = self._pressure_locked()
            self._m_pressure.set(pressure)
            evict = None
            if pressure >= self.shed_threshold:
                evict = self._shed_locked(pressure, int(priority))
            ticket = _Ticket(circuit, kind, state, shots, uniforms,
                             observable, density, durable_dir,
                             durable_every, tenant, int(priority),
                             route_key, expiry, self._seq)
            self._seq += 1
            idx = self._pick_replica_locked(route_key, healthy)
            ticket.replica = idx
            self._pending[id(ticket)] = ticket
            n_tenant = self._tenant_pending.get(tenant, 0) + 1
            self._tenant_pending[tenant] = n_tenant
            self.registry.gauge(f"tenant_pending_{tenant}").set(n_tenant)
        if _F.ACTIVE:
            try:
                _F.check("fleet.route", program=route_key, replica=idx,
                         tenant=tenant, priority=int(priority))
            except BaseException:
                self.registry.counter("serve_faults_injected").inc()
                with self._lock:
                    self._forget_locked(ticket)
                raise
        try:
            self._submit_to(ticket, idx)
        except BaseException:
            with self._lock:
                self._forget_locked(ticket)
            raise
        self._m_routed.inc()
        if kind == "durable":
            self.registry.counter("fleet_durable_jobs").inc()
        if evict is not None:
            # tallied after the admit, so the victim's shed never masks a
            # failed submit of the evictor
            self.registry.counter("shed_evictions").inc()
        # cancel-while-queued propagates to the replica: attached last,
        # so no cancel can race the submit path above
        ticket.future.add_done_callback(
            lambda f, t=ticket: self._on_outer_done(t, f))
        return ticket.future

    def _on_outer_done(self, ticket: _Ticket, f: Future) -> None:
        """Outer-future completion hook; only a cancellation needs work:
        cancel the queued inner request (a dispatched launch is never
        aborted, its result is dropped) and release the ledger slot."""
        if not f.cancelled():
            return
        inner = ticket.inner
        if inner is not None and inner.cancel():
            self._engines[ticket.replica].reap_cancelled()
        with self._lock:
            self._forget_locked(ticket)

    def _route_key(self, circuit, state, density,
                   durable_dir) -> Tuple[str, tuple]:
        """(kind, program key) for affinity routing: the program
        identities the engines queue by (Circuit.program_key,
        trajectories.program_key)."""
        if state is not None:
            dtype = str(torch.as_tensor(state).dtype).replace("torch.", "")
            base = circuit.program_key(density=density, dtype=dtype)
            if durable_dir is not None:
                return "durable", base + ("durable",)
            return "apply", base
        from quest_tpu_torch import trajectories as T
        _, qkey = T.program_key(circuit, engine=self.traj_engine)
        return "traj", qkey

    # -- routing -----------------------------------------------------------

    def _healthy_locked(self) -> List[int]:
        return [i for i, e in enumerate(self._engines)
                if e.state == "running" and i not in self._retired]

    def _pick_replica_locked(self, route_key: tuple,
                             healthy: List[int]) -> int:
        """Affinity if warm and not overloaded, else least-loaded.
        Overload: the affinity replica's queued depth runs at least one
        max_batch deeper than the least-loaded healthy replica; the
        request spills, and the pin stays."""
        depth = {i: self._engines[i]._pending for i in healthy}
        aff = self._affinity.get(route_key)
        least = min(healthy, key=lambda i: (depth[i], i))
        if aff is not None and aff in depth:
            self._affinity.move_to_end(route_key)
            if depth[aff] - depth[least] < self._engines[aff].max_batch:
                self._m_aff.inc()
                return aff
            self._m_spill.inc()
            return least
        # a new program family: least-loaded, round-robin on ties so
        # families spread across the fleet
        min_depth = depth[least]
        ties = [i for i in healthy if depth[i] == min_depth]
        idx = ties[self._rr % len(ties)]
        self._rr += 1
        self._affinity[route_key] = idx
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)
        return idx

    def _submit_to(self, ticket: _Ticket, idx: int) -> None:
        """Hand `ticket` to replica `idx`, trying the other healthy
        replicas on a synchronous RejectedError (a full queue, or a
        replica that failed between the pick and the submit). Raises only
        when every healthy replica refused."""
        with self._lock:
            retired = set(self._retired)
        order = [idx] + [i for i in range(len(self._engines)) if i != idx]
        last: Optional[BaseException] = None
        for i in order:
            if i in retired:
                continue
            eng = self._engines[i]
            if eng.state != "running":
                continue
            remaining = (None if ticket.expiry is None
                         else ticket.expiry - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded(
                    "Invalid operation: the request's deadline elapsed "
                    "before it could be routed to a replica.")
            try:
                inner = eng._submit(
                    ticket.circuit, state=ticket.state, shots=ticket.shots,
                    uniforms=ticket.uniforms, deadline_s=remaining,
                    observable=ticket.observable, density=ticket.density,
                    durable_dir=ticket.durable_dir,
                    durable_every=ticket.durable_every)
            except RejectedError as e:
                last = e
                continue
            ticket.replica = i
            ticket.inner = inner
            inner.add_done_callback(
                lambda fut, t=ticket: self._on_inner_done(t, fut))
            return
        with self._lock:
            self._forget_locked(ticket)
        raise last if last is not None else RejectedError(
            "Invalid operation: no replica accepted the request.")

    # -- completion + failover ---------------------------------------------

    def _forget_locked(self, ticket: _Ticket) -> None:
        if self._pending.pop(id(ticket), None) is not None:
            n = self._tenant_pending.get(ticket.tenant, 1) - 1
            if n:
                self._tenant_pending[ticket.tenant] = n
            else:
                self._tenant_pending.pop(ticket.tenant, None)
            self.registry.gauge(f"tenant_pending_{ticket.tenant}").set(n)

    def _resolve(self, ticket: _Ticket, result=None,
                 exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._forget_locked(ticket)
        f = ticket.future
        if f.done() or not f.set_running_or_notify_cancel():
            return
        if exc is not None:
            f.set_exception(exc)
        else:
            f.set_result(result)

    def _on_inner_done(self, ticket: _Ticket, fut: Future) -> None:
        """Runs on the owning replica's thread (or the evicting
        submitter's, for a cancel): move the inner result or error to the
        user's future, or REQUEUE onto a survivor when the replica died
        with the request still safe to re-serve."""
        if ticket.future.cancelled():
            # the caller walked away: never fail over abandoned work
            with self._lock:
                self._forget_locked(ticket)
            return
        if fut.cancelled():
            # an inner-only cancel is the shed eviction (queued only)
            exc = ticket.shed_cause or ShedError(
                "Invalid operation: the request was load-shed while "
                "queued.")
            self._resolve(ticket, exc=exc)
            return
        exc = fut.exception()
        if exc is None:
            self._resolve(ticket, result=fut.result())
            return
        replica_failed = self._engines[ticket.replica].state == "failed"
        # requeue-safe: a FAILED replica resolves its never-launched
        # requests (and its durable jobs, whose retry is a resume) with
        # RejectedError; anything else that died with it had an unknown
        # launch outcome and fails typed
        requeueable = (replica_failed
                       and isinstance(exc, RejectedError)
                       and not isinstance(exc, DeadlineExceeded))
        if not requeueable:
            self._resolve(ticket, exc=exc)
            return
        with self._lock:
            self._note_failed_locked(ticket.replica)
            healthy = self._healthy_locked()
            ticket.requeues += 1
            if not healthy:
                # only a true no-survivors state defines the fleet's
                # failure cause
                self._failure_cause = exc
            if not healthy or ticket.requeues > self._requeue_cap:
                healthy = []
            else:
                target = self._pick_replica_locked(ticket.route_key,
                                                   healthy)
        if not healthy:
            self._resolve(ticket, exc=RejectedError(
                f"Invalid operation: request lost its replica and no "
                f"survivor could take it (hops: {ticket.requeues}); "
                f"last cause: {exc!r}."))
            return
        if _F.ACTIVE:
            try:
                _F.check("fleet.failover", replica=ticket.replica,
                         target=target)
                # the requeue hop proper (fleet.failover is the decision
                # point): fires as the ticket is re-submitted
                _F.check("fleet.requeue", replica=ticket.replica,
                         target=target, hops=ticket.requeues,
                         durable=ticket.kind == "durable")
            except BaseException as e:  # noqa: BLE001 - typed resolve
                self.registry.counter("serve_faults_injected").inc()
                self._resolve(ticket, exc=e)
                return
        self.registry.counter("fleet_requeued_requests").inc()
        try:
            self._submit_to(ticket, target)
        except BaseException as e:      # noqa: BLE001 - typed resolve
            self._resolve(ticket, exc=e)

    def _note_failed_locked(self, idx: int) -> None:
        """A replica went FAILED: tally the failover once, drop its
        affinity pins and refresh the health gauge."""
        if idx not in self._failed_noted:
            self._failed_noted.add(idx)
            self.registry.counter("fleet_failovers").inc()
        for k in [k for k, v in self._affinity.items() if v == idx]:
            del self._affinity[k]
        self.registry.gauge("fleet_replicas_healthy").set(
            len(self._healthy_locked()))

    # -- elasticity (serve/autoscaler.py drives these) ----------------------

    def _set_replica_gauges_locked(self) -> None:
        self.registry.gauge("fleet_replicas").set(
            len(self._engines) - len(self._retired))
        self.registry.gauge("fleet_replicas_healthy").set(
            len(self._healthy_locked()))

    def add_replica(self) -> int:
        """Grow the fleet by one replica of its backend; returns its
        index. The spawn runs outside the fleet lock (a process boot
        takes seconds and submits keep flowing)."""
        with self._lock:
            if self._closed:
                raise RejectedError(
                    "Invalid operation: add_replica() after "
                    "ServeFleet.close().")
            idx = len(self._engines)
        eng = self._make_replica(idx)
        with self._lock:
            closed_race = self._closed
            if not closed_race:
                self._engines.append(eng)
                self._requeue_cap = 2 * len(self._engines)
                self._set_replica_gauges_locked()
        if closed_race:
            eng.close(timeout_s=5.0)
            raise RejectedError(
                "Invalid operation: fleet closed while the new replica "
                "was booting.")
        self.registry.counter("fleet_scale_ups").inc()
        return len(self._engines) - 1

    def remove_replica(self, timeout_s: Optional[float] = 30.0) -> int:
        """Shrink the fleet by one replica: the least-loaded running one
        retires (no new routing; its queued requests drain, never shed),
        then closes. Returns its index. A drain that outlives `timeout_s`
        rolls the retirement back and raises TimeoutError: a scale-down
        never loses accepted work. Refuses to remove the last live
        replica."""
        with self._lock:
            if self._closed:
                raise RejectedError(
                    "Invalid operation: remove_replica() after "
                    "ServeFleet.close().")
            healthy = self._healthy_locked()
            if len(healthy) <= 1:
                raise ValueError(
                    "cannot retire the last live replica — scale-down "
                    "floors at 1 (QUEST_FLEET_MIN_REPLICAS governs the "
                    "autoscaler's own floor)")
            # least-loaded retires (cheapest drain); the newest breaks
            # ties so long-lived warm replicas keep their pins
            idx = min(healthy,
                      key=lambda i: (self._engines[i]._pending, -i))
            self._retired.add(idx)
            for k in [k for k, v in self._affinity.items() if v == idx]:
                del self._affinity[k]
            self._set_replica_gauges_locked()
        eng = self._engines[idx]
        try:
            eng.drain(timeout_s=timeout_s)
        except RejectedError:
            pass        # already failed or closed: nothing to drain
        except TimeoutError:
            with self._lock:
                self._retired.discard(idx)
                self._set_replica_gauges_locked()
            raise TimeoutError(
                f"scale-down of replica {idx} aborted: its drain did not "
                f"complete within timeout_s={timeout_s}; the retirement "
                f"rolled back so no accepted request is lost") from None
        eng.close(timeout_s=timeout_s)
        self.registry.counter("fleet_scale_downs").inc()
        return idx

    def scrape(self) -> str:
        """One Prometheus exposition for the whole fleet: the shared
        registry's for thread replicas; for process replicas the fleet
        registry merged with every worker's last heartbeat snapshot
        (counters and gauges sum, histogram quantiles take the worst
        replica)."""
        if not self.process:
            return self.registry.scrape()
        snaps = [self.registry.snapshot()]
        snaps += [e.snapshot() for e in self._engines]
        return M.render_snapshot(M.merge_snapshots(snaps))

    # -- pressure + shedding -----------------------------------------------

    def _pressure_locked(self) -> float:
        """Queued depth over the healthy replicas' bounded capacity, plus
        one max_batch of backlog per breaker not CLOSED, counted from
        this fleet's replicas only."""
        healthy = self._healthy_locked()
        if not healthy:
            return 1.0
        capacity = sum(self._engines[i]._admission.max_queue
                       for i in healthy)
        queued = sum(self._engines[i]._pending for i in healthy)
        open_breakers = sum(
            1 for i in healthy
            for br in list(self._engines[i]._breakers.values())
            if br.state != _CLOSED)
        max_batch = max(self._engines[i].max_batch for i in healthy)
        return (queued + open_breakers * max_batch) / max(capacity, 1)

    def _shed_locked(self, pressure: float,
                     priority: int) -> Optional[_Ticket]:
        """The shed decision under pressure: evict the lowest-priority
        queued ticket below `priority` that can still be cancelled and
        return it, or, when the incoming request is itself in the lowest
        pending class, raise ShedError for it. Every shed lands on the
        lowest pending class until it is exhausted."""
        cause = (f"fleet pressure {pressure:.3f} >= "
                 f"QUEST_SERVE_SHED_THRESHOLD={self.shed_threshold} "
                 f"(queued depth + open-breaker backlog over healthy "
                 f"capacity)")
        below = [t for t in self._pending.values() if t.priority < priority]
        if _F.ACTIVE:
            try:
                _F.check("fleet.shed", pressure=pressure,
                         priority=priority, evict=bool(below))
            except BaseException:
                self.registry.counter("serve_faults_injected").inc()
                raise
        if below:
            # a cancel succeeds only while the victim is still queued at
            # its replica; a dispatched one is walked past. The typed
            # cause is set per candidate, so the one that sheds is named.
            for t in sorted(below, key=lambda t: (t.priority, t.seq)):
                t.shed_cause = ShedError(
                    f"Invalid operation: request (priority "
                    f"{t.priority}, tenant {t.tenant!r}) was load-shed "
                    f"for a priority-{priority} request: {cause}.")
                if t.inner is not None and t.inner.cancel():
                    # free the victim's queue slot now: at the hard queue
                    # bound the evicting submit would otherwise still see
                    # a full queue and be rejected
                    self._engines[t.replica].reap_cancelled()
                    self.registry.counter("shed_requests").inc()
                    self.registry.counter(
                        f"shed_requests_p{t.priority}").inc()
                    return t
                t.shed_cause = None
            # nothing evictable (all dispatched): the incoming request is
            # admitted; launches are never aborted
            return None
        self.registry.counter("shed_requests").inc()
        self.registry.counter(f"shed_requests_p{priority}").inc()
        raise ShedError(
            f"Invalid operation: request (priority {priority}) was "
            f"load-shed — it sits in the lowest pending priority class "
            f"and {cause}.")

    # -- drain / close -----------------------------------------------------

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Flush every queued request on every replica and block until
        each fleet future has resolved, requests that fail over mid-drain
        included. TimeoutError when `timeout_s` elapses first; on a FAILED
        fleet it returns once every future has resolved typed."""
        with self._lock:
            closed = self._closed
        if closed:
            raise RejectedError(
                "Invalid operation: fleet closed — drain() after "
                "ServeFleet.close().")
        self._drain(None if timeout_s is None
                    else time.monotonic() + timeout_s)

    def _drain(self, deadline: Optional[float]) -> None:
        while True:
            with self._lock:
                inners = [t.inner for t in self._pending.values()
                          if t.inner is not None]
                if not self._pending:
                    return
            for eng in list(self._engines):
                if eng.state != "running":
                    continue
                step = (0.25 if deadline is None
                        else max(0.0, min(0.25,
                                          deadline - time.monotonic())))
                try:
                    eng.drain(timeout_s=step)
                except (TimeoutError, RejectedError):
                    pass
            # wait briefly on the inner futures (the outer ones resolve
            # from their callbacks): no busy spin while a requeued request
            # rides a survivor's queue
            if inners:
                _wait(inners, timeout=0.05)
            else:
                time.sleep(0.05)
            with self._lock:
                remaining = len(self._pending)
            if not remaining:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ServeFleet.drain() timed out with {remaining} "
                    f"request(s) unresolved")

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Drain, then close every replica. Idempotent. `timeout_s` is one
        budget shared by the drain and every replica's close."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            try:
                self._drain(deadline)
            except TimeoutError:
                pass
        for eng in list(self._engines):
            step = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            eng.close(timeout_s=step)

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
