"""Deterministic fault injection at named sites.

The port's own copy of quest_tpu/resilience/faults.py (standard library
only, so it carries no dependency on the JAX package). A registry of
named FAULT SITES threaded through the hot path — the sharded dispatch
(parallel/sharded.py apply_circuit_sharded), the checkpoint commit and
read (checkpoint.py), each cut of the durable executor
(resilience/durable.py) — and a `FaultPlan` that makes a chosen site
raise a chosen error DETERMINISTICALLY, so every recovery path (the
durable resume chain, the corrupt-checkpoint skip) is provable end to
end in tests and soak runs instead of waiting for real hardware to
misbehave. The serving sites (serve.*, fleet.*, ipc.*) stay in the
catalog; they fire once the serving runtime that calls them is ported
(ROADMAP A12).

Zero-cost when empty: every call site is guarded by the ONE module flag
`ACTIVE` (`if faults.ACTIVE: faults.check(site)`), so an uninstrumented
process pays a single attribute read per site; the checks live strictly
on the host side of every launch.

Usage — tests install a plan directly:

    plan = FaultPlan()
    plan.inject("durable.preempt", after_n=2, times=1)
    with faults.active(plan):
        ...

Soak runs set the `QUEST_FAULT_PLAN` knob (grammar below);
`install_from_env()` parses and installs it process-wide.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Callable, Dict, List, Optional

# the ONE hot-path guard: call sites read `faults.ACTIVE` before calling
# check(). False whenever no plan (or an empty plan) is installed.
ACTIVE = False

# the fault-site catalog (the reference's). inject() validates
# against it so a typo'd site fails loudly at plan-build time instead of
# silently never firing.
SITES = (
    "serve.worker_loop",    # ServeEngine worker iteration (phase=idle
                            # before the pop, phase=popped with batches
                            # in hand but none dispatched)
    "serve.compile",        # primary-engine program compile/resolution
                            # (the port checks it at every ladder rung
                            # it builds; ctx: program, rung)
    "serve.device_put",     # host->device staging of a coalesced batch
    "serve.dispatch",       # the batched launch itself (ctx carries the
                            # batch's requests — match= emulates one
                            # poisoned rider failing its whole launch)
    "serve.demux",          # per-request result demux (ctx carries the
                            # single request)
    "sharded.dispatch",     # apply_circuit_sharded's mesh dispatch
    "checkpoint.save",      # checkpoint commit point (temp files
                            # written, rename pending) — an injected
                            # error emulates a crash MID-SAVE; the
                            # previous checkpoint must stay loadable
    "checkpoint.load",      # checkpoint read path (load/load_arrays) —
                            # emulates IO failures; the durable resume
                            # chain must skip to an older checkpoint
    "checkpoint.load_gang", # gang/elastic reassembly read path
                            # (checkpoint.load_step_gang — every
                            # multi-host resume and every elastic
                            # re-entry of a gang chain): chaos plans
                            # can fail the reassembly on one host; the
                            # gang scanner must skip to an older
                            # committed step on EVERY host (validity is
                            # a pure function of the shared dir)
    "durable.step",         # durable executor, before each sweep-plan
                            # step (ctx carries the step index)
    "durable.preempt",      # the durable KILL site: same cut points as
                            # durable.step, reserved for preemption
                            # plans so soaks can kill a run at seeded
                            # boundaries without disturbing step-fault
                            # rules
    "fleet.route",          # ServeFleet routing decision (ctx carries
                            # program key, chosen replica, tenant,
                            # priority) — an armed error surfaces in
                            # the submitter, so soaks can fail routing
                            # deterministically
    "fleet.failover",       # fleet-level failover requeue of a dead
                            # replica's request onto a survivor (ctx:
                            # replica, target) — an armed error fails
                            # that request's future typed
    "fleet.shed",           # the shed decision point: fires when
                            # pressure crosses the threshold and a
                            # victim is about to shed (ctx: pressure,
                            # priority, evict) — soaks can force the
                            # decision path deterministically
    "fleet.requeue",        # failover REQUEUE hop: fires as a dead
                            # replica's ticket is re-submitted to its
                            # chosen survivor (ctx: replica, target,
                            # hops, durable) — distinct from
                            # fleet.failover (the decision point), so
                            # chaos plans can fail the hop itself, e.g.
                            # mid-durable-failover
    "fleet.spawn",          # process-replica spawn (serve.ipc — both
                            # the initial boot and every supervised
                            # respawn; ctx: replica, respawn) — an
                            # armed error emulates exec/fork failure so
                            # soaks can prove spawn loss burns the
                            # process supervisor budget and fails over
    "ipc.send",             # one framed message leaving the proxy for
                            # its worker process (ctx: replica, type) —
                            # an armed error emulates a broken pipe
                            # mid-submit; the proxy must fail the
                            # request typed, never strand its future
    "ipc.recv",             # one framed message arriving from the
                            # worker process (ctx: replica, type) — an
                            # armed error emulates a torn/poisoned
                            # frame; the proxy treats it as worker loss
                            # (kill + respawn under budget)
)


class InjectedFault(RuntimeError):
    """Default error an armed fault site raises (a stand-in for the real
    failure class: Mosaic compile error, device OOM, transfer fault)."""


class _Rule:
    """One armed site: deterministic hit counting, bounded firing."""

    __slots__ = ("site", "error", "after_n", "every_n", "times", "p",
                 "match", "hits", "fired", "_rng")

    def __init__(self, site: str, error, after_n: int, every_n,
                 times, p, match, seed: int):
        self.site = site
        self.error = error
        self.after_n = int(after_n)
        self.every_n = None if every_n is None else int(every_n)
        self.times = None if times is None else int(times)
        self.p = None if p is None else float(p)
        self.match = match
        self.hits = 0
        self.fired = 0
        # per-rule PRNG seeded by (site, seed): a probabilistic rule
        # fires the same hit sequence on every run of the same plan
        self._rng = random.Random(f"{site}:{seed}")

    def consider(self, ctx: dict) -> None:
        if self.match is not None and not self.match(ctx):
            return
        self.hits += 1
        if self.hits <= self.after_n:
            return
        if self.times is not None and self.fired >= self.times:
            return
        if (self.every_n is not None
                and (self.hits - self.after_n) % self.every_n != 0):
            return
        if self.p is not None and self._rng.random() >= self.p:
            return
        self.fired += 1
        err = self.error
        if isinstance(err, type):
            err = err(f"injected fault at {self.site!r} "
                      f"(hit {self.hits}, fire {self.fired})")
        raise err


class FaultPlan:
    """A deterministic set of armed fault sites.

    `inject(site, ...)` arms one site; every keyword is optional:

      error    exception INSTANCE or CLASS to raise (default
               InjectedFault — classes get a descriptive message built
               per fire, instances raise as-is)
      after_n  skip the first N hits of the site (default 0)
      every_n  then fire every Nth remaining hit (default: every hit)
      times    cap total fires (default: unlimited)
      p        fire with probability p per eligible hit, from a PRNG
               seeded by (site, seed) — deterministic per plan replay
      match    callable(ctx) -> bool; the hit only COUNTS when the
               site's context matches (e.g. lambda ctx: bad_future in
               [r.future for r in ctx["reqs"]] — emulates a poisoned
               request that fails any launch containing it)
      seed     PRNG seed for `p` (default 0)

    Thread-safe: hit counters mutate under one lock (client threads hit
    sharded.dispatch while a worker hits the others)."""

    _GUARDED_BY = {"_lock": ("_rules",)}

    def __init__(self):
        self._rules: Dict[str, List[_Rule]] = {}
        self._lock = threading.Lock()

    def inject(self, site: str, error=InjectedFault, after_n: int = 0,
               every_n: Optional[int] = None, times: Optional[int] = None,
               p: Optional[float] = None,
               match: Optional[Callable[[dict], bool]] = None,
               seed: int = 0) -> "FaultPlan":
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; the catalog is "
                f"{sorted(SITES)}")
        if after_n < 0:
            raise ValueError(f"after_n must be >= 0, got {after_n}")
        if every_n is not None and every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {p}")
        with self._lock:
            self._rules.setdefault(site, []).append(
                _Rule(site, error, after_n, every_n, times, p, match, seed))
        return self

    @property
    def empty(self) -> bool:
        # quest-lint: disable=QL005(truthiness of a dict is one atomic read)
        return not self._rules

    def fired(self, site: Optional[str] = None) -> int:
        """Total fires (or one site's) — test/soak introspection."""
        with self._lock:
            rules = (self._rules.get(site, ()) if site is not None
                     else [r for rs in self._rules.values() for r in rs])
            return sum(r.fired for r in rules)

    def check(self, site: str, ctx: dict) -> None:
        # quest-lint: disable=QL005(lock-free fast path: dict.get is atomic, plans arm before workers start)
        rules = self._rules.get(site)
        if not rules:
            return
        with self._lock:
            for rule in rules:
                rule.consider(ctx)


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_INSTALLED = False


def install(plan: Optional[FaultPlan]) -> None:
    """Install `plan` process-wide (None clears). `ACTIVE` flips with
    it, so an empty/absent plan keeps every call site on the one-flag
    fast path."""
    global _PLAN, ACTIVE
    _PLAN = plan
    ACTIVE = bool(plan is not None and not plan.empty)


def clear() -> None:
    install(None)


def current() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped install: the previous plan is restored on exit (tests)."""
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def check(site: str, **ctx) -> None:
    """Raise if the installed plan arms `site` for this hit. Call sites
    guard with `if faults.ACTIVE:` so the empty case never gets here."""
    plan = _PLAN
    if plan is not None:
        plan.check(site, ctx)


# ---------------------------------------------------------------------------
# QUEST_FAULT_PLAN: the soak-run knob
# ---------------------------------------------------------------------------
#
# Grammar (validated loudly — env.knob_value raises ValueError on any
# malformed spec):
#
#     QUEST_FAULT_PLAN="site[:key=value]...[;site[:key=value]...]..."
#
# e.g. "serve.dispatch:error=RuntimeError:after=10:every=25;
#       serve.worker_loop:p=0.01:seed=7:times=2"
#
# keys: error (builtin exception name or 'fault' = InjectedFault),
# after, every, times, p, seed — the inject() parameters; match= is
# API-only (it takes a callable).


def parse_plan(spec: str) -> FaultPlan:
    """Parse a QUEST_FAULT_PLAN spec string into a FaultPlan (the knob's
    registered parser; raises ValueError on malformed input)."""
    plan = FaultPlan()
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site, kw = fields[0].strip(), {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(
                    f"QUEST_FAULT_PLAN field {f!r} is not key=value "
                    f"(in {part!r})")
            k, v = (s.strip() for s in f.split("=", 1))
            if k == "error":
                if v == "fault":
                    kw["error"] = InjectedFault
                else:
                    import builtins
                    err = getattr(builtins, v, None)
                    if not (isinstance(err, type)
                            and issubclass(err, Exception)):
                        raise ValueError(
                            f"QUEST_FAULT_PLAN error={v!r} is not a "
                            f"builtin exception name (or 'fault')")
                    kw["error"] = err
            elif k in ("after", "after_n"):
                kw["after_n"] = _parse_int(k, v, lo=0)
            elif k in ("every", "every_n"):
                kw["every_n"] = _parse_int(k, v, lo=1)
            elif k == "times":
                kw["times"] = _parse_int(k, v, lo=1)
            elif k == "seed":
                kw["seed"] = _parse_int(k, v)
            elif k == "p":
                try:
                    kw["p"] = float(v)
                except ValueError:
                    raise ValueError(
                        f"QUEST_FAULT_PLAN p={v!r} is not a float")
            else:
                raise ValueError(
                    f"unknown QUEST_FAULT_PLAN key {k!r} (in {part!r}); "
                    f"keys: error, after, every, times, p, seed")
        plan.inject(site, **kw)
    return plan


def _parse_int(key: str, raw: str, lo: Optional[int] = None) -> int:
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"QUEST_FAULT_PLAN {key}={raw!r} is not an int")
    if lo is not None and v < lo:
        raise ValueError(f"QUEST_FAULT_PLAN {key} must be >= {lo}, got {v}")
    return v


def install_from_env() -> None:
    """Install the QUEST_FAULT_PLAN knob's plan once per process (no-op
    when the knob is unset or a plan was already installed explicitly).
    The durable executor calls this on entry, so soak runs arm the sites
    by exporting the knob — no code change."""
    global _ENV_INSTALLED
    if _ENV_INSTALLED or _PLAN is not None:
        return
    _ENV_INSTALLED = True
    from quest_tpu_torch.env import knob_value
    plan = knob_value("QUEST_FAULT_PLAN")
    if plan is not None:
        install(plan)
