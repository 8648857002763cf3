"""Runtime audits of the port: builds under a rerun, knob-flip cache
misses, and the lock acquisition order.

The static rules (analysis/lint.py) prove every knob a program builder
reads is registered as keyed; this module proves at run time that the
registration works (ref quest_tpu/analysis/audit.py):

  * CompileAuditor — counts what the port builds while it is active:
    programs (misses of Circuit._cached, which every engine's program
    and the trajectory programs go through, and of the lru-cached
    Pauli-sum and Trotter builders) and kernel libraries (nvcc builds
    and loads, ops/_build.py). The golden check runs a circuit set
    twice and asserts the second pass builds nothing.
  * audit_knob_flips — for every keyed knob of the registry, warms the
    per-gate, banded and fused programs of one circuit, asserts a
    same-value rerun builds nothing, then flips the knob (its registered
    `flips`) and asserts every program cache misses. A hit means the
    knob is missing from engine_mode_key(): the stale-program bug.
  * LockOrderAuditor — wraps locks, records which is taken under which,
    and fails on a cycle (a latent ABBA deadlock).

The reference's audit_eager_worker has no counterpart: the port's eager
gates (ops/gates.py) keep no program cache of their own, so there is no
eager cache for a knob flip to miss.

Programs run on the card unless the caller passes device="cpu" (the
plain versions: nothing is compiled there).
"""

from __future__ import annotations

import contextlib
import importlib
import os
from typing import Dict, List, Optional, Sequence

# the lru-cached builders besides Circuit._cached: (module, function)
_LRU_BUILDERS = (("quest_tpu_torch.ops.expec", "_plan_cached"),
                 ("quest_tpu_torch.ops.expec", "_batched_reducer_cached"),
                 ("quest_tpu_torch.evolution", "_plan_trotter"),
                 ("quest_tpu_torch.evolution", "_trotter_circuit_cached"))

AUDIT_QUBITS = 10        # the fused engine's smallest register


class StaleCacheError(AssertionError):
    """A program cache returned a stale program, or built anew when it
    should not have, during an audit."""


def _counts() -> tuple:
    """(program builds, kernel builds, kernel libraries loaded) so far
    in this process."""
    from quest_tpu_torch import circuit
    from quest_tpu_torch.ops import _build
    lru = sum(getattr(importlib.import_module(mod), name).cache_info().misses
              for mod, name in _LRU_BUILDERS)
    return circuit.PROGRAM_BUILDS + lru, _build.BUILDS, len(_build._LIBS)


class CompileAuditor:
    """Counts what the port builds while active: `builds` (programs),
    `kernel_builds` (nvcc runs) and `kernel_loads` (libraries opened);
    `traces` is their sum, the reference's name for "anything built".
    The counts are process-wide deltas between enter and exit (live
    while active), so auditors nest and re-enter freely."""

    def __init__(self):
        self._start = self._end = None

    def __enter__(self) -> "CompileAuditor":
        self._start, self._end = _counts(), None
        return self

    def __exit__(self, *exc) -> None:
        self._end = _counts()

    def _delta(self, i: int) -> int:
        if self._start is None:
            return 0
        end = self._end if self._end is not None else _counts()
        return end[i] - self._start[i]

    @property
    def builds(self) -> int:
        return self._delta(0)

    @property
    def kernel_builds(self) -> int:
        return self._delta(1)

    @property
    def kernel_loads(self) -> int:
        return self._delta(2)

    @property
    def traces(self) -> int:
        return self.builds + self.kernel_builds + self.kernel_loads

    def assert_no_retrace(self, what: str = "golden circuit set") -> None:
        if self.traces:
            raise StaleCacheError(
                f"{self.builds} program build(s), {self.kernel_builds} "
                f"kernel build(s) and {self.kernel_loads} library load(s) "
                f"while re-running the {what}: some program cache key is "
                f"unstable (every rerun pays a silent rebuild)")


# ---------------------------------------------------------------------------
# golden circuit set
# ---------------------------------------------------------------------------


def golden_circuits(n: int = AUDIT_QUBITS):
    """Small circuits over the per-gate, banded and fused engines (ref
    audit.py:101, widened to the fused engine's smallest register)."""
    from quest_tpu_torch.circuit import Circuit
    c1 = Circuit(n).h(0).cnot(0, 1).rz(2, 0.25).cz(1, 2).rx(0, 0.5)
    c1.ry(n - 1, 0.3).cnot(n - 1, 7)
    c2 = Circuit(n)
    for q in range(n):
        c2.h(q)
    c2.cnot(0, 2).t(1).cphase(0.7, 3, n - 2)
    return [c1, c2]


def _base_state(n: int, device):
    import torch
    amps = torch.zeros((2, 1 << n), dtype=torch.float32, device=device)
    amps[0, 0] = 1.0
    return amps


def run_golden(circuits, device=None) -> None:
    """One pass of a golden set through the per-gate, banded and fused
    programs on `device` (default: the card). Pass the SAME circuit
    objects across passes: the programs are cached on them."""
    from quest_tpu_torch.env import resolve_device
    dev = resolve_device(device)
    for c in circuits:
        _run_engines(c, dev)


def _engines(c, dev) -> Dict[str, object]:
    n = c.num_qubits
    return {"pergate": lambda: c.compiled(n, device=dev),
            "banded": lambda: c.compiled_banded(n, device=dev),
            "fused": lambda: c.compiled_fused(n, device=dev)}


def _run_engines(c, dev) -> None:
    for get in _engines(c, dev).values():
        get()(_base_state(c.num_qubits, dev))


def golden_retrace_check(circuits=None, device=None) -> CompileAuditor:
    """The golden audit: warm every engine on the set, re-run the same
    pass under a CompileAuditor and assert it built nothing. Returns the
    (exited) auditor."""
    from quest_tpu_torch.env import resolve_device
    dev = resolve_device(device)
    circuits = golden_circuits() if circuits is None else circuits
    run_golden(circuits, dev)
    with CompileAuditor() as aud:
        run_golden(circuits, dev)
    aud.assert_no_retrace()
    return aud


# ---------------------------------------------------------------------------
# knob flipping
# ---------------------------------------------------------------------------


def _apply_flip(name: str, raw: str) -> None:
    """Flip a knob as its docs say to flip it mid-process: the matmul
    tier through its setter (set_matmul_precision beats the variable
    once called), every other knob through the environment."""
    if name == "QUEST_MATMUL_PRECISION":
        from quest_tpu_torch import precision
        precision.set_matmul_precision(raw)
    else:
        os.environ[name] = raw


@contextlib.contextmanager
def _knob_guard(name: str):
    """Restore the variable and any setter-backed value afterwards."""
    from quest_tpu_torch import precision
    saved_env = os.environ.get(name)
    saved_tier = precision._tier_override \
        if name == "QUEST_MATMUL_PRECISION" else None
    try:
        yield
    finally:
        if saved_env is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved_env
        if name == "QUEST_MATMUL_PRECISION":
            precision.set_matmul_precision(saved_tier)


def audit_knob_flips(names: Optional[Sequence[str]] = None, device=None,
                     circuit=None) -> List[Dict]:
    """For each keyed knob (or each of `names`): under its first flip
    value, warm the per-gate, banded and fused programs of `circuit`
    (default: a 10-qubit circuit the fused engine takes) on `device`
    (default: the card) and assert a same-value rerun builds nothing;
    then set its second flip value and assert each engine's program
    cache misses. Raises StaleCacheError naming the knob on the first
    violation; returns one record per knob: its flips, and per engine
    the programs the flip built and the fused program's driver and
    tier."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.env import KNOBS, resolve_device
    dev = resolve_device(device)
    targets = [KNOBS[n] for n in names] if names else [
        k for k in KNOBS.values() if k.scope == "keyed"]
    n = AUDIT_QUBITS
    report: List[Dict] = []
    for knob in targets:
        if not knob.flips:
            raise ValueError(f"{knob.name} has no registered flip values")
        c = circuit if circuit is not None else \
            Circuit(n).h(0).cnot(0, 1).rz(2, 0.25).rx(n - 1, 0.5)
        m = c.num_qubits
        with _knob_guard(knob.name):
            _apply_flip(knob.name, knob.flips[0])
            _run_engines(c, dev)
            with CompileAuditor() as stable:
                _run_engines(c, dev)
            stable.assert_no_retrace(
                f"programs with {knob.name}={knob.flips[0]}")
            _apply_flip(knob.name, knob.flips[1])
            built = {}
            for engine, get in _engines(c, dev).items():
                with CompileAuditor() as flipped:
                    prog = get()
                    prog(_base_state(m, dev))
                built[engine] = flipped.builds
                if not flipped.builds:
                    raise StaleCacheError(
                        f"flipping {knob.name} {knob.flips[0]!r} -> "
                        f"{knob.flips[1]!r} did NOT miss the {engine} "
                        f"program cache: the knob is missing from "
                        f"engine_mode_key() and the engine returned a "
                        f"STALE program")
            report.append({"knob": knob.name, "flips": knob.flips,
                           "builds": built,
                           "fused_driver": getattr(prog, "driver", None),
                           "fused_tier": getattr(prog, "tier", None)})
    return report


# ---------------------------------------------------------------------------
# lock-order auditing (the dynamic half of QL005/QL007)
# ---------------------------------------------------------------------------


class LockOrderError(AssertionError):
    """Two audited locks were acquired in opposite orders by different
    threads: a latent ABBA deadlock the static rules cannot see."""


class _AuditedLock:
    """Transparent proxy over a Lock/RLock/Condition that reports every
    acquire/release to its LockOrderAuditor. Forwards everything else
    (`wait`/`notify` on a wrapped Condition still work: during `wait`
    the blocked thread acquires nothing, so the held-stack stays
    truthful for ordering purposes)."""

    def __init__(self, auditor: "LockOrderAuditor", name: str, inner):
        self._auditor = auditor
        self._name = name
        self._inner = inner

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._auditor._note_acquire(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._auditor._note_release(self._name)

    def __enter__(self) -> "_AuditedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class LockOrderAuditor:
    """Records the acquisition-order graph of every wrapped lock and
    fails on a cycle (ref quest_tpu/analysis/audit.py:303-436).

        auditor = LockOrderAuditor()
        engine._cond = auditor.wrap("engine", engine._cond)
        fleet._lock = auditor.wrap("fleet", fleet._lock)
        ... run the workload ...
        auditor.assert_acyclic()

    Every `acquire` of lock B while a thread already holds lock A adds
    the directed edge A -> B; a cycle in that graph means two threads
    can acquire the same pair in opposite orders — the ABBA deadlock.
    Same-name re-entry (ServeFleet's RLock) is counted, not edged: a
    reentrant self-acquire cannot deadlock. Thread-safe; the held-stack
    is thread-local."""

    _GUARDED_BY = {"_mu": ("edges", "reentries", "acquisitions")}

    def __init__(self):
        import threading
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.edges: Dict[str, set] = {}           # A -> {B acquired under A}
        self.reentries: Dict[str, int] = {}       # name -> self-reacquires
        self.acquisitions: Dict[str, int] = {}    # name -> total acquires

    def wrap(self, name: str, inner) -> _AuditedLock:
        with self._mu:
            self.edges.setdefault(name, set())
        return _AuditedLock(self, name, inner)

    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquire(self, name: str) -> None:
        stack = self._held()
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            if name in stack:
                self.reentries[name] = self.reentries.get(name, 0) + 1
            else:
                for held in set(stack):
                    self.edges.setdefault(held, set()).add(name)
        stack.append(name)

    def _note_release(self, name: str) -> None:
        stack = self._held()
        # release orders can interleave (Condition.wait releases out of
        # band); drop the innermost matching entry
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def find_cycle(self) -> Optional[List[str]]:
        """A lock-name cycle ['a', 'b', 'a'] if one exists, else None."""
        with self._mu:
            edges = {k: sorted(v) for k, v in self.edges.items()}
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in edges}
        path: List[str] = []

        def visit(n: str) -> Optional[List[str]]:
            color[n] = GREY
            path.append(n)
            for nxt in edges.get(n, ()):
                c = color.get(nxt, WHITE)
                if c == GREY:
                    return path[path.index(nxt):] + [nxt]
                if c == WHITE:
                    got = visit(nxt)
                    if got:
                        return got
            color[n] = BLACK
            path.pop()
            return None

        for n in sorted(edges):
            if color.get(n, WHITE) == WHITE:
                got = visit(n)
                if got:
                    return got
        return None

    def assert_acyclic(self) -> None:
        cycle = self.find_cycle()
        if cycle:
            raise LockOrderError(
                f"lock acquisition-order cycle {' -> '.join(cycle)}: "
                f"two threads can take these locks in opposite orders "
                f"and deadlock; impose one global order")
