"""QUEST_* knob registry, device selection and the QuESTEnv of one card.

A copy of the registry pattern in quest_tpu/env.py (`KNOBS` /
`knob_value`), holding only the knobs the port reads. Each knob parses
loudly: a malformed value raises ValueError instead of falling back.
The engines read the knobs when they plan (Circuit.compiled_fused,
compiled_banded, compiled_batched, apply, trajectories.run_batched), so a flip takes effect on
the next such call; a compiled program keeps what it read (its matmul
tier, its segment driver and slot count).

A knob of scope "keyed" changes what a compiled program does, so every
program cache key carries its effective value: `engine_mode_key()`
(ref quest_tpu/env.py:718-727) is the tuple of them, derived from the
registry. The matmul tier enters through precision.matmul_precision(),
so a set_matmul_precision override counts as the knob does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered QUEST_* environment knob (ref quest_tpu/env.py:57).

    scope: "keyed" — read when a program is built; its effective value is
    part of engine_mode_key(), so every program cache misses when it
    flips; "import_once" — resolved once per process, never re-read;
    "runtime" — read outside any program build (host tooling, serving,
    the capacity models), so it can never return a stale program.
    quest-lint (analysis/lint.py) checks the scopes statically and
    analysis/audit.py checks the keyed contract at run time."""
    name: str
    parse: Callable[[str], Any]     # raw string -> value; ValueError if bad
    default: Any
    doc: str
    scope: str                      # "keyed" | "import_once" | "runtime"
    layer: str                      # apply|planner|host|kernel|infra|bench|
                                    # serve
    malformed: Optional[str] = None     # a raw value parse() must reject
                                        # (None: every string parses)
    flips: Optional[Tuple[str, str]] = None  # two raw values with distinct
                                             # effective values (flip audit)
    current: Callable[[], Any] = None   # effective value beyond the env


def _bool01(name: str) -> Callable[[str], bool]:
    def parse(raw: str) -> bool:
        if raw not in ("0", "1"):
            raise ValueError(f"{name} must be '0' or '1', got {raw!r}")
        return raw == "1"
    return parse


def _int_range(name: str, lo: int, hi: int = None) -> Callable[[str], int]:
    def parse(raw: str) -> int:
        try:
            v = int(raw)
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {raw!r}") from None
        if v < lo or (hi is not None and v > hi):
            raise ValueError(f"{name} must be in "
                             f"[{lo}, {'inf' if hi is None else hi}], "
                             f"got {v}")
        return v
    return parse


def _parse_pos_float(name: str) -> Callable[[str], float]:
    def parse(raw: str) -> float:
        try:
            v = float(raw)
        except ValueError:
            raise ValueError(f"{name} must be a float, got {raw!r}")
        if not (v > 0.0):
            raise ValueError(f"{name} must be > 0, got {v}")
        return v
    return parse


def _parse_fault_plan(raw: str):
    # the resilience package is standard-library only at import time, so
    # this import cannot cycle back into env.py's module load
    from quest_tpu_torch.resilience import faults
    return faults.parse_plan(raw)


def _parse_nonneg_float(name: str) -> Callable[[str], float]:
    def parse(raw: str) -> float:
        try:
            v = float(raw)
        except ValueError:
            raise ValueError(f"{name} must be a float, got {raw!r}")
        if not (v >= 0.0):
            raise ValueError(f"{name} must be >= 0, got {v}")
        return v
    return parse


def _parse_tenant_quota(raw: str):
    # serve.admission is standard-library only at import time
    from quest_tpu_torch.serve.admission import parse_tenant_quota
    return parse_tenant_quota(raw)


def _parse_shed_threshold(raw: str) -> float:
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"QUEST_SERVE_SHED_THRESHOLD must be a float, got {raw!r}")
    if not (0.0 < v <= 1.0):
        raise ValueError(
            f"QUEST_SERVE_SHED_THRESHOLD must be in (0, 1] (a fraction of "
            f"queue capacity; 1.0 sheds only at the hard bound), got {v}")
    return v


# admission.DEFAULT_TENANT_QUOTA, the quota of every tenant unnamed
_DEFAULT_TENANT_QUOTA = {"default": 256}


def _choice(name: str, choices) -> Callable[[str], str]:
    def parse(raw: str) -> str:
        if raw not in choices:
            raise ValueError(f"{name} must be one of {list(choices)}, "
                             f"got {raw!r}")
        return raw
    return parse


def _parse_exchange_slices(raw: str) -> int:
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"QUEST_EXCHANGE_SLICES must be an integer, got {raw!r}")
    if v < 1 or v > 1024 or (v & (v - 1)):
        raise ValueError(
            f"QUEST_EXCHANGE_SLICES must be a power of two in [1, 1024] "
            f"(exchange blocks are power-of-two sized, so any other "
            f"slice count cannot divide them), got {v}")
    return v


def _parse_comm_topology(raw: str):
    """QUEST_COMM_TOPOLOGY grammar (ref quest_tpu/env.py:155): '0' (flat)
    or 'hosts=H[,ici=X][,dci=Y]' — devices grouped into H hosts
    (contiguous), intra-host links weighted X (default 1) and cross-host
    links Y (default 4). Returns 0 or a (hosts, ici, dci) tuple;
    parallel.comm.topology() turns it into the Topology the planner
    prices with."""
    if raw == "0":
        return 0
    hosts, ici, dci = None, 1.0, 4.0
    for part in raw.split(","):
        if "=" not in part:
            raise ValueError(
                f"QUEST_COMM_TOPOLOGY must be '0' or "
                f"'hosts=H[,ici=X][,dci=Y]', got {raw!r}")
        key, val = part.split("=", 1)
        key = key.strip()
        try:
            if key == "hosts":
                hosts = int(val)
            elif key in ("ici", "dci"):
                v = float(val)
                if not (v > 0):
                    raise ValueError
                if key == "ici":
                    ici = v
                else:
                    dci = v
            else:
                raise KeyError(key)
        except KeyError:
            raise ValueError(
                f"unknown QUEST_COMM_TOPOLOGY key {key!r} in {raw!r} "
                f"(known: hosts, ici, dci)")
        except ValueError:
            raise ValueError(
                f"QUEST_COMM_TOPOLOGY {key}= must be a positive "
                f"{'integer' if key == 'hosts' else 'number'}, "
                f"got {val!r}")
    if hosts is None:
        raise ValueError(
            f"QUEST_COMM_TOPOLOGY must name hosts= (got {raw!r})")
    if hosts < 1 or hosts & (hosts - 1):
        raise ValueError(
            f"QUEST_COMM_TOPOLOGY hosts must be a power of two >= 1 "
            f"(device counts are powers of two, so any other host count "
            f"cannot group them evenly), got {hosts}")
    return (hosts, ici, dci)


def _parse_dci_slices(raw: str) -> int:
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"QUEST_EXCHANGE_SLICES_DCI must be an integer, got {raw!r}")
    if v < 0 or v > 1024 or (v and v & (v - 1)):
        raise ValueError(
            f"QUEST_EXCHANGE_SLICES_DCI must be 0 (follow "
            f"QUEST_EXCHANGE_SLICES) or a power of two in [1, 1024], "
            f"got {v}")
    return v


def _current_matmul_precision() -> str:
    from quest_tpu_torch import precision
    return precision.matmul_precision()


def _parse_matmul_precision(raw: str) -> str:
    tiers = ("default", "high", "highest")
    if raw.lower() not in tiers:
        raise ValueError(
            f"matmul precision must be one of {sorted(tiers)} "
            f"(via QUEST_MATMUL_PRECISION), got {raw!r}")
    return raw.lower()


_KNOB_LIST = (
    Knob("QUEST_MATMUL_PRECISION", _parse_matmul_precision, "highest",
         doc="precision tier for state-amplitude contractions: default "
             "(one bf16 product), high (three bf16 products of hi/lo "
             "splits) or highest (IEEE fp32); read when a program is "
             "compiled (default: highest)",
         current=_current_matmul_precision,
         scope="keyed", layer="apply", malformed="ultra",
         flips=("highest", "high")),
    Knob("QUEST_APPLY_AUTOROUTE", _bool01("QUEST_APPLY_AUTOROUTE"), True,
         doc="Circuit.apply runs circuits of more than "
             "PERGATE_COMPILE_WARN_OPS ops through the banded engine: "
             "1/0 (default: 1; 0 keeps the per-gate engine)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    Knob("QUEST_SCHEDULE", _bool01("QUEST_SCHEDULE"), True,
         doc="commutation-aware gate scheduler in front of the fusing "
             "engine's planner: 1/0 (default: 1)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    Knob("QUEST_FUSED_SCAN", _bool01("QUEST_FUSED_SCAN"), False,
         doc="scan over repeated-structure kernel segments (the "
             "reference's lax.scan over runs of >= 3 swept segments of one "
             "structure): 1/0 (default: 0); the port builds the same "
             "launches either way (circuit.py)",
         scope="keyed", layer="planner", malformed="on", flips=("0", "1")),
    Knob("QUEST_SWEEP_FUSION", _bool01("QUEST_SWEEP_FUSION"), True,
         doc="sweep fusion: merge consecutive geometry-compatible kernel "
             "segments into one launch: 1/0 (default: 1)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    # the sharded engines' comm planner (ref quest_tpu/env.py:362-394)
    Knob("QUEST_COMM_PLAN", _bool01("QUEST_COMM_PLAN"), True,
         doc="communication planner for the sharded engines: pick the "
             "cheapest of plain/coalesced-reshard/relabel-events/lazy per "
             "circuit by predicted comm_stats bytes: 1/0 (default: 1; 0 "
             "restores the fixed legacy policies)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    # The next three keep the comm records equal to the reference's. On
    # the single-process mesh they change only the planner's records and
    # the number of copies an exchange makes: a sliced exchange has no
    # compute to overlap, and one process is one host (ROADMAP A10c).
    Knob("QUEST_EXCHANGE_SLICES", _parse_exchange_slices, 1,
         doc="copies each sharded pair exchange splits into (default: 1; "
             "power of two)",
         scope="keyed", layer="planner", malformed="3", flips=("1", "4")),
    Knob("QUEST_EXCHANGE_SLICES_DCI", _parse_dci_slices, 0,
         doc="copies for pair exchanges that cross the host boundary of "
             "the QUEST_COMM_TOPOLOGY model; 0 (default) follows "
             "QUEST_EXCHANGE_SLICES (power of two)",
         scope="keyed", layer="planner", malformed="3", flips=("0", "4")),
    Knob("QUEST_COMM_TOPOLOGY", _parse_comm_topology, None,
         doc="hierarchical interconnect model for the comm planner: "
             "'hosts=H[,ici=X][,dci=Y]' groups the mesh into H hosts with "
             "per-link cost weights (defaults ici=1, dci=4); 0 forces the "
             "flat single-tier model; unset: the mesh's distinct hosts "
             "(one process: one host, the flat model)",
         scope="keyed", layer="planner", malformed="hosts=three",
         flips=("0", "hosts=2")),
    # the segment drivers (ref quest_tpu/env.py:431-457); read when a
    # program is compiled and kept in each of its segments. The reference
    # resolves QUEST_FUSED_DRIVER and QUEST_FUSED_NBUF once per process
    # (import_once: its Pallas block geometry is fixed at first compile);
    # the port reads both at every program build, so they are keyed here,
    # with flips that pick another driver (K3) and another slot count
    Knob("QUEST_FUSED_DRIVER",
         _choice("QUEST_FUSED_DRIVER", ("pipelined", "grid")), "pipelined",
         doc="segment driver: pipelined (persistent blocks, bulk async "
             "copies through shared-memory plane slots; default) or grid "
             "(one block per tile)",
         scope="keyed", layer="kernel", malformed="turbo",
         flips=("pipelined", "grid")),
    Knob("QUEST_FUSED_PIPELINE", _bool01("QUEST_FUSED_PIPELINE"), True,
         doc="under the pipelined driver: 1 (default) refills a plane slot "
             "as soon as its store has read it (the decoupled ring, K1); 0 "
             "only once the store has landed, NBUF slots (the in-place "
             "driver, K2)",
         scope="keyed", layer="kernel", malformed="2", flips=("1", "0")),
    Knob("QUEST_FUSED_NBUF", _int_range("QUEST_FUSED_NBUF", 2, 8), 3,
         doc="plane slots of the in-place driver (QUEST_FUSED_PIPELINE=0): "
             "2..8, clamped to what a block's shared memory holds and to "
             "the launch's steps (default: 3)",
         scope="keyed", layer="kernel", malformed="9", flips=("3", "2")),
    # the Hamiltonian layers (ref quest_tpu/env.py:313, :341-359, :467)
    Knob("QUEST_EXPEC_FUSION", _bool01("QUEST_EXPEC_FUSION"), True,
         doc="grouped Pauli-sum expectation engine (ops/expec.py): 1/0 "
             "(default: 1; 0 evaluates term by term)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    Knob("QUEST_EXPEC_MAX_MASKS",
         _int_range("QUEST_EXPEC_MAX_MASKS", 1, 1 << 30), 64,
         doc="off-diagonal flip-mask groups that share one expectation "
             "sweep (default: 64)",
         scope="keyed", layer="planner", malformed="0", flips=("64", "1")),
    Knob("QUEST_TROTTER_FUSION", _bool01("QUEST_TROTTER_FUSION"), True,
         doc="pooled Trotter emission and fused-engine dispatch "
             "(evolution.py): 1/0 (default: 1; 0 emits term by term and "
             "runs the eager per-term workers)",
         scope="keyed", layer="planner", malformed="2", flips=("1", "0")),
    Knob("QUEST_ADJOINT", _choice("QUEST_ADJOINT", ("auto", "0", "1")),
         "auto",
         doc="gradient engine of adjoint.value_and_grad: auto (priced by "
             "the capacity model), 0 = taped autograd, 1 = the adjoint "
             "walk (default: auto)",
         scope="keyed", layer="planner", malformed="2", flips=("auto", "1")),
    # the front ends (ref quest_tpu/env.py:321-329, :411-420)
    Knob("QUEST_TRANSPILE", _choice("QUEST_TRANSPILE", ("auto", "0", "1")),
         "auto",
         doc="circuit transpiler (transpile.py): auto (the planner prices "
             "raw vs transpiled per circuit, incumbent-wins-ties), 0 = "
             "never rewrite, 1 = prefer the transpiled stream whenever it "
             "changed (default: auto)",
         scope="keyed", layer="planner", malformed="2", flips=("auto", "0")),
    Knob("QUEST_PLAN_CACHE", _bool01("QUEST_PLAN_CACHE"), True,
         doc="persistent content-addressed plan cache for plan.autotune: "
             "1/0 (default: 1; 0 prices every autotune call fresh)",
         scope="runtime", layer="infra"),
    Knob("QUEST_PLAN_CACHE_DIR", str, None,
         doc="plan-cache directory for plan.autotune (default: "
             "build/quest_tpu_torch_plans under the repo)",
         scope="runtime", layer="infra"),
    Knob("QUEST_HBM_BYTES", _int_range("QUEST_HBM_BYTES", 1, 1 << 62), None,
         doc="device memory in bytes for the capacity models (default: "
             "the card's total memory, torch.cuda.get_device_properties)",
         scope="runtime", layer="bench", malformed="16G"),
    # the native host engine (ref quest_tpu/env.py:426, :463)
    Knob("QUEST_HOST_BLOCK", _int_range("QUEST_HOST_BLOCK", 1, 30), 17,
         doc="log2 amplitudes per cache block of the native host engine "
             "(host.py; default: 17 = 1 MiB of f32 planes)",
         scope="keyed", layer="host", malformed="big", flips=("17", "15")),
    # the reference reads QUEST_NATIVE_LIB when native.py is imported
    # (runtime: no program reads it); the port reads it at the first
    # native.load() and keeps that library for the process, which a host
    # program's build can reach: once per process, so import_once
    Knob("QUEST_NATIVE_LIB", str, None,
         doc="path of a native host library to load instead of the one "
             "built from native/*.cpp into build/quest_tpu_torch "
             "(native.py; used as it is, never rebuilt; read at the "
             "first load, kept for the process)",
         scope="import_once", layer="host"),
    # the serving engine (ref quest_tpu/env.py:497-590, :644); read when
    # a ServeEngine is constructed
    Knob("QUEST_SERVE_MAX_WAIT_MS",
         _int_range("QUEST_SERVE_MAX_WAIT_MS", 0), 5,
         doc="max milliseconds a serve request waits for batch-mates "
             "before its partial batch launches (default: 5); 0 = no "
             "coalescing, every request launches alone",
         scope="runtime", layer="serve", malformed="-1"),
    Knob("QUEST_SERVE_MAX_QUEUE", _int_range("QUEST_SERVE_MAX_QUEUE", 1),
         1024,
         doc="bounded pending-request depth of ServeEngine; the "
             "overflowing submit raises RejectedError (default: 1024)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_SERVE_MAX_BATCH", _int_range("QUEST_SERVE_MAX_BATCH", 1),
         64,
         doc="max states coalesced into one serve launch; a queue "
             "holding this many pending states dispatches at once "
             "(default: 64)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_SERVE_RESTART_MAX",
         _int_range("QUEST_SERVE_RESTART_MAX", 0), 3,
         doc="consecutive worker-crash restarts ServeEngine's supervisor "
             "allows before the engine turns FAILED (default: 3)",
         scope="runtime", layer="serve", malformed="-1"),
    Knob("QUEST_SERVE_BREAKER_THRESHOLD",
         _int_range("QUEST_SERVE_BREAKER_THRESHOLD", 1), 3,
         doc="consecutive primary-engine compile failures of one program "
             "before its breaker opens and its requests step down the "
             "fused -> banded -> host ladder (default: 3)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_SERVE_TENANT_QUOTA", _parse_tenant_quota,
         _DEFAULT_TENANT_QUOTA,
         doc="per-tenant pending-request quota: one integer (every "
             "tenant) or 'tenant=quota,...' with an optional default= "
             "entry (default: 256)",
         scope="runtime", layer="serve", malformed="alice=lots"),
    Knob("QUEST_SERVE_SHED_THRESHOLD", _parse_shed_threshold, 0.75,
         doc="queue pressure above which the lowest priority class is "
             "shed with ShedError, in (0, 1] (default: 0.75)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_DISPATCH_TIMEOUT_S",
         _parse_nonneg_float("QUEST_DISPATCH_TIMEOUT_S"), 0.0,
         doc="serve dispatch watchdog deadline in seconds: a launch "
             "outliving it fails typed DispatchTimeout and the wedged "
             "worker is replaced (default: 0 = no watchdog)",
         scope="runtime", layer="serve", malformed="-1"),
    # the serving fleet (ref quest_tpu/env.py:535-591); read when a
    # ServeFleet, ReplicaProxy or Autoscaler is constructed
    Knob("QUEST_SERVE_REPLICAS", _int_range("QUEST_SERVE_REPLICAS", 1), 2,
         doc="ServeEngine replicas a ServeFleet owns (program-key "
             "affinity routing, fleet-level failover; default: 2)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_FLEET_PROC", _bool01("QUEST_FLEET_PROC"), False,
         doc="ServeFleet replica backend: 1 = supervised worker processes "
             "behind serve.ipc, each with its own interpreter and CUDA "
             "context; 0 = in-process worker threads (default)",
         scope="runtime", layer="serve", malformed="2"),
    Knob("QUEST_FLEET_MIN_REPLICAS",
         _int_range("QUEST_FLEET_MIN_REPLICAS", 1), 1,
         doc="autoscaler floor: the fleet never scales below this many "
             "live replicas (default: 1)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_FLEET_MAX_REPLICAS",
         _int_range("QUEST_FLEET_MAX_REPLICAS", 1), 4,
         doc="autoscaler ceiling: the fleet never scales above this many "
             "live replicas (default: 4)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_HEARTBEAT_S", _parse_pos_float("QUEST_HEARTBEAT_S"), 0.25,
         doc="process-replica heartbeat cadence in seconds: each worker "
             "ships its health and a registry snapshot a beat, and the "
             "proxy declares it lost (kill, respawn under the restart "
             "budget) after 4 missed beats (default: 0.25)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_SERVE_PRIORITIES", _int_range("QUEST_SERVE_PRIORITIES", 1),
         2,
         doc="priority classes a ServeFleet accepts (submit priority= in "
             "[0, N); higher classes shed later; default: 2)",
         scope="runtime", layer="serve", malformed="0"),
    # fault injection and the durable executor (ref quest_tpu/env.py:
    # 597-640): read at run time, not keyed
    Knob("QUEST_FAULT_PLAN", _parse_fault_plan, None,
         doc="deterministic fault-injection plan: 'site[:key=value]..."
             "[;...]' over the resilience.faults site catalog (keys: "
             "error, after, every, times, p, seed); unset = no injection",
         scope="runtime", layer="serve", malformed="serve.not_a_site"),
    Knob("QUEST_DURABLE_EVERY", _int_range("QUEST_DURABLE_EVERY", 1), 8,
         doc="sweep-plan steps between checkpoints of the durable "
             "executor (resilience/durable.py; default: 8)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_INTEGRITY", _bool01("QUEST_INTEGRITY"), True,
         doc="in-flight corruption sentinels at checkpoint cadence "
             "(statevector norm / density trace+hermiticity drift vs the "
             "run's baseline): 1/0 (default: 1; a trip raises "
             "IntegrityError and refuses to stamp the checkpoint)",
         scope="runtime", layer="serve", malformed="2"),
    Knob("QUEST_INTEGRITY_TOL", _parse_pos_float("QUEST_INTEGRITY_TOL"),
         1e-3,
         doc="relative drift budget of the durable integrity sentinels "
             "(absolute for unit-scale invariants; default: 1e-3)",
         scope="runtime", layer="serve", malformed="-1"),
    Knob("QUEST_CHECKPOINT_KEEP", _int_range("QUEST_CHECKPOINT_KEEP", 1), 2,
         doc="versioned checkpoints retained per durable run "
             "(checkpoint.prune_steps keep-last-K; default: 2)",
         scope="runtime", layer="serve", malformed="0"),
    Knob("QUEST_DURABLE_ELASTIC", _bool01("QUEST_DURABLE_ELASTIC"), False,
         doc="default for run_durable(elastic=): 1 makes a durable resume "
             "mesh-independent (a chain written on D shards re-enters any "
             "mesh, or one register); default: 0, a mesh mismatch is "
             "refused typed",
         scope="runtime", layer="serve", malformed="yes"),
)

KNOBS = {k.name: k for k in _KNOB_LIST}


def knob_value(name: str):
    """Effective value of a registered knob: the validating parse of the
    environment when set, else the registered default."""
    k = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return k.default
    return k.parse(raw)


def knob_current(name: str):
    """Like knob_value, but honouring a setter-backed effective value
    (set_matmul_precision beats QUEST_MATMUL_PRECISION once called)."""
    k = KNOBS[name]
    return k.current() if k.current is not None else knob_value(name)


_KEYED = tuple(sorted(k.name for k in _KNOB_LIST
                     if k.scope == "keyed"))

# engine_mode_key runs on every serve submit. Reading its 18 knobs through
# os.environ.get encodes each name and raises a KeyError inside the
# mapping for every unset knob; it reads the interpreter's encoded
# environment instead (os.environ._data, which os.environ's own writes
# update), with the names encoded once and each raw value's parse kept.
# scripts/profile_torch_submit.py times a CPU submit under this read,
# under os.environ.get with the same parse cache, and per knob.
_ENV_DATA = os.environ._data
_KEYED_READS = tuple((KNOBS[name], os.environ.encodekey(name))
                     for name in _KEYED)
_PARSED = {}        # (name, encoded raw value) -> parsed value


def engine_mode_key() -> tuple:
    """((name, effective value), ...) of every keyed knob, sorted by
    name: the part of every compiled-program cache key that a knob flip
    changes (ref quest_tpu/env.py:718-727). Reads the environment on
    every call."""
    out = []
    for k, ekey in _KEYED_READS:
        if k.current is not None:
            out.append((k.name, k.current()))
            continue
        raw = _ENV_DATA.get(ekey)
        if raw is None:
            out.append((k.name, k.default))
            continue
        try:
            value = _PARSED[(k.name, raw)]
        except KeyError:
            value = k.parse(os.environ.decodevalue(raw))
            _PARSED[(k.name, raw)] = value
        out.append((k.name, value))
    return tuple(out)


def default_device() -> torch.device:
    """The device the entry points use when the caller names none: the
    CUDA card. Raises when there is none — the port never drops to the
    CPU on its own; the CPU path is taken only on an explicit
    device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "quest_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or default_device() when None."""
    if device is None:
        return default_device()
    return torch.device(device)


def hbm_bytes(device=None) -> int:
    """Device memory the capacity models price against: QUEST_HBM_BYTES
    when set, else the total memory of the card (`device`, default the
    current one). A CPU device has no such figure: set the knob."""
    raw = knob_value("QUEST_HBM_BYTES")
    if raw is not None:
        return int(raw)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        raise ValueError(
            f"no device memory figure for {dev}: set QUEST_HBM_BYTES")
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device to read the memory of: set "
                         "QUEST_HBM_BYTES")
    return int(torch.cuda.get_device_properties(
        dev if dev is not None else torch.cuda.current_device()).total_memory)


class QuESTEnv:
    """The execution environment of one process (ref quest_tpu/env.py:730,
    QuESTEnv(devices, distributed)). `devices` is a list of torch devices
    or names, in the reference's first position; entries may repeat (four
    shards on one card are [torch.device("cuda")] * 4). Two or more make
    a mesh of that many shards (the largest power of two of them):
    num_ranks is its size, and create_qureg(n, env) shards a register
    over it when `sharding_for` says so. One device — a list of one, or
    a bare device or name such as QuESTEnv("cpu") — is a one-device env;
    None is the CUDA card. `mesh=` (an AmpMesh, keyword only) gives the
    mesh itself. distributed=True (a mesh over several processes) raises
    until multi-process meshes are ported (ROADMAP A10c)."""

    def __init__(self, devices=None, distributed: bool = False, *,
                 mesh=None):
        if distributed:
            raise NotImplementedError(
                "QuESTEnv(distributed=True): meshes over several "
                "processes are not ported yet (ROADMAP A10c)")
        device = None
        if isinstance(devices, (str, torch.device)):
            devices, device = None, devices
        if mesh is not None and devices is not None:
            raise ValueError("pass devices= or mesh=, not both")
        if devices is not None:
            from quest_tpu_torch.parallel.mesh import make_amp_mesh
            devices = list(devices)
            if not devices:
                raise ValueError("devices must name at least one device")
            mesh = make_amp_mesh(devices=devices)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if mesh is not None:
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)

    @property
    def num_ranks(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def rank(self) -> int:
        return 0

    def sharding_for(self, num_state_qubits: int):
        """The mesh a register of `num_state_qubits` is sharded over, or
        None when the env is one device or the register holds fewer than
        two amplitudes a shard (ref :763: local_n >= 1, the
        E_DISTRIB_QUREG_TOO_SMALL bound of the sharded engines)."""
        if (self.mesh is None
                or (1 << num_state_qubits) < 2 * self.num_ranks):
            return None
        return self.mesh

    def sync(self) -> None:
        """Block until the devices' queued work completes (ref
        syncQuESTEnv)."""
        devs = self.mesh.devices if self.mesh is not None else (self.device,)
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def platform(self) -> str:
        return "CUDA" if self.device.type == "cuda" else "CPU"

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "CPU"

    def get_environment_string(self, num_state_qubits: int = None) -> str:
        """The reference's label "{n}qubits_{PLATFORM}_{r}ranksx{t}threads"
        (getEnvironmentString, QuEST_cpu.c:1358-1364), the platform CUDA
        or CPU, one rank and one thread."""
        tag = f"{self.platform()}_{self.num_ranks}ranksx1threads"
        if num_state_qubits is not None:
            tag = f"{num_state_qubits}qubits_{tag}"
        return tag

    def report(self) -> str:
        s = (f"EXECUTION ENVIRONMENT:\nRunning distributed (MPI) version: "
             f"{'yes' if self.num_ranks > 1 else 'no'}\n"
             f"Number of devices: {self.num_ranks}\n"
             f"Platform: {self.platform()} ({self.device_name()})")
        print(s)
        return s


def create_quest_env(devices=None, distributed: bool = False, *,
                     mesh=None) -> QuESTEnv:
    """QuESTEnv(devices, distributed, mesh=) (ref quest_tpu/env.py
    create_quest_env)."""
    return QuESTEnv(devices, distributed, mesh=mesh)


def destroy_quest_env(env: QuESTEnv) -> None:
    """Nothing to free; kept for API parity."""


def sync_quest_success(success_code: int = 1) -> int:
    """AND a success code across processes (ref syncQuESTSuccess); one
    process: the code as 0 or 1."""
    return int(bool(success_code))
