"""The program-plan IR, the priced autotuner and its persistent plan cache.

A port of quest_tpu/plan.py. `ProgramPlan` is one typed record of what
the engines would run for a circuit: the scheduler's counters, the
banded pass model, the fused engine's segment/sweep record under
HOPPER_GEOMETRY, the batched, f64, gradient and transpile axes.
`Circuit.plan_stats()` is a view of it (`ProgramPlan.stats()`, the
reference's dict shape).

`autotune()` prices every engine a circuit can run through on one card
(per-gate, banded, fused; each again on the transpiled stream when the
transpiler changed it) and picks the cheapest, INCUMBENT-WINS-TIES: the
engine Circuit.apply dispatches without the autotuner (per-gate, or
banded above PERGATE_COMPILE_WARN_OPS under QUEST_APPLY_AUTOROUTE) is
always a candidate and loses only to a strictly cheaper plan. The prices
are the card's, from circuit._COST_MODELS['h100']: the per-gate engine
at its measured ms per op, the banded engine at its measured ms per
full-state pass, the fused engine through circuit._estimate_ms over its
actual sweep plan. No TPU multiplier is left.

The chosen plan is persistent: a content-addressed JSON file (sha256
over the op stream's values, the register kind, dtype, batch, the device
kind, engine_mode_key() and the port's format tag), versioned and
self-digested, in plan_cache_dir() (QUEST_PLAN_CACHE_DIR, default
build/quest_tpu_torch_plans under the repo). A damaged or stale entry
is skipped loudly (stderr and a counter) to a fresh price, never read.

`build_plan(devices=)` (and Circuit.plan_stats(devices=)) adds the
reference's 'comm' record: the comm planner's predicted schedule of the
banded/fused sharded engines over that many shards, pure host math
(parallel.sharded.comm_plan_record). The priced sharded search
(`autotune(mesh=, devices=, topology=)`, ref plan.py:419-600) prices the
sharded families on the shard: the banded engine's local passes plus the
comm planner's predicted exchange bytes (comm.choose_plan, the same
record build_plan(devices=) gives) as device-local copies at the card's
measured stage-free sweep rate, every comm strategy the planner priced
as an advisory candidate, and the fused engine projected from the
unsharded fused/banded pass ratio; the incumbent (sharded-banded) wins
ties. A mesh's plan key carries its device tuple.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from quest_tpu_torch.env import engine_mode_key, hbm_bytes, knob_value
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F

PLAN_FORMAT_VERSION = 1
# the port's own tag: a plan of the JAX package and one of the port never
# share a key or a file
PLAN_FORMAT = "quest_tpu_torch-plan"

ENGINES = ("pergate", "banded", "fused")

_CACHE_STATS = {"hits": 0, "misses": 0, "stale": 0, "corrupt": 0,
                "searches": 0, "stores": 0, "unkeyed": 0}


def cache_stats() -> dict:
    """Snapshot of the plan-cache counters (ref plan.py:68)."""
    return dict(_CACHE_STATS)


def reset_cache_stats() -> None:
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramPlan:
    """The queryable program plan (ref plan.py:87), in JSON-native fields
    so it round-trips through the cache by value."""
    version: int
    key: Optional[str]         # content address; None: unrenderable operand
    num_qubits: int
    n: int                     # state qubits (2x num_qubits if density)
    density: bool
    dtype: str                 # numpy dtype str of the real planes
    batch: Optional[int]
    devices: Optional[int]
    engine: str                # chosen candidate
    incumbent: str             # what Circuit.apply dispatches
    source: str                # 'search' | 'cache' | 'build'
    cost: dict                 # the chosen candidate's priced record
    candidates: dict           # name -> priced record
    scheduled: bool
    flat_ops: int
    planned_ops: int
    scheduler: dict
    banded: dict               # fusion.plan_stats record
    fused: Optional[dict]      # band_plan.fused_record (kernel tier only)
    batched: Optional[dict]    # batch= only
    f64: dict                  # f64 plane bytes against the device memory
    comm: Optional[dict]       # predicted sharded schedule (devices=)
    extra: dict                # subsystem extensions (Trotter frames)
    grad: Optional[dict] = None
    transpile: Optional[dict] = None
    device_kind: str = "cpu"

    def stats(self) -> dict:
        """The reference's Circuit.plan_stats() dict (ref plan.py:122)."""
        rec = {
            "scheduled": self.scheduled,
            "flat_ops": self.flat_ops,
            "planned_ops": self.planned_ops,
            "scheduler": dict(self.scheduler),
            "banded": dict(self.banded),
        }
        if self.fused is not None:
            rec["fused"] = dict(self.fused)
        if self.batched is not None:
            rec["batched"] = dict(self.batched)
        rec["f64"] = dict(self.f64)
        if self.comm is not None:
            rec["comm"] = dict(self.comm)
        if self.grad is not None:
            rec["grad"] = dict(self.grad)
        if self.transpile is not None:
            rec["transpile"] = dict(self.transpile)
        return rec

    def to_meta(self) -> dict:
        meta = dataclasses.asdict(self)
        meta["plan_digest"] = _self_digest(meta)
        return meta

    @classmethod
    def from_meta(cls, meta: dict) -> "ProgramPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})

    def line(self) -> str:
        """explain()'s plan line (ref plan.py:160)."""
        tot = (self.cost or {}).get("total_ms")
        cost_s = f"~{tot:.3g} ms/app" if tot is not None else "unpriced"
        src = {"cache": "cache hit", "search": "searched",
               "build": "unsearched"}.get(self.source, self.source)
        extra = ""
        if self.grad is not None:
            extra = f", grad={self.grad.get('engine', 'taped')}"
        if self.transpile is not None:
            t = self.transpile
            extra += (f", transpile={t['ops_in']}->{t['ops_out']} ops"
                      f"{' (chosen)' if t.get('chosen') else ''}")
        return (f"plan: engine={self.engine} {cost_s} "
                f"(incumbent={self.incumbent}{extra}, "
                f"{len(self.candidates)} candidate(s), {src}; priced for "
                f"{self.device_kind})")


# ---------------------------------------------------------------------------
# subsystem records
# ---------------------------------------------------------------------------

def _memory_or_none() -> Optional[int]:
    """env.hbm_bytes(), or None where there is no figure (a CPU session
    without QUEST_HBM_BYTES)."""
    try:
        return hbm_bytes()
    except ValueError:
        return None


def _f64_record(n: int) -> dict:
    """f64 planes of 2^n amplitudes against the device memory (the port
    runs f64 natively, in place; the reference's limb chunking has no
    counterpart)."""
    state = 2 * 8 * (1 << n)
    hbm = _memory_or_none()
    return {"n": int(n), "state_bytes": state, "hbm_bytes": hbm,
            "fits_hbm": None if hbm is None else bool(state <= hbm)}


def _subsystem_records(circuit, n: int, density: bool,
                       batch: Optional[int],
                       budgets: BP.Budgets = BP.HOPPER_GEOMETRY) -> dict:
    """Every subsystem's plan record through its own planner (ref
    plan.py:183): one scheduler run serves the stats, the planned list
    and the prices."""
    from quest_tpu_torch.circuit import flatten_ops
    flat = flatten_ops(circuit.ops, n, density)
    enabled = F._schedule_enabled()
    sched_ops, sstats = F.schedule(flat, n)
    sstats["enabled"] = enabled
    planned = sched_ops if enabled else flat
    rec: Dict[str, Any] = {
        "flat": flat, "sched_ops": sched_ops, "planned": planned,
        "enabled": enabled, "scheduler": sstats,
        "banded": F.plan_stats(F.plan(planned, n)),
        "fused": None, "batched": None, "swept": None,
    }
    if BP.usable(n):
        items = F.plan(planned, n, bands=BP.plan_bands(n))
        parts = BP.segment_plan(items, n, budgets=budgets)
        swept = BP.maybe_sweep(parts, n, budgets=budgets)
        rec["swept"] = swept
        rec["fused"] = BP.fused_record(parts, swept, n, budgets=budgets)
        if batch is not None:
            rec["batched"] = BP.batched_stats(swept, int(batch))
    elif batch is not None:
        # below the kernel tier the batch rides the banded program
        rec["batched"] = {
            "batch": int(batch), "bucket": int(batch),
            "states_per_sweep": int(batch),
            "hbm_sweeps": rec["banded"]["full_state_passes"],
            "kernel_sweeps": 0, "batched_stages": 0,
        }
    rec["f64"] = _f64_record(n)
    return rec


def _grad_record(circuit, density: bool, dtype) -> Optional[dict]:
    """The gradient axis (adjoint.grad_record); None without parametric
    ops, or where the device memory is unknown."""
    if _memory_or_none() is None:
        return None
    from quest_tpu_torch import adjoint as AD
    return AD.grad_record(circuit, density=density, dtype=dtype)


_transpile_warned = False


def _transpile_record(circuit, n: int, density: bool, recs: dict):
    """The transpile axis (ref plan.py:282): (record, transpiled circuit
    or None). None record under QUEST_TRANSPILE=0."""
    knob = knob_value("QUEST_TRANSPILE")
    if knob == "0":
        return None, None
    from quest_tpu_torch.circuit import flatten_ops
    try:
        from quest_tpu_torch import transpile as T
        tc, rep = T.transpile_cached(circuit)
    except Exception as e:             # never fatal to planning
        global _transpile_warned
        if not _transpile_warned:
            _transpile_warned = True
            print(f"[quest_tpu_torch.plan] transpile axis skipped: {e!r}",
                  file=sys.stderr, flush=True)
        return None, None
    sweeps_in = recs["banded"]["full_state_passes"]
    rec = {"knob": knob, "ops_in": rep["ops_in"], "ops_out": rep["ops_out"],
           "sweeps_in": sweeps_in, "sweeps_out": sweeps_in,
           "passes": dict(rep["passes"]), "chosen": False}
    if not rep["changed"]:
        return rec, None
    flat_t = flatten_ops(tc.ops, n, density)
    sched_t, _ = F.schedule(flat_t, n)
    planned_t = sched_t if recs["enabled"] else flat_t
    rec["sweeps_out"] = F.plan_stats(F.plan(planned_t, n))[
        "full_state_passes"]
    return rec, tc


def _plan_extra(circuit, density: bool) -> dict:
    fn = getattr(circuit, "_plan_extra", None)
    return dict(fn(density)) if callable(fn) else {}


def _incumbent_engine(circuit, devices: Optional[int] = None) -> str:
    """The engine the stack dispatches without the autotuner: on shards
    the banded sharded engine (ref :333); else Circuit.apply's choice,
    banded above PERGATE_COMPILE_WARN_OPS ops of a channel-free circuit
    under QUEST_APPLY_AUTOROUTE, per-gate otherwise."""
    if devices is not None:
        return "sharded-banded"
    from quest_tpu_torch.circuit import PERGATE_COMPILE_WARN_OPS
    if (len(circuit.ops) > PERGATE_COMPILE_WARN_OPS
            and not any(op.kind == "superop" for op in circuit.ops)
            and knob_value("QUEST_APPLY_AUTOROUTE")):
        return "banded"
    return "pergate"


def device_kind(device=None) -> str:
    """The card's name (torch.cuda.get_device_name) a plan is priced
    and keyed for, or 'cpu' for device='cpu' or without a card."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def build_plan(circuit, *, density: bool = False,
               batch: Optional[int] = None, devices: Optional[int] = None,
               dtype=np.float32, budgets: BP.Budgets = BP.HOPPER_GEOMETRY,
               device=None) -> ProgramPlan:
    """The ProgramPlan of `circuit` under the current keyed knobs,
    unpriced (engine = the incumbent): the record Circuit.plan_stats()
    shows (ref plan.py:238). `budgets` is the planner geometry of the
    fused record (band_plan.TPU_GEOMETRY gives the reference's).
    `devices` adds the comm record of the sharded engines over that many
    shards, and the incumbent is then the banded sharded engine (ref
    plan.py:333)."""
    n = circuit.num_qubits * 2 if density else circuit.num_qubits
    recs = _subsystem_records(circuit, n, density, batch, budgets)
    comm = None
    incumbent = _incumbent_engine(circuit)
    if devices is not None:
        from quest_tpu_torch import precision
        from quest_tpu_torch.parallel import sharded as S
        comm = S.comm_plan_record(
            circuit.ops, n, density, int(devices),
            dtype=precision.complex_dtype_of(dtype))
        incumbent = "sharded-banded"
    return ProgramPlan(
        version=PLAN_FORMAT_VERSION, key=None,
        num_qubits=circuit.num_qubits, n=n, density=bool(density),
        dtype=np.dtype(dtype).str,
        batch=None if batch is None else int(batch),
        devices=None if devices is None else int(devices),
        engine=incumbent, incumbent=incumbent, source="build",
        cost={}, candidates={},
        scheduled=recs["enabled"], flat_ops=len(recs["flat"]),
        planned_ops=len(recs["planned"]), scheduler=recs["scheduler"],
        banded=recs["banded"], fused=recs["fused"],
        batched=recs["batched"], f64=recs["f64"], comm=comm,
        extra=_plan_extra(circuit, density),
        grad=_grad_record(circuit, density, dtype),
        transpile=_transpile_record(circuit, n, density, recs)[0],
        device_kind=device_kind(device))



# ---------------------------------------------------------------------------
# pricing: the card's measured constants (circuit._COST_MODELS['h100'])
# ---------------------------------------------------------------------------

def _pass_scale(n: int, dtype) -> float:
    """The model's constants are ms at 2^30 f32 amplitudes; f64 planes
    move twice the bytes."""
    return (1 << n) / (1 << 30) * (np.dtype(dtype).itemsize / 4.0)


def _comm_ms(elem_bytes: float, bytes_per_real: int, model: dict) -> float:
    """An exchange's price: its bytes as a device-local copy (read once,
    written once) at the rate of the card's measured stage-free sweep,
    which reads and writes both planes of 2^30 f32 amplitudes (16 GiB
    moved) in model['base_pass'] ms."""
    moved = 2.0 * float(elem_bytes) * bytes_per_real
    return moved / float(16 << 30) * model["base_pass"]


def _cost_rec(lo: float, hi: float, passes: int, *, compile_ops: int,
              comm_elem_bytes: float = 0.0, comm_steps: int = 0,
              bytes_per_real: int = 4, model: dict = None,
              selectable: bool = True) -> dict:
    comm_ms = (_comm_ms(comm_elem_bytes, bytes_per_real, model)
               if comm_elem_bytes else 0.0)
    return {"est_ms_lo": round(float(lo), 6),
            "est_ms_hi": round(float(hi), 6),
            "hbm_passes": int(passes),
            "compile_ops": int(compile_ops),
            "comm_elem_bytes": float(comm_elem_bytes),
            "comm_steps": int(comm_steps),
            "comm_ms": round(comm_ms, 6),
            "total_ms": round((float(lo) + float(hi)) / 2 + comm_ms, 6),
            "selectable": bool(selectable)}


def _rank(cost: dict):
    """Cheapest first: estimated ms, then full-state passes, then program
    size. Selection uses strict <, so the incumbent wins ties."""
    return (cost["total_ms"], cost["hbm_passes"], cost["compile_ops"])


def _price_pergate(num_flat: int, n: int, model: dict, dtype) -> dict:
    # the per-gate engine: every op of the flat list is one pass of its
    # primitive over the state, at the card's ms per op
    ms = num_flat * model["pergate_op"] * _pass_scale(n, dtype)
    return _cost_rec(ms, ms, num_flat, compile_ops=num_flat)


def _price_banded(banded_stats: dict, n: int, model: dict, dtype,
                  selectable: bool = True, comm_elem_bytes: float = 0.0,
                  comm_steps: int = 0, bytes_per_real: int = 4) -> dict:
    # fusion.plan_stats's pass model at the card's ms per full-state pass
    passes = banded_stats["full_state_passes"]
    ms = passes * model["banded_pass"] * _pass_scale(n, dtype)
    return _cost_rec(ms, ms, passes, compile_ops=passes,
                     comm_elem_bytes=comm_elem_bytes, comm_steps=comm_steps,
                     bytes_per_real=bytes_per_real, model=model,
                     selectable=selectable)


def _price_fused(swept, n: int, model: dict,
                 selectable: bool = True) -> dict:
    # the fused engine's own estimate over its sweep plan
    from quest_tpu_torch.circuit import _estimate_ms
    lo, hi = _estimate_ms(swept, n, model)
    passes = len(swept)
    segs = sum(1 for p in swept if p[0] == "segment")
    return _cost_rec(lo, hi, passes, compile_ops=passes + segs,
                     selectable=selectable)


def _enumerate_candidates(n: int, dtype, recs: dict, model: dict) -> dict:
    """Every priced alternative on one card (ref plan.py:419). The
    scheduler stream the knob does not run is priced but not selectable
    (QUEST_SCHEDULE stays the user's); the fused candidate is selectable
    only on f32 planes (the kernel is f32)."""
    f32 = np.dtype(dtype).itemsize <= 4
    cands: Dict[str, dict] = {
        "pergate": _price_pergate(len(recs["flat"]), n, model, dtype),
        "banded": _price_banded(recs["banded"], n, model, dtype),
    }
    if recs["swept"] is not None:
        cands["fused"] = _price_fused(recs["swept"], n, model,
                                      selectable=f32)
    other = recs["flat"] if recs["enabled"] else recs["sched_ops"]
    tag = "nosched" if recs["enabled"] else "sched"
    cands[f"banded:{tag}"] = _price_banded(
        F.plan_stats(F.plan(other, n)), n, model, dtype, selectable=False)
    return cands


def _enumerate_sharded(n: int, dtype, recs: dict, model: dict,
                       devices: int, topology) -> dict:
    """The sharded families (ref plan.py:459-505): the banded engine's
    local passes on the shard plus the comm planner's predicted bytes of
    the strategy it chose; every other strategy it priced as an advisory
    candidate; the fused engine projected from the unsharded fused/banded
    pass ratio (it runs the same segment geometry per shard between the
    same exchanges), selectable on f32 planes and a kernel-tier shard."""
    from quest_tpu_torch import precision
    from quest_tpu_torch.parallel import comm as C
    from quest_tpu_torch.parallel import sharded as S

    f32 = np.dtype(dtype).itemsize <= 4
    local_n = n - (devices.bit_length() - 1)
    topo = topology if topology is not None else C.topology(devices)
    bands = S._shard_bands(n, local_n)
    chosen, cinfo = C.choose_plan(recs["planned"], n, local_n,
                                  engine="banded", bands=bands, topo=topo)
    strategy = cinfo["strategy"]
    comm_cost = cinfo["candidates"][strategy]
    bpr = precision.real_dtype_of(
        precision.complex_dtype_of(np.dtype(dtype))).itemsize
    items = cinfo.get("items")
    if items is None:
        items = F.plan(chosen, n, bands=bands)
    bstats = F.plan_stats(items)
    cands: Dict[str, dict] = {}
    for name, cc in cinfo["candidates"].items():
        if name == strategy:
            continue
        cands[f"sharded-banded:comm={name}"] = _price_banded(
            bstats, local_n, model, dtype,
            comm_elem_bytes=cc["elem_bytes"], comm_steps=cc["exchanges"],
            bytes_per_real=bpr, selectable=False)
    sb = _price_banded(bstats, local_n, model, dtype,
                       comm_elem_bytes=comm_cost["elem_bytes"],
                       comm_steps=comm_cost["exchanges"],
                       bytes_per_real=bpr)
    cands["sharded-banded"] = sb
    if BP.usable(local_n) and recs["fused"] is not None:
        ratio = (recs["fused"]["hbm_sweeps"]
                 / max(1, recs["banded"]["full_state_passes"]))
        base = _price_banded(bstats, local_n, model, dtype)
        cands["sharded-fused"] = _cost_rec(
            base["est_ms_lo"] * ratio, base["est_ms_hi"] * ratio,
            max(1, int(round(bstats["full_state_passes"] * ratio))),
            compile_ops=recs["fused"]["hbm_sweeps"],
            comm_elem_bytes=comm_cost["elem_bytes"],
            comm_steps=comm_cost["exchanges"], bytes_per_real=bpr,
            model=model, selectable=f32)
    return cands


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

def autotune(circuit, state_kind: str = "pure", mesh=None, topology=None,
             dtype=np.float32, batch: Optional[int] = None,
             devices: Optional[int] = None, persist: Optional[bool] = None,
             device=None) -> ProgramPlan:
    """Price every engine `circuit` can run through on one card and return
    the cheapest as a ProgramPlan, incumbent-wins-ties (ref plan.py:510).
    `state_kind` 'pure' or 'density'; `persist` None follows
    QUEST_PLAN_CACHE (load from / store to plan_cache_dir()); `device`
    names the card the plan is for (default: the current one, or 'cpu'
    without a card). `mesh` (a parallel.AmpMesh) or `devices` (a shard
    count) selects the sharded families; `topology` (a comm.Topology)
    overrides the QUEST_COMM_TOPOLOGY resolution of the comm pricing."""
    if state_kind not in ("pure", "density"):
        raise ValueError(
            f"state_kind must be 'pure' or 'density', got {state_kind!r}")
    circuit._reject_measure("plan.autotune")
    mesh_key = None
    if mesh is not None:
        from quest_tpu_torch.parallel.mesh import refuse_process_mesh
        # each process would time its own candidates and could choose
        # another engine than its peers
        refuse_process_mesh(mesh, "plan.autotune(mesh=)")
        if devices is not None:
            raise ValueError("pass mesh= or devices=, not both")
        devices = int(mesh.size)
        mesh_key = list(mesh.key)
        if device is None:
            device = mesh.devices[0]
    if devices is not None:
        devices = int(devices)
        if devices < 2 or devices & (devices - 1):
            raise ValueError(
                f"devices must be a power of two >= 2, got {devices}")
    elif topology is not None:
        raise ValueError("topology= prices the sharded families: pass "
                         "mesh= or devices= with it")
    density = state_kind == "density"
    n = circuit.num_qubits * 2 if density else circuit.num_qubits
    if persist is None:
        persist = bool(knob_value("QUEST_PLAN_CACHE"))
    kind = device_kind(device)
    key = plan_key(circuit, density=density, dtype=dtype, batch=batch,
                   kind=kind, devices=devices, topology=topology,
                   mesh_key=mesh_key)
    if key is None:
        _CACHE_STATS["unkeyed"] += 1
    elif persist:
        cached = load_plan(key)
        if cached is not None:
            _CACHE_STATS["hits"] += 1
            return cached
        _CACHE_STATS["misses"] += 1
    _CACHE_STATS["searches"] += 1
    from quest_tpu_torch.circuit import _cost_model_for
    model = _cost_model_for(kind)[0]
    recs = _subsystem_records(circuit, n, density, batch)

    def enumerate_for(recs_):
        if devices is None:
            return _enumerate_candidates(n, dtype, recs_, model)
        return _enumerate_sharded(n, dtype, recs_, model, devices, topology)
    cands = enumerate_for(recs)
    incumbent = _incumbent_engine(circuit, devices)
    # the transpile axis: the rewritten stream's candidates beside the raw
    # ones; under 'auto' the raw incumbent still wins ties, under '1' the
    # transpiled family is preferred whenever the rewrite changed anything
    tr_rec, tr_c = _transpile_record(circuit, n, density, recs)
    if tr_c is not None:
        recs_t = _subsystem_records(tr_c, n, density, batch)
        for cname, cval in enumerate_for(recs_t).items():
            cands[f"{cname}:transpiled"] = cval
    selectable = {k: v for k, v in cands.items() if v["selectable"]}
    best, pool = incumbent, selectable
    if tr_rec is not None and tr_rec["knob"] == "1" and tr_c is not None:
        inc_t = _incumbent_engine(tr_c, devices) + ":transpiled"
        pool_t = {k: v for k, v in selectable.items()
                  if k.endswith(":transpiled")}
        if inc_t in pool_t:
            best, pool = inc_t, pool_t
    for name in sorted(pool):
        if _rank(pool[name]) < _rank(pool[best]):
            best = name
    if tr_rec is not None:
        tr_rec["chosen"] = best.endswith(":transpiled")
    plan = ProgramPlan(
        version=PLAN_FORMAT_VERSION, key=key,
        num_qubits=circuit.num_qubits, n=n, density=density,
        dtype=np.dtype(dtype).str,
        batch=None if batch is None else int(batch), devices=devices,
        engine=best, incumbent=incumbent, source="search",
        cost=cands[best], candidates=cands,
        scheduled=recs["enabled"], flat_ops=len(recs["flat"]),
        planned_ops=len(recs["planned"]), scheduler=recs["scheduler"],
        banded=recs["banded"], fused=recs["fused"],
        batched=recs["batched"], f64=recs["f64"],
        comm=(None if devices is None else _comm_record(
            circuit, n, density, devices, dtype)),
        extra=_plan_extra(circuit, density),
        grad=_grad_record(circuit, density, dtype),
        transpile=tr_rec, device_kind=kind)
    if persist and key is not None:
        save_plan(plan)
    return plan


def _comm_record(circuit, n: int, density: bool, devices: int,
                 dtype) -> dict:
    from quest_tpu_torch import precision
    from quest_tpu_torch.parallel import sharded as S
    return S.comm_plan_record(circuit.ops, n, density, int(devices),
                              dtype=precision.complex_dtype_of(dtype))


def planned_circuit(circuit, plan: ProgramPlan):
    """The circuit a plan's chosen engine runs: the transpiled stream
    for a ':transpiled' candidate, else `circuit` itself."""
    if plan.engine.endswith(":transpiled"):
        from quest_tpu_torch import transpile as T
        return T.transpile_cached(circuit)[0]
    return circuit


def compiled_for(circuit, plan: ProgramPlan, device=None, mesh=None):
    """The chosen engine's compiled program of `circuit` on `device`
    (default: the CUDA card): Circuit.compiled, compiled_banded or
    compiled_fused of the (maybe transpiled) stream; a sharded plan's
    compiled_sharded_banded / _fused over `mesh`."""
    c = planned_circuit(circuit, plan)
    engine = plan.engine.split(":")[0]
    if engine.startswith("sharded-"):
        if mesh is None:
            raise ValueError(f"plan engine {plan.engine!r} runs on a mesh: "
                             f"pass mesh=")
        build = {"sharded-banded": c.compiled_sharded_banded,
                 "sharded-fused": c.compiled_sharded_fused}[engine]
        return build(plan.n, plan.density, mesh)
    build = {"pergate": c.compiled, "banded": c.compiled_banded,
             "fused": c.compiled_fused}[engine]
    return build(plan.n, plan.density, device=device)


# ---------------------------------------------------------------------------
# content addressing
# ---------------------------------------------------------------------------

def plan_key(circuit, *, density: bool, dtype, batch: Optional[int],
             devices: Optional[int] = None, topology=None,
             kind: str = None, mesh_key=None) -> Optional[str]:
    """sha256 over the op stream's values and everything the priced answer
    depends on: register kind, plane dtype, batch, the device kind, the
    shard count, its topology model and a mesh's device tuple,
    engine_mode_key() and the port's format tag (ref plan.py:633). None
    when an operand cannot be rendered (a tensor that needs grad)."""
    from quest_tpu_torch.circuit import _op_fingerprint
    topo_desc = None
    if devices is not None:
        from quest_tpu_torch.parallel import comm as C
        topo = topology if topology is not None else C.topology(devices)
        topo_desc = topo.describe(devices)
    ops_fp = []
    for op in circuit.ops:
        fp = _op_fingerprint(op)
        if fp is None:
            return None
        ops_fp.append(fp)
    ident = {
        "format": PLAN_FORMAT,
        "format_version": PLAN_FORMAT_VERSION,
        "num_qubits": circuit.num_qubits,
        "ops": ops_fp,
        "density": bool(density),
        "dtype": np.dtype(dtype).str,
        "batch": None if batch is None else int(batch),
        "device_kind": kind if kind is not None else device_kind(),
        "mode": [[k, repr(v)] for k, v in engine_mode_key()],
    }
    if devices is not None:
        ident.update({"devices": int(devices), "topology": topo_desc,
                      "mesh": mesh_key})
    return hashlib.sha256(json.dumps(
        ident, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------

def _self_digest(meta: dict) -> str:
    clean = {k: v for k, v in meta.items() if k != "plan_digest"}
    return hashlib.sha256(json.dumps(
        clean, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def plan_cache_dir(create: bool = True) -> Optional[str]:
    """QUEST_PLAN_CACHE_DIR, default build/quest_tpu_torch_plans under the
    repo (beside the kernel library's build/quest_tpu_torch). None when
    the location cannot be written (callers search instead)."""
    path = knob_value("QUEST_PLAN_CACHE_DIR")
    if path is None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(repo, "build", "quest_tpu_torch_plans")
    if create:
        try:
            os.makedirs(path, exist_ok=True)
            if not os.access(path, os.W_OK):
                return None
        except OSError:
            return None
    return path


def _loud_skip(path: str, why: str, counter: str) -> None:
    _CACHE_STATS[counter] += 1
    print(f"[quest_tpu_torch.plan] {counter.upper()} plan-cache entry "
          f"{path!r} skipped to a fresh price: {why}", file=sys.stderr,
          flush=True)


def save_plan(plan: ProgramPlan) -> Optional[str]:
    """Persist a searched plan (tmp + rename); the path, or None."""
    if plan.key is None:
        return None
    d = plan_cache_dir()
    if d is None:
        return None
    path = os.path.join(d, f"plan-{plan.key}.json")
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(plan.to_meta(), f, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        print(f"[quest_tpu_torch.plan] could not persist plan {path!r}: "
              f"{e!r}", file=sys.stderr, flush=True)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    _CACHE_STATS["stores"] += 1
    return path


def load_plan(key: str) -> Optional[ProgramPlan]:
    """A persisted plan by content key: None quietly when missing, None
    loudly (stderr and a counter) when corrupt or of another version
    (ref plan.py:737)."""
    d = plan_cache_dir()
    if d is None:
        return None
    path = os.path.join(d, f"plan-{key}.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        _loud_skip(path, f"unreadable JSON ({e!r})", "corrupt")
        return None
    version = meta.get("version")
    if version != PLAN_FORMAT_VERSION:
        _loud_skip(path, f"format version {version!r} != "
                   f"{PLAN_FORMAT_VERSION}", "stale")
        return None
    if meta.get("plan_digest") != _self_digest(meta):
        _loud_skip(path, "self-digest mismatch (bytes damaged on disk)",
                   "corrupt")
        return None
    if meta.get("key") != key:
        _loud_skip(path, "content key mismatch (entry filed under the "
                   "wrong identity)", "corrupt")
        return None
    try:
        plan = ProgramPlan.from_meta(meta)
    except TypeError as e:
        _loud_skip(path, f"schema mismatch ({e!r})", "corrupt")
        return None
    return dataclasses.replace(plan, source="cache")


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def sweep_chunk(total: int, num_qubits: int, *, density: bool = False,
                dtype=np.float32) -> int:
    """Chunk size for variational.sweep(chunk='auto') (ref plan.py:781):
    the largest power of two of parameter sets whose live planes (chunk x
    both planes x 2^n at `dtype`, x3 for the ansatz's working set) fit
    env.hbm_bytes() (QUEST_HBM_BYTES, or the card's memory), clamped to
    [1, total]; no bucket padding."""
    n = num_qubits * 2 if density else num_qubits
    state_bytes = 2 * np.dtype(dtype).itemsize * (1 << n)
    fit = max(1, int(hbm_bytes() // (3 * state_bytes)))
    chunk = 1
    while chunk * 2 <= min(fit, max(1, int(total))):
        chunk *= 2
    return chunk
