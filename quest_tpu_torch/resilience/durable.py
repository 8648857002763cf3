"""Durable execution: mid-circuit checkpoints, preemption-tolerant resume
and corruption sentinels.

A port of quest_tpu/resilience/durable.py (ROADMAP A11). `run_durable`
executes a circuit in STEPS cut at the engines' own launch boundaries,
never inside a kernel:

  * fused: the parts of the fused program's own sweep plan under
    HOPPER_GEOMETRY (Circuit.compiled_fused's steps), so each step is one
    launch of the segment kernel (K1 on the card) or one passthrough;
  * banded: the items of the banded engine's fusion plan;
  * sharded (mesh=): on f32 planes with kernel-tier shards the parts of
    the sharded fused program (one launch per shard, or one sharded item
    with its exchanges); otherwise the banded plan items of
    compile_plan_items_sharded; the relabel permutation at the cut rides
    the cursor.

Every `QUEST_DURABLE_EVERY` steps it checkpoints the planes and a cursor
through checkpoint.save_step's atomic versioned chain (the planes in
canonical logical order, the reference's format):

  * RESUME: a rerun of the same call finds the newest VALID checkpoint,
    verifies its cursor against the re-derived plan (engine, step count,
    keyed-knob mode key, circuit and initial-state fingerprints, the
    relabel permutation at the cut) and continues from the cut.
    Interrupted and uninterrupted runs execute the same step programs in
    the same order, so the final planes are BIT-IDENTICAL. The step
    programs are cached on the circuit: a resume in a warm process builds
    nothing.
  * CORRUPTION ON DISK: every checkpoint's digests are verified at load;
    a corrupt one is skipped LOUDLY (stderr and
    `durable_corrupt_checkpoints_skipped`) for the previous valid one.
  * CORRUPTION IN FLIGHT: sentinel reductions at checkpoint cadence —
    statevector norm drift against the run's baseline, density trace and
    Hermiticity residual (per shard on a mesh: each shard's diagonal
    block) — under QUEST_INTEGRITY / QUEST_INTEGRITY_TOL; a trip raises
    IntegrityError and refuses to stamp the checkpoint.
  * ELASTIC re-entry (elastic=True, QUEST_DURABLE_ELASTIC): a chain
    written on one mesh (or one register, or another engine) re-enters
    this call's at a boundary whose canonical op count matches the cut.

`run_durable_trajectories` checkpoints the trajectory engine's shot
chunks. The port's trajectories draw one (shots, C) block of uniforms
from a torch.Generator, so the cursor fingerprints the generator's state
at entry and a resume, given a generator in that state, redraws the
block: the result is bit-identical to trajectories.run_batched with the
same generator state and chunk.

Fault sites `durable.step` / `durable.preempt` fire before every step
(and chunk); `checkpoint.save` / `checkpoint.load` at the checkpoint's
commit and read. Metrics (serve.metrics.REGISTRY, or `registry=`):
counters durable_steps_run, durable_checkpoints_saved, durable_resumes,
durable_elastic_resumes, durable_corrupt_checkpoints_skipped,
durable_sentinel_trips; gauge durable_last_checkpoint_step; histogram
durable_checkpoint_s.

On a mesh that spans processes (parallel.make_process_mesh) the chain
is GANG-CONSISTENT (ref :779-1000): every cut writes one shared
checkpoint through checkpoint.save_step_gang's two-phase commit (each
process stamps its slice, the last stamp commits with one rename, a
process killed mid-save leaves the step uncommitted for every process),
the shards stay in the physical layout with the relabel perm in the
cursor, the cursor's state fingerprint is a reduction every process
computes to the same value, and resume validity is a function of the
shared directory alone (_latest_valid_gang), so every process resumes
the same cut, bit-identical to an uninterrupted run. Elastic resume
crosses formats both ways: a gang chain re-enters a one-process mesh or
one register, and a one-process chain a process mesh. Without elastic, a
gang step on a one-process run (or a plain step on a gang run) is
refused typed.
"""

from __future__ import annotations

import hashlib
import sys
import time as _time
from typing import List, Optional, Tuple

import numpy as np
import torch

from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch import precision
from quest_tpu_torch import validation
from quest_tpu_torch.resilience import faults
from quest_tpu_torch.serve import metrics as _metrics
from quest_tpu_torch.state import Qureg


class DurableError(validation.QuESTError):
    """A durable resume could not be reconciled with the re-derived plan:
    the cursor's engine, step count, mode key, fingerprints or relabel
    permutation disagree with what this process would execute. The
    message names the field with the expected and found values."""


class IntegrityError(validation.QuESTError):
    """An in-flight corruption sentinel tripped: the state's invariant
    (statevector norm, density trace and Hermiticity) drifted beyond
    QUEST_INTEGRITY_TOL from the run's baseline. The checkpoint at this
    cut was NOT stamped."""


def _registry_of(registry: Optional[_metrics.Registry]
                 ) -> _metrics.Registry:
    return registry if registry is not None else _metrics.REGISTRY


def _counter(name: str, registry: Optional[_metrics.Registry] = None):
    return _registry_of(registry).counter(name)


def _ops_sha(ops) -> str:
    """Value fingerprint of a circuit's op stream — kinds, qubits AND
    operand bytes. The cursor's op COUNT alone cannot catch an edited
    rotation angle (same count, same plan shape, different program);
    resuming across one would splice two different circuits' amplitude
    prefixes silently."""
    h = hashlib.sha256()
    for op in ops:
        h.update(repr((op.kind, op.targets, op.controls,
                       op.cstates)).encode())
        if op.operand is not None:
            try:
                h.update(np.asarray(op.operand).tobytes())
            except Exception:       # nested structures (classical ops)
                h.update(repr(op.operand).encode())
    return h.hexdigest()[:32]



def _plans_align(items, planned) -> bool:
    """STRUCTURAL equality of the comm planner's item list and the
    attribution re-plan — length alone could mask a same-length plan
    that composes ops differently (under-counting ops_done by one and
    double-applying a gate on elastic resume). Both lists wrap the SAME
    flat-stream op objects, so exposed ops compare by identity; band
    items compare by geometry + the qubit sets that drove composition."""
    if len(items) != len(planned):
        return False
    for a, b in zip(items, planned):
        if type(a) is not type(b):
            return False
        if getattr(a, "op", None) is not getattr(b, "op", None):
            return False
        if (getattr(a, "ql", None) != getattr(b, "ql", None)
                or getattr(a, "w", None) != getattr(b, "w", None)
                or getattr(a, "nondiag", None) != getattr(b, "nondiag",
                                                          None)
                or getattr(a, "touched", None) != getattr(b, "touched",
                                                          None)):
            return False
    return True


def _boundary_ops_done(flat_used, step_attr, exec_items,
                       num_steps: int) -> List[Optional[int]]:
    """ops_done_at[b] for every step boundary b in [0, num_steps]: the
    number of CANONICAL (scheduled-stream) ops fully consumed by steps
    [0, b) when that boundary is PORTABLE — the consumed ops form an
    exact prefix of the canonical stream, nothing straddles the cut,
    and every relabel-pass-inserted layout op before it is VISIBLE to
    the perm replay (an inserted SWAP the planner composed into a band
    operator moves data replay_perm cannot see — canonicalization would
    be wrong from that step on) — else None. Boundary 0 is always
    portable (restart from op 0). `step_attr` is the per-step flat-op
    attribution (None = attribution unavailable: only boundary 0
    stays portable)."""
    from quest_tpu_torch.parallel import relabel as R

    out: List[Optional[int]] = [0]
    if step_attr is None:
        return out + [None] * num_steps
    nflat = len(flat_used)
    canon_of: List[Optional[int]] = []
    m = 0
    for op in flat_used:
        if R.is_inserted_layout_op(op):
            canon_of.append(None)
        else:
            canon_of.append(m)
            m += 1
    first = [num_steps] * nflat
    last = [-1] * nflat
    poison = num_steps + 1
    for k, srcs in enumerate(step_attr):
        for p in srcs:
            first[p] = min(first[p], k)
            last[p] = max(last[p], k)
            if canon_of[p] is None and exec_items is not None:
                # layout ops must ride op-exposing items (PassOp for
                # relabel events, DiagItem never): a band-composed one
                # is invisible to the perm replay — poison every
                # boundary past its item
                if getattr(exec_items[k], "op", None) is not flat_used[p]:
                    poison = min(poison, k)
    canon_total = m
    for b in range(1, num_steps + 1):
        if b > poison:
            out.append(None)
            continue
        done = 0
        hi = -1
        ok = True
        for p in range(nflat):
            consumed = last[p] < b and last[p] >= 0
            touched = first[p] < b
            if consumed != touched:
                ok = False          # an op straddles the cut
                break
            if consumed and canon_of[p] is not None:
                done += 1
                hi = max(hi, canon_of[p])
        # prefix check: the consumed canonical ops must be exactly
        # 0..done-1 of the scheduled stream
        if ok and hi == done - 1:
            out.append(done)
        else:
            out.append(None)
    # a fully-consumed plan must land on the full canonical count —
    # anything else means attribution lost ops; degrade loudly-safe
    if out[num_steps] is not None and out[num_steps] != canon_total:
        out[num_steps] = None
    return out



def _logical_shape(state: Qureg) -> tuple:
    return (2, state.num_amps)


def _state_fingerprint(state: Qureg) -> str:
    """Value fingerprint of the INITIAL register, stored in the cursor
    and re-derived at resume from the caller's own argument (ref :104):
    small registers hash every amplitude, large ones the shape, dtype and
    the first 4096 amplitudes of each plane (which shard 0 holds)."""
    amps = state.amps
    rdt = precision.numpy_dtype(amps.dtype)
    h = hashlib.sha256()
    h.update(repr((_logical_shape(state), str(rdt))).encode())
    if state.num_amps * 2 <= (1 << 22):
        payload = ckpt._host_planes(amps)
    elif torch.is_tensor(amps):
        payload = amps.detach().reshape(2, -1)[:, :4096].cpu().numpy()
    else:
        payload = amps.views()[0][:, :4096].detach().cpu().numpy()
    h.update(memoryview(np.ascontiguousarray(payload)).cast("B"))
    return h.hexdigest()[:32]


def _state_fingerprint_gang(state: Qureg, mesh) -> str:
    """Fingerprint of the initial register of a gang run (ref :167): the
    cursor must be equal on every process, and no process reads its
    peers' shards, so instead of bytes it hashes the shape, the dtype and
    three reductions (sum, sum of squares, max magnitude) taken per shard
    of `mesh` in f64 and combined in shard order, whether `state` holds
    one tensor or shards over the process mesh: every process computes
    the same value."""
    amps = state.amps
    D = mesh.size
    rdt = precision.numpy_dtype(amps.dtype)
    stats = torch.zeros((D, 3), dtype=torch.float64)
    if torch.is_tensor(amps):
        flat = amps.detach().reshape(2, -1)
        m = flat.shape[1] // D
        chunks = [(d, flat[:, d * m:(d + 1) * m]) for d in range(D)]
    else:
        chunks = [(d, v) for d, v in enumerate(amps.views()) if v is not None]
    for d, v in chunks:
        x = v.to(torch.float64)
        stats[d] = torch.stack([x.sum(), (x * x).sum(),
                                x.abs().max()]).cpu()
    if not torch.is_tensor(amps):
        stats = amps.mesh.host_all_reduce(stats)
    vals = [float(stats[:, 0].sum()), float(stats[:, 1].sum()),
            float(stats[:, 2].max())]
    h = hashlib.sha256()
    h.update(repr(((_logical_shape(state), str(rdt)), vals)).encode())
    return h.hexdigest()[:32]


_MOD = 1 << 32


def _bit_sums(words: torch.Tensor, offset: int) -> Tuple[int, int]:
    """(sum w, sum w (i + 1)) mod 2^32 of uint32 words (as int64 in
    [0, 2^32)) at flat positions offset, offset + 1, ...; int64-exact."""
    s1 = int(words.sum().item()) % _MOD
    idx = torch.arange(offset + 1, offset + 1 + words.numel(),
                       dtype=torch.int64, device=words.device) % _MOD
    hi, lo = words >> 16, words & 0xFFFF
    term = ((hi * idx) % _MOD * 65536 + lo * idx) % _MOD
    return s1, int(term.sum().item()) % _MOD


def _state_fingerprint_elastic(state: Qureg) -> str:
    """MESH-INDEPENDENT exact fingerprint of the initial register (ref
    :125): the raw amplitude bits as uint32 words in the flat order of
    the (2, 2^n) planes, a plain and an index-weighted sum mod 2^32, so
    the value is bit-equal on any layout holding the same amplitudes,
    and equal to the reference's for the same planes."""
    amps = state.amps
    rdt = precision.numpy_dtype(amps.dtype)
    wpe = rdt.itemsize // 4               # uint32 words an element
    num = state.num_amps
    if torch.is_tensor(amps):
        pieces = [(amps.detach().reshape(2, -1)[p], p * num)
                  for p in (0, 1)]
    else:
        m = 1 << amps.local_n
        pieces = [(v[p], p * num + d * m)
                  for p in (0, 1) for d, v in enumerate(amps.views())
                  if v is not None]
    s1 = s2 = 0
    chunk = 1 << 22
    for plane, start in pieces:
        flat = plane.detach().contiguous().reshape(-1)
        for a in range(0, flat.numel(), chunk):
            part = flat[a:a + chunk]
            words = part.view(torch.int32).to(torch.int64) % _MOD
            t1, t2 = _bit_sums(words, (start + a) * wpe)
            s1, s2 = (s1 + t1) % _MOD, (s2 + t2) % _MOD
    if not torch.is_tensor(amps):
        # the sums mod 2^32 of every process's pieces: exact in int64
        tot = amps.mesh.host_all_reduce(torch.tensor([s1, s2],
                                                     dtype=torch.int64))
        s1, s2 = int(tot[0]) % _MOD, int(tot[1]) % _MOD
    key = (_logical_shape(state), str(rdt))
    h = hashlib.sha256()
    h.update(repr((key, [s1, s2])).encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# step plans: the circuit cut at launch boundaries, per engine
# ---------------------------------------------------------------------------


def _resolve_state_engine(engine, n: int, is_f32: bool, mesh) -> str:
    from quest_tpu_torch.ops import band_plan as BP
    if mesh is not None:
        if engine not in (None, "sharded"):
            raise ValueError(
                f"engine {engine!r} does not take a mesh; pass "
                f"engine='sharded' (or None) with mesh=")
        return "sharded"
    if engine == "sharded":
        raise ValueError("engine='sharded' requires mesh=")
    if engine not in (None, "fused", "banded"):
        raise ValueError(
            f"engine must be None, 'fused', 'banded' or 'sharded', "
            f"got {engine!r}")
    if engine in (None, "fused") and BP.usable(n) and is_f32:
        return "fused"
    # compiled_fused's own fallback: f64 planes and registers below the
    # kernel's 10 qubits ride the banded program
    return "banded"


def _part_ranges(counts: List[int]) -> List[Tuple[int, int]]:
    out, at = [], 0
    for c in counts:
        out.append((at, at + c))
        at += c
    return out


def _steps_attr(item_attr, ranges):
    """Per-step flat-op attribution: the union of its items' sets, or
    None when the attribution does not cover the steps' items."""
    if item_attr is None or (ranges and ranges[-1][1] != len(item_attr)):
        return None
    return [frozenset().union(*item_attr[a:b]) if b > a else frozenset()
            for a, b in ranges]


def _build_steps(circuit, n: int, density: bool, engine: str, mesh,
                 device, is_f32: bool) -> Tuple[List, dict]:
    """(steps, info) of one engine's durable plan: `steps` the per-step
    programs (each takes the engine's amps and updates them in place),
    `info` the plan fingerprint the cursor validates against. Cached on
    the circuit, so a resume in a warm process builds nothing."""
    from quest_tpu_torch.circuit import (_apply_item, _device_key,
                                         _engine_mode_key)
    from quest_tpu_torch.ops import band_plan as BP
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.ops.segment import Segment, segment_sweep

    key = ("durable", engine, n, density, bool(is_f32),
           mesh.key if mesh is not None else _device_key(device),
           len(circuit.ops), _engine_mode_key())
    cached = circuit._compiled.get(key)
    if cached is not None:
        return cached

    perm_items = None
    devices = 1
    exec_items = None
    if engine == "fused":
        prog = circuit.compiled_fused(n, density, device=device)
        flat = circuit._planned_flat(n, density)
        item_attr: list = []
        F.plan(flat, n, bands=BP.plan_bands(n), attr=item_attr)
        steps = []
        counts = []
        for st in prog.steps:
            if isinstance(st, Segment):
                steps.append(lambda a, st=st: segment_sweep(a, st))
                counts.append(len(st.stages))
            else:
                steps.append(st)
                counts.append(1)
        ranges = _part_ranges(counts)
        step_attr = _steps_attr(item_attr, ranges)
        layout = "fused"
        flat_used = flat
    elif engine == "banded":
        tier = precision.matmul_precision()
        precision.ieee_fp32()
        flat = circuit._planned_flat(n, density)
        item_attr = []
        items = F.plan(flat, n, attr=item_attr)
        steps = [lambda a, it=it: _apply_item(a, n, it, tier)
                 for it in items]
        step_attr = item_attr
        layout = "flat"
        flat_used, exec_items = flat, items
    else:                                   # sharded
        from quest_tpu_torch.env import knob_value
        from quest_tpu_torch.parallel import comm as C
        from quest_tpu_torch.parallel import sharded as S
        devices = mesh.size
        local_n = n - mesh.global_qubits
        fused_bands = S.fused_shard_bands(n, local_n)
        use_parts = is_f32 and fused_bands is not None
        bands = fused_bands if use_parts else S._shard_bands(n, local_n)
        cinfo: dict = {}
        flat_r = S.engine_flat(circuit.ops, n, density, local_n,
                               bands=bands, comm_info=cinfo,
                               topo=C.topology(devices, mesh))
        item_attr = []
        planned = F.plan(flat_r, n, bands=bands, attr=item_attr)
        items = cinfo.get("items")
        if items is None:
            items = planned
        elif not _plans_align(items, planned):
            # the comm planner's plan is not the attribution re-plan:
            # the elastic boundary map degrades to "op 0 only"
            item_attr = None
        if use_parts:
            tier = S._tier()
            driver = BP.active_driver()
            parts = S.plan_fused_parts(items, local_n, driver)
            prog = S.ShardedProgram(
                "fused", mesh, n, items, tier, parts=parts, driver=driver,
                nbuf=knob_value("QUEST_FUSED_NBUF"), comm_info=cinfo)
            steps = [lambda a, i=i: prog.run_part(i, a)
                     for i in range(len(parts))]
            counts = [len(p[1]) if p[0] == "segment" else 1 for p in parts]
            exec_items = [p[1] if p[0] != "segment" else None
                          for p in parts]
        else:
            steps = [S.compile_plan_items_sharded((it,), n, mesh)
                     for it in items]
            counts = [1] * len(items)
            exec_items = list(items)
        ranges = _part_ranges(counts)
        step_attr = _steps_attr(item_attr, ranges)
        layout = "sharded"
        flat_used = flat_r
        # the GateOp stream behind the items before every step boundary:
        # what relabel.replay_perm fingerprints (band-composed ops expose
        # no op; relabel events and explicit SWAPs do)
        acc: list = []
        before = []
        for it in items:
            before.append(tuple(acc))
            op = getattr(it, "op", None)
            if op is not None:
                acc.append(op)
        before.append(tuple(acc))
        perm_items = [before[a] for a, _ in ranges] + [before[-1]]

    layout_perms = None
    if engine == "sharded" and step_attr is not None:
        layout_perms = _layout_perms(flat_used, step_attr, n,
                                     n - mesh.global_qubits)
    sched = circuit._planned_flat(n, density)
    ops_done_at = _boundary_ops_done(flat_used, step_attr, exec_items,
                                     len(steps))
    info = {
        "engine": engine,
        "n": n,
        "density": density,
        "num_steps": len(steps),
        "mode_key": repr(_engine_mode_key()),
        "circuit_ops": len(circuit.ops),
        "layout": layout,
        "devices": devices,
        "mesh": mesh,
        "device": device,
        "perm_ops": perm_items,
        "layout_perms": layout_perms,
        "sched_sha": _ops_sha(sched),
        "ops_total": len(sched),
        "ops_done_at": ops_done_at,
    }
    circuit._compiled[key] = (steps, info)
    return steps, info


def _layout_perms(flat, step_attr, n: int, local_n: int):
    """The physical layout at every step boundary: the permutation the
    inserted layout ops (relabel events, pass-inserted SWAPs) consumed
    by the steps before it have made, in flat order, those the planner
    composed into band operators included (replay_perm cannot see
    those; it fingerprints the cursor, this locates the diagonal for the
    density sentinels)."""
    from quest_tpu_torch.parallel import relabel as R
    out = []
    consumed: set = set()
    for b in range(len(step_attr) + 1):
        if b:
            consumed |= set(step_attr[b - 1])
        tr = R._PermTracker(n, local_n, [])
        for i in sorted(consumed):
            op = flat[i]
            if not R.is_inserted_layout_op(op):
                continue
            if op.kind == "relabel":
                tr.emit_relabel(op.operand)
            else:
                tr.emit_swap(*op.targets)
        out.append(list(tr.perm))
    return out


def _sentinel_perm(info: dict, step: int):
    """The physical layout the sentinels read the state in at `step`."""
    perms = info.get("layout_perms")
    return perms[step] if perms is not None else _cut_perm(info, step)


def _cut_perm(info: dict, step: int) -> Optional[List[int]]:
    """The relabel permutation at cut `step` (sharded engine only): which
    logical qubit sits at which physical position once the first `step`
    steps have run."""
    if info["engine"] != "sharded":
        return None
    from quest_tpu_torch.parallel import relabel as R
    local_n = info["n"] - (info["devices"].bit_length() - 1)
    return R.replay_perm(info["perm_ops"][step], info["n"], local_n)


# ---------------------------------------------------------------------------
# layouts: host planes <-> each engine's amps
# ---------------------------------------------------------------------------


def _to_layout(planes, info: dict):
    """The engine's amps holding `planes` (host (2, 2^n) planes, a
    tensor, or a sharded register's ShardedAmps): a new buffer the steps
    may update in place."""
    from quest_tpu_torch.parallel.mesh import ShardedAmps, shard_planes
    if isinstance(planes, np.ndarray):
        planes = torch.from_numpy(np.ascontiguousarray(planes))
    if info["layout"] == "sharded":
        if isinstance(planes, ShardedAmps):
            if planes.mesh.key == info["mesh"].key:
                return planes.clone()
            planes = planes.gather("cpu")
        return shard_planes(planes.reshape(2, -1), info["mesh"], info["n"])
    if isinstance(planes, ShardedAmps):
        # a sharded register entering a one-register engine
        return planes.gather(info["device"]).reshape(2, -1)
    return planes.reshape(2, -1).to(info["device"], copy=True)


def _sync(amps) -> None:
    devs = ([s.device for _, s in amps.local()] if not torch.is_tensor(amps)
            else [amps.device])
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# corruption sentinels: cheap invariants at checkpoint cadence
# ---------------------------------------------------------------------------


def _herm_block(re: torch.Tensor, im: torch.Tensor) -> float:
    """max(|re - re^T|, |im + im^T|) of a square block, a row band at a
    time."""
    worst = 0.0
    k = re.shape[0]
    step = max(1, (1 << 24) // max(k, 1))
    for a in range(0, k, step):
        b = min(k, a + step)
        worst = max(worst,
                    float((re[a:b] - re[:, a:b].T).abs().max()),
                    float((im[a:b] + im[:, a:b].T).abs().max()))
    return worst


def _density_shard_sentinel(v: torch.Tensor, d: int, nq: int, perm,
                            chunk: int = 1 << 22):
    """Shard d's part of a sharded density register's invariants: (its
    f64 (Re, Im) partial trace, its Hermiticity residual over the entries
    whose transposed partner it also holds). The shard holds physical
    indices [d m, (d+1) m); logical qubit l sits at physical position
    perm[l] (the identity without relabeling), so an entry is diagonal
    where the physical bits of each row qubit and its column copy agree,
    and its transpose swaps those bits."""
    m = v.shape[1]
    perm = list(perm) if perm else list(range(2 * nq))
    tr = torch.zeros(2, dtype=torch.float64, device=v.device)
    herm = 0.0
    for a0 in range(0, m, chunk):
        p = torch.arange(d * m + a0, d * m + min(m, a0 + chunk),
                         dtype=torch.int64, device=v.device)
        diag = torch.ones_like(p, dtype=torch.bool)
        partner = p.clone()
        for lq in range(nq):
            a, b = perm[lq], perm[lq + nq]
            ba, bb = (p >> a) & 1, (p >> b) & 1
            diag &= ba == bb
            flip = ba ^ bb
            partner ^= (flip << a) | (flip << b)
        re, im = v[0, a0:a0 + p.numel()], v[1, a0:a0 + p.numel()]
        tr += torch.stack([re[diag].to(torch.float64).sum(),
                           im[diag].to(torch.float64).sum()])
        mine = (partner >= d * m) & (partner < (d + 1) * m)
        idx = partner[mine] - d * m
        if idx.numel():
            herm = max(herm,
                       float((re[mine] - v[0][idx]).abs().max()),
                       float((im[mine] + v[1][idx]).abs().max()))
    return tr, herm


def _sentinel_values(amps, info: dict, perm=None) -> dict:
    """The state's invariants as host floats (ref :486): the norm of a
    statevector (f64 partials), the trace and the Hermiticity residual of
    a density register; on a mesh each shard's partial (its residual over
    the transposed pairs it holds, `perm` the relabel permutation of the
    physical layout) and one reduce. NaN anywhere fails every
    comparison."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch.parallel import eager as SE
    sharded = not torch.is_tensor(amps)
    if not info["density"]:
        if sharded:
            val = float(amps.mesh.reduce([None if s is None else
                                          SE._sum_sq(s)
                                          for s in amps.shards]))
        else:
            val = K._sum_sq(amps)
        return {"norm": val}
    nq = info["n"] // 2
    dim = 1 << nq
    if not sharded:
        v = amps.reshape(2, dim, dim)          # v[plane, c, r]
        tr_re = float(v[0].diagonal().to(torch.float64).sum())
        tr_im = float(v[1].diagonal().to(torch.float64).sum())
        return {"trace_re": tr_re, "trace_im": tr_im,
                "herm_residual": _herm_block(v[0], v[1])}
    parts, herm = [None] * amps.mesh.size, 0.0
    for d, v in enumerate(amps.views()):
        if v is None:
            continue
        tr, h = _density_shard_sentinel(v, d, nq, perm)
        parts[d] = tr
        herm = max(herm, h)
    tr = amps.mesh.reduce(parts)
    if amps.mesh.world > 1:
        herm = float(amps.mesh.host_all_reduce(
            torch.tensor(herm, dtype=torch.float64), "max"))
    return {"trace_re": float(tr[0]), "trace_im": float(tr[1]),
            "herm_residual": herm}


def _cut_values(amps, info: dict, step: int, tol: float) -> dict:
    """The sentinel values to hold at an intermediate cut. A density cut
    may fall between a gate and its column-space dual (their items are
    separate launches when the dual's qubits lie in another band or on
    a global qubit): the state there is U rho, neither Hermitian nor of
    unit trace, so only its finiteness is checked; every other cut, and
    the run's final state, is held to the baseline whole."""
    vals = _sentinel_values(amps, info, _sentinel_perm(info, step))
    if (info["density"] and all(np.isfinite(v) for v in vals.values())
            and vals["herm_residual"] > tol):
        return {}
    return vals


def _check_integrity(vals: dict, baseline: dict, tol: float,
                     step, registry=None) -> None:
    for name, got in vals.items():
        ref = float(baseline.get(name, 0.0))
        # relative drift with a floor of 1: registers need not be
        # normalized (init_debug_state is not), so the budget scales
        # with the invariant's own magnitude and becomes absolute for
        # unit-scale invariants (norm/trace of normalized states)
        drift = abs(got - ref) / max(1.0, abs(ref))
        if not (drift <= tol):           # NaN-safe: NaN fails the <=
            _counter("durable_sentinel_trips", registry).inc()
            raise IntegrityError(
                f"Integrity sentinel tripped at step {step}: {name} = "
                f"{got!r}, baseline {ref!r}, drift beyond the "
                f"QUEST_INTEGRITY_TOL budget {tol} — the state is "
                f"corrupt (NaN poisoning or a bad plane); REFUSING to "
                f"stamp a checkpoint from it")



def _validate_cursor(cursor: dict, want: dict, path: str) -> None:
    """Every field of the re-derived plan must match the checkpointed
    cursor — resuming across a drifted plan would run the wrong program
    suffix over the cut amplitudes. Raises DurableError naming the
    first mismatching field."""
    for field, expect in want.items():
        got = cursor.get(field)
        if got != expect:
            raise DurableError(
                f"Invalid durable resume: checkpoint {path!r} was cut "
                f"under {field}={got!r}, but this process would execute "
                f"{field}={expect!r} — a keyed knob flip or circuit "
                f"change between save and resume; finish the run under "
                f"the original configuration (or clear the checkpoint "
                f"directory to restart from op 0)")



def _latest_valid(directory: str, kind: str, registry=None):
    """Newest checkpoint under `directory` that loads AND digests
    cleanly, scanning newest -> oldest: corrupt or unreadable entries
    are skipped LOUDLY (stderr + counter) in favor of older ones —
    never silently consumed. Returns (meta, arrays, cursor, path) or
    None when no valid checkpoint exists (the run restarts from op
    0). A GANG-format step (written by a multi-process run) is a typed
    mesh mismatch, not corruption: restarting from op 0 over a valid
    gang chain would silently discard it."""
    for step, path in reversed(ckpt.step_dirs(directory)):
        if ckpt.is_gang_step(path):
            raise DurableError(
                f"Invalid durable resume: checkpoint {path!r} was "
                f"written by a multi-host gang run; resume it on the "
                f"same mesh, or pass elastic=True to re-enter it on "
                f"this one")
        try:
            meta, arrays = ckpt.load_arrays(path, require=("planes",))
            cursor = meta.get("extra")
            if not isinstance(cursor, dict) or cursor.get("kind") != kind:
                raise ckpt.CheckpointError(
                    f"Invalid checkpoint: {path!r} carries no "
                    f"{kind!r} durable cursor")
            # belt to the meta self-digest's suspenders: the cursor's
            # cut index must agree with the committed directory name (a
            # save-side bug writing the wrong step would pass digests)
            cut = cursor.get("step", cursor.get("shots_done"))
            if int(cut) != step:
                raise ckpt.CheckpointError(
                    f"Invalid checkpoint: {path!r} carries cursor cut "
                    f"{cut!r}, directory name says {step}")
        except (ckpt.CheckpointError, OSError, TypeError, ValueError,
                faults.InjectedFault) as e:
            # TypeError/ValueError: a parseable-but-malformed cursor
            # (e.g. no 'step' field) is corruption, not a crash — the
            # scan's contract is skip-loudly-to-older
            # InjectedFault: the checkpoint.load site's default error —
            # its documented contract is that the resume chain SKIPS to
            # an older checkpoint, so the injected failure must prove
            # the fallback, not take the run down
            _counter("durable_corrupt_checkpoints_skipped",
                     registry).inc()
            print(f"[durable] SKIPPING corrupt checkpoint {path!r} "
                  f"({e}); falling back to the previous one",
                  file=sys.stderr, flush=True)
            continue
        return meta, arrays, cursor, path
    return None



def _latest_valid_gang(directory: str, kind: str, registry=None):
    """Gang counterpart of _latest_valid (ref :612): the newest committed
    gang checkpoint whose every shard digests cleanly and whose
    per-process cursors agree. Validity is a function of the shared
    directory alone (load_step_gang verifies every shard on every
    process), so every process lands on the same checkpoint: a mid-save
    kill left its step uncommitted, and corruption anywhere skips the
    whole gang to the same older cut. A plain step (written by a
    one-process run) is refused typed. Returns (cursor, planes, path) or
    None."""
    import os
    for step, path in reversed(ckpt.step_dirs(directory)):
        if os.path.exists(os.path.join(path, ckpt._META_NAME)):
            raise DurableError(
                f"Invalid durable resume: checkpoint {path!r} was "
                f"written by a single-process run, but this is a "
                f"multi-host gang resume; resume it on the writing "
                f"mesh, or pass elastic=True to re-enter it on this "
                f"one")
        try:
            metas, planes = ckpt.load_step_gang(path, kind_extra=kind)
            cursor = metas[0].get("extra")
            cut = cursor.get("step")
            if int(cut) != step:
                raise ckpt.CheckpointError(
                    f"Invalid checkpoint: {path!r} carries cursor cut "
                    f"{cut!r}, directory name says {step}")
        except (ckpt.CheckpointError, OSError, TypeError, ValueError,
                faults.InjectedFault) as e:
            _counter("durable_corrupt_checkpoints_skipped",
                     registry).inc()
            print(f"[durable] SKIPPING corrupt gang checkpoint {path!r} "
                  f"({e}); falling back to the previous one",
                  file=sys.stderr, flush=True)
            continue
        return cursor, planes, path
    return None


def _iter_valid_elastic(directory: str, registry=None):
    """The scan of an ELASTIC resume: yields every step checkpoint, plain
    (canonical or, from older chains, physical layout) or gang, that
    loads and digests cleanly, newest first, in CANONICAL LOGICAL ORDER
    via checkpoint.load_step_elastic. Corrupt or unreadable entries skip
    loudly to older ones, exactly like the strict scanners; the caller
    advances past entries the target plan cannot re-enter. Yields
    (cursor, canonical_planes, path)."""
    for step, path in reversed(ckpt.step_dirs(directory)):
        try:
            cursor, planes = ckpt.load_step_elastic(path)
            cut = cursor.get("step")
            if int(cut) != step:
                raise ckpt.CheckpointError(
                    f"Invalid checkpoint: {path!r} carries cursor cut "
                    f"{cut!r}, directory name says {step}")
        except (ckpt.CheckpointError, OSError, TypeError, ValueError,
                faults.InjectedFault) as e:
            # TypeError/ValueError: a parseable-but-malformed cursor
            # (e.g. no 'step' field) is corruption, not a crash — the
            # scan's contract is skip-loudly-to-older
            _counter("durable_corrupt_checkpoints_skipped",
                     registry).inc()
            print(f"[durable] SKIPPING corrupt checkpoint {path!r} "
                  f"({e}); falling back to the previous one",
                  file=sys.stderr, flush=True)
            continue
        yield cursor, planes, path



def _clear_chain(directory: str) -> None:
    """A COMPLETED run consumes its resume chain: the checkpoints exist
    to finish this run, and leaving them would make a later run over
    the same directory resume mid-circuit with a different initial
    state."""
    import shutil
    for _, path in ckpt.step_dirs(directory):
        shutil.rmtree(path, ignore_errors=True)
    ckpt.sweep_stale(directory)


def _enter_elastic(want, elastic_want, cursor_extra, info, state,
                   directory: str, registry=None):
    """Elastic re-entry (ref :651): walk the chain newest to oldest and
    re-enter the first checkpoint this plan can continue. A mismatched
    sched_sha, state_efp, dtype, density or ops_total (or cursor_extra)
    raises DurableError; a cursor without sched_sha falls back to the
    strict validation; a cut with no portable boundary in this plan
    skips LOUDLY to an older checkpoint (op 0 is always portable).
    Returns (start step, amps, baseline) or None."""
    from quest_tpu_torch.parallel import relabel as R

    for cursor, canon, path in _iter_valid_elastic(directory, registry):
        if "sched_sha" not in cursor:
            _validate_cursor(cursor, want, path)
            step = int(cursor["step"])
            perm = _cut_perm(info, step)
            _validate_cursor(cursor, {"perm": perm}, path)
            b = step
        else:
            _validate_cursor(cursor, elastic_want, path)
            if cursor_extra:
                _validate_cursor(cursor, cursor_extra, path)
            m = cursor.get("ops_done")
            b = (info["ops_done_at"].index(m)
                 if m is not None and m in info["ops_done_at"] else None)
            if b is None:
                print(f"[durable] checkpoint {path!r} cut at canonical op "
                      f"{m!r} has no portable boundary in this plan; "
                      f"falling back to an older checkpoint",
                      file=sys.stderr, flush=True)
                continue
            perm = _cut_perm(info, b)
        want_shape = (2, state.num_amps)
        if tuple(canon.shape) != want_shape:
            raise DurableError(
                f"Invalid durable resume: checkpoint {path!r} holds planes "
                f"of shape {tuple(canon.shape)}, register expects "
                f"{want_shape}")
        planes = np.asarray(canon).astype(state.real_dtype)
        if perm:
            planes = R.physicalize_planes(planes, perm)
        _counter("durable_resumes", registry).inc()
        if (cursor.get("devices") != info["devices"]
                or cursor.get("engine") != info["engine"]):
            _counter("durable_elastic_resumes", registry).inc()
        return b, _to_layout(planes, info), cursor.get("baseline")
    return None


# ---------------------------------------------------------------------------
# the durable executor: state engines
# ---------------------------------------------------------------------------


def run_durable(circuit, state: Qureg, directory: str, *,
                every: int = None, engine: str = None, mesh=None,
                keep: int = None, elastic: Optional[bool] = None,
                cursor_extra: Optional[dict] = None,
                registry: Optional[_metrics.Registry] = None) -> Qureg:
    """Apply `circuit` to `state` durably (ref :731): run the engine's
    own launch plan step by step, checkpoint planes and cursor every
    `every` steps (default QUEST_DURABLE_EVERY) under `directory`, and
    RESUME from the newest valid checkpoint there instead of op 0. The
    final register is bit-identical to an uninterrupted run whatever mix
    of preemptions, mid-save crashes and corrupt checkpoints came
    between. `state` is left as it was; the result is a new register
    (sharded over `mesh` on the sharded engine).

    engine: None takes 'fused' for an f32 register of at least the
    kernel's 10 qubits and 'banded' otherwise; `mesh` (a
    parallel.AmpMesh) selects 'sharded'. A sharded `state` without mesh=
    runs on its own mesh. `keep` overrides QUEST_CHECKPOINT_KEEP;
    `elastic` (default QUEST_DURABLE_ELASTIC) lets a chain written on
    another mesh or engine re-enter this one; `cursor_extra` adds
    JSON-serializable workload fields to every cursor, validated at
    resume like the plan fields; `registry` redirects the metrics. A
    completed run removes its checkpoint chain."""
    from quest_tpu_torch.env import knob_value
    from quest_tpu_torch.parallel.mesh import ShardedAmps

    if circuit.num_qubits != state.num_qubits:
        raise ValueError("circuit/register size mismatch")
    circuit._reject_measure("run_durable")
    faults.install_from_env()
    if mesh is None and isinstance(state.amps, ShardedAmps) \
            and engine in (None, "sharded"):
        mesh = state.amps.mesh
    n = state.num_state_qubits
    density = state.is_density
    every = int(every) if every is not None else knob_value(
        "QUEST_DURABLE_EVERY")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    is_f32 = state.real_dtype == np.dtype(np.float32)
    engine = _resolve_state_engine(engine, n, is_f32, mesh)
    device = (mesh.local_devices[0] if mesh is not None
              else state.amps.device)
    steps, info = _build_steps(circuit, n, density, engine, mesh, device,
                               is_f32)
    integrity = knob_value("QUEST_INTEGRITY")
    tol = knob_value("QUEST_INTEGRITY_TOL")
    if elastic is None:
        elastic = bool(knob_value("QUEST_DURABLE_ELASTIC"))
    # gang mode: one gang-consistent checkpoint a cut across the mesh's
    # processes, its cursor fields equal on every process
    gang = mesh is not None and mesh.world > 1

    want = {
        "engine": engine,
        # the reference's field: the port has no interpret mode
        "interpret": False,
        "devices": info["devices"],
        "num_steps": info["num_steps"],
        "mode_key": info["mode_key"],
        "circuit_ops": info["circuit_ops"],
        "plan_sha": _ops_sha(circuit.ops),
        "state_fp": (_state_fingerprint_gang(state, mesh) if gang
                     else _state_fingerprint(state)),
    }
    elastic_want = {
        "sched_sha": info["sched_sha"],
        "ops_total": info["ops_total"],
        "state_efp": _state_fingerprint_elastic(state),
        "dtype": str(state.real_dtype),
        "density": density,
    }
    if cursor_extra:
        reserved = (set(want) | set(elastic_want)
                    | {"kind", "step", "perm", "baseline", "layout",
                       "ops_done"})
        overlap = set(cursor_extra) & reserved
        if overlap:
            raise ValueError(
                f"cursor_extra may not shadow reserved cursor fields "
                f"{sorted(overlap)}")
        want.update(cursor_extra)
    start, baseline = 0, None
    resume = None
    if elastic:
        resume = _enter_elastic(want, elastic_want, cursor_extra, info,
                                state, directory, registry)
        if resume is not None:
            start, amps, baseline = resume
    else:
        found = (_latest_valid_gang(directory, "state", registry) if gang
                 else _latest_valid(directory, "state", registry))
        if found is not None:
            if gang:
                cursor, planes, path = found
            else:
                meta, arrays, cursor, path = found
                planes = arrays["planes"]
            _validate_cursor(cursor, want, path)
            step = int(cursor["step"])
            perm = _cut_perm(info, step)
            _validate_cursor(cursor, {"perm": perm}, path)
            if tuple(planes.shape) != (2, state.num_amps):
                raise DurableError(
                    f"Invalid durable resume: checkpoint {path!r} holds "
                    f"planes of shape {tuple(planes.shape)}, register "
                    f"expects {(2, state.num_amps)}")
            if cursor.get("layout") == "canonical" and perm:
                from quest_tpu_torch.parallel import relabel as R
                planes = R.physicalize_planes(np.asarray(planes), perm)
            amps = _to_layout(planes.astype(state.real_dtype), info)
            start = step
            baseline = cursor.get("baseline")
            resume = True
            _counter("durable_resumes", registry).inc()
    if resume is None:
        amps = _to_layout(state.amps, info)
    if baseline is None and integrity:
        baseline = _sentinel_values(amps, info, _sentinel_perm(info, start))

    for i in range(start, len(steps)):
        if faults.ACTIVE:
            faults.check("durable.step", step=i, engine=engine)
            faults.check("durable.preempt", step=i, engine=engine)
        amps = steps[i](amps)
        _counter("durable_steps_run", registry).inc()
        done = i + 1
        if done % every == 0 and done < len(steps):
            # drain the queued steps before the timer, so the checkpoint's
            # cost is its own
            _sync(amps)
            t0 = _time.perf_counter()
            perm_cut = _cut_perm(info, done)
            if integrity:
                _check_integrity(_cut_values(amps, info, done, tol),
                                 baseline, tol, done, registry)
            cursor = dict(want, **elastic_want, kind="state", step=done,
                          perm=perm_cut, baseline=baseline,
                          ops_done=info["ops_done_at"][done],
                          layout="physical" if gang else "canonical")
            stamped = True
            if gang:
                # gang shards stay in the physical layout (no process
                # holds its peers' canonical columns); the perm in the
                # digested cursor makes the step's meaning
                # writer-independent (load_step_elastic normalizes)
                committed = ckpt.save_step_gang(
                    directory, done, qureg=state.replace_amps(amps),
                    extra=cursor, keep=keep)
                # a save a killed peer never stamped is not a saved
                # checkpoint (a slower peer's commit counts there)
                import os
                stamped = (committed is not None
                           or os.path.isdir(ckpt.step_path(directory, done)))
            else:
                # canonical logical order before digesting: the file's
                # meaning does not depend on the writer's relabel history
                # (an exact index permutation, undone bit for bit at a
                # strict resume)
                planes_np = ckpt._host_planes(amps)
                if perm_cut:
                    from quest_tpu_torch.parallel import relabel as R
                    planes_np = R.canonicalize_planes(planes_np, perm_cut)
                ckpt.save_step(directory, done,
                               qureg=Qureg(amps=planes_np,
                                           num_qubits=state.num_qubits,
                                           is_density=state.is_density),
                               extra=cursor, keep=keep)
            if stamped:
                _counter("durable_checkpoints_saved", registry).inc()
                _registry_of(registry).gauge(
                    "durable_last_checkpoint_step").set(done)
            _registry_of(registry).histogram("durable_checkpoint_s").observe(
                _time.perf_counter() - t0)
    if integrity:
        _check_integrity(_sentinel_values(amps, info,
                                          _sentinel_perm(info, len(steps))),
                         baseline, tol, "final", registry)
    if torch.is_tensor(amps) and torch.is_tensor(state.amps):
        amps = amps.reshape(state.amps.shape)
    out = state.replace_amps(amps)
    if gang:
        # no process clears the chain while a peer may still write its
        # last slice
        mesh.barrier()
    _clear_chain(directory)
    return out


# ---------------------------------------------------------------------------
# the durable executor: trajectory engine
# ---------------------------------------------------------------------------


def _generator_fingerprint(generator: torch.Generator) -> str:
    """The generator's state at entry: a resume given a generator in the
    same state redraws the same uniforms."""
    state = generator.get_state()
    return hashlib.sha256(
        state.cpu().numpy().tobytes()
        + str(generator.device).encode()).hexdigest()[:32]


def run_durable_trajectories(circuit, generator: torch.Generator,
                             shots: int, directory: str, *,
                             every: int = None, chunk: int = None,
                             engine: str = None, device=None,
                             keep: int = None,
                             registry: Optional[_metrics.Registry] = None):
    """Durable counterpart of trajectories.run_batched (ref :985): the
    same (shots, C) uniforms drawn from `generator`, the same chunks of
    `chunk` shots (all of them when None), and every `every` chunks a
    checkpoint of the accumulated (shots_done, 2, 2^n) planes and
    (shots_done, C) draws with a cursor fingerprinting the generator's
    state at entry. A rerun given a generator in that state resumes: the
    finished shots load from the checkpoint, the rest run from their own
    uniforms, and (planes, draws) are bit-identical to run_batched's.
    Returns them as tensors on the program's device. Each checkpoint
    holds the whole accumulated payload (keep-last-K needs every
    survivor self-contained), so checkpoint bytes grow with the shots
    done: size `every` to the failure rate."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.circuit import _engine_mode_key
    from quest_tpu_torch.env import knob_value

    faults.install_from_env()
    n = circuit.num_qubits
    shots = int(shots)
    if shots < 1:
        raise ValueError(f"shots must be >= 1, got {shots}")
    every = int(every) if every is not None else knob_value(
        "QUEST_DURABLE_EVERY")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    integrity = knob_value("QUEST_INTEGRITY")
    tol = knob_value("QUEST_INTEGRITY_TOL")
    engine = T._resolve_engine(engine, n)
    bucket = shots if chunk is None else max(1, min(int(chunk), shots))
    prog = T._compiled_traj(circuit, n, device, engine)
    want = {
        "engine": engine,
        "interpret": False,
        "bucket": bucket,
        "shots": shots,
        "mode_key": repr(_engine_mode_key()),
        "circuit_ops": len(circuit.ops),
        "plan_sha": _ops_sha(circuit.ops),
        "key_fp": _generator_fingerprint(generator),
    }
    uniforms = torch.rand((shots, prog.num_channels), generator=generator,
                          dtype=torch.float64,
                          device=generator.device).to(prog.device)

    planes_acc: list = []
    draws_acc: list = []
    shots_done = 0
    found = _latest_valid(directory, "traj", registry)
    if found is not None:
        meta, arrays, cursor, path = found
        _validate_cursor(cursor, want, path)
        shots_done = int(cursor["shots_done"])
        planes_acc.append(np.asarray(arrays["planes"]))
        draws_acc.append(np.asarray(arrays["draws"]))
        _counter("durable_resumes", registry).inc()

    def norm_check(planes, where):
        norms = np.sum(planes.astype(np.float64) ** 2, axis=(1, 2))
        worst = int(np.argmax(np.abs(norms - 1.0)))
        _check_integrity({"norm": float(norms[worst])}, {"norm": 1.0}, tol,
                         where(worst), registry)

    chunks_done = 0
    for lo in range(shots_done, shots, bucket):
        if faults.ACTIVE:
            faults.check("durable.step", shot=lo, engine=engine)
            faults.check("durable.preempt", shot=lo, engine=engine)
        planes, draws = prog(uniforms[lo:lo + bucket])
        planes_acc.append(planes.detach().cpu().numpy())
        draws_acc.append(draws.detach().cpu().numpy())
        _counter("durable_steps_run", registry).inc()
        shots_done = min(lo + bucket, shots)
        chunks_done += 1
        if chunks_done % every == 0 and shots_done < shots:
            t0 = _time.perf_counter()
            all_planes = np.concatenate(planes_acc, axis=0)
            all_draws = np.concatenate(draws_acc, axis=0)
            planes_acc, draws_acc = [all_planes], [all_draws]
            if integrity:
                norm_check(all_planes, lambda w, s=shots_done:
                           f"shot {w} (of {s} done)")
            cursor = dict(want, kind="traj", shots_done=shots_done)
            ckpt.save_step(directory, shots_done,
                           arrays={"planes": all_planes,
                                   "draws": all_draws},
                           extra=cursor, keep=keep)
            _counter("durable_checkpoints_saved", registry).inc()
            _registry_of(registry).gauge("durable_last_checkpoint_step").set(
                shots_done)
            _registry_of(registry).histogram("durable_checkpoint_s").observe(
                _time.perf_counter() - t0)
    planes = (planes_acc[0] if len(planes_acc) == 1
              else np.concatenate(planes_acc, axis=0))
    draws = (draws_acc[0] if len(draws_acc) == 1
             else np.concatenate(draws_acc, axis=0))
    if integrity:
        norm_check(planes, lambda w: f"final (shot {w})")
    _clear_chain(directory)
    return (torch.from_numpy(planes).to(prog.device),
            torch.from_numpy(draws).to(prog.device))
