"""The sharded engines: the reference's distributed schedule on a mesh of
torch devices.

A port of quest_tpu/parallel/sharded.py. The reference runs a whole
circuit inside one shard_map over a 1-D jax mesh; here one process walks
the program over the shards of a `ShardedAmps` (parallel/mesh.py), each
shard's (2, 2^local_n) planes (or (B, 2, 2^local_n) for a batch) on its
own device, and the exchanges are copies between shard tensors through
the mesh:

  reference mechanism                    | here
  ---------------------------------------|-----------------------------
  lax.axis_index over the mesh           | the shard index d, a host int
  getChunkPairId = id XOR 2^(q - local)  | mesh.permute over device bit
  exchangeStateVectors (ppermute)        |   (a copy into a new buffer
                                         |    on the receiving shard)
  swap-to-local for multi-target gates   | half-chunk permute
  relabel events (all_to_all)            | mesh.all_to_all of the slot
                                         |   blocks
  psum                                   | mesh.reduce on shard 0's device
  jnp.where(pred, new, chunk) on a       | the shard is skipped: its
    global-control predicate             |   planes stay bit for bit

Every local computation goes through ops/apply (in place on the shard's
planes, at the program's matmul tier); the fused engine runs each
maximal run of shard-local plan items as swept kernel segments, one
launch of the segment kernel (ops/segment.py segment_sweep, K1 by
default) per shard, planned under HOPPER_GEOMETRY on the chunk's
local_n qubits (`plan_fused_structural`; band_plan.TPU_GEOMETRY gives the
reference's parts). An exchange receives every shard's block before any
shard writes, so shards that share a device never read a chunk another
shard has already overwritten (mesh.permute). Routing, relabeling and
the comm plan are the reference's host math (parallel/comm.py,
parallel/relabel.py), so the mesh's recorder issues exactly the
exchanges comm_stats predicts (parallel/introspect.py holds them
equal).

Every program walks the same code on a dry mesh (AmpMesh.dry, 'meta'
shards): the exchanges record and copy nothing and no local work runs;
introspect prices a schedule that way without a state.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from quest_tpu_torch import cplx
from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.env import knob_value
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.parallel import comm as C
from quest_tpu_torch.parallel.mesh import AmpMesh, ShardedAmps, shard_planes

_DYNAMIC = ("measure", "measure_dm", "classical")


# ---------------------------------------------------------------------------
# shard views and predicates
# ---------------------------------------------------------------------------

def _split_controls(controls, cstates, local_n):
    cstates = A.norm_control_states(controls, cstates)
    loc_c, loc_s, glob = [], [], []
    for c, s in zip(controls, cstates):
        if c < local_n:
            loc_c.append(c)
            loc_s.append(s)
        else:
            glob.append((c - local_n, s))
    return tuple(loc_c), tuple(loc_s), tuple(glob)


def _holds(d: int, glob_controls) -> bool:
    """Shard d satisfies every global-qubit control (its whole chunk
    shares those bits)."""
    return all(((d >> bit) & 1) == want for bit, want in glob_controls)


def _bit_axes(x: torch.Tensor, local_n: int, qubits):
    """(view, axis): shard planes x (B, 2, 2^local_n) viewed with one
    size-2 axis per qubit (apply.bit_view), axis[q] its axis."""
    dims, axis_of = A.bit_view(local_n, qubits)
    return (x.view([x.shape[0], 2] + dims),
            {q: a + 2 for q, a in axis_of.items()})


def _flat_slices(v: torch.Tensor, s: int, start: int = 2) -> list:
    """s views of `v` that cut the row-major index over its axes from
    `start` on into s equal contiguous ranges, in order (axis sizes and s
    are powers of two)."""
    parts, ax, rem = [v], start, s
    while rem > 1:
        size = parts[0].shape[ax]
        if size >= rem:
            step = size // rem
            parts = [p.narrow(ax, i * step, step) for p in parts
                     for i in range(rem)]
            rem = 1
        else:
            parts = [p.narrow(ax, i, 1) for p in parts for i in range(size)]
            rem //= size
            ax += 1
    return parts


def _scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _scale(x: torch.Tensor, local_n: int, c: complex, loc_c=(), loc_s=()):
    """Multiply the shard's amplitudes where the local controls hold by
    the complex scalar c, in place."""
    fre = _scalar(x, c.real)
    fim = _scalar(x, c.imag) if c.imag else None
    for xr, xi, _ in A.target_chunks(x, local_n, (), loc_c, loc_s):
        A._complex_mul_(xr, xi, fre, fim)


def _slices(mesh: AmpMesh, x_elems: int, gbit: int) -> int:
    """QUEST_EXCHANGE_SLICES (or _DCI) for a block of x_elems per plane
    over device bit gbit: comm.effective_slices, the predictor's clamp."""
    D = mesh.size
    return C.effective_slices(x_elems, C.topology(D).link_of(gbit, D))


def _sliced_receive(views: Sequence, mesh: AmpMesh, gbit: int, s: int):
    """One pair exchange of `views` (one block per shard) split into s
    permutes: each shard's partner block lands in a new contiguous buffer
    shaped like its own block. Returns the buffers (None on a dry mesh)."""
    if mesh.dry:
        for i in range(s):
            mesh.permute([_flat_slices(v, s)[i] for v in views], gbit)
        return None
    recv = [torch.empty(v.shape, dtype=v.dtype, device=dev)
            for v, dev in zip(views, mesh.devices)]
    src = [_flat_slices(v, s) for v in views]
    dst = [_flat_slices(r, s) for r in recv]
    for i in range(s):
        mesh.permute([p[i] for p in src], gbit, out=[q[i] for q in dst])
    return recv


# ---------------------------------------------------------------------------
# the per-shard appliers (ref sharded.py:56-484)
# ---------------------------------------------------------------------------

def _swap_global_local(xs, mesh, local_n, gbit, l):
    """Distributed SWAP of global qubit (device bit `gbit`) with local
    qubit l: each shard sends the half of its chunk whose bit l differs
    from its own device bit and receives its partner's into it (ref
    _swap_global_local)."""
    views = []
    for d, x in enumerate(xs):
        v, ax = _bit_axes(x, local_n, (l,))
        views.append(v.narrow(ax[l], 1 - ((d >> gbit) & 1), 1))
    s = _slices(mesh, 1 << (local_n - 1), gbit)
    for i in range(s):
        parts = [_flat_slices(v, s)[i] for v in views]
        recv = mesh.permute(parts, gbit)
        if recv is not None:
            for p, r in zip(parts, recv):
                p.copy_(r)


def _butterfly_1q(xs, mesh, local_n, sup, gbit, loc_c=(), loc_s=(),
                  glob_c=()):
    """Single-qubit operator on global bit `gbit` through one full-chunk
    pair exchange, split into QUEST_EXCHANGE_SLICES permutes, each slice
    combined as it lands (ref _butterfly_1q): the shard whose bit is 0
    holds the "up" amplitudes, new_up = m00 up + m01 lo, and its partner
    new_lo = m10 up + m11 lo. Local controls narrow the combine; a shard
    failing a global control keeps its planes."""
    m = 1 << local_n
    s = _slices(mesh, m, gbit)
    L = (m // s).bit_length() - 1         # free bits of one slice
    for i in range(s):
        parts = [x.narrow(2, i * (m // s), m // s) for x in xs]
        recv = mesh.permute(parts, gbit)
        if recv is None:
            continue
        for d, (p, r) in enumerate(zip(parts, recv)):
            if not _holds(d, glob_c):
                continue
            mine = (d >> gbit) & 1
            diag, off = (sup[0, 0], sup[0, 1]) if mine == 0 else \
                (sup[1, 1], sup[1, 0])
            pv, rv = _control_views(p, r, L, i, loc_c, loc_s)
            if pv is None:
                continue
            dre, die = _scalar(p, diag.real), _scalar(p, diag.imag)
            ore, oie = _scalar(p, off.real), _scalar(p, off.imag)
            re, im = pv[:, 0], pv[:, 1]
            rre, rim = rv[:, 0], rv[:, 1]
            nre = dre * re - die * im + ore * rre - oie * rim
            nim = dre * im + die * re + ore * rim + oie * rre
            re.copy_(nre)
            im.copy_(nim)


def _control_views(p, r, nbits, hi, controls, cstates):
    """Views of a block p (B, 2, 2^nbits) — flat range `hi` of its
    chunk, so index bits from nbits up equal hi — and of its received
    block r, narrowed to where the local controls hold; (None, None) when
    a control above the block fails."""
    low = []
    for c, st in zip(controls, cstates):
        if c >= nbits:
            if ((hi >> (c - nbits)) & 1) != st:
                return None, None
        else:
            low.append((c, st))
    if not low:
        return p, r
    pv, ax = _bit_axes(p, nbits, [c for c, _ in low])
    rv, _ = _bit_axes(r, nbits, [c for c, _ in low])
    for c, st in low:
        pv = pv.narrow(ax[c], st, 1)
        rv = rv.narrow(ax[c], st, 1)
    return pv, rv


def _pair_exchange_2t(xs, mesh, local_n, sup, t, jg, gbit, tier):
    """Two-target operator with local target `t` and the other on device
    bit `gbit` (matrix index bit `jg`): split by the global index bit
    into same-block and cross-block 2x2s and exchange only what the
    cross-block reads — half a chunk when each cross-block reads one
    column, else the whole chunk (ref _pair_exchange_2t)."""
    same, cross, need = C.pair2t_blocks(sup, jg)
    m = 1 << local_n
    if all(len(nd) <= 1 for nd in need):
        nv = [nd[0] if nd else 0 for nd in need]
        views = []
        for d, x in enumerate(xs):
            v, ax = _bit_axes(x, local_n, (t,))
            send = nv[1] if ((d >> gbit) & 1) == 0 else nv[0]
            views.append(v.narrow(ax[t], send, 1))
        recv = _sliced_receive(views, mesh, gbit, _slices(mesh, m // 2, gbit))
        if recv is None:
            return
        for d, x in enumerate(xs):
            g = (d >> gbit) & 1
            A.apply_matrix(x, local_n, same[g], (t,), tier=tier)
            col = np.asarray(cross[g])[:, nv[g]]
            v, ax = _bit_axes(x, local_n, (t,))
            rre, rim = recv[d][:, 0], recv[d][:, 1]
            for row in (0, 1):
                out = v.narrow(ax[t], row, 1)
                cre, cim = _scalar(x, col[row].real), _scalar(x, col[row].imag)
                out[:, 0].add_(cre * rre - cim * rim)
                out[:, 1].add_(cre * rim + cim * rre)
        return
    # dense cross-block (generic crossing 2q unitaries): the whole chunk
    recv = _sliced_receive(xs, mesh, gbit, _slices(mesh, m, gbit))
    if recv is None:
        return
    for d, x in enumerate(xs):
        g = (d >> gbit) & 1
        A.apply_matrix(recv[d], local_n, cross[g], (t,), tier=tier)
        A.apply_matrix(x, local_n, same[g], (t,), tier=tier)
        x.add_(recv[d])


def _matrix_op(xs, mesh, local_n, operand, targets, controls=(),
               cstates=(), tier="highest"):
    """General k-qubit matrix gate (a complex matrix or an (re, im) pair),
    distributed by comm.matrix_route (ref _matrix_op): a diagonal operand
    never communicates; two targets with one global take one direct pair
    exchange; a single global target the butterfly; any other global
    targets swap into free local slots, apply and swap back (a control
    in a chosen slot moves to the vacated global position, the
    reference's ctrlMask fixup)."""
    targets, controls = tuple(targets), tuple(controls)
    cstates = A.norm_control_states(controls, cstates)
    pair = operand if isinstance(operand, tuple) else cplx.pack(operand)
    sup = C.dense_operand(pair, len(targets))
    route = C.matrix_route(sup, targets, controls, local_n)
    if route[0] == "diagonal":
        return _diagonal_op(xs, mesh, local_n, np.diagonal(sup), targets)
    if route[0] == "pair2t":
        _, _, t, jg, gbit = route
        return _pair_exchange_2t(xs, mesh, local_n, sup, t, jg, gbit, tier)
    loc_c, loc_s, glob_c = _split_controls(controls, cstates, local_n)
    if route[0] == "local":
        if not mesh.dry:
            for d, x in enumerate(xs):
                if _holds(d, glob_c):
                    A.apply_matrix(x, local_n, sup, targets, loc_c, loc_s,
                                   tier)
        return
    if route[0] == "butterfly":
        return _butterfly_1q(xs, mesh, local_n, sup, route[1], loc_c, loc_s,
                             glob_c)
    glob_targets = [t for t in targets if t >= local_n]
    slots = [q for q in range(local_n) if q not in targets]
    ctrl_slots = set(controls)
    slots.sort(key=lambda q: (q in ctrl_slots, q))  # prefer non-control slots
    if len(slots) < len(glob_targets):
        raise val.QuESTError(
            "Invalid number of target qubits: the matrix cannot fit in a "
            f"single device chunk (targets {targets} need "
            f"{len(glob_targets)} local slots, only {len(slots)} exist; "
            "ref E_CANNOT_FIT_MULTI_QUBIT_MATRIX, QuEST_validation.c:121)")
    relabeled, new_controls, swaps = list(targets), list(controls), []
    for gt in glob_targets:
        slot = slots.pop(0)
        swaps.append((gt - local_n, slot))
        relabeled[relabeled.index(gt)] = slot
        if slot in ctrl_slots:
            new_controls[new_controls.index(slot)] = gt
        _swap_global_local(xs, mesh, local_n, gt - local_n, slot)
    loc_c, loc_s, glob_c = _split_controls(new_controls, cstates, local_n)
    if not mesh.dry:
        for d, x in enumerate(xs):
            if _holds(d, glob_c):
                A.apply_matrix(x, local_n, sup, relabeled, loc_c, loc_s, tier)
    for gbit, slot in reversed(swaps):
        _swap_global_local(xs, mesh, local_n, gbit, slot)


def _diagonal_op(xs, mesh, local_n, diag, targets, controls=(), cstates=()):
    """Diagonal gate: never communicates. The table's global-target axes
    are indexed by the shard's device bits (ref _diagonal_op)."""
    if mesh.dry:
        return
    targets = tuple(targets)
    loc_c, loc_s, glob_c = _split_controls(controls, cstates, local_n)
    k = len(targets)
    table = np.asarray(diag, dtype=np.complex128).reshape((2,) * k)
    loc_t = [t for t in targets if t < local_n]
    for d, x in enumerate(xs):
        if not _holds(d, glob_c):
            continue
        tab = table
        # diag index bit j <-> targets[j] <-> axis k-1-j; ascending j
        # removes the highest remaining axis, leaving lower axes in place
        for j in range(k):
            if targets[j] >= local_n:
                tab = np.take(tab, (d >> (targets[j] - local_n)) & 1,
                              axis=k - 1 - j)
        if loc_t:
            A.apply_diagonal(x, local_n, tab.reshape(-1), loc_t, loc_c, loc_s)
        else:
            _scale(x, local_n, complex(tab), loc_c, loc_s)


def _parity_op(xs, mesh, local_n, targets, angle):
    """exp(-i angle/2 Z...Z): the global targets' signs are one factor of
    the shard (ref _parity_op)."""
    if mesh.dry:
        return
    loc = [t for t in targets if t < local_n]
    for d, x in enumerate(xs):
        gsign = 1
        for t in targets:
            if t >= local_n and (d >> (t - local_n)) & 1:
                gsign = -gsign
        if loc:
            A.apply_parity_phase(x, local_n, loc, gsign * angle)
            continue
        half = torch.as_tensor(angle, dtype=x.dtype) / 2.0
        _scale(x, local_n, complex(float(half.cos()),
                                   -gsign * float(half.sin())))


def _all_ones_op(xs, mesh, local_n, term, qubits):
    """Phase `term` where every listed qubit is 1; global qubits are the
    shard's predicate (ref _all_ones_op)."""
    if mesh.dry:
        return
    glob = [(q - local_n, 1) for q in qubits if q >= local_n]
    loc = [q for q in qubits if q < local_n]
    for d, x in enumerate(xs):
        if not _holds(d, glob):
            continue
        if loc:
            A.apply_phase_on_all_ones(x, local_n, loc, term)
        else:
            _scale(x, local_n, complex(term))


def _relabel_op(xs, mesh, local_n, slots):
    """Whole-register relabel event: device bit j swaps with local slot
    slots[j] in ONE all-to-all (ref _relabel_op): shard k's block whose
    slot bits read d becomes shard d's block whose slot bits read k."""
    slots = tuple(slots)
    D = mesh.size
    dims, axis_of = A.bit_view(local_n, slots)

    def block(x, v):
        t = x.view([x.shape[0], 2] + dims)
        for j, s in enumerate(slots):
            t = t.narrow(axis_of[s] + 2, (v >> j) & 1, 1)
        return t
    sends = [[block(xs[d], k) for k in range(D)] for d in range(D)]
    recv = mesh.all_to_all(sends)
    if recv is None:
        return
    for k in range(D):
        for d in range(D):
            block(xs[k], d).copy_(recv[k][d])


def _apply_gateop(xs, mesh, local_n, n, density, op, tier):
    """One GateOp (plus its column-space dual on a density register when
    the op list is not flattened) on the shards (ref _apply_gateop)."""
    shift = n // 2 if density else 0
    if op.kind == "relabel":
        return _relabel_op(xs, mesh, local_n, op.operand)
    if op.kind == "superop":
        from quest_tpu_torch.ops.matrices import superop_targets
        return _matrix_op(xs, mesh, local_n, op.operand,
                          superop_targets(op.targets, shift), tier=tier)

    def one(targets, controls, conj):
        if op.kind == "parity":
            return _parity_op(xs, mesh, local_n, targets,
                              -op.operand if conj else op.operand)
        operand = np.conj(op.operand) if conj else op.operand
        if op.kind == "allones":
            return _all_ones_op(xs, mesh, local_n, operand, targets)
        if op.kind == "diagonal":
            return _diagonal_op(xs, mesh, local_n, operand, targets, controls,
                                op.cstates)
        return _matrix_op(xs, mesh, local_n, operand, targets, controls,
                          op.cstates, tier)

    one(op.targets, op.controls, False)
    if density:
        one(tuple(t + shift for t in op.targets),
            tuple(c + shift for c in op.controls), True)


def _band_op_sharded(xs, mesh, local_n, bop, tier):
    """A composed BandOp: local bands as one in-chunk contraction per
    shard; a width-1 band on a global qubit rides the single-qubit pair
    exchange; cross-shard predicates select the shards (ref
    _band_op_sharded)."""
    if bop.ql >= local_n:
        return _matrix_op(xs, mesh, local_n, (bop.gre, bop.gim), (bop.ql,),
                          [q for q, _ in bop.preds],
                          [s for _, s in bop.preds], tier)
    if mesh.dry:
        return
    loc_p = [(q, s) for q, s in bop.preds if q < local_n]
    glob_p = [(q - local_n, s) for q, s in bop.preds if q >= local_n]
    for d, x in enumerate(xs):
        if _holds(d, glob_p):
            A.apply_band(x, local_n, (bop.gre, bop.gim), bop.ql, bop.w, loc_p,
                         tier)


def _apply_plan_item(xs, mesh, local_n, n, it, tier):
    """One fusion-plan item (or bare GateOp) on the shards — the shared
    applier of the banded, fused and dynamic engines."""
    from quest_tpu_torch.ops import fusion as F
    if isinstance(it, F.BandOp):
        return _band_op_sharded(xs, mesh, local_n, it, tier)
    return _apply_gateop(xs, mesh, local_n, n, False, getattr(it, "op", it),
                         tier)


# ---------------------------------------------------------------------------
# the flat op lists and band layouts (ref sharded.py:487-645)
# ---------------------------------------------------------------------------

def engine_flat(ops: Sequence, n: int, density: bool, local_n: int,
                lazy: bool = False, relabel: bool = None,
                sched_stats: Optional[dict] = None, bands: Sequence = None,
                comm_info: Optional[dict] = None):
    """The flat op list the banded/fused sharded engines execute:
    flatten_ops, the scheduler, then the one relabel-rewrite policy
    (ref engine_flat): relabel None means the comm planner's choice
    under QUEST_COMM_PLAN (priced on `bands`), plan_full_relabels with
    the knob off; lazy=True the lazy rewrite. `sched_stats` and
    `comm_info`, when dicts, receive the scheduler's counters and the
    planner's strategy (with the winner's fusion plan under 'items')."""
    from quest_tpu_torch.circuit import flatten_ops
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import relabel as R

    if lazy and relabel:
        raise ValueError("lazy and relabel are mutually exclusive "
                         "relabeling strategies; pick one")
    flat0 = flatten_ops(ops, n, density)
    if sched_stats is None:
        flat = F.maybe_schedule(flat0, n)
    else:
        enabled = F._schedule_enabled()
        sched, stats = F.schedule(flat0, n)
        stats["enabled"] = enabled
        sched_stats.update(stats)
        flat = sched if enabled else list(flat0)
    if lazy:
        if comm_info is not None:
            comm_info.update({"strategy": "lazy"})
        return R.lazy_relabel_ops(flat, n, local_n)
    if relabel is None and C.plan_enabled():
        chosen, info = C.choose_plan(
            flat, n, local_n, engine="banded",
            bands=bands if bands is not None else _shard_bands(n, local_n))
        if comm_info is not None:
            comm_info.update(info)
        return chosen
    if relabel or relabel is None:
        if comm_info is not None:
            comm_info.update({"strategy": "relabel"})
        return R.plan_full_relabels(flat, n, local_n)
    if comm_info is not None:
        comm_info.update({"strategy": "plain"})
    return flat


def comm_plan_record(ops: Sequence, n: int, density: bool, devices: int,
                     dtype=np.complex64) -> dict:
    """The plan IR's 'comm' record (ref comm_plan_record): the comm
    planner's predicted schedule for the banded/fused sharded engines
    over `devices`, through engine_flat and the predictor, bytes at the
    real width of `dtype`. Pure host math: no mesh, no state."""
    from quest_tpu_torch.ops import fusion as F

    if devices < 2 or devices & (devices - 1):
        raise ValueError(
            f"devices must be a power of two >= 2, got {devices}")
    g = devices.bit_length() - 1
    local_n = n - g
    if local_n < 1:
        raise ValueError(
            f"register too small to shard over {devices} devices "
            f"(ref E_DISTRIB_QUREG_TOO_SMALL)")
    cinfo: dict = {}
    bands = _shard_bands(n, local_n)
    flat_r = engine_flat(ops, n, density, local_n, bands=bands,
                         comm_info=cinfo)
    items = cinfo.get("items")
    if items is None:
        items = F.plan(flat_r, n, bands=bands)
    topo = C.topology(devices)
    ici_b = topo.ici_bits(devices) if topo.hierarchical else None
    rec = C.comm_stats(C.predict_exchanges_items(items, local_n, ici_b),
                       num_devices=devices,
                       bytes_per_real=precision.real_dtype_of(dtype).itemsize,
                       topo=topo)
    rec.update({
        "devices": devices,
        "comm_strategy": cinfo.get("strategy", "plain"),
        "comm_plan_enabled": C.plan_enabled(),
        "comm_topology": topo.describe(devices),
        "relabel_events": sum(1 for op in flat_r if op.kind == "relabel"),
    })
    return rec


def pergate_flat(ops: Sequence, n: int, density: bool, local_n: int,
                 lazy: bool = False, comm_info: Optional[dict] = None):
    """The flat op list the per-gate engine executes (ref pergate_flat):
    flatten, then the comm planner's per-gate choice under
    QUEST_COMM_PLAN; lazy=True the lazy rewrite; the knob off keeps the
    plain schedule."""
    from quest_tpu_torch.circuit import flatten_ops
    from quest_tpu_torch.parallel import relabel as R

    flat = flatten_ops(ops, n, density)
    if lazy:
        if comm_info is not None:
            comm_info.update({"strategy": "lazy"})
        return R.lazy_relabel_ops(flat, n, local_n)
    if C.plan_enabled():
        chosen, info = C.choose_plan(flat, n, local_n, engine="pergate")
        if comm_info is not None:
            comm_info.update(info)
        return chosen
    if comm_info is not None:
        comm_info.update({"strategy": "plain"})
    return list(flat)


def _shard_bands(n: int, local_n: int):
    """Bands aligned to the shard boundary: full-width bands inside the
    chunk, width-1 bands for the global qubits (ref _shard_bands)."""
    from quest_tpu_torch.ops.fusion import BAND_W
    bands, ql = [], 0
    while ql < local_n:
        w = min(BAND_W, local_n - ql)
        bands.append((ql, w))
        ql += w
    return bands + [(q, 1) for q in range(local_n, n)]


def fused_shard_bands(n: int, local_n: int):
    """The fused engine's band layout — the kernel's bands on the chunk,
    width-1 bands for the global qubits — or None when the chunk is below
    the kernel's 10 qubits (ref fused_shard_bands)."""
    if not BP.usable(local_n):
        return None
    return list(BP.plan_bands(local_n)) + [(q, 1) for q in range(local_n, n)]


def plan_fused_structural(items, local_n: int,
                          budgets: BP.Budgets = BP.HOPPER_GEOMETRY):
    """Maximal runs of purely-local plan items become ("segment", stages,
    arrays) parts through band_plan.segment_plan on the chunk's local_n
    qubits under `budgets`; everything else (and a segment plan's own
    passthroughs) is ("sharded", item), a sweep barrier (ref
    plan_fused_structural). Pure planning."""
    parts, run_items = [], []

    def close_run():
        nonlocal run_items
        for sub in BP.segment_plan(run_items, local_n, budgets=budgets):
            parts.append(sub if sub[0] == "segment" else ("sharded", sub[1]))
        run_items = []

    for it in items:
        if all(q < local_n for q in it.qubits()):
            run_items.append(it)
        else:
            if run_items:
                close_run()
            parts.append(("sharded", it))
    if run_items:
        close_run()
    return parts


def plan_fused_parts(items, local_n: int, driver: str = None,
                     budgets: BP.Budgets = BP.HOPPER_GEOMETRY):
    """plan_fused_structural, then the per-shard sweep fusion
    (band_plan.maybe_sweep under `driver`): the parts the fused engine
    launches (ref _plan_fused_parts, which also compiles them; here the
    program prepares each segment once per device)."""
    return BP.maybe_sweep(plan_fused_structural(items, local_n, budgets),
                          local_n, budgets=budgets, driver=driver)


def _reject_measure_ops(ops):
    if any(op.kind in _DYNAMIC for op in ops):
        raise val.QuESTError(
            "Invalid operation: this circuit contains mid-circuit "
            "measurements; use compile_circuit_sharded_measured (or "
            "Circuit.apply_sharded_measured) for dynamic circuits on the "
            "mesh.")


def _local_n(n: int, mesh: AmpMesh) -> int:
    local_n = n - mesh.global_qubits
    if local_n < 1:
        val.err(val.ErrorCode.E_DISTRIB_QUREG_TOO_SMALL)
    return local_n


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

class ShardedProgram:
    """A compiled sharded program: call it on a ShardedAmps (or a list of
    shard tensors) over `mesh` — one state, (2, 2^local_n) per shard, or a
    batch, (B, 2, 2^local_n) — f32 or f64; it updates the shards in place
    and returns the ShardedAmps. `kind` 'pergate' walks the flat op list
    (`density`: each op's dual inline when the list is not flattened),
    'banded' the fusion plan `items`, 'fused' the parts: a ("kernel",
    stages, arrays) part is one segment_sweep launch per shard of the
    segment prepared for that shard's device (K1 by default), a
    ("sharded", item) part the per-shard appliers with their exchanges.
    f64 planes run `items` through the appliers (the kernel is f32).
    `plain(x)` runs the fused parts through the kernel's plain version,
    out of place, shard by shard. `strategy` is the comm planner's
    choice, `record` what it predicted."""

    def __init__(self, kind: str, mesh: AmpMesh, n: int, items: List,
                 tier: str, density: bool = False, parts: List = None,
                 driver: str = None, nbuf: int = None,
                 comm_info: dict = None):
        self.kind = kind
        self.mesh = mesh
        self.n = n
        self.local_n = n - mesh.global_qubits
        self.items = items
        self.tier = tier
        self.density = density
        self.parts = parts
        self.driver = driver
        self.nbuf = nbuf
        self.comm_info = comm_info or {}
        self.fallback = None
        self.segments = {}          # (part index, device key) -> Segment
        if parts is not None and not mesh.dry:
            from quest_tpu_torch.ops.segment import prepare_segment
            for i, p in enumerate(parts):
                if p[0] != "segment":
                    continue
                for dev in mesh.devices:
                    key = (i, str(dev))
                    if key not in self.segments:
                        self.segments[key] = prepare_segment(
                            p[1], p[2], self.local_n, dev, tier=tier,
                            driver=driver, nbuf=nbuf)

    @property
    def strategy(self) -> str:
        return self.comm_info.get("strategy", "plain")

    @property
    def kernel_parts(self) -> int:
        return sum(1 for p in (self.parts or ()) if p[0] == "segment")

    @property
    def launches_per_call(self) -> int:
        """Segment launches of one call on f32 planes: one per kernel part
        per shard."""
        return self.kernel_parts * self.mesh.size

    def _views(self, x):
        """(amps, per-shard (B, 2, 2^local_n) views). The exchanges of a
        call run on amps.mesh, which must have the program's key (the
        cache shares a program between meshes over the same devices), so
        each mesh's recorder holds its own call's exchanges."""
        amps = x if isinstance(x, ShardedAmps) else ShardedAmps(
            list(x), self.mesh, self.n)
        if amps.mesh.key != self.mesh.key:
            raise ValueError(f"shards over the mesh {amps.mesh.key}; the "
                             f"program is for {self.mesh.key}")
        if len(amps.shards) != self.mesh.size:
            raise ValueError(f"{len(amps.shards)} shards for a mesh of "
                             f"{self.mesh.size}")
        m = 1 << self.local_n
        xs = []
        for d, s in enumerate(amps.shards):
            if s.device != self.mesh.devices[d] and not (
                    s.device.type == self.mesh.devices[d].type
                    and self.mesh.devices[d].index is None):
                raise ValueError(f"shard {d} on {s.device}; the program's "
                                 f"mesh puts it on {self.mesh.devices[d]}")
            if s.numel() % (2 * m) or not s.is_contiguous():
                raise ValueError(f"shard {d} of shape {tuple(s.shape)} is not "
                                 f"contiguous (2, 2^{self.local_n}) planes or "
                                 f"a batch of them")
            xs.append(s.view(-1, 2, m))
        return amps, xs

    def __call__(self, x):
        amps, xs = self._views(x)
        self._run(amps.shards, xs, amps.mesh)
        return amps

    def _run(self, shards, xs, mesh, plain=False):
        if self.kind == "pergate":
            for op in self.items:
                _apply_gateop(xs, mesh, self.local_n, self.n, self.density,
                              op, self.tier)
            return
        if self.parts is None or xs[0].dtype != torch.float32:
            for it in self.items:
                _apply_plan_item(xs, mesh, self.local_n, self.n, it, self.tier)
            return
        for i in range(len(self.parts)):
            self._part(i, shards, xs, mesh, plain)

    def _part(self, i, shards, xs, mesh, plain=False):
        from quest_tpu_torch.ops.segment import (segment_sweep,
                                                 segment_sweep_reference)
        part = self.parts[i]
        if part[0] != "segment":
            _apply_plan_item(xs, mesh, self.local_n, self.n, part[1],
                             self.tier)
            return
        if mesh.dry:
            return
        for d, s in enumerate(shards):
            seg = self.segments[(i, str(mesh.devices[d]))]
            if plain:
                out = segment_sweep_reference(s, seg.stages, seg.operands,
                                              self.local_n, tier=seg.tier)
                s.copy_(out.reshape(s.shape))
            else:
                segment_sweep(s, seg)

    def run_part(self, i: int, x) -> ShardedAmps:
        """Part i of a fused program alone, in place (the durable
        executor's step: one launch per shard, or one sharded item)."""
        amps, xs = self._views(x)
        self._part(i, amps.shards, xs, amps.mesh)
        return amps

    def plain(self, x) -> ShardedAmps:
        """The same program with every kernel part through its plain
        PyTorch version (segment_sweep_reference), shard by shard, on a
        copy of the shards; returns the copy."""
        amps, _ = self._views(x)
        copy = ShardedAmps([s.clone() for s in amps.shards], amps.mesh,
                           self.n)
        _, xs = self._views(copy)
        self._run(copy.shards, xs, amps.mesh, plain=True)
        return copy

    def dry_walk(self, batch: int = 0, dtype=torch.float32) -> AmpMesh:
        """Walk the program on a dry copy of its mesh ('meta' shards,
        nothing copied, no local work) and return that mesh, whose
        recorder holds every exchange one call issues."""
        dry = self.mesh if self.mesh.dry else self.mesh.dry_copy()
        m = 1 << self.local_n
        shape = (max(batch, 1), 2, m)
        shards = [torch.empty(shape, dtype=dtype, device="meta")
                  for _ in range(dry.size)]
        self._run(shards, shards, dry)
        return dry


def _tier():
    tier = precision.matmul_precision()
    precision.ieee_fp32()
    return tier


def compile_circuit_sharded(ops: Sequence, n: int, density: bool,
                            mesh: AmpMesh, lazy: bool = False
                            ) -> ShardedProgram:
    """The per-gate engine over the mesh (ref compile_circuit_sharded):
    one routed op per flat-list entry; under QUEST_COMM_PLAN (or lazy)
    the list is flattened (duals explicit) and rewritten by the comm
    planner's per-gate choice."""
    local_n = _local_n(n, mesh)
    _reject_measure_ops(ops)
    if not density and any(op.kind == "superop" for op in ops):
        raise val.QuESTError(
            "Invalid operation: noise channels require a density-matrix "
            "register")
    cinfo: dict = {}
    if lazy or C.plan_enabled():
        ops = pergate_flat(ops, n, density, local_n, lazy=lazy,
                           comm_info=cinfo)
        density = False
    else:
        cinfo["strategy"] = "plain"
    return ShardedProgram("pergate", mesh, n, list(ops), _tier(),
                          density=density, comm_info=cinfo)


def compile_circuit_sharded_banded(ops: Sequence, n: int, density: bool,
                                   mesh: AmpMesh, lazy: bool = False,
                                   relabel: bool = None) -> ShardedProgram:
    """The band-fusion engine over the mesh (ref
    compile_circuit_sharded_banded): the fusion planner on shard-aligned
    bands, after engine_flat's relabel policy; local band runs compose
    into one contraction per band per shard, a global qubit's run into
    one 2x2 (one pair exchange)."""
    from quest_tpu_torch.ops import fusion as F
    _reject_measure_ops(ops)
    local_n = _local_n(n, mesh)
    bands = _shard_bands(n, local_n)
    cinfo: dict = {}
    flat = engine_flat(ops, n, density, local_n, lazy=lazy, relabel=relabel,
                       bands=bands, comm_info=cinfo)
    items = cinfo.get("items")
    if items is None:
        items = F.plan(flat, n, bands=bands)
    return ShardedProgram("banded", mesh, n, items, _tier(), comm_info=cinfo)


def compile_plan_items_sharded(items, n: int, mesh: AmpMesh
                               ) -> ShardedProgram:
    """A program applying a slice of fusion-plan items to the shards (ref
    compile_plan_items_sharded, the durable executor's per-step program):
    the banded engine's applier over exactly these items."""
    _local_n(n, mesh)
    return ShardedProgram("banded", mesh, n, list(items), _tier())


def _fused_fallback(what: str, local_n: int) -> None:
    print(f"[sharded] {what}: local_n={local_n} is below the kernel's "
          f"minimum of {BP.LANE_QUBITS + 3} qubits; the BANDED engine runs "
          f"instead (no kernel launches)", file=sys.stderr, flush=True)


def compile_circuit_sharded_fused(ops: Sequence, n: int, density: bool,
                                  mesh: AmpMesh, relabel: bool = None
                                  ) -> ShardedProgram:
    """The segment-kernel engine over the mesh (ref
    compile_circuit_sharded_fused): every maximal run of shard-local plan
    items runs as swept kernel segments, one launch per shard each; items
    touching global qubits ride the exchanges between them. The segment
    driver (QUEST_FUSED_DRIVER / _PIPELINE / _NBUF), the matmul tier and
    the comm plan are read now and kept. A chunk below the kernel's 10
    qubits takes the banded engine (said on stderr); f64 planes run the
    plan's items through the appliers. On a CUDA mesh a segment that
    cannot be prepared or launched raises."""
    from quest_tpu_torch.ops import fusion as F
    _reject_measure_ops(ops)
    local_n = _local_n(n, mesh)
    bands = fused_shard_bands(n, local_n)
    if bands is None:
        _fused_fallback("fused engine", local_n)
        prog = compile_circuit_sharded_banded(ops, n, density, mesh,
                                              relabel=relabel)
        prog.fallback = "banded"
        return prog
    cinfo: dict = {}
    flat = engine_flat(ops, n, density, local_n, relabel=relabel,
                       bands=bands, comm_info=cinfo)
    items = cinfo.get("items")
    if items is None:
        items = F.plan(flat, n, bands=bands)
    tier = _tier()
    driver, nbuf = BP.active_driver(), knob_value("QUEST_FUSED_NBUF")
    parts = plan_fused_parts(items, local_n, driver)
    return ShardedProgram("fused", mesh, n, items, tier, parts=parts,
                          driver=driver, nbuf=nbuf, comm_info=cinfo)


def compile_circuit_sharded_fused_batched(ops: Sequence, n: int,
                                          density: bool, mesh: AmpMesh,
                                          relabel: bool = None
                                          ) -> ShardedProgram:
    """The batched fused engine over the mesh (ref
    compile_circuit_sharded_fused_batched): shards of (B, 2, 2^local_n),
    the batch axis local to every shard. One launch per kernel part per
    shard carries all B states, so launches do not scale with B; an
    exchange moves the B states' blocks in one copy. B is taken at call
    time. Below the kernel tier every item runs through the appliers."""
    return compile_circuit_sharded_fused(ops, n, density, mesh, relabel)


# ---------------------------------------------------------------------------
# the dynamic engine (ref sharded.py:549-812)
# ---------------------------------------------------------------------------

def plan_measured_program(flat: Sequence, n: int, local_n: int, engine: str,
                          relabel: bool, driver: str = None):
    """Split the flat op list at its measurements and classically
    controlled ops, run the relabel pass per measurement-free stretch
    (each stretch restores standard order, so every barrier sees logical
    positions) and band/kernel-plan each stretch per `engine` (ref
    plan_measured_program). Returns (program, resolved engine): a list of
    ("dyn", op) | ("stretch", items, parts or None)."""
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import relabel as R

    bands = None
    if engine == "fused":
        bands = fused_shard_bands(n, local_n)
        if bands is None:
            _fused_fallback("dynamic engine", local_n)
            engine = "banded"
    if engine == "banded":
        bands = _shard_bands(n, local_n)
    program: list = []

    def close(stretch):
        if not stretch:
            return
        if engine != "xla":
            stretch = F.maybe_schedule(stretch, n)
        if relabel:
            stretch = R.plan_full_relabels(stretch, n, local_n)
        if engine == "xla":
            program.append(("stretch", stretch, None))
            return
        items = F.plan(stretch, n, bands=bands)
        parts = (plan_fused_parts(items, local_n, driver)
                 if engine == "fused" else None)
        program.append(("stretch", items, parts))

    cur: list = []
    for op in flat:
        if op.kind in _DYNAMIC:
            close(cur)
            cur = []
            program.append(("dyn", op))
        else:
            cur.append(op)
    close(cur)
    return program, engine


def resolve_measured_engine(engine, relabel, banded: bool = False):
    """The dynamic engine's argument defaults (ref
    resolve_measured_engine): engine None means 'xla' ('banded' through
    the legacy bool); relabel defaults on for the fusing engines."""
    if engine is None:
        engine = "banded" if banded else "xla"
    if engine not in ("xla", "banded", "fused"):
        raise ValueError(f"engine must be 'xla', 'banded' or 'fused', "
                         f"got {engine!r}")
    if relabel is None:
        relabel = engine in ("banded", "fused")
    return engine, relabel


def _partial_prob0(x, d, local_n, n, qubit, density):
    """This shard's part of P(qubit = 0), an f64 scalar tensor."""
    if density:
        dim = 1 << (n // 2)
        cols = (1 << local_n) // dim
        c0 = d * cols
        diag = x[0, 0].reshape(-1)[c0::dim + 1][:cols]
        idx = torch.arange(c0, c0 + cols, device=x.device)
        keep = ((idx >> qubit) & 1) == 0
        return diag.to(torch.float64)[keep].sum()
    if qubit >= local_n:
        if (d >> (qubit - local_n)) & 1:
            return torch.zeros((), dtype=torch.float64, device=x.device)
        return x.to(torch.float64).pow(2).sum()
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for xr, xi, _ in A.target_chunks(x, local_n, (), (qubit,), (0,)):
        total += (xr * xr + xi * xi).to(torch.float64).sum()
    return total


def _collapse_shard(x, d, local_n, qubits, outcome, renorm):
    """Keep the shard's amplitudes where every qubit of `qubits` reads
    `outcome`, times renorm; zero the rest. In place."""
    if any(((d >> (q - local_n)) & 1) != outcome
           for q in qubits if q >= local_n):
        x.zero_()
        return
    loc = tuple(q for q in qubits if q < local_n)
    if not loc:
        x.mul_(float(renorm))
        return
    for states in np.ndindex(*(2,) * len(loc)):
        keep = all(s == outcome for s in states)
        for xr, xi, _ in A.target_chunks(x, local_n, (), loc, states):
            if keep:
                xr.mul_(float(renorm))
                xi.mul_(float(renorm))
            else:
                xr.zero_()
                xi.zero_()


def _measure_sharded(xs, mesh, local_n, n, qubit, density, draw):
    """Mid-circuit measurement over the shards (ref _measure_op_sharded):
    each shard's part of P(0) summed through mesh.reduce (the psum), one
    uniform for the whole register, the outcome read on the host, then
    each shard collapsed locally — a shard whose global qubit fixes the
    other outcome is zeroed. Returns the outcome (None on a dry mesh)."""
    parts = None if mesh.dry else [
        _partial_prob0(x, d, local_n, n, qubit, density)
        for d, x in enumerate(xs)]
    total = mesh.reduce(parts if parts is not None else [None] * mesh.size)
    if total is None:
        return None
    rdt = precision.numpy_dtype(xs[0].dtype)
    p0 = rdt.type(total.item())
    eps = rdt.type(precision.real_eps(rdt))
    one = rdt.type(1.0)
    u = draw()
    if p0 < eps:
        outcome = 1
    elif one - p0 < eps:
        outcome = 0
    else:
        outcome = int(rdt.type(u) > p0)
    prob = max(p0 if outcome == 0 else one - p0, eps)
    if density:
        qubits = (qubit, qubit + n // 2)
        renorm = one / prob
    else:
        qubits = (qubit,)
        renorm = one / np.sqrt(prob)
    for d, x in enumerate(xs):
        _collapse_shard(x, d, local_n, qubits, outcome, renorm)
    return outcome


class ShardedMeasuredProgram(ShardedProgram):
    """A compiled dynamic circuit over the mesh: fn(x, generator) -> (x,
    outcomes int32 CPU tensor in program order), the shards updated in
    place; fn.given(x, uniforms) takes the measurements' uniforms in a
    sequence instead. Measurement-free stretches run as the static
    engines run them (`engine` 'xla', 'banded' or 'fused', kernel parts
    launched per shard); a classically controlled gate runs on every
    shard, or on none, from the outcomes read on the host. A dry walk
    counts every classically controlled gate as applied, or, given the
    outcomes of a run (`dry_walk(outcomes=)`), those whose conditions
    held in it."""

    def __init__(self, mesh, n, program, engine, relabel, tier, driver,
                 nbuf):
        self.program = program
        self.engine = engine
        self.relabel = relabel
        parts = []
        self._part_ids = []
        for el in program:
            if el[0] == "stretch" and el[2] is not None:
                self._part_ids.append(list(range(len(parts),
                                                 len(parts) + len(el[2]))))
                parts += el[2]
            else:
                self._part_ids.append(None)
        super().__init__("measured", mesh, n, [], tier, parts=parts,
                         driver=driver, nbuf=nbuf,
                         comm_info={"strategy":
                                    "relabel" if relabel else "plain"})

    def __call__(self, x, generator: torch.Generator):
        from quest_tpu_torch import measurement as MS
        amps, xs = self._views(x)
        outs = self._walk(amps.shards, xs, amps.mesh,
                          lambda: MS.draw_uniform(generator, xs[0].dtype))
        return amps, outs

    def given(self, x, uniforms):
        it = iter(uniforms)
        amps, xs = self._views(x)
        return amps, self._walk(amps.shards, xs, amps.mesh,
                                lambda: float(next(it)))

    def dry_walk(self, batch: int = 0, dtype=torch.float32,
                 outcomes=None) -> AmpMesh:
        """ShardedProgram.dry_walk; `outcomes` (one per measurement, in
        program order) decide the classically controlled gates as they
        did in the run that measured them, instead of counting each as
        applied."""
        dry = self.mesh if self.mesh.dry else self.mesh.dry_copy()
        shape = (max(batch, 1), 2, 1 << self.local_n)
        shards = [torch.empty(shape, dtype=dtype, device="meta")
                  for _ in range(dry.size)]
        self._walk(shards, shards, dry, lambda: 0.0, outcomes)
        return dry

    def _walk(self, shards, xs, mesh, draw, known=None):
        from quest_tpu_torch.ops.segment import segment_sweep
        outs: List[int] = []
        kernels = xs[0].dtype == torch.float32
        for el, ids in zip(self.program, self._part_ids):
            if el[0] == "dyn":
                op = el[1]
                if op.kind in ("measure", "measure_dm"):
                    oc = _measure_sharded(xs, mesh, self.local_n, self.n,
                                          op.targets[0],
                                          op.kind == "measure_dm", draw)
                    outs.append(oc if known is None else int(known[len(outs)]))
                    continue
                inners, conds = op.operand
                if ((mesh.dry and known is None)
                        or all(outs[i] == want for i, want in conds)):
                    for g in inners:
                        _apply_gateop(xs, mesh, self.local_n, self.n, False,
                                      g, self.tier)
                continue
            _, items, parts = el
            if parts is None or not kernels:
                for it in items:
                    _apply_plan_item(xs, mesh, self.local_n, self.n, it,
                                     self.tier)
                continue
            for i, part in zip(ids, parts):
                if part[0] != "segment":
                    _apply_plan_item(xs, mesh, self.local_n, self.n, part[1],
                                     self.tier)
                elif not mesh.dry:
                    for d, s in enumerate(shards):
                        segment_sweep(s, self.segments[(i, str(
                            mesh.devices[d]))])
        return torch.tensor([-1 if o is None else o for o in outs],
                            dtype=torch.int32)

    def _run(self, shards, xs, mesh, plain=False):
        self._walk(shards, xs, mesh, lambda: 0.0)


def compile_circuit_sharded_measured(ops: Sequence, n: int, density: bool,
                                     mesh: AmpMesh, engine: str = None,
                                     relabel: bool = None,
                                     banded: bool = False
                                     ) -> ShardedMeasuredProgram:
    """A dynamic circuit over the mesh (ref
    compile_circuit_sharded_measured): mid-circuit measurements (partial
    probabilities reduced over the shards, one draw for the register,
    local collapse, global qubits included) and classical feedback, with
    the measurement-free stretches relabeled and fused like the static
    engines (engine 'banded'/'fused'; 'xla' op by op)."""
    from quest_tpu_torch.circuit import flatten_ops
    engine, relabel = resolve_measured_engine(engine, relabel, banded)
    local_n = _local_n(n, mesh)
    if density and (1 << (n // 2)) < mesh.size:
        raise val.QuESTError(
            "Invalid operation: dynamic density circuits need at least "
            "one density-matrix column per device (2^numQubits >= mesh "
            "size) so each shard can read its diagonal slice; use fewer "
            "devices or the static engine + eager measurement.")
    flat = flatten_ops(ops, n, density)
    if not any(op.kind in ("measure", "measure_dm") for op in flat):
        raise val.QuESTError(
            "Invalid operation: compile_circuit_sharded_measured requires "
            "at least one mid-circuit measurement; use "
            "compile_circuit_sharded instead.")
    tier = _tier()
    driver, nbuf = BP.active_driver(), knob_value("QUEST_FUSED_NBUF")
    program, engine = plan_measured_program(flat, n, local_n, engine,
                                            relabel, driver)
    return ShardedMeasuredProgram(mesh, n, program, engine, relabel, tier,
                                  driver, nbuf)


def apply_circuit_sharded(q, ops: Sequence, mesh: AmpMesh):
    """One-shot per-gate engine on a register (ref apply_circuit_sharded):
    returns the register with its planes sharded over the mesh. The
    `sharded.dispatch` fault site fires before the dispatch."""
    from quest_tpu_torch.resilience import faults
    if faults.ACTIVE:
        faults.check("sharded.dispatch", num_qubits=q.num_qubits,
                     num_ops=len(ops))
    amps = q.amps if isinstance(q.amps, ShardedAmps) else shard_planes(
        q.amps, mesh, q.num_state_qubits)
    fn = compile_circuit_sharded(ops, q.num_state_qubits, q.is_density, mesh)
    return q.replace_amps(fn(amps))
