"""Circuit builder and the engines: per-gate, banded, fused and measured.

A port of quest_tpu/circuit.py: the GateOp record, the Circuit builder
(gates, noise channels, mid-circuit measurement and classically
controlled gates), dual_of, inverse_op and flatten_ops (density duals,
superoperator expansion, measurements claiming both copies of a qubit),
`as_rotation` and `_op_fingerprint` (the gradient engine's angle
recovery and cache key, adjoint.py), the scheduled flat op list
(_planned_flat), `explain`, and the reference's engines:

  * per-gate (`compiled`, `trace`, `apply`): every op of the unscheduled
    flat list through ops/apply's primitives, the semantic oracle the
    scheduled engines are held against; `apply` routes circuits of more
    than PERGATE_COMPILE_WARN_OPS ops to the banded engine
    (QUEST_APPLY_AUTOROUTE);
  * banded (`compiled_banded`, `banded_trace`, `apply_banded`): the
    fusion plan's band operators, diagonals and passthroughs, each one
    apply.apply_band / primitive call;
  * fused (`compiled_fused`, `apply_fused`, `compiled_batched`,
    `apply_batched`): the reference's chain — fusion.schedule,
    fusion.plan, segment_plan, sweep_plan — under HOPPER_GEOMETRY; every
    swept segment runs as one launch of the segment kernel
    (ops/segment.py), for one state or a whole batch, and a plan item
    no kernel stage reaches (a cross-band or wide matrix, a band above
    the block top, a diagonal) runs through the primitives between
    segments, as the reference runs it in XLA. Below the kernel's 10
    qubits it falls back to the banded engine, and f64 planes run the
    banded items of its plan (the kernel is f32), as the reference does;
  * measured (`compiled_measured`, `apply_measured`): a dynamic circuit
    through the per-gate ('xla') or banded engine, each measurement's
    outcome drawn from a torch.Generator and read on the host, each
    classically controlled gate applied in place or skipped.

Every program runs on the device it was compiled for, in place on the
planes, at the matmul tier (quest_tpu_torch/precision.py) and, for the
fused engine, under the segment driver (QUEST_FUSED_DRIVER /
QUEST_FUSED_PIPELINE / QUEST_FUSED_NBUF, band_plan.active_driver) read
when it was compiled. Each is cached on its circuit, keyed on its
arguments, its device and `_engine_mode_key()` (every keyed knob's
effective value), so repeated calls reuse one program and a knob flip
builds a new one; adding an op clears the cache. QUEST_FUSED_SCAN=1
(the reference's lax.scan over runs of >= 3 swept segments of one
structure, `_scan_partition`) builds the same program: each segment is
already one launch of the one kernel binary with its operands resident
on the device, so grouping a run changes nothing until a CUDA graph
over it does (ROADMAP).

The sharded engines (ROADMAP A10, quest_tpu_torch/parallel):
`compiled_sharded` (per-gate), `compiled_sharded_banded`,
`compiled_sharded_fused` (the segment kernel on every shard),
`compiled_sharded_batched`, `compiled_sharded_measured`, their `apply_*`
forms, `explain_sharded` and `_comm_plan_stats`, cached like the others
and keyed on the mesh's device tuple.

The front ends (ROADMAP A9): `from_qasm` / `to_qasm` (qasm_import.py,
qasm.py), `transpiled` (transpile.py, memoised until the circuit
changes), `plan_stats` (a view of plan.build_plan) and `explain`'s plan
and transpile lines (plan.autotune, transpile.transpile_cached).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from quest_tpu_torch import measurement as MS
from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.env import engine_mode_key, knob_value, resolve_device
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.ops import segment as _segment
from quest_tpu_torch.ops.segment import (Segment, batch_of, prepare_segment,
                                         segment_sweep,
                                         segment_sweep_reference)
from quest_tpu_torch.profiling import annotate

_LOOP_UNROLL_MAX = 32
# op count above which Circuit.apply takes the banded engine (ref
# circuit.py:49, where the per-gate XLA chain compiles pathologically
# slowly; here it is the per-gate engine's pass count that grows)
PERGATE_COMPILE_WARN_OPS = 64
PLAIN_CHUNK_STATES = 8        # states per plain-path pass of a batch
# runs of segments of one structure the reference's scan groups
# (_scan_partition; planning only in the port, see the module docstring)
SCAN_MIN = 3


def _engine_mode_key():
    """The mode flags every compiled-program cache key carries (ref
    circuit.py:109): env.engine_mode_key(), every keyed knob's effective
    value (the matmul tier through set_matmul_precision too)."""
    return engine_mode_key()


@dataclasses.dataclass(frozen=True)
class GateOp:
    kind: str                 # 'matrix' | 'diagonal' | 'parity' | 'allones' |
    # 'superop' | 'measure' | 'classical' ('measure_dm' once flattened)
    targets: Tuple[int, ...]
    controls: Tuple[int, ...] = ()
    cstates: Tuple[int, ...] = ()
    operand: object = None    # matrix / diag vector / angle / phase term
    meta: object = None       # Circuit.kraus stores ("kraus", <raw Kraus
    # operators>) beside the superoperator; the engines never execute it


_DYNAMIC = ("measure", "measure_dm", "classical")


def dual_of(op, shift: int):
    """The column-space dual of a gate on a density register: conjugated
    operand on targets/controls shifted by N (ref QuEST.c:8-10). A parity
    rotation's dual negates its angle; a scheduler-composed diagonal
    (fusion.ComposedDiag) negates each part's angle too. Superoperators
    already act on both spaces: no dual (returns None)."""
    if op.kind == "superop":
        return None
    if op.kind == "parity":
        return dataclasses.replace(
            op, targets=tuple(t + shift for t in op.targets),
            operand=-op.operand)
    moved = dict(targets=tuple(t + shift for t in op.targets),
                 controls=tuple(c + shift for c in op.controls),
                 operand=np.conj(op.operand))
    parts = getattr(op, "parts", None)
    if parts:
        moved["parts"] = tuple((kind, bits, -ang)
                               for kind, bits, ang in parts)
    return dataclasses.replace(op, **moved)


def inverse_op(op) -> "GateOp":
    """The adjoint of one GateOp (ref circuit.py:226): matrix -> U+,
    diagonal / allones -> conjugate, parity -> negated angle, controls
    kept. Raises on noise channels, measurements and classically
    controlled gates."""
    if op.kind == "superop" or op.kind in _DYNAMIC:
        what = {"superop": "noise channels", "measure": "measurements",
                "measure_dm": "measurements",
                "classical": "classically-controlled gates"}
        raise val.QuESTError(
            f"Invalid operation: a circuit containing {what[op.kind]} has "
            f"no inverse.")
    if op.kind == "matrix":
        operand = np.asarray(op.operand).conj().T
    elif op.kind in ("diagonal", "allones"):
        operand = np.conj(op.operand)
    else:                      # parity: exp(-i a/2 Z..Z)
        operand = -op.operand
    parts = getattr(op, "parts", None)
    if parts:
        return dataclasses.replace(
            op, operand=operand,
            parts=tuple((k, b, -a) for k, b, a in parts))
    return dataclasses.replace(op, operand=operand)


# the fixed Cliffords a stored 2x2 operand may equal exactly (ref
# circuit.py:125): as_rotation reads them as constants
_NAMED_2x2 = (("h", M.HADAMARD), ("x", M.PAULI_X), ("y", M.PAULI_Y),
              ("z", M.PAULI_Z))


def _named_1q(u):
    """(gate name, params) of a stored 2x2 operand, or None (ref
    circuit.py:131): the fixed Cliffords by exact match, rx/ry by the
    structural recovery of as_rotation, for to_qasm's named lines."""
    for name, mat in _NAMED_2x2:
        if np.array_equal(u, mat):
            return (name, ())
    rot = as_rotation(GateOp("matrix", (0,), operand=u))
    return (rot[0], (rot[1],)) if rot is not None else None


def _named_diag(d):
    """(gate name, params) of a stored (2,) diagonal operand, or None
    (ref circuit.py:151)."""
    if np.array_equal(d, M.Z_DIAG):
        return ("z", ())
    if np.array_equal(d, M.S_DIAG):
        return ("s", ())
    if np.array_equal(d, M.T_DIAG):
        return ("t", ())
    if abs(d[0] - 1.0) < 1e-14 and abs(abs(d[1]) - 1.0) < 1e-14:
        return ("phase", (float(np.angle(d[1])),))
    return None


def as_rotation(op: GateOp):
    """(family, theta) of a parametric op, or None for a constant gate
    (ref circuit.py:165): the structural inverse of the angle-taking
    builders, which the adjoint engine (adjoint.py) needs to
    differentiate a gate.

      'parity'  exp(-i th/2 Z..Z)  theta = the stored angle
      'rx'/'ry' M.rotation(th, x/y axis), recovered with arctan2 over
                the matrix's 4pi period
      'phase'   diagonal [1, e^{i th}] on one target
      'allones' e^{i th} on the all-ones subspace (cphase)

    Exact constants (h/x/y/z, the z/s/t diagonals, cz's -1) return None;
    the builders never produce them from a generic angle."""
    if op.kind == "parity":
        return ("parity", float(op.operand))
    if op.kind == "matrix":
        u = np.asarray(op.operand)
        if u.shape != (2, 2):
            return None
        for _, mat in _NAMED_2x2:
            if np.array_equal(u, mat):
                return None
        c, o = u[0, 0], u[0, 1]
        if (abs(c.imag) < 1e-14 and abs(o.real) < 1e-14
                and np.allclose(u, [[c, o], [o, c]])):
            th = 2.0 * np.arctan2(-o.imag, c.real)
            if np.allclose(u, M.rotation(th, (1.0, 0.0, 0.0))):
                return ("rx", float(th))
        if (np.allclose(u.imag, 0.0, atol=1e-14)
                and np.allclose(u, [[c, o], [-o, c]])):
            th = 2.0 * np.arctan2(-o.real, c.real)
            if np.allclose(u, M.rotation(th, (0.0, 1.0, 0.0))):
                return ("ry", float(th))
        return None
    if op.kind == "diagonal":
        d = np.asarray(op.operand)
        if d.shape != (2,):
            return None
        if (np.array_equal(d, M.Z_DIAG) or np.array_equal(d, M.S_DIAG)
                or np.array_equal(d, M.T_DIAG)):
            return None
        if abs(d[0] - 1.0) < 1e-14 and abs(abs(d[1]) - 1.0) < 1e-14:
            return ("phase", float(np.angle(d[1])))
        return None
    if op.kind == "allones":
        term = complex(op.operand)
        if abs(term + 1.0) < 1e-14:      # cz/ccz: exact constant
            return None
        if abs(abs(term) - 1.0) < 1e-14:
            return ("allones", float(np.angle(term)))
        return None
    return None


def _render_operand(x):
    """A value fingerprint of an operand (ref plan.py:599), or None for
    one that is not a concrete array."""
    import hashlib
    if x is None:
        return ["none"]
    try:
        arr = np.asarray(x)
        if arr.dtype == object:
            return None
        return ["arr", list(arr.shape), arr.dtype.str,
                hashlib.sha256(
                    np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]]
    except Exception:
        return None


def _op_fingerprint(op):
    """[kind, targets, controls, cstates, operand fingerprint] of one op,
    or None when its operand is not concrete (the port's copy of ref
    plan.py:625, the gradient engine's cache key)."""
    operand = _render_operand(op.operand)
    if operand is None:
        return None
    return [op.kind, list(op.targets), list(op.controls),
            list(op.cstates or []), operand]


def flatten_ops(ops, n: int, density: bool) -> List[GateOp]:
    """The flat op list the engines plan from (ref circuit.py:258-312):
    on a density register (n = 2N state qubits) every gate is followed
    by its dual, each superoperator becomes a matrix op on [targets,
    targets + N], a measurement becomes 'measure_dm' claiming both
    copies of its qubit (targets[0] stays the logical qubit, so the
    planner cannot commute a later gate's dual back across the
    collapse), and a classically controlled op carries its inner gates
    with their duals, claiming every qubit they touch."""
    if not density and any(op.kind == "superop" for op in ops):
        raise val.QuESTError(
            "Invalid operation: noise channels require a density-matrix "
            "register")
    flat: List[GateOp] = []
    for op in ops:
        if density and any(q >= n // 2 for q in (*op.targets, *op.controls)):
            raise ValueError(
                f"a density register of {n} state qubits holds {n // 2} "
                f"qubits; {op.kind} op on {op.targets + op.controls}")
        if op.kind == "superop":
            flat.append(dataclasses.replace(
                op, kind="matrix",
                targets=M.superop_targets(op.targets, n // 2)))
            continue
        if op.kind == "measure":
            if density:
                q0 = op.targets[0]
                op = dataclasses.replace(op, kind="measure_dm",
                                         targets=(q0, q0 + n // 2))
            flat.append(op)
            continue
        if op.kind == "classical" and density:
            inners, conds = op.operand
            expanded, claim = [], []
            for g in inners:
                for h in (g, dual_of(g, n // 2)):
                    expanded.append(h)
                    claim += list(h.targets) + list(h.controls)
            flat.append(dataclasses.replace(
                op, targets=tuple(dict.fromkeys(claim)),
                operand=(tuple(expanded), conds)))
            continue
        flat.append(op)
        if density and op.kind != "classical":
            flat.append(dual_of(op, n // 2))
    return flat


def _apply_one(amps: torch.Tensor, n: int, op, tier: str) -> torch.Tensor:
    """One GateOp of a flat list (flatten_ops: superoperators are matrix
    ops there) on the planes, in place (ref circuit.py:330)."""
    if op.kind == "parity":
        return A.apply_parity_phase(amps, n, op.targets, op.operand)
    if op.kind == "allones":
        return A.apply_phase_on_all_ones(amps, n, op.targets, op.operand)
    if op.kind == "diagonal":
        return A.apply_diagonal(amps, n, op.operand, op.targets, op.controls,
                                op.cstates)
    return A.apply_matrix(amps, n, op.operand, op.targets, op.controls,
                          op.cstates, tier)


def _apply_item(amps: torch.Tensor, n: int, it, tier: str) -> torch.Tensor:
    """One fusion-plan item (BandOp, DiagItem, PassOp) or GateOp of the
    flat list, in place (ref _apply_banded_items, :353; the flat list
    holds each op's density dual after it, the reference's _apply_op)."""
    if isinstance(it, F.BandOp):
        return A.apply_band(amps, n, (it.gre, it.gim), it.ql, it.w, it.preds,
                            tier)
    if isinstance(it, (F.DiagItem, F.PassOp)):
        return _apply_one(amps, n, it.op, tier)
    return _apply_one(amps, n, it, tier)


def _apply_banded_items(amps: torch.Tensor, n: int, items,
                        tier: str) -> torch.Tensor:
    """Apply an already computed fusion plan, in place (ref :353)."""
    for it in items:
        _apply_item(amps, n, it, tier)
    return amps


# programs Circuit._cached has built in this process (its misses), read
# by analysis/audit.CompileAuditor
PROGRAM_BUILDS = 0


def _states(amps: torch.Tensor, n: int) -> int:
    """States of n qubits that the planes hold (1 unbatched)."""
    return max(1, amps.numel() // (2 << n))


class XlaPass:
    """A plan item between kernel segments that no stage reaches (a
    cross-band or wide matrix, a channel superoperator, a band above the
    block top, a diagonal), applied in place by ops/apply at the tier of
    the program it belongs to, as the reference applies it outside
    Pallas (circuit.py:541-569). Takes one state's planes or a batch."""

    def __init__(self, item, n: int, tier: str):
        self.item = item
        self.n = n
        self.tier = tier

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        if _segment.WORK_RECORDERS and _segment.note_work(
                "pass", self, _states(amps, self.n), amps.element_size()):
            return amps
        return _apply_item(amps, self.n, self.item, self.tier)


def _device_key(device: torch.device) -> str:
    """A cache key's device: 'cuda' names the current card, so a program
    built for device=None (or 'cuda') is the one a register on that card
    finds."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _check_device(amps: torch.Tensor, device: torch.device) -> None:
    """Programs run on the device they were compiled for, never another."""
    if amps.device.type != device.type or (
            device.index is not None and amps.device.index != device.index):
        raise ValueError(f"planes on {amps.device}; the program was "
                         f"compiled for {device}")


class XlaProgram:
    """A compiled per-gate (`kind` 'pergate': the flat op list) or banded
    ('banded': a fusion plan) program: call it on the planes of one
    state ((2, 2^n) or the fused view, f32 or f64) or on a batch (B, 2,
    ...) of them, on `device`; it applies `items` in order, `iters`
    times, in place through ops/apply at matmul `tier`, and returns the
    planes. Plain tensor code: there is no kernel to hold it against."""

    def __init__(self, kind: str, n: int, items: List, iters: int,
                 tier: str, device: torch.device):
        self.kind = kind
        self.n = n
        self.items = items
        self.iters = iters
        self.tier = tier
        self.device = device

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        if _segment.WORK_RECORDERS and _segment.note_work(
                "xla", self, _states(amps, self.n), amps.element_size()):
            return amps
        _check_device(amps, self.device)
        for _ in range(self.iters):
            _apply_banded_items(amps, self.n, self.items, self.tier)
        return amps


def _sweep_unrolled(raw, n: int, iters: int, driver: str):
    """(swept parts of one program call, loop count) of the raw segment
    plan `raw` of one application: up to _LOOP_UNROLL_MAX applications
    are unrolled into one sweep plan (ref compiled_fused)."""
    unroll = iters if 1 < iters <= _LOOP_UNROLL_MAX else 1
    if not knob_value("QUEST_SWEEP_FUSION"):
        return raw, iters
    return BP.sweep_plan(raw * unroll, n, driver=driver), iters // unroll


def _scan_partition(parts, scan_min: int):
    """Group maximal runs of >= scan_min consecutive kernel segments
    sharing ONE structure (identical stage tuple; operands differ) into
    ('scan', stages, [arrays, ...]) elements; everything else passes
    through as ('one', part). scan_min <= 0 disables grouping (ref
    circuit.py:482, pure planning)."""
    out = []
    i = 0
    while i < len(parts):
        part = parts[i]
        if scan_min > 0 and part[0] == "segment":
            seg_key = tuple(part[1])
            j = i
            while (j < len(parts) and parts[j][0] == "segment"
                   and tuple(parts[j][1]) == seg_key):
                j += 1
            if j - i >= scan_min:
                out.append(("scan", part[1], [p[2] for p in parts[i:j]]))
                i = j
                continue
        out.append(("one", part))
        i += 1
    return out


class FusedProgram:
    """A compiled fused program: call it on (2, 2^n) or (2, rows, 128)
    f32 planes, or on a batch (B, 2, ...) of them; it updates them in
    place (one kernel launch per swept segment on the card, whatever B
    is; apply_matrix_rows for each matrix passthrough) and returns them.
    `steps` is one application in order, `segments` its packed
    segments; `plain(amps)` runs the same plan through the plain PyTorch
    version, out of place, PLAIN_CHUNK_STATES states of a batch at a
    time, for comparison. `tier` is the matmul tier it was compiled at
    (precision.matmul_precision() then), `driver` and `nbuf` the segment
    driver and in-place slots (band_plan.active_driver(),
    QUEST_FUSED_NBUF then); every call runs under them. f64 planes (the
    kernel is f32) run `items`, the fusion plan the segments were cut
    from, through the banded primitives `iters` times instead, in place,
    as the reference's program routes them at call time
    (circuit.py:1321). Its plan record is Circuit.plan_stats()['fused']
    (band_plan.fused_record)."""

    def __init__(self, n: int, steps: List, loop_iters: int, tier: str,
                 driver: str, nbuf: int, items: List, iters: int,
                 device: torch.device):
        self.n = n
        self.steps = steps
        self.segments = [s for s in steps if isinstance(s, Segment)]
        self.loop_iters = loop_iters
        self.tier = tier
        self.driver = driver
        self.nbuf = nbuf
        self.banded = XlaProgram("banded", n, items, iters, tier, device)

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        if amps.dtype == torch.float64:
            return self.banded(amps)
        for _ in range(self.loop_iters):
            for step in self.steps:
                if isinstance(step, Segment):
                    segment_sweep(amps, step)
                else:
                    step(amps)
        return amps

    def plain(self, amps: torch.Tensor) -> torch.Tensor:
        if amps.dtype == torch.float64:
            return self.banded(amps.clone())
        b = batch_of(amps, self.n)
        if b > PLAIN_CHUNK_STATES:
            return torch.cat([self.plain(amps[i:i + PLAIN_CHUNK_STATES])
                              for i in range(0, b, PLAIN_CHUNK_STATES)])
        out = amps
        for _ in range(self.loop_iters):
            for step in self.steps:
                if isinstance(step, Segment):
                    out = segment_sweep_reference(out, step.stages,
                                                  step.operands, self.n,
                                                  tier=step.tier)
                else:
                    if out is amps:
                        out = amps.clone()
                    step(out)
        return out.reshape(amps.shape)

    @property
    def launches_per_call(self) -> int:
        return self.loop_iters * len(self.segments)


class Circuit:
    """Builder for a fixed gate sequence over `num_qubits` qubits."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.ops: List[GateOp] = []
        self._compiled = {}     # programs, keyed (see _engine_mode_key)
        self._transpiled = {}   # transpile.transpile_cached's memo

    # -- builders (chainable) ------------------------------------------------

    def _add(self, kind, targets, operand, controls=(), cstates=None,
             meta=None):
        targets = tuple(int(t) for t in targets)
        controls = tuple(int(c) for c in controls)
        cstates = (tuple(int(s) for s in cstates) if cstates is not None
                   else (1,) * len(controls))
        val.validate_gate_qubits(self.num_qubits, targets, controls, cstates)
        self.ops.append(GateOp(kind, targets, controls, cstates, operand,
                               meta))
        self._compiled.clear()
        self._transpiled.clear()
        return self

    def gate(self, matrix, targets, controls=(), cstates=None):
        return self._add("matrix", targets,
                         np.asarray(matrix, dtype=np.complex128),
                         controls, cstates)

    def h(self, t):
        return self._add("matrix", (t,), M.HADAMARD)

    def x(self, t, *controls):
        return self._add("matrix", (t,), M.PAULI_X, controls)

    def y(self, t):
        return self._add("matrix", (t,), M.PAULI_Y)

    def z(self, t):
        return self._add("diagonal", (t,), M.Z_DIAG)

    def s(self, t):
        return self._add("diagonal", (t,), M.S_DIAG)

    def t(self, tq):
        return self._add("diagonal", (tq,), M.T_DIAG)

    def phase(self, t, angle):
        return self._add("diagonal", (t,),
                         np.array([1.0, np.exp(1j * angle)]))

    def rx(self, t, angle):
        return self._add("matrix", (t,),
                         np.asarray(M.rotation(angle, (1., 0., 0.))))

    def ry(self, t, angle):
        return self._add("matrix", (t,),
                         np.asarray(M.rotation(angle, (0., 1., 0.))))

    def rz(self, t, angle):
        return self._add("parity", (t,), float(angle))

    def cnot(self, control, target):
        return self._add("matrix", (target,), M.PAULI_X, (control,))

    def cz(self, q1, q2):
        return self._add("allones", (q1, q2), -1.0 + 0.0j)

    def swap(self, q1, q2):
        return self._add("matrix", (q1, q2), M.SWAP)

    def cu(self, matrix, target, *controls, cstates=None):
        """Arbitrary single/multi-controlled k-qubit unitary."""
        t = (target,) if np.isscalar(target) else tuple(target)
        return self._add("matrix", t, np.asarray(matrix, dtype=np.complex128),
                         controls, cstates)

    def cphase(self, angle, *qubits):
        """Symmetric controlled phase e^{i angle} on all-ones of qubits."""
        return self._add("allones", tuple(qubits), np.exp(1j * float(angle)))

    def multi_rotate_z(self, targets, angle):
        return self._add("parity", tuple(targets), float(angle))

    def multi_rotate_pauli(self, targets, paulis, angle):
        """exp(-i angle/2 P1 x P2 x ...) as basis rotations around a
        parity phase (ref circuit.py:793, statevec_multiRotatePauli,
        QuEST_common.c:410-447): the 1q basis changes compose into the
        neighbouring band operators. The eager API takes the one-pass
        flip form instead (ops/gates.multi_rotate_pauli)."""
        f = 1.0 / np.sqrt(2.0)
        to_z = {1: np.array([[f, f], [-f, f]]),             # Ry(-pi/2)
                2: np.array([[f, -1j * f], [-1j * f, f]])}  # Rx(pi/2)
        z_targets = []
        for t, p in zip(targets, paulis):
            p = int(p)
            if p == 0:
                continue
            z_targets.append(int(t))
            if p in to_z:
                self._add("matrix", (int(t),), to_z[p])
        if z_targets:
            self._add("parity", tuple(z_targets), float(angle))
        for t, p in zip(targets, paulis):
            if int(p) in to_z:
                self._add("matrix", (int(t),), to_z[int(p)].conj().T)
        return self

    def sqrt_swap(self, q1, q2):
        return self._add("matrix", (q1, q2), M.SQRT_SWAP)

    def inverse(self) -> "Circuit":
        """The adjoint circuit: ops reversed, each through inverse_op
        (ref circuit.py:974). Raises on noise channels and dynamic ops."""
        inv = Circuit(self.num_qubits)
        inv.ops = [inverse_op(op) for op in reversed(self.ops)]
        return inv

    # -- the front ends (ref circuit.py:988-1087, :1477-1522) ----------------

    @classmethod
    def from_qasm(cls, text: str, u_dialect: str = None,
                  transpile: bool = None) -> "Circuit":
        """Parse OPENQASM 2.0 text into a Circuit (qasm_import.py): the
        recorder's dialect and standard qelib1 gates. `u_dialect`
        ('spec' | 'recorder') pins the capital-U convention; `transpile`
        (None follows QUEST_TRANSPILE) routes the stream through the
        transpiler."""
        from quest_tpu_torch.qasm_import import circuit_from_qasm
        return circuit_from_qasm(text, u_dialect=u_dialect,
                                 transpile=transpile)

    def to_qasm(self) -> str:
        """OPENQASM 2.0 text of this circuit through the eager API's
        logger (qasm.py): named gates recovered from the stored operands,
        general 1q operands as ZYZ U-lines, ops with no QASM equivalent
        as comments (ref circuit.py:1002)."""
        from quest_tpu_torch import qasm as Q

        log = Q.QASMLogger(self.num_qubits)
        log.is_logging = True
        for op in self.ops:
            targets, controls = op.targets, op.controls
            cstates = op.cstates or (1,) * len(controls)
            if op.kind == "measure":
                log.record_measurement(targets[0])
            elif op.kind == "classical":
                log.record_comment(
                    "Here a classically-controlled gate was applied "
                    f"(conditions on measurements {list(op.operand[1])})")
            elif op.kind == "parity":
                if len(targets) == 1 and not controls:
                    log.record_gate("rz", targets[0], (), (op.operand,))
                else:
                    log.record_comment(
                        f"Here a multiRotateZ of angle {op.operand:g} was "
                        f"applied to qubits {list(targets)}")
            elif op.kind == "allones":
                term = complex(op.operand)
                qubits = tuple(targets) + tuple(controls)
                if any(s == 0 for s in cstates):
                    # a control-on-0 all-ones phase is not symmetric:
                    # anchor the diagonal on a condition-on-1 target
                    log.record_multi_state_controlled_unitary(
                        np.diag([1.0, term]),
                        tuple(targets[:-1]) + tuple(controls),
                        (1,) * (len(targets) - 1) + tuple(cstates),
                        targets[-1])
                elif abs(term + 1.0) < 1e-14:
                    log.record_gate("z", qubits[-1], qubits[:-1])
                else:
                    log.record_gate("phase", qubits[-1], qubits[:-1],
                                    (float(np.angle(term)),))
            elif op.kind == "diagonal" and len(targets) == 1:
                d = np.asarray(op.operand).reshape(-1)
                named = _named_diag(d)
                if any(s == 0 for s in cstates):
                    log.record_multi_state_controlled_unitary(
                        np.diag(d), controls, cstates, targets[0])
                elif named is not None:
                    log.record_gate(named[0], targets[0], controls,
                                    named[1])
                else:
                    log.record_unitary(np.diag(d), targets[0], controls)
            elif op.kind == "matrix" and len(targets) == 1:
                u = np.asarray(op.operand)
                named = _named_1q(u)
                if any(s == 0 for s in cstates):
                    log.record_multi_state_controlled_unitary(
                        u, controls, cstates, targets[0])
                elif named is not None:
                    log.record_gate(named[0], targets[0], controls,
                                    named[1])
                else:
                    log.record_unitary(u, targets[0], controls)
            elif (op.kind == "matrix" and len(targets) == 2
                  and not controls and np.array_equal(op.operand, M.SWAP)):
                log.record_gate("swap", targets[1], (targets[0],))
            elif (op.kind == "matrix" and len(targets) == 2
                  and not controls and np.allclose(op.operand, M.SQRT_SWAP)):
                log.record_gate("sqrtswap", targets[1], (targets[0],))
            else:
                log.record_comment("Here a multi-qubit gate was applied "
                                   "(no QASM equivalent)")
        return log.recorded()

    def transpiled(self, exact_only: bool = False) -> "Circuit":
        """An equivalent circuit rewritten by the transpiler
        (transpile.py): self when no pass fires. `exact_only` keeps the
        bit-identical subset. The report rides on the result as
        `_transpile_report`; memoised until this circuit changes."""
        from quest_tpu_torch import transpile as T
        return T.transpile_cached(self, exact_only=exact_only)[0]

    def plan_stats(self, density: bool = False, batch: int = None,
                   devices: int = None) -> dict:
        """The reference's plan statistics dict (ref circuit.py:1477), a
        view of plan.build_plan's ProgramPlan: the scheduler's counters,
        the banded pass model, the fused record under HOPPER_GEOMETRY
        (from 10 qubits), the batched record (`batch`), the f64 record,
        the gradient and transpile axes, and with `devices` the comm
        planner's predicted schedule of the banded/fused sharded engines
        over that many shards ('comm', pure host math)."""
        self._reject_measure("plan_stats")
        from quest_tpu_torch import plan as P
        return P.build_plan(self, density=density, batch=batch,
                            devices=devices).stats()

    # -- dynamic circuits (ref circuit.py:717-790) ---------------------------

    def measure(self, qubit):
        """Mid-circuit measurement of `qubit` in the computational basis;
        circuits holding one run through compiled_measured /
        apply_measured, which return the outcomes in program order."""
        return self._add("measure", (int(qubit),), None)

    def gate_if(self, matrix, targets, when, controls=(), cstates=None):
        """A classically controlled gate: `matrix` on `targets` only when
        earlier outcomes match `when`, a (measurement index, wanted bit)
        pair or a sequence of them (indices count measure() calls in
        program order)."""
        when = tuple(when)
        if when and all(hasattr(w, "__len__") for w in when):
            when = tuple(tuple(w) for w in when)
        else:
            when = (when,)
        if not all(len(w) == 2 for w in when) or not when:
            raise ValueError(
                "gate_if condition must be a (measurement index, wanted "
                "bit) pair or a non-empty sequence of such pairs")
        n_meas = self._measure_count()
        for idx, want in when:
            if not 0 <= int(idx) < n_meas:
                raise ValueError(
                    f"gate_if condition references measurement {idx}, but "
                    f"only {n_meas} measure() calls precede it")
            if int(want) not in (0, 1):
                raise ValueError("wanted outcome must be 0 or 1")
        inner = GateOp("matrix", tuple(int(t) for t in targets),
                       tuple(int(c) for c in controls),
                       tuple(cstates) if cstates is not None
                       else (1,) * len(controls),
                       np.asarray(matrix, dtype=np.complex128))
        return self._add(
            "classical", inner.targets + inner.controls,
            ((inner,), tuple((int(i), int(w)) for i, w in when)))

    def x_if(self, target, when):
        return self.gate_if(M.PAULI_X, (target,), when)

    def z_if(self, target, when):
        return self.gate_if(M.PAULI_Z, (target,), when)

    def reset(self, qubit):
        """Reset `qubit` to |0> mid-circuit: measure it and flip it on
        outcome 1 (its outcome stays in the returned sequence)."""
        self.measure(qubit)
        return self.x_if(qubit, (self._measure_count() - 1, 1))

    def _measure_count(self) -> int:
        return sum(1 for op in self.ops if op.kind == "measure")

    def _dynamic_count(self) -> int:
        return sum(1 for op in self.ops
                   if op.kind in ("measure", "classical"))

    def _reject_measure(self, what: str):
        if self._dynamic_count():
            raise val.QuESTError(
                f"Invalid operation: this circuit contains mid-circuit "
                f"measurements; use compiled_measured/apply_measured "
                f"instead of {what}.")

    def _cached(self, key, build):
        """The program under `key` (extended by the op count, which
        guards a direct append to `ops`, and _engine_mode_key()), built
        by `build()` on a miss."""
        global PROGRAM_BUILDS
        key = key + (len(self.ops), _engine_mode_key())
        prog = self._compiled.get(key)
        if prog is None:
            PROGRAM_BUILDS += 1
            prog = self._compiled[key] = build()
        return prog

    # -- noise channels (density-matrix circuits only) -----------------------

    def kraus(self, targets, ops):
        """General Kraus map: a superoperator on the doubled register
        (ref QuEST_common.c:540-673), validated at build time like the
        reference's mixKrausMap. The raw operators ride in `meta`."""
        t = (targets,) if np.isscalar(targets) else tuple(targets)
        k = len(t)
        val.validate_kraus_ops(ops, k, max_ops=1 << (2 * k))
        raw = tuple(np.asarray(K, dtype=np.complex128) for K in ops)
        return self._add("superop", t, M.kraus_superoperator(ops),
                         meta=("kraus", raw))

    def damping(self, target, prob):
        p = float(prob)
        val.validate_one_qubit_damping_prob(p)
        return self.kraus(target, M.damping_kraus(p))

    def depolarising(self, target, prob):
        p = float(prob)
        val.validate_one_qubit_depol_prob(p)
        return self.kraus(target, M.depolarising_kraus(p))

    def dephasing(self, target, prob):
        p = float(prob)
        val.validate_one_qubit_dephase_prob(p)
        return self.kraus(target, M.dephasing_kraus(p))

    # -- planning ------------------------------------------------------------

    def _planned_flat(self, n: int, density: bool) -> List[GateOp]:
        """Flattened, then reordered/composed by the commutation-aware
        scheduler (fusion.maybe_schedule, QUEST_SCHEDULE knob). The
        per-gate engine stays unscheduled: it is the oracle the
        scheduled engines are held against."""
        return F.maybe_schedule(flatten_ops(self.ops, n, density), n)

    def fused_plan(self, n: int, density: bool = False):
        """(items, raw): the scheduled flat list planned on the kernel's
        bands (plan_bands), and the raw segment plan of one application
        built from those items (before sweep fusion), under
        HOPPER_GEOMETRY. The fused engine runs the raw plan, and its f64
        route the items."""
        items = self.banded_items(n, density, bands=BP.plan_bands(n))
        return items, BP.segment_plan(items, n)

    def segment_parts(self, n: int, density: bool = False):
        """The raw segment plan of one application (fused_plan's)."""
        return self.fused_plan(n, density)[1]

    def fused_parts(self, n: int, iters: int = 1, density: bool = False,
                    driver: str = None):
        """(swept part list of one program call, loop count): the
        reference's compiled_fused planning, under HOPPER_GEOMETRY and the
        operand budget of `driver` (None: the knobs'). `n` counts state
        qubits (2N for a density register)."""
        return _sweep_unrolled(self.segment_parts(n, density), n, iters,
                               driver)

    # -- the per-gate and banded engines -------------------------------------

    def trace(self, amps: torch.Tensor, n: int, density: bool,
              tier: str = None) -> torch.Tensor:
        """Apply every op, unscheduled, to raw planes in place (ref
        circuit.py:1089), at `tier` (None: the session's)."""
        self._reject_measure("trace")
        tier = precision.check_tier(tier or precision.matmul_precision())
        precision.ieee_fp32()
        return _apply_banded_items(amps, n, flatten_ops(self.ops, n, density),
                                   tier)

    def compiled(self, n: int, density: bool = False, iters: int = 1,
                 device=None) -> XlaProgram:
        """The per-gate engine on `n` state qubits (ref circuit.py:1101):
        every op of the unscheduled flat list (density duals included)
        through ops/apply, `iters` times, on `device` (default: the CUDA
        card) at the session's matmul tier, both read when it is built
        and kept; cached per (n, density, iters, device, mode key)."""
        self._reject_measure("compiled")
        dev = resolve_device(device)

        def build():
            tier = precision.matmul_precision()
            precision.ieee_fp32()
            return XlaProgram("pergate", n, flatten_ops(self.ops, n, density),
                              iters, tier, dev)
        return self._cached(("pergate", n, density, iters, _device_key(dev)), build)

    def apply(self, q):
        """Apply the circuit to register `q` in place on its device;
        returns the register (ref circuit.py:1122). A circuit of more than
        PERGATE_COMPILE_WARN_OPS ops without channels runs through the
        banded engine (QUEST_APPLY_AUTOROUTE, default 1), else through
        the per-gate engine. A sharded register runs the sharded per-gate
        engine on its own mesh (apply_sharded)."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if not torch.is_tensor(q.amps):
            return self.apply_sharded(q, q.amps.mesh)
        if (len(self.ops) > PERGATE_COMPILE_WARN_OPS
                and not self._dynamic_count()
                and not any(op.kind == "superop" for op in self.ops)
                and knob_value("QUEST_APPLY_AUTOROUTE")):
            return self.apply_banded(q)
        fn = self.compiled(q.num_state_qubits, q.is_density,
                           device=q.amps.device)
        return q.replace_amps(fn(q.amps))

    def banded_items(self, n: int, density: bool = False, bands=None):
        """The fusion plan the banded engine applies: the scheduled flat
        list planned on 7-qubit bands (`bands`: another layout, as
        fusion.plan takes it)."""
        return F.plan(self._planned_flat(n, density), n, bands=bands)

    def compiled_banded(self, n: int, density: bool = False, iters: int = 1,
                        device=None) -> XlaProgram:
        """The banded engine on `n` state qubits (ref circuit.py:1157):
        runs of commuting gates composed into one operator per 7-qubit
        band, each applied as one contraction (apply.apply_band);
        diagonals, parity phases and cross-band matrices through their
        primitives. On `device` (default: the CUDA card) at the session's
        matmul tier, read when it is built and kept; cached."""
        self._reject_measure("compiled_banded")
        dev = resolve_device(device)

        def build():
            tier = precision.matmul_precision()
            precision.ieee_fp32()
            return XlaProgram("banded", n, self.banded_items(n, density),
                              iters, tier, dev)
        return self._cached(("banded", n, density, iters, _device_key(dev)), build)

    def banded_trace(self, amps: torch.Tensor, n: int, density: bool,
                     tier: str = None) -> torch.Tensor:
        """Apply the banded plan to raw planes in place (ref :1238)."""
        self._reject_measure("banded_trace")
        tier = precision.check_tier(tier or precision.matmul_precision())
        precision.ieee_fp32()
        return _apply_banded_items(amps, n, self.banded_items(n, density),
                                   tier)

    def apply_banded(self, q):
        """Apply through the banded engine on the register's device, in
        place; returns the register (ref :1246); a sharded register
        through the sharded banded engine on its own mesh."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if not torch.is_tensor(q.amps):
            return self.apply_sharded_banded(q, q.amps.mesh)
        fn = self.compiled_banded(q.num_state_qubits, q.is_density,
                                  device=q.amps.device)
        return q.replace_amps(fn(q.amps))

    # -- the fused engine ----------------------------------------------------

    def compiled_fused(self, n: int, density: bool = False, iters: int = 1,
                       device=None):
        """The fused engine on `n` state qubits (2N for a density
        register over N): each swept segment of band operators, Kraus
        pairs, diagonals and parity phases runs as ONE launch of the
        segment kernel, in place on the state; a passthrough runs
        through ops/apply between segments. Operands and descriptor
        tables go to `device` (default: the CUDA card) once, when the
        program is built; calls reuse them. The matmul tier
        (QUEST_MATMUL_PRECISION or precision.set_matmul_precision) and
        the segment driver (QUEST_FUSED_DRIVER, QUEST_FUSED_PIPELINE,
        QUEST_FUSED_NBUF) are read then, as the reference reads them at
        trace time: the program keeps them, and the cache key carries
        them, so a flip builds a new program. QUEST_FUSED_SCAN is keyed
        too and builds the same steps. Below the kernel's 10
        qubits this is compiled_banded (ref circuit.py:1274); f64 planes
        run the plan's banded items (FusedProgram)."""
        self._reject_measure("compiled_fused")
        if not BP.usable(n):
            return self.compiled_banded(n, density, iters, device)
        dev = resolve_device(device)

        def build():
            with annotate("plan.fused"):
                tier = precision.matmul_precision()
                driver = BP.active_driver()
                nbuf = knob_value("QUEST_FUSED_NBUF")
                precision.ieee_fp32()
                with annotate("plan.fusion"):
                    items, raw = self.fused_plan(n, density)
                with annotate("plan.sweep"):
                    parts, loop_iters = _sweep_unrolled(raw, n, iters,
                                                        driver)
                with annotate("plan.upload"):
                    steps = [prepare_segment(p[1], p[2], n, dev, tier=tier,
                                             driver=driver, nbuf=nbuf)
                             if p[0] == "segment" else XlaPass(p[1], n, tier)
                             for p in parts]
                return FusedProgram(n, steps, loop_iters, tier, driver,
                                    nbuf, items, iters, dev)
        return self._cached(("fused", n, density, iters, _device_key(dev)), build)

    def apply_fused(self, q, iters: int = 1):
        """Apply the circuit to register `q` (statevector or density)
        through the fused engine on the register's device, in place on
        its planes; returns the register (ref circuit.py:1343); a sharded
        register through the sharded fused engine on its own mesh (one
        application)."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if not torch.is_tensor(q.amps):
            if iters != 1:
                raise ValueError("a sharded register applies the circuit "
                                 "once a call (iters=1)")
            return self.apply_sharded_fused(q, q.amps.mesh)
        fn = self.compiled_fused(q.num_state_qubits, q.is_density, iters,
                                 device=q.amps.device)
        return q.replace_amps(fn(q.amps))

    def compiled_batched(self, batch: int, density: bool = False,
                         device=None, engine: str = None):
        """The batched engine (ref circuit.py:1352): one program that
        takes a batch (B, 2, ...) of states. engine None or 'fused': the
        circuit's FusedProgram, every swept segment ONE kernel launch over
        all states, so the launch count does not depend on the batch; the
        kernel takes B at launch and nothing planned depends on it, so
        the program runs any batch at its exact size (`batch`, >= 1, is
        the reference's signature, and no part of the cache key). f64
        batches run its banded items. engine 'banded', and engine None
        below the kernel's 10 qubits: the banded program over the whole
        batch. engine 'fused' below the kernel tier raises ValueError, as
        in the reference."""
        self._reject_measure("compiled_batched")
        if engine not in (None, "fused", "banded"):
            raise ValueError(
                f"engine must be None, 'fused' or 'banded', got {engine!r}")
        if int(batch) < 1:
            raise ValueError(f"batch size must be >= 1, got {batch}")
        n = self.num_qubits * 2 if density else self.num_qubits
        if engine == "fused" and not BP.usable(n):
            raise ValueError(
                f"engine='fused' requires the kernel tier; a {n}-qubit "
                f"register rides the banded program (engine='banded' or "
                f"None)")
        dev = resolve_device(device)

        def build():
            if engine == "banded":
                return self.compiled_banded(n, density, device=dev)
            return self.compiled_fused(n, density, device=dev)
        return self._cached(("batched", n, density, engine, _device_key(dev)), build)

    def apply_batched(self, amps_b: torch.Tensor,
                      density: bool = False) -> torch.Tensor:
        """Apply this circuit to a (B, 2, 2^n) batch of planes through
        the batched engine on their device, in place; returns them (ref
        circuit.py:1469)."""
        fn = self.compiled_batched(int(amps_b.shape[0]), density,
                                   device=amps_b.device)
        return fn(amps_b)

    def program_key(self, density: bool = False, dtype=np.float32) -> Tuple:
        """The identity of the batched program this circuit resolves to
        (ref circuit.py:1448): two requests may share one compiled_batched
        call iff their keys are equal. It holds the circuit object itself
        (compared by identity), its op count (a circuit grown after a
        submit is a new family), the register kind and size, the plane
        dtype (f32 runs the kernel, f64 the banded items) and
        _engine_mode_key()."""
        n = self.num_qubits * 2 if density else self.num_qubits
        return ("batched", self, len(self.ops), n, density,
                np.dtype(dtype).str, _engine_mode_key())

    # -- the native host engine ----------------------------------------------

    def compiled_host(self, n: int, density: bool, iters: int = 1):
        """The native host engine (host.py; ref circuit.py:1183):
        step(planes) -> planes running the whole circuit `iters` times
        through cache-blocked C++ kernels, on (2, 2^n) CPU planes (a
        torch tensor or a numpy array, f32 or f64), in place when they
        are contiguous and writable. Raises host.HostEngineUnsupported on
        dynamic ops, operands that need a gradient or a missing native
        library. Cached; QUEST_HOST_BLOCK is keyed, so a flip builds
        anew."""
        self._reject_measure("compiled_host")
        from quest_tpu_torch import host as H
        return self._cached(("host", n, density, iters),
                            lambda: H.compile_circuit_host(self.ops, n,
                                                           density, iters))

    def apply_host(self, q):
        """Apply the circuit to register `q` through the native host
        engine, in place on its planes; returns the register. A register
        on the card is copied to the host, run there and copied back
        into its planes: two explicit copies of the state, on this call
        only. A sharded register is refused (gather it first)."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if not torch.is_tensor(q.amps):
            raise ValueError("apply_host runs one register on the host; "
                             "gather a sharded register first")
        fn = self.compiled_host(q.num_state_qubits, q.is_density)
        if q.amps.device.type == "cpu" and q.amps.is_contiguous():
            fn(q.amps)
            return q
        host = q.amps.to("cpu").contiguous()
        fn(host)
        q.amps.copy_(host.reshape(q.amps.shape))
        return q

    def compiled_host_measured(self, n: int, density: bool = False):
        """A dynamic circuit on the native host engine (ref
        circuit.py:1216): step(planes, draws=None) -> (planes, outcomes).
        Measurements collapse in C; by default their uniforms come from
        random_ (the eager API's stream), so runs seeded alike take the
        same outcomes; `draws` gives them explicitly."""
        from quest_tpu_torch import host as H
        return self._cached(("host-measured", n, density),
                            lambda: H.compile_circuit_host_measured(
                                self.ops, n, density))

    # -- dynamic circuits ----------------------------------------------------

    def compiled_measured(self, n: int, density: bool = False,
                          engine: str = "banded", device=None):
        """The dynamic-circuit program (ref circuit.py:870): fn(amps,
        generator) -> (amps, outcomes), the planes updated in place and
        the outcomes an int32 CPU tensor in program order. engine
        'banded' plans the scheduled flat list (measurements and
        classically controlled ops are opaque barriers to the planner),
        'xla' runs the flat list op by op. Each measurement draws one
        uniform from `generator` (fn.given(amps, uniforms) takes them in
        a sequence instead), reads the outcome on the host and collapses
        in place; a classically controlled gate runs in place or not at
        all. On `device` (default: the CUDA card); cached."""
        if engine not in ("banded", "xla"):
            raise ValueError(
                f"engine must be 'banded' or 'xla', got {engine!r}")
        if not self._measure_count():
            raise val.QuESTError(
                "Invalid operation: compiled_measured requires at least "
                "one mid-circuit measurement; use compiled() instead.")
        dev = resolve_device(device)

        def build():
            tier = precision.matmul_precision()
            precision.ieee_fp32()
            flat = flatten_ops(self.ops, n, density)
            if engine == "banded":
                items = F.plan(F.maybe_schedule(flat, n), n)
            else:
                items = flat
            return MeasuredProgram(engine, n, items, tier, dev)
        return self._cached(("measured", engine, n, density, _device_key(dev)), build)

    def apply_measured(self, q, generator: torch.Generator,
                       engine: str = "banded"):
        """Apply a dynamic circuit to `q` in place on its device: (the
        register, outcomes int32 in program order). Equal generator
        states give equal outcomes."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if not self._measure_count():
            raise val.QuESTError(
                "Invalid operation: apply_measured requires at least one "
                "mid-circuit measurement; use apply() instead.")
        fn = self.compiled_measured(q.num_state_qubits, q.is_density, engine,
                                    device=q.amps.device)
        amps, outcomes = fn(q.amps, generator)
        return q.replace_amps(amps), outcomes

    # -- introspection -------------------------------------------------------

    def explain(self, density: bool = False, batch: int = None,
                budgets: BP.Budgets = BP.HOPPER_GEOMETRY) -> str:
        """What compiled_fused would run, without building it (ref
        circuit.py:1533): the scheduler's line, the sweep fusion line,
        one line per planned part (a kernel segment and its stage mix, or
        a passthrough), the totals (state passes, bytes one application
        moves, segments, distinct kernel structures), the batch line and
        an estimate from the Hopper cost model (_COST_MODELS). `budgets`
        is the planner geometry (band_plan.TPU_GEOMETRY reproduces the
        reference's plan)."""
        self._reject_measure("explain")
        n = self.num_qubits * 2 if density else self.num_qubits
        pass_bytes = 2 * 4 * (1 << n) * 2   # r+w of both f32 planes
        lines = [f"fused schedule for {len(self.ops)} ops on "
                 f"{self.num_qubits} qubits"
                 + (f" (density: {n}-qubit register)" if density else "")]
        flat = flatten_ops(self.ops, n, density)
        sched_ops, sched = F.schedule(flat, n)
        enabled = F._schedule_enabled()
        if enabled:
            lines.append(
                f"  scheduler: on (QUEST_SCHEDULE=1): "
                f"{sched['delayed']} diagonal op(s) delayed, "
                f"{sched['hoisted']} hoisted, {sched['fused_ops']} "
                f"composed into {sched['fused_groups']} group(s)")
        else:
            lines.append(
                f"  scheduler: OFF (QUEST_SCHEDULE=0); on, it would "
                f"compose {sched['fused_ops']} diagonal op(s) into "
                f"{sched['fused_groups']} group(s)")
        if not BP.usable(n):
            lines.append(f"  register below the kernel tier's minimum "
                         f"({BP.LANE_QUBITS + 3} qubits): the banded "
                         f"engine runs instead")
            lines += (_transpile_line(self) + _plan_line(self, density, batch)
                      + _host_line(flat, n))
            return "\n".join(lines)
        items = F.plan(sched_ops if enabled else flat, n,
                       bands=BP.plan_bands(n))
        parts = BP.segment_plan(items, n, budgets=budgets)
        swept = BP.sweep_plan(parts, n, budgets=budgets)
        nseg = sum(1 for p in parts if p[0] == "segment")
        nsw = sum(1 for p in swept if p[0] == "segment")
        if knob_value("QUEST_SWEEP_FUSION"):
            lines.append(
                f"  sweep fusion: on (QUEST_SWEEP_FUSION=1): {nseg} "
                f"kernel segment(s) -> {nsw} sweep(s), {len(swept)} HBM "
                f"pass(es) per application")
            parts = swept
        else:
            lines.append(
                f"  sweep fusion: OFF (QUEST_SWEEP_FUSION=0); on, it "
                f"would merge {nseg} segment(s) into {nsw} sweep(s)")
        kernels = set()
        for i, part in enumerate(parts):
            if part[0] == "segment":
                stages = part[1]
                kernels.add(tuple(stages))
                mix = {}
                for st in stages:
                    name = type(st).__name__.removesuffix("Stage").lower()
                    if hasattr(st, "kind"):
                        name = f"{name}:{st.kind}"
                    mix[name] = mix.get(name, 0) + 1
                desc = " ".join(f"{k}x{v}" if v > 1 else k
                                for k, v in mix.items())
                lines.append(f"  [{i}] kernel segment  "
                             f"{len(stages)} stages  ({desc})")
            else:
                it = part[1]
                what = (f"band q{it.ql}..q{it.ql + it.w - 1}"
                        if isinstance(it, F.BandOp) else
                        "diagonal" if isinstance(it, F.DiagItem)
                        else f"op {getattr(it.op, 'kind', '?')}")
                lines.append(f"  [{i}] passthrough  {what}")
        passes = len(parts)
        moved = passes * pass_bytes
        lines.append(
            f"  total: {passes} HBM pass{'es' if passes != 1 else ''} "
            f"({_human_bytes(moved)} moved per application at {n}q), "
            f"{sum(1 for p in parts if p[0] == 'segment')} segments, "
            f"{len(kernels)} distinct kernels")
        if batch is not None:
            lines.append(
                f"  batched: B={batch} states per launch (no bucket: the "
                f"kernel takes B at launch); {passes} launch(es) per "
                f"application independent of B — "
                f"{_human_bytes(moved * int(batch))} moved for the batch")
        kind = (torch.cuda.get_device_name(torch.cuda.current_device())
                if torch.cuda.is_initialized() else "?")
        model, matched = _cost_model_for(kind)
        lo, hi = _estimate_ms(parts, n, model)
        tag = ("" if matched or kind == "?" else
               f" [CAUTION: no cost model for {kind!r} — using H100 "
               f"constants; treat as relative, not absolute]")
        lines.append(
            f"  estimated steady state on one H100: {lo:.1f}-{hi:.1f} ms "
            f"per application at HIGHEST (constants: "
            f"{model['provenance']}){tag}")
        lines += (_transpile_line(self) + _plan_line(self, density, batch)
                  + _host_line(flat, n))
        return "\n".join(lines)

    # -- the sharded engines (ref circuit.py:1524, :1728-1987) ---------------

    def _comm_plan_stats(self, n: int, density: bool, devices: int) -> dict:
        """The plan_stats 'comm' record: the predicted schedule of the
        banded/fused sharded engines over `devices` (ref
        circuit.py:1524, parallel.sharded.comm_plan_record)."""
        from quest_tpu_torch.parallel import sharded as S
        return S.comm_plan_record(self.ops, n, density, devices)

    def _sharded(self, what: str, mesh, key, build):
        self._reject_measure(what)
        return self._cached((what,) + tuple(key) + (mesh.key,), build)

    def compiled_sharded(self, n: int, density: bool, mesh, lazy: bool = False):
        """The per-gate engine over `mesh` (parallel.sharded
        compile_circuit_sharded): one routed op per flat-list entry, the
        exchanges copies between the shards; cached on the mesh's device
        tuple (ref circuit.py:1830)."""
        from quest_tpu_torch.parallel import sharded as S
        return self._sharded(
            "compiled_sharded", mesh, ("sharded", n, density, lazy),
            lambda: S.compile_circuit_sharded(self.ops, n, density, mesh,
                                              lazy))

    def compiled_sharded_banded(self, n: int, density: bool, mesh,
                                relabel: bool = None):
        """The band-fusion engine over `mesh` (ref circuit.py:1849)."""
        from quest_tpu_torch.parallel import sharded as S
        return self._sharded(
            "compiled_sharded_banded", mesh,
            ("sharded-banded", n, density, relabel),
            lambda: S.compile_circuit_sharded_banded(
                self.ops, n, density, mesh, relabel=relabel))

    def compiled_sharded_fused(self, n: int, density: bool, mesh,
                               relabel: bool = None):
        """The segment-kernel engine over `mesh` (ref circuit.py:1864):
        every run of shard-local items one launch per swept segment per
        shard (K1 by default), the global items' exchanges between them;
        below the kernel's 10 local qubits the banded engine, said on
        stderr."""
        from quest_tpu_torch.parallel import sharded as S
        return self._sharded(
            "compiled_sharded_fused", mesh,
            ("sharded-fused", n, density, relabel),
            lambda: S.compile_circuit_sharded_fused(
                self.ops, n, density, mesh, relabel=relabel))

    def compiled_sharded_batched(self, batch: int, mesh,
                                 density: bool = False):
        """The batched fused engine over `mesh` (ref circuit.py:1881):
        shards of (B, 2, 2^local_n), the batch local to every shard, one
        launch per swept segment per shard for all B states. The program
        takes B at call time (`batch`, >= 1, is the reference's
        signature and no part of the key)."""
        from quest_tpu_torch.parallel import sharded as S
        if int(batch) < 1:
            raise ValueError(f"batch size must be >= 1, got {batch}")
        n = self.num_qubits * 2 if density else self.num_qubits
        return self._sharded(
            "compiled_sharded_batched", mesh, ("sharded-batched", n, density),
            lambda: S.compile_circuit_sharded_fused_batched(
                self.ops, n, density, mesh))

    def compiled_sharded_measured(self, n: int, density: bool, mesh,
                                  engine: str = None, relabel: bool = None):
        """The dynamic program over `mesh` (ref circuit.py:1932):
        fn(x, generator) -> (x, outcomes), fn.given(x, uniforms); engine
        'xla' (default), 'banded' or 'fused'; relabel defaults on for the
        fusing engines."""
        from quest_tpu_torch.parallel import sharded as S
        engine, relabel = S.resolve_measured_engine(engine, relabel)
        if not self._measure_count():
            raise val.QuESTError(
                "Invalid operation: compiled_sharded_measured requires at "
                "least one mid-circuit measurement; use compiled_sharded "
                "instead.")
        return self._cached(
            ("sharded-measured", n, density, engine, relabel, mesh.key),
            lambda: S.compile_circuit_sharded_measured(
                self.ops, n, density, mesh, engine=engine, relabel=relabel))

    def _sharded_amps(self, q, mesh):
        from quest_tpu_torch.parallel.mesh import ShardedAmps, shard_planes
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if isinstance(q.amps, ShardedAmps):
            return q.amps
        return shard_planes(q.amps, mesh, q.num_state_qubits)

    def apply_sharded(self, q, mesh):
        """Apply through the per-gate sharded engine: the register comes
        back with its planes a ShardedAmps over `mesh` (sharded here when
        they were not), updated in place."""
        amps = self._sharded_amps(q, mesh)
        return q.replace_amps(self.compiled_sharded(
            q.num_state_qubits, q.is_density, mesh)(amps))

    def apply_sharded_banded(self, q, mesh):
        """Apply through the banded sharded engine (see apply_sharded)."""
        amps = self._sharded_amps(q, mesh)
        return q.replace_amps(self.compiled_sharded_banded(
            q.num_state_qubits, q.is_density, mesh)(amps))

    def apply_sharded_fused(self, q, mesh):
        """Apply through the fused sharded engine (see apply_sharded)."""
        amps = self._sharded_amps(q, mesh)
        return q.replace_amps(self.compiled_sharded_fused(
            q.num_state_qubits, q.is_density, mesh)(amps))

    def apply_sharded_measured(self, q, generator: torch.Generator, mesh,
                               engine: str = None, relabel: bool = None):
        """A dynamic circuit over `mesh`: (register, outcomes int32 in
        program order); equal generator states give equal outcomes."""
        amps = self._sharded_amps(q, mesh)
        fn = self.compiled_sharded_measured(q.num_state_qubits, q.is_density,
                                            mesh, engine, relabel)
        amps, outcomes = fn(amps, generator)
        return q.replace_amps(amps), outcomes

    def explain_sharded(self, mesh, density: bool = False,
                        engine: str = "banded", batch: int = None) -> str:
        """The distributed counterpart of explain() (ref circuit.py:1728):
        the sharded program for a mesh of `mesh`'s size (an AmpMesh or a
        shard count) walked dry (parallel.introspect): shard geometry,
        the local plan, the comm planner's line and whether it matches
        the issued exchanges, reductions. Dynamic circuits report the
        measured engine's stretches."""
        from quest_tpu_torch.parallel import introspect as I
        n = self.num_qubits * 2 if density else self.num_qubits
        if self._measure_count():
            dyn_engine = {"pergate": "xla"}.get(engine, engine)
            rec = I.sharded_measured_schedule(self.ops, n, density, mesh,
                                              engine=dyn_engine)
            return "\n".join([
                f"sharded DYNAMIC ({rec['engine']}) schedule for "
                f"{len(self.ops)} ops on {self.num_qubits} qubits over "
                f"{rec['devices']} devices"
                + (f" (density: {n}-qubit register)" if density else ""),
                f"  shard geometry: {rec['local_qubits']} local + "
                f"{rec['global_qubits']} device qubits, "
                f"{_human_bytes(rec['chunk_bytes'])} chunk per device",
                f"  {rec['measurements']} measurement(s) + "
                f"{rec['classical_ops']} feedback op(s) splitting "
                f"{rec['stretches']} static stretch(es)",
                f"  local band passes: {rec['local_band_passes']}"
                + (f" ({rec['kernel_segments']} kernel segments)"
                   if rec['kernel_segments'] else ""),
                f"  relabel events: {rec['relabel_events']}",
                _comm_plan_line(rec),
                f"  collective exchanges: {rec['collective_exchanges']} "
                f"({_human_bytes(rec['ici_bytes_per_device'])} per device "
                f"per application)",
                f"  reductions: {rec['all_reduces']}"])
        rec = I.sharded_schedule(self.ops, n, density, mesh, engine=engine)
        if engine == "pergate":
            plan_lines = [f"  local ops: {rec['local_ops']}",
                          f"  device-qubit ops: {rec['global_ops']}"]
        else:
            sch = rec.get("scheduler", {})
            if sch.get("enabled"):
                sch_line = (f"  scheduler: on "
                            f"({sch.get('fused_ops', 0)} diagonal op(s) "
                            f"composed into {sch.get('fused_groups', 0)} "
                            f"group(s), {sch.get('hoisted', 0)} hoisted)")
            else:
                sch_line = (f"  scheduler: OFF (QUEST_SCHEDULE=0); on, "
                            f"it would compose {sch.get('fused_ops', 0)} "
                            f"diagonal op(s) into "
                            f"{sch.get('fused_groups', 0)} group(s)")
            plan_lines = [
                sch_line,
                f"  local band passes: {rec['local_band_passes']}",
                f"  global-qubit items: {rec['global_qubit_items']}"]
            if "kernel_sweeps" in rec:
                plan_lines.append(
                    f"  local kernel sweeps: {rec['kernel_sweeps']} per "
                    f"shard (from {rec['kernel_segments']} segment(s); "
                    f"QUEST_SWEEP_FUSION)")
            if batch is not None and "hbm_sweeps" in rec:
                plan_lines.append(
                    f"  batched: B={batch} states ride each per-shard "
                    f"sweep; the batch axis stays local to every shard "
                    f"(no batch exchanges), {rec['hbm_sweeps']} per-shard "
                    f"launch(es) and passthroughs independent of B")
        return "\n".join([
            f"sharded ({engine}) schedule for {len(self.ops)} ops on "
            f"{self.num_qubits} qubits over {rec['devices']} devices"
            + (f" (density: {n}-qubit register)" if density else ""),
            f"  shard geometry: {rec['local_qubits']} local + "
            f"{rec['global_qubits']} device qubits, "
            f"{_human_bytes(rec['chunk_bytes'])} chunk per device",
            *plan_lines,
            _comm_plan_line(rec),
            f"  collective exchanges: {rec['collective_exchanges']} "
            f"({_human_bytes(rec['ici_bytes_per_device'])} per device "
            f"per application)",
            *([f"  of which relabel all-to-alls: {rec['all_to_alls']}"]
              if rec.get("all_to_alls") else []),
            f"  reductions: {rec['all_reduces']}"])


def _transpile_line(circuit) -> List[str]:
    """explain()'s transpile line (ref circuit.py:1594): what the rewriter
    buys under QUEST_TRANSPILE; no line when it cannot run, never fatal."""
    try:
        knob = knob_value("QUEST_TRANSPILE")
        if knob == "0":
            return ["  transpile: off (QUEST_TRANSPILE=0)"]
        from quest_tpu_torch import transpile as T
        _, rep = T.transpile_cached(circuit)
        if not rep["changed"]:
            return [f"  transpile: no rewrite ({rep['ops_in']} op(s) "
                    f"already minimal under the pass catalog; "
                    f"QUEST_TRANSPILE={knob})"]
        attr = ", ".join(f"{k}={v}" for k, v in rep["passes"].items() if v)
        return [f"  transpile: {rep['ops_in']} -> {rep['ops_out']} op(s) "
                f"[{attr}] (QUEST_TRANSPILE={knob}; docs/TRANSPILE.md)"]
    except Exception:
        return []


def _host_line(flat, n: int) -> List[str]:
    """explain()'s host line (ref circuit.py:1566-1577): what the native
    host engine would do with the raw flat ops. Omitted, never fatal,
    when the library is unavailable or an op has no host kernel."""
    from quest_tpu_torch import host as H
    from quest_tpu_torch import native
    if not native.available():
        return []
    try:
        return ["  cpu fallback " + H.plan_summary(flat, n)]
    except H.HostEngineUnsupported:
        return []


def _plan_line(circuit, density: bool, batch) -> List[str]:
    """explain()'s plan line (ref circuit.py:1579): the autotuner's verdict,
    searched fresh (persist=False: explain never touches the plan
    cache); no line when it cannot price, never fatal."""
    try:
        from quest_tpu_torch import plan as P
        return ["  " + P.autotune(
            circuit, state_kind="density" if density else "pure",
            batch=batch, persist=False).line()]
    except Exception:
        return []


def _comm_plan_line(rec: dict) -> str:
    """The comm planner's line of explain_sharded (ref circuit.py:607):
    the predicted schedule and whether the mesh's recorder issued exactly
    it on the program's dry walk."""
    verdict = ("matches" if rec.get("comm_matches_hlo")
               else "MISMATCH vs")
    line = (f"  comm plan: {rec.get('comm_strategy', '?')} "
            f"(QUEST_COMM_PLAN={1 if rec.get('comm_plan_enabled') else 0})"
            f": {rec.get('comm_exchanges', 0)} exchange(s) = "
            f"{rec.get('comm_collective_permutes', 0)} pair permute(s) + "
            f"{rec.get('comm_all_to_alls', 0)} all-to-all(s), "
            f"{_human_bytes(rec.get('comm_bytes', 0))} per device planned "
            f"[{verdict} the issued exchanges]")
    topo = rec.get("comm_topology") or {}
    if topo.get("hosts", 1) > 1:
        line += (f"\n  topology: {topo['hosts']} host(s), "
                 f"{rec.get('comm_dci_exchanges', 0)} DCI-crossing "
                 f"exchange(s), "
                 f"{_human_bytes(rec.get('comm_dci_bytes', 0))} DCI + "
                 f"{_human_bytes(rec.get('comm_ici_bytes', 0))} ICI "
                 f"per device (weights ici={topo['ici_weight']}, "
                 f"dci={topo['dci_weight']})")
    return line


def _human_bytes(b: int) -> str:
    if b >= 2**29:
        return f"{b / 2**30:.2f} GiB"
    if b >= 2**19:
        return f"{b / 2**20:.2f} MiB"
    return f"{b / 2**10:.2f} KiB"


# The Hopper cost model of explain(), in the keys of the reference's
# _COST_MODELS (circuit.py:418-478), ms at 2^30 amplitudes (an 8 GiB f32
# state): the 28-qubit K1 launch times of PERF.md section 6 (chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700 W, PR 10) times 4. base_pass is the
# stage-free launch; every other entry is a stage's launch minus it.
_H100_28Q_MS = {"stage_free": 1.463, "b0": 6.557, "b1": 7.091,
                "scb": 7.078, "sc": 1.591, "pair": 1.549, "parity": 1.556}
_SCALE_30Q = 4.0
# the XLA engines on the 28-qubit depth-4 flagship (PERF.md section 6,
# PR 9, chip_smoke.py phases pergate and banded): the step's time over
# its ops (166, per-gate) or over its full-state passes (18: 12 band
# passes and 6 diagonal runs, fusion.plan_stats), scaled to 2^30 as above
_H100_28Q_PERGATE = (1276.7, 166)       # (ms per step, ops)
_H100_28Q_BANDED = (164.7, 18)          # (ms per step, full-state passes)
_COST_MODELS = {
    "h100": {
        "provenance": "MEASURED on NVIDIA H100 80GB HBM3, 700 W, PR 10 "
                      "(chip_smoke.py stage_timing: 28q K1 launches x 4; "
                      "PERF.md section 6)",
        "base_pass": _H100_28Q_MS["stage_free"] * _SCALE_30Q,
        "sc": (_H100_28Q_MS["sc"] - _H100_28Q_MS["stage_free"]) * _SCALE_30Q,
        # b0 and scb-128 compute adders, averaged: every matrix stage of
        # d >= 16 takes the same FMA chain
        "scb": ((_H100_28Q_MS["b0"] + _H100_28Q_MS["scb"]) / 2
                - _H100_28Q_MS["stage_free"]) * _SCALE_30Q,
        "b1_extra": (_H100_28Q_MS["b1"] - _H100_28Q_MS["b0"]) * _SCALE_30Q,
        "pair": (_H100_28Q_MS["pair"] - _H100_28Q_MS["stage_free"])
        * _SCALE_30Q,
        "phase": (_H100_28Q_MS["parity"] - _H100_28Q_MS["stage_free"])
        * _SCALE_30Q,
        # the per-gate engine's price per op and the banded engine's per
        # full-state pass (plan.autotune; a passthrough of the fused plan
        # runs through the same primitives)
        "pergate_op": _H100_28Q_PERGATE[0] / _H100_28Q_PERGATE[1]
        * _SCALE_30Q,
        "pergate_provenance": "MEASURED on NVIDIA H100 80GB HBM3, 700 W, "
                              "PR 9 (chip_smoke.py pergate: 28q d4 "
                              "flagship 1276.7 ms / 166 ops x 4; PERF.md "
                              "section 6)",
        "banded_pass": _H100_28Q_BANDED[0] / _H100_28Q_BANDED[1]
        * _SCALE_30Q,
        "banded_provenance": "MEASURED on NVIDIA H100 80GB HBM3, 700 W, "
                             "PR 9 (chip_smoke.py banded: 28q d4 flagship "
                             "164.7 ms / 18 full-state passes x 4; "
                             "PERF.md section 6)",
    },
}


def _cost_model_for(device_name: str):
    """(model, matched) for a torch.cuda device name: the H100 model,
    matched only on an H100 (an unknown card gets it with matched False,
    so explain() cautions)."""
    return _COST_MODELS["h100"], "H100" in device_name


def _estimate_ms(parts, n: int, model=None):
    """(lo, hi) ms per application (ref circuit.py:480): per segment
    max(base, compute) and base + compute, a passthrough at the card's
    price of its primitive (a band the banded engine's pass, anything
    else the per-gate engine's op), scaled from 2^30 amplitudes to
    2^n."""
    model = model or _COST_MODELS["h100"]
    scale = (1 << n) / (1 << 30)
    base = model["base_pass"]

    def compute_ms(st):
        if isinstance(st, BP.MatStage):
            if st.kind == "sc":
                return model["sc"]
            return (model["scb"] * (2 / 3 if st.real_only else 1.0)
                    + (model["b1_extra"] if st.kind == "b1" else 0.0))
        if isinstance(st, BP.PairStage):
            return model["pair"]
        if isinstance(st, BP.MultiPhaseStage):
            return model["phase"] * (0.7 + 0.3 * len(st.forms))
        return model["phase"]

    lo = hi = 0.0
    for part in parts:
        if part[0] == "segment":
            comp = sum(compute_ms(st) for st in part[1])
            lo += max(base, comp)
            hi += base + comp
        else:
            ms = (model["banded_pass"] if isinstance(part[1], F.BandOp)
                  else model["pergate_op"])
            lo += ms
            hi += ms
    return lo * scale, hi * scale


class MeasuredProgram:
    """A compiled dynamic circuit (ref circuit.py:870): `items` are the
    banded engine's plan items or the per-gate engine's flat ops, run in
    place at matmul `tier` on `device`. A measurement ('measure', or
    'measure_dm' on a density register) draws its uniform, reads its
    outcome on the host and collapses the planes
    (measurement._measure_given_uniform); a 'classical' op checks its
    conditions against the outcomes so far and applies its gates in
    place, or skips them."""

    def __init__(self, engine: str, n: int, items: List, tier: str,
                 device: torch.device):
        self.engine = engine
        self.n = n
        self.items = items
        self.tier = tier
        self.device = device

    def __call__(self, amps: torch.Tensor, generator: torch.Generator):
        return self._run(amps, lambda: MS.draw_uniform(generator, amps.dtype))

    def given(self, amps: torch.Tensor, uniforms):
        """The same run with the measurements' uniforms given in order
        (a sequence of floats in [0, 1))."""
        it = iter(uniforms)
        return self._run(amps, lambda: float(next(it)))

    def _run(self, amps: torch.Tensor, draw):
        _check_device(amps, self.device)
        outs: List[int] = []
        for it in self.items:
            op = it.op if isinstance(it, F.PassOp) else it
            kind = getattr(op, "kind", None)
            if kind in ("measure", "measure_dm"):
                outcome, _ = MS._measure_given_uniform(
                    amps, draw(), n=self.n, qubit=op.targets[0],
                    density=kind == "measure_dm")
                outs.append(outcome)
            elif kind == "classical":
                inners, conds = op.operand
                if all(outs[idx] == want for idx, want in conds):
                    for g in inners:
                        _apply_one(amps, self.n, g, self.tier)
            else:
                _apply_item(amps, self.n, it, self.tier)
        return amps, torch.tensor(outs, dtype=torch.int32)


# ---------------------------------------------------------------------------
# benchmark circuit generators
# ---------------------------------------------------------------------------


def random_circuit(num_qubits: int, depth: int, seed: int = 0,
                   entangler: str = "cz") -> Circuit:
    """RCS-style benchmark circuit: layers of random single-qubit rotations
    followed by a brick pattern of entangling gates (BASELINE.json config
    '30-qubit random-circuit-sampling statevector'). Same draws as the
    reference's random_circuit for the same seed."""
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    for d in range(depth):
        for q in range(num_qubits):
            angle = float(rng.uniform(0, 2 * np.pi))
            kind = rng.integers(0, 3)
            if kind == 0:
                c.rx(q, angle)
            elif kind == 1:
                c.ry(q, angle)
            else:
                c.rz(q, angle)
        start = d % 2
        for q in range(start, num_qubits - 1, 2):
            if entangler == "cz":
                c.cz(q, q + 1)
            else:
                c.cnot(q, q + 1)
    return c


def qft_circuit(num_qubits: int) -> Circuit:
    """Quantum Fourier transform (BASELINE.json config 'distributed QFT')."""
    c = Circuit(num_qubits)
    for q in reversed(range(num_qubits)):
        c.h(q)
        for j in range(q):
            angle = np.pi / (1 << (q - j))
            c._add("allones", (j, q), np.exp(1j * angle))
    for q in range(num_qubits // 2):
        c.swap(q, num_qubits - 1 - q)
    return c
