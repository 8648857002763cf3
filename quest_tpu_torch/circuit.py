"""Circuit builder and the three engines: per-gate, banded and fused.

A port of quest_tpu/circuit.py for the gates of random_circuit,
qft_circuit and the noisy density circuits (Kraus channels as
superoperators): the GateOp record, the Circuit builder, dual_of and
flatten_ops (density duals and superoperator expansion), the scheduled
flat op list (_planned_flat), and the reference's engines:

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
    banded items of its plan (the kernel is f32), as the reference does.

Every program runs on the device it was compiled for, in place on the
planes, at the matmul tier (quest_tpu_torch/precision.py) and, for the
fused engine, under the segment driver (QUEST_FUSED_DRIVER /
QUEST_FUSED_PIPELINE / QUEST_FUSED_NBUF, band_plan.active_driver) read
when it was compiled. Mid-circuit measurement, classical control and
QUEST_FUSED_SCAN are not ported yet and raise NotImplementedError naming
ROADMAP A4.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.ops.segment import (Segment, batch_of, prepare_segment,
                                         segment_sweep,
                                         segment_sweep_reference)

_LOOP_UNROLL_MAX = 32
# op count above which Circuit.apply takes the banded engine (ref
# circuit.py:49, where the per-gate XLA chain compiles pathologically
# slowly; here it is the per-gate engine's pass count that grows)
PERGATE_COMPILE_WARN_OPS = 64
PLAIN_CHUNK_STATES = 8        # states per plain-path pass of a batch


@dataclasses.dataclass(frozen=True)
class GateOp:
    kind: str                 # 'matrix' | 'diagonal' | 'parity' | 'allones' | 'superop'
    targets: Tuple[int, ...]
    controls: Tuple[int, ...] = ()
    cstates: Tuple[int, ...] = ()
    operand: object = None    # matrix / diag vector / angle / phase term
    meta: object = None       # Circuit.kraus stores ("kraus", <raw Kraus
    # operators>) beside the superoperator; the engines never execute it


_KINDS = ("matrix", "diagonal", "parity", "allones", "superop")


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


def flatten_ops(ops, n: int, density: bool) -> List[GateOp]:
    """The flat op list the engines plan from (ref circuit.py:258-312):
    on a density register (n = 2N state qubits) every gate is followed
    by its dual, and each superoperator becomes a matrix op on
    [targets, targets + N]."""
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
        if op.kind not in _KINDS:
            raise NotImplementedError(
                f"{op.kind!r} ops (mid-circuit measurement, classical "
                f"control) are not ported yet (ROADMAP A4)")
        if op.kind == "superop":
            flat.append(dataclasses.replace(
                op, kind="matrix",
                targets=M.superop_targets(op.targets, n // 2)))
            continue
        flat.append(op)
        if density:
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
        return _apply_item(amps, self.n, self.item, self.tier)


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
    QUEST_FUSED_NBUF then); every call runs under them. `fused_record`
    is band_plan.fused_record of one application's plan (the reference's
    Circuit.plan_stats()['fused']). f64 planes (the kernel is f32) run
    `items`, the fusion plan the segments were cut from, through the
    banded primitives `iters` times instead, in place, as the
    reference's program routes them at call time (circuit.py:1321)."""

    def __init__(self, n: int, steps: List, loop_iters: int, tier: str,
                 driver: str, nbuf: int, fused_record: dict, items: List,
                 iters: int, device: torch.device):
        self.n = n
        self.steps = steps
        self.segments = [s for s in steps if isinstance(s, Segment)]
        self.loop_iters = loop_iters
        self.tier = tier
        self.driver = driver
        self.nbuf = nbuf
        self.fused_record = fused_record
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
        self._compiled = {}     # trajectory programs (trajectories.py)

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
        tier = precision.check_tier(tier or precision.matmul_precision())
        precision.ieee_fp32()
        return _apply_banded_items(amps, n, flatten_ops(self.ops, n, density),
                                   tier)

    def compiled(self, n: int, density: bool = False, iters: int = 1,
                 device=None) -> XlaProgram:
        """The per-gate engine on `n` state qubits (ref circuit.py:1101):
        every op of the unscheduled flat list (density duals included)
        through ops/apply, `iters` times, on `device` (default: the CUDA
        card) at the session's matmul tier, both read here and kept."""
        dev = resolve_device(device)
        tier = precision.matmul_precision()
        precision.ieee_fp32()
        return XlaProgram("pergate", n, flatten_ops(self.ops, n, density),
                          iters, tier, dev)

    def apply(self, q):
        """Apply the circuit to register `q` in place on its device;
        returns the register (ref circuit.py:1122). A circuit of more than
        PERGATE_COMPILE_WARN_OPS ops without channels runs through the
        banded engine (QUEST_APPLY_AUTOROUTE, default 1), else through
        the per-gate engine."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
        if (len(self.ops) > PERGATE_COMPILE_WARN_OPS
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
        matmul tier, read here and kept."""
        dev = resolve_device(device)
        tier = precision.matmul_precision()
        precision.ieee_fp32()
        return XlaProgram("banded", n, self.banded_items(n, density), iters,
                          tier, dev)

    def banded_trace(self, amps: torch.Tensor, n: int, density: bool,
                     tier: str = None) -> torch.Tensor:
        """Apply the banded plan to raw planes in place (ref :1238)."""
        tier = precision.check_tier(tier or precision.matmul_precision())
        precision.ieee_fp32()
        return _apply_banded_items(amps, n, self.banded_items(n, density),
                                   tier)

    def apply_banded(self, q):
        """Apply through the banded engine on the register's device, in
        place; returns the register (ref :1246)."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
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
        tables go to `device` (default: the CUDA card) here, once; calls
        reuse them. The matmul tier (QUEST_MATMUL_PRECISION or
        precision.set_matmul_precision) and the segment driver
        (QUEST_FUSED_DRIVER, QUEST_FUSED_PIPELINE, QUEST_FUSED_NBUF) are
        read here, once, as the reference reads them at trace time: the
        program keeps them. Below the kernel's 10 qubits this is
        compiled_banded (ref circuit.py:1274); f64 planes run the plan's
        banded items (FusedProgram)."""
        if knob_value("QUEST_FUSED_SCAN"):
            raise NotImplementedError(
                "QUEST_FUSED_SCAN is not ported yet (ROADMAP A4)")
        if not BP.usable(n):
            return self.compiled_banded(n, density, iters, device)
        dev = resolve_device(device)
        tier = precision.matmul_precision()
        driver, nbuf = BP.active_driver(), knob_value("QUEST_FUSED_NBUF")
        precision.ieee_fp32()
        items, raw = self.fused_plan(n, density)
        parts, loop_iters = _sweep_unrolled(raw, n, iters, driver)
        steps = [prepare_segment(p[1], p[2], n, dev, tier=tier,
                                 driver=driver, nbuf=nbuf)
                 if p[0] == "segment" else XlaPass(p[1], n, tier)
                 for p in parts]
        record = BP.fused_record(raw, BP.maybe_sweep(raw, n, driver=driver),
                                 n, driver=driver, nbuf=nbuf)
        return FusedProgram(n, steps, loop_iters, tier, driver, nbuf, record,
                            items, iters, dev)

    def apply_fused(self, q, iters: int = 1):
        """Apply the circuit to register `q` (statevector or density)
        through the fused engine on the register's device, in place on
        its planes; returns the register (ref circuit.py:1343)."""
        if self.num_qubits != q.num_qubits:
            raise ValueError("circuit/register size mismatch")
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
        the reference's signature). f64 batches run its banded items.
        engine 'banded', and engine None below the kernel's 10 qubits:
        the banded program over the whole batch. engine 'fused' below the
        kernel tier raises ValueError, as in the reference."""
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
        if engine == "banded":
            return self.compiled_banded(n, density, device=device)
        return self.compiled_fused(n, density, device=device)

    def apply_batched(self, amps_b: torch.Tensor,
                      density: bool = False) -> torch.Tensor:
        """Apply this circuit to a (B, 2, 2^n) batch of planes through
        the batched engine on their device, in place; returns them (ref
        circuit.py:1469)."""
        fn = self.compiled_batched(int(amps_b.shape[0]), density,
                                   device=amps_b.device)
        return fn(amps_b)


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
