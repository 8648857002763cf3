"""Circuit builder and the fused engine.

A port of the part of quest_tpu/circuit.py that the RCS statevector and
density-matrix decoherence paths run: the GateOp record, the Circuit
builder for the gates of random_circuit, qft_circuit and the noisy
density circuits (Kraus channels as superoperators), dual_of and
flatten_ops (density duals and superoperator expansion), the scheduled
flat op list (_planned_flat), compiled_fused and apply_fused, and the
batched engine (compiled_batched, apply_batched). The plan is the
reference's chain — fusion.schedule, fusion.plan, segment_plan,
sweep_plan — under HOPPER_GEOMETRY; every swept segment then runs as one
launch of the segment kernel (ops/segment.py), for one state or for a
whole batch of states, and a multi-target matrix the kernel cannot
reach (the reference's XLA matrix passthrough) runs through
ops/apply.apply_matrix_rows between segments. A program runs at the
matmul tier (quest_tpu_torch/precision.py) and under the segment driver
(QUEST_FUSED_DRIVER / QUEST_FUSED_PIPELINE / QUEST_FUSED_NBUF,
band_plan.active_driver) it was compiled with.

What the reference runs elsewhere is not ported yet and raises
NotImplementedError naming its ROADMAP item: f64 registers, the banded
engine and the XLA band/diagonal passthroughs, registers below the fused
engine's 10 qubits (all A3), mid-circuit measurement, classical control
and QUEST_FUSED_SCAN (A4).
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


class MatrixPass:
    """A matrix passthrough between kernel segments: a multi-target
    matrix (a cross-band channel superoperator, a 3- or 4-qubit gate)
    that no kernel stage reaches, applied in place by
    ops/apply.apply_matrix_rows, as the reference applies it outside
    Pallas (circuit.py:555-564)."""

    def __init__(self, op, n: int, tier: str):
        self.op = op
        self.n = n
        self.tier = tier

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        """Apply to one state's planes, or to a batch of states, at the
        matmul tier of the program it belongs to."""
        op = self.op
        return A.apply_matrix_rows(amps, self.n, op.operand, op.targets,
                                   op.controls, op.cstates, self.tier)


def _xla_part_applier(part, n: int, tier: str) -> MatrixPass:
    """The port's applier for a non-segment plan part: matrix ops of at
    most A.MAX_TARGETS targets (ref circuit.py:541-568). Band and
    diagonal passthroughs and wider matrices are ROADMAP A3."""
    it = part[1]
    if (isinstance(it, F.PassOp) and it.op.kind == "matrix"
            and len(it.op.targets) <= A.MAX_TARGETS):
        return MatrixPass(it.op, n, tier)
    raise NotImplementedError(
        f"this circuit needs an XLA band passthrough "
        f"({type(it).__name__}) between kernel segments, which is not "
        f"ported yet (ROADMAP A3)")


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
    Circuit.plan_stats()['fused'])."""

    def __init__(self, n: int, steps: List, loop_iters: int, tier: str,
                 driver: str, nbuf: int, fused_record: dict):
        self.n = n
        self.steps = steps
        self.segments = [s for s in steps if isinstance(s, Segment)]
        self.loop_iters = loop_iters
        self.tier = tier
        self.driver = driver
        self.nbuf = nbuf
        self.fused_record = fused_record

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        if amps.dtype == torch.float64:
            raise NotImplementedError(
                "f64 registers are not ported yet (ROADMAP A3: the reference "
                "runs them on its banded engine)")
        for _ in range(self.loop_iters):
            for step in self.steps:
                if isinstance(step, Segment):
                    segment_sweep(amps, step)
                else:
                    step(amps)
        return amps

    def plain(self, amps: torch.Tensor) -> torch.Tensor:
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
        scheduler (fusion.maybe_schedule, QUEST_SCHEDULE knob)."""
        return F.maybe_schedule(flatten_ops(self.ops, n, density), n)

    def segment_parts(self, n: int, density: bool = False):
        """The raw segment plan of one application (before sweep fusion),
        under HOPPER_GEOMETRY."""
        flat = self._planned_flat(n, density)
        items = F.plan(flat, n, bands=BP.plan_bands(n))
        return BP.segment_plan(items, n)

    def fused_parts(self, n: int, iters: int = 1, density: bool = False,
                    driver: str = None):
        """(swept part list of one program call, loop count): the
        reference's compiled_fused planning, under HOPPER_GEOMETRY and the
        operand budget of `driver` (None: the knobs'). `n` counts state
        qubits (2N for a density register)."""
        return _sweep_unrolled(self.segment_parts(n, density), n, iters,
                               driver)

    def compiled_fused(self, n: int, density: bool = False, iters: int = 1,
                       device=None) -> FusedProgram:
        """The fused engine on `n` state qubits (2N for a density
        register over N): each swept segment of band operators, Kraus
        pairs, diagonals and parity phases runs as ONE launch of the
        segment kernel, in place on the state; a matrix passthrough runs
        through apply_matrix_rows between segments. Operands and
        descriptor tables go to `device` (default: the CUDA card) here,
        once; calls reuse them. The matmul tier (QUEST_MATMUL_PRECISION
        or precision.set_matmul_precision) and the segment driver
        (QUEST_FUSED_DRIVER, QUEST_FUSED_PIPELINE, QUEST_FUSED_NBUF) are
        read here, once, as the reference reads them at trace time: the
        program keeps them."""
        if knob_value("QUEST_FUSED_SCAN"):
            raise NotImplementedError(
                "QUEST_FUSED_SCAN is not ported yet (ROADMAP A4)")
        if not BP.usable(n):
            raise NotImplementedError(
                f"n={n} is below the fused engine's {BP.LANE_QUBITS + 3} "
                f"qubits; the reference falls back to compiled_banded, "
                f"which is not ported yet (ROADMAP A3)")
        dev = resolve_device(device)
        tier = precision.matmul_precision()
        driver, nbuf = BP.active_driver(), knob_value("QUEST_FUSED_NBUF")
        precision.ieee_fp32()
        raw = self.segment_parts(n, density)
        parts, loop_iters = _sweep_unrolled(raw, n, iters, driver)
        steps = [prepare_segment(p[1], p[2], n, dev, tier=tier,
                                 driver=driver, nbuf=nbuf)
                 if p[0] == "segment" else _xla_part_applier(p, n, tier)
                 for p in parts]
        record = BP.fused_record(raw, BP.maybe_sweep(raw, n, driver=driver),
                                 n, driver=driver, nbuf=nbuf)
        return FusedProgram(n, steps, loop_iters, tier, driver, nbuf, record)

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
                         device=None, engine: str = None) -> FusedProgram:
        """The batched fused engine (ref circuit.py:1352): the circuit's
        FusedProgram, which takes a batch (B, 2, ...) of states and runs
        every swept segment as ONE kernel launch over all of them, so the
        launch count does not depend on the batch. The kernel takes B at
        launch and nothing planned depends on it, so the program runs any
        batch at its exact size; `batch` (>= 1) is the reference's
        signature. engine: None or 'fused'; the reference's vmapped
        banded program ('banded', and its f64 and sub-10-qubit uses) is
        ROADMAP A3."""
        if engine not in (None, "fused", "banded"):
            raise ValueError(
                f"engine must be None, 'fused' or 'banded', got {engine!r}")
        if engine == "banded":
            raise NotImplementedError(
                "the vmapped banded batched program is not ported yet "
                "(ROADMAP A3)")
        if int(batch) < 1:
            raise ValueError(f"batch size must be >= 1, got {batch}")
        n = self.num_qubits * 2 if density else self.num_qubits
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
