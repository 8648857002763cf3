"""Circuit builder and the fused engine.

A port of the part of quest_tpu/circuit.py that the RCS statevector
path runs: the GateOp record, the Circuit builder for the gates that
random_circuit and qft_circuit use (plus `gate` and controlled `x`),
flatten_ops, the
scheduled flat op list (_planned_flat), and compiled_fused. The plan is
the reference's chain — fusion.schedule, fusion.plan, segment_plan,
sweep_plan — under HOPPER_GEOMETRY; every swept segment then runs as one
launch of the segment kernel (ops/segment.py).

What the reference runs elsewhere is not ported yet and raises
NotImplementedError naming its ROADMAP item: density registers (A5),
f64 registers and the XLA band passthroughs between segments, registers
below the fused engine's 10 qubits (all A3), QUEST_FUSED_SCAN (A4),
and the stage kinds PairStage / DiagVecStage / BatchSelStage (B8-B10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.ops.segment import (Segment, prepare_segment,
                                         segment_sweep,
                                         segment_sweep_reference)

_LOOP_UNROLL_MAX = 32


@dataclasses.dataclass(frozen=True)
class GateOp:
    kind: str                 # 'matrix' | 'diagonal' | 'parity' | 'allones'
    targets: Tuple[int, ...]
    controls: Tuple[int, ...] = ()
    cstates: Tuple[int, ...] = ()
    operand: object = None    # matrix / diag vector / angle / phase term


_KINDS = ("matrix", "diagonal", "parity", "allones")


def flatten_ops(ops, n: int, density: bool) -> List[GateOp]:
    """The flat op list the engines plan from. Statevector registers
    only: density duals and superoperators are ROADMAP A5."""
    if density:
        raise NotImplementedError(
            "density registers are not ported yet (ROADMAP A5)")
    for op in ops:
        if op.kind == "superop":
            raise val.QuESTError(
                "Invalid operation: noise channels require a density-matrix "
                "register")
        if op.kind not in _KINDS:
            raise NotImplementedError(
                f"{op.kind!r} ops (mid-circuit measurement, classical "
                f"control) are not ported yet (ROADMAP A4)")
    return list(ops)


class FusedProgram:
    """A compiled fused program: call it on (2, 2^n) or (2, rows, 128)
    f32 planes; it updates them in place (one kernel launch per swept
    segment on the card) and returns them. `segments` holds the packed
    segments of one application; `plain(amps)` runs the same plan through
    the plain PyTorch version, out of place, for comparison."""

    def __init__(self, n: int, segments: List[Segment], loop_iters: int):
        self.n = n
        self.segments = segments
        self.loop_iters = loop_iters

    def __call__(self, amps: torch.Tensor) -> torch.Tensor:
        for _ in range(self.loop_iters):
            for seg in self.segments:
                segment_sweep(amps, seg)
        return amps

    def plain(self, amps: torch.Tensor) -> torch.Tensor:
        out = amps
        for _ in range(self.loop_iters):
            for seg in self.segments:
                out = segment_sweep_reference(out, seg.stages, seg.operands,
                                              self.n)
        return out.reshape(amps.shape)

    @property
    def launches_per_call(self) -> int:
        return self.loop_iters * len(self.segments)


class Circuit:
    """Builder for a fixed gate sequence over `num_qubits` qubits."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.ops: List[GateOp] = []

    # -- builders (chainable) ------------------------------------------------

    def _add(self, kind, targets, operand, controls=(), cstates=None):
        targets = tuple(int(t) for t in targets)
        controls = tuple(int(c) for c in controls)
        cstates = (tuple(int(s) for s in cstates) if cstates is not None
                   else (1,) * len(controls))
        val.validate_gate_qubits(self.num_qubits, targets, controls, cstates)
        self.ops.append(GateOp(kind, targets, controls, cstates, operand))
        return self

    def gate(self, matrix, targets, controls=(), cstates=None):
        return self._add("matrix", targets,
                         np.asarray(matrix, dtype=np.complex128),
                         controls, cstates)

    def h(self, t):
        return self._add("matrix", (t,), M.HADAMARD)

    def x(self, t, *controls):
        return self._add("matrix", (t,), M.PAULI_X, controls)

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

    # -- planning ------------------------------------------------------------

    def _planned_flat(self, n: int, density: bool) -> List[GateOp]:
        """Flattened, then reordered/composed by the commutation-aware
        scheduler (fusion.maybe_schedule, QUEST_SCHEDULE knob)."""
        return F.maybe_schedule(flatten_ops(self.ops, n, density), n)

    def fused_parts(self, n: int, iters: int = 1):
        """(swept part list of one program call, loop count): the
        reference's compiled_fused planning, under HOPPER_GEOMETRY."""
        flat = self._planned_flat(n, False)
        items = F.plan(flat, n, bands=BP.plan_bands(n))
        parts = BP.segment_plan(items, n)
        unroll = iters if 1 < iters <= _LOOP_UNROLL_MAX else 1
        if knob_value("QUEST_SWEEP_FUSION"):
            parts = BP.sweep_plan(parts * unroll, n)
        else:
            unroll = 1
        return parts, iters // unroll

    def compiled_fused(self, n: int, density: bool = False, iters: int = 1,
                       device=None) -> FusedProgram:
        """The fused engine: each swept segment of band operators,
        diagonals and parity phases runs as ONE launch of the segment
        kernel, in place on the state. Operands and descriptor tables go
        to `device` (default: the CUDA card) here, once; calls reuse
        them."""
        if density:
            raise NotImplementedError(
                "density registers are not ported yet (ROADMAP A5)")
        if knob_value("QUEST_FUSED_SCAN"):
            raise NotImplementedError(
                "QUEST_FUSED_SCAN is not ported yet (ROADMAP A4)")
        if not BP.usable(n):
            raise NotImplementedError(
                f"n={n} is below the fused engine's {BP.LANE_QUBITS + 3} "
                f"qubits; the reference falls back to compiled_banded, "
                f"which is not ported yet (ROADMAP A3)")
        dev = resolve_device(device)
        precision.ieee_fp32()
        parts, loop_iters = self.fused_parts(n, iters)
        for part in parts:
            if part[0] != "segment":
                raise NotImplementedError(
                    f"this circuit needs an XLA band passthrough "
                    f"({type(part[1]).__name__}) between kernel segments, "
                    f"which is not ported yet (ROADMAP A3)")
        segments = [prepare_segment(p[1], p[2], n, dev) for p in parts]
        return FusedProgram(n, segments, loop_iters)


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
