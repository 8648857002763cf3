"""Carry circuits, state and segment operands across from the JAX
package.

The reference package's objects arrive as plain Python/numpy: a
quest_tpu GateOp is read by attribute (nothing of quest_tpu is
imported), state planes and operands as numpy arrays. Density circuits
cross the same way (superoperator ops with their `meta` Kraus
branches), and so do dynamic circuits: a 'measure' op as it is, a
'classical' op with its inner gates rebuilt as port GateOps. State
planes become a statevector Qureg, and density planes — (2, 4^N) in the
reference's column-major flat order — a density Qureg.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch

from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.state import Qureg


def _operand(x):
    """A GateOp operand as the port stores it: Python scalars stay,
    arrays become numpy."""
    if x is None or isinstance(x, (int, float, complex)):
        return x
    return np.asarray(x)


def _meta(meta):
    """A GateOp's meta as the port stores it: ("kraus", operators) with
    each operator a numpy array; anything else as it is."""
    if isinstance(meta, tuple) and len(meta) == 2 and meta[0] == "kraus":
        return ("kraus", tuple(np.asarray(k) for k in meta[1]))
    return meta


def _gate_op(op) -> GateOp:
    """A port GateOp of the same fields as `op`; a classical op's operand
    ((inner GateOps, ...), conditions) with its inner ops rebuilt."""
    operand = op.operand
    if op.kind == "classical":
        inners, conds = operand
        operand = (tuple(_gate_op(g) for g in inners),
                   tuple((int(i), int(w)) for i, w in conds))
    else:
        operand = _operand(operand)
    return GateOp(kind=op.kind, targets=tuple(int(t) for t in op.targets),
                  controls=tuple(int(q) for q in op.controls),
                  cstates=tuple(int(s) for s in op.cstates),
                  operand=operand, meta=_meta(getattr(op, "meta", None)))


def circuit_from_ops(ops: Iterable, num_qubits: int = None) -> Circuit:
    """A port Circuit holding the same gate stream as `ops` — quest_tpu
    GateOps (or anything with kind/targets/controls/cstates/operand and
    optionally meta attributes) with numpy operands. `num_qubits`
    defaults to one more than the highest qubit named."""
    ops = list(ops)
    if num_qubits is None:
        num_qubits = 1 + max((q for op in ops
                              for q in (*op.targets, *op.controls)),
                             default=0)
    c = Circuit(num_qubits)
    c.ops.extend(_gate_op(op) for op in ops)
    return c


def planes_from_numpy(planes, device=None) -> torch.Tensor:
    """State planes ((2, 2^n) or (2, rows, 128), any float dtype) as a
    new contiguous f32 tensor on `device` (default: the CUDA card), same
    shape."""
    # a copy: the engine updates the result in place, and the source may
    # be a read-only view (a JAX array's host buffer)
    arr = np.array(planes, dtype=np.float32, order="C")
    return torch.from_numpy(arr).to(resolve_device(device))


def qureg_from_numpy(planes, device=None, dtype=np.float32) -> Qureg:
    """A statevector Qureg from (2, 2^n) planes (or any view of them) on
    `device`, f32 planes (`dtype` np.float64: f64)."""
    arr = np.array(planes, dtype=dtype, order="C").reshape(2, -1)
    amps = torch.from_numpy(arr).to(resolve_device(device))
    n = amps.shape[1].bit_length() - 1
    if amps.shape[1] != 1 << n:
        raise ValueError(f"statevector planes need 2^n amplitudes, got "
                         f"{amps.shape[1]}")
    return Qureg(amps=amps, num_qubits=n)


def density_qureg_from_numpy(planes, device=None) -> Qureg:
    """A density Qureg over N qubits from (2, 4^N) planes (or any view of
    them, e.g. the fused (2, rows, 128)), the reference's column-major
    flat order (rho[r, c] at r + c * 2^N), as f32 on `device`."""
    amps = planes_from_numpy(planes, device).reshape(2, -1)
    n = amps.shape[1].bit_length() - 1
    if amps.shape[1] != 1 << n or n % 2:
        raise ValueError(f"density planes need 4^N amplitudes, got "
                         f"{amps.shape[1]}")
    return Qureg(amps=amps, num_qubits=n // 2, is_density=True)


def operands_from_numpy(arrays: Sequence, device=None) -> List[torch.Tensor]:
    """Segment operand arrays (segment_plan's numpy f32 arrays, as the
    reference packs them) as f32 tensors on `device`."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=np.float32))).to(dev) for a in arrays]

