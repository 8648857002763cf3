"""Carry circuits, state and segment operands across from the JAX
package.

The reference package's objects arrive as plain Python/numpy: a
quest_tpu GateOp is read by attribute (nothing of quest_tpu is
imported), state planes and operands as numpy arrays.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch

from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.env import resolve_device


def _operand(x):
    """A GateOp operand as the port stores it: Python scalars stay,
    arrays become numpy."""
    if x is None or isinstance(x, (int, float, complex)):
        return x
    return np.asarray(x)


def circuit_from_ops(ops: Iterable, num_qubits: int = None) -> Circuit:
    """A port Circuit holding the same gate stream as `ops` — quest_tpu
    GateOps (or anything with kind/targets/controls/cstates/operand
    attributes) with numpy operands. `num_qubits` defaults to one more
    than the highest qubit named."""
    ops = list(ops)
    if num_qubits is None:
        num_qubits = 1 + max((q for op in ops
                              for q in (*op.targets, *op.controls)),
                             default=0)
    c = Circuit(num_qubits)
    for op in ops:
        c.ops.append(GateOp(
            kind=op.kind, targets=tuple(int(t) for t in op.targets),
            controls=tuple(int(q) for q in op.controls),
            cstates=tuple(int(s) for s in op.cstates),
            operand=_operand(op.operand)))
    return c


def planes_from_numpy(planes, device=None) -> torch.Tensor:
    """State planes ((2, 2^n) or (2, rows, 128), any float dtype) as a
    contiguous f32 tensor on `device` (default: the CUDA card), same
    shape."""
    arr = np.ascontiguousarray(np.asarray(planes, dtype=np.float32))
    return torch.from_numpy(arr).to(resolve_device(device))


def operands_from_numpy(arrays: Sequence, device=None) -> List[torch.Tensor]:
    """Segment operand arrays (segment_plan's numpy f32 arrays, as the
    reference packs them) as f32 tensors on `device`."""
    dev = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=np.float32))).to(dev) for a in arrays]

