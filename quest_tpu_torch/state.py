"""The simulation state: split re/im planes in a torch tensor.

The layout is the reference's (quest_tpu/state.py): ONE real tensor of
shape (2, 2^N), plane 0 the real parts and plane 1 the imaginary parts,
qubit q being bit q of the flat amplitude index. The fused engine views
the same memory as (2, 2^(N-7), 128) (fused_state_shape); the two views
share storage, so switching between them is a reshape, not a copy.

A density matrix over N qubits is the same planes over 2N state
qubits: rho[r, c] sits at flat index r + c * 2^N (column-major), so the
row-space copy of qubit q is state qubit q and its column-space copy
q + N (ref QuEST.c:48-60).

Unlike the reference's immutable pytree, a port register may be updated
in place by the engines (the fused engine's kernel writes each tile back
where it read it; the per-gate and banded engines write chunk by chunk),
which keeps a 30-qubit f32 state at one 8 GiB buffer.

Planes are f32 (complex64 amplitudes) or f64 (complex128): the same
layout, with native double arithmetic on f64. Registers of any size from
one qubit use the flat (2, 2^n) planes; the fused view needs n >= 10.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops.band_plan import LANE_QUBITS, LANES, usable


@dataclasses.dataclass
class Qureg:
    """Statevector or density-matrix register.

    amps: (2, 2**num_state_qubits) real tensor — [0] real, [1] imag
    planes; num_state_qubits is 2N for a density matrix over N qubits.
    """

    amps: torch.Tensor
    num_qubits: int
    is_density: bool = False

    @property
    def num_state_qubits(self) -> int:
        return 2 * self.num_qubits if self.is_density else self.num_qubits

    @property
    def num_amps(self) -> int:
        return 1 << self.num_state_qubits

    @property
    def real_dtype(self) -> np.dtype:
        return np.dtype(str(self.amps.dtype).replace("torch.", ""))

    @property
    def dtype(self) -> np.dtype:
        """Logical (complex) amplitude dtype."""
        return precision.complex_dtype_of(self.real_dtype)

    def replace_amps(self, amps: torch.Tensor) -> "Qureg":
        return dataclasses.replace(self, amps=amps)


def basis_planes(flat_index: int, *, n: int, rdt=np.float32, shape=None,
                 device=None) -> torch.Tensor:
    """The (2, 2^n) re/im planes of computational-basis state
    |flat_index>, optionally in the view `shape` (see fused_state_shape),
    on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    out = torch.zeros((2, 1 << n), dtype=precision.torch_dtype(rdt),
                      device=dev)
    out[0, int(flat_index)] = 1.0
    return out.reshape(shape) if shape is not None else out


def fused_state_shape(n: int):
    """The fused engine's state view for an n-qubit register:
    (2, 2^(n-7), 128)."""
    if not usable(n):
        raise ValueError(
            f"the fused engine needs n >= {LANE_QUBITS + 3} qubits "
            f"(one (8, 128) f32 tile per block), got n={n}")
    return (2, 1 << (n - LANE_QUBITS), LANES)


def _make(num_qubits: int, is_density: bool, dtype, device) -> Qureg:
    validation.validate_num_qubits(num_qubits)
    dtype = np.dtype(dtype) if dtype is not None else precision.DEFAULT_DTYPE
    rdt = precision.real_dtype_of(dtype)
    n = 2 * num_qubits if is_density else num_qubits
    amps = basis_planes(0, n=n, rdt=rdt, device=device)
    return Qureg(amps=amps, num_qubits=num_qubits, is_density=is_density)


def create_qureg(num_qubits: int, dtype=None, device=None) -> Qureg:
    """Statevector register initialized to |0...0> (ref: QuEST.c:34-46):
    f32 planes for complex64 (the default), f64 for complex128."""
    return _make(num_qubits, False, dtype, device)


def create_density_qureg(num_qubits: int, dtype=None, device=None) -> Qureg:
    """Density-matrix register initialized to |0..0><0..0| (ref:
    QuEST.c:48-60): 2N state qubits, f32 planes for complex64 (the
    default), f64 for complex128."""
    return _make(num_qubits, True, dtype, device)


def init_zero_state(qureg: Qureg) -> Qureg:
    """|0...0> or |0..0><0..0|."""
    amps = torch.zeros_like(qureg.amps.reshape(2, -1))
    amps[0, 0] = 1.0
    return qureg.replace_amps(amps)


def init_plus_state(qureg: Qureg) -> Qureg:
    """|+>^N; density: the uniform matrix 1/2^N (ref
    QuEST_cpu.c:1406-1473)."""
    n = qureg.num_qubits
    val = 1.0 / (1 << n) if qureg.is_density else 1.0 / np.sqrt(1 << n)
    amps = torch.zeros_like(qureg.amps.reshape(2, -1))
    amps[0].fill_(val)
    return qureg.replace_amps(amps)


def init_classical_state(qureg: Qureg, state_index: int) -> Qureg:
    """Basis state |k> or |k><k| (ref QuEST_cpu.c:1475-1539)."""
    validation.validate_state_index(qureg, state_index)
    flat = state_index
    if qureg.is_density:
        flat = state_index + (state_index << qureg.num_qubits)
    amps = torch.zeros_like(qureg.amps.reshape(2, -1))
    amps[0, flat] = 1.0
    return qureg.replace_amps(amps)


def init_debug_state(qureg: Qureg) -> Qureg:
    """Deterministic unphysical state: amp[k] = (2k + i(2k+1))/10, the
    reference's initDebugState (QuEST_cpu.c:1559-1590), computed in the
    plane dtype exactly as quest_tpu.state.init_debug_state does."""
    k = torch.arange(qureg.num_amps, dtype=qureg.amps.dtype,
                     device=qureg.amps.device)
    return qureg.replace_amps(
        torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0]))


def get_density_amp(qureg: Qureg, row: int, col: int) -> complex:
    """rho[row, col] (ref getDensityAmp, QuEST.c:694-705)."""
    if not qureg.is_density:
        raise validation.QuESTError(
            "Invalid operation: getDensityAmp requires a density matrix")
    dim = 1 << qureg.num_qubits
    validation.validate_amp_index(qureg, row, dim=dim)
    validation.validate_amp_index(qureg, col, dim=dim)
    pair = qureg.amps.reshape(2, -1)[:, row + (col << qureg.num_qubits)]
    re, im = pair.cpu().tolist()
    return complex(re, im)


def to_dense(qureg_or_amps) -> np.ndarray:
    """Fetch the full state to the host: a (2^N,) complex vector, or the
    (2^N, 2^N) matrix for a density Qureg. Takes a Qureg or raw planes
    in any view of (2, 2^n) (raw planes come back as a flat vector)."""
    amps = getattr(qureg_or_amps, "amps", qureg_or_amps)
    planes = amps.detach().reshape(2, -1).cpu().numpy()
    arr = planes[0] + 1j * planes[1]
    if getattr(qureg_or_amps, "is_density", False):
        dim = 1 << qureg_or_amps.num_qubits
        return arr.reshape(dim, dim, order="F")
    return arr
