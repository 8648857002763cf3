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

The initialisers and setters of ref quest_tpu/state.py:152-370
(init_blank_state, init_state_of_single_qubit, init_pure_state,
init_state_from_amps, set_amps, set_density_amps) write into the
register's own planes, on its device, and return it; `clone` gives a
register of its own buffer. The getters read single amplitudes.

A register whose planes are a parallel.ShardedAmps (parallel.shard_qureg,
or create_qureg(env=) over a QuESTEnv of several shards) runs every one
of these on its shards (parallel/eager.py): each shard writes or reads
its own slice, and nothing gathers but `to_dense`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops.band_plan import LANE_QUBITS, LANES, usable
from quest_tpu_torch.parallel import eager as SE


@dataclasses.dataclass
class Qureg:
    """Statevector or density-matrix register.

    amps: (2, 2**num_state_qubits) real tensor — [0] real, [1] imag
    planes — or a parallel.ShardedAmps of them; num_state_qubits is 2N
    for a density matrix over N qubits.
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
        return precision.numpy_dtype(self.amps.dtype)

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


def _make(num_qubits: int, is_density: bool, dtype, device, env) -> Qureg:
    validation.validate_num_qubits(num_qubits)
    dtype = (np.dtype(dtype) if dtype is not None
             else precision.get_default_dtype())
    rdt = precision.real_dtype_of(dtype)
    n = 2 * num_qubits if is_density else num_qubits
    mesh = env.sharding_for(n) if env is not None else None
    if device is None and env is not None:
        device = env.device
    if mesh is not None:
        m = 1 << (n - mesh.global_qubits)
        shards = [None if dev is None else
                  torch.zeros((2, m), dtype=precision.torch_dtype(rdt),
                              device=dev) for dev in mesh.devices]
        if shards[0] is not None:
            shards[0][0, 0] = 1.0
        amps = SE.ShardedAmps(shards, mesh, n)
    else:
        amps = basis_planes(0, n=n, rdt=rdt, device=device)
    return Qureg(amps=amps, num_qubits=num_qubits, is_density=is_density)


def create_qureg(num_qubits: int, env=None, dtype=None, *,
                 device=None) -> Qureg:
    """Statevector register initialized to |0...0> (ref: QuEST.c:34-46;
    the reference's argument order, quest_tpu/state.py:139): f32 planes
    for complex64, f64 for complex128, precision.get_default_dtype()
    when `dtype` is None. On `device`, else the env's device, else the
    CUDA card. Under an `env` over several shards (QuESTEnv([...]) /
    QuESTEnv(mesh=)) the planes are sharded over its mesh when the
    register holds at least two amplitudes a shard
    (QuESTEnv.sharding_for)."""
    return _make(num_qubits, False, dtype, device, env)


def create_density_qureg(num_qubits: int, env=None, dtype=None, *,
                         device=None) -> Qureg:
    """Density-matrix register initialized to |0..0><0..0| (ref:
    QuEST.c:48-60): 2N state qubits, dtype, device and sharding as
    create_qureg."""
    return _make(num_qubits, True, dtype, device, env)


def init_zero_state(qureg: Qureg) -> Qureg:
    """|0...0> or |0..0><0..0|."""
    if SE.is_sharded(qureg):
        return SE.init_zero_state(qureg)
    amps = torch.zeros_like(qureg.amps.reshape(2, -1))
    amps[0, 0] = 1.0
    return qureg.replace_amps(amps)


def init_plus_state(qureg: Qureg) -> Qureg:
    """|+>^N; density: the uniform matrix 1/2^N (ref
    QuEST_cpu.c:1406-1473)."""
    if SE.is_sharded(qureg):
        return SE.init_plus_state(qureg)
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
    if SE.is_sharded(qureg):
        return SE.init_classical_state(qureg, flat)
    amps = torch.zeros_like(qureg.amps.reshape(2, -1))
    amps[0, flat] = 1.0
    return qureg.replace_amps(amps)


def init_debug_state(qureg: Qureg) -> Qureg:
    """Deterministic unphysical state: amp[k] = (2k + i(2k+1))/10, the
    reference's initDebugState (QuEST_cpu.c:1559-1590), computed in the
    plane dtype exactly as quest_tpu.state.init_debug_state does."""
    if SE.is_sharded(qureg):
        return SE.init_debug_state(qureg)
    k = torch.arange(qureg.num_amps, dtype=qureg.amps.dtype,
                     device=qureg.amps.device)
    return qureg.replace_amps(
        torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0]))


def clone(qureg: Qureg) -> Qureg:
    """A copy in a buffer of its own (ref createCloneQureg,
    QuEST.c:62-72)."""
    return qureg.replace_amps(qureg.amps.clone())   # ShardedAmps.clone too


def _flat(qureg: Qureg) -> torch.Tensor:
    return qureg.amps.reshape(2, -1)


def init_blank_state(qureg: Qureg) -> Qureg:
    """Every amplitude zero (an unphysical state)."""
    if SE.is_sharded(qureg):
        return SE.init_blank_state(qureg)
    _flat(qureg).zero_()
    return qureg


def init_state_of_single_qubit(qureg: Qureg, qubit: int,
                               outcome: int) -> Qureg:
    """The uniform superposition of the basis states whose bit `qubit` is
    `outcome` (ref statevec_initStateOfSingleQubit,
    QuEST_cpu.c:1513-1555); statevectors only."""
    validation.validate_state_vector(qureg)
    validation.validate_target(qureg, qubit)
    validation.validate_outcome(outcome)
    if SE.is_sharded(qureg):
        return SE.init_state_of_single_qubit(qureg, qubit, outcome)
    n = qureg.num_state_qubits
    amps = _flat(qureg)
    amps.zero_()
    amps[0].view(1 << (n - 1 - qubit), 2, 1 << qubit)[:, outcome].fill_(
        1.0 / np.sqrt(1 << (n - 1)))
    return qureg


def init_pure_state(qureg: Qureg, pure: Qureg) -> Qureg:
    """|psi> (a statevector copy) or |psi><psi| (ref
    densmatr_initPureState, QuEST.c:139-146), a block of columns at a
    time."""
    validation.validate_pure_state_args(qureg, pure)
    if SE.is_sharded(qureg):
        return SE.init_pure_state(qureg, pure)
    amps = _flat(qureg)
    src = pure.amps.reshape(2, -1).to(device=amps.device, dtype=amps.dtype)
    if not qureg.is_density:
        amps.copy_(src)
        return qureg
    dim = 1 << qureg.num_qubits
    re, im = src[0], src[1]
    # rho[r, c] = psi_r conj(psi_c) at flat r + c dim: row c of the
    # (dim, dim) view holds column c of rho
    mre, mim = amps[0].view(dim, dim), amps[1].view(dim, dim)
    step = max(1, (1 << 24) // dim)
    for c0 in range(0, dim, step):
        cr, ci = re[c0:c0 + step, None], im[c0:c0 + step, None]
        mre[c0:c0 + step] = cr * re + ci * im
        mim[c0:c0 + step] = cr * im - ci * re
    return qureg


def _host_pair(reals, imags, amps) -> torch.Tensor:
    rdt = precision.numpy_dtype(amps.dtype)
    pair = np.stack([np.asarray(reals, dtype=rdt).reshape(-1),
                     np.asarray(imags, dtype=rdt).reshape(-1)])
    return torch.from_numpy(pair).to(amps.device)


def _write(qureg: Qureg, start: int, pair: torch.Tensor) -> Qureg:
    """The (2, L) planes `pair` at flat amplitudes [start, start + L)."""
    if SE.is_sharded(qureg):
        return SE.write_range(qureg, start, pair)
    _flat(qureg)[:, start:start + pair.shape[1]] = pair
    return qureg


def init_state_from_amps(qureg: Qureg, reals, imags) -> Qureg:
    """Overwrite every amplitude (ref QuEST.c:155-161)."""
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    validation.validate_equal_lengths(reals, imags)
    validation.validate_num_amps(qureg, 0, reals.size)
    if reals.size != qureg.num_amps:
        raise validation.QuESTError(
            "Invalid number of amplitudes: must match the register size")
    return _write(qureg, 0, _host_pair(reals, imags, qureg.amps))


def set_amps(qureg: Qureg, start_index: int, reals, imags) -> Qureg:
    """Overwrite a contiguous run of amplitudes (ref QuEST.c:779-786)."""
    validation.validate_state_vector(qureg)
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    validation.validate_equal_lengths(reals, imags)
    validation.validate_num_amps(qureg, start_index, reals.size)
    return _write(qureg, start_index, _host_pair(reals, imags, qureg.amps))


def set_density_amps(qureg: Qureg, start_row: int, start_col: int, reals,
                     imags) -> Qureg:
    """Write a flat run of amplitudes from rho[start_row, start_col] in
    the column-major flat order (ref QuEST_debug.h:44-48)."""
    if not qureg.is_density:
        raise validation.QuESTError(
            "Invalid operation: setDensityAmps requires a density matrix")
    reals = np.asarray(reals).reshape(-1)
    imags = np.asarray(imags).reshape(-1)
    validation.validate_equal_lengths(reals, imags)
    dim = 1 << qureg.num_qubits
    validation.validate_amp_index(qureg, start_row, dim=dim)
    validation.validate_amp_index(qureg, start_col, dim=dim)
    start = start_row + (start_col << qureg.num_qubits)
    validation.validate_num_amps(qureg, start, reals.size)
    return _write(qureg, start, _host_pair(reals, imags, qureg.amps))


def _fetch_amp(qureg: Qureg, flat: int) -> complex:
    if SE.is_sharded(qureg):
        return SE.read_amp(qureg, flat)
    re, im = _flat(qureg)[:, flat].cpu().tolist()
    return complex(re, im)


def get_amp(qureg: Qureg, index: int) -> complex:
    """Amplitude `index` of a statevector (ref QuEST.c:671-690)."""
    validation.validate_amp_index(qureg, index)
    validation.validate_state_vector(qureg)
    return _fetch_amp(qureg, index)


def get_real_amp(qureg: Qureg, index: int) -> float:
    return get_amp(qureg, index).real


def get_imag_amp(qureg: Qureg, index: int) -> float:
    return get_amp(qureg, index).imag


def get_prob_amp(qureg: Qureg, index: int) -> float:
    a = get_amp(qureg, index)
    return a.real * a.real + a.imag * a.imag


def get_num_qubits(qureg: Qureg) -> int:
    return qureg.num_qubits


def get_num_amps(qureg: Qureg) -> int:
    """Statevector amplitude count (ref getNumAmps)."""
    validation.validate_state_vector(qureg)
    return qureg.num_amps


def get_density_amp(qureg: Qureg, row: int, col: int) -> complex:
    """rho[row, col] (ref getDensityAmp, QuEST.c:694-705)."""
    if not qureg.is_density:
        raise validation.QuESTError(
            "Invalid operation: getDensityAmp requires a density matrix")
    dim = 1 << qureg.num_qubits
    validation.validate_amp_index(qureg, row, dim=dim)
    validation.validate_amp_index(qureg, col, dim=dim)
    return _fetch_amp(qureg, row + (col << qureg.num_qubits))


def to_dense(qureg_or_amps) -> np.ndarray:
    """Fetch the full state to the host: a (2^N,) complex vector, or the
    (2^N, 2^N) matrix for a density Qureg. Takes a Qureg or raw planes
    in any view of (2, 2^n) (raw planes come back as a flat vector). A
    sharded register's planes are gathered here: with
    ShardedAmps.gather, the only explicit gathers of the port."""
    amps = getattr(qureg_or_amps, "amps", qureg_or_amps)
    if not torch.is_tensor(amps):
        amps = amps.gather("cpu")
    planes = amps.detach().reshape(2, -1).cpu().numpy()
    arr = planes[0] + 1j * planes[1]
    if getattr(qureg_or_amps, "is_density", False):
        dim = 1 << qureg_or_amps.num_qubits
        return arr.reshape(dim, dim, order="F")
    return arr
