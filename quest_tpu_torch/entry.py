"""Entry points of the port's main steps, mirroring __graft_entry__.entry.

entry(device=None) -> (fn, (amps,)): fn(amps) applies one depth-4
random circuit (seed 7, cz entanglers) to a 28-qubit f32 statevector
(a 2 GiB state of split re/im planes) through the fused engine, one
segment-kernel launch per swept segment, in place.

density_entry(device=None) -> (fn, (amps,)): fn(amps) applies the
noisy-RCS circuit (noisy_rcs_circuit: rotations, a cz brick, a
depolarising channel on every qubit and one damping channel per layer;
depth 3, seed 11) to a 14-qubit density register at |0><0| — 28 state
qubits, the flagship's 2 GiB — through the same engine: every channel
runs inside the segment kernel as a Kraus pair.

The two other density circuits the smoke test drives are here too:
bench_density_circuit (the repo's density bench scenario: rotations,
damping, a 2-qubit depolarising Kraus map and a Pauli Kraus map) and
clifford_t_density_circuit (Clifford+T gates and damping on every
qubit, whose plans carry general diagonals).
"""

from __future__ import annotations

import numpy as np

from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.state import basis_planes, fused_state_shape

FLAGSHIP_QUBITS = 28
FLAGSHIP_DEPTH = 4
DENSITY_QUBITS = 14           # 28 state qubits
DENSITY_DEPTH = 3


def flagship_circuit(num_qubits: int = FLAGSHIP_QUBITS,
                     depth: int = FLAGSHIP_DEPTH):
    return random_circuit(num_qubits, depth, seed=7, entangler="cz")


def noisy_rcs_circuit(num_qubits: int = DENSITY_QUBITS,
                      depth: int = DENSITY_DEPTH) -> Circuit:
    """Noisy RCS-shaped circuit (the repo bench's trajectory workload,
    bench.py _build_traj_circuit, draw for draw with seed 11): per layer,
    a random rx/ry/rz on every qubit, a cz brick, a depolarising channel
    (p = 0.02) on every qubit and one amplitude-damping channel
    (p = 0.05) on a random qubit."""
    rng = np.random.default_rng(11)
    c = Circuit(num_qubits)
    for d in range(depth):
        for q in range(num_qubits):
            kind = rng.integers(0, 3)
            ang = float(rng.uniform(0, 2 * np.pi))
            (c.rx if kind == 0 else c.ry if kind == 1 else c.rz)(q, ang)
        for q in range(d % 2, num_qubits - 1, 2):
            c.cz(q, q + 1)
        for q in range(num_qubits):
            c.depolarising(q, 0.02)
        c.damping(int(rng.integers(0, num_qubits)), 0.05)
    return c


def bench_density_circuit(num_qubits: int) -> Circuit:
    """The repo bench's density scenario (bench.py _build_density_circuit,
    BASELINE.json config 4): an rx layer (seed 7), amplitude damping on
    qubit 1, a two-qubit depolarising channel as its 16-operator Kraus
    map on (0, N-1), and a 4-operator Pauli Kraus map on qubit 2."""
    rng = np.random.default_rng(7)
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.rx(q, float(rng.uniform(0, 2 * np.pi)))
    c.damping(1, 0.1)
    p = 0.15
    paulis = [np.eye(2), M.PAULI_X, M.PAULI_Y, M.PAULI_Z]
    ops2 = []
    for i, a in enumerate(paulis):
        for j, b in enumerate(paulis):
            w = np.sqrt(1 - 15 * p / 16) if i == j == 0 else np.sqrt(p / 16)
            ops2.append(w * np.kron(b, a))
    c.kraus((0, num_qubits - 1), ops2)
    c.kraus(2, M.pauli_kraus(0.05, 0.05, 0.05))
    return c


def clifford_t_density_circuit(num_qubits: int) -> Circuit:
    """Clifford+T with decoherence: h then t on every qubit, a brick of
    cnots on the pairs (0, 1), (2, 3), ..., s on every qubit, and
    amplitude damping (p = 0.1) on every qubit. The s right after the
    cross-band cnot (6, 7) cannot fold into a band operator, so the plan
    holds general diagonals (DiagVecStage) for it and its dual."""
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.h(q)
    for q in range(num_qubits):
        c.t(q)
    for q in range(0, num_qubits - 1, 2):
        c.cnot(q, q + 1)
    for q in range(num_qubits):
        c.s(q)
    for q in range(num_qubits):
        c.damping(q, 0.1)
    return c


def entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
          depth: int = FLAGSHIP_DEPTH):
    """(fn, (amps,)) of the flagship step on `device` (default: the CUDA
    card; raises without one). amps is |0...0> in the fused view
    (2, 2^(n-7), 128)."""
    dev = resolve_device(device)
    n = num_qubits
    fn = flagship_circuit(n, depth).compiled_fused(n, device=dev)
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=dev)
    return fn, (amps,)


def density_entry(device=None, num_qubits: int = DENSITY_QUBITS,
                  depth: int = DENSITY_DEPTH):
    """(fn, (amps,)) of the density step on `device` (default: the CUDA
    card; raises without one): the noisy-RCS circuit on a density
    register of `num_qubits` qubits; amps is |0..0><0..0| in the fused
    view of its 2N state qubits."""
    dev = resolve_device(device)
    n = 2 * num_qubits
    fn = noisy_rcs_circuit(num_qubits, depth).compiled_fused(
        n, density=True, device=dev)
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=dev)
    return fn, (amps,)
