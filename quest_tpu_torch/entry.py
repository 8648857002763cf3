"""Entry point of the flagship step, mirroring __graft_entry__.entry.

entry(device=None) -> (fn, (amps,)): fn(amps) applies one depth-4
random circuit (seed 7, cz entanglers) to a 28-qubit f32 statevector
(a 2 GiB state of split re/im planes) through the fused engine, one
segment-kernel launch per swept segment, in place.
"""

from __future__ import annotations

from quest_tpu_torch.circuit import random_circuit
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.state import basis_planes, fused_state_shape

FLAGSHIP_QUBITS = 28
FLAGSHIP_DEPTH = 4


def flagship_circuit(num_qubits: int = FLAGSHIP_QUBITS,
                     depth: int = FLAGSHIP_DEPTH):
    return random_circuit(num_qubits, depth, seed=7, entangler="cz")


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
