"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy: a statevector and density-matrix simulator of
dense gates, diagonal phases and Kraus channels, the order-2 product
formula of a Pauli-sum Hamiltonian, the Pauli-sum energy, Born sampling
and the density readouts. It imports neither JAX, nor the JAX package,
nor anything of quest_tpu_torch, and takes nothing the port has made: it
works every state out again from the same gate list or Hamiltonian.

A state is a flat complex tensor; qubit q is bit q of the amplitude
index. A density matrix over N qubits is the flat (2^2N,) tensor whose
entry r + c * 2^N is rho[r, c] (rows in the low N bits).

`Precision` says what a run computes in: TRUTH (complex128, IEEE
matmuls) is the reference; CONTROL (complex64 with every matmul operand
rounded to TF32, and TF32 matmuls on a card) is the nearest precision
below the float32 the configurations state, run in the program's place
to show that the comparison fails it.
"""

from portbench.reference.core import CONTROL, TRUTH, Precision  # noqa: F401
