"""quest_tpu_torch — the PyTorch/CUDA port of quest_tpu for NVIDIA Hopper.

The JAX package `quest_tpu` stays the reference; this package imports
neither it nor JAX. State layout matches the reference at every public
function: (2, 2^n) or (2, rows, 128) float32 re/im planes.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a GPU and without that explicit request they
raise (quest_tpu_torch.env.default_device). On the card, the fused
engine (Circuit.compiled_fused) runs every swept segment as one launch
of the hand-written segment kernel (csrc/segment.cu); on the CPU the
same wrapper runs its plain PyTorch version. Statevector and
density-matrix registers (Kraus channels as superoperators on the
doubled register) both run through it.

The QuEST user surface runs on the same registers: eager gates and
channels (ops.gates, ops.channels), measurement, sampling and dynamic
circuits (measurement, Circuit.measure / gate_if / compiled_measured),
and calculations (inner products, fidelity, Pauli expectations, linear
XEB).

The front ends (ROADMAP A9): the QuEST C API under its camelCase names
(api), QASM out (qasm, Circuit.to_qasm) and in (Circuit.from_qasm), the
transpiler (transpile, Circuit.transpiled) and the plan IR with its
priced autotuner (plan, Circuit.plan_stats).

The top level binds every name the reference's package does
(quest_tpu/__init__.py), in its calling conventions; the submodules
checkpoint, profiling, variational, trajectories and evolution load on
first access.
"""

from quest_tpu_torch import (api, calculations, measurement, plan, qasm,
                             transpile)
from quest_tpu_torch.calculations import (calc_expec_pauli_prod,
                                          calc_expec_pauli_sum, calc_fidelity,
                                          calc_inner_product, calc_purity,
                                          calc_total_prob)
from quest_tpu_torch.circuit import Circuit, GateOp, qft_circuit, random_circuit
from quest_tpu_torch.env import QuESTEnv, create_quest_env
from quest_tpu_torch.measurement import (calc_prob_of_outcome,
                                         collapse_to_outcome, measure,
                                         measure_with_stats, sample)
from quest_tpu_torch.ops import channels, gates
from quest_tpu_torch.ops.expec import PauliSum
from quest_tpu_torch.precision import (get_default_dtype, real_dtype_of,
                                       real_eps, set_default_dtype)
from quest_tpu_torch.state import (Qureg, basis_planes, clone,
                                   create_density_qureg, create_qureg,
                                   fused_state_shape, get_amp,
                                   get_density_amp, init_blank_state,
                                   init_classical_state, init_debug_state,
                                   init_plus_state, init_pure_state,
                                   init_state_from_amps, init_zero_state,
                                   set_amps, set_density_amps, to_dense)
from quest_tpu_torch.validation import QuESTError

__version__ = "0.1.0"

_LAZY = ("checkpoint", "profiling", "variational", "trajectories",
         "evolution")

__all__ = [
    "Circuit", "GateOp", "PauliSum", "QuESTEnv", "QuESTError", "Qureg",
    "api", "basis_planes", "calc_expec_pauli_prod", "calc_expec_pauli_sum",
    "calc_fidelity", "calc_inner_product", "calc_prob_of_outcome",
    "calc_purity", "calc_total_prob", "calculations", "channels", "clone",
    "collapse_to_outcome", "create_density_qureg", "create_quest_env",
    "create_qureg", "fused_state_shape", "gates", "get_amp",
    "get_default_dtype", "get_density_amp", "init_blank_state",
    "init_classical_state", "init_debug_state", "init_plus_state",
    "init_pure_state", "init_state_from_amps", "init_zero_state", "measure",
    "measure_with_stats", "measurement", "plan", "qasm", "qft_circuit",
    "random_circuit", "real_dtype_of", "real_eps", "sample", "set_amps",
    "set_default_dtype", "set_density_amps", "to_dense", "transpile",
    *_LAZY,
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'quest_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib
    mod = importlib.import_module(f"quest_tpu_torch.{name}")
    globals()[name] = mod
    return mod
