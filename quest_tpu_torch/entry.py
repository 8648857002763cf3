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

batched_entry(device=None) -> (fn, (amps_b,)): fn(amps_b) applies the
flagship's circuit cut to 24 qubits (random_circuit(24, 4, seed=7)) to a
batch of 64 random normalised states (seeded, made on the device; an
8 GiB batch) through the batched engine, one launch per swept segment
for the whole batch, in place.

trajectory_entry(device=None) -> (fn, (generator,)): fn(generator) runs
the repo bench's trajectory scenario — noisy_rcs_circuit(24, 3), 256
shots in chunks of 64 through trajectories.run_batched — and returns
(per-shot <Z_23> (256,), draws (256, 75)); the observable reduces each
chunk on the device, as the bench does, so no chunk's planes outlive it.

banded_entry(device=None) and pergate_entry(device=None) -> (fn,
(amps,)): the flagship step through the banded engine (compiled_banded)
and the per-gate engine (compiled) on flat (2, 2^28) planes, as the
reference's __graft_entry__.entry runs the flagship through banded_trace
off the TPU.

entry, density_entry, banded_entry and pergate_entry take a `dtype`:
complex64 (f32 planes, the default) or complex128 (f64 planes; the fused
program then runs its plan's banded items, as the reference's does).

Each entry compiles its program at the session's matmul tier
(QUEST_MATMUL_PRECISION or precision.set_matmul_precision: highest, high
or default), as the reference's entry points do.

measured_entry(device=None, engine="banded") -> (fn, (amps, generator)):
fn(amps, generator) runs repetition_code_circuit() — two rounds of a
bit-flip-code cycle on 28 data qubits and 2 syndrome ancillas (30 qubits,
8 GiB f32 planes): small rx/rz noise on every data qubit, two parity
syndromes measured, feedback corrections, the ancillas reset by
measurement and a conditioned flip — through compiled_measured(engine)
in place, and returns (amps, outcomes). The generator is a CPU
torch.Generator seeded with `seed`, so equal seeds give equal draws on
either engine and either device.

xeb_entry(device=None) -> (fn, (amps, generator)): fn(amps, generator)
runs the flagship step, then draws 2^20 samples of the state
(measurement.sample) and returns (linear XEB, samples) — the RCS
workload end to end: circuit, samples, fidelity estimate.

evolution_entry(device=None, num_qubits=30, steps=4) -> (fn, (state,)):
fn(state) runs the repo bench's evolution scenario — the transverse-field
Ising quench (tfim_sum: a ring of ZZ couplings at -1 and X fields at
-0.7), order 2, dt 0.05, `steps` steps from |0...0> on a 30-qubit f32
register (8 GiB) — through evolution.run_evolution with the energy
measured after every step, and returns its EvolutionResult; on the card
each step is the pooled Trotter circuit's fused program (K1 launches of
S7/S8 diagonal groups and the frame's band stages).

vqe_entry(device=None, num_qubits=30, layers=2) -> (fn, (theta,)): fn =
adjoint.value_and_grad of a hardware-efficient ansatz (hea_circuit: ry
and rz on every qubit and a cz ring per layer; 120 parameters at 30
qubits and 2 layers, seeded angles) against the same TFIM Hamiltonian
through the adjoint engine: fn(theta) -> (energy, gradient); theta the
ansatz's angles.

gallery_qasm(n, depth=4, seed=20) -> {class: OpenQASM 2.0 text}: the
repo bench's QASM gallery (qft, qaoa, rcs, adder, ghz) in the rebased
1q+CX basis a foreign exporter emits, text for text.

frontend_entry(device=None, num_qubits=28, cls="qft", transpile=None) ->
(fn, args): the front ends end to end. The gallery class's text goes
through Circuit.from_qasm (transpile None follows QUEST_TRANSPILE) and
plan.autotune; fn(amps) runs the chosen engine's program in place on
|0...0> flat planes. The ghz class holds a mid-circuit measurement:
fn(amps, generator) runs its measured program and returns (amps,
outcomes). fn.plan (None for ghz) and fn.circuit name what ran.

sharded_entry(device=None, num_qubits=28, shards=4, engine="fused") ->
(fn, (x,)): the flagship step over a mesh of `shards` shards of one
device (make_amp_mesh(shards, devices=[device] * shards)): fn(x) runs
the flagship circuit through compiled_sharded_fused (the segment kernel
on every shard), compiled_sharded_banded (engine "banded") or
compiled_sharded (engine "pergate") in place; x is |0...0> as a
ShardedAmps over the mesh, whose recorder holds the exchanges of the
calls on it (x.mesh).

dryrun_multichip(n_devices, device=None) runs the reference's dryrun
(__graft_entry__.dryrun_multichip) on a mesh of n_devices shards of
`device`: a circuit with local, global and multi-target gates across
the split through the per-gate, banded and lazy-relabeled sharded
engines (agreeing within 1e-5), the fused engine at 10 local qubits
against the banded one (1e-4), and the norm through the mesh's
reduction, and 16 samples of the sharded state (per-shard CDFs, no
gather).

The two other density circuits the smoke test drives are here too:
bench_density_circuit (the repo's density bench scenario: rotations,
damping, a 2-qubit depolarising Kraus map and a Pauli Kraus map) and
clifford_t_density_circuit (Clifford+T gates and damping on every
qubit, whose plans carry general diagonals). Two diagonal circuits whose
plans are long runs of phase and parity stages: diag_layer_circuit (the
cost layer of a QAOA MaxCut step on a ring, or the diagonal block of an
IQP circuit) and cz_brick_circuit.
"""

from __future__ import annotations

import numpy as np
import torch

from quest_tpu_torch import calculations as K
from quest_tpu_torch import measurement as MS
from quest_tpu_torch import precision
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape

FLAGSHIP_QUBITS = 28
FLAGSHIP_DEPTH = 4
DENSITY_QUBITS = 14           # 28 state qubits
DENSITY_DEPTH = 3
BATCHED_QUBITS = 24
BATCHED_STATES = 64           # 64 x 128 MiB = an 8 GiB batch
TRAJ_QUBITS = 24              # bench.py _measure_trajectories on a chip
TRAJ_DEPTH = 3
TRAJ_SHOTS = 256
TRAJ_CHUNK = 64
TRAJ_SEED = 0
MEASURED_DATA_QUBITS = 28     # + 2 ancillas: 30 qubits, 8 GiB planes
MEASURED_ROUNDS = 2
MEASURED_SEED = 5
XEB_SHOTS = 1 << 20
XEB_SEED = 3
EVOLUTION_QUBITS = 30          # 8 GiB f32 planes
EVOLUTION_DT = 0.05
EVOLUTION_STEPS = 4
VQE_QUBITS = 30
VQE_LAYERS = 2
VQE_SEED = 13
SERVE_QUBITS = 20             # bench.py _measure_serve on a chip
SERVE_GATES = 16              # bench.py GATES_PER_STEP
SERVE_STATES = 512
SERVE_STATE_SEED = 7
SERVE_MAX_BATCH = 64
SERVE_WAIT_MS = 5


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


def diag_layer_circuit(num_qubits: int = FLAGSHIP_QUBITS,
                       seed: int = 10) -> Circuit:
    """rz on every qubit, then cphase on every edge (q, q + 1 mod n) of a
    ring, angles uniform in [0, 2 pi) from `seed`: a QAOA MaxCut cost
    layer on a ring. At 28 qubits the planner makes it one launch of 54
    stages: a phase, a multiphase, then a run of 28 parity and 24 phase
    stages."""
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.rz(q, float(rng.uniform(0, 2 * np.pi)))
    for q in range(num_qubits):
        c.cphase(float(rng.uniform(0, 2 * np.pi)), q, (q + 1) % num_qubits)
    return c


def cz_brick_circuit(num_qubits: int = FLAGSHIP_QUBITS) -> Circuit:
    """cz on (0, 1), (2, 3), ...: one launch of a multiphase and a run of
    phase stages at 28 qubits."""
    c = Circuit(num_qubits)
    for q in range(0, num_qubits - 1, 2):
        c.cz(q, q + 1)
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


def _planes(n: int, dtype, dev, shape=None):
    """|0...0> planes of an n-qubit register of amplitude `dtype`."""
    rdt = precision.real_dtype_of(dtype)
    return basis_planes(0, n=n, rdt=rdt, shape=shape, device=dev)


def haar_unitary(k: int, rng) -> np.ndarray:
    """A Haar-random 2^k x 2^k unitary from numpy generator `rng` (QR of
    a complex Gaussian matrix, the phases of R's diagonal divided out)."""
    d = 1 << k
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def wide_gates_circuit(num_qubits: int = FLAGSHIP_QUBITS,
                       depth: int = FLAGSHIP_DEPTH, seed: int = 3) -> Circuit:
    """BASELINE.json config 3 (multiControlledUnitary and general
    n-qubit gates) on the flagship: the depth-`depth` flagship circuit,
    then a 5-target and a 6-target Haar unitary on qubits spread over
    the bands, and a 2-target Haar unitary with 3 controls, one of them
    conditioned on state 0 (num_qubits >= 11). No kernel stage reaches these three: on the
    fused engine they run as passthroughs between segments."""
    rng = np.random.default_rng(seed)
    c = flagship_circuit(num_qubits, depth)
    qubits = rng.permutation(num_qubits)
    c.gate(haar_unitary(5, rng), qubits[:5])
    c.gate(haar_unitary(6, rng), qubits[5:11])
    qubits = rng.permutation(num_qubits)
    c.gate(haar_unitary(2, rng), qubits[:2], controls=qubits[2:5],
           cstates=(1, 0, 1))
    return c


def tutorial_circuit() -> Circuit:
    """The reference QuEST tutorial (examples/tutorial_example.c:50-105)
    on 3 qubits, gate for gate as tests/test_api.py drives it; the
    reference binary prints prob |111> = 0.112422 and prob(qubit 2 = 1)
    = 0.749178."""
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    toffoli = np.eye(8, dtype=np.complex128)[[0, 1, 2, 3, 4, 5, 7, 6]]
    c = Circuit(3).h(0).cnot(0, 1).ry(2, 0.1)
    c.cu(M.PAULI_Z, 2, 0, 1)                    # multiControlledPhaseFlip
    c.gate(u, (0,)).gate(M.compact_unitary(a, b), (1,))
    c.gate(M.rotation(3.14 / 2, (1.0, 0.0, 0.0)), (2,))
    c.cu(M.compact_unitary(a, b), 1, 0).cu(u, 2, 0, 1)
    return c.gate(toffoli, (0, 1, 2))


def entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
          depth: int = FLAGSHIP_DEPTH, dtype=np.complex64):
    """(fn, (amps,)) of the flagship step on `device` (default: the CUDA
    card; raises without one). amps is |0...0> in the fused view
    (2, 2^(n-7), 128), f32 or (dtype complex128) f64."""
    dev = resolve_device(device)
    n = num_qubits
    fn = flagship_circuit(n, depth).compiled_fused(n, device=dev)
    return fn, (_planes(n, dtype, dev, fused_state_shape(n)),)


def banded_entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
                 depth: int = FLAGSHIP_DEPTH, dtype=np.complex64):
    """(fn, (amps,)) of the flagship step through the banded engine on
    `device` (default: the CUDA card); amps is |0...0> as flat planes."""
    dev = resolve_device(device)
    n = num_qubits
    fn = flagship_circuit(n, depth).compiled_banded(n, device=dev)
    return fn, (_planes(n, dtype, dev),)


def pergate_entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
                  depth: int = FLAGSHIP_DEPTH, dtype=np.complex64):
    """(fn, (amps,)) of the flagship step through the per-gate engine on
    `device` (default: the CUDA card); amps is |0...0> as flat planes."""
    dev = resolve_device(device)
    n = num_qubits
    fn = flagship_circuit(n, depth).compiled(n, device=dev)
    return fn, (_planes(n, dtype, dev),)


def density_entry(device=None, num_qubits: int = DENSITY_QUBITS,
                  depth: int = DENSITY_DEPTH, dtype=np.complex64):
    """(fn, (amps,)) of the density step on `device` (default: the CUDA
    card; raises without one): the noisy-RCS circuit on a density
    register of `num_qubits` qubits; amps is |0..0><0..0| in the fused
    view of its 2N state qubits, f32 or (dtype complex128) f64."""
    dev = resolve_device(device)
    n = 2 * num_qubits
    fn = noisy_rcs_circuit(num_qubits, depth).compiled_fused(
        n, density=True, device=dev)
    return fn, (_planes(n, dtype, dev, fused_state_shape(n)),)


SHARDED_SHARDS = 4


def sharded_entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
                  shards: int = SHARDED_SHARDS, engine: str = "fused",
                  depth: int = FLAGSHIP_DEPTH):
    """(fn, (x,)) of the flagship step over `shards` shards of `device`
    (default: the CUDA card; raises without one); x is |0...0> as a
    ShardedAmps of f32 planes."""
    from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh
    dev = resolve_device(device)
    mesh = make_amp_mesh(shards, devices=[dev] * shards)
    n = num_qubits
    c = flagship_circuit(n, depth)
    build = {"fused": c.compiled_sharded_fused,
             "banded": c.compiled_sharded_banded,
             "pergate": c.compiled_sharded}
    if engine not in build:
        raise ValueError(f"engine must be one of {sorted(build)}, "
                         f"got {engine!r}")
    fn = build[engine](n, False, mesh)
    # |0...0>: shard 0 holds amplitude 0, every other shard zeros
    local = [torch.zeros((2, 1 << (n - mesh.global_qubits)),
                         dtype=torch.float32, device=dev)
             for _ in range(shards)]
    local[0][0, 0] = 1.0
    return fn, (ShardedAmps(local, mesh, n),)


def dryrun_circuit(n: int) -> Circuit:
    """The reference dryrun's circuit (__graft_entry__.dryrun_multichip):
    every qubit class — local targets, global targets (one- and
    two-qubit), global controls, diagonals, a SWAP and a general 2-qubit
    unitary across the split."""
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.rz(n - 1, 0.3)
    c.cz(0, n - 1)
    c.swap(0, n - 1)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    q_, _ = np.linalg.qr(m)
    c.gate(q_, (1, n - 1))
    for q in range(n):
        c.ry(q, 0.1 * (q + 1))
    return c


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The reference's dryrun_multichip on a mesh of n_devices shards of
    `device` (default: the CUDA card): returns the largest differences
    and the norm; raises AssertionError where the reference asserts."""
    from quest_tpu_torch.parallel import make_amp_mesh, shard_planes
    from quest_tpu_torch.parallel import sharded as S
    dev = resolve_device(device)
    mesh = make_amp_mesh(n_devices, devices=[dev] * n_devices)
    g = mesh.global_qubits
    n = g + 4                       # 4 local qubits per shard
    c = dryrun_circuit(n)
    amps = basis_planes(0, n=n, rdt=np.float32, device=dev)

    def run(prog, planes, nq):
        return prog(shard_planes(planes, mesh, nq)).gather()
    out = run(S.compile_circuit_sharded(c.ops, n, False, mesh), amps, n)
    out_b = run(S.compile_circuit_sharded_banded(c.ops, n, False, mesh),
                amps, n)
    rec = {"banded": (out - out_b).abs().max().item()}
    assert rec["banded"] < 1e-5, f"banded sharded engine diverged: {rec}"
    n2 = g + 10
    c2 = random_circuit(n2, 2, seed=3)
    amps2 = basis_planes(0, n=n2, rdt=np.float32, device=dev)
    out_f = run(S.compile_circuit_sharded_fused(c2.ops, n2, False, mesh),
                amps2, n2)
    out_b2 = run(S.compile_circuit_sharded_banded(c2.ops, n2, False, mesh),
                 amps2, n2)
    rec["fused"] = (out_f - out_b2).abs().max().item()
    assert rec["fused"] < 1e-4, f"fused sharded engine diverged: {rec}"
    x = shard_planes(out, mesh, n)
    rec["norm"] = mesh.reduce([s.double().pow(2).sum()
                               for s in x.shards]).item()
    assert abs(rec["norm"] - 1.0) < 1e-4, f"norm drifted: {rec}"
    out_l = run(S.compile_circuit_sharded(c.ops, n, False, mesh, lazy=True),
                amps, n)
    rec["lazy"] = (out_l - out).abs().max().item()
    assert rec["lazy"] < 1e-5, f"lazy relabeling diverged: {rec}"
    from quest_tpu_torch.measurement import sample
    shots = sample(Qureg(amps=x, num_qubits=n), 16,
                   torch.Generator().manual_seed(0))
    assert shots.shape == (16,) and int(shots.min()) >= 0 \
        and int(shots.max()) < (1 << n), shots
    rec["samples"] = shots.tolist()
    return rec


def random_states(batch: int, n: int, seed: int = 7, device=None):
    """(batch, 2, 2^(n-7), 128) f32 planes of `batch` random normalised
    states, drawn from a seeded generator on `device` (default: the CUDA
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    amps = torch.randn((batch,) + fused_state_shape(n), generator=gen,
                       device=dev)
    norms = amps.double().pow(2).sum(dim=(1, 2, 3)).sqrt()
    return amps.div_(norms.to(torch.float32).reshape(-1, 1, 1, 1))


def batched_entry(device=None, num_qubits: int = BATCHED_QUBITS,
                  depth: int = FLAGSHIP_DEPTH, batch: int = BATCHED_STATES):
    """(fn, (amps_b,)) of the batched step on `device` (default: the CUDA
    card; raises without one): the depth-`depth` flagship circuit on a
    batch of `batch` random normalised `num_qubits`-qubit states."""
    dev = resolve_device(device)
    fn = flagship_circuit(num_qubits, depth).compiled_batched(batch, device=dev)
    return fn, (random_states(batch, num_qubits, device=dev),)


def serve_circuit(num_qubits: int = SERVE_QUBITS) -> Circuit:
    """The repo bench's serving workload circuit (bench.py _build_circuit,
    draw for draw with seed 42): SERVE_GATES rx rotations round-robin over
    qubits 1..n-1."""
    rng = np.random.default_rng(42)
    c = Circuit(num_qubits)
    for i in range(SERVE_GATES):
        c.rx(1 + i % (num_qubits - 1), float(rng.uniform(0, 2 * np.pi)))
    return c


def serve_states(num_qubits: int = SERVE_QUBITS, count: int = SERVE_STATES,
                 seed: int = SERVE_STATE_SEED) -> np.ndarray:
    """(count, 2, 2^n) f32 normalised random planes: the bench's serving
    requests (bench.py _measure_serve, np.random.default_rng(7)), drawn
    64 states at a time (the same stream, a 64-state f64 temporary)."""
    rng = np.random.default_rng(seed)
    out = np.empty((count, 2, 1 << num_qubits), dtype=np.float32)
    for lo in range(0, count, 64):
        s = rng.standard_normal(out[lo:lo + 64].shape)
        out[lo:lo + 64] = s
        out[lo:lo + 64] /= np.sqrt(
            (out[lo:lo + 64] ** 2).sum(axis=(1, 2), keepdims=True))
    return out


def z_top(planes: torch.Tensor) -> torch.Tensor:
    """Per-shot <Z> of the highest qubit of (shots, 2, 2^n) planes, the
    bench's trajectory observable (bench.py _measure_trajectories)."""
    v = (planes[:, 0] ** 2 + planes[:, 1] ** 2).reshape(planes.shape[0], 2, -1)
    return (v[:, 0] - v[:, 1]).sum(dim=1)


def trajectory_entry(device=None, num_qubits: int = TRAJ_QUBITS,
                     depth: int = TRAJ_DEPTH, shots: int = TRAJ_SHOTS,
                     chunk: int = TRAJ_CHUNK, seed: int = TRAJ_SEED):
    """(fn, (generator,)) of the trajectory step on `device` (default:
    the CUDA card; raises without one): fn(generator) runs `shots`
    trajectories of noisy_rcs_circuit(num_qubits, depth) in chunks of
    `chunk` and returns (per-shot <Z_top>, draws). The generator is
    seeded with `seed` on the CPU; fn.circuit, fn.shots and fn.chunk name
    the run."""
    dev = resolve_device(device)
    circ = noisy_rcs_circuit(num_qubits, depth)

    def fn(generator):
        return T.run_batched(circ, shots, generator=generator, chunk=chunk,
                             observable=z_top, device=dev)
    fn.circuit, fn.shots, fn.chunk = circ, shots, chunk
    return fn, (torch.Generator().manual_seed(seed),)


def repetition_code_circuit(n_data: int = MEASURED_DATA_QUBITS,
                            rounds: int = MEASURED_ROUNDS) -> Circuit:
    """`rounds` bit-flip-code cycles on `n_data` data qubits and 2
    syndrome ancillas (tests/test_dynamic_circuits.py's 30-qubit-class
    cycle, draw for draw with seed 5): rx and rz of up to 0.2 rad on
    every data qubit, the parities (0, 1) and (1, 2) onto the ancillas,
    both measured, a correcting flip on data qubit 0, 1 or 2 conditioned
    on the pair, then each ancilla measured again and flipped back on
    outcome 1 (a reset)."""
    n = n_data + 2
    c = Circuit(n)
    rng = np.random.default_rng(5)
    out_idx = 0
    for _ in range(rounds):
        for qb in range(n_data):
            c.rx(qb, float(rng.uniform(0, 0.2)))
            c.rz(qb, float(rng.uniform(0, 0.2)))
        c.cnot(0, n_data)
        c.cnot(1, n_data)
        c.cnot(1, n_data + 1)
        c.cnot(2, n_data + 1)
        c.measure(n_data)
        c.measure(n_data + 1)
        c.x_if(0, ((out_idx, 1), (out_idx + 1, 0)))
        c.x_if(2, ((out_idx, 0), (out_idx + 1, 1)))
        c.x_if(1, ((out_idx, 1), (out_idx + 1, 1)))
        c.measure(n_data)
        c.measure(n_data + 1)
        c.x_if(n_data, (out_idx + 2, 1))
        c.x_if(n_data + 1, (out_idx + 3, 1))
        out_idx += 4
    return c


def measured_entry(device=None, n_data: int = MEASURED_DATA_QUBITS,
                   rounds: int = MEASURED_ROUNDS, engine: str = "banded",
                   seed: int = MEASURED_SEED):
    """(fn, (amps, generator)) of the dynamic-circuit step on `device`
    (default: the CUDA card; raises without one): fn(amps, generator)
    runs repetition_code_circuit(n_data, rounds) through
    compiled_measured(engine) in place and returns (amps, outcomes int32).
    amps is |0...0> as flat planes; fn.circuit names the circuit."""
    dev = resolve_device(device)
    circ = repetition_code_circuit(n_data, rounds)
    n = circ.num_qubits
    fn = circ.compiled_measured(n, engine=engine, device=dev)
    fn.circuit = circ
    return fn, (_planes(n, np.complex64, dev),
                torch.Generator().manual_seed(seed))


def xeb_entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
              depth: int = FLAGSHIP_DEPTH, shots: int = XEB_SHOTS,
              seed: int = XEB_SEED):
    """(fn, (amps, generator)) of the sampling step on `device` (default:
    the CUDA card; raises without one): fn(amps, generator) applies the
    flagship step to amps in place, draws `shots` samples of the state
    from `generator` and returns (linear XEB, samples). fn.step is the
    flagship program, fn.shots the shot count."""
    dev = resolve_device(device)
    step, (amps,) = entry(dev, num_qubits, depth)

    def fn(amps, generator):
        step(amps)
        q = Qureg(amps=amps, num_qubits=num_qubits)
        samples = MS.sample(q, shots, generator)
        return K.calc_linear_xeb(q, samples), samples
    fn.step, fn.shots = step, shots
    return fn, (amps, torch.Generator().manual_seed(seed))


def tfim_sum(n: int):
    """(codes, coeffs) of the n-qubit transverse-field Ising Hamiltonian
    of the repo bench (bench.py _build_tfim_sum): n ring ZZ couplings at
    -1 and n X fields at -0.7. Its grouped plan is 2 sweeps."""
    rows = []
    for i in range(n):
        r = [0] * n
        r[i] = 3
        r[(i + 1) % n] = 3
        rows.append(r)
    for i in range(n):
        r = [0] * n
        r[i] = 1
        rows.append(r)
    coeffs = np.concatenate([np.full(n, -1.0), np.full(n, -0.7)])
    return np.asarray(rows), coeffs


def random_support_sum(n: int, terms: int = 100, families: int = 8,
                       seed: int = 42):
    """(codes, coeffs) of the bench's random-support sum (bench.py
    _build_random_support_sum): 40 % diagonal terms on random Z
    supports, the rest X/Y on `families` random supports dressed with
    two Z factors elsewhere — the shape of a tapered molecular
    Hamiltonian, about 1 + families mask groups."""
    rng = np.random.default_rng(seed)
    n_diag = int(terms * 0.4)
    rows = []
    for _ in range(n_diag):
        r = np.zeros(n, dtype=np.int32)
        sup = rng.choice(n, size=rng.integers(1, 4), replace=False)
        r[sup] = 3
        rows.append(r)
    fams = [rng.choice(n, size=rng.integers(1, 4), replace=False)
            for _ in range(families)]
    for i in range(terms - n_diag):
        r = np.zeros(n, dtype=np.int32)
        fam = fams[i % families]
        r[fam] = rng.integers(1, 3, size=len(fam))      # X or Y
        rest = [q for q in range(n) if q not in fam]
        r[rng.choice(rest, size=2, replace=False)] = 3  # Z dressing
        rows.append(r)
    return np.stack(rows), rng.standard_normal(terms)


def evolution_entry(device=None, num_qubits: int = EVOLUTION_QUBITS,
                    steps: int = EVOLUTION_STEPS, dt: float = EVOLUTION_DT,
                    engine: str = None):
    """(fn, (state,)) of the TFIM quench on `device` (default: the CUDA
    card): fn(state) -> evolution.EvolutionResult, order 2, the energy
    after every step; state is |0...0> (f32); `engine` as run_evolution
    takes it (None: the fused engine on the card)."""
    from quest_tpu_torch import evolution as EV
    from quest_tpu_torch.state import create_qureg
    dev = resolve_device(device)
    codes, coeffs = tfim_sum(num_qubits)

    def fn(state):
        return EV.run_evolution((codes, coeffs), dt, steps, state=state,
                                order=2, energy_every=1, engine=engine)
    return fn, (create_qureg(num_qubits, device=dev),)


def hea_circuit(num_qubits: int, layers: int, seed: int = VQE_SEED):
    """The hardware-efficient ansatz: per layer ry and rz on every qubit
    (seeded angles) and a cz ring."""
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    for _ in range(layers):
        for q in range(num_qubits):
            c.ry(q, float(rng.uniform(-np.pi, np.pi)))
        for q in range(num_qubits):
            c.rz(q, float(rng.uniform(-np.pi, np.pi)))
        for q in range(num_qubits):
            c.cz(q, (q + 1) % num_qubits)
    return c


def vqe_entry(device=None, num_qubits: int = VQE_QUBITS,
              layers: int = VQE_LAYERS, engine: str = "adjoint"):
    """(fn, (theta,)) of the VQE gradient step on `device` (default: the
    CUDA card): fn = adjoint.value_and_grad(hea_circuit, TFIM, engine)
    and theta its recovered angles (f32, on the device)."""
    from quest_tpu_torch import adjoint as AD
    dev = resolve_device(device)
    codes, coeffs = tfim_sum(num_qubits)
    fn = AD.value_and_grad(hea_circuit(num_qubits, layers), codes,
                           coeffs=coeffs, engine=engine, device=dev)
    theta = torch.as_tensor(fn.initial_params, dtype=torch.float32,
                            device=dev)
    return fn, (theta,)


# ---------------------------------------------------------------------------
# the front ends: the QASM gallery (bench.py build_gallery_qasm)
# ---------------------------------------------------------------------------

GALLERY_CLASSES = ("qft", "qaoa", "rcs", "adder", "ghz")


def _qasm_cphase_lines(theta: float, a: int, b: int):
    """cu1(theta) in the rebased exporter form rz/cx/rz/cx/rz."""
    return [f"rz({theta / 2}) q[{a}];", f"cx q[{a}],q[{b}];",
            f"rz({-theta / 2}) q[{b}];", f"cx q[{a}],q[{b}];",
            f"rz({theta / 2}) q[{b}];"]


def _qasm_ccx_lines(a: int, b: int, c: int):
    """ccx in the standard Clifford+T decomposition (15 ops)."""
    return [f"h q[{c}];", f"cx q[{b}],q[{c}];", f"tdg q[{c}];",
            f"cx q[{a}],q[{c}];", f"t q[{c}];", f"cx q[{b}],q[{c}];",
            f"tdg q[{c}];", f"cx q[{a}],q[{c}];", f"t q[{b}];",
            f"t q[{c}];", f"h q[{c}];", f"cx q[{a}],q[{b}];",
            f"t q[{a}];", f"tdg q[{b}];", f"cx q[{a}],q[{b}];"]


def gallery_qasm(n: int, depth: int = 4, seed: int = 20) -> dict:
    """{class: OpenQASM 2.0 text} of the gallery's five classes on n
    qubits, the same text as the repo bench's build_gallery_qasm: QFT
    (h and the controlled-phase ladder as rz/cx chains, swaps as 3 cx),
    ring QAOA (cx.rz.cx costs, h.rz.h mixers), RCS (rz.ry.rz Euler
    triples and a cz brick), a Cuccaro ripple-carry adder (toffolis in
    their 15-op Clifford+T form) and GHZ with a mid-circuit measurement."""
    rng = np.random.default_rng(seed)
    head = ["OPENQASM 2.0;", 'include "qelib1.inc";',
            f"qreg q[{n}];", f"creg c[{n}];"]
    out = {}

    lines = list(head)
    for i in range(n):
        lines.append(f"h q[{i}];")
        for j in range(i + 1, n):
            lines += _qasm_cphase_lines(np.pi / (1 << (j - i)), j, i)
    for i in range(n // 2):
        a, b = i, n - 1 - i
        lines += [f"cx q[{a}],q[{b}];", f"cx q[{b}],q[{a}];",
                  f"cx q[{a}],q[{b}];"]
    out["qft"] = "\n".join(lines)

    lines = list(head)
    for i in range(n):
        lines.append(f"h q[{i}];")
    for layer in range(depth):
        g, b = 0.4 + 0.1 * layer, 0.3 + 0.05 * layer
        for i in range(n):
            j = (i + 1) % n
            lines += [f"cx q[{i}],q[{j}];", f"rz({2 * g}) q[{j}];",
                      f"cx q[{i}],q[{j}];"]
        for i in range(n):
            lines += [f"h q[{i}];", f"rz({2 * b}) q[{i}];",
                      f"h q[{i}];"]
    out["qaoa"] = "\n".join(lines)

    lines = list(head)
    for layer in range(depth):
        for i in range(n):
            a1, a2, a3 = rng.uniform(-np.pi, np.pi, 3)
            lines += [f"rz({a1}) q[{i}];", f"ry({a2}) q[{i}];",
                      f"rz({a3}) q[{i}];"]
        for i in range(layer % 2, n - 1, 2):
            lines.append(f"cz q[{i}],q[{i + 1}];")
    out["rcs"] = "\n".join(lines)

    w = (n - 1) // 2                       # operand width
    lines = list(head)
    for i in range(n):
        if rng.uniform() < 0.5:
            lines.append(f"x q[{i}];")     # seeded input operands
    prev = 0
    maj, uma = [], []
    for k in range(w):
        a, b = 1 + 2 * k, 2 + 2 * k
        maj += [f"cx q[{a}],q[{b}];", f"cx q[{a}],q[{prev}];"]
        maj += _qasm_ccx_lines(prev, b, a)
        uma = (_qasm_ccx_lines(prev, b, a)
               + [f"cx q[{a}],q[{prev}];", f"cx q[{prev}],q[{b}];"]
               + uma)
        prev = a
    out["adder"] = "\n".join(lines + maj + uma)

    lines = list(head)
    lines.append("h q[0];")
    for i in range(n - 1):
        lines.append(f"cx q[{i}],q[{i + 1}];")
    lines.append("measure q[0] -> c[0];")
    for i in range(n - 1, 0, -1):
        lines.append(f"cx q[{i - 1}],q[{i}];")
    lines.append("h q[0];")
    out["ghz"] = "\n".join(lines)
    return out


def frontend_entry(device=None, num_qubits: int = FLAGSHIP_QUBITS,
                   cls: str = "qft", transpile=None, seed: int = 0,
                   persist: bool = False):
    """(fn, args) of one gallery class through the front ends on `device`
    (default: the CUDA card): QASM text -> Circuit.from_qasm(transpile)
    -> plan.autotune (persist: through the plan cache) -> the chosen
    engine's program. fn(amps) runs it in place on args = (|0...0> flat
    planes,). The ghz class runs its measured program instead:
    fn(amps, generator) -> (amps, outcomes), args = (planes, a CPU
    generator seeded with `seed`). fn.circuit is the imported circuit,
    fn.plan the chosen ProgramPlan (None for ghz)."""
    from quest_tpu_torch import plan as P
    dev = resolve_device(device)
    n = num_qubits
    circ = Circuit.from_qasm(gallery_qasm(n)[cls], transpile=transpile)
    amps = _planes(n, np.complex64, dev)
    if circ._measure_count():
        prog = circ.compiled_measured(n, device=dev)

        def fn(amps, generator):
            return prog(amps, generator)
        fn.plan = None
        fn.circuit = circ
        return fn, (amps, torch.Generator().manual_seed(seed))
    plan = P.autotune(circ, device=dev, persist=persist)
    prog = P.compiled_for(circ, plan, device=dev)

    def fn(amps):
        return prog(amps)
    fn.plan = plan
    fn.circuit = circ
    fn.program = prog
    return fn, (amps,)
