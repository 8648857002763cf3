"""The port's native host engine (quest_tpu_torch.native / host, the
Circuit host methods and trajectories.run_batched(engine="host")) against
the reference's (quest_tpu.native / host) and the port's banded engine.

Both packages load the same C++ sources (native/*.cpp), the port from
its own build under build/quest_tpu_torch. Circuits are built with the
reference's Circuit and converted (convert.circuit_from_ops), the same
numpy-seeded planes go through quest_tpu.host.compile_circuit_host and
the port's compiled_host, and both are held against the oracle of
tests/oracle.py and the port's compiled_banded: 2e-5 for f32 planes,
1e-12 for f64. Dynamic circuits are held against the port's eager
measurement API seeded alike (both draw from the MT19937 stream of
random_). The trajectory engine is held against the port's banded
program from one generator state (equal draws) and against the
reference's host engine given its draws (tests/test_torch_trajectories.py
maps JAX draws to uniforms). These mirror tests/test_host.py, the
MT19937 and runner cases of tests/test_native.py and the host case of
tests/test_scheduler.py.
"""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax

from quest_tpu import host as JH
from quest_tpu import native as JN
from quest_tpu import trajectories as JT
from quest_tpu.circuit import Circuit as JCircuit

from quest_tpu_torch import convert, host, native
from quest_tpu_torch import measurement as MS
from quest_tpu_torch import random_ as R
from quest_tpu_torch import state as S
from quest_tpu_torch import trajectories as T
from quest_tpu_torch import validation as TV
from quest_tpu_torch.circuit import Circuit, GateOp, flatten_ops
from quest_tpu_torch.ops import channels as CH
from quest_tpu_torch.ops import gates as G

from . import oracle
from .test_fuzz import _random_circuit
from .test_torch_trajectories import _uniforms_for

pytestmark = pytest.mark.dtype_agnostic

N = 6
TOL = {np.float32: 2e-5, np.float64: 1e-12}
# the canonical mt19937ar vector: genrand_real1 after init_by_array(
# [0x123, 0x234, 0x345, 0x456]) (tests/test_native.py)
REF_DRAWS = [0.24856890068588985, 0.22257348131914007, 0.11112762803936554,
             0.95628639309580588, 0.98463531513340663]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _require_libraries():
    if not (native.available() and JH.available()):
        pytest.skip(f"native host library unavailable: "
                    f"{native.unavailable_reason()}")


def _mixed_circuit(rng, n):
    """The reference test's circuit of every host kind (matrices of 1-3
    targets with 0/1 control states, a controlled diagonal, a parity
    rotation, an all-ones phase) as a reference Circuit, and its oracle
    op list."""
    c = JCircuit(n)
    ops = []

    def add(matrix, targets, controls=(), cstates=None):
        c.gate(matrix, targets, controls, cstates)
        ops.append((np.asarray(matrix), tuple(targets), tuple(controls),
                    tuple(cstates) if cstates else None))

    qs = [int(q) for q in rng.permutation(n)]
    add(oracle.random_unitary(1, rng), (qs[0],))
    add(oracle.random_unitary(1, rng), (qs[1],), (qs[2],), (0,))
    add(oracle.random_unitary(2, rng), (qs[3], qs[0]))
    add(oracle.random_unitary(3, rng), (qs[2], qs[5], qs[1]))
    add(oracle.random_unitary(2, rng), (qs[4], qs[2]), (qs[0], qs[1]),
        (1, 0))
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
    from quest_tpu.circuit import GateOp as JGateOp
    c.ops.append(JGateOp("diagonal", (qs[1], qs[4]), (qs[5],), (1,),
                         np.asarray(d)))
    ops.append((np.diag(d), (qs[1], qs[4]), (qs[5],), (1,)))
    ang = float(rng.uniform(0, 2 * np.pi))
    c.multi_rotate_z((qs[0], qs[3], qs[5]), ang)
    par = np.array([np.exp(-1j * ang / 2 * (-1.0) ** (bin(i).count("1") & 1))
                    for i in range(8)])
    ops.append((np.diag(par), (qs[0], qs[3], qs[5]), (), None))
    c.cphase(0.77, qs[2], qs[4])
    ops.append((np.diag([1, 1, 1, np.exp(1j * 0.77)]), (qs[2], qs[4]), (),
                None))
    return c, ops


def _planes(v, dtype):
    return np.stack([v.real, v.imag]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_host_matches_reference_oracle_and_banded(seed, dtype):
    rng = np.random.default_rng(500 + seed)
    jc, ops = _mixed_circuit(rng, N)
    tc = convert.circuit_from_ops(jc.ops, N)
    v0 = oracle.random_statevector(N, rng)
    want = v0
    for mat, targets, controls, cstates in ops:
        want = oracle.apply_to_vector(want, N, mat, targets, controls,
                                      cstates)
    ref = JH.compile_circuit_host(jc.ops, N, False)(_planes(v0, dtype))
    got = tc.compiled_host(N, False)(_planes(v0, dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got[0] + 1j * got[1], want,
                               atol=TOL[dtype], rtol=0)
    banded = tc.compiled_banded(N, device="cpu")(
        torch.from_numpy(_planes(v0, dtype)))
    np.testing.assert_allclose(got, banded.numpy(), atol=TOL[dtype], rtol=0)


def test_apply_host_on_registers_in_place():
    """apply_host on a CPU register runs in place on its planes; a torch
    tensor input is updated in place too."""
    rng = np.random.default_rng(3)
    jc, ops = _mixed_circuit(rng, N)
    tc = convert.circuit_from_ops(jc.ops, N)
    v0 = oracle.random_statevector(N, rng)
    q = S.init_state_from_amps(
        S.create_qureg(N, dtype=np.complex128, device="cpu"), v0.real,
        v0.imag)
    planes = q.amps
    out = tc.apply_host(q)
    assert out.amps is planes
    want = v0
    for mat, targets, controls, cstates in ops:
        want = oracle.apply_to_vector(want, N, mat, targets, controls,
                                      cstates)
    np.testing.assert_allclose(S.to_dense(out), want, atol=1e-12, rtol=0)
    x = torch.from_numpy(_planes(v0, np.float32))
    assert tc.compiled_host(N, False)(x) is x
    with pytest.raises(ValueError, match="host"):
        tc.compiled_host(N, False)(x.to("meta"))


@pytest.mark.parametrize("block", ["1", "3", "4"])
def test_host_blocked_schedule_invariant(block, monkeypatch):
    """Tiny blocks split the program into many groups; the result equals
    the one-group run (QUEST_HOST_BLOCK is keyed: a new program)."""
    rng = np.random.default_rng(77)
    jc, _ = _mixed_circuit(rng, N)
    tc = convert.circuit_from_ops(jc.ops, N)
    v0 = oracle.random_statevector(N, rng)
    base = tc.compiled_host(N, False)(_planes(v0, np.float64))
    monkeypatch.setenv("QUEST_HOST_BLOCK", block)
    got = tc.compiled_host(N, False)(_planes(v0, np.float64))
    np.testing.assert_allclose(got, base, atol=1e-13, rtol=0)
    assert f"block=2^{block} amps" in host.plan_summary(
        flatten_ops(tc.ops, N, False), N)


def test_host_density_channels_match_reference():
    """A density register with channels: superoperators flatten to
    doubled-target matrices, gate duals included."""
    nd = 3
    rng = np.random.default_rng(123)
    jc = JCircuit(nd)
    u = oracle.random_unitary(1, rng)
    jc.gate(u, (1,))
    jc.damping(0, 0.2)
    jc.dephasing(2, 0.3)
    tc = convert.circuit_from_ops(jc.ops, nd)
    rho0 = oracle.random_density(nd, rng)
    want = oracle.apply_to_density(rho0, nd, u, (1,))
    from quest_tpu.ops.matrices import damping_kraus, dephasing_kraus
    want = oracle.apply_kraus_to_density(want, nd, damping_kraus(0.2), (0,))
    want = oracle.apply_kraus_to_density(want, nd, dephasing_kraus(0.3),
                                         (2,))
    flat = rho0.reshape(-1, order="F")
    ref = JH.compile_circuit_host(jc.ops, 2 * nd, True)(
        _planes(flat, np.float64))
    q = S.init_state_from_amps(
        S.create_density_qureg(nd, dtype=np.complex128, device="cpu"),
        flat.real, flat.imag)
    got = tc.apply_host(q)
    np.testing.assert_allclose(q.amps.reshape(2, -1).numpy(), ref,
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(S.to_dense(got), want, atol=1e-12, rtol=0)


def test_host_iters_repeat():
    rng = np.random.default_rng(4)
    jc, _ = _mixed_circuit(rng, N)
    tc = convert.circuit_from_ops(jc.ops, N)
    planes = _planes(oracle.random_statevector(N, rng), np.float64)
    one = tc.compiled_host(N, False, iters=1)
    x = planes.copy()
    for _ in range(3):
        x = one(x)
    y = tc.compiled_host(N, False, iters=3)(planes.copy())
    np.testing.assert_array_equal(y, x)


def test_host_unsupported_is_loud():
    c = Circuit(2).h(0)
    c.measure(0)
    with pytest.raises(TV.QuESTError, match="measure"):
        c.compiled_host(2, False)
    c2 = Circuit(8)
    c2.ops.append(GateOp("matrix", tuple(range(7)), (), (),
                         np.eye(128, dtype=complex)))
    with pytest.raises(host.HostEngineUnsupported, match="7-target"):
        c2.compiled_host(8, False)
    c3 = Circuit(2)
    c3.ops.append(GateOp("matrix", (0,), (), (),
                         torch.eye(2, dtype=torch.complex128,
                                   requires_grad=True)))
    with pytest.raises(host.HostEngineUnsupported, match="grad"):
        c3.compiled_host(2, False)


def test_host_plan_summary_counts_sweeps():
    c = Circuit(20)
    for q in range(8):
        c.rx(q, 0.1)           # low targets: one blocked sweep
    c.rx(19, 0.2)              # a high target: a sweep of its own
    flat = flatten_ops(c.ops, 20, False)
    s = host.plan_summary(flat, 20)
    assert "9 gates" in s and "2 state sweep(s)" in s
    jc = JCircuit(20)
    for q in range(8):
        jc.rx(q, 0.1)
    jc.rx(19, 0.2)
    from quest_tpu.circuit import flatten_ops as jflatten
    assert s == JH.plan_summary(jflatten(jc.ops, 20, False), 20)


def test_missing_library_raises_typed(monkeypatch):
    """No library: the engine raises HostEngineUnsupported naming the
    reason, never another engine."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("QUEST_NATIVE_LIB", "/nonexistent/libq.so")
    assert not native.available()
    assert "QUEST_NATIVE_LIB" in native.unavailable_reason()
    with pytest.raises(host.HostEngineUnsupported, match="QUEST_NATIVE_LIB"):
        Circuit(3).h(0).compiled_host(3, False)
    monkeypatch.setattr(native, "_tried", False)


def test_library_builds_outside_native_dir():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.BUILD_DIR.name == "quest_tpu_torch"
    assert native.REPO / "native" not in path.parents


# --- MT19937 and the runner (tests/test_native.py) -------------------------


def test_mt19937_matches_reference_stream():
    native.init_by_array([0x123, 0x234, 0x345, 0x456])
    got = [native.genrand_real1() for _ in REF_DRAWS]
    assert got == REF_DRAWS
    JN.init_by_array([0x123, 0x234, 0x345, 0x456])
    assert [JN.genrand_real1() for _ in REF_DRAWS] == got
    R.seed_quest([0x123, 0x234, 0x345, 0x456])
    assert [R.uniform() for _ in REF_DRAWS] == got
    # random_ draws from this library's generator when it loads, so the
    # two streams are compared one after the other, not interleaved
    native.init_by_array([7, 8])
    want = [native.genrand_int32() for _ in range(64)]
    R.seed_quest([7, 8])
    assert [R.uint32() for _ in range(64)] == want


def test_host_kernels_native_runner_exercise(monkeypatch):
    """Every op kind, odd block sizes, controls and both dtypes through
    the runner, self-checked by the norm and an inverse round trip, and
    equal to the reference's runner on the same program."""
    rng = np.random.default_rng(0)

    def rand_u(k):
        m = rng.normal(size=(1 << k, 1 << k)) \
            + 1j * rng.normal(size=(1 << k, 1 << k))
        return np.linalg.qr(m)[0]

    n = 9
    c = Circuit(n)
    c.ops.append(GateOp("matrix", (0,), (), (), rand_u(1)))
    c.ops.append(GateOp("matrix", (8,), (3, 5), (1, 0), rand_u(1)))
    c.ops.append(GateOp("matrix", (4, 7), (), (), rand_u(2)))
    c.ops.append(GateOp("matrix", (2, 6, 1), (0,), (1,), rand_u(3)))
    c.ops.append(GateOp("matrix", (5, 0, 8, 3), (), (), rand_u(4)))
    c.ops.append(GateOp("diagonal", (1, 7), (4,), (1,),
                        np.exp(1j * rng.normal(size=4))))
    c.ops.append(GateOp("allones", (2, 5, 8), (), (), np.exp(0.7j)))
    c.ops.append(GateOp("parity", (0, 4, 8), (), (), 1.1))
    for block in ("1", "2", "5", "9", None):
        if block is None:
            monkeypatch.delenv("QUEST_HOST_BLOCK", raising=False)
        else:
            monkeypatch.setenv("QUEST_HOST_BLOCK", block)
        for dtype in (np.float64, np.float32):
            v = np.zeros((2, 1 << n), dtype=dtype)
            v[0, 0] = 1.0
            ref = JH.compile_circuit_host(c.ops, n, False, iters=2)(v.copy())
            v = host.compile_circuit_host(c.ops, n, False, iters=2)(v)
            np.testing.assert_allclose(v, ref, atol=TOL[dtype], rtol=0)
            norm = float((v.astype(np.float64) ** 2).sum())
            assert abs(norm - 1.0) < 1e-4, (block, dtype, norm)
            v = host.compile_circuit_host(c.inverse().ops, n, False,
                                          iters=2)(v)
            assert abs(float(v[0, 0]) - 1.0) < 1e-3, (block, dtype)
    dc = Circuit(n)
    dc.ops.append(GateOp("matrix", (2,), (), (),
                         np.array([[1, 1], [1, -1]]) / np.sqrt(2)))
    dc.measure(2)
    dc.x_if(0, (0, 1))
    dc.measure(0)
    step = host.compile_circuit_host_measured(dc.ops, n, False)
    for u0 in (0.01, 0.99):
        v = np.zeros((2, 1 << n))
        v[0, 0] = 1.0
        v, outs = step(v, draws=[u0, 0.5])
        assert outs[0] == (0 if u0 < 0.5 else 1)
        assert outs[1] == outs[0]
        assert abs(float((v ** 2).sum()) - 1.0) < 1e-6


def test_fuzz_host_engine_matches_banded_and_reference():
    """The host engine runs Circuit.ops unscheduled, so it doubles as an
    independent check of the scheduled banded engine (ref
    tests/test_scheduler.py::test_fuzz_scheduled_host_engine_matches)."""
    n = 9
    rng = np.random.default_rng(7)
    jc, _ = _random_circuit(rng, n, depth=40)
    tc = convert.circuit_from_ops(jc.ops, n)
    q = S.create_qureg(n, device="cpu")
    got = S.to_dense(tc.apply_host(q))
    want = S.to_dense(tc.apply_banded(S.create_qureg(n, device="cpu")))
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    v = np.zeros((2, 1 << n), dtype=np.float32)
    v[0, 0] = 1.0
    ref = JH.compile_circuit_host(jc.ops, n, False)(v)
    np.testing.assert_allclose(got, ref[0] + 1j * ref[1], atol=2e-5, rtol=0)


# --- dynamic circuits in C --------------------------------------------------


def _basis(n, dtype=np.float64):
    v = np.zeros((2, 1 << n), dtype=dtype)
    v[0, 0] = 1.0
    return v


def test_host_measured_matches_eager_trajectories():
    """Host and eager runs seeded alike take the same outcomes and end in
    the same state: both draw from random_'s MT19937 stream."""
    c = Circuit(3).h(0).cnot(0, 1).ry(2, 0.7)
    c.measure(1)
    c.x_if(2, (0, 1))
    c.measure(2)
    step = c.compiled_host_measured(3, False)
    for s in range(6):
        R.seed_quest([s, s + 1])
        arr, outs = step(_basis(3))
        R.seed_quest([s, s + 1])
        q = S.create_qureg(3, dtype=np.complex128, device="cpu")
        q = G.rotate_y(G.controlled_not(G.hadamard(q, 0), 0, 1), 2, 0.7)
        q, o1 = MS.measure(q, 1)
        if o1 == 1:
            q = G.pauli_x(q, 2)
        q, o2 = MS.measure(q, 2)
        assert list(outs) == [o1, o2]
        np.testing.assert_allclose(arr[0] + 1j * arr[1], S.to_dense(q),
                                   atol=1e-12, rtol=0)


def test_host_measured_explicit_draws_force_branches():
    c = Circuit(1).h(0)
    c.measure(0)
    step = c.compiled_host_measured(1, False)
    arr, outs = step(_basis(1), draws=[0.1])
    assert list(outs) == [0] and abs(arr[0, 0] - 1.0) < 1e-12
    arr, outs = step(_basis(1), draws=[0.9])
    assert list(outs) == [1] and abs(arr[0, 1] - 1.0) < 1e-12


def test_host_measured_repeat_is_consistent():
    c = Circuit(1).h(0)
    c.measure(0)
    c.measure(0)
    step = c.compiled_host_measured(1, False)
    for s in range(10):
        R.seed_quest([40 + s])
        _, outs = step(_basis(1))
        assert outs[0] == outs[1]


def test_host_measured_guards():
    with pytest.raises(TV.QuESTError, match="at least one"):
        Circuit(1).h(0).compiled_host_measured(1, False)


def test_host_measured_density_matches_eager_and_reference():
    nd = 2
    jc = JCircuit(nd).h(0).cnot(0, 1).dephasing(0, 0.25)
    jc.measure(0)
    jc.x_if(1, (0, 1))
    jc.measure(1)
    c = convert.circuit_from_ops(jc.ops, nd)
    step = c.compiled_host_measured(2 * nd, True)
    ref_step = JH.compile_circuit_host_measured(jc.ops, 2 * nd, True)
    for s in range(8):
        R.seed_quest([9 + s])
        arr, outs = step(_basis(2 * nd))
        draws = [0.05 + 0.1 * s, 0.95 - 0.1 * s]
        a2, o2 = step(_basis(2 * nd), draws=list(draws))
        r2, ro2 = ref_step(_basis(2 * nd), draws=list(draws))
        assert list(o2) == list(ro2)
        np.testing.assert_allclose(a2, r2, atol=1e-12, rtol=0)
        R.seed_quest([9 + s])
        q = S.create_density_qureg(nd, dtype=np.complex128, device="cpu")
        q = G.controlled_not(G.hadamard(q, 0), 0, 1)
        q = CH.mix_dephasing(q, 0, 0.25)
        q, o0 = MS.measure(q, 0)
        if o0 == 1:
            q = G.pauli_x(q, 1)
        q, o1 = MS.measure(q, 1)
        assert list(outs) == [o0, o1], (s, list(outs), [o0, o1])
        got = (arr[0] + 1j * arr[1]).reshape(1 << nd, 1 << nd, order="F")
        np.testing.assert_allclose(got, S.to_dense(q), atol=1e-12, rtol=0)


def test_host_measured_forced_outcome_keeps_stream_in_sync():
    """A forced measurement consumes no uniform, as in the eager API."""
    c = Circuit(2)
    c.measure(0)
    c.h(1)
    c.measure(1)
    step = c.compiled_host_measured(2, False)
    for s in range(12):
        R.seed_quest([77 + s])
        _, outs = step(_basis(2))
        R.seed_quest([77 + s])
        q = S.create_qureg(2, dtype=np.complex128, device="cpu")
        q, o0 = MS.measure(q, 0)
        q, o1 = MS.measure(G.hadamard(q, 1), 1)
        assert list(outs) == [o0, o1], (s, list(outs), [o0, o1])
    with pytest.raises(ValueError, match="draws exhausted"):
        step(_basis(2), draws=[])


@pytest.mark.parametrize("seed", range(3))
def test_host_measured_fuzz_vs_reference(seed):
    """Random dynamic circuits: the port's and the reference's host
    engines on the same draws take the same outcomes and end in the same
    state, and the port's equals its eager replay seeded alike."""
    n = 5
    rng = np.random.default_rng(9000 + seed)
    jc = JCircuit(n)
    for block in range(3):
        blk, _ = _random_circuit(rng, n, depth=4)
        jc.ops.extend(blk.ops)
        jc.measure(int(rng.integers(0, n)))
        jc.x_if(int(rng.integers(0, n)), (block, int(rng.integers(0, 2))))
    c = convert.circuit_from_ops(jc.ops, n)
    step = c.compiled_host_measured(n, False)
    ref = JH.compile_circuit_host_measured(jc.ops, n, False)
    for s in range(3):
        draws = list(np.random.default_rng(seed * 10 + s).uniform(size=3))
        arr, outs = step(_basis(n), draws=list(draws))
        rarr, routs = ref(_basis(n), draws=list(draws))
        assert list(outs) == list(routs)
        np.testing.assert_allclose(arr, rarr, atol=1e-11, rtol=0)
        R.seed_quest([7000 + 13 * seed + s])
        arr, outs = step(_basis(n))
        R.seed_quest([7000 + 13 * seed + s])
        q = S.create_qureg(n, dtype=np.complex128, device="cpu")
        eager_outs = []
        for op in c.ops:
            if op.kind == "measure":
                q, o = MS.measure(q, op.targets[0])
                eager_outs.append(o)
            elif op.kind == "classical":
                inners, conds = op.operand
                if all(eager_outs[i] == w for i, w in conds):
                    one = Circuit(n)
                    one.ops.extend(inners)
                    one.apply(q)
            else:
                one = Circuit(n)
                one.ops.append(op)
                one.apply(q)
        assert list(outs) == eager_outs
        np.testing.assert_allclose(arr[0] + 1j * arr[1], S.to_dense(q),
                                   atol=1e-11, rtol=0)


# --- the host trajectory engine ----------------------------------------------


def _noisy(n, wide=True):
    """Every channel kind on n qubits: depolarising, damping (state-
    dependent), dephasing, a run of two mixtures and, with `wide`, a
    two-qubit Kraus map."""
    c = JCircuit(n).h(0).cnot(0, 1)
    c.depolarising(0, 0.1).damping(1, 0.2)
    c.ry(2, 0.3).dephasing(2, 0.15).dephasing(3, 0.05)
    if wide:
        c.kraus((1, 3), [np.sqrt(0.9) * np.eye(4),
                         np.sqrt(0.1) * np.kron(np.diag([1, -1]),
                                                np.diag([1, -1]))])
    return c.h(3).cz(2, 3).rx(n - 1, 0.4)


@pytest.mark.parametrize("n", [4, 11])
def test_host_trajectories_equal_banded_draws(n):
    tc = convert.circuit_from_ops(_noisy(n).ops, n)
    ph, dh = T.run_batched(tc, 16, generator=torch.Generator().manual_seed(n),
                           engine="host")
    pb, db = T.run_batched(tc, 16, generator=torch.Generator().manual_seed(n),
                           engine="banded", device="cpu")
    assert torch.equal(dh, db)
    assert ph.device.type == "cpu" and ph.dtype == torch.float32
    assert (ph - pb).abs().max().item() <= 2e-5 * pb.abs().max().item()
    prog = T._compiled_traj(tc, n, None, "host")
    assert prog.num_channels == 5 and prog.launches_per_call == 0
    # depolarising | damping | the two dephasings as one run | the map
    assert [k for k, _ in prog.program].count("chans") == 4


@pytest.mark.parametrize("engine,wide", [("host", False),
                                          ("banded", True)])
def test_host_trajectories_match_reference_given_the_draws(engine, wide):
    """Given the reference's draws, the port's host engine gives its
    planes: against the reference's host engine on one-qubit channels,
    and against its banded engine with a two-qubit map too (on that
    circuit the reference's host engine disagrees with its own banded
    engine by 0.5 on the same draws; ROADMAP C)."""
    n = 6
    jc = _noisy(n, wide)
    tc = convert.circuit_from_ops(jc.ops, n)
    jplanes, jdraws = JT.run_batched(jc, jax.random.key(3), 8, engine=engine)
    jplanes, jdraws = np.asarray(jplanes), np.asarray(jdraws)
    prog = T._compiled_traj(tc, n, None, "host")
    planes, draws = prog(torch.from_numpy(_uniforms_for(jdraws,
                                                        prog.channel_info)))
    np.testing.assert_array_equal(draws.numpy(), jdraws)
    np.testing.assert_allclose(planes.numpy(), jplanes, atol=2e-5, rtol=0)
