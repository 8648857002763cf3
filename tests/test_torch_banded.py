"""The port's per-gate, banded and fallback engines against the JAX package.

quest_tpu_torch's `Circuit.compiled` (per-gate), `compiled_banded`, and
`compiled_fused` below the kernel's 10 qubits and on f64 planes, run on
the CPU beside quest_tpu's `compiled` / `compiled_banded` /
`compiled_fused(interpret=True)` and the dense numpy oracle
(tests/oracle.py), within 2e-5 x max|amp| at f32 and 1e-12 x max|amp|
at f64: the cases of tests/test_large_gates.py (five- and six-target
unitaries, controlled, the density dual, a three-qubit Kraus map) and
tests/test_fusion.py (banded against the oracle at 5 and 9 qubits, QFT,
RCS, density channels); the banded and per-gate engines bit for bit on
permutation and phase gates at HIGHEST; the fused path with wide
passthroughs (entry.wide_gates_circuit); and compiled_batched's banded
program and its f64 form against the reference's vmapped banded one."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax.numpy as jnp

from quest_tpu import calculations as JK
from quest_tpu import circuit as JC
from quest_tpu import state as JS
from quest_tpu.ops import matrices as JM

from quest_tpu_torch import calculations as TK
from quest_tpu_torch import circuit as TC
from quest_tpu_torch import entry as E
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit, qft_circuit, random_circuit

from . import oracle

pytestmark = pytest.mark.dtype_agnostic

DTYPES = [np.float32, np.float64]
TOL = {np.float32: 2e-5, np.float64: 1e-12}
PORT_ENGINES = ("compiled", "compiled_banded", "compiled_fused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _reference(tc: Circuit) -> JC.Circuit:
    """The same op list as a quest_tpu Circuit."""
    jc = JC.Circuit(tc.num_qubits)
    for op in tc.ops:
        jc.ops.append(JC.GateOp(op.kind, op.targets, op.controls, op.cstates,
                                op.operand, op.meta))
    return jc


def _vector_planes(v, rdt):
    return np.stack([v.real, v.imag]).astype(rdt)


def _density_planes(rho, rdt):
    return _vector_planes(rho.reshape(-1, order="F"), rdt)


def _dense(planes):
    return planes[0] + 1j * planes[1]


def _port(tc, engine, n, planes, density=False):
    fn = getattr(tc, engine)(n, density, device="cpu")
    amps = torch.from_numpy(planes.copy())
    out = fn(amps)
    assert out is amps and out.dtype == amps.dtype
    return out.numpy()


def _ref(jc, engine, n, planes, density=False, **kw):
    fn = getattr(jc, engine)(n, density, donate=False, **kw)
    return np.asarray(fn(jnp.asarray(planes)))


def _assert_close(got, want, rdt):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL[rdt] * scale, rtol=0)


def _check_engines(tc, n, planes, oracle_planes=None, density=False):
    """Every port engine against the reference's per-gate and banded
    engines (and the oracle, when given) on the same planes."""
    rdt = planes.dtype.type
    jc = _reference(tc)
    want = _ref(jc, "compiled", n, planes, density)
    _assert_close(_ref(jc, "compiled_banded", n, planes, density), want, rdt)
    if oracle_planes is not None:
        _assert_close(want, oracle_planes, rdt)
    for engine in PORT_ENGINES:
        _assert_close(_port(tc, engine, n, planes, density), want, rdt)


# ---------------------------------------------------------------------------
# tests/test_large_gates.py:18-73, replayed through the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("targets", [(0, 1, 2, 3, 4), (0, 2, 3, 5, 6),
                                     (6, 4, 3, 2, 0)])
def test_five_target_unitary(targets, rdt, rng):
    n = 7
    u = oracle.random_unitary(5, rng)
    v = oracle.random_statevector(n, rng)
    want = oracle.apply_to_vector(v, n, u, list(targets))
    _check_engines(Circuit(n).gate(u, targets), n, _vector_planes(v, rdt),
                   _vector_planes(want, np.float64))


@pytest.mark.parametrize("rdt", DTYPES)
def test_controlled_five_target_unitary(rdt, rng):
    n = 8
    u = oracle.random_unitary(5, rng)
    targets, controls = [0, 2, 4, 6, 7], [1, 5]
    v = oracle.random_statevector(n, rng)
    want = oracle.apply_to_vector(v, n, u, targets, controls)
    _check_engines(Circuit(n).gate(u, targets, controls), n,
                   _vector_planes(v, rdt), _vector_planes(want, np.float64))


@pytest.mark.parametrize("rdt", DTYPES)
def test_six_target_unitary(rdt, rng):
    n = 6
    u = oracle.random_unitary(6, rng)
    v = oracle.random_statevector(n, rng)
    _check_engines(Circuit(n).gate(u, range(6)), n, _vector_planes(v, rdt),
                   _vector_planes(u @ v, np.float64))


@pytest.mark.parametrize("rdt", DTYPES)
def test_three_qubit_kraus_map(rdt, rng):
    """3 Kraus targets: a 6-target superoperator on the doubled register."""
    nd = 4
    rho = oracle.random_density(nd, rng)
    ops = oracle.random_kraus_map(3, 4, rng)
    want = oracle.apply_kraus_to_density(rho, nd, ops, [0, 1, 3])
    _check_engines(Circuit(nd).kraus((0, 1, 3), ops), 2 * nd,
                   _density_planes(rho, rdt),
                   _density_planes(want, np.float64), density=True)


@pytest.mark.parametrize("rdt", DTYPES)
def test_five_target_density_dual(rdt, rng):
    nd = 5
    rho = oracle.random_density(nd, rng)
    u = oracle.random_unitary(5, rng)
    _check_engines(Circuit(nd).gate(u, range(5)), 2 * nd,
                   _density_planes(rho, rdt),
                   _density_planes(u @ rho @ u.conj().T, np.float64),
                   density=True)


# ---------------------------------------------------------------------------
# tests/test_fusion.py:155-225, replayed through the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n", [5, 9])
def test_banded_matches_oracle_random_circuit(n, rdt):
    rng = np.random.default_rng(20260729 + n)
    c = Circuit(n)
    vec = np.zeros(1 << n, dtype=np.complex128)
    vec[0] = 1.0
    for _ in range(40):
        kind = int(rng.integers(0, 7))
        q = int(rng.integers(0, n))
        q2 = int(rng.integers(0, n))
        a = float(rng.uniform(0, 2 * np.pi))
        if kind == 0:
            c.rx(q, a)
            m = np.asarray(JM.rotation(a, (1., 0., 0.)))
            vec = oracle.apply_to_vector(vec, n, m, [q])
        elif kind == 1:
            c.ry(q, a)
            m = np.asarray(JM.rotation(a, (0., 1., 0.)))
            vec = oracle.apply_to_vector(vec, n, m, [q])
        elif kind == 2:
            c.rz(q, a)
            vec = oracle.apply_to_vector(
                vec, n, np.diag([np.exp(-.5j * a), np.exp(.5j * a)]), [q])
        elif kind == 3:
            c.h(q)
            vec = oracle.apply_to_vector(vec, n, np.asarray(JM.HADAMARD), [q])
        elif kind == 4:
            c.s(q)
            vec = oracle.apply_to_vector(vec, n, np.diag([1, 1j]), [q])
        elif kind == 5 and q2 != q:
            c.cnot(q, q2)
            vec = oracle.apply_to_vector(vec, n, np.asarray(JM.PAULI_X),
                                         [q2], controls=[q])
        elif kind == 6 and q2 != q:
            c.cz(q, q2)
            vec = oracle.apply_to_vector(vec, n, np.diag([1, 1, 1, -1]),
                                         sorted([q, q2]))
    zero = np.zeros(1 << n, dtype=np.complex128)
    zero[0] = 1.0
    _check_engines(c, n, _vector_planes(zero, rdt),
                   _vector_planes(vec, np.float64))


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("name", ["qft9", "rcs10"])
def test_banded_matches_pergate_on_qft_and_rcs(name, rdt):
    c = qft_circuit(9) if name == "qft9" else random_circuit(10, 6, seed=3)
    n = c.num_qubits
    planes = TS.basis_planes(0, n=n, rdt=rdt, device="cpu").numpy()
    _check_engines(c, n, planes)


@pytest.mark.parametrize("rdt", DTYPES)
def test_banded_density_channels(rdt):
    nd = 3
    c = Circuit(nd).h(0).cnot(0, 2).damping(1, 0.2).depolarising(2, 0.1)
    dt = np.complex64 if rdt == np.float32 else np.complex128
    q = TS.init_debug_state(TS.create_density_qureg(nd, dtype=dt,
                                                    device="cpu"))
    planes = q.amps.numpy().copy()
    jq = JS.init_debug_state(JS.create_density_qureg(nd, dtype=dt))
    np.testing.assert_array_equal(np.asarray(jq.amps), planes)
    want = np.asarray(_reference(c).apply(jq).amps)
    got_pergate = c.apply(q).amps.numpy()
    q2 = TS.init_debug_state(TS.create_density_qureg(nd, dtype=dt,
                                                     device="cpu"))
    got_banded = c.apply_banded(q2).amps.numpy()
    _assert_close(got_pergate, want, rdt)
    _assert_close(got_banded, want, rdt)
    _check_engines(c, 2 * nd, planes, density=True)


def test_f64_registers_initialise_and_reduce_like_the_reference():
    """complex128 registers: the initialisers, to_dense, the total
    probability and the purity against the reference's, at 1e-12."""
    c128 = np.complex128
    for nq in (1, 4):
        for init, args in ((TS.init_plus_state, ()),
                           (TS.init_classical_state, (1,)),
                           (TS.init_debug_state, ())):
            jinit = getattr(JS, init.__name__)
            for density in (False, True):
                make = (TS.create_density_qureg if density
                        else TS.create_qureg)
                jmake = (JS.create_density_qureg if density
                         else JS.create_qureg)
                q = init(make(nq, dtype=c128, device="cpu"), *args)
                jq = jinit(jmake(nq, dtype=c128), *args)
                assert q.amps.dtype == torch.float64
                np.testing.assert_allclose(TS.to_dense(q), JS.to_dense(jq),
                                           atol=1e-12, rtol=0)
    rho = oracle.random_density(4, np.random.default_rng(3))
    planes = _density_planes(rho, np.float64)
    q = TS.Qureg(torch.from_numpy(planes), 4, is_density=True)
    jq = JS.create_density_qureg(4, dtype=c128).replace_amps(
        jnp.asarray(planes))
    assert abs(TK.calc_total_prob(q) - float(JK.calc_total_prob(jq))) <= 1e-12
    assert abs(TK.calc_purity(q) - float(JK.calc_purity(jq))) <= 1e-12


# ---------------------------------------------------------------------------
# bit-identity and the apply route
# ---------------------------------------------------------------------------


def _permutation_circuit(n: int = 5, reps: int = 3) -> Circuit:
    """x / cnot / swap / cz only (tests/test_plan.py's family)."""
    c = Circuit(n)
    for r in range(reps):
        c.x(r % n).cnot(r % n, (r + 1) % n)
        c.swap((r + 2) % n, (r + 3) % n).cz(r % n, (r + 2) % n)
    return c


@pytest.mark.parametrize("n", [5, 11])
def test_banded_and_pergate_bit_identical_on_permutations(n):
    c = _permutation_circuit(n, reps=4)
    c.cz(0, n - 1).x(n - 1, 0, 2).swap(1, n - 2)
    planes = TS.init_debug_state(TS.create_qureg(n, device="cpu")).amps
    a = c.compiled(n, device="cpu")(planes.clone())
    b = c.compiled_banded(n, device="cpu")(planes.clone())
    assert torch.equal(a, b)


def test_apply_routes_long_circuits_to_banded(monkeypatch):
    c = _permutation_circuit()
    monkeypatch.setattr(TC, "PERGATE_COMPILE_WARN_OPS", 8)
    assert len(c.ops) > 8
    calls = []
    orig = Circuit.apply_banded
    monkeypatch.setattr(Circuit, "apply_banded",
                        lambda self, q: calls.append(1) or orig(self, q))

    def run():
        return c.apply(TS.init_debug_state(
            TS.create_qureg(5, device="cpu"))).amps
    monkeypatch.setenv("QUEST_APPLY_AUTOROUTE", "0")
    legacy = run()
    assert not calls
    monkeypatch.setenv("QUEST_APPLY_AUTOROUTE", "1")
    routed = run()
    assert calls
    assert torch.equal(routed, legacy)
    want = np.asarray(_reference(c).apply(JS.init_debug_state(
        JS.create_qureg(5, dtype=np.complex64))).amps)
    np.testing.assert_array_equal(routed.numpy(), want)


def test_traces_apply_in_place_and_programs_keep_their_device():
    c = random_circuit(6, 2, seed=1)
    planes = TS.basis_planes(0, n=6, device="cpu")
    a = c.trace(planes.clone(), 6, False)
    b = c.banded_trace(planes.clone(), 6, False)
    _assert_close(a.numpy(), b.numpy(), np.float32)
    prog = c.compiled_banded(6, device="meta")
    with pytest.raises(ValueError, match="compiled for meta"):
        prog(planes)


# ---------------------------------------------------------------------------
# the fused engine: wide passthroughs, f64, below the kernel tier
# ---------------------------------------------------------------------------


def test_fused_path_with_wide_passthroughs():
    """entry.wide_gates_circuit at 12 qubits: kernel segments (plain
    version) with the 5- and 6-target and the controlled 2-target
    matrices between them, against the reference's interpret-mode
    compiled_fused; banded and per-gate agree."""
    n = 12
    c = E.wide_gates_circuit(n)
    prog = c.compiled_fused(n, device="cpu")
    passes = [s for s in prog.steps if isinstance(s, TC.XlaPass)]
    assert len(passes) >= 3 and prog.segments
    planes = TS.basis_planes(0, n=n, device="cpu").reshape(2, -1, 128)
    want = _ref(_reference(c), "compiled_fused", n, planes.numpy(),
                interpret=True)
    got = prog(planes.clone()).numpy()
    _assert_close(got, want, np.float32)
    for engine in ("compiled", "compiled_banded"):
        out = _port(c, engine, n, planes.reshape(2, -1).numpy())
        _assert_close(out, want.reshape(2, -1), np.float32)


@pytest.mark.parametrize("density", [False, True])
def test_fused_program_routes_f64_to_its_banded_items(density):
    nd = 5 if density else 12
    c = E.noisy_rcs_circuit(nd, 1) if density else random_circuit(nd, 3,
                                                                  seed=5)
    n = 2 * nd if density else nd
    prog = c.compiled_fused(n, density, device="cpu")
    planes = TS.basis_planes(0, n=n, rdt=np.float64, device="cpu")
    jc = _reference(c)
    want = _ref(jc, "compiled_fused", n, planes.numpy(), density,
                interpret=True)
    _assert_close(_ref(jc, "compiled_banded", n, planes.numpy(), density),
                  want, np.float64)
    got = prog(planes.clone())
    assert got.dtype == torch.float64
    _assert_close(got.numpy(), want, np.float64)
    _assert_close(prog.plain(planes).numpy(), want, np.float64)
    f32 = prog(planes.float().reshape(2, -1, 128)).reshape(2, -1)
    _assert_close(f32.numpy(), want.astype(np.float32), np.float32)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 8, 9])
def test_fused_below_the_kernel_tier_is_banded(n, rdt):
    c = random_circuit(n, 3, seed=n)
    prog = c.compiled_fused(n, device="cpu")
    assert isinstance(prog, TC.XlaProgram) and prog.kind == "banded"
    dt = np.complex64 if rdt == np.float32 else np.complex128
    q = TS.create_qureg(n, dtype=dt, device="cpu")
    assert q.amps.shape == (2, 1 << n) and q.real_dtype == rdt
    planes = q.amps.numpy()
    want = _ref(_reference(c), "compiled_fused", n, planes, interpret=True)
    _assert_close(c.apply_fused(q).amps.numpy(), want, rdt)


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
def test_tutorial_through_the_fused_fallback(dt):
    """entry.tutorial_circuit on 3 qubits through compiled_fused (the
    banded fallback): the reference binary's numbers, and the reference
    package's per-gate program."""
    c = E.tutorial_circuit()
    q = c.apply_fused(TS.create_qureg(3, dtype=dt, device="cpu"))
    probs = (q.amps.double() ** 2).sum(0)
    assert abs(probs[7].item() - 0.112422) <= 1e-6
    assert abs(probs[4:].sum().item() - 0.749178) <= 1e-6
    rdt = np.float32 if dt == np.complex64 else np.float64
    want = _ref(_reference(c), "compiled", 3, TS.create_qureg(
        3, dtype=dt, device="cpu").amps.numpy())
    _assert_close(q.amps.numpy(), want, rdt)


# ---------------------------------------------------------------------------
# the batched engine's banded program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n,engine", [(10, "banded"), (8, None), (10, None)])
def test_batched_banded_matches_vmapped_reference(n, engine, rdt):
    b = 3
    c = random_circuit(n, 3, seed=2).cnot(n - 1, 0).rz(n - 2, 0.3)
    rng = np.random.default_rng(n)
    planes = rng.standard_normal((b, 2, 1 << n)).astype(rdt)
    want = np.asarray(_reference(c).compiled_batched(
        b, donate=False, interpret=True, engine="banded")(
        jnp.asarray(planes)))
    fn = c.compiled_batched(b, engine=engine, device="cpu")
    if engine == "banded" or n < 10:
        assert isinstance(fn, TC.XlaProgram)
    amps = torch.from_numpy(planes.copy())
    if isinstance(fn, TC.XlaProgram):
        out = fn(amps)
    else:
        out = fn(amps.reshape(b, 2, -1, 128)).reshape(b, 2, -1)
    _assert_close(out.numpy(), want, rdt)


def test_batched_fused_below_the_kernel_tier_raises():
    c = Circuit(8).h(0)
    with pytest.raises(ValueError, match="kernel tier"):
        c.compiled_batched(2, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="kernel tier"):
        _reference(c).compiled_batched(2, engine="fused")
