"""The port's density-matrix path end to end against the JAX package.

On the CPU (every segment through the plain PyTorch version, every
matrix passthrough through apply_matrix_rows), the port's
compiled_fused(2N, density=True) must agree with the reference's
compiled_fused(2N, True, interpret=True) and its per-gate engine
compiled(2N, True) at N = 8 for the slice's three density circuits,
within 2e-5 x max|amp| (the f32 `tol` of tests/conftest.py). Also: trace
and purity, apply_matrix_rows, dual_of, density registers, the channel
validators' codes and messages, and the conversion of density circuits.
"""

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
from quest_tpu import validation as JV
from quest_tpu.ops import apply as JA
from quest_tpu.ops import fusion as JF
from quest_tpu.ops import matrices as JM

from quest_tpu_torch import calculations as TK
from quest_tpu_torch import circuit as TC
from quest_tpu_torch import convert
from quest_tpu_torch import entry as TE
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import apply as TA
from quest_tpu_torch.ops import fusion as TF

from tests.test_torch_density_plan import CIRCUITS

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5
ND = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs:
    the suite runs several workers side by side (see
    tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL * float(np.abs(want).max()),
                               rtol=0)


def pure_density_planes(nd, seed):
    """(2, 4^N) f32 planes of |psi><psi| for a seeded random psi, in the
    column-major flat order (rho[r, c] at r + c 2^N)."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << nd) + 1j * rng.standard_normal(1 << nd)
    psi /= np.linalg.norm(psi)
    rho = np.outer(psi, psi.conj()).reshape(-1, order="F")
    return np.stack([rho.real, rho.imag]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_density_path_matches_reference_engines(name):
    build_ref, build_port = CIRCUITS[name]
    n = 2 * ND
    planes = pure_density_planes(ND, seed=5)
    jc = build_ref(ND)
    want_fused = np.asarray(jc.compiled_fused(
        n, True, donate=False, interpret=True)(jnp.asarray(planes))
    ).reshape(2, -1)
    want_gates = np.asarray(jc.compiled(n, True, donate=False)(
        jnp.asarray(planes)))
    prog = build_port(ND).compiled_fused(n, density=True, device="cpu")
    amps = torch.from_numpy(planes.copy())
    got = prog(amps)
    assert got is amps                       # in place
    _assert_close(got.numpy(), want_fused)
    _assert_close(got.numpy(), want_gates)
    _assert_close(prog.plain(torch.from_numpy(planes)).numpy(), want_fused)
    q = TS.Qureg(got, ND, is_density=True)
    assert abs(TK.calc_total_prob(q) - 1.0) < 1e-5
    rho = TS.to_dense(q)
    assert np.abs(rho - rho.conj().T).max() <= TOL * np.abs(rho).max()
    assert TK.calc_purity(q) <= 1.0 + 1e-5


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_trace_and_purity_match_reference(name):
    build_ref, _ = CIRCUITS[name]
    n = 2 * ND
    planes = np.asarray(build_ref(ND).compiled(n, True, donate=False)(
        jnp.asarray(pure_density_planes(ND, seed=9))))
    jq = JS.Qureg(amps=jnp.asarray(planes), num_qubits=ND, is_density=True)
    tq = convert.density_qureg_from_numpy(planes, device="cpu")
    assert tq.num_qubits == ND and tq.is_density
    assert abs(TK.calc_total_prob(tq) - JK.calc_total_prob(jq)) < 1e-6
    assert abs(TK.calc_purity(tq) - JK.calc_purity(jq)) < 1e-6
    sv = planes[:, :1 << 10] / np.sqrt((planes[:, :1 << 10] ** 2).sum())
    jsv = JS.Qureg(amps=jnp.asarray(sv), num_qubits=10, is_density=False)
    tsv = TS.Qureg(torch.from_numpy(sv.astype(np.float32)), 10)
    assert abs(TK.calc_total_prob(tsv) - JK.calc_total_prob(jsv)) < 1e-6
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_purity(tsv)
    assert str(e.value) == JV.MESSAGES[JV.ErrorCode.E_DEFINED_ONLY_FOR_DENSMATRS]


def test_apply_fused_on_registers():
    """Circuit.apply_fused on a density Qureg (and on a statevector)
    against the reference's apply_fused(interpret=True)."""
    jc = CIRCUITS["clifford_t"][0](ND)
    tc = convert.circuit_from_ops(jc.ops, ND)
    want = JS.to_dense(jc.apply_fused(JS.create_density_qureg(
        ND, dtype=np.complex64), interpret=True))
    q = tc.apply_fused(TS.create_density_qureg(ND, device="cpu"))
    assert q.is_density and q.num_state_qubits == 2 * ND
    _assert_close(TS.to_dense(q), want)
    jsv = JC.random_circuit(12, 2, seed=4)
    want = JS.to_dense(jsv.apply_fused(JS.create_qureg(12, dtype=np.complex64),
                                       interpret=True))
    got = TC.random_circuit(12, 2, seed=4).apply_fused(
        TS.create_qureg(12, device="cpu"))
    _assert_close(TS.to_dense(got), want)


def _matrix(k, seed):
    rng = np.random.default_rng(seed)
    d = 1 << k
    return (rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))) / d


@pytest.mark.parametrize("targets,controls,cstates", [
    ((2,), (), ()),
    ((0, 5), (9,), (1,)),
    ((3, 12), (1, 13), (0, 1)),
    ((8,), (2,), (1,)),
    ((10, 7), (4, 11), (1, 0)),
    ((0, 6, 7, 13), (), ()),
    ((1, 9, 11, 12), (3,), (0,)),
], ids=["lane", "lane2_rowctl", "mixed_ctl", "row_lanectl", "row2_ctl",
        "superop4", "mixed4_ctl"])
def test_apply_matrix_rows_matches_reference(targets, controls, cstates,
                                             monkeypatch):
    n = 14
    m = _matrix(len(targets), seed=len(targets) + sum(targets))
    planes = np.random.default_rng(3).standard_normal(
        (2, 1 << (n - 7), 128)).astype(np.float32)
    want = np.asarray(JA.apply_matrix_rows(
        jnp.asarray(planes), n, (m.real, m.imag), targets, controls, cstates))
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << 9)     # several chunks
    amps = torch.from_numpy(planes.copy())
    out = TA.apply_matrix_rows(amps, n, m, targets, controls, cstates)
    assert out is amps
    _assert_close(out.numpy(), want)


def test_apply_matrix_rows_refuses_wide_operators():
    """A 5-target operator is applied on the fused view, as the
    reference's apply_matrix_rows applies it through its flat path."""
    n, targets = 12, (0, 3, 7, 9, 11)
    m = _matrix(len(targets), seed=5)
    planes = np.random.default_rng(6).standard_normal(
        (2, 1 << (n - 7), 128)).astype(np.float32)
    want = np.asarray(JA.apply_matrix_rows(
        jnp.asarray(planes), n, (m.real, m.imag), targets))
    amps = torch.from_numpy(planes.copy())
    _assert_close(TA.apply_matrix_rows(amps, n, m, targets).numpy(), want)


def _dual_key(op):
    return (op.kind, tuple(op.targets), tuple(op.controls),
            np.asarray(op.operand).tolist(),
            tuple(getattr(op, "parts", ())))


def test_dual_of_matches_reference_per_kind():
    u = _matrix(1, 1)
    ops = [("matrix", (3,), (1,), (0,), u),
           ("diagonal", (2, 5), (), (), np.exp(1j * np.arange(4.0))),
           ("parity", (0, 4), (), (), 0.37),
           ("allones", (1, 6), (), (), np.exp(0.2j)),
           ("superop", (2,), (), (), JM.kraus_superoperator(
               JM.damping_kraus(0.2)))]
    for kind, t, c, s, operand in ops:
        want = JC.dual_of(JC.GateOp(kind, t, c, s, operand), 7)
        got = TC.dual_of(TC.GateOp(kind, t, c, s, operand), 7)
        if want is None:
            assert got is None
            continue
        assert _dual_key(got) == _dual_key(want)
    parts = (("allones", (0, 1), 0.4), ("parity", (1,), -0.3))
    want = JC.dual_of(JF.ComposedDiag("diagonal", (1, 9), (), (),
                                      np.exp(1j * np.arange(4.0)), parts), 7)
    got = TC.dual_of(TF.ComposedDiag("diagonal", (1, 9), (), (),
                                     np.exp(1j * np.arange(4.0)), parts), 7)
    assert _dual_key(got) == _dual_key(want)


def _message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value), getattr(e.value, "code", None)


@pytest.mark.parametrize("build", [
    lambda c: c.kraus(1, [np.eye(2), np.eye(2)]),                 # not CPTP
    lambda c: c.kraus(0, [np.eye(2) / 2] * 5),                    # too many
    lambda c: c.kraus((0, 1), [np.eye(4) / 4] * 17),
    lambda c: c.kraus((0, 1, 2), []),
    lambda c: c.kraus(2, [np.eye(4)]),                            # size
    lambda c: c.damping(0, 1.5),
    lambda c: c.depolarising(1, 0.8),
    lambda c: c.dephasing(2, 0.6),
    lambda c: c.dephasing(2, -0.1),
], ids=["not_cptp", "one_qubit_count", "two_qubit_count", "n_qubit_count",
        "kraus_size", "damping", "depolarising", "dephasing", "negative"])
def test_bad_channels_raise_reference_messages(build):
    name, msg, _ = _message(lambda: build(JC.Circuit(4)))
    tname, tmsg, code = _message(lambda: build(TC.Circuit(4)))
    # the reference's error hook prefixes "QuEST Error in function ...: "
    assert name == tname == "QuESTError" and msg.endswith(": " + tmsg)
    assert TV.MESSAGES[code] == tmsg
    assert JV.ErrorCode[code.name].value == code.value


def test_noise_needs_a_density_register():
    c = TC.Circuit(10).h(0).damping(3, 0.1)
    with pytest.raises(TV.QuESTError, match="density-matrix register"):
        c.compiled_fused(10, device="cpu")


def test_convert_round_trips_density_circuit():
    jc = CIRCUITS["bench_density"][0](ND)
    tc = convert.circuit_from_ops(jc.ops, ND)
    assert [(o.kind, o.targets, o.meta is None) for o in tc.ops] == [
        (o.kind, o.targets, o.meta is None) for o in jc.ops]
    for a, b in zip(jc.ops, tc.ops):
        assert np.array_equal(np.asarray(a.operand), np.asarray(b.operand))
        if a.meta is not None:
            assert a.meta[0] == b.meta[0] == "kraus"
            assert all(np.array_equal(x, y)
                       for x, y in zip(a.meta[1], b.meta[1]))
    planes = pure_density_planes(ND, seed=2)
    want = np.asarray(jc.compiled(2 * ND, True, donate=False)(
        jnp.asarray(planes)))
    got = tc.compiled_fused(2 * ND, density=True, device="cpu")(
        torch.from_numpy(planes.copy()))
    _assert_close(got.numpy(), want)
    with pytest.raises(ValueError, match="4\\^N"):
        convert.density_qureg_from_numpy(np.zeros((2, 1 << 11), np.float32),
                                         device="cpu")


def test_density_registers_match_reference():
    n = 5
    jq = JS.create_density_qureg(n, dtype=np.complex64)
    tq = TS.create_density_qureg(n, device="cpu")
    assert tq.is_density and tq.num_state_qubits == 10 and tq.num_amps == 1024
    np.testing.assert_array_equal(TS.to_dense(tq), JS.to_dense(jq))
    for init in ("init_zero_state", "init_plus_state", "init_debug_state"):
        np.testing.assert_allclose(
            TS.to_dense(getattr(TS, init)(tq)),
            JS.to_dense(getattr(JS, init)(jq)), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        TS.to_dense(TS.init_classical_state(tq, 11)),
        JS.to_dense(JS.init_classical_state(jq, 11)))
    sv = TS.init_plus_state(TS.create_qureg(n, device="cpu"))
    np.testing.assert_allclose(TS.to_dense(sv), JS.to_dense(JS.init_plus_state(
        JS.create_qureg(n, dtype=np.complex64))), rtol=0, atol=1e-7)
    dq = TS.init_debug_state(tq)
    jd = JS.init_debug_state(jq)
    assert TS.get_density_amp(dq, 3, 17) == pytest.approx(
        JS.get_density_amp(jd, 3, 17))
    for bad in (lambda: TS.get_density_amp(dq, 32, 0),
                lambda: TS.init_classical_state(tq, 32)):
        name, msg, code = _message(bad)
        assert name == "QuESTError" and TV.MESSAGES[code] == msg
    with pytest.raises(TV.QuESTError):
        TS.get_density_amp(sv, 0, 0)
    q64 = TS.create_density_qureg(5, dtype=np.complex128, device="cpu")
    assert q64.amps.dtype == torch.float64 and q64.dtype == np.complex128
    np.testing.assert_array_equal(TS.to_dense(q64), JS.to_dense(
        JS.create_density_qureg(5, dtype=np.complex128)))


def test_density_entry_on_the_cpu():
    """density_entry at a small width: one step through the port's
    engine, a valid density matrix that the plain path reproduces."""
    fn, (amps,) = TE.density_entry(device="cpu", num_qubits=6, depth=2)
    assert amps.shape == (2, 1 << 5, 128)
    want = fn.plain(amps.clone())
    fn(amps)
    _assert_close(amps.numpy(), want.numpy())
    q = TS.Qureg(amps, 6, is_density=True)
    assert abs(TK.calc_total_prob(q) - 1.0) < 1e-5
    assert TK.calc_purity(q) <= 1.0 + 1e-5
