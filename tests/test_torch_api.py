"""The port's QuEST API (quest_tpu_torch.api) against the JAX package's.

Every API function called through both packages with the same arguments
on 3-5 qubit statevector and density registers (seeded random states,
complex64 and complex128): the states agree within 2e-5 (f32) and 1e-12
(f64), returned values likewise, and the recorded QASM is byte-equal.
Also: the reference tutorial's numbers (ref examples/tutorial_example.c,
tests/test_api.py); seeded measure / measureWithStats outcomes equal;
every error of tests/test_validation_messages.py raises the same
message; set_input_error_handler and invalidQuESTInputError are called;
a clone is not an alias (mutate one handle, the other holds); the
environment names the CPU it runs on; reportState's file equals the
reference's and reads back."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import api as JQ
from quest_tpu import state as JS
from quest_tpu.validation import QuESTError as JQuESTError

from quest_tpu_torch import api as Q
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.validation import QuESTError

pytestmark = pytest.mark.dtype_agnostic

TOL = {np.complex64: 2e-5, np.complex128: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


ENV = Q.createQuESTEnv(devices="cpu")


def _haar(d, rng):
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def test_tutorial_numbers():
    """The tutorial circuit reproduces the reference binary's output."""
    qubits = Q.createQureg(3, ENV)
    Q.hadamard(qubits, 0)
    Q.controlledNot(qubits, 0, 1)
    Q.rotateY(qubits, 2, 0.1)
    Q.multiControlledPhaseFlip(qubits, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    Q.unitary(qubits, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    Q.compactUnitary(qubits, 1, a, b)
    Q.rotateAroundAxis(qubits, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    Q.controlledCompactUnitary(qubits, 0, 1, a, b)
    Q.multiControlledUnitary(qubits, [0, 1], 2, u)
    toff = Q.createComplexMatrixN(3)
    toff[6, 7] = 1
    toff[7, 6] = 1
    for i in range(6):
        toff[i, i] = 1
    Q.multiQubitUnitary(qubits, [0, 1, 2], toff)
    assert Q.getProbAmp(qubits, 7) == pytest.approx(0.112422, abs=1e-6)
    assert Q.calcProbOfOutcome(qubits, 2, 1) == pytest.approx(0.749178,
                                                               abs=1e-6)
    assert Q.calcTotalProb(qubits) == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# every function, through both packages
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(2024)
U2 = _haar(2, _RNG)
U4 = _haar(4, _RNG)
U8 = _haar(8, _RNG)
A, B = U2[0, 0], U2[1, 0]
K1 = [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * U2]
K2 = [np.sqrt(0.6) * np.eye(4), np.sqrt(0.4) * U4]
COEFFS = [0.7, -1.3]


def _codes(q):
    """Two Pauli terms on q's qubits (4 or 3)."""
    return ([3, 1, 0, 2, 0, 0, 1, 3] if q.numQubitsRepresented == 4
            else [3, 1, 2, 0, 1, 3])


SV, DM = "sv", "dm"
# (name, register kinds, call(api, q, aux) -> value); aux holds a pure
# statevector 'pure', a second register 'other' of q's kind and an output
# 'out' of q's kind, each built the same way on both packages
CALLS = [
    ("compactUnitary", (SV, DM), lambda Q, q, x: Q.compactUnitary(q, 1, A, B)),
    ("controlledCompactUnitary", (SV, DM),
     lambda Q, q, x: Q.controlledCompactUnitary(q, 0, 2, A, B)),
    ("unitary", (SV, DM), lambda Q, q, x: Q.unitary(q, 2, U2)),
    ("controlledUnitary", (SV, DM),
     lambda Q, q, x: Q.controlledUnitary(q, 1, 0, U2)),
    ("multiControlledUnitary", (SV, DM),
     lambda Q, q, x: Q.multiControlledUnitary(q, [0, 2], 1, U2)),
    ("multiControlledUnitary_c", (SV, DM),
     lambda Q, q, x: Q.multiControlledUnitary(q, [0, 2, 1], 2, 1, U2)),
    ("multiStateControlledUnitary", (SV, DM),
     lambda Q, q, x: Q.multiStateControlledUnitary(q, [0, 2], [0, 1], 1,
                                                   U2)),
    ("pauliX", (SV, DM), lambda Q, q, x: Q.pauliX(q, 0)),
    ("pauliY", (SV, DM), lambda Q, q, x: Q.pauliY(q, 1)),
    ("pauliZ", (SV, DM), lambda Q, q, x: Q.pauliZ(q, 2)),
    ("hadamard", (SV, DM), lambda Q, q, x: Q.hadamard(q, 1)),
    ("sGate", (SV, DM), lambda Q, q, x: Q.sGate(q, 0)),
    ("tGate", (SV, DM), lambda Q, q, x: Q.tGate(q, 2)),
    ("phaseShift", (SV, DM), lambda Q, q, x: Q.phaseShift(q, 1, 0.37)),
    ("controlledPhaseShift", (SV, DM),
     lambda Q, q, x: Q.controlledPhaseShift(q, 0, 2, -1.1)),
    ("multiControlledPhaseShift", (SV, DM),
     lambda Q, q, x: Q.multiControlledPhaseShift(q, [0, 1, 2], 0.8)),
    ("multiControlledPhaseShift_c", (SV, DM),
     lambda Q, q, x: Q.multiControlledPhaseShift(q, [2, 0, 1], 2, 0.8)),
    ("controlledPhaseFlip", (SV, DM),
     lambda Q, q, x: Q.controlledPhaseFlip(q, 1, 2)),
    ("multiControlledPhaseFlip", (SV, DM),
     lambda Q, q, x: Q.multiControlledPhaseFlip(q, [0, 1, 2])),
    ("multiControlledPhaseFlip_c", (SV, DM),
     lambda Q, q, x: Q.multiControlledPhaseFlip(q, [1, 2, 0], 2)),
    ("controlledNot", (SV, DM), lambda Q, q, x: Q.controlledNot(q, 2, 0)),
    ("controlledPauliY", (SV, DM),
     lambda Q, q, x: Q.controlledPauliY(q, 0, 1)),
    ("rotateX", (SV, DM), lambda Q, q, x: Q.rotateX(q, 0, 0.3)),
    ("rotateY", (SV, DM), lambda Q, q, x: Q.rotateY(q, 1, -0.6)),
    ("rotateZ", (SV, DM), lambda Q, q, x: Q.rotateZ(q, 2, 1.7)),
    ("rotateAroundAxis", (SV, DM),
     lambda Q, q, x: Q.rotateAroundAxis(q, 1, 0.9, (0.3, -0.2, 0.5))),
    ("controlledRotateX", (SV, DM),
     lambda Q, q, x: Q.controlledRotateX(q, 1, 0, 0.4)),
    ("controlledRotateY", (SV, DM),
     lambda Q, q, x: Q.controlledRotateY(q, 2, 1, 0.5)),
    ("controlledRotateZ", (SV, DM),
     lambda Q, q, x: Q.controlledRotateZ(q, 0, 2, 0.6)),
    ("controlledRotateAroundAxis", (SV, DM),
     lambda Q, q, x: Q.controlledRotateAroundAxis(q, 2, 0, 1.2,
                                                  (1.0, 1.0, 0.0))),
    ("multiRotateZ", (SV, DM),
     lambda Q, q, x: Q.multiRotateZ(q, [0, 2], 0.45)),
    ("multiRotateZ_c", (SV, DM),
     lambda Q, q, x: Q.multiRotateZ(q, [0, 1, 2], 2, 0.45)),
    ("multiRotatePauli", (SV, DM),
     lambda Q, q, x: Q.multiRotatePauli(q, [0, 1, 2], [1, 2, 3], 0.7)),
    ("multiRotatePauli_c", (SV, DM),
     lambda Q, q, x: Q.multiRotatePauli(q, [2, 0, 1], [2, 0, 1], 2, 0.7)),
    ("swapGate", (SV, DM), lambda Q, q, x: Q.swapGate(q, 0, 2)),
    ("sqrtSwapGate", (SV, DM), lambda Q, q, x: Q.sqrtSwapGate(q, 1, 2)),
    ("twoQubitUnitary", (SV, DM),
     lambda Q, q, x: Q.twoQubitUnitary(q, 2, 0, U4)),
    ("controlledTwoQubitUnitary", (SV, DM),
     lambda Q, q, x: Q.controlledTwoQubitUnitary(q, 1, 0, 2, U4)),
    ("multiControlledTwoQubitUnitary", (SV,),
     lambda Q, q, x: Q.multiControlledTwoQubitUnitary(q, [1, 3], 0, 2, U4)),
    ("multiQubitUnitary", (SV, DM),
     lambda Q, q, x: Q.multiQubitUnitary(q, [2, 0, 1], U8)),
    ("controlledMultiQubitUnitary", (SV,),
     lambda Q, q, x: Q.controlledMultiQubitUnitary(q, 3, [2, 0], U4)),
    ("multiControlledMultiQubitUnitary", (SV,),
     lambda Q, q, x: Q.multiControlledMultiQubitUnitary(q, [3, 1], [2, 0],
                                                        U4)),
    # decoherence
    ("mixDephasing", (DM,), lambda Q, q, x: Q.mixDephasing(q, 1, 0.3)),
    ("mixTwoQubitDephasing", (DM,),
     lambda Q, q, x: Q.mixTwoQubitDephasing(q, 0, 2, 0.4)),
    ("mixDepolarising", (DM,), lambda Q, q, x: Q.mixDepolarising(q, 2, 0.2)),
    ("mixTwoQubitDepolarising", (DM,),
     lambda Q, q, x: Q.mixTwoQubitDepolarising(q, 1, 0, 0.5)),
    ("mixDamping", (DM,), lambda Q, q, x: Q.mixDamping(q, 0, 0.35)),
    ("mixPauli", (DM,), lambda Q, q, x: Q.mixPauli(q, 1, 0.1, 0.2, 0.15)),
    ("mixKrausMap", (DM,), lambda Q, q, x: Q.mixKrausMap(q, 2, K1)),
    ("mixTwoQubitKrausMap", (DM,),
     lambda Q, q, x: Q.mixTwoQubitKrausMap(q, 0, 1, K2)),
    ("mixMultiQubitKrausMap", (DM,),
     lambda Q, q, x: Q.mixMultiQubitKrausMap(q, [2, 0], K2)),
    ("mixDensityMatrix", (DM,),
     lambda Q, q, x: Q.mixDensityMatrix(q, 0.3, x["other"])),
    # state initialisations and setters
    ("initBlankState", (SV, DM), lambda Q, q, x: Q.initBlankState(q)),
    ("initZeroState", (SV, DM), lambda Q, q, x: Q.initZeroState(q)),
    ("initPlusState", (SV, DM), lambda Q, q, x: Q.initPlusState(q)),
    ("initClassicalState", (SV, DM),
     lambda Q, q, x: Q.initClassicalState(q, 5)),
    ("initPureState", (SV, DM),
     lambda Q, q, x: Q.initPureState(q, x["pure"])),
    ("initDebugState", (SV, DM), lambda Q, q, x: Q.initDebugState(q)),
    ("initStateDebug", (SV,), lambda Q, q, x: Q.initStateDebug(q)),
    ("initStateFromAmps", (SV,),
     lambda Q, q, x: Q.initStateFromAmps(q, np.arange(16) / 30.0,
                                         -np.arange(16) / 40.0)),
    ("initStateOfSingleQubit", (SV,),
     lambda Q, q, x: Q.initStateOfSingleQubit(q, 2, 1)),
    ("setAmps", (SV,),
     lambda Q, q, x: Q.setAmps(q, 3, [0.1, 0.2, 0.3], [0.0, -0.1, 0.4])),
    ("setAmps_c", (SV,),
     lambda Q, q, x: Q.setAmps(q, 5, [0.1, 0.2, 0.3], [0.3, 0.2, 0.1], 2)),
    ("setDensityAmps", (DM,),
     lambda Q, q, x: Q.setDensityAmps(q, np.linspace(0, 1, 64),
                                      np.linspace(1, 0, 64))),
    ("setWeightedQureg", (SV, DM),
     lambda Q, q, x: Q.setWeightedQureg(0.5 + 0.1j, q, -0.3j, x["other"],
                                        0.7, x["out"])),
    ("cloneQureg", (SV, DM), lambda Q, q, x: Q.cloneQureg(q, x["other"])),
    # calculations
    ("calcTotalProb", (SV, DM), lambda Q, q, x: Q.calcTotalProb(q)),
    ("calcInnerProduct", (SV,),
     lambda Q, q, x: Q.calcInnerProduct(q, x["other"])),
    ("calcDensityInnerProduct", (DM,),
     lambda Q, q, x: Q.calcDensityInnerProduct(q, x["other"])),
    ("calcPurity", (DM,), lambda Q, q, x: Q.calcPurity(q)),
    ("calcFidelity", (SV, DM),
     lambda Q, q, x: Q.calcFidelity(q, x["pure"])),
    ("calcHilbertSchmidtDistance", (DM,),
     lambda Q, q, x: Q.calcHilbertSchmidtDistance(q, x["other"])),
    ("calcExpecPauliProd", (SV, DM),
     lambda Q, q, x: Q.calcExpecPauliProd(q, [0, 2, 1], [1, 3, 2])),
    ("calcExpecPauliProd_c", (SV, DM),
     lambda Q, q, x: Q.calcExpecPauliProd(q, [1, 0, 2], [3, 1, 2], 2,
                                          x["out"])),
    ("calcExpecPauliSum", (SV, DM),
     lambda Q, q, x: Q.calcExpecPauliSum(q, _codes(q), COEFFS)),
    ("calcExpecPauliSum_c", (SV, DM),
     lambda Q, q, x: Q.calcExpecPauliSum(q, _codes(q), COEFFS, 1)),
    ("calcProbOfOutcome", (SV, DM),
     lambda Q, q, x: Q.calcProbOfOutcome(q, 1, 1)),
    ("applyPauliSum", (SV,),
     lambda Q, q, x: Q.applyPauliSum(q, _codes(q), COEFFS, 2, x["out"])),
    ("collapseToOutcome", (SV, DM),
     lambda Q, q, x: Q.collapseToOutcome(q, 2, 0)),
    # getters
    ("getAmp", (SV,), lambda Q, q, x: Q.getAmp(q, 11)),
    ("getRealAmp", (SV,), lambda Q, q, x: Q.getRealAmp(q, 3)),
    ("getImagAmp", (SV,), lambda Q, q, x: Q.getImagAmp(q, 6)),
    ("getProbAmp", (SV,), lambda Q, q, x: Q.getProbAmp(q, 9)),
    ("getDensityAmp", (DM,), lambda Q, q, x: Q.getDensityAmp(q, 3, 6)),
    ("getNumQubits", (SV, DM), lambda Q, q, x: Q.getNumQubits(q)),
    ("getNumAmps", (SV,), lambda Q, q, x: Q.getNumAmps(q)),
    ("compareStates", (SV, DM),
     lambda Q, q, x: (Q.compareStates(q, x["other"], 1e-3),
                      Q.compareStates(q, q, 0.0))),
]

N_SV, N_DM = 4, 3


def _handles(pkg, kind, dtype, seed):
    """(q, aux) of package `pkg` ('port' or 'ref'): q a `kind` register
    in a seeded random state, aux its companions."""
    rng = np.random.default_rng(seed)
    n = N_SV if kind == SV else N_DM

    def make(k, m):
        if pkg == "port":
            st = (TS.create_qureg if k == SV else TS.create_density_qureg)(
                m, dtype=dtype, device="cpu")
            return Q.Qureg(st, ENV)
        st = (JS.create_qureg if k == SV else JS.create_density_qureg)(
            m, dtype=dtype)
        return JQ.Qureg(st)

    api = Q if pkg == "port" else JQ

    def pure(m):
        v = rng.standard_normal((2, 1 << m))
        v /= np.sqrt((v ** 2).sum())
        p = make(SV, m)
        api.initStateFromAmps(p, v[0], v[1])
        return p

    def register():
        q = make(kind, n)
        if kind == SV:
            v = rng.standard_normal((2, 1 << n))
            v /= np.sqrt((v ** 2).sum())
            api.initStateFromAmps(q, v[0], v[1])
        else:
            api.initPureState(q, pure(n))
            api.mixDepolarising(q, 0, 0.2)
        return q
    q = register()
    aux = {"other": register(), "out": register(), "pure": pure(n)}
    return q, aux


def _dense(h):
    to = TS.to_dense if isinstance(h, Q.Qureg) else JS.to_dense
    return np.asarray(to(h.state))


def _same_value(a, b, tol):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y, tol)
    elif a is None or isinstance(a, (bool, int, np.bool_)):
        assert a == b
    else:
        assert abs(complex(a) - complex(b)) <= tol * max(1.0, abs(b))


CASES = [(name, kind, call) for name, kinds, call in CALLS
         for kind in kinds]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("name,kind,call", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_api_function_equals_reference(name, kind, call, dtype):
    tol = TOL[dtype]
    mine, maux = _handles("port", kind, dtype, 11)
    ref, raux = _handles("ref", kind, dtype, 11)
    for h in (mine, ref):
        h.qasm.start_recording()
    got = call(Q, mine, maux)
    want = call(JQ, ref, raux)
    _same_value(got, want, tol)
    for a, b in [(mine, ref)] + [(maux[k], raux[k]) for k in maux]:
        x, y = _dense(a), _dense(b)
        assert np.abs(x - y).max() <= tol * max(1.0, np.abs(y).max())
    assert mine.qasm.recorded() == ref.qasm.recorded()


# ---------------------------------------------------------------------------
# measurement, seeded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [SV, DM])
@pytest.mark.parametrize("seed", [1, 7, 123])
def test_seeded_measure_outcomes_equal(seed, kind):
    dtype = np.complex128
    mine, _ = _handles("port", kind, dtype, seed)
    ref, _ = _handles("ref", kind, dtype, seed)
    for h in (mine, ref):
        h.qasm.start_recording()
    Q.seedQuEST([seed, 99])
    JQ.seedQuEST([seed, 99])
    for qubit in (0, 2, 1):
        assert Q.measure(mine, qubit) == JQ.measure(ref, qubit)
    Q.seedQuEST([seed])
    JQ.seedQuEST([seed])
    o1, p1 = Q.measureWithStats(mine, 1)
    o2, p2 = JQ.measureWithStats(ref, 1)
    assert o1 == o2 and abs(p1 - p2) <= 1e-12
    assert np.abs(_dense(mine) - _dense(ref)).max() <= 1e-12
    assert mine.qasm.recorded() == ref.qasm.recorded()


# ---------------------------------------------------------------------------
# errors and the error hook
# ---------------------------------------------------------------------------

def _sv(api, n=3):
    if api is Q:
        return Q.createQureg(n, ENV)
    return JQ.createQureg(n)


def _dm(api, n=2):
    if api is Q:
        return Q.createDensityQureg(n, ENV)
    return JQ.createDensityQureg(n)


ERRORS = [
    ("target", lambda Q: Q.hadamard(_sv(Q), 5)),
    ("control", lambda Q: Q.controlledNot(_sv(Q), 7, 1)),
    ("control_is_target", lambda Q: Q.controlledNot(_sv(Q), 1, 1)),
    ("non_unitary", lambda Q: Q.unitary(_sv(Q), 0,
                                        np.array([[1, 0], [0, 0.5]]))),
    ("non_unitary_pair", lambda Q: Q.compactUnitary(_sv(Q), 0, 0.9, 0.1)),
    ("dephase", lambda Q: Q.mixDephasing(_dm(Q), 0, 0.6)),
    ("dephase2", lambda Q: Q.mixTwoQubitDephasing(_dm(Q), 0, 1, 0.8)),
    ("depol", lambda Q: Q.mixDepolarising(_dm(Q), 0, 0.8)),
    ("depol2", lambda Q: Q.mixTwoQubitDepolarising(_dm(Q), 0, 1, 0.95)),
    ("damping", lambda Q: Q.mixDamping(_dm(Q), 0, 1.2)),
    ("kraus", lambda Q: Q.mixKrausMap(_dm(Q), 0, [np.eye(2) * 0.5])),
    ("kraus_count", lambda Q: Q.mixKrausMap(_dm(Q), 0, [np.eye(2) / 2] * 5)),
    ("purity_of_sv", lambda Q: Q.calcPurity(_sv(Q))),
    ("amp_of_dm", lambda Q: Q.getAmp(_dm(Q), 0)),
    ("fidelity_of_dm", lambda Q: Q.calcFidelity(_sv(Q), _dm(Q))),
    ("pauli_code", lambda Q: Q.calcExpecPauliSum(_sv(Q, 2), [[4, 0]], [1.0])),
    ("sum_terms", lambda Q: Q.calcExpecPauliSum(_sv(Q, 2), np.zeros((0, 2)),
                                                [])),
    ("outcome", lambda Q: Q.collapseToOutcome(_sv(Q, 2), 0, 2)),
    ("create_zero", lambda Q: Q.createQureg(0, ENV if Q is not JQ else None)),
    ("create_huge", lambda Q: Q.createQureg(70, ENV if Q is not JQ else None)),
    ("matrix_size", lambda Q: Q.createComplexMatrixN(0)),
]


@pytest.mark.parametrize("call", [e[1] for e in ERRORS],
                         ids=[e[0] for e in ERRORS])
def test_error_message_equals_reference(call):
    with pytest.raises(JQuESTError) as want:
        call(JQ)
    with pytest.raises(QuESTError) as got:
        call(Q)
    # the reference's default hook prefixes "QuEST Error in function f: "
    assert str(want.value).endswith(str(got.value))
    assert str(got.value) in set(TV.MESSAGES.values()) or \
        str(got.value).startswith("Invalid")


def test_input_error_handler_is_called():
    seen = []

    def handler(msg, func):
        seen.append((msg, func))
        raise RuntimeError("handled: " + msg)
    Q.set_input_error_handler(handler)
    try:
        with pytest.raises(RuntimeError, match="handled: Invalid target"):
            Q.hadamard(Q.createQureg(2, ENV), 4)
        assert seen and seen[0][1] == "hadamard"
    finally:
        Q.set_input_error_handler(None)
    # a handler that returns still stops the operation
    Q.set_input_error_handler(lambda msg, func: seen.append((msg, func)))
    try:
        with pytest.raises(QuESTError):
            Q.pauliX(Q.createQureg(2, ENV), 9)
    finally:
        Q.set_input_error_handler(None)
    assert len(seen) == 2


def test_default_handler_calls_the_api_hook(monkeypatch):
    seen = []
    monkeypatch.setattr(Q, "invalidQuESTInputError",
                        lambda msg, func: seen.append((msg, func)))
    with pytest.raises(QuESTError) as e:
        Q.rotateX(Q.createQureg(2, ENV), 3, 0.1)
    assert e.value.code is TV.ErrorCode.E_INVALID_TARGET_QUBIT
    assert seen == [(str(e.value), "rotateX")]


# ---------------------------------------------------------------------------
# handles, environment, reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [SV, DM])
def test_a_clone_is_not_an_alias(kind):
    q, aux = _handles("port", kind, np.complex64, 3)
    before = _dense(q)
    clone = Q.createCloneQureg(q)
    assert clone.state.amps.data_ptr() != q.state.amps.data_ptr()
    Q.hadamard(clone, 0)
    Q.pauliX(clone, 1)
    np.testing.assert_array_equal(_dense(q), before)
    other = aux["other"]
    Q.cloneQureg(other, q)
    Q.rotateY(q, 2, 0.4)
    np.testing.assert_array_equal(_dense(other), before)
    assert other.state.amps.data_ptr() != q.state.amps.data_ptr()
    Q.setWeightedQureg(1.0, q, 0.0, aux["pure"] if kind == SV else other,
                       0.0, aux["out"])
    Q.pauliZ(q, 0)
    assert not np.array_equal(_dense(aux["out"]), _dense(q))
    if kind == DM:
        pure = aux["pure"]
        Q.initPureState(q, pure)
        Q.hadamard(q, 0)
        assert np.allclose(np.linalg.norm(_dense(pure)), 1.0)
        assert pure.state.amps.data_ptr() != q.state.amps.data_ptr()
        Q.mixDensityMatrix(q, 0.5, other)
        Q.pauliX(q, 0)
        np.testing.assert_array_equal(_dense(other), before)


def test_environment_names_its_device(capsys):
    q = Q.createQureg(3, ENV)
    assert Q.getEnvironmentString(ENV, q) == "3qubits_CPU_1ranksx1threads"
    assert Q.getEnvironmentString(ENV) == "CPU_1ranksx1threads"
    rho = Q.createDensityQureg(2, ENV)
    assert Q.getEnvironmentString(ENV, rho).startswith("4qubits_")
    Q.reportQuESTEnv(ENV)
    out = capsys.readouterr().out
    assert "Platform: CPU" in out and "TPU" not in out
    assert ENV.num_ranks == 1 and ENV.rank == 0
    Q.syncQuESTEnv(ENV)
    assert Q.syncQuESTSuccess(5) == 1 and Q.syncQuESTSuccess(0) == 0
    Q.copyStateToGPU(q)
    Q.copyStateFromGPU(q)
    Q.destroyQureg(q, ENV)
    assert q.state is None
    Q.destroyQuESTEnv(ENV)
    assert q.numQubitsRepresented if q.state else True


def test_reports_equal_reference(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for kind in (SV, DM):
        mine, _ = _handles("port", kind, np.complex128, 5)
        ref, _ = _handles("ref", kind, np.complex128, 5)
        for api, h in ((Q, mine), (JQ, ref)):
            api.reportQuregParams(h)
            api.reportStateToScreen(h)
        out = capsys.readouterr().out.splitlines()
        half = len(out) // 2
        assert out[:half] == out[half:]
    jq = JQ.createQureg(3)
    JQ.initDebugState(jq)
    JQ.reportState(jq)
    want = (tmp_path / "state_rank_0.csv").read_text()
    q = Q.createQureg(3, ENV)
    Q.initDebugState(q)
    Q.reportState(q)
    text = (tmp_path / "state_rank_0.csv").read_text()
    assert text == want and text.splitlines()[0] == "real, imag"
    q2 = Q.createQureg(3, ENV)
    assert Q.initStateFromSingleFile(q2, "state_rank_0.csv")
    assert Q.compareStates(q, q2, 1e-6)
    assert not Q.initStateFromSingleFile(q2, "missing.csv")


def test_matrices_and_precision():
    m = Q.createComplexMatrixN(2)
    assert m.shape == (4, 4) and not m.any()
    Q.initComplexMatrixN(m, np.eye(4), 2 * np.eye(4))
    np.testing.assert_array_equal(m, (1 + 2j) * np.eye(4))
    np.testing.assert_array_equal(
        Q.bindArraysToStackComplexMatrixN(1, [[1, 0], [0, 1]],
                                          [[0, 1], [1, 0]]),
        JQ.bindArraysToStackComplexMatrixN(1, [[1, 0], [0, 1]],
                                           [[0, 1], [1, 0]]))
    np.testing.assert_array_equal(
        Q.getStaticComplexMatrixN(1, [[1, 0], [0, 1]], [[0, 0], [0, 0]]),
        np.eye(2))
    Q.destroyComplexMatrixN(m)
    assert Q.QuESTPrecision() == 1
    assert (Q.PAULI_I, Q.PAULI_X, Q.PAULI_Y, Q.PAULI_Z) == (0, 1, 2, 3)


def test_qasm_controls_and_file(tmp_path, capsys):
    q = Q.createQureg(2, ENV)
    Q.startRecordingQASM(q)
    Q.pauliX(q, 0)
    Q.clearRecordedQASM(q)
    Q.pauliY(q, 1)
    Q.stopRecordingQASM(q)
    Q.hadamard(q, 0)
    path = tmp_path / "out.qasm"
    Q.writeRecordedQASMToFile(q, str(path))
    assert path.read_text() == q.qasm.recorded()
    assert "y q[1];" in path.read_text() and "h q[0]" not in path.read_text()
    Q.printRecordedQASM(q)
    assert capsys.readouterr().out == q.qasm.recorded()
    with pytest.raises(QuESTError, match="Could not open file"):
        Q.writeRecordedQASMToFile(q, str(tmp_path / "no" / "x.qasm"))
