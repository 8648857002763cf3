"""The port's eager gate and channel API, state initialisers and getters
against the JAX package.

Every public function of quest_tpu/ops/gates.py (39, set_weighted_qureg
included) and ops/channels.py (10) through quest_tpu_torch.ops.gates /
channels on the CPU, beside the reference's, from the same seeded random
state: statevectors of 5 qubits and density matrices of 3 (a gate's
column-space dual included), f32 within 2e-5 x max|amp| and a subset at
f64 within 1e-12; the reference tutorial (prob |111> = 0.112422,
prob(qubit 2 = 1) = 0.749178 within 2e-6); the initialisers and
amplitude getters of state.py; and the validation errors, whose codes
and messages must be the reference's verbatim."""

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import state as JS
from quest_tpu import validation as JV
from quest_tpu.ops import channels as JCH
from quest_tpu.ops import gates as JG

from quest_tpu_torch import measurement as TM
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import channels as TCH
from quest_tpu_torch.ops import gates as TG
from quest_tpu_torch.ops import matrices as M

pytestmark = pytest.mark.dtype_agnostic

TOL = {np.float32: 2e-5, np.float64: 1e-12}
SV, DM = 5, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _haar(k, seed):
    rng = np.random.default_rng(seed)
    d = 1 << k
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


U2, U4, U8 = _haar(1, 1), _haar(2, 2), _haar(3, 3)
ALPHA, BETA = 0.6 * np.exp(0.3j), 0.8 * np.exp(-1.1j)

# (function name, arguments after the register); every qubit below 3, so
# each case runs on the 3-qubit density register too
GATES = [
    ("compact_unitary", (0, ALPHA, BETA)),
    ("controlled_compact_unitary", (1, 0, ALPHA, BETA)),
    ("unitary", (2, U2)),
    ("controlled_unitary", (0, 2, U2)),
    ("multi_controlled_unitary", ([0, 1], 2, U2)),
    ("multi_state_controlled_unitary", ([0, 2], [0, 1], 1, U2)),
    ("pauli_x", (1,)), ("pauli_y", (2,)), ("pauli_z", (0,)),
    ("hadamard", (1,)), ("s_gate", (2,)), ("t_gate", (0,)),
    ("phase_shift", (1, 0.7)),
    ("controlled_not", (0, 2)), ("controlled_pauli_y", (2, 1)),
    ("rotate_around_axis", (1, 0.9, (1.0, 2.0, 3.0))),
    ("rotate_x", (0, 0.3)), ("rotate_y", (1, 1.1)), ("rotate_z", (2, -0.4)),
    ("controlled_rotate_around_axis", (0, 1, 0.5, (0.3, -1.0, 2.0))),
    ("controlled_rotate_x", (2, 0, 0.6)), ("controlled_rotate_y", (1, 2, 0.7)),
    ("controlled_rotate_z", (0, 1, 0.8)),
    ("controlled_phase_shift", (0, 2, 0.9)),
    ("multi_controlled_phase_shift", ([0, 1, 2], 0.4)),
    ("controlled_phase_flip", (1, 2)),
    ("multi_controlled_phase_flip", ([0, 1, 2],)),
    ("multi_rotate_z", ([0, 2], 0.3)),
    ("multi_rotate_pauli", ([0, 1, 2], [1, 2, 3], 0.77)),
    ("swap_gate", (0, 2)), ("sqrt_swap_gate", (1, 2)),
    ("two_qubit_unitary", (2, 0, U4)),
    ("controlled_two_qubit_unitary", (1, 0, 2, U4)),
    ("multi_controlled_two_qubit_unitary", ([1], 2, 0, U4)),
    ("multi_qubit_unitary", ([2, 0, 1], U8)),
    ("controlled_multi_qubit_unitary", (1, [0, 2], U4)),
    ("multi_controlled_multi_qubit_unitary", ([0], [2, 1], U4)),
    ("apply_pauli_prod", ([0, 2], [2, 1])),
]

F64_GATES = ("unitary", "multi_state_controlled_unitary", "rotate_y",
             "multi_controlled_phase_shift", "multi_rotate_pauli",
             "multi_qubit_unitary")


def _kraus2():
    p = 0.2
    paulis = [np.eye(2), M.PAULI_X, M.PAULI_Y, M.PAULI_Z]
    return [np.sqrt(1 - 15 * p / 16) * np.eye(4)] + [
        np.sqrt(p / 16) * np.kron(b, a) for i, a in enumerate(paulis)
        for j, b in enumerate(paulis) if i or j]


CHANNELS = [
    ("mix_dephasing", (1, 0.3)),
    ("mix_two_qubit_dephasing", (0, 2, 0.5)),
    ("mix_depolarising", (2, 0.4)),
    ("mix_two_qubit_depolarising", (0, 1, 0.6)),
    ("mix_damping", (1, 0.35)),
    ("mix_pauli", (0, 0.1, 0.15, 0.2)),
    ("mix_kraus_map", (2, M.damping_kraus(0.25))),
    ("mix_two_qubit_kraus_map", (0, 2, _kraus2())),
    ("mix_multi_qubit_kraus_map", ([2, 0, 1], [U8 * np.sqrt(0.5),
                                               np.eye(8) * np.sqrt(0.5)])),
]


def _cdt(rdt):
    return np.complex64 if rdt == np.float32 else np.complex128


def _registers(density, rdt, seed=20):
    """(port register, reference register) holding one random state."""
    rng = np.random.default_rng(seed)
    if density:
        dim = 1 << DM
        g = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
        rho = g @ g.conj().T
        v = (rho / np.trace(rho).real).reshape(-1, order="F")
        tq = TS.create_density_qureg(DM, dtype=_cdt(rdt), device="cpu")
        jq = JS.create_density_qureg(DM, dtype=_cdt(rdt))
    else:
        v = rng.standard_normal(1 << SV) + 1j * rng.standard_normal(1 << SV)
        v /= np.linalg.norm(v)
        tq = TS.create_qureg(SV, dtype=_cdt(rdt), device="cpu")
        jq = JS.create_qureg(SV, dtype=_cdt(rdt))
    planes = np.stack([v.real, v.imag]).astype(rdt)
    tq.amps.copy_(torch.from_numpy(planes))
    return tq, jq.replace_amps(jnp.asarray(planes))


def _compare(tq, jq, rdt):
    want = np.asarray(jq.amps)
    got = tq.amps.numpy()
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= TOL[rdt] * np.abs(want).max()


def _gate_cases():
    cases = [pytest.param(name, args, density, np.float32,
                          id=f"{name}-{'dm' if density else 'sv'}-f32")
             for name, args in GATES for density in (False, True)]
    cases += [pytest.param(name, args, density, np.float64,
                           id=f"{name}-{'dm' if density else 'sv'}-f64")
              for name, args in GATES if name in F64_GATES
              for density in (False, True)]
    return cases


@pytest.mark.parametrize("name,args,density,rdt", _gate_cases())
def test_gate_matches_reference(name, args, density, rdt):
    tq, jq = _registers(density, rdt)
    out = getattr(TG, name)(tq, *args)
    assert out is tq                           # in place
    _compare(tq, getattr(JG, name)(jq, *args), rdt)


@pytest.mark.parametrize("name,args", CHANNELS + [
    ("mix_density_matrix", (0.3,))], ids=lambda x: x if isinstance(x, str)
    else "")
@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_channel_matches_reference(name, args, rdt):
    tq, jq = _registers(True, rdt)
    if name == "mix_density_matrix":
        to, jo = _registers(True, rdt, seed=21)
        args = args + (to,)
        jargs = (0.3, jo)
    else:
        jargs = args
    assert getattr(TCH, name)(tq, *args) is tq
    _compare(tq, getattr(JCH, name)(jq, *jargs), rdt)


def test_set_weighted_qureg():
    for density in (False, True):
        a, ja = _registers(density, np.float32, 1)
        b, jb = _registers(density, np.float32, 2)
        o, jo = _registers(density, np.float32, 3)
        facs = (0.5 - 0.2j, 1.5j, -0.25 + 0.1j)
        out = TG.set_weighted_qureg(facs[0], a, facs[1], b, facs[2], o)
        assert out is o
        _compare(o, JG.set_weighted_qureg(facs[0], ja, facs[1], jb, facs[2],
                                          jo), np.float32)
    # the output may be one of the inputs
    a, ja = _registers(False, np.float32, 1)
    TG.set_weighted_qureg(2.0, a, 0.0, a, 1.0, a)
    _compare(a, JG.set_weighted_qureg(2.0, ja, 0.0, ja, 1.0, ja), np.float32)


def test_identity_pauli_rotation_is_a_no_op():
    tq, _ = _registers(False, np.float32)
    before = tq.amps.clone()
    TG.multi_rotate_pauli(tq, [1, 3], [0, 0], 0.5)
    assert torch.equal(tq.amps, before)


def test_tutorial_numbers():
    """The reference tutorial (examples/tutorial_example.c:50-105) through
    the eager API: the reference binary's 0.112422 and 0.749178."""
    q = TS.create_qureg(3, device="cpu")
    TG.hadamard(q, 0)
    TG.controlled_not(q, 0, 1)
    TG.rotate_y(q, 2, 0.1)
    TG.multi_controlled_phase_flip(q, [0, 1, 2])
    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
    TG.unitary(q, 0, u)
    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    TG.compact_unitary(q, 1, a, b)
    TG.rotate_around_axis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    TG.controlled_compact_unitary(q, 0, 1, a, b)
    TG.multi_controlled_unitary(q, [0, 1], 2, u)
    toff = np.eye(8, dtype=complex)[[0, 1, 2, 3, 4, 5, 7, 6]]
    TG.multi_qubit_unitary(q, [0, 1, 2], toff)
    assert TS.get_prob_amp(q, 7) == pytest.approx(0.112422, abs=2e-6)
    assert TM.calc_prob_of_outcome(q, 2, 1) == pytest.approx(0.749178,
                                                             abs=2e-6)


def test_initialisers_and_getters():
    for rdt in (np.float32, np.float64):
        cdt = _cdt(rdt)
        t = TS.create_qureg(4, dtype=cdt, device="cpu")
        j = JS.create_qureg(4, dtype=cdt)
        TS.init_state_of_single_qubit(t, 2, 1)
        _compare(t, JS.init_state_of_single_qubit(j, 2, 1), rdt)
        TS.init_blank_state(t)
        assert not t.amps.any()
        rng = np.random.default_rng(4)
        re, im = rng.standard_normal(16), rng.standard_normal(16)
        TS.init_state_from_amps(t, re, im)
        j = JS.init_state_from_amps(j, re, im)
        _compare(t, j, rdt)
        TS.set_amps(t, 3, re[:5], im[5:10])
        j = JS.set_amps(j, 3, re[:5], im[5:10])
        _compare(t, j, rdt)
        for i in (0, 7, 15):
            assert TS.get_amp(t, i) == JS.get_amp(j, i)
            assert TS.get_real_amp(t, i) == JS.get_real_amp(j, i)
            assert TS.get_imag_amp(t, i) == JS.get_imag_amp(j, i)
            assert TS.get_prob_amp(t, i) == JS.get_prob_amp(j, i)
        assert TS.get_num_qubits(t) == 4 and TS.get_num_amps(t) == 16
        c = TS.clone(t)
        assert torch.equal(c.amps, t.amps)
        assert c.amps.data_ptr() != t.amps.data_ptr()
        # density registers
        pure, jpure = t, j
        norm = (t.amps.double() ** 2).sum().sqrt().item()
        pure.amps.div_(norm)
        jpure = jpure.replace_amps(jpure.amps / norm)
        r = TS.create_density_qureg(4, dtype=cdt, device="cpu")
        jr = JS.create_density_qureg(4, dtype=cdt)
        TS.init_pure_state(r, pure)
        _compare(r, JS.init_pure_state(jr, jpure), rdt)
        TS.set_density_amps(r, 2, 3, re[:4], im[:4])
        jr = JS.set_density_amps(JS.init_pure_state(jr, jpure), 2, 3,
                                 re[:4], im[:4])
        _compare(r, jr, rdt)
        assert TS.get_density_amp(r, 2, 3) == JS.get_density_amp(jr, 2, 3)
        s = TS.create_qureg(4, dtype=cdt, device="cpu")
        TS.init_pure_state(s, pure)
        assert torch.equal(s.amps, pure.amps)


def _raises_reference(code_name):
    return pytest.raises(TV.QuESTError, match="^" + re.escape(
        JV.MESSAGES[JV.ErrorCode[code_name]]) + "$")


@pytest.mark.parametrize("call,code", [
    (lambda q, r: TG.hadamard(q, 5), "E_INVALID_TARGET_QUBIT"),
    (lambda q, r: TG.controlled_not(q, 7, 1), "E_INVALID_CONTROL_QUBIT"),
    (lambda q, r: TG.controlled_not(q, 1, 1), "E_TARGET_IS_CONTROL"),
    (lambda q, r: TG.swap_gate(q, 1, 1), "E_QUBITS_NOT_UNIQUE"),
    (lambda q, r: TG.multi_qubit_unitary(q, [0, 0], U4),
     "E_TARGETS_NOT_UNIQUE"),
    (lambda q, r: TG.multi_controlled_unitary(q, [1, 1], 0, U2),
     "E_CONTROLS_NOT_UNIQUE"),
    (lambda q, r: TG.multi_controlled_unitary(q, [0, 1], 0, U2),
     "E_CONTROL_TARGET_COLLISION"),
    (lambda q, r: TG.multi_state_controlled_unitary(q, [1], [2], 0, U2),
     "E_INVALID_CONTROLS_BIT_STATE"),
    (lambda q, r: TG.unitary(q, 0, np.array([[1, 0], [0, 0.5]])),
     "E_NON_UNITARY_MATRIX"),
    (lambda q, r: TG.two_qubit_unitary(q, 0, 1, U2), "E_INVALID_UNITARY_SIZE"),
    (lambda q, r: TG.compact_unitary(q, 0, 0.9, 0.1),
     "E_NON_UNITARY_COMPLEX_PAIR"),
    (lambda q, r: TG.rotate_around_axis(q, 0, 0.1, (0, 0, 0)),
     "E_ZERO_VECTOR"),
    (lambda q, r: TG.multi_rotate_pauli(q, [0], [5], 0.1),
     "E_INVALID_PAULI_CODE"),
    (lambda q, r: TG.multi_rotate_z(q, [], 0.1), "E_INVALID_NUM_TARGETS"),
    (lambda q, r: TCH.mix_dephasing(r, 0, 0.6),
     "E_INVALID_ONE_QUBIT_DEPHASE_PROB"),
    (lambda q, r: TCH.mix_two_qubit_dephasing(r, 0, 1, 0.8),
     "E_INVALID_TWO_QUBIT_DEPHASE_PROB"),
    (lambda q, r: TCH.mix_depolarising(r, 0, 0.8),
     "E_INVALID_ONE_QUBIT_DEPOL_PROB"),
    (lambda q, r: TCH.mix_two_qubit_depolarising(r, 0, 1, 0.95),
     "E_INVALID_TWO_QUBIT_DEPOL_PROB"),
    (lambda q, r: TCH.mix_damping(r, 0, 1.2), "E_INVALID_PROB"),
    (lambda q, r: TCH.mix_pauli(r, 0, 0.4, 0.3, 0.1),
     "E_INVALID_ONE_QUBIT_PAULI_PROBS"),
    (lambda q, r: TCH.mix_kraus_map(r, 0, [np.eye(2) * 0.5]),
     "E_INVALID_KRAUS_OPS"),
    (lambda q, r: TCH.mix_kraus_map(r, 0, [np.eye(2) / 2] * 5),
     "E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS"),
    (lambda q, r: TCH.mix_dephasing(q, 0, 0.1),
     "E_DEFINED_ONLY_FOR_DENSMATRS"),
    (lambda q, r: TCH.mix_density_matrix(r, 0.1, TS.create_density_qureg(
        2, device="cpu")), "E_MISMATCHING_QUREG_DIMENSIONS"),
    (lambda q, r: TG.set_weighted_qureg(1, q, 1, r, 1, q),
     "E_MISMATCHING_QUREG_TYPES"),
    (lambda q, r: TS.get_amp(r, 0), "E_DEFINED_ONLY_FOR_STATEVECS"),
    (lambda q, r: TS.get_amp(q, 8), "E_INVALID_AMP_INDEX"),
    (lambda q, r: TS.set_amps(q, 6, [1, 2, 3], [1, 2, 3]),
     "E_INVALID_OFFSET_NUM_AMPS"),
    (lambda q, r: TS.init_state_of_single_qubit(q, 0, 3),
     "E_INVALID_QUBIT_OUTCOME"),
    (lambda q, r: TS.init_pure_state(r, r), "E_SECOND_ARG_MUST_BE_STATEVEC"),
])
def test_validation_messages_are_the_reference(call, code):
    q = TS.create_qureg(3, device="cpu")
    r = TS.create_density_qureg(3, device="cpu")
    with _raises_reference(code) as e:
        call(q, r)
    assert e.value.code is TV.ErrorCode[code]
