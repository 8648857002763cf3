"""The port's QASM front ends against the JAX package.

quest_tpu_torch.qasm beside quest_tpu.qasm: every record_* of QASMLogger
gives byte-equal text on seeded random calls. quest_tpu_torch.qasm_import
beside quest_tpu.qasm_import: the repo bench's gallery (qft, qaoa, rcs,
adder, ghz; entry.gallery_qasm equals bench.build_gallery_qasm text for
text) at 9 and 12 qubits, and recorder exports of random circuits,
import op for op (kind, targets, controls, control states, operands
within 1e-12) under both capital-U dialects; malformed text raises the
reference's message; Circuit.to_qasm gives the reference's text, and
to_qasm -> from_qasm applies the same unitary up to global phase."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import bench
from quest_tpu import qasm as JQ
from quest_tpu.circuit import Circuit as JCircuit
from quest_tpu.validation import QuESTError as JQuESTError

from quest_tpu_torch import qasm as TQ
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.entry import GALLERY_CLASSES, gallery_qasm
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.validation import QuESTError

pytestmark = pytest.mark.dtype_agnostic


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _haar(d, rng):
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


# ---------------------------------------------------------------------------
# the logger, record for record
# ---------------------------------------------------------------------------

def _record_calls(name, rng, n):
    """Seeded argument tuples for one record_* method on n qubits."""
    q = [int(x) for x in rng.permutation(n)]
    ang = float(rng.uniform(-7, 7))
    u = _haar(2, rng)
    a, b = u[0, 0], u[1, 0]
    return {
        "record_comment": [(f"comment {ang:.4f}",)],
        "record_gate": [(g, q[0], tuple(q[1:1 + int(rng.integers(0, 3))]),
                         (ang,) if g in ("rx", "ry", "rz", "phase") else ())
                        for g in ("x", "y", "z", "t", "s", "h", "rx", "ry",
                                  "rz", "phase", "swap", "sqrtswap")],
        "record_compact_unitary": [(a, b, q[0]), (a, b, q[0], (q[1],))],
        "record_unitary": [(u, q[0]), (u, q[0], (q[1], q[2]))],
        "record_axis_rotation": [(ang, tuple(rng.standard_normal(3)), q[0]),
                                 (ang, (0.0, 0.0, 1.0), q[0], (q[1],))],
        "record_multi_state_controlled_unitary": [
            (u, (q[1], q[2]), (0, 1), q[0]), (u, (q[1],), (1,), q[0])],
        "record_measurement": [(q[0],)],
        "record_init_zero": [()],
        "record_init_plus": [()],
        "record_init_classical": [(int(rng.integers(0, 1 << n)),)],
    }[name]


RECORDS = ("record_comment", "record_gate", "record_compact_unitary",
           "record_unitary", "record_axis_rotation",
           "record_multi_state_controlled_unitary", "record_measurement",
           "record_init_zero", "record_init_plus", "record_init_classical")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", RECORDS)
def test_record_text_equals_reference(name, seed):
    rng = np.random.default_rng(seed)
    n = 5
    mine, ref = TQ.QASMLogger(n), JQ.QASMLogger(n)
    for log in (mine, ref):
        log.start_recording()
    for args in _record_calls(name, rng, n):
        getattr(mine, name)(*args)
        getattr(ref, name)(*args)
    assert mine.recorded() == ref.recorded()
    # stopped loggers record nothing, cleared ones keep the header only
    mine.stop_recording()
    ref.stop_recording()
    for args in _record_calls(name, rng, n):
        getattr(mine, name)(*args)
    assert mine.recorded() == ref.recorded()
    mine.clear()
    ref.clear()
    assert mine.recorded() == ref.recorded()


def test_helpers_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        u = _haar(2, rng)
        assert TQ.complex_pair_and_phase_from_unitary(u) == \
            JQ.complex_pair_and_phase_from_unitary(u)
        a, b, _ = TQ.complex_pair_and_phase_from_unitary(u)
        assert TQ.zyz_angles_from_complex_pair(a, b) == \
            JQ.zyz_angles_from_complex_pair(a, b)
        x = float(rng.standard_normal() * 10.0 ** rng.integers(-8, 8))
        assert TQ._fmt(x) == JQ._fmt(x)


def test_write_recorded_to_file(tmp_path):
    log = TQ.QASMLogger(2)
    log.start_recording()
    log.record_gate("h", 0)
    path = tmp_path / "out.qasm"
    assert log.write_recorded_to_file(str(path))
    assert path.read_text() == log.recorded()
    assert not log.write_recorded_to_file(str(tmp_path / "no" / "x.qasm"))


# ---------------------------------------------------------------------------
# the importer, op for op
# ---------------------------------------------------------------------------

def _same_operand(a, b, tol):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, GateOp) or hasattr(x, "kind"):
                _same_op(x, y, tol)
            else:
                _same_operand(x, y, tol)
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_allclose(np.asarray(a, dtype=np.complex128),
                               np.asarray(b, dtype=np.complex128),
                               atol=tol, rtol=0)


def _same_op(t, j, tol=1e-12):
    assert (t.kind, tuple(t.targets), tuple(t.controls),
            tuple(t.cstates)) == (j.kind, tuple(j.targets),
                                  tuple(j.controls), tuple(j.cstates))
    _same_operand(t.operand, j.operand, tol)


def _same_ops(tops, jops, tol=1e-12):
    assert len(tops) == len(jops)
    for t, j in zip(tops, jops):
        _same_op(t, j, tol)


def test_gallery_text_equals_bench():
    for n in (9, 12):
        assert gallery_qasm(n) == bench.build_gallery_qasm(n)


@pytest.mark.parametrize("dialect", [None, "spec", "recorder"])
@pytest.mark.parametrize("n", [9, 12])
@pytest.mark.parametrize("cls", GALLERY_CLASSES)
def test_gallery_imports_op_for_op(cls, n, dialect):
    text = gallery_qasm(n)[cls]
    mine = Circuit.from_qasm(text, u_dialect=dialect, transpile=False)
    ref = JCircuit.from_qasm(text, u_dialect=dialect, transpile=False)
    assert mine.num_qubits == ref.num_qubits == n
    _same_ops(mine.ops, ref.ops)


def _recorder_circuit(seed, n=5):
    """A random circuit of every kind to_qasm can express as gate lines,
    built the same way on both packages."""
    rng = np.random.default_rng(seed)
    cs = (Circuit(n), JCircuit(n))
    for _ in range(25):
        k = int(rng.integers(0, 11))
        q = [int(x) for x in rng.permutation(n)]
        ang = float(rng.uniform(-4, 4))
        u = _haar(2, rng)
        for c in cs:
            if k == 0:
                c.h(q[0])
            elif k == 1:
                c.rx(q[0], ang)
            elif k == 2:
                c.ry(q[0], ang)
            elif k == 3:
                c.rz(q[0], ang)
            elif k == 4:
                c.cnot(q[0], q[1])
            elif k == 5:
                c.cphase(ang, q[0], q[1])
            elif k == 6:
                c.gate(u, (q[0],))
            elif k == 7:
                c.gate(u, (q[0],), controls=(q[1],))
            elif k == 8:
                c.swap(q[0], q[1])
            elif k == 9:
                c.phase(q[0], ang)
            else:
                c.gate(np.diag([1.0, np.exp(1j * ang)]), (q[0],),
                       controls=(q[1],), cstates=(0,))
    return cs


@pytest.mark.parametrize("dialect", [None, "recorder"])
@pytest.mark.parametrize("seed", range(4))
def test_recorder_export_imports_op_for_op(seed, dialect):
    mine, ref = _recorder_circuit(seed)
    text = mine.to_qasm()
    assert text == ref.to_qasm()
    a = Circuit.from_qasm(text, u_dialect=dialect, transpile=False)
    b = JCircuit.from_qasm(text, u_dialect=dialect, transpile=False)
    _same_ops(a.ops, b.ops)


def test_spec_dialect_reads_capital_u_as_u3():
    text = "OPENQASM 2.0;\nqreg q[2];\nU(0.3,0.2,0.1) q[0];\nU(1,2,3) q[1];"
    for dialect in ("spec", "recorder"):
        a = Circuit.from_qasm(text, u_dialect=dialect, transpile=False)
        b = JCircuit.from_qasm(text, u_dialect=dialect, transpile=False)
        _same_ops(a.ops, b.ops)
    spec = Circuit.from_qasm(text, u_dialect="spec", transpile=False)
    rec = Circuit.from_qasm(text, u_dialect="recorder", transpile=False)
    assert not np.allclose(spec.ops[0].operand, rec.ops[0].operand)


MALFORMED = [
    "OPENQASM 2.0;",
    "qreg q[2]; frob q[0];",
    "qreg q[1]; rz(import_os) q[0];",
    "qreg q[1]; rz(1 +) q[0];",
    "qreg q[1]; creg c[1]; if (c==1) x q[0];",
    "qreg q[2]; Ctrl-h q[0];",
    "qreg q[2]; h r;",
    "qreg q[2]; qreg p[2];",
    "h q[0];",
    "qreg q[2]; rz q[0];",
    "qreg q[2]; rz(0.1 q[0];",
    "qreg q[2]; cx q[0], p[1];",
]


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_text_raises_reference_message(text):
    with pytest.raises(JQuESTError) as want:
        JCircuit.from_qasm(text)
    with pytest.raises(QuESTError) as got:
        Circuit.from_qasm(text)
    assert str(got.value) == str(want.value)


def test_u_dialect_argument_is_checked():
    with pytest.raises(ValueError, match="u_dialect"):
        Circuit.from_qasm("qreg q[1];", u_dialect="qiskit")


# ---------------------------------------------------------------------------
# export and round trips
# ---------------------------------------------------------------------------

def _dense(c, n):
    q = TS.init_debug_state(TS.create_qureg(n, dtype=np.complex128,
                                            device="cpu"))
    c.apply(q)
    return TS.to_dense(q)


def _same_up_to_phase(a, b, atol):
    k = int(np.argmax(np.abs(a)))
    phase = b[k] / a[k]
    assert abs(abs(phase) - 1.0) < atol
    np.testing.assert_allclose(a * phase, b, atol=atol, rtol=0)


def _named_circuit(cls):
    n = 4
    c = cls(n)
    c.h(0).x(1, 2).y(2).z(3).s(1).t(0)
    c.rx(2, 1.1).ry(3, -0.4).rz(1, 0.5)
    c.cnot(0, 3).swap(1, 3).sqrt_swap(0, 2)
    c.cphase(0.7, 0, 1, 2).phase(2, 0.3).cz(1, 3)
    c.multi_rotate_z((1,), 0.9).multi_rotate_z((0, 2), 0.4)
    c.gate(np.diag([1.0, 1.0j]), (1,), controls=(0,), cstates=(0,))
    c.gate(np.array([[0.6, 0.8], [0.8, -0.6]]), (3,), controls=(2,))
    c.gate(np.kron(M.HADAMARD, M.PAULI_X), (0, 1))
    c.measure(0)
    return c


def test_to_qasm_equals_reference():
    assert _named_circuit(Circuit).to_qasm() == \
        _named_circuit(JCircuit).to_qasm()


@pytest.mark.parametrize("seed", range(3))
def test_to_qasm_from_qasm_round_trip(seed):
    c, _ = _recorder_circuit(seed, n=4)
    # angles pass through %g text (6 significant digits): 25 gates on the
    # debug state (amplitudes up to ~6) stay within 1e-4
    back = Circuit.from_qasm(c.to_qasm(), transpile=False)
    _same_up_to_phase(_dense(c, 4), _dense(back, 4), 1e-4)
    again = Circuit.from_qasm(back.to_qasm(), transpile=False)
    _same_up_to_phase(_dense(back, 4), _dense(again, 4), 1e-4)
