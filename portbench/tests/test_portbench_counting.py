"""The counting rules pinned on small cases counted by hand."""

import pytest

from portbench import counting


def test_statevector_gates_by_hand():
    # 3 qubits, 8 amplitudes: rx 8*8*2 = 128, rz 6*8 = 48, cz 48
    gates = [("rx", 0, 0.1), ("rz", 1, 0.2), ("cz", 0, 1)]
    w = counting.circuit_work(gates, 3, False, reads=1)
    assert w["flops"] == 128 + 48 + 48
    assert w["bytes"] == 8 * 8 * 3          # written, read, one readout


def test_density_gates_by_hand():
    # 2 qubits, 4 state bits, 16 entries: ry and each channel 8*16*4 = 512
    gates = [("ry", 0, 0.3), ("depolarising", 1, 0.02), ("damping", 0, 0.05),
             ("cz", 0, 1), ("rz", 1, 1.0)]
    w = counting.circuit_work(gates, 4, True, reads=1)
    assert w["flops"] == 3 * 512 + 2 * 6 * 16
    assert w["bytes"] == 8 * 16 * 3


def test_quench_by_hand():
    ham = {"couplings": [(0, 1, -1.0), (1, 2, -1.0), (2, 0, -1.0)],
           "fields": [(0, -0.7), (1, -0.7), (2, -0.7)]}
    # a step: 3 ZZ twice (6 * 8 each) and 3 X once (16 * 8 each)
    w = counting.quench_work(ham, 3, steps=4, energies=5)
    assert w["flops"] == 4 * (6 * 6 * 8 + 3 * 16 * 8)
    assert w["bytes"] == 8 * 8 * (2 + 5)


def test_least_time_takes_the_larger_bound():
    peaks = counting.PEAKS
    flops_bound = {"flops": 67e12, "bytes": 1.0}
    bytes_bound = {"flops": 1.0, "bytes": 3.35e12}
    assert counting.least_seconds(flops_bound) == pytest.approx(
        67e12 / peaks["fp32_flops_per_s"])
    assert counting.least_seconds(bytes_bound) == pytest.approx(
        3.35e12 / peaks["hbm_bytes_per_s"])
    assert peaks["power_limit_w"] == 700 and "data sheet" in peaks["source"]


def test_unknown_gate_has_no_rule():
    with pytest.raises(ValueError):
        counting.circuit_work([("swap", 0, 1)], 2, False, reads=0)
