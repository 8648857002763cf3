"""What decides `correct`, on the CPU at a width a test run holds: sound
runs pass every cell's committed limits; the control (the reference at
TF32 in the program's place) and each fault planted under the timed path
fail them."""

import time
from pathlib import Path

import pytest
import torch

from portbench import harness, readings

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["sv30.rcs_d20", "dm14.noisy_rcs_d3", "sv30.tfim_quench"]


def small(name):
    cell = harness.load_cell(name, ROOT)
    return 5 if cell.config["register"] == "density" else 11


def run(name, seed=2 ** 31 + 7):
    return harness.run_cell(name, seed, 0.3, False, root=ROOT,
                            t_start=time.time(), device="cpu",
                            qubits=small(name))


def within(nums, limits):
    return all(v <= limits[k] for k, v in nums.items())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 32 + 9])
def test_sound_runs_are_correct(name, seed):
    r = run(name, seed)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = harness.load_cell(name, ROOT)
    for seed in (11, 12, 2 ** 31 + 13):
        nums = readings.control_reading(cell, seed, 2, "cpu", small(name))
        assert not within(nums, cell.limits), nums


def _unchanged(monkeypatch):
    from quest_tpu_torch import circuit
    monkeypatch.setattr(circuit.FusedProgram, "__call__",
                        lambda self, amps: amps)


def _half_xeb(monkeypatch):
    from quest_tpu_torch import calculations as K
    real = K.calc_linear_xeb
    monkeypatch.setattr(K, "calc_linear_xeb",
                        lambda q, s: real(q, s[: len(s) // 2]))


def _altered_sample(monkeypatch):
    from quest_tpu_torch import measurement as MS
    real = MS.sample

    def sample(q, shots, gen):
        s = real(q, shots, gen)
        s[0] = (s[0] + q.num_amps // 2) % q.num_amps
        return s
    monkeypatch.setattr(MS, "sample", sample)


def _altered_xeb(monkeypatch):
    from quest_tpu_torch import calculations as K
    real = K.calc_linear_xeb
    monkeypatch.setattr(K, "calc_linear_xeb",
                        lambda q, s: real(q, s) * (1 + 1e-2))


def _half_purity(monkeypatch):
    from quest_tpu_torch import calculations as K

    def purity(q):
        flat = q.amps.reshape(-1)
        half = flat[: flat.numel() // 2].to(torch.float64)
        return float(2 * (half * half).sum())
    monkeypatch.setattr(K, "calc_purity", purity)


def _altered_purity(monkeypatch):
    from quest_tpu_torch import calculations as K
    real = K.calc_purity
    monkeypatch.setattr(K, "calc_purity", lambda q: real(q) * (1 + 1e-3))


def _half_terms(monkeypatch):
    from quest_tpu_torch import calculations as K
    real = K.calc_expec_pauli_sum

    def expec(q, codes, coeffs):
        m = len(coeffs) // 2
        return 2 * real(q, codes[:m], coeffs[:m])
    monkeypatch.setattr(K, "calc_expec_pauli_sum", expec)


def _altered_energy(monkeypatch):
    from quest_tpu_torch import calculations as K
    real = K.calc_expec_pauli_sum
    monkeypatch.setattr(K, "calc_expec_pauli_sum",
                        lambda q, c, w: real(q, c, w) * (1 + 1e-3))


FAULTS = [
    ("sv30.rcs_d20", _unchanged), ("sv30.rcs_d20", _half_xeb),
    ("sv30.rcs_d20", _altered_sample), ("sv30.rcs_d20", _altered_xeb),
    ("dm14.noisy_rcs_d3", _unchanged), ("dm14.noisy_rcs_d3", _half_purity),
    ("dm14.noisy_rcs_d3", _altered_purity),
    ("sv30.tfim_quench", _unchanged), ("sv30.tfim_quench", _half_terms),
    ("sv30.tfim_quench", _altered_energy),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run(name)
    assert r["correct"] is False, r["checks"]
    assert r["checks"], "the comparison has to run and fail, not crash"
