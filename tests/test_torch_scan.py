"""The scan over repeated kernel segments (QUEST_FUSED_SCAN, ROADMAP A4.4).

`_scan_partition` equals the reference's (quest_tpu/circuit.py:482) on
tests/test_pallas.py's fixture and on real swept plans; under
QUEST_FUSED_SCAN=1 the fused engine builds the same segments (each one
launch with its own operands, so a group has nothing to share until a
CUDA graph runs it), and the program's planes are bit for bit the
unscanned program's (plain version on the CPU); the knob is keyed, so a
flip builds a new program."""

import numpy as np
import pytest
import torch

from quest_tpu.circuit import _scan_partition as ref_scan_partition

from quest_tpu_torch import circuit as TC
from quest_tpu_torch import entry as E
from quest_tpu_torch import env as TE

from .test_torch_comm import _one_thread_per_worker  # noqa: F401

pytestmark = pytest.mark.dtype_agnostic


def test_scan_partition_fixture_equals_reference():
    sA, sB = ("stageA",), ("stageB",)
    parts = [("segment", sA, [1]), ("segment", sA, [2]),
             ("segment", sA, [3]), ("sharded-ish", None),
             ("segment", sB, [4]), ("segment", sB, [5]),
             ("segment", sA, [6])]
    for scan_min in (0, 1, 2, 3, 4):
        assert (TC._scan_partition(parts, scan_min)
                == ref_scan_partition(parts, scan_min))
    out = TC._scan_partition(parts, 3)
    assert out[0] == ("scan", sA, [[1], [2], [3]])
    assert all(g[0] == "one" for g in out[1:])


@pytest.mark.parametrize("name,circuit,n,iters", [
    ("diag12x8", E.diag_layer_circuit(12), 12, 8),
    ("qft12", TC.qft_circuit(12), 12, 1),
    ("rcs14", TC.random_circuit(14, 4, seed=2), 14, 3)])
def test_scan_partition_of_swept_plans_equals_reference(name, circuit, n,
                                                        iters):
    parts, _ = circuit.fused_parts(n, iters)

    def shape(groups):
        return [(g[0], len(g[2]) if g[0] == "scan" else 1) for g in groups]
    assert (shape(TC._scan_partition(parts, 3))
            == shape(ref_scan_partition(parts, 3)))


@pytest.mark.parametrize("case", ["diag12x8", "cz12x8", "qft12", "rcs12x3"])
def test_scanned_program_is_bit_for_bit_unscanned(case, monkeypatch):
    circuit, n, iters = {
        "diag12x8": (E.diag_layer_circuit(12), 12, 8),
        "cz12x8": (E.cz_brick_circuit(12), 12, 8),
        "qft12": (TC.qft_circuit(12), 12, 1),
        "rcs12x3": (TC.random_circuit(12, 2, seed=1), 12, 3)}[case]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1 << n)).astype(np.float32))
    progs, outs = {}, {}
    for flag in ("0", "1"):
        monkeypatch.setenv("QUEST_FUSED_SCAN", flag)
        progs[flag] = p = circuit.compiled_fused(n, iters=iters,
                                                 device="cpu")
        outs[flag] = p(x.clone())
        assert torch.equal(p.plain(x.clone()), outs[flag])
    assert progs["0"] is not progs["1"]          # keyed knob
    assert torch.equal(outs["0"], outs["1"])
    off, on = progs["0"], progs["1"]
    assert on.launches_per_call == off.launches_per_call
    assert len(on.segments) == len(off.segments)
    for a, b in zip(on.segments, off.segments):
        assert torch.equal(a.desc, b.desc) and torch.equal(a.ops, b.ops)
    if case == "diag12x8":
        parts, _ = circuit.fused_parts(n, iters)
        groups = TC._scan_partition(parts, TC.SCAN_MIN)
        assert [g[0] for g in groups] == ["scan"]
        assert len(groups[0][2]) == len(on.segments) > 1


def test_scan_knob_is_keyed(monkeypatch):
    monkeypatch.setenv("QUEST_FUSED_SCAN", "1")
    assert ("QUEST_FUSED_SCAN", True) in TE.engine_mode_key()
    monkeypatch.setenv("QUEST_FUSED_SCAN", "2")
    with pytest.raises(ValueError, match="QUEST_FUSED_SCAN"):
        TE.knob_value("QUEST_FUSED_SCAN")
