"""quest_tpu_torch.profiling on the CPU: trace / annotate, the counted
work of op_metrics, the stage report's probe segments and its CPU path.

op_metrics counts each launch a call makes by the rules every bound in
PERF.md comes from; on the flagship plan and on 30q d20's plan it must
equal the counts chip_smoke.py computed before the rules moved into the
package (pinned below, from the tree before the move: bytes, fp32 and
bf16 operations, bound ms), launch for launch. Under TPU_GEOMETRY the
stage report's probe segments are the reference's
(quest_tpu.profiling._single_segment).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import profiling as JP

import chip_smoke
from quest_tpu_torch import profiling as P
from quest_tpu_torch.circuit import random_circuit
from quest_tpu_torch.entry import flagship_circuit, wide_gates_circuit
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.state import fused_state_shape

pytestmark = pytest.mark.dtype_agnostic

CPU = "cpu"

# (bytes, fp32 operations, bf16 tensor operations, bound ms, bound by,
# launches) of one call, as chip_smoke.py counted them before the move
PINNED = {
    "flagship": (38656278816, 3172101783552.0, 0.0, 47.344802739582086,
                 "operations", 9),
    "rcs30_d20": (790280407520, 53856205537280.0, 0.0, 803.8239632429851,
                  "operations", 46),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (the suite runs several workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _stage_key(st):
    return (type(st).__name__, dataclasses.astuple(st))


# ---------------------------------------------------------------------------
# trace / annotate
# ---------------------------------------------------------------------------


def test_trace_and_annotate_write_the_region(tmp_path):
    with P.trace(str(tmp_path / "tr"), device=CPU) as tr:
        with P.annotate("quest-region"):
            x = torch.randn(64, 64) @ torch.randn(64, 64)
        assert tr.path is None
    assert x.shape == (64, 64)
    assert os.path.dirname(tr.path) == str(tmp_path / "tr")
    assert tr.path.endswith(".pt.trace.json")
    events = json.load(open(tr.path))["traceEvents"]
    region = [e for e in events if e.get("name") == "quest-region"]
    assert region and region[0]["cat"] == "user_annotation"
    # no device on the CPU: the region launched no kernel
    assert P.annotated_kernels(tr.path, "quest-region") == []
    with pytest.raises(ValueError, match="no region"):
        P.annotated_kernels(tr.path, "absent")


def test_annotated_kernels_reads_correlated_launches(tmp_path):
    """A kernel belongs to the region its launch call lies in (matched
    by correlation id), wherever the device ran it; a kernel with no
    launch record counts by its own span."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "r", "ts": 100,
           "dur": 50},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 110, "dur": 2, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 300, "dur": 2, "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 400, "dur": 9,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120, "dur": 9,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "k3", "ts": 130, "dur": 9,
           "args": {"correlation": 3}},
          {"ph": "X", "cat": "kernel", "name": "k4", "ts": 145, "dur": 9,
           "args": {"correlation": 4}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert [e["name"] for e in P.annotated_kernels(str(path), "r")] \
        == ["k3", "k1"]


def test_trace_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with P.trace(str(tmp_path)):
            pass


def test_annotate_outside_a_trace_is_a_plain_region():
    with P.annotate("nothing-recording"):
        y = torch.ones(3).sum()
    assert float(y) == 3.0


# ---------------------------------------------------------------------------
# op_metrics: counted, not measured
# ---------------------------------------------------------------------------


def _program(name):
    if name == "flagship":
        return flagship_circuit(28).compiled_fused(28, device=CPU), 28
    return random_circuit(30, 20, seed=7, entangler="cz").compiled_fused(
        30, device=CPU), 30


@pytest.mark.parametrize("name", sorted(PINNED))
def test_op_metrics_equals_the_counts_before_the_move(name):
    fn, n = _program(name)
    m = P.op_metrics(fn, torch.empty(fused_state_shape(n), device="meta"))
    nbytes, flops, tc, ms, by, launches = PINNED[name]
    assert (m["bytes accessed"], m["fp32_flops"], m["tensor_flops"]) \
        == (nbytes, flops, tc)
    assert (m["bound_ms"], m["bound_by"], m["segment_launches"]) \
        == (ms, by, launches)
    assert m["flops"] == flops + tc
    assert m["optimal_seconds"] == ms / 1e3
    assert P.program_bound(fn) == (ms, by)
    assert chip_smoke.program_bound(fn) == (ms, by)
    assert fn.launches_per_call == launches


def test_chip_smoke_counts_with_the_package_rules():
    for name in ("segment_work", "bound_ms", "bound_of", "program_bound",
                 "passthrough_work", "xla_bound", "xla_item_work",
                 "HBM_BYTES_PER_S"):
        assert getattr(chip_smoke, name) is getattr(P, name), name


def _mixed_circuit(n):
    """entry.wide_gates_circuit: kernel segments with 5- and 6-target and
    a controlled 2-target matrix between them, which no stage reaches
    (passthroughs on the fused engine)."""
    return wide_gates_circuit(n, depth=2)


def test_op_metrics_dry_and_real_counts_agree():
    """A plan with passthroughs: the dry count (meta planes) equals the
    count of a real call on CPU planes, and program_bound's."""
    n = 12
    fn = _mixed_circuit(n).compiled_fused(n, device=CPU)
    passes = [s for s in fn.steps if not hasattr(s, "stages")]
    assert passes, "the plan holds no passthrough"
    dry = P.op_metrics(fn, torch.empty((2, 1 << n), device="meta"))
    amps = torch.zeros((2, 1 << n))
    amps[0, 0] = 1.0
    real = P.op_metrics(fn, amps)
    assert dry == real
    assert real["passthroughs"] == len(passes) * fn.loop_iters
    assert real["segment_launches"] == fn.launches_per_call
    assert (real["bound_ms"], real["bound_by"]) == P.program_bound(fn)
    assert abs(float((amps.double() ** 2).sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("engine", ["pergate", "banded"])
def test_op_metrics_counts_xla_engine_calls(engine):
    n = 11
    c = _mixed_circuit(n)
    fn = (c.compiled(n, device=CPU) if engine == "pergate"
          else c.compiled_banded(n, device=CPU))
    m = P.op_metrics(fn, torch.empty((3, 2, 1 << n), device="meta"))
    _, nbytes, flops, tc = P.xla_program_work(fn, 4, 3)
    assert (m["xla_calls"], m["bytes accessed"], m["fp32_flops"],
            m["tensor_flops"]) == (1, nbytes, flops, tc)
    assert m["segment_launches"] == m["passthroughs"] == 0


# ---------------------------------------------------------------------------
# the stage report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [15, 22])
def test_probe_segments_are_the_references_under_tpu_geometry(n):
    ref = JP._stage_cases(n)
    port = P._stage_cases(n)
    assert [label for label, _ in port] == [label for label, _ in ref]
    if n == 22:
        assert [label for label, _ in port] == [
            "phase (DMA floor)", "b0", "b1", "scb", "sc"]
    for (label, jc), (_, tc) in zip(ref, port):
        js, ja = JP._single_segment(jc.ops, n)
        ts, ta = P._single_segment(tc.ops, n, budgets=BP.TPU_GEOMETRY)
        assert [_stage_key(s) for s in ts] == [_stage_key(s) for s in js], \
            label
        assert len(ta) == len(ja)
        for x, y in zip(ja, ta):
            assert np.array_equal(np.asarray(x), np.asarray(y)), label


@pytest.mark.parametrize("n", [12, 30])
def test_probe_segments_plan_into_one_segment_on_hopper(n):
    for label, circ in P._stage_cases(n):
        stages, arrays = P._single_segment(circ.ops, n)
        assert stages and len(stages) == len(arrays), label


def test_stage_report_on_the_cpu_gives_no_verdict():
    out = io.StringIO()
    rec = P.stage_report(n=12, reps=2, out=out, device=CPU, check=True)
    text = out.getvalue()
    assert "CAUTION: CPU host" in text
    assert list(rec) == ["phase (DMA floor)", "b0", "b1"]
    for label, r in rec.items():
        assert r["verdict"] == "n/a (plain version on the CPU)"
        assert r["model_lo_ms"] <= r["model_hi_ms"]
        assert r["max_abs_err"] == 0.0 and abs(r["norm"] - 1.0) < 1e-5
        assert f"[stage_report] {label}" in text
        assert ("compute_adder_ms" in r) == (label != P.FLOOR_CASE)
    assert "DMA floor" in text.splitlines()[-1]


def test_stage_report_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.stage_report(n=12)
    with pytest.raises(ValueError, match="below the kernel tier"):
        P.stage_report(n=8, device=CPU)


def test_profiling_cli_on_the_cpu(capsys):
    P._main(["--n", "10", "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "n=10" in out and "n/a (plain version on the CPU)" in out
