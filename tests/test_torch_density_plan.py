"""Density-register plans: the port's planners against the reference's.

Under TPU_GEOMETRY, quest_tpu_torch.ops.band_plan must emit exactly the
stage lists and operand arrays of quest_tpu.ops.pallas_band (segment_plan
and sweep_plan) for the density circuits of the slice — the repo bench's
density scenario, its noisy-RCS trajectory circuit and a Clifford+T
circuit with damping — including every PairStage field and the
DiagVecStage tables. Under HOPPER_GEOMETRY, the plans of the three entry
circuits at 14 and 15 qubits (28 and 30 state qubits) keep every Kraus
pair inside the kernel: the only passthrough left is the 4-target
superoperator of the bench's two-qubit depolarising channel, which the
reference also runs outside its kernel.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import bench
from quest_tpu import circuit as JC
from quest_tpu.ops import fusion as JF
from quest_tpu.ops import pallas_band as PB

from quest_tpu_torch import entry as TE
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as TF
from quest_tpu_torch.ops import segment as S

pytestmark = pytest.mark.dtype_agnostic


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


def reference_clifford_t(nd):
    """The reference-package build of entry.clifford_t_density_circuit."""
    c = JC.Circuit(nd)
    for q in range(nd):
        c.h(q)
    for q in range(nd):
        c.t(q)
    for q in range(0, nd - 1, 2):
        c.cnot(q, q + 1)
    for q in range(nd):
        c.s(q)
    for q in range(nd):
        c.damping(q, 0.1)
    return c


CIRCUITS = {
    "bench_density": (bench._build_density_circuit, TE.bench_density_circuit),
    "noisy_rcs": (lambda nd: bench._build_traj_circuit(nd, 3),
                  lambda nd: TE.noisy_rcs_circuit(nd, 3)),
    "clifford_t": (reference_clifford_t, TE.clifford_t_density_circuit),
}


def _stage_key(st):
    return (type(st).__name__, dataclasses.astuple(st))


def _item_key(it):
    if hasattr(it, "op"):
        op = it.op
        return (type(it).__name__, op.kind, tuple(op.targets),
                tuple(op.controls))
    return (type(it).__name__, it.ql, it.w, tuple(it.preds))


def assert_parts_equal(ref, port):
    assert [p[0] for p in ref] == [p[0] for p in port]
    for a, b in zip(ref, port):
        if a[0] != "segment":
            assert _item_key(a[1]) == _item_key(b[1])
            continue
        assert [_stage_key(s) for s in a[1]] == [_stage_key(s) for s in b[1]]
        assert len(a[2]) == len(b[2])
        for x, y in zip(a[2], b[2]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def ref_parts(jc, n):
    items = JF.plan(jc._planned_flat(n, True), n, bands=PB.plan_bands(n))
    raw = PB.segment_plan(items, n)
    return raw, PB.sweep_plan(raw, n)


def port_parts(tc, n, budgets=BP.TPU_GEOMETRY):
    items = TF.plan(tc._planned_flat(n, True), n, bands=BP.plan_bands(n))
    raw = BP.segment_plan(items, n, budgets=budgets)
    return raw, BP.sweep_plan(raw, n, budgets=budgets)


def _kinds(parts):
    return {S.stage_label(st) for p in parts if p[0] == "segment"
            for st in p[1]}


@pytest.mark.parametrize("name,nd", [("bench_density", 8), ("bench_density", 9),
                                     ("noisy_rcs", 7), ("noisy_rcs", 8),
                                     ("noisy_rcs", 9), ("noisy_rcs", 10),
                                     ("clifford_t", 8)])
def test_tpu_plans_match_reference(name, nd):
    build_ref, build_port = CIRCUITS[name]
    jc, tc = build_ref(nd), build_port(nd)
    n = 2 * nd
    ref_raw, ref_swept = ref_parts(jc, n)
    raw, swept = port_parts(tc, n)
    assert_parts_equal(ref_raw, raw)
    assert_parts_equal(ref_swept, swept)
    assert "pair" in _kinds(swept)
    if name == "clifford_t":
        assert "diagvec" in _kinds(swept)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_port_circuits_are_the_reference_circuits(name):
    build_ref, build_port = CIRCUITS[name]
    jc, tc = build_ref(8), build_port(8)
    assert len(jc.ops) == len(tc.ops)
    for a, b in zip(jc.ops, tc.ops):
        assert (a.kind, a.targets, a.controls, a.cstates) == (
            b.kind, b.targets, b.controls, b.cstates)
        assert np.array_equal(np.asarray(a.operand), np.asarray(b.operand))
        if a.kind == "superop":
            assert a.meta[0] == b.meta[0] == "kraus"
            assert all(np.array_equal(x, y)
                       for x, y in zip(a.meta[1], b.meta[1]))


@pytest.mark.parametrize("name,nd", [(name, nd) for name in sorted(CIRCUITS)
                                     for nd in (14, 15)])
def test_hopper_plans_keep_every_pair_in_the_kernel(name, nd):
    build_ref, build_port = CIRCUITS[name]
    tc = build_port(nd)
    n = 2 * nd
    parts, _ = tc.fused_parts(n, density=True)
    passthroughs = [p[1] for p in parts if p[0] != "segment"]
    for it in passthroughs:
        assert isinstance(it, TF.PassOp) and it.op.kind == "matrix"
        assert len(it.op.targets) == 4
    # the reference passes the same ops through (4-target superops)
    ref_raw, _ = ref_parts(build_ref(nd), n)
    ref_pass = sorted(_item_key(p[1]) for p in ref_raw if p[0] != "segment")
    assert sorted(_item_key(it) for it in passthroughs) == ref_pass
    if name != "bench_density":
        assert not passthroughs
    pairs = [st for p in parts if p[0] == "segment" for st in p[1]
             if isinstance(st, BP.PairStage)]
    one_qubit = sum(1 for op in tc.ops
                    if op.kind == "superop" and len(op.targets) == 1)
    assert len(pairs) == one_qubit
    for st in pairs:
        assert st.op_kind in ("lane", "sub", "sc")
        if st.op_kind == "sub":
            assert st.op_bit <= 5
        if st.op_kind == "sc" and st.op_bit < 7:
            assert st.op_bit == 6
    for p in parts:
        if p[0] == "segment":
            geo = BP.segment_geometry(p[1], n)
            assert geo.tile_bits <= S.MAX_TILE_BITS
            assert geo.tile_bits >= 10


def test_hopper_lowering_is_chosen_by_the_row_budget():
    """The same channel keeps the reference's b1 form under a budget
    that holds 8 row bits and becomes sub/sc butterflies under Hopper's
    7."""
    tc = TE.noisy_rcs_circuit(14, 1)
    n = 28
    raw_tpu, _ = port_parts(tc, n, BP.TPU_GEOMETRY)
    raw_hop, _ = port_parts(tc, n, BP.HOPPER_GEOMETRY)

    def ops(parts):
        return sorted({st.op_kind for p in parts if p[0] == "segment"
                       for st in p[1] if isinstance(st, BP.PairStage)})
    assert ops(raw_tpu) == ["b1", "lane"]
    assert ops(raw_hop) == ["lane", "sc", "sub"]
