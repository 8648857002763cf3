"""The port's planners against the reference's.

Under TPU_GEOMETRY, quest_tpu_torch.ops.band_plan must emit exactly the
stage lists and operand arrays of quest_tpu.ops.pallas_band (segment_plan
and sweep_plan) for the RCS, QFT and band-engine circuits. Under
HOPPER_GEOMETRY every planned tile must fit one thread block's shared
memory."""

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

from quest_tpu import circuit as JC
from quest_tpu.ops import fusion as JF
from quest_tpu.ops import pallas_band as PB

import quest_tpu_torch.circuit as TC
from quest_tpu_torch import convert
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as TF

pytestmark = pytest.mark.dtype_agnostic


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """The suite runs several workers side by side. One BLAS thread per
    core per worker (OpenBLAS spins while it waits) oversubscribes the CPU:
    six workers planning at once measured 30x slower each, and starve the
    timing-sensitive tests of the other workers. Pin numpy's BLAS and
    torch to one thread while this module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _stage_key(st):
    return (type(st).__name__, dataclasses.astuple(st))


def _item_key(it):
    """Structure of a passthrough item, comparable across packages."""
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


def ref_parts(jc, n, scheduled=True, scatter_max=PB.SCATTER_MAX):
    flat = jc._planned_flat(n, False) if scheduled else jc.ops
    items = JF.plan(flat, n, bands=PB.plan_bands(n))
    raw = PB.segment_plan(items, n, scatter_max)
    return raw, PB.sweep_plan(raw, n)


def port_parts(tc, n, scheduled=True, scatter_max=PB.SCATTER_MAX):
    flat = tc._planned_flat(n, False) if scheduled else tc.ops
    items = TF.plan(flat, n, bands=BP.plan_bands(n))
    raw = BP.segment_plan(items, n, budgets=dataclasses.replace(
        BP.TPU_GEOMETRY, scatter_max=scatter_max))
    return raw, BP.sweep_plan(raw, n, budgets=BP.TPU_GEOMETRY)


@pytest.mark.parametrize("n,depth", [(10, 4), (12, 4), (14, 4), (20, 4),
                                     (22, 2), (22, 4)])
def test_random_circuit_plans_match_reference(n, depth):
    jc = JC.random_circuit(n, depth, seed=7)
    tc = TC.random_circuit(n, depth, seed=7)
    ref_raw, ref_swept = ref_parts(jc, n)
    raw, swept = port_parts(tc, n)
    assert_parts_equal(ref_raw, raw)
    assert_parts_equal(ref_swept, swept)


def test_cnot_random_circuit_plan_matches_reference():
    jc = JC.random_circuit(12, 3, seed=3, entangler="cnot")
    tc = TC.random_circuit(12, 3, seed=3, entangler="cnot")
    for scheduled in (True, False):
        ref = ref_parts(jc, 12, scheduled)
        port = port_parts(tc, 12, scheduled)
        assert_parts_equal(ref[0], port[0])
        assert_parts_equal(ref[1], port[1])


def test_qft_plan_matches_reference():
    jc, tc = JC.qft_circuit(10), TC.qft_circuit(10)
    for scheduled in (True, False):
        ref = ref_parts(jc, 10, scheduled)
        port = port_parts(tc, 10, scheduled)
        assert_parts_equal(ref[0], port[0])
        assert_parts_equal(ref[1], port[1])


def _band_circuits():
    """(name, n, builder, scatter_max) — the circuits of
    tests/test_pallas.py, built on the reference's Circuit."""
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
    m9 = np.random.default_rng(9)
    nonu = ((m9.standard_normal((4, 4)) + 1j * m9.standard_normal((4, 4)))
            @ np.diag([1.0, 0.8, 0.9, 1.0]))

    def band0(c):
        for q in range(7):
            c.h(q)
        c.cnot(0, 1).z(2).s(3).t(4)

    def row_gates(c):
        for q in (7, 8, 9):
            c.h(q).ry(q, 0.37).s(q).phase(q, 0.41)

    def phases(c):
        c.rz(2, 0.3).rz(8, 0.5).multi_rotate_z((1, 5, 9), 0.7)
        c.cz(0, 1).cz(2, 9).cz(7, 8)

    def controls(c):
        c.x(0, 3).x(1, 8).x(9, 2).x(7, 9)

    def kak(c):
        c.h(0).gate(u, (3, 8)).h(9)

    def scattered(c):
        c.h(0).ry(14, 1.4).ry(15, 1.5)

    def sparse(c):
        c.h(16).ry(15, 0.3).ry(16, 0.7).cz(15, 16)

    def full_band(c):
        for q in range(14, 21):
            c.ry(q, 0.1 * (q - 13))
        c.cz(13, 14).h(2).ry(9, 0.3).x(21, 15)

    def overflow(c):
        c.h(14).h(20).h(21)

    def multi_block(c):
        c.h(0).h(8).rz(16, 0.3).s(7).x(1, 16).cz(2, 15)

    def scat_pair(c):
        c.h(0)._add("matrix", (14, 21), nonu.astype(np.complex128))

    def deep(c):
        r = np.random.default_rng(7)
        for d in range(60):
            for q in range(12):
                c.rx(q, float(r.uniform(0, 2 * np.pi)))
            for q in range(d % 2, 11, 2):
                c.cz(q, q + 1)

    return [("band0", 10, band0, None), ("row_gates", 10, row_gates, None),
            ("phases", 10, phases, None), ("controls", 10, controls, None),
            ("kak", 10, kak, None), ("scattered", 16, scattered, None),
            ("sparse", 23, sparse, None), ("full_band", 23, full_band, None),
            ("overflow", 23, overflow, 7), ("oversized", 23, overflow, 5),
            ("multi_block", 17, multi_block, None),
            ("scat_pair", 23, scat_pair, None), ("deep", 12, deep, None)]


@pytest.mark.parametrize("case", _band_circuits(), ids=lambda c: c[0])
def test_band_circuit_plans_match_reference(case):
    _, n, build, scatter_max = case
    jc = JC.Circuit(n)
    build(jc)
    tc = convert.circuit_from_ops(jc.ops, n)
    scatter_max = scatter_max or PB.SCATTER_MAX
    for scheduled in (False, True):
        ref = ref_parts(jc, n, scheduled, scatter_max)
        port = port_parts(tc, n, scheduled, scatter_max)
        assert_parts_equal(ref[0], port[0])
        assert_parts_equal(ref[1], port[1])


def test_geometry_matches_reference():
    """segment_geometry under TPU_GEOMETRY equals the reference's."""
    for n, depth in [(12, 4), (20, 4), (22, 2), (28, 4)]:
        jc = JC.random_circuit(n, depth, seed=7)
        tc = TC.random_circuit(n, depth, seed=7)
        for rpart, part in zip(ref_parts(jc, n)[1], port_parts(tc, n)[1]):
            ref = PB.segment_geometry(rpart[1], n)
            geo = BP.segment_geometry(part[1], n, budgets=BP.TPU_GEOMETRY)
            assert (geo.scat, geo.inner_bits, geo.gaps) == (
                ref.scat, ref.inner_bits, ref.gaps)
            assert geo.rows_eff == ref.rows_eff


SMEM_PER_BLOCK = 232448      # H100: 227 KB of dynamic shared memory


def test_tpu_budgets_are_the_reference_constants():
    g = BP.TPU_GEOMETRY
    assert g.rows_eff_bits == PB.ROWS_EFF_BITS
    assert g.max_block_row_bits == PB.max_block_row_bits()
    assert g.scatter_max == PB.SCATTER_MAX
    assert g.max_segment_stages == PB.MAX_SEGMENT_STAGES
    assert g.max_sweep_stages == PB.MAX_SWEEP_STAGES
    assert g.sweep_operand_bytes == PB.sweep_operand_budget()


@pytest.mark.parametrize("n,depth", [(10, 4), (12, 4), (14, 4), (20, 4),
                                     (22, 4), (28, 4), (29, 3), (30, 20)])
def test_hopper_tiles_fit_shared_memory(n, depth):
    from quest_tpu_torch.ops import segment as S
    g = BP.HOPPER_GEOMETRY
    assert g.tile_bytes == 128 * 1024
    tc = TC.random_circuit(n, depth, seed=7)
    parts, _ = tc.fused_parts(n)
    assert parts and all(p[0] == "segment" for p in parts)
    for _, stages, arrays in parts:
        geo = BP.segment_geometry(stages, n)
        assert geo.tile_bits <= 7 + g.max_block_row_bits
        assert 2 * 4 * (1 << geo.tile_bits) <= g.tile_bytes
        smem = 2 * 4 * (1 << S.MAX_TILE_BITS) + 4 * (128 + 3 * S.MAX_MULTIPHASE_ROWS)
        assert smem <= SMEM_PER_BLOCK
        assert len(stages) <= g.max_sweep_stages
        assert sum(a.nbytes for a in arrays) <= g.sweep_operand_bytes
