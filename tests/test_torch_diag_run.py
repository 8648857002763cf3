"""S5 and S6 as runs, and the tile skip of phase-only launches.

The kernel (csrc/segment.cu diag_run) applies each maximal run of
consecutive phase (S5) and parity (S6) stages in one pass over a tile:
each element's stage bits come from a 64-bit lane word L and row word R
(bit s of L & R: S5 applies; of L ^ R: S6 takes the minus sign of its
sine). A segment of phase stages only launches just the tiles whose free
row bits hold the value every stage's predicate fixes
(ops.segment.phase_skip). The CUDA code runs only on the card; here:

- run detection (`diag_runs`) and the run word the packer writes (F_RUN),
  runs of 64 and 65 (cut 64 + 1) included;
- the L/R word model (tests/test_torch_segment.py `run_words`) against
  each element's predicate and parity, row masks above bit 15 and row
  ids of 33-qubit states included;
- the skip: the launched tiles are exactly the tiles holding an amplitude
  the segment changes, batched too; the ring and tensor-map models
  (band_plan.ring_schedule, tile_rows, tma_requests) on the skipped
  launch;
- the angle form of long unit-modulus runs: when the packer picks it,
  its turn table, and the kernel's split of each element's turns (lane
  part, row part, mixed stages) equal to the turns summed stage by stage;
- `emulate_kernel` with runs and skip equal to its sequential model
  (every tile, each stage alone) — bit for bit for exact-form runs,
  within 1e-6 x max|amp| where a run takes the angle form — and within
  2e-5 x max|amp| of the plain version;
- the diagonal layer (entry.diag_layer_circuit) and the cz brick through
  the port's compiled_fused on the CPU against the reference's
  compiled_banded and interpret-mode compiled_fused (2e-5 x max|amp|),
  with the same stage lists under TPU_GEOMETRY.
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

from quest_tpu import circuit as JC

from quest_tpu_torch import entry as E
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import segment as S
from tests.test_torch_band_plan import assert_parts_equal, port_parts, ref_parts
from tests.test_torch_segment import (
    _parity_bits, angle_turns, direct_turns, emulate_kernel, launch_tiles,
    run_element_bits, run_words, tile_base)

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (the suite runs several workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _phase(rng, lm, lw, rm, rw):
    t = np.exp(1j * rng.uniform(0, 2 * np.pi))
    return BP.PhaseStage(), np.array(
        [[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15, rw & 0x7FFF,
          rw >> 15]], np.float32)


def _parity(rng, lm, rm):
    h = rng.uniform(0, np.pi)
    return BP.ParityStage(), np.array(
        [[np.cos(h), np.sin(h), lm, rm & 0x7FFF, rm >> 15, 0, 0, 0]],
        np.float32)


def _multiphase(rng):
    return BP.MultiPhaseStage(("a", "p")), np.array(
        [[rng.uniform(-np.pi, np.pi), 0b11, 0, 0, 0, 0, 0, 0],
         [rng.uniform(-np.pi, np.pi), 0b100, 0b1, 0, 0, 0, 0, 0]],
        np.float32)


def _mat(rng, kind, dim, bit=-1):
    g = (rng.standard_normal((2, dim, dim)) / np.sqrt(dim)).astype(np.float32)
    return BP.MatStage(kind, dim, False, (), (), bit), g


def _random_diag(rng, row_bits):
    """A random S5 or S6 stage with masks over the lanes and `row_bits`
    row bits, now and then an empty one."""
    lm = int(rng.integers(0, 128)) * int(rng.integers(0, 4) > 0)
    rm = int(rng.integers(0, 1 << row_bits)) * int(rng.integers(0, 4) > 0)
    if rng.integers(2):
        return _parity(rng, lm, rm)
    return _phase(rng, lm, int(rng.integers(0, 128)) & lm, rm,
                  int(rng.integers(0, 1 << row_bits)) & rm)


def _segment(ops, n, device="cpu"):
    return S.prepare_segment([s for s, _ in ops], [a for _, a in ops], n,
                             device)


def _planes(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# run detection and the packed run word
# ---------------------------------------------------------------------------

P, Q, M, X = S.K_PHASE, S.K_PARITY, S.K_MULTIPHASE, S.K_MAT


@pytest.mark.parametrize("kinds,want", [
    ([P], [(0, 1)]),
    ([Q, Q, X, Q], [(0, 2), (3, 1)]),
    ([P, M, Q, Q, P, X, P, S.K_PAIR, Q, S.K_DIAGVEC, P, P],
     [(0, 1), (2, 3), (6, 1), (8, 1), (10, 2)]),
    ([M, X, S.K_BATCHSEL], []),
    ([P, Q] * 32, [(0, 64)]),
    ([X] + [Q, P] * 32 + [Q], [(1, 64), (65, 1)]),
    ([P] * 130, [(0, 64), (64, 64), (128, 2)]),
], ids=["one", "two_runs", "mixed", "none", "exactly_64", "65_splits",
        "130"])
def test_diag_runs_finds_maximal_runs(kinds, want):
    assert S.diag_runs(kinds) == want


@pytest.mark.parametrize("length", [1, 5, 64, 65])
def test_run_word_is_packed_into_each_run_head(length):
    rng = np.random.default_rng(length)
    ops = ([_mat(rng, "b0", 128), _multiphase(rng)]
           + [_random_diag(rng, 5) for _ in range(length)]
           + [_mat(rng, "sc", 2, bit=4), _random_diag(rng, 5)])
    seg = _segment(ops, 12)
    desc = seg.desc.numpy()
    runs = S.diag_runs(desc[:, S.F_KIND].tolist())
    assert runs[0][0] == 2 and sum(r[1] for r in runs[:-1]) == length
    assert runs[-1] == (len(ops) - 1, 1)
    want = np.zeros(len(ops), np.int64)
    for first, k in runs:
        want[first] = k
    assert np.array_equal(desc[:, S.F_RUN], want)
    assert all(k <= S.MAX_DIAG_RUN for _, k in runs)


# ---------------------------------------------------------------------------
# the L/R word model
# ---------------------------------------------------------------------------


def _direct_bits(descs, ops, lane, row):
    """Each stage's bit per element from its own predicate or parity (the
    kernel before runs): S5 lane and row match; S6 lane parity ^ row
    parity."""
    out = []
    for d in descs:
        g = ops[int(d[S.F_OP_OFF]):]
        if int(d[S.F_KIND]) == S.K_PHASE:
            rm = int(g[4]) | (int(g[5]) << 15)
            rw = int(g[6]) | (int(g[7]) << 15)
            out.append(((lane & int(g[2])) == int(g[3])) & ((row & rm) == rw))
        else:
            rm = int(g[3]) | (int(g[4]) << 15)
            out.append((_parity_bits(lane & int(g[2]))
                        ^ _parity_bits(row & rm)) == 1)
    return out


@pytest.mark.parametrize("n,row_bits,k,seed", [
    (12, 5, 7, 0), (14, 7, 64, 1), (23, 16, 40, 2), (33, 26, 64, 3)],
    ids=["12q", "14q_64", "23q_high_half", "33q"])
def test_run_words_match_each_elements_predicates(n, row_bits, k, seed):
    """Every element of the tiles checked (for 33 qubits, three tiles of
    a launch that is never run here): bit s of run_element_bits equals
    stage s's predicate (S5) or parity (S6); masks reach row bit
    row_bits - 1 (bit 15 and above ride in the operand's high half)."""
    rng = np.random.default_rng(seed)
    ops = [_random_diag(rng, row_bits) for _ in range(k)]
    # a stage every element of some rows matches, in the high half
    ops.append(_phase(rng, 0, 0, 1 << (row_bits - 1), 1 << (row_bits - 1)))
    seg = _segment(ops, n)
    desc = seg.desc.numpy()
    with np.errstate(invalid="ignore"):    # angle tables are int32 bits
        raw = seg.ops.numpy().astype(np.float64)
    e = np.arange(1 << seg.geometry.tile_bits)
    lane = e & 127
    tiles = seg.tiles
    for blk in sorted({0, tiles // 2 + 1, tiles - 1}):
        rows = tile_base(seg, blk) + np.arange(len(e) >> 7)
        for first, length in S.diag_runs(desc[:, S.F_KIND].tolist()):
            descs = desc[first:first + length]
            par, lw, rw = run_words(descs, raw, np.arange(128), rows)
            on = run_element_bits(par, lw[lane], rw[e >> 7])
            for s, want in enumerate(_direct_bits(descs, raw, lane,
                                                  rows[e >> 7])):
                got = (on >> np.uint64(s)) & np.uint64(1)
                assert np.array_equal(got.astype(bool), want), (blk, s)


# ---------------------------------------------------------------------------
# the skip
# ---------------------------------------------------------------------------

SKIP_CASES = [
    # (name, n, stages (lm, lw, rm, rw), fixed mask)
    ("one_free_bit", 16, [(0b1, 0b1, 1 << 8, 1 << 8)], 1 << 8),
    ("two_stages_agree", 17, [(0b10, 0b10, (1 << 9) | (1 << 3), 1 << 9),
                              (0, 0, (1 << 9) | (1 << 7), (1 << 9) | (1 << 7))],
     1 << 9),
    ("disagree", 16, [(0, 0, 1 << 8, 1 << 8), (0, 0, 1 << 8, 0)], 0),
    ("inner_only", 16, [(0b1, 0b1, 0b11, 0b01)], 0),
    ("two_bits_want_0", 17, [(0, 0, (1 << 7) | (1 << 9), 0),
                             (0b100, 0b100, (1 << 7) | (1 << 9) | 1, 1)],
     (1 << 7) | (1 << 9)),
]


def _skip_segment(case):
    _, n, preds, _ = case
    rng = np.random.default_rng(n)
    return _segment([_phase(rng, *p) for p in preds], n), n


@pytest.mark.parametrize("case", SKIP_CASES, ids=lambda c: c[0])
def test_phase_skip_mask(case):
    seg, n = _skip_segment(case)
    assert seg.fixed_mask == case[3]
    assert seg.tiles == seg.geometry.blocks >> bin(case[3]).count("1")
    assert seg.free_mask & seg.fixed_mask == 0
    assert seg.fixed_rows & ~seg.fixed_mask == 0


def test_no_skip_beside_other_stages():
    rng = np.random.default_rng(3)
    for other in (_parity(rng, 1, 1 << 8), _multiphase(rng),
                  _mat(rng, "b0", 128)):
        seg = _segment([_phase(rng, 0, 0, 1 << 8, 1 << 8), other], 16)
        assert seg.fixed_mask == 0 and seg.tiles == seg.geometry.blocks
    assert S.prepare_segment([], [], 16, "cpu").tiles == (
        S.prepare_segment([], [], 16, "cpu").geometry.blocks)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("case", SKIP_CASES, ids=lambda c: c[0])
def test_launched_tiles_are_the_changed_tiles(case, batch):
    """The tiles a launch runs are exactly those holding an amplitude the
    plain version changes (in every state of a batch); emulate_kernel on
    them equals the plain version and leaves every other tile's bytes as
    they were."""
    seg, n = _skip_segment(case)
    shape = (batch, 2, 1 << n) if batch else (2, 1 << n)
    planes = _planes(shape, 5)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n).numpy().reshape(shape)
    changed = np.any((want != planes).reshape(max(1, batch), 2, -1, 128),
                     axis=(0, 1, 3))           # per global row
    geo = seg.geometry
    all_bases = launch_tiles(seg, sequential=True)
    local = np.array(BP.tile_rows(geo, 0)) & ~all_bases[0]
    touched = {b for b in all_bases if changed[b | local].any()}
    assert set(launch_tiles(seg)) == touched
    got = emulate_kernel(planes, seg)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)
    launched = np.zeros(1 << (n - 7), bool)
    for b in launch_tiles(seg):
        launched[b | local] = True
    rows = got.reshape(max(1, batch), 2, -1, 128)
    assert np.array_equal(rows[:, :, ~launched],
                          planes.reshape(rows.shape)[:, :, ~launched])


@pytest.mark.parametrize("case", SKIP_CASES[:2] + SKIP_CASES[-1:],
                         ids=lambda c: c[0])
def test_ring_and_tensor_map_models_of_a_skipped_launch(case):
    """band_plan's models of the skipped launch: tile_rows and
    tma_requests under the skip give the kernel's rows, each holding the
    fixed bits, the launched tiles' rows cover exactly those rows; the
    ring walks tiles x batch steps (each plane loaded and stored once)."""
    seg, n = _skip_segment(case)
    geo, skip = seg.geometry, (seg.fixed_mask, seg.fixed_rows)
    boxes = BP.tma_boxes(geo, 2)
    seen = set()
    for t in range(seg.tiles):
        rows = BP.tile_rows(geo, t, skip)
        assert rows[0] == tile_base(seg, t) and rows == sorted(rows)
        assert all(r & seg.fixed_mask == seg.fixed_rows for r in rows)
        seen.update(rows)
        reqs = BP.tma_requests(boxes, geo, t, skip)
        assert [r[1] for r in reqs] == [
            q * boxes["box_rows"] for q in range(boxes["requests_per_plane"])]
    assert seen == {r for r in range(1 << (n - 7))
                    if r & seg.fixed_mask == seg.fixed_rows}
    for driver in BP.DRIVERS:
        steps = seg.tiles * 2
        slots = BP.ring_slots(geo.tile_bits, steps, driver)
        ev = BP.ring_schedule(driver, steps, slots)
        assert sum(e[0] == "chain" for e in ev) == steps
        assert sorted(e[1] for e in ev if e[0] == "load") == list(
            range(2 * steps))
        assert sorted(e[1] for e in ev if e[0] == "store") == list(
            range(2 * steps))


# ---------------------------------------------------------------------------
# emulate_kernel with runs and skip against its sequential model
# ---------------------------------------------------------------------------


def _emulate_cases():
    rng = np.random.default_rng(11)
    mixed = [_random_diag(rng, 9), _random_diag(rng, 9), _mat(rng, "b0", 128),
             _random_diag(rng, 9), _multiphase(rng), _random_diag(rng, 9),
             _random_diag(rng, 9), _random_diag(rng, 9),
             _mat(rng, "scb", 4, bit=3), _random_diag(rng, 9)]
    long = [_random_diag(rng, 9) for _ in range(65)]
    skip = [_phase(rng, 0b1, 0b1, (1 << 8) | 1, 1 << 8),
            _phase(rng, 0, 0, (1 << 8) | (1 << 2), (1 << 8) | (1 << 2)),
            _phase(rng, 0b110, 0b10, 1 << 8, 1 << 8)]
    exact_long = [_random_diag(rng, 9) for _ in range(7)] + [
        (BP.PhaseStage(), np.array([[1.5, 0.5, 1, 1, 0, 0, 0, 0]],
                                   np.float32))]          # |factor| != 1
    return [("mixed_runs", 16, 0, mixed), ("run_65", 16, 0, long),
            ("skip", 16, 0, skip), ("skip_batched", 16, 3, skip),
            ("mixed_batched", 16, 2, mixed[:8]),
            ("exact_8", 16, 0, exact_long)]


def _angle_runs(seg):
    desc = seg.desc.numpy()
    return [i for i in range(len(desc))
            if desc[i, S.F_RUN] and desc[i, S.F_FORMS] & 1]


@pytest.mark.parametrize("case", _emulate_cases(), ids=lambda c: c[0])
def test_emulated_runs_and_skip_equal_the_sequential_model(case):
    _, n, batch, ops = case
    seg = _segment(ops, n)
    shape = (batch, 2, 1 << n) if batch else (2, 1 << n)
    planes = _planes(shape, 9)
    got = emulate_kernel(planes, seg)
    seq = emulate_kernel(planes, seg, sequential=True)
    if _angle_runs(seg):
        np.testing.assert_allclose(got, seq, atol=1e-6 * np.abs(seq).max(),
                                   rtol=0)
    else:
        assert np.array_equal(got, seq)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n).numpy().reshape(shape)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


# ---------------------------------------------------------------------------
# the angle form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,unit,mixed_ok,want", [
    (7, True, True, False), (8, True, True, True), (64, True, True, True),
    (20, False, True, False), (40, True, False, False)],
    ids=["short", "eight", "sixty_four", "not_unit", "too_mixed"])
def test_angle_form_is_picked_by_the_data(length, unit, mixed_ok, want):
    rng = np.random.default_rng(length)
    ops = []
    for s in range(length):
        lm = 1 << (s % 7)
        rm = (1 << (s % 5)) if (not mixed_ok or s % 3 == 0) else 0
        ops.append(_phase(rng, lm, lm, rm, rm) if s % 2 else
                   _parity(rng, lm, rm))
    if not unit:
        ops[3][1][0, 0] *= 1.001
    seg = _segment(ops, 12)
    head = seg.desc.numpy()[0]
    assert bool(head[S.F_FORMS] & 1) == want and head[S.F_RUN] == length
    if not want:
        return
    tab = seg.ops.numpy().view(np.int32)[int(head[S.F_TARGETS]):][
        :2 * length].astype(np.int64).reshape(-1, 2)
    for (st, arr), (off, d) in zip(ops, tab):
        f = complex(arr[0, 0], arr[0, 1])
        on = np.exp(1j * np.pi * np.int32(np.uint32((off + d) % (1 << 32))
                                          .view(np.int32)) / 2 ** 31)
        off_f = np.exp(1j * np.pi * np.int32(off) / 2 ** 31)
        assert abs(on - f) < 1e-6           # S5: its phase; S6: e^{+ih}
        if isinstance(st, BP.PhaseStage):
            assert off == 0
        else:                               # S6 at parity 0: e^{-ih}
            assert abs(off_f - f.conjugate()) < 1e-6


@pytest.mark.parametrize("n,row_bits,seed", [(12, 5, 0), (16, 9, 1),
                                             (23, 16, 2), (33, 26, 3)])
def test_angle_turns_split_equals_the_stage_sums(n, row_bits, seed):
    """The kernel's split of the turns (lane part, row part, mixed
    stages) equals T_off + bit x D summed stage by stage for every
    element, empty masks and wants outside their masks included."""
    rng = np.random.default_rng(seed)
    ops = [_random_diag(rng, row_bits) for _ in range(40)]
    ops += [_phase(rng, 0, 0, 0, 0), _phase(rng, 0, 0, 0b1, 0b11),
            _phase(rng, 0b1, 0b11, 0, 0), _parity(rng, 0, 0)]
    seg = _segment(ops, n)
    desc, raw = seg.desc.numpy(), seg.ops.numpy()
    heads = _angle_runs(seg)
    assert heads == [0]
    lanes = np.arange(128)
    for blk in sorted({0, seg.tiles // 2, seg.tiles - 1}):
        rows = tile_base(seg, blk) + np.arange(1 << (seg.geometry.tile_bits
                                                     - 7))
        descs = desc[:int(desc[0, S.F_RUN])]
        assert np.array_equal(angle_turns(descs, raw, lanes, rows),
                              direct_turns(descs, raw, lanes, rows))


# ---------------------------------------------------------------------------
# the diagonal layer and the cz brick, end to end
# ---------------------------------------------------------------------------


def _reference_circuit(tc):
    jc = JC.Circuit(tc.num_qubits)
    for op in tc.ops:
        jc._add(op.kind, op.targets, op.operand, op.controls, op.cstates)
    return jc


# (name, n, circuit, against the interpret-mode fused program too): the
# reference's interpreted diagonal layer compiles for ~2 s at 10 qubits and
# minutes from 11, so from there it is held against compiled_banded only
CIRCUITS = [("diag_layer", 10, E.diag_layer_circuit, True),
            ("diag_layer", 12, E.diag_layer_circuit, False),
            ("diag_layer", 14, E.diag_layer_circuit, False),
            ("cz_brick", 13, E.cz_brick_circuit, True),
            ("cz_brick", 14, E.cz_brick_circuit, True)]


@pytest.mark.parametrize("case", CIRCUITS, ids=lambda c: f"{c[0]}_{c[1]}")
def test_diagonal_circuits_match_the_reference(case):
    _, n, build, fused = case
    tc = build(n)
    jc = _reference_circuit(tc)
    planes = _planes((2, 1 << n), n)
    planes /= np.sqrt((planes.astype(np.float64) ** 2).sum()).astype(
        np.float32)
    wants = [np.asarray(jc.compiled_banded(n, False, donate=False)(
        jnp.asarray(planes))).reshape(2, -1)]
    if fused:
        wants.append(np.asarray(jc.compiled_fused(
            n, False, donate=False, interpret=True)(jnp.asarray(planes))
        ).reshape(2, -1))
    want_banded = wants[0]
    prog = tc.compiled_fused(n, device="cpu")
    got = prog(torch.from_numpy(planes.copy())).numpy().reshape(2, -1)
    for want in wants:
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                                   rtol=0)
    # the kernel model of every launch, runs and all
    x = planes
    for seg in prog.segments:
        assert any(k > 1 for k in seg.desc[:, S.F_RUN].tolist())
        x = emulate_kernel(x, seg).astype(np.float32)
    np.testing.assert_allclose(x, want_banded,
                               atol=TOL * np.abs(want_banded).max(), rtol=0)


@pytest.mark.parametrize("case", CIRCUITS, ids=lambda c: f"{c[0]}_{c[1]}")
def test_diagonal_circuit_plans_match_reference(case):
    _, n, build, _ = case
    tc = build(n)
    jc = _reference_circuit(tc)
    ref_raw, ref_swept = ref_parts(jc, n)
    raw, swept = port_parts(tc, n)
    assert_parts_equal(ref_raw, raw)
    assert_parts_equal(ref_swept, swept)


def test_diag_layer_plan_at_28_qubits():
    """The planner's launch of the diagonal layer at 28 qubits: a phase,
    a multiphase, then one run of 28 parity and 24 phase stages; the cz
    brick a multiphase and a run of 12 phases (planning only)."""
    parts, _ = E.diag_layer_circuit(28).fused_parts(28)
    assert [p[0] for p in parts] == ["segment"]
    kinds = [type(s).__name__ for s in parts[0][1]]
    assert kinds == (["PhaseStage", "MultiPhaseStage"] + ["ParityStage"] * 28
                     + ["PhaseStage"] * 24)
    parts, _ = E.cz_brick_circuit(28).fused_parts(28)
    assert [type(s).__name__ for s in parts[0][1]] == (
        ["MultiPhaseStage"] + ["PhaseStage"] * 12)
