"""The segment drivers K1 (decoupled), K2 (in place) and K3 (grid) on the
CPU: their knobs, the planning half of their schedule against the
reference's, the port's ring model, and the plain path under every
driver against the reference's interpreted kernel.

Under TPU_GEOMETRY, for each knob setting (QUEST_FUSED_PIPELINE 1 and 0,
QUEST_FUSED_DRIVER=grid), quest_tpu_torch.ops.band_plan must return what
quest_tpu.ops.pallas_band returns: the operand budget, the swept plans,
pipeline_stats, fused_record and sweep_vmem_bytes. The reference resolves
its driver once per process (`_DRIVER_EFFECTIVE`); the tests set it with
monkeypatch and never edit the reference. Under HOPPER_GEOMETRY the plans
do not depend on the driver, every launch fits a block's shared memory,
and K1 reads ahead on every sweep of the 30q d20 plan. The kernel's
schedule is held to `band_plan.ring_schedule`, whose invariants are
checked here for every driver and slot count; the CUDA kernel itself
runs in tests/test_torch_cuda.py on a card.
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

import jax.numpy as jnp

import bench
from quest_tpu import circuit as JC
from quest_tpu import trajectories as JT
from quest_tpu.ops import fusion as JF
from quest_tpu.ops import pallas_band as PB

import quest_tpu_torch.circuit as TC
from quest_tpu_torch import convert
from quest_tpu_torch import entry as TE
from quest_tpu_torch import env
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as TF
from quest_tpu_torch.ops import segment as S

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5
KNOBS = ("QUEST_FUSED_DRIVER", "QUEST_FUSED_PIPELINE", "QUEST_FUSED_NBUF")
# knob setting -> (environment, the port's driver, the reference's
# _DRIVER_EFFECTIVE)
SETTINGS = {
    "pipeline1": ({"QUEST_FUSED_PIPELINE": "1"}, "decoupled", "pipelined"),
    "pipeline0": ({"QUEST_FUSED_PIPELINE": "0"}, "inplace", "pipelined"),
    "grid": ({"QUEST_FUSED_DRIVER": "grid"}, "grid", "grid"),
}
# the port's launch configurations: (driver, nbuf)
CONFIGS = [("decoupled", 3), ("inplace", 2), ("inplace", 3), ("inplace", 8),
           ("grid", 3)]


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


@pytest.fixture
def knobs(monkeypatch):
    """knobs(setting) sets the three knobs for both packages (the
    reference's driver through its per-process cache, restored after the
    test) and returns the port's driver."""
    def apply(setting):
        environ, driver, ref = SETTINGS[setting]
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in environ.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(PB, "_DRIVER_EFFECTIVE", ref)
        return driver
    return apply


def _stage_key(st):
    return (type(st).__name__, dataclasses.astuple(st))


def _item_key(it):
    if hasattr(it, "op"):
        op = it.op
        return (type(it).__name__, op.kind, tuple(op.targets),
                tuple(op.controls))
    if hasattr(it, "ql"):
        return (type(it).__name__, it.ql, it.w, tuple(it.preds))
    return (type(it).__name__, getattr(it, "index", None))


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


def _assert_schedule_matches(ref_raw, ref_swept, raw, swept, n, batch=1):
    """Swept plans, pipeline_stats, fused_record and sweep_vmem_bytes of
    the active setting, port (TPU_GEOMETRY) against reference."""
    tpu = BP.TPU_GEOMETRY
    assert_parts_equal(ref_swept, swept)
    assert (BP.pipeline_stats(swept, n, batch, budgets=tpu)
            == PB.pipeline_stats(ref_swept, n, batch))
    if batch == 1:
        assert (BP.fused_record(raw, swept, n, budgets=tpu)
                == PB.fused_record(ref_raw, ref_swept, n))
    for a, b in zip(ref_swept, swept):
        if a[0] == "segment":
            assert (BP.sweep_vmem_bytes(b[1], b[2], n, batch)
                    == PB.sweep_vmem_bytes(a[1], a[2], n, batch))


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,default", [("QUEST_FUSED_DRIVER", "pipelined"),
                                          ("QUEST_FUSED_PIPELINE", True),
                                          ("QUEST_FUSED_NBUF", 3)])
def test_knob_defaults(monkeypatch, name, default):
    monkeypatch.delenv(name, raising=False)
    assert env.knob_value(name) == default
    assert env.KNOBS[name].default == default


@pytest.mark.parametrize("name,raw,want", [
    ("QUEST_FUSED_DRIVER", "pipelined", "pipelined"),
    ("QUEST_FUSED_DRIVER", "grid", "grid"),
    ("QUEST_FUSED_PIPELINE", "1", True),
    ("QUEST_FUSED_PIPELINE", "0", False),
    ("QUEST_FUSED_NBUF", "2", 2),
    ("QUEST_FUSED_NBUF", "5", 5),
    ("QUEST_FUSED_NBUF", "8", 8)])
def test_knob_parses(monkeypatch, name, raw, want):
    monkeypatch.setenv(name, raw)
    assert env.knob_value(name) == want


@pytest.mark.parametrize("name,raw", [
    ("QUEST_FUSED_DRIVER", "turbo"), ("QUEST_FUSED_PIPELINE", "x"),
    ("QUEST_FUSED_PIPELINE", "2"), ("QUEST_FUSED_NBUF", "9"),
    ("QUEST_FUSED_NBUF", "1"), ("QUEST_FUSED_NBUF", "x")])
def test_malformed_knob_raises(monkeypatch, name, raw):
    """The port's knobs parse loudly (the reference warns and falls
    back): a malformed value raises at the read and when a program is
    compiled."""
    monkeypatch.setenv(name, raw)
    with pytest.raises(ValueError):
        env.knob_value(name)
    with pytest.raises(ValueError):
        TE.flagship_circuit(12, 2).compiled_fused(12, device="cpu")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_active_driver_is_the_references(knobs, setting):
    driver = knobs(setting)
    assert BP.active_driver() == driver
    assert BP.decoupled_active() == PB.decoupled_active()
    assert BP.pipeline_enabled() == PB.pipeline_enabled()


def test_unknown_driver_raises():
    with pytest.raises(ValueError):
        BP.check_driver("turbo")
    with pytest.raises(ValueError):
        S.prepare_segment([], [], 12, "cpu", driver="turbo")
    with pytest.raises(ValueError):
        S.prepare_segment([], [], 12, "cpu", driver="inplace", nbuf=9)


def test_fused_program_keeps_its_driver(knobs, monkeypatch):
    """A program reads the knobs when it is compiled and keeps them: a
    later flip changes the programs compiled after it, not this one."""
    knobs("grid")
    c = TE.flagship_circuit(12, 3)
    grid = c.compiled_fused(12, device="cpu")
    knobs("pipeline0")
    monkeypatch.setenv("QUEST_FUSED_NBUF", "2")
    inplace = c.compiled_fused(12, device="cpu")
    monkeypatch.delenv("QUEST_FUSED_PIPELINE")
    monkeypatch.delenv("QUEST_FUSED_NBUF")
    default = c.compiled_fused(12, device="cpu")
    assert (grid.driver, inplace.driver, default.driver) == (
        "grid", "inplace", "decoupled")
    assert {s.driver for s in grid.segments} == {"grid"}
    assert {(s.driver, s.nbuf) for s in inplace.segments} == {("inplace", 2)}
    assert inplace.nbuf == 2 and default.nbuf == 3
    planes = np.random.default_rng(3).standard_normal((2, 1 << 12))
    outs = [fn(torch.from_numpy(planes.astype(np.float32)))
            for fn in (grid, inplace, default)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_trajectory_program_keeps_its_driver(knobs):
    circ = TE.noisy_rcs_circuit(10, 2)
    knobs("pipeline0")
    k2 = T._compiled_traj(circ, 10, "cpu")
    knobs("grid")
    k3 = T._compiled_traj(circ, 10, "cpu")
    knobs("pipeline1")
    k1 = T._compiled_traj(circ, 10, "cpu")
    assert (k1.driver, k2.driver, k3.driver) == ("decoupled", "inplace",
                                                  "grid")
    assert T._compiled_traj(circ, 10, "cpu") is k1
    assert {s.driver for s in k2.segments} == {"inplace"}
    u = torch.rand((3, k1.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(4))
    (p1, d1), (p3, d3) = k1(u), k3(u)
    assert torch.equal(p1, p3) and torch.equal(d1, d3)


# ---------------------------------------------------------------------------
# planning under TPU_GEOMETRY: the reference's numbers for every setting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_operand_budget_matches_reference(knobs, setting):
    driver = knobs(setting)
    assert BP.sweep_operand_budget(BP.TPU_GEOMETRY) == PB.sweep_operand_budget()
    assert BP.sweep_operand_budget(BP.TPU_GEOMETRY, driver) == (
        PB.PIPELINE_SWEEP_OPERAND_BYTES if driver == "decoupled"
        else PB.SWEEP_OPERAND_BYTES)
    # on the port no driver keeps operands in shared memory
    assert BP.sweep_operand_budget() == 32 * (1 << 20)


def _rcs_parts(n, depth=6):
    jc = JC.random_circuit(n, depth, seed=n)
    tc = TC.random_circuit(n, depth, seed=n)
    items = JF.plan(jc._planned_flat(n, False), n, bands=PB.plan_bands(n))
    ref_raw = PB.segment_plan(items, n)
    titems = TF.plan(tc._planned_flat(n, False), n, bands=BP.plan_bands(n))
    raw = BP.segment_plan(titems, n, budgets=BP.TPU_GEOMETRY)
    return ref_raw, raw


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("n", [10, 14, 18, 22])
def test_rcs_schedule_matches_reference(knobs, setting, n):
    knobs(setting)
    ref_raw, raw = _rcs_parts(n)
    assert_parts_equal(ref_raw, raw)
    ref_swept = PB.sweep_plan(ref_raw * 2, n)
    swept = BP.sweep_plan(raw * 2, n, budgets=BP.TPU_GEOMETRY)
    _assert_schedule_matches(ref_raw * 2, ref_swept, raw * 2, swept, n)


def _reference_clifford_t(nd):
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


DENSITY = {
    "bench_density": (bench._build_density_circuit, TE.bench_density_circuit),
    "noisy_rcs": (lambda nd: bench._build_traj_circuit(nd, 3),
                  lambda nd: TE.noisy_rcs_circuit(nd, 3)),
    "clifford_t": (_reference_clifford_t, TE.clifford_t_density_circuit),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("name", sorted(DENSITY))
def test_density_schedule_matches_reference(knobs, setting, name):
    knobs(setting)
    build_ref, build_port = DENSITY[name]
    nd = 8
    n = 2 * nd
    jc, tc = build_ref(nd), build_port(nd)
    items = JF.plan(jc._planned_flat(n, True), n, bands=PB.plan_bands(n))
    ref_raw = PB.segment_plan(items, n)
    titems = TF.plan(tc._planned_flat(n, True), n, bands=BP.plan_bands(n))
    raw = BP.segment_plan(titems, n, budgets=BP.TPU_GEOMETRY)
    swept = BP.sweep_plan(raw, n, budgets=BP.TPU_GEOMETRY)
    _assert_schedule_matches(ref_raw, PB.sweep_plan(ref_raw, n), raw, swept,
                             n)


def _noisy_reference_circuit(n):
    """Channels on a lane, an inner-row and a scattered qubit (the circuit
    of tests/test_torch_trajectories.py, without its two-qubit maps)."""
    c = JC.Circuit(n)
    for q in (0, 2, 5, 9, 11, n - 1):
        c.h(q)
    c.ry(2, 1.1).cz(2, 9).ry(9, 0.8).cnot(n - 1, 5).rz(11, 0.3)
    c.damping(2, 0.3)
    c.depolarising(9, 0.2)
    c.ry(n - 1, 0.9)
    c.dephasing(n - 1, 0.25)
    c.ry(9, 1.3).cz(0, 9)
    c.damping(9, 0.4)
    c.depolarising(0, 0.3)
    c.damping(n - 1, 0.3)
    c.dephasing(5, 0.1).ry(5, 0.4)
    return c


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_trajectory_schedule_matches_reference(knobs, setting):
    """The batched trajectory plan: its steps are blocks x batch."""
    knobs(setting)
    n, batch = 15, 8
    jc = _noisy_reference_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    jitems, _ = JT._traj_channels_and_items(jc, n, True)
    items, _ = T._traj_channels_and_items(tc, n)
    ref_raw = PB.segment_plan(jitems, n, batch=batch)
    raw = BP.segment_plan(items, n, batch=batch, budgets=BP.TPU_GEOMETRY)
    swept = BP.sweep_plan(raw, n, budgets=BP.TPU_GEOMETRY)
    _assert_schedule_matches(ref_raw, PB.sweep_plan(ref_raw, n), raw, swept,
                             n, batch)


def test_nbuf_reaches_the_in_place_vmem_accounting(knobs, monkeypatch):
    """The in-place driver holds min(NBUF, steps) block slots (the
    reference reads NBUF once, at import)."""
    knobs("pipeline0")
    monkeypatch.setattr(PB, "NBUF", 5)
    raw, _ = _rcs_parts(22)
    for st, arrays in ((p[1], p[2]) for p in raw[:4] if p[0] == "segment"):
        assert (BP.sweep_vmem_bytes(st, arrays, 22, nbuf=5)
                == PB.sweep_vmem_bytes(st, arrays, 22))


# ---------------------------------------------------------------------------
# planning under HOPPER_GEOMETRY
# ---------------------------------------------------------------------------


def _hopper_plans(setting, knobs):
    knobs(setting)
    flagship, _ = TE.flagship_circuit(28).fused_parts(28)
    baseline, _ = TC.random_circuit(30, 20, seed=7, entangler="cz"
                                    ).fused_parts(30)
    density, _ = TE.noisy_rcs_circuit(14, 3).fused_parts(28, density=True)
    items, _ = T._traj_channels_and_items(TE.noisy_rcs_circuit(24, 3), 24)
    traj = BP.maybe_sweep(BP.segment_plan(items, 24, batch=64), 24)
    return flagship, baseline, density, traj


def test_hopper_plans_do_not_depend_on_the_driver(knobs):
    """The port reads operands through L1/L2 under every driver: the same
    plans, 9 launches for the flagship and 46 for 30q d20."""
    plans = {s: _hopper_plans(s, knobs) for s in SETTINGS}
    ref = plans["pipeline1"]
    assert [len(p) for p in ref[:2]] == [9, 46]
    for other in plans.values():
        for a, b in zip(ref, other):
            assert_parts_equal(a, b)


@pytest.mark.parametrize("driver,nbuf,overlap", [
    ("decoupled", 3, 1), ("inplace", 2, 0), ("inplace", 3, 1),
    ("inplace", 8, 1), ("grid", 3, 0)])
def test_read_ahead_on_every_30q_sweep(driver, nbuf, overlap):
    """pipeline_overlap_steps per sweep of the 30q d20 plan (a block of
    the 132-block persistent grid walks ~500 tiles): K1 reads a step
    ahead on every sweep (the reference's gate, tests/test_sweeps.py);
    K2 at 2 slots and K3 do not."""
    parts, _ = TC.random_circuit(30, 20, seed=7, entangler="cz"
                                 ).fused_parts(30, driver=driver)
    for p in parts:
        rec = BP.pipeline_stats([p], 30, driver=driver, nbuf=nbuf)
        assert rec["pipeline_overlap_steps"] == overlap, (p[1], rec)
    rec = BP.pipeline_stats(parts, 30, driver=driver, nbuf=nbuf)
    assert rec["pipeline_driver"] == driver
    assert rec["pipeline_slots"] == (2 if driver == "grid" else
                                     3 if driver == "decoupled" else
                                     min(nbuf, 3))


def test_fused_program_reports_its_record(knobs):
    knobs("pipeline1")
    circ = TE.flagship_circuit(16, 3)
    fn = circ.compiled_fused(16, device="cpu")
    rec = circ.plan_stats()["fused"]
    assert rec["hbm_sweeps"] == fn.launches_per_call
    assert rec["pipeline_driver"] == "decoupled"
    assert rec["pipeline_slots"] == 3
    assert rec["kernel_segments"] >= rec["hbm_sweeps"]


def _adversarial():
    """(name, stages, n, batch): the geometries of tests/test_sweeps.py's
    accounting test under the Hopper budgets — a full scattered band, a
    b1 floor beside scattered bits at the row budget, an operand-heavy
    sweep, a batched one — and an 11-bit tile."""
    scb = BP.MatStage("scb", 128, False, (), (), 14)
    mixed = [BP.MatStage("b1", 16, False, (), ())] + [
        BP.MatStage("sc", 2, False, (), (), 12 + j) for j in range(3)]
    dense = [BP.MatStage("b0", 128, False, (), ())] * 64
    batched = [BP.BatchSelStage(27, 0), BP.MatStage("b0", 128, False, (), ()),
               BP.BatchSelStage(10, 1, False)]
    small = [BP.MatStage("sc", 2, False, (), (), 3)]
    return [("full_band", [scb], 28, 1), ("mixed", mixed, 28, 1),
            ("dense", dense, 28, 1), ("batched", batched, 24, 64),
            ("tile11", small, 24, 1), ("one_tile", [], 14, 1)]


@pytest.mark.parametrize("driver,nbuf", CONFIGS, ids=str)
@pytest.mark.parametrize("case", _adversarial(), ids=lambda c: c[0])
def test_smem_fits_a_block(case, driver, nbuf):
    """Every launch fits one block's 232,448 bytes: slots, row ids,
    multiphase rows and mbarriers, with the in-place slots clamped to
    what fits and to the launch's planes."""
    name, stages, n, batch = case
    rec = BP.sweep_smem_bytes(stages, n, batch, driver=driver, nbuf=nbuf)
    assert rec["total_bytes"] <= rec["budget_bytes"] == 232448
    geo = BP.segment_geometry(stages, n)
    assert rec["tile_bits"] == geo.tile_bits
    assert rec["steps"] == geo.blocks * batch
    want = {"decoupled": 3, "grid": 2}.get(driver, nbuf)
    assert rec["slots"] == max(2, min(want, BP.ring_fit(geo.tile_bits),
                                      2 * rec["steps"]))
    # an mbarrier per ring slot; K3's one for its tile
    assert rec["barrier_bytes"] == (8 if driver == "grid"
                                    else 8 * rec["slots"])


def test_smem_layout_clamps_every_tile_size():
    for tile_bits in range(10, 15):
        for nbuf in range(2, 9):
            lay = BP.smem_layout(tile_bits, 1 << 20, "inplace", nbuf)
            assert lay["total_bytes"] <= BP.BLOCK_SMEM_BYTES
            assert lay["slots"] == min(nbuf, BP.ring_fit(tile_bits))
            # one more slot would not fit, unless nbuf asked for no more
            more = BP.smem_layout(tile_bits, 1 << 20, "inplace", 8)
            assert more["slots"] == BP.ring_fit(tile_bits)
    # the operator ring (2 x 16 KiB slices and their mbarriers) sits
    # beside the plane slots under every driver: one slot fewer at 13 bits
    assert [BP.ring_fit(b) for b in range(10, 15)] == [8, 8, 8, 6, 3]
    # S8's 1 KiB table sits beside them too
    assert BP.smem_layout(14, 1 << 20, "decoupled")["total_bytes"] == 231720
    assert BP.smem_layout(14, 1 << 20, "grid")["total_bytes"] == 166168
    assert BP.smem_layout(14, 1 << 20, "grid")["op_ring_bytes"] == 32784


@pytest.mark.parametrize("batch", [1, 64, 65535, 65536, 65539,
                                   3 * 65535 + 1])
@pytest.mark.parametrize("driver", BP.DRIVERS)
def test_grid_batch_slices_cover_the_batch(driver, batch):
    """Batches of any size (ROADMAP C1): the ring drivers fold the batch
    into their steps and launch once; the grid driver, whose gridDim.y
    holds at most 65535 states, launches consecutive slices of at most
    that many, each from its first state, covering [0, B) once, in as
    few launches as the limit allows."""
    slices = S.grid_batch_slices(batch, driver)
    if driver != "grid":
        assert slices == [(0, batch)]
        return
    assert slices[0][0] == 0
    assert all(1 <= k <= S.MAX_GRID_BATCH for _, k in slices)
    assert all(a + k == b for (a, k), (b, _) in zip(slices, slices[1:]))
    assert sum(k for _, k in slices) == batch
    assert len(slices) == -(-batch // S.MAX_GRID_BATCH)


def test_grid_batch_slices_refuse_an_empty_batch():
    with pytest.raises(ValueError):
        S.grid_batch_slices(0, "grid")


# ---------------------------------------------------------------------------
# the schedule model
# ---------------------------------------------------------------------------


def _check_schedule(driver, steps, slots, parts=1):
    ev = BP.ring_schedule(driver, steps, slots, parts)
    width = 2 if driver == "grid" else slots
    parts = 1 if driver == "grid" else parts
    loads = [e for e in ev if e[0] == "load"]
    stores = [e for e in ev if e[0] == "store"]
    chains = [e for e in ev if e[0] == "chain"]
    # every part of every step loaded, chained and stored exactly once, in
    # order
    every = [(j, i) for j in range(2 * steps) for i in range(parts)]
    assert [(e[1], e[3]) for e in loads] == every
    assert [(e[1], e[3]) for e in stores] == every
    assert [e[1] for e in chains] == list(range(steps))
    pos = {e: i for i, e in enumerate(ev)}
    occupant = {}                        # (slot, part) -> plane it holds
    released = set()                     # store groups read (K1) or landed
    committed = []
    for i, e in enumerate(ev):
        kind = e[0]
        if kind == "load":
            j, slot, part = e[1], e[2], e[3]
            assert slot == j % width
            if (slot, part) in occupant:     # a refill: its store released
                prev = occupant[(slot, part)]
                assert pos[("store", prev, slot, part)] < i
                assert (prev, part) in released, (driver, steps, slots, e)
            occupant[(slot, part)] = j
        elif kind == "store":
            committed.append((e[1], e[3]))
            assert pos[("chain", e[1] // 2, chains[e[1] // 2][2])] < i
        elif kind in ("read", "drained"):
            if driver == "inplace":
                assert kind == "drained"     # K2 waits for the landing
            done = committed[:committed.index((e[1], e[2])) + 1]
            assert len(committed) - len(done) == e[3]   # wait_group's N
            released |= set(done)
        elif kind == "landed":
            k = e[1]
            for j in (2 * k, 2 * k + 1):
                for part in range(parts):
                    assert pos[("load", j, j % width, part)] < i
        elif kind == "chain":
            k = e[1]
            assert pos[("landed", k)] < i
            assert e[2] == ((2 * k) % width, (2 * k + 1) % width)
            for part in range(parts):
                assert occupant[(e[2][0], part)] == 2 * k
                assert occupant[(e[2][1], part)] == 2 * k + 1
    # every store has landed before a ring block exits; K3's block exits
    # once its stores have read the tile
    assert ev[-1] == ("read" if driver == "grid" else "drained",
                      2 * steps - 1, parts - 1, 0)
    return ev


@pytest.mark.parametrize("driver,slots",
                         [(d, s) for d in ("decoupled", "inplace")
                          for s in range(2, 9)] + [("grid", 2)])
def test_ring_schedule_invariants(driver, slots):
    """For 1..9 steps, planes whole or in the kernel's parts: each part of
    each step is loaded, chained and stored exactly once; a part of a
    slot is refilled only after its previous plane's store of that part
    has read it (K1) or landed (K2), waiting with the count of store
    groups committed since; a chain starts only after its loads have
    landed; every store lands before a ring block exits, and has read
    K3's tile before its block exits."""
    for parts in (1, 2, BP.MAX_TMA_PARTS):
        for steps in range(1, 10):
            ev = _check_schedule(driver, steps, slots, parts)
            ahead = BP.overlap_steps(ev)
            if steps == 1 or driver == "grid" or slots == 2:
                assert ahead == 0
            else:
                assert ahead == 1 if slots < 6 or steps < 4 else ahead >= 1


def test_ring_schedule_decoupled_waits_only_for_the_read():
    """K1 refills as soon as the store has read the slot; K2 at the same
    slots waits for the landing at the same points."""
    k1 = BP.ring_schedule("decoupled", 4, 3)
    k2 = BP.ring_schedule("inplace", 4, 3)
    assert [e for e in k1 if e[0] == "read"]
    assert [e[0] for e in k1 if e[0] != "read"][:-1] == [
        e[0] for e in k2 if e[0] != "drained"]
    assert [e[1] for e in k1 if e[0] == "read"] == [
        e[1] for e in k2 if e[0] == "drained"][:-1]


def test_persistent_walk_covers_every_tile_once():
    """The persistent grid's walk (block b takes steps b, b + grid, ...;
    tile = step mod tiles, state = step / tiles) covers every tile of
    every state once, and a block's planes sit where ring_schedule puts
    them."""
    tiles, batch = 64, 5
    steps = tiles * batch
    for grid in (1, 7, 132, steps):
        grid = min(grid, steps)
        seen = []
        for b in range(grid):
            local = list(range(b, steps, grid))
            seen += [(s // tiles, s % tiles) for s in local]
            ev = BP.ring_schedule("decoupled", len(local), 3)
            assert sum(e[0] == "chain" for e in ev) == len(local)
        assert sorted(seen) == [(s, t) for s in range(batch)
                                for t in range(tiles)]


# ---------------------------------------------------------------------------
# segments and the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver,nbuf", CONFIGS, ids=str)
def test_stage_free_segment(driver, nbuf):
    """The stage-free segment (the reference's compile_segment((), ()) of
    its profiler) packs, and leaves a state unchanged bit for bit."""
    n = 14
    seg = S.prepare_segment([], [], n, "cpu", driver=driver, nbuf=nbuf)
    assert tuple(seg.desc.shape) == (0, S.DESC_WORDS)
    assert seg.ops.numel() == 0 and seg.labels == frozenset()
    assert (seg.driver, seg.nbuf) == (driver, nbuf)
    planes = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1 << n)).astype(np.float32))
    out = S.segment_sweep(planes.clone(), seg)
    assert torch.equal(out, planes)


def _chain(rng, n):
    """(port stages, reference stages, arrays): b0, b1, scb, phase,
    parity, multiphase and a lane/scat Kraus pair, under TPU budgets."""
    def mat(d):
        g = rng.standard_normal((2, d, d)) / np.sqrt(d)
        return g.astype(np.float32)
    t = np.exp(1j * 0.7)
    cores = rng.standard_normal((2, 4, 2, 2)) / 2
    emb = np.stack([TF.embed_operator(cores[0, b] + 1j * cores[1, b], [3],
                                      [], [], 7).T for b in range(4)])
    port = [BP.MatStage("b0", 128, False, ((5, 1),), ()),
            BP.MatStage("b1", 8, False, (), ((4, 0),)),
            BP.MatStage("scb", 4, False, (), (), 3),
            BP.PhaseStage(), BP.ParityStage(),
            BP.MultiPhaseStage(("a", "p")),
            BP.PairStage("lane", 128, -1, "scat", 4, False, (), ())]
    arrays = [mat(128), mat(8), mat(4),
              np.array([[t.real, t.imag, 0b11, 0b01, 0b10, 0, 0b10, 0]],
                       np.float32),
              np.array([[np.cos(0.3), np.sin(0.3), 0b101, 0b1, 0, 0, 0, 0]],
                       np.float32),
              np.array([[0.4, 0b1, 0b100, 0, 0, 0, 0, 0],
                        [-0.9, 0b10, 0b1, 0, 0, 0, 0, 0]], np.float32),
              np.stack([emb.real, emb.imag]).astype(np.float32)]
    ref = [getattr(PB, type(st).__name__)(*dataclasses.astuple(st))
           for st in port]
    return port, ref, arrays


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_plain_path_matches_interpreted_reference(knobs, setting):
    """At 12 qubits the port's plain path (what every driver runs on a
    CPU tensor) against the reference's compile_segment in the Pallas
    interpreter under the same knobs: K1's decoupled rings, K2's
    in-place slots, K3's grid (no S9: the reference's interpreted
    BatchSelStage fails here, ROADMAP C)."""
    driver = knobs(setting)
    n = 12
    port, ref, arrays = _chain(np.random.default_rng(12), n)
    planes = np.random.default_rng(13).standard_normal(
        (2, 1 << n)).astype(np.float32)
    want = np.asarray(PB.compile_segment(ref, n, interpret=True)(
        jnp.asarray(planes).reshape(2, -1, PB.LANES), arrays))
    seg = S.prepare_segment(port, arrays, n, "cpu", budgets=BP.TPU_GEOMETRY)
    assert seg.driver == driver
    got = S.segment_sweep(torch.from_numpy(planes.copy()), seg)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want.reshape(2, -1),
                               atol=TOL * scale, rtol=0)


def test_sweep_dma_report_measures_only_the_card():
    """The profiler times the CUDA kernel; asked for the CPU it raises
    instead of timing the plain path."""
    from quest_tpu_torch import profiling
    with pytest.raises(ValueError, match="CUDA"):
        profiling.sweep_dma_report(n=12, device="cpu")
