"""The drivers' tile copies on the CPU: the tensor-map model, the
box-granular schedule of csrc/segment.cu's ring_kernel, and the grid
driver's (K3's) blocks on the same map.

K1 and K2 move every tile plane as cp.async.bulk.tensor boxes of one
tensor map per launch, whose dimensions, strides, box and per-tile
request coordinates are modelled by band_plan.tma_boxes / tma_requests
(the wrapper checks the model against the kernel's own encoding on the
card). Here the model is held to an independent model of the kernel's
tile rows (tile_base, tile_row) on every segment geometry of the paths'
plans — the flagship, 30q d20, the density and Clifford+T density steps,
the batched step and a trajectory chunk — and on seeded random
geometries: the boxes cover exactly the tile's rows in slot order, stay
inside the tensor and inside TMA's limits, and take one request per
plane wherever the tile's rows are contiguous in slot order (at most 4
on the paths' plans). The schedule model band_plan.ring_schedule, whole
planes or parts, never refills part of a slot before the store of that
part has released it (read for K1, landed for K2), waits with the
bulk-group count the kernel computes, and reads ahead no less than the
schedule of the bulk-copy kernel it replaced. K3 takes the same map
over the whole batch: a block's requests sit at (tile, state0 +
blockIdx.y) on every path geometry, random ones and the slice
boundaries of batches above 65,535 states, and its launch counts one
mbarrier in shared memory. The kernel itself runs in
tests/test_torch_cuda.py on a card. (The reference has no counterpart:
its copies are Pallas BlockSpecs.)
"""

import contextlib
import functools
import itertools

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import chip_smoke
import quest_tpu_torch.circuit as TC
from quest_tpu_torch import entry as TE
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.ops import band_plan as BP

pytestmark = pytest.mark.dtype_agnostic

LANE_BITS = 7


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


# path -> (plan, n, states per launch)
PATHS = {
    "flagship": lambda: (TE.flagship_circuit(28).fused_parts(28)[0], 28, 1),
    "baseline_30q_d20": lambda: (TC.random_circuit(
        30, 20, seed=7, entangler="cz").fused_parts(30)[0], 30, 1),
    "density": lambda: (TE.noisy_rcs_circuit(14, 3).fused_parts(
        28, density=True)[0], 28, 1),
    "clifford_t_density": lambda: (TE.clifford_t_density_circuit(
        14).fused_parts(28, density=True)[0], 28, 1),
    "batched": lambda: (TE.flagship_circuit(24).fused_parts(24)[0], 24, 64),
    "trajectory_chunk": lambda: (BP.maybe_sweep(BP.segment_plan(
        T._traj_channels_and_items(TE.noisy_rcs_circuit(24, 3), 24)[0], 24,
        batch=64), 24), 24, 64),
}
# the scattered-row tiles of each path: (inner rows, scattered groups) ->
# sweeps, as the port's planner gives them today
SCATTERED = {
    "flagship": {(0, (7,)): 6},
    "baseline_30q_d20": {(0, (7,)): 24, (5, (2,)): 8},
    "density": {(0, (7,)): 9, (4, (3,)): 3, (5, (2,)): 3, (6, (1,)): 3,
                (4, (1, 1, 1)): 3},
    "clifford_t_density": {(0, (7,)): 2, (0, (6, 1)): 1, (3, (4,)): 1,
                           (5, (2,)): 1, (6, (1,)): 1, (5, (1, 1)): 1},
    "batched": {(0, (7,)): 2, (4, (3,)): 2},
    "trajectory_chunk": {(0, (7,)): 6, (4, (3,)): 5, (6, (1,)): 1,
                         (5, (2,)): 1},
}


@functools.lru_cache(maxsize=None)
def path_geometries(path):
    """Distinct (geometry, batch) of the path's launches, with the count
    of sweeps of each (inner rows, scattered groups)."""
    parts, n, batch = PATHS[path]()
    geos, tally = {}, {}
    for p in parts:
        if p[0] != "segment":
            continue
        geo = BP.segment_geometry(p[1], n)
        geos[geo] = batch
        key = chip_smoke.geometry_groups(geo)
        tally[key] = tally.get(key, 0) + 1
    return tuple(geos.items()), tally


def kernel_tile_rows(geo, tile):
    """Global row of each tile row as csrc/segment.cu builds it, from the
    masks the wrapper passes (ops/segment.py prepare_segment): the tile
    index deposited into the free mask, low bits first (tile_base), then
    the inner rows and each scattered bit of the mask, lowest first
    (tile_row)."""
    row_bits = geo.n - LANE_BITS
    scat_mask = sum(1 << s for s in geo.scat)
    free_mask = ((1 << row_bits) - 1) & ~scat_mask & ~((1 << geo.inner_bits)
                                                       - 1)
    base, fm, t = 0, free_mask, tile
    while fm:
        low = fm & -fm
        if t & 1:
            base |= low
        t >>= 1
        fm &= fm - 1
    out = []
    for r in range(1 << (geo.tile_bits - LANE_BITS)):
        row = base | (r & ((1 << geo.inner_bits) - 1))
        k, sm = geo.inner_bits, scat_mask
        while sm:
            low = sm & -sm
            if (r >> k) & 1:
                row |= low
            k += 1
            sm &= sm - 1
        out.append(row)
    return out


def covered(boxes, requests):
    """(tile row, global row) of every row the requests' boxes move, in
    the order they land in the slot."""
    s0, w = boxes["s0"], boxes["w"]
    b2, b3 = boxes["box"][1], boxes["box"][2]
    out = []
    for _, r0, (c1, c2, c3, c4) in requests:
        assert c1 == 0 and boxes["box"][0] == boxes["dims"][0] == 128
        for i3 in range(b3):
            for i2 in range(b2):
                out.append((r0 + i3 * b2 + i2,
                            (c2 + i2) + ((c3 + i3) << s0) + (c4 << (s0 + w))))
    return out


def sample_tiles(geo):
    last = geo.blocks - 1
    return sorted({0, min(1, last), last // 2 + 3 if last > 6 else last,
                   last})


def check_boxes(geo, batch, boxes):
    """The model's map and requests against the kernel's rows and TMA's
    limits, on a few tiles."""
    plane = 4 << geo.tile_bits
    assert boxes["rank"] == len(boxes["dims"]) == len(boxes["box"]) <= 5
    assert len(boxes["strides"]) == boxes["rank"] - 1
    assert all(1 <= b <= 256 for b in boxes["box"])
    assert all(s % 16 == 0 and s < 1 << 40 for s in boxes["strides"])
    assert all(1 <= d < 1 << 32 for d in boxes["dims"])
    assert boxes["box"][0] * 4 % 16 == 0
    # the dims tile the batch's planes exactly, row-major
    assert np.prod(boxes["dims"], dtype=np.int64) == 2 * batch << geo.n
    assert boxes["strides"][0] == 4 * boxes["dims"][0]
    for k in range(1, 4):
        assert boxes["strides"][k] == boxes["strides"][k - 1] * boxes["dims"][k]
    assert boxes["strides"][3] == 4 << geo.n
    # a plane is whole boxes: every request counts full box bytes
    assert boxes["box_bytes"] * boxes["requests_per_plane"] == plane
    assert boxes["part_bytes"] * boxes["parts"] == plane
    rows = 1 << (geo.tile_bits - LANE_BITS)
    for tile in sample_tiles(geo):
        reqs = BP.tma_requests(boxes, geo, tile)
        assert len(reqs) == boxes["requests_per_plane"]
        # requests go out part by part, each inside its part
        per_part = rows // boxes["parts"]
        assert [q[0] for q in reqs] == sorted(q[0] for q in reqs)
        for part, r0, c in reqs:
            assert part == r0 // per_part
            assert (r0 + boxes["box_rows"] - 1) // per_part == part
            assert all(0 <= c[d] and c[d] + boxes["box"][d] <= boxes["dims"][d]
                       for d in range(4))
            assert all(x < 1 << 31 for x in c)
        got = covered(boxes, reqs)
        assert [r for r, _ in got] == list(range(rows))      # slot order
        assert [g for _, g in got] == kernel_tile_rows(geo, tile)
        assert BP.tile_rows(geo, tile) == kernel_tile_rows(geo, tile)
    # the plane coordinate of the batch's last plane fits int32
    assert boxes["dims"][4] - 1 < 1 << 31


@pytest.mark.parametrize("path", sorted(PATHS))
def test_paths_take_the_scattered_geometries(path):
    """The scattered-row tiles of each path's launches, as the port's
    planner gives them: (0,(7,)) on every path, split groups on the
    density and Clifford+T plans."""
    _, tally = path_geometries(path)
    scattered = {k: v for k, v in tally.items() if k[1]}
    assert scattered == SCATTERED[path]
    assert all(k == (7, ()) for k in tally if not k[1])


# requests per plane under the kernel's copy unit: one box holds the
# inner rows and the lowest scattered group
REQUESTS = {(7, ()): 1, (0, (7,)): 1, (5, (2,)): 1, (4, (3,)): 1,
            (6, (1,)): 1, (3, (4,)): 1, (0, (6, 1)): 2, (5, (1, 1)): 2,
            (4, (1, 1, 1)): 4}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tensor_map_covers_tile_rows_on_path_plans(path):
    """Every geometry of the path under the kernel's copy unit: the boxes
    of a tile cover exactly the rows tile_row gives, in slot order, each
    once; inside the tensor and TMA's limits; one box per plane where the
    inner rows and the lowest scattered group make the whole tile, else
    one per value of the higher groups' bits (2 or 4)."""
    geos, _ = path_geometries(path)
    for geo, batch in geos:
        boxes = BP.tma_boxes(geo, batch)
        assert boxes["parts"] == BP.TMA_PARTS == 1
        want = REQUESTS[chip_smoke.geometry_groups(geo)]
        assert boxes["requests_per_plane"] == want, (geo, boxes)
        check_boxes(geo, batch, boxes)


def _copy_units(geo):
    """Every (parts, box rows) the geometry takes."""
    rows_log2 = geo.tile_bits - LANE_BITS
    s0, w = BP._lowest_group(geo)
    for parts in (1, 2, 4):
        most = min(rows_log2 - parts.bit_length() + 1, geo.inner_bits + w)
        for b in range(most + 1):
            yield parts, 1 << b


def _random_geometry(rng):
    """A segment geometry from seeded random stages: n in [10, 33], up to
    7 scattered row bits (sc stages), a sublane floor (a b1 stage) when
    the budget leaves room."""
    n = int(rng.integers(10, 34))
    row_bits = n - LANE_BITS
    k = int(rng.integers(0, min(7, row_bits) + 1))
    scat = sorted(rng.choice(row_bits, size=k, replace=False).tolist())
    stages = [BP.MatStage("sc", 2, False, (), (), int(b)) for b in scat]
    if k < 7 and rng.random() < 0.5:
        d = 1 << int(rng.integers(1, 7 - k + 1))
        stages.append(BP.MatStage("b1", d, False, (), ()))
    geo = BP.segment_geometry(stages, n)
    if geo.tile_bits < LANE_BITS + 3 or geo.tile_bits > 14:
        return None
    return geo


@pytest.mark.parametrize("seed", range(12))
def test_tensor_map_on_random_geometries(seed):
    """Seeded random geometries under every copy unit they take (1, 2 or
    4 parts; boxes of 1 row up to a part or the contiguous run), batches
    of 1 to 65,539 states: coverage, bounds and limits as above."""
    rng = np.random.default_rng(seed)
    done = 0
    while done < 4:
        geo = _random_geometry(rng)
        if geo is None:
            continue
        batch = int(rng.choice([1, 5, 64, 65539]))
        for parts, box_rows in _copy_units(geo):
            boxes = BP.tma_boxes(geo, batch, parts=parts, box_rows=box_rows)
            assert (boxes["parts"], boxes["box_rows"]) == (parts, box_rows)
            check_boxes(geo, batch, boxes)
        done += 1


@pytest.mark.parametrize("n,batch", [(33, 1), (10, 65539), (24, 64)])
def test_tensor_map_at_the_limits(n, batch):
    """The fault checks' launches: a 33-qubit state (a 32 GiB plane
    stride, below TMA's 2^40) and 65,539 states of 10 qubits (131,078
    planes on the fifth dimension, an int32 coordinate), with and without
    scattered bits."""
    for stages in ([], [BP.MatStage("scb", 8, False, (), (), n - 10)],
                   [BP.DiagVecStage((n - 1, 3), (), ())]):
        geo = BP.segment_geometry(stages, n)
        boxes = BP.tma_boxes(geo, batch)
        check_boxes(geo, batch, boxes)
        assert boxes["strides"][3] == 4 << n < 1 << 40
        assert boxes["dims"][4] == 2 * batch


def test_tensor_map_refuses_a_unit_the_geometry_cannot_take():
    """Parts that are not 1, 2 or 4; boxes longer than a part or than the
    run of tile rows that is contiguous in slot order: ValueError (the
    kernel's quest_segment_tma_geometry refuses the same)."""
    geo = BP.segment_geometry(
        [BP.MatStage("sc", 2, False, (), (), b) for b in (5, 8, 11)], 20)
    assert chip_smoke.geometry_groups(geo) == (4, (1, 1, 1))
    assert BP.tma_boxes(geo, parts=4, box_rows=32)["requests_per_part"] == 1
    for parts, box_rows in ((3, None), (8, None), (0, None), (4, 64),
                            (1, 64), (4, 3), (2, 0)):
        with pytest.raises(ValueError):
            BP.tma_boxes(geo, parts=parts, box_rows=box_rows)


# ---------------------------------------------------------------------------
# the box-granular ring schedule
# ---------------------------------------------------------------------------


def simulate(driver, steps, slots, parts):
    """Walk ring_schedule(driver, steps, slots, parts) as the hardware
    would: store groups committed in order; a wait with count N completes
    every group but the last N (read for K1, landed for K2). Checks each
    wait's N against the groups committed after the one it names, and
    that every load into part i of a slot comes after the store of part i
    of the slot's previous plane was released the way the driver
    needs."""
    ev = BP.ring_schedule(driver, steps, slots, parts)
    need = "read" if driver == "decoupled" else "drained"
    committed, released = [], set()
    holder = {}                      # (slot, part) -> plane it holds
    for e in ev:
        if e[0] == "store":
            committed.append((e[1], e[3]))
        elif e[0] in ("read", "drained"):
            j, i, nwait = e[1], e[2], e[3]
            pos = committed.index((j, i))
            assert nwait == len(committed) - 1 - pos, e
            if e[0] == need or e[0] == "drained":
                released |= set(committed[:len(committed) - nwait])
        elif e[0] == "load":
            j, slot, i = e[1], e[2], e[3]
            assert slot == j % slots
            if (slot, i) in holder:
                prev = holder[(slot, i)]
                assert (prev, i) in released, (driver, steps, slots, parts, e)
            holder[(slot, i)] = j
    assert ev[-1][0] == "drained" and ev[-1][3] == 0
    return ev


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("driver,slots",
                         [("decoupled", 3)] + [("inplace", s)
                                               for s in (2, 3, 5, 8)])
def test_box_granular_refills_wait_for_their_own_part(driver, slots, parts):
    """For 1..9 steps: a part of a slot is refilled only after the store
    of the same part of its previous plane has read it (K1) or landed
    (K2), with the kernel's wait_group count (ring_wait_groups), which
    never exceeds 2 x parts - 1 (the kernel's immediates)."""
    for steps in range(1, 10):
        ev = simulate(driver, steps, slots, parts)
        waits = [e[3] for e in ev if e[0] in ("read", "drained")]
        assert max(waits) <= 2 * parts - 1
        if driver == "decoupled":
            assert not [e for e in ev[:-1] if e[0] == "drained"]


def bulk_copy_schedule(driver, steps, slots):
    """The ring kernel's order of events before the tensor-map copies (a
    copy of the model of that time, whole planes): at step k the loads of
    planes [2k - 2 + slots, 2k + slots) (k = 0: [0, slots)), each after
    its slot's previous store, then the tile's wait, the chain and both
    stores."""
    release = "read" if driver == "decoupled" else "drained"
    ev = []
    for k in range(steps):
        lo = 0 if k == 0 else 2 * k - 2 + slots
        for j in range(lo, min(2 * k + slots, 2 * steps)):
            if j >= slots:
                ev.append((release, j - slots))
            ev.append(("load", j, j % slots))
        ev.append(("landed", k))
        ev.append(("chain", k, (2 * k % slots, (2 * k + 1) % slots)))
        ev += [("store", 2 * k, 2 * k % slots),
               ("store", 2 * k + 1, (2 * k + 1) % slots)]
    return ev


@pytest.mark.parametrize("driver,slots",
                         [("decoupled", 3)] + [("inplace", s)
                                               for s in (2, 3, 5, 8)])
def test_read_ahead_no_less_than_the_bulk_copy_kernel(driver, slots):
    """The tensor-map schedule, whole planes or parts, keeps the read-ahead
    of the kernel it replaced: as many later steps in flight and as many
    bytes when each chain starts (K1 at 3 slots: the next step's re
    plane, 64 KiB)."""
    plane = 4 << 14
    for steps in range(1, 10):
        old = bulk_copy_schedule(driver, steps, slots)
        for parts in (1, 2, 4):
            new = BP.ring_schedule(driver, steps, slots, parts)
            assert BP.overlap_steps(new) >= BP.overlap_steps(old)
            assert (BP.readahead_bytes(new, plane // parts)
                    >= BP.readahead_bytes(old, plane))
    ev = BP.ring_schedule("decoupled", 6, 3)
    assert BP.readahead_bytes(ev, plane) == plane


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_next_im_plane_loads_behind_the_re_store_alone(parts):
    """K1 at 3 slots: after chain k the block stores re(k), refills the
    slot it frees with im(k + 1) part by part (wait_group.read P - 1 -
    i), and only then stores im(k); once tile k + 1 has landed it refills
    im(k)'s slot with re(k + 2) before chain k + 1."""
    p = parts
    ev = BP.ring_schedule("decoupled", 4, 3, p)
    k = 1
    at = ev.index(("chain", k, (2, 0))) + 1
    want = ([("store", 2 * k, i) for i in range(p)]
            + [x for i in range(p) for x in (("read", 2 * k, i),
                                             ("load", 2 * k + 3, i))]
            + [("store", 2 * k + 1, i) for i in range(p)])
    got = ev[at:at + len(want)]
    assert [(e[0], e[1], e[2] if e[0] == "read" else e[3])
            for e in got] == want
    assert [e[3] for e in got if e[0] == "read"] == [p - 1 - i
                                                     for i in range(p)]
    at += len(want)
    assert ev[at] == ("landed", k + 1)
    nxt = ev[at + 1:at + 1 + 2 * p]
    assert [(e[0], e[1]) for e in nxt] == [
        x for i in range(p) for x in (("read", 2 * k + 1),
                                      ("load", 2 * k + 4))]
    assert ev[at + 1 + 2 * p][0] == "chain"


def test_pipeline_stats_reports_bytes_in_flight():
    """pipeline_readahead_bytes on the 30q d20 plan: K1 keeps one plane
    (64 KiB) in flight for the next step when each chain starts; K2 at 2
    slots and K3 none."""
    parts, _ = TC.random_circuit(30, 20, seed=7, entangler="cz"
                                 ).fused_parts(30)
    for driver, nbuf, want in (("decoupled", 3, 1 << 16), ("inplace", 2, 0),
                               ("inplace", 3, 1 << 16), ("grid", 3, 0)):
        rec = BP.pipeline_stats(parts, 30, driver=driver, nbuf=nbuf)
        assert rec["pipeline_readahead_bytes"] == want, (driver, rec)


def test_copy_units_of_every_small_geometry():
    """Every tile geometry of up to 3 scattered bits at 12 qubits under
    every copy unit it takes: the exhaustive companion of the random
    test."""
    row_bits = 12 - LANE_BITS
    for k in range(0, 4):
        for scat in itertools.combinations(range(row_bits), k):
            geo = BP.segment_geometry(
                [BP.MatStage("sc", 2, False, (), (), b) for b in scat], 12)
            if geo.tile_bits < LANE_BITS + 3:
                continue
            for parts, box_rows in _copy_units(geo):
                check_boxes(geo, 3, BP.tma_boxes(geo, 3, parts=parts,
                                                 box_rows=box_rows))


# ---------------------------------------------------------------------------
# the grid driver's (K3) tile copies on the same map
# ---------------------------------------------------------------------------


def check_grid_block(geo, boxes, tile, state):
    """K3's requests for one block, as csrc segment_kernel issues them
    through the ring drivers' plane_boxes (tma_requests, at plane
    coordinate 2 * state + p): each plane inside the map, its boxes
    covering the tile's rows in slot order and inside the tensor."""
    reqs = BP.tma_requests(boxes, geo, tile)
    assert len(reqs) == boxes["requests_per_plane"]
    for p in range(2):
        assert 0 <= 2 * state + p < boxes["dims"][4] < 1 << 31
    got = covered(boxes, reqs)
    assert [r for r, _ in got] == list(range(1 << (geo.tile_bits
                                                    - LANE_BITS)))
    assert [g for _, g in got] == kernel_tile_rows(geo, tile)
    for _, _, c in reqs:
        assert all(0 <= c[d] and c[d] + boxes["box"][d] <= boxes["dims"][d]
                   for d in range(4))
    return len(reqs)


def grid_blocks(geo, batch):
    """(tile, state) of a few blocks of every K3 launch of a sweep over
    `batch` states: the first and last state of each slice (state0 and
    state0 + states - 1) on the first, a middle and the last tile."""
    from quest_tpu_torch.ops import segment as S
    for state0, states in S.grid_batch_slices(batch, "grid"):
        for y in sorted({0, states - 1}):
            for tile in sample_tiles(geo):
                yield tile, state0 + y


@pytest.mark.parametrize("path", sorted(PATHS))
def test_grid_driver_map_on_path_plans(path):
    """K3 takes the ring drivers' map (tma_boxes over the whole batch):
    on every geometry of the path its blocks' requests sit at (tile,
    state0 + y), cover the tile's rows in slot order, stay inside the
    map, and take the kernel's requests per plane (1, 2 or 4)."""
    geos, _ = path_geometries(path)
    for geo, batch in geos:
        boxes = BP.tma_boxes(geo, batch)
        want = REQUESTS[chip_smoke.geometry_groups(geo)]
        for tile, state in grid_blocks(geo, batch):
            assert check_grid_block(geo, boxes, tile, state) == want


@pytest.mark.parametrize("seed", range(8))
def test_grid_driver_map_on_random_geometries(seed):
    """Seeded random geometries and batches (1 to 65,539 states) under
    every copy unit: K3's requests stay inside the map for the first and
    last state of every slice of the batch."""
    rng = np.random.default_rng(100 + seed)
    done = 0
    while done < 4:
        geo = _random_geometry(rng)
        if geo is None:
            continue
        batch = int(rng.choice([1, 7, 65535, 65539]))
        for parts, box_rows in _copy_units(geo):
            boxes = BP.tma_boxes(geo, batch, parts=parts, box_rows=box_rows)
            for tile, state in grid_blocks(geo, batch):
                check_grid_block(geo, boxes, tile, state)
        done += 1


@pytest.mark.parametrize("batch", [65535, 65536, 65539, 2 * 65535 + 1])
def test_grid_slices_stay_inside_the_map(batch):
    """ROADMAP C1's slice boundaries: a batch of 10-qubit states above
    gridDim.y's 65,535 launches in slices that share one map over the
    whole batch; the last state of a slice and the first of the next
    address neighbouring planes, and the batch's last plane is the map's
    last."""
    from quest_tpu_torch.ops import segment as S
    for stages in ([], [BP.MatStage("sc", 2, False, (), (), 1)]):
        geo = BP.segment_geometry(stages, 10)
        boxes = BP.tma_boxes(geo, batch)
        assert boxes["dims"][4] == 2 * batch
        slices = S.grid_batch_slices(batch, "grid")
        firsts = [s for s, _ in slices]
        assert firsts == list(range(0, batch, S.MAX_GRID_BATCH))
        spans = []                   # (first, last) plane of each slice
        for state0, states in slices:
            planes = set()
            for y in (0, states - 1):
                planes |= {2 * (state0 + y) + p for p in range(2)}
                check_grid_block(geo, boxes, 0, state0 + y)
                check_grid_block(geo, boxes, geo.blocks - 1, state0 + y)
            spans.append((min(planes), max(planes)))
        assert spans[0][0] == 0 and spans[-1][1] == boxes["dims"][4] - 1
        for (_, last), (first, _) in zip(spans, spans[1:]):
            assert first == last + 1


def test_grid_driver_shared_memory_counts_its_mbarrier():
    """K3's launch holds its two planes, the fixed words and one mbarrier
    for the tile, within a block's 232,448 bytes at every tile size."""
    for tile_bits in range(10, 15):
        lay = BP.smem_layout(tile_bits, 1 << 20, "grid")
        assert lay["slots"] == 2 and lay["barrier_bytes"] == 8
        assert lay["total_bytes"] == (8 << tile_bits) + BP.FIXED_SMEM_BYTES + 8
        assert lay["total_bytes"] <= BP.BLOCK_SMEM_BYTES
    assert BP.smem_layout(14, 1, "grid")["total_bytes"] == 166168


def test_grid_schedule_exits_on_the_stores_read():
    """The schedule model of the blocks one SM runs under K3: both planes
    loaded on one mbarrier, the chain, a store group per plane, and the
    exit once the stores have read the planes (wait_group.read 0), before
    the next tile's block loads into the same shared memory."""
    ev = BP.ring_schedule("grid", 3, 2)
    for k in range(3):
        at = ev.index(("chain", k, (0, 1)))
        assert ev[at - 3:at] == [("load", 2 * k, 0, 0),
                                 ("load", 2 * k + 1, 1, 0), ("landed", k)]
        assert ev[at + 1:at + 4] == [("store", 2 * k, 0, 0),
                                     ("store", 2 * k + 1, 1, 0),
                                     ("read", 2 * k + 1, 0, 0)]
    assert not [e for e in ev if e[0] == "drained"]


# path -> (launches, launches holding S7, S7 stages): every S7 stage the
# paths' planners emit has the main paths' form, two all-ones terms
MULTIPHASE_ON_PATHS = {"flagship": (9, 2, 2), "baseline_30q_d20": (46, 19, 20),
                       "density": (24, 2, 2), "clifford_t_density": (9, 0, 0),
                       "batched": (7, 2, 2), "trajectory_chunk": (20, 2, 2)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_multiphase_stages_on_path_plans(path):
    """The multiphase stages of each path's launches, as the port's
    planner gives them today (the S7 launches PERF.md counts): how many
    launches hold one, how many there are, and their forms ('a', 'a')."""
    parts, _, _ = PATHS[path]()
    segs = [p[1] for p in parts if p[0] == "segment"]
    mp = [[s for s in st if isinstance(s, BP.MultiPhaseStage)] for st in segs]
    assert (len(segs), sum(1 for m in mp if m),
            sum(len(m) for m in mp)) == MULTIPHASE_ON_PATHS[path]
    assert {s.forms for m in mp for s in m} <= {("a", "a")}
