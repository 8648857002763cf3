"""The segment kernel's wrapper, its plain PyTorch version, and operand
packing.

`prepare_segment` turns one swept segment of the planner (stages plus
numpy operand arrays, quest_tpu_torch/ops/band_plan.py) into a `Segment`:
the block geometry under HOPPER_GEOMETRY, a device table of stage
descriptors and one device buffer with every operand in the reference's
packing and orientation. It runs once per segment when a program is
compiled, never per call.

`segment_sweep(amps, seg, sel)` applies the segment in place, to one
state's planes or to a batch of states (B, 2, 2^n) in one launch (under
the grid driver, one per MAX_GRID_BATCH states). On a CUDA tensor it
launches the hand-written kernel (csrc/segment.cu) under the segment's
driver and counts each launch in `segment_sweep.launches`,
in `segment_sweep.driver_launches` (keyed by driver), and once for each
stage kind the segment holds in `segment_sweep.stage_launches` (keyed by
`stage_label`); on a CPU tensor it runs the plain version,
`segment_sweep_reference`, which applies each stage to the whole batch
with reshapes that expose the band bits and torch.matmul for the
contractions. It does not share the kernel's tiling.

Per-state channel branches (BatchSelStage, the batched trajectory
engine's stage) read the per-call selection table `sel`, one device
tensor of shape (slots, B, 8): row sel[slot, b] is state b's selected
2x2 [g00re, g00im, g01re, g01im, g10re, g10im, g11re, g11im] for the
channel in that slot (the stage's `index`). The caller writes the table
on the device between launches; the descriptors and operand buffer
never change per call.

Kraus pairs (PairStage) reach the kernel as a 4x4 butterfly on two tile
bits: the packer reduces the 128x128 embedded blocks of 'lane' and 'b1'
pairs to their 2x2 cores (checking that the rest of each block is the
embedding), so every form runs 4 complex MACs per amplitude.

Matrix stages of d >= 16 (SLICED_MIN_DIM) stream their operator
through the kernel's ring of two OP_SLICE_BYTES shared-memory slices, so
the packer writes them as those slices (`slice_operator`), from G read in
the planner's orientation (G^T for b0, b1 and 128-wide scb, G for narrow
scb): at 'highest' the rows [Gre[:, j], Gim[:, j]] of each input j, f32;
at 'high' and 'default' (matmul tiers, quest_tpu_torch/precision.py) the
bf16 B tiles of the kernel's wgmma products, per 16-input k-step and per
part ('high': the hi and lo planes of Gre and Gim, 'default': their RNE
roundings), in wgmma's K-major core-matrix layout, inputs and outputs in
the order `operand_perm` gives. Narrower stages keep the f32 operand in
the planner's orientation, read through strides; at a tier the kernel
rounds it as it reads it. A segment is packed for one tier, which rides
in the Segment and in each matrix descriptor (F_TIER): the b0, b1 and scb
stages round at the segment's tier, `sc` stays exact. The plain version
applies the same tier through precision.tier_products.

Drivers (band_plan.DRIVERS, the reference's K1-K3). A segment is packed
for one driver, read from QUEST_FUSED_DRIVER / QUEST_FUSED_PIPELINE /
QUEST_FUSED_NBUF when it is prepared unless the caller names it:
'decoupled' (K1, the default) and 'inplace' (K2) launch the persistent
ring kernel (K1 with 3 plane slots, K2 with `nbuf`), 'grid' (K3) one
block per tile (a batch above MAX_GRID_BATCH states in several
launches, `grid_batch_slices`); each launch sizes its shared memory from
band_plan.smem_layout. Every driver moves tiles through a tensor map over
the whole batch that the launch encodes from band_plan.tma_boxes
(`tma_unit` checks the model against the kernel's side once per
geometry); a K3 block exits once its stores have read the tile. The
drivers give bit-identical planes; the plain version is the same for all
three. A
segment with no stages is the stage-free copy (the reference's
compile_segment((), ()) of its profiler): each tile loaded and stored.

S5 and S6 run as runs: the packer writes into the first descriptor of
each maximal run of consecutive phase and parity stages (at most
MAX_DIAG_RUN, `diag_runs`) its length (F_RUN), and the kernel applies the
whole run in one pass over the tile, each stage's formula in stage order
(bit for bit the same stages as one-stage segments). A run of at least
ANGLE_MIN_RUN stages whose factors all have unit modulus takes the angle
form instead (`angle_table`): each element's turns summed exactly in
32-bit integers, then one sincospi and one complex multiply; its planes
agree with the plain version within the stage tolerance, not bit for
bit. A segment of phase stages only launches just the tiles it can
change (`phase_skip`): the free row bits every stage's predicate fixes
to one value leave the tile index (free_mask) and ride in fixed_rows, so
`Segment.tiles` counts 2^popcount(free_mask) tiles a state.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import FrozenSet, Sequence, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch.env import knob_value
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.apply import bit_view
from quest_tpu_torch.ops.band_plan import (
    HOPPER_GEOMETRY, LANE_QUBITS, LANES, Budgets, DiagVecStage, Geometry,
    BatchSelStage, MatStage, MultiPhaseStage, PairStage, ParityStage,
    PhaseStage, MAX_RING_SLOTS, OP_SLICE_BYTES, check_driver,
    TMA_PARTS, segment_geometry, smem_layout, tma_boxes)

DESC_WORDS = 18
# descriptor columns (csrc/segment.cu enum F_*)
(F_KIND, F_DIM, F_POS, F_REAL, F_SI, F_SJ, F_LANE_MASK, F_LANE_WANT,
 F_ROW_MASK, F_ROW_WANT, F_OP_OFF, F_FORMS, F_MASKED, F_TARGETS,
 F_POS2, F_SLOT, F_TIER, F_RUN) = range(18)
K_MAT, K_PHASE, K_PARITY, K_MULTIPHASE, K_PAIR, K_DIAGVEC, K_BATCHSEL = range(7)
MAT_DIMS = (2, 4, 8, 16, 32, 64, 128)
MAX_MULTIPHASE_ROWS = 64
MAX_DIAG_RUN = 64             # S5/S6 stages of one run (csrc MAX_DIAG_RUN)
ANGLE_MIN_RUN = 8             # runs from this length may take the angle form
MAX_MIXED = 32                # its stages with a lane and a row mask, at most
UNIT_TOL = 1e-6               # |factor| - 1 of a unit-modulus stage, at most
TURN = 2.0 ** 32              # the angle form's turn: 2 pi
MAX_TILE_BITS = 14
MAX_DIAG_TARGETS = 7          # fusion.DIAG_FUSE_MAX
TARGET_BITS = 6               # bits per qubit index in F_TARGETS
SEL_WORDS = 8                 # one selection-table row: a complex 2x2
MAX_GRID_BATCH = 65535        # states per grid-driver launch (gridDim.y)
TIER_CODE = {"highest": 0, "high": 1, "default": 2}   # csrc T_* codes
DRIVER_CODE = {"decoupled": 0, "inplace": 1, "grid": 2}  # csrc D_* codes
SLICED_MIN_DIM = 16           # d from which the operator is streamed in slices
WGMMA_K = 16                  # inputs per wgmma k-step (one B tile)
PLAIN_CHUNK_AMPS = 1 << 26    # amplitudes per slice of a plain contraction

_PORTED = (MatStage, PhaseStage, ParityStage, MultiPhaseStage, PairStage,
           DiagVecStage, BatchSelStage)


def check_supported(stages) -> None:
    """Raise NotImplementedError for a stage kind the port's kernel does
    not run."""
    for st in stages:
        if not isinstance(st, _PORTED):
            raise NotImplementedError(
                f"{type(st).__name__} is not ported yet (ROADMAP B)")


def rounds(st) -> bool:
    """Whether the stage's products take the matmul tier: the b0, b1 and
    scb contractions (the reference's `_mxu_dot_general` calls), not the
    elementwise `sc` butterfly."""
    return isinstance(st, MatStage) and st.kind != "sc"


def stage_label(st, tier: str = "highest") -> str:
    """Stage kind as the launch counts name it: b0, b1, scb<d>, sc, phase,
    parity, multiphase, pair, diagvec or batchsel; a b0/b1/scb stage at a
    tier below 'highest' gets it as a suffix (b0@high, scb128@default)."""
    if isinstance(st, MatStage):
        label = f"scb{st.dim}" if st.kind == "scb" else st.kind
        return label if tier == "highest" or not rounds(st) else (
            f"{label}@{tier}")
    return {PhaseStage: "phase", ParityStage: "parity",
            MultiPhaseStage: "multiphase", PairStage: "pair",
            DiagVecStage: "diagvec", BatchSelStage: "batchsel"}[type(st)]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One swept segment, packed for the kernel."""
    n: int
    stages: Tuple
    arrays: Tuple[np.ndarray, ...]       # host operands, planner layout
    geometry: Geometry
    desc: torch.Tensor                   # (stages, DESC_WORDS) int64
    ops: torch.Tensor                    # all operands, flat f32
    operands: Tuple[torch.Tensor, ...]   # per-stage planner operands for
    # the plain version: views into `ops`, except the embedded 128x128
    # blocks of 'lane'/'b1' pairs (the kernel's buffer holds their cores)
    scat_mask: int                       # scattered global row bits
    free_mask: int                       # row bits taken by the tile index
    fixed_mask: int                      # free row bits held fixed instead
    # (a segment of phase stages only, phase_skip; else 0)
    fixed_rows: int                      # their value in every tile
    labels: FrozenSet[str]               # stage_label of each stage
    slots: Tuple[int, ...]               # selection-table slots read by
    # its BatchSelStages, in stage order
    tier: str                            # matmul tier of b0/b1/scb stages
    driver: str                          # band_plan.DRIVERS
    nbuf: int                            # the in-place driver's plane slots
    # (QUEST_FUSED_NBUF; each launch clamps them, band_plan.ring_slots)

    @property
    def device(self) -> torch.device:
        return self.ops.device

    @property
    def tiles(self) -> int:
        """Tiles one launch runs per state: 2^popcount(free_mask), the
        geometry's blocks unless phase_skip held free bits fixed."""
        return 1 << bin(self.free_mask).count("1")


def _preds_masks(preds):
    mask = want = 0
    for bit, s in preds:
        mask |= 1 << bit
        want |= int(s) << bit
    return mask, want


def _set_preds(row: list, st) -> list:
    """Fill a descriptor's predicate fields from the stage's lane and row
    predicates; returns the row."""
    row[F_LANE_MASK], row[F_LANE_WANT] = _preds_masks(st.lane_preds)
    row[F_ROW_MASK], row[F_ROW_WANT] = _preds_masks(st.row_preds)
    row[F_MASKED] = int(bool(st.lane_preds or st.row_preds))
    return row


def _mat_row(st: MatStage, geo: Geometry, tier: str) -> list:
    """Descriptor of a matrix stage: contraction position inside the
    tile, operand strides (G[i, j] = op[i*si + j*sj]), tier and
    predicates."""
    d = st.dim
    w = d.bit_length() - 1
    if d not in MAT_DIMS:
        raise ValueError(f"matrix stage of dimension {d} not supported")
    if st.kind == "b0":
        pos = 0
    elif st.kind == "b1":
        pos = LANE_QUBITS
        if w > geo.inner_bits:
            raise ValueError(f"b1 d={d} needs {w} inner row bits, "
                             f"geometry holds {geo.inner_bits}")
    elif st.kind in ("scb", "sc"):
        pos = LANE_QUBITS + geo.tile_row_bit(st.bit)
        for k in range(w):
            if LANE_QUBITS + geo.tile_row_bit(st.bit + k) != pos + k:
                raise ValueError(f"{st.kind} bits {st.bit}+{w} are not "
                                 f"adjacent tile axes in {geo}")
    else:
        raise ValueError(f"unknown matrix stage kind {st.kind!r}")
    si, sj = (1, d) if stores_transpose(st) else (d, 1)
    row = [0] * DESC_WORDS
    row[F_KIND], row[F_DIM], row[F_POS], row[F_REAL] = (
        K_MAT, d, pos, int(st.real_only))
    row[F_SI], row[F_SJ] = si, sj
    row[F_TIER] = TIER_CODE[tier] if rounds(st) else 0
    return _set_preds(row, st)


def stores_transpose(st: MatStage) -> bool:
    """Whether the planner stores the stage's operator as G^T (X @ G^T
    form: b0, b1 and 128-wide scb) rather than G (narrow scb and sc;
    quest_tpu/ops/pallas_band.py:462-468)."""
    return st.kind in ("b0", "b1") or (st.kind == "scb" and st.dim == LANES)


def _operator(st: MatStage, arr: np.ndarray) -> np.ndarray:
    """(2, d, d) planes of G[i, j] (out_i = sum_j G[i, j] x_j) from the
    planner's operand."""
    return arr.transpose(0, 2, 1) if stores_transpose(st) else arr


def _bf16_bits(x: torch.Tensor) -> np.ndarray:
    """uint32 holding the bf16 encoding (RNE) of each value of f32 x."""
    b = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return b.astype(np.uint32)


def tier_parts(g: np.ndarray, tier: str) -> np.ndarray:
    """(P, d, d) uint32 bf16 encodings of the tier's parts of the operator
    planes g (2, d, d): 'high' -> [re_hi, re_lo, im_hi, im_lo], 'default'
    -> [re, im]."""
    t = torch.from_numpy(np.ascontiguousarray(g, dtype=np.float32))
    if tier == "high":
        parts = [p for plane in t for p in precision.split_hi_lo(plane)]
    elif tier == "default":
        parts = list(t)
    else:
        raise ValueError(f"no bf16 parts at tier {tier!r}")
    return np.stack([_bf16_bits(p) for p in parts])


def perm16(x):
    """Position 2t + e (+ 8 h) of a 16-group of the kernel's wgmma
    fragments -> the input or output it carries: 4t + 2h + e, so that the
    thread holding fragment columns 2t, 2t + 1, 2t + 8, 2t + 9 reads (and
    writes) four consecutive elements."""
    x = np.asarray(x)
    return 4 * ((x & 7) >> 1) + 2 * ((x >> 3) & 1) + (x & 1)


def operand_perm(d: int) -> np.ndarray:
    """perm16 over each group of 16 of d indices: the order in which the
    tier body's B tiles list inputs (k) and outputs (n)."""
    x = np.arange(d)
    return (x & ~15) | perm16(x & 15)


def slice_rows(g: np.ndarray) -> np.ndarray:
    """HIGHEST operand of a d >= 16 stage from G planes (2, d, d): row j =
    [Gre[:, j], Gim[:, j]] (d, 2, d) f32, KB = min(d, OP_SLICE_BYTES /
    (8 d)) rows to a slice."""
    return np.ascontiguousarray(g.transpose(2, 0, 1), dtype=np.float32)


def tier_tiles(g: np.ndarray, tier: str) -> np.ndarray:
    """bf16 B tiles (uint16) of the operator planes g (2, d, d) at `tier`:
    (d / 16 k-steps, parts, d / 8 output groups, 2 input halves, 8
    outputs, 8 inputs). Tile (ks, part) holds B[k, n] = part[perm(n),
    perm(16 ks + k)] (perm = operand_perm) as wgmma's K-major no-swizzle
    layout: 8x8 core matrices of 16-byte rows (8 inputs of one output),
    the input halves 128 bytes apart (LBO), the output groups 256 (SBO)."""
    d = g.shape[-1]
    parts = tier_parts(g, tier).astype(np.uint16)      # (P, i, j)
    perm = operand_perm(d)
    b = parts[:, perm][:, :, perm]                      # P, n, j (logical)
    b = b.reshape(-1, d // 8, 8, d // WGMMA_K, 2, 8)    # P ng nr ks kh kr
    return np.ascontiguousarray(b.transpose(3, 0, 1, 4, 2, 5))


def _tier_words(st: MatStage, arr: np.ndarray, tier: str) -> np.ndarray:
    """The operator of a tier stage (d >= 16) as the kernel's slices:
    tier_tiles, k-step major, two bf16 to a word (the lower index in the
    low half), viewed as f32."""
    t = tier_tiles(_operator(st, arr), tier).reshape(-1).astype(np.uint32)
    return (t[0::2] | (t[1::2] << 16)).view(np.float32)


def slice_operator(st: MatStage, arr: np.ndarray, tier: str) -> np.ndarray:
    """The flat f32 operand of a d >= 16 matrix stage as the kernel
    streams it: slice_rows at 'highest', _tier_words at a tier."""
    if rounds(st) and tier != "highest":
        return _tier_words(st, arr, tier)
    return slice_rows(_operator(st, arr)).reshape(-1)


def _tile_pos(geo: Geometry, row_bit: int) -> int:
    """Tile index bit of GLOBAL row bit `row_bit` (inner or scattered)."""
    if row_bit < geo.inner_bits or row_bit in geo.scat:
        return LANE_QUBITS + geo.tile_row_bit(row_bit)
    raise ValueError(f"row bit {row_bit} is neither an inner row nor a "
                     f"scattered axis of {geo}")


def _embedded_t(core: np.ndarray, q: int) -> np.ndarray:
    """The planner's packing of a 2x2 block embedded at bit q of a 7-bit
    space: E^T with E[i, j] = core[i_q, j_q] where the other bits of i and
    j agree (band_plan._embed_2x2, stored transposed)."""
    i = np.arange(LANES)
    same = ((i[:, None] ^ i[None, :]) & (LANES - 1) & ~(1 << q)) == 0
    return core[(i[None, :] >> q) & 1, (i[:, None] >> q) & 1] * same


def pair_core(st: PairStage, arr: np.ndarray):
    """(op bit, (2, 4, 2, 2) cores) of a PairStage operand. 2-wide forms
    carry their cores as they are (op bit: the GLOBAL row bit op_bit);
    'lane' and 'b1' forms carry 128x128 embeddings stored transposed,
    reduced here to the 2x2 block they embed and the bit q they embed it
    at (a lane bit, or the row bit q for 'b1'). Raises ValueError unless
    every block is exactly that embedding."""
    if st.op_dim == 2:
        if arr.shape != (2, 4, 2, 2):
            raise ValueError(f"pair operand shape {arr.shape}")
        return st.op_bit, arr
    if arr.shape != (2, 4, LANES, LANES):
        raise ValueError(f"pair operand shape {arr.shape}")
    for q in range(LANE_QUBITS):
        sel = [0, 1 << q]
        cores = arr[:, :, sel][:, :, :, sel].transpose(0, 1, 3, 2)
        if all(np.array_equal(arr[p, b], _embedded_t(cores[p, b], q))
               for p in range(2) for b in range(4)):
            return q, np.ascontiguousarray(cores)
    raise ValueError(f"{st.op_kind} pair operand is not a 2x2 block "
                     f"embedded at one bit")


def _pair_row(st: PairStage, arr: np.ndarray, geo: Geometry):
    """(descriptor, packed (2, 4, 2, 2) cores) of a PairStage: op bit at
    tile position F_POS, sliced bit at F_POS2."""
    q, cores = pair_core(st, arr)
    pos = q if st.op_kind == "lane" else _tile_pos(geo, q)
    row = [0] * DESC_WORDS
    row[F_KIND], row[F_POS] = K_PAIR, pos
    row[F_POS2] = _tile_pos(geo, st.sliced_bit)
    row[F_REAL] = int(st.real_only)
    return _set_preds(row, st), cores


def _diagvec_row(st: DiagVecStage, arr: np.ndarray) -> list:
    """Descriptor of a DiagVecStage: k in F_DIM, the GLOBAL target qubits
    packed TARGET_BITS apart in F_TARGETS (targets[j] selects bit j of
    the table index)."""
    k = len(st.targets)
    if k > MAX_DIAG_TARGETS or arr.shape != (2, 1 << k):
        raise ValueError(f"diagonal of {k} targets, operand {arr.shape}")
    row = [0] * DESC_WORDS
    row[F_KIND], row[F_DIM] = K_DIAGVEC, k
    row[F_TARGETS] = sum(q << (TARGET_BITS * j)
                         for j, q in enumerate(st.targets))
    return _set_preds(row, st)


def _batchsel_row(st: BatchSelStage, geo: Geometry) -> list:
    """Descriptor of a BatchSelStage: the tile position of its qubit (a
    lane bit, an inner row or a scattered axis) in F_POS, its
    selection-table slot in F_SLOT."""
    q = st.qubit
    row = [0] * DESC_WORDS
    row[F_KIND] = K_BATCHSEL
    row[F_POS] = q if q < LANE_QUBITS else _tile_pos(geo, q - LANE_QUBITS)
    row[F_SLOT] = st.index
    return row


def diag_runs(kinds: Sequence[int]) -> list:
    """(first stage, length) of each run of descriptor kinds `kinds`:
    the maximal runs of consecutive K_PHASE / K_PARITY stages, each cut
    into pieces of at most MAX_DIAG_RUN (a run is one 64-bit word per
    lane and per row in the kernel)."""
    runs, s = [], 0
    while s < len(kinds):
        if kinds[s] not in (K_PHASE, K_PARITY):
            s += 1
            continue
        e = s
        while (e < len(kinds) and kinds[e] in (K_PHASE, K_PARITY)
               and e - s < MAX_DIAG_RUN):
            e += 1
        runs.append((s, e - s))
        s = e
    return runs


def angle_table(stages: Sequence, arrays: Sequence[np.ndarray]):
    """The angle form's int32 table (k, 2) of a run of phase and parity
    stages — per stage T_off, the element's turn where its bit is clear,
    and D, what its bit adds, in units of 2 pi / 2^32 — or None when the
    run keeps the exact form: shorter than ANGLE_MIN_RUN, a factor whose
    modulus is not 1 within UNIT_TOL, or more than MAX_MIXED stages with
    both a lane and a row mask. S5 (tre, tim): 0 and its phase; S6 (cos
    h, sin h), whose factor is cos h - i sin h (-1)^parity: -h and 2h.
    The angles are taken in f64 from the f32 operands."""
    if len(stages) < ANGLE_MIN_RUN:
        return None
    rows, mixed = [], 0
    for st, arr in zip(stages, arrays):
        a, b = float(arr[0, 0]), float(arr[0, 1])
        if abs(math.hypot(a, b) - 1.0) > UNIT_TOL:
            return None
        turn = round(math.atan2(b, a) / (2 * math.pi) * TURN)
        rows.append((0, turn) if isinstance(st, PhaseStage)
                    else (-turn, 2 * turn))
        rm = (_row_mask(arr[0, 4], arr[0, 5]) if isinstance(st, PhaseStage)
              else _row_mask(arr[0, 3], arr[0, 4]))
        mixed += bool(int(arr[0, 2]) and rm)
    if mixed > MAX_MIXED:
        return None
    t = np.array(rows, np.int64) % (1 << 32)
    return t.astype(np.uint32).view(np.int32)


def phase_skip(stages: Sequence, arrays: Sequence[np.ndarray],
               free_mask: int) -> Tuple[int, int]:
    """(fixed mask, fixed rows) of a segment: for a non-empty segment of
    PhaseStages only, the bits of `free_mask` (the free row bits of its
    tiles) that every stage's row predicate fixes to one value, and that
    value; its launch runs only the tiles whose free bits hold it (every
    amplitude of another tile fails some stage's predicate, so no stage
    changes it). (0, 0) for any other segment."""
    if not stages or not all(isinstance(st, PhaseStage) for st in stages):
        return 0, 0
    mask, want = free_mask, None
    for arr in arrays:
        rm, rw = _row_mask(arr[0, 4], arr[0, 5]), _row_mask(arr[0, 6],
                                                            arr[0, 7])
        mask &= rm
        if want is not None:
            mask &= ~(rw ^ want)
        want = rw
    return mask, want & mask


def prepare_segment(stages: Sequence, arrays: Sequence[np.ndarray], n: int,
                    device, budgets: Budgets = HOPPER_GEOMETRY,
                    tier: str = None, driver: str = None,
                    nbuf: int = None) -> Segment:
    """Pack one segment — its geometry, a descriptor table (one int64 row
    of DESC_WORDS per stage) and one flat f32 buffer of every operand —
    for matmul `tier` (None: the session's, precision.matmul_precision)
    and `driver` with `nbuf` in-place slots (None: the knobs'), and move
    the table and buffer to `device` (once, at compile time). An empty
    stage list is the stage-free copy."""
    check_supported(stages)
    tier = precision.check_tier(tier or precision.matmul_precision())
    driver = check_driver(driver)
    nbuf = knob_value("QUEST_FUSED_NBUF") if nbuf is None else int(nbuf)
    if not 2 <= nbuf <= MAX_RING_SLOTS:
        raise ValueError(f"nbuf must be in [2, {MAX_RING_SLOTS}], got {nbuf}")
    if len(stages) != len(arrays):
        raise ValueError("a segment needs one operand array per stage")
    geo = segment_geometry(stages, n, budgets=budgets)
    if geo.tile_bits > MAX_TILE_BITS:
        raise ValueError(f"tile of {geo.tile_bits} bits exceeds the "
                         f"kernel's {MAX_TILE_BITS}")
    arrays = tuple(np.asarray(a, dtype=np.float32) for a in arrays)
    rows, offs, packed, chunks = [], [], [], []
    off = 0
    for st, arr in zip(stages, arrays):
        kernel_arr = arr
        if isinstance(st, PairStage):
            row, kernel_arr = _pair_row(st, arr, geo)
        elif isinstance(st, BatchSelStage):
            # its operand is the per-call selection table, not a buffer
            # entry; the planner's (batch, 8) placeholder stays host-side
            row = _batchsel_row(st, geo)
            kernel_arr = np.zeros(0, np.float32)
        elif isinstance(st, DiagVecStage):
            row = _diagvec_row(st, arr)
        elif isinstance(st, MatStage):
            if arr.shape != (2, st.dim, st.dim):
                raise ValueError(f"{st.kind} operand shape {arr.shape}")
            row = _mat_row(st, geo, tier)
            if st.dim >= SLICED_MIN_DIM:
                kernel_arr = slice_operator(st, arr, tier)
                pad = -off % 4                   # 16-byte bulk copies
                chunks.append(np.zeros(pad, np.float32))
                off += pad
        elif isinstance(st, MultiPhaseStage):
            m = len(st.forms)
            if arr.shape != (m, 8) or m > MAX_MULTIPHASE_ROWS:
                raise ValueError(f"multiphase operand shape {arr.shape} "
                                 f"(at most {MAX_MULTIPHASE_ROWS} rows)")
            row = [0] * DESC_WORDS
            row[F_KIND], row[F_DIM] = K_MULTIPHASE, m
            # bit r: row r is a parity term; bit 63 is the int64's sign
            # (the kernel reads the word's 64 bits)
            forms = sum(1 << r for r, f in enumerate(st.forms) if f == "p")
            row[F_FORMS] = forms - (1 << 64) if forms >> 63 else forms
        else:
            if arr.shape != (1, 8):
                raise ValueError(f"phase operand shape {arr.shape}")
            row = [0] * DESC_WORDS
            row[F_KIND] = K_PHASE if isinstance(st, PhaseStage) else K_PARITY
        row[F_OP_OFF] = off
        rows.append(row)
        packed.append(kernel_arr)
        chunks.append(kernel_arr.reshape(-1))
        offs.append(off)
        off += kernel_arr.size
    # each run's length in its head; a long unit-modulus run's angle table
    # after the operands (F_FORMS bit 0, F_TARGETS its offset)
    for first, length in diag_runs([r[F_KIND] for r in rows]):
        rows[first][F_RUN] = length
        table = angle_table(stages[first:first + length],
                            arrays[first:first + length])
        if table is not None:
            rows[first][F_FORMS], rows[first][F_TARGETS] = 1, off
            chunks.append(table.reshape(-1).view(np.float32))
            off += table.size
    # the kernel's buffer holds each operand as it reads it (pair cores);
    # `operands` keeps the planner's arrays for the plain version
    flat = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    desc = np.array(rows, dtype=np.int64).reshape(-1, DESC_WORDS)
    dev = torch.device(device)
    ops = torch.from_numpy(flat).to(dev)
    operands = tuple(
        ops[o:o + a.size].view(a.shape) if a is k
        else torch.from_numpy(a).to(dev)
        for o, a, k in zip(offs, arrays, packed))
    row_bits = n - LANE_QUBITS
    scat_mask = sum(1 << s for s in geo.scat)
    free_mask = (((1 << row_bits) - 1) & ~scat_mask
                 & ~((1 << geo.inner_bits) - 1))
    fixed_mask, fixed_rows = phase_skip(stages, arrays, free_mask)
    return Segment(n=n, stages=tuple(stages), arrays=arrays, geometry=geo,
                   desc=torch.from_numpy(desc).to(dev), ops=ops,
                   operands=operands, scat_mask=scat_mask,
                   free_mask=free_mask & ~fixed_mask, fixed_mask=fixed_mask,
                   fixed_rows=fixed_rows,
                   labels=frozenset(stage_label(st, tier) for st in stages),
                   slots=tuple(st.index for st in stages
                               if isinstance(st, BatchSelStage)),
                   tier=tier, driver=driver, nbuf=nbuf)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_quest_declared", False):
        vp, ci, cu, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                           ctypes.c_longlong)
        lib.quest_segment_sweep.argtypes = [vp, ci, ci, ci, cu, cu, cu, vp,
                                            ci, vp, cll, ci, ci, ci, vp, ci,
                                            ci, ci, ci, ci, cll, vp]
        lib.quest_segment_sweep.restype = ci
        lib.quest_segment_tma_geometry.argtypes = [ci, ci, ci, cu, ci, ci,
                                                   ci, vp]
        lib.quest_segment_tma_geometry.restype = ci
        lib.quest_segment_tma_encode.argtypes = [vp, ci, ci, ci, cu, ci, ci,
                                                 ci, ci]
        lib.quest_segment_tma_encode.restype = ci
        lib.quest_segment_smem_bytes.argtypes = [ci, ci, ci]
        lib.quest_segment_smem_bytes.restype = cll
        lib.quest_segment_desc_words.restype = ci
        lib.quest_segment_max_tile_bits.restype = ci
        lib.quest_segment_max_multiphase_rows.restype = ci
        lib.quest_segment_op_slice_bytes.restype = ci
        lib.quest_segment_max_grid_batch.restype = ci
        lib.quest_cuda_error_string.argtypes = [ci]
        lib.quest_cuda_error_string.restype = ctypes.c_char_p
        layout = (lib.quest_segment_desc_words(),
                  lib.quest_segment_max_tile_bits(),
                  lib.quest_segment_max_multiphase_rows(),
                  lib.quest_segment_op_slice_bytes(),
                  lib.quest_segment_max_grid_batch())
        if layout != (DESC_WORDS, MAX_TILE_BITS, MAX_MULTIPHASE_ROWS,
                      OP_SLICE_BYTES, MAX_GRID_BATCH):
            raise RuntimeError(f"segment kernel layout {layout} does not "
                               f"match the packer's")
        for tb in range(LANE_QUBITS + 3, MAX_TILE_BITS + 1):
            for driver, code in DRIVER_CODE.items():
                for nbuf in range(2, MAX_RING_SLOTS + 1):
                    lay = smem_layout(tb, 1 << 20, driver, nbuf)
                    got = lib.quest_segment_smem_bytes(tb, code, lay["slots"])
                    if got != lay["total_bytes"]:
                        raise RuntimeError(
                            f"shared memory of a {driver} launch at {tb} "
                            f"tile bits: kernel {got}, planner "
                            f"{lay['total_bytes']}")
        lib._quest_declared = True
    return lib


_TMA_CHECKED = set()     # (n, geometry, batch, parts, box rows) checked


def tma_unit(seg: Segment, batch: int, copy_unit=None) -> dict:
    """band_plan.tma_boxes of a launch of `seg` over `batch` states (under
    the grid driver, every slice of the batch shares the one map),
    at the copy unit `copy_unit` ((parts, box rows); None: the kernel's
    default), checked once per geometry against the C side's
    quest_segment_tma_geometry (dims, strides, box, requests per plane).
    Raises ValueError for a unit the geometry cannot take."""
    parts, box_rows = copy_unit or (TMA_PARTS, None)
    boxes = tma_boxes(seg.geometry, batch, parts=parts, box_rows=box_rows)
    key = (seg.n, seg.geometry, batch, parts, boxes["box_rows"])
    if key not in _TMA_CHECKED:
        geo = seg.geometry
        out = (ctypes.c_longlong * 15)()
        rc = _lib().quest_segment_tma_geometry(
            seg.n, geo.tile_bits, geo.inner_bits, seg.scat_mask, batch, parts,
            boxes["box_rows"], out)
        got = (tuple(out[0:5]), tuple(out[5:9]), tuple(out[9:14]), out[14])
        want = (boxes["dims"], boxes["strides"], boxes["box"],
                boxes["requests_per_plane"])
        if rc != 0 or got != want:
            raise RuntimeError(f"tensor map of {geo} x {batch}: kernel "
                               f"{got} (rc {rc}), model {want}")
        _TMA_CHECKED.add(key)
    return boxes


def grid_batch_slices(batch: int, driver: str) -> list:
    """(first state, states) of each launch of one sweep over `batch`
    states: one launch under the ring drivers (their steps fold the batch
    in), launches of at most MAX_GRID_BATCH states (gridDim.y) under the
    grid driver, in order."""
    if batch < 1:
        raise ValueError(f"a sweep needs at least one state, got {batch}")
    if check_driver(driver) != "grid":
        return [(0, batch)]
    return [(s, min(MAX_GRID_BATCH, batch - s))
            for s in range(0, batch, MAX_GRID_BATCH)]


def batch_of(amps: torch.Tensor, n: int) -> int:
    """0 for one state's planes ((2, 2^n) or (2, rows, 128)), B for a
    batch of states ((B, 2, 2^n) or (B, 2, rows, 128)). Raises ValueError
    for any other shape."""
    shape = tuple(amps.shape)
    if amps.dim() in (2, 3) and shape[0] == 2 and amps.numel() == 2 << n:
        if amps.dim() == 2 or shape[2] == LANES:
            return 0
    elif amps.dim() in (3, 4) and shape[0] >= 1 and shape[1] == 2:
        tail = shape[2:]
        if tail in ((1 << n,), (1 << (n - LANE_QUBITS), LANES)):
            return shape[0]
    raise ValueError(f"state of shape {shape} is not (2, 2^{n}), "
                     f"(2, rows, 128) or a batch (B, 2, ...) of either")


def _check_state(amps: torch.Tensor, seg: Segment) -> int:
    """Validate the state; returns the states it holds (1 unbatched)."""
    if amps.dtype != torch.float32:
        raise TypeError(f"segment_sweep takes float32 planes, got {amps.dtype}")
    batch = max(1, batch_of(amps, seg.n))
    if not amps.is_contiguous():
        raise ValueError("segment_sweep needs a contiguous state")
    if amps.device != seg.device:
        raise ValueError(f"state on {amps.device}, segment on {seg.device}")
    return batch


def _check_sel(sel, seg: Segment, batch: int) -> None:
    if not seg.slots:
        return
    if sel is None:
        raise ValueError("a segment with BatchSelStages needs a selection "
                         "table (slots, B, 8)")
    if (sel.dtype != torch.float32 or sel.dim() != 3
            or tuple(sel.shape[1:]) != (batch, SEL_WORDS)
            or sel.shape[0] <= max(seg.slots)):
        raise ValueError(f"selection table {tuple(sel.shape)} {sel.dtype} is "
                         f"not float32 (> {max(seg.slots)}, {batch}, 8)")
    if not sel.is_contiguous() or sel.device != seg.device:
        raise ValueError(f"selection table must be contiguous on "
                         f"{seg.device}")


# profiling.op_metrics counts the work of a call: each segment launch,
# passthrough and XLA-engine program call reports itself to every
# recorder here, recorder(kind, obj, batch, rbytes) -> True when the call
# is a dry count (planes on the meta device) and must skip the work
WORK_RECORDERS: list = []


def note_work(kind: str, obj, batch: int, rbytes: int = 4) -> bool:
    """Report one unit of work ('segment', 'pass' or 'xla') to the active
    recorders; True when the caller is to skip it (a dry count)."""
    dry = False
    for record in WORK_RECORDERS:
        dry = record(kind, obj, batch, rbytes) or dry
    return dry


def segment_sweep(amps: torch.Tensor, seg: Segment,
                  sel: torch.Tensor = None, *,
                  copy_unit=None) -> torch.Tensor:
    """Apply segment `seg` in place to `amps` — one state's planes ((2,
    2^n) or (2, rows, 128) f32) or a batch of B states ((B, 2, 2^n) or
    (B, 2, rows, 128)) — and return it: on a CUDA tensor one kernel
    launch whatever B is (the grid driver: grid_batch_slices), the plain
    version on a CPU tensor. `sel` is
    the selection table (slots, B, 8) its BatchSelStages read (B = 1
    for unbatched planes); None when it has none. `copy_unit` (parts per
    plane, rows per box) overrides the tensor-map copy unit (tma_unit)
    for measurements that compare units; the planes are the same under
    every unit."""
    if WORK_RECORDERS and note_work("segment", seg,
                                    max(1, batch_of(amps, seg.n))):
        return amps
    batch = _check_state(amps, seg)
    _check_sel(sel, seg, batch)
    if amps.device.type == "cpu":
        out = segment_sweep_reference(amps, seg.stages, seg.operands, seg.n,
                                      sel, seg.tier)
        return amps.copy_(out.reshape(amps.shape))
    if amps.device.type != "cuda":
        raise ValueError(f"segment_sweep runs on cuda or cpu, not {amps.device}")
    if amps.data_ptr() % 16:
        raise ValueError("segment_sweep needs 16-byte aligned planes "
                         "(tensor-map copies)")
    lib = _lib()
    geo = seg.geometry
    lay = smem_layout(geo.tile_bits, seg.tiles * batch, seg.driver, seg.nbuf)
    boxes = tma_unit(seg, batch, copy_unit)
    with torch.cuda.device(amps.device):
        stream = torch.cuda.current_stream(amps.device).cuda_stream
        for state0, states in grid_batch_slices(batch, seg.driver):
            rc = lib.quest_segment_sweep(
                amps.data_ptr(), seg.n, geo.tile_bits, geo.inner_bits,
                seg.scat_mask, seg.free_mask, seg.fixed_rows,
                seg.desc.data_ptr(), len(seg.stages), seg.ops.data_ptr(),
                seg.tiles, batch,
                state0, states, sel.data_ptr() if seg.slots else None,
                TIER_CODE[seg.tier], DRIVER_CODE[seg.driver], lay["slots"],
                boxes["parts"], boxes["box_rows"], lay["total_bytes"], stream)
            if rc != 0:
                raise RuntimeError(
                    f"segment kernel launch ({seg.driver}, {lay['slots']} "
                    f"slots, {lay['total_bytes']} B of shared memory, states "
                    f"{state0}..{state0 + states - 1}) failed: CUDA error "
                    f"{rc} ({lib.quest_cuda_error_string(rc).decode()})")
            segment_sweep.launches += 1
            segment_sweep.driver_launches[seg.driver] = (
                segment_sweep.driver_launches.get(seg.driver, 0) + 1)
            for label in seg.labels:
                segment_sweep.stage_launches[label] = (
                    segment_sweep.stage_launches.get(label, 0) + 1)
    return amps


segment_sweep.launches = 0
segment_sweep.stage_launches = {}
segment_sweep.driver_launches = {}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _pred_mask(lane, row, lane_preds, row_preds):
    mask = None
    for bit, want in lane_preds:
        m = ((lane >> bit) & 1) == want
        mask = m if mask is None else mask & m
    for bit, want in row_preds:
        m = ((row >> bit) & 1) == want
        mask = m if mask is None else mask & m
    return mask


def _parity(x, mask: int):
    """Parity of the bits of `x` selected by `mask` (int tensor)."""
    par = torch.zeros_like(x)
    b = 0
    while mask >> b:
        if (mask >> b) & 1:
            par = par ^ ((x >> b) & 1)
        b += 1
    return par


def _sign(x, mask: int):
    """(-1)^parity of the bits of `x` selected by `mask`, as f32. Taken
    per axis (lane or row ids) and multiplied in by broadcasting, since
    (-1)^(a^b) = (-1)^a (-1)^b: no full-state integer temporaries."""
    return 1.0 - 2.0 * _parity(x, mask).to(torch.float32)


def _row_mask(lo, hi) -> int:
    return int(lo) | (int(hi) << 15)


def _states_view(n: int, qubits, batch: int):
    """bit_view of a batch of `batch` n-qubit states laid end to end: the
    batch joins the highest gap axis."""
    dims, axis_of = bit_view(n, qubits)
    dims[0] *= batch
    return dims, axis_of


def _contract(re, im, g, st: MatStage, n: int, tier: str):
    """Apply the stage's operator to the planes (each B x 2^n amplitudes,
    the states end to end): out[.., i, ..] = sum_j G[i, j] x[.., j, ..]
    over the stage's bits, in the real-block form the kernel uses (out_re
    = Gre x_re - Gim x_im, out_im = Gre x_im + Gim x_re; two products when
    the operator is real), each product at `tier` (b0/b1/scb; `sc` is
    exact at every tier)."""
    d = st.dim
    w = d.bit_length() - 1
    if st.kind == "b0":
        q0 = 0
    elif st.kind == "b1":
        q0 = LANE_QUBITS
    else:
        q0 = LANE_QUBITS + st.bit
    gre, gim = (g[0].T, g[1].T) if stores_transpose(st) else (g[0], g[1])
    shape = (-1, d, 1 << q0)
    xr, xi = re.reshape(shape), im.reshape(shape)
    t = tier if rounds(st) else "highest"

    def mm(a, b):
        return precision.tier_matmul(a, b, t)
    # in slices of the leading axis, so that a tier's rounded parts stay
    # small beside a 30-qubit state
    nre, nim = torch.empty_like(xr), torch.empty_like(xi)
    step = max(1, PLAIN_CHUNK_AMPS // (d << q0))
    for a in range(0, xr.shape[0], step):
        r, i = xr[a:a + step], xi[a:a + step]
        if st.real_only:
            nre[a:a + step], nim[a:a + step] = mm(gre, r), mm(gre, i)
        else:
            nre[a:a + step] = mm(gre, r) - mm(gim, i)
            nim[a:a + step] = mm(gre, i) + mm(gim, r)
    return nre, nim


def _pair(re, im, g, st: PairStage, n: int, batch: int):
    """Apply a Kraus pair to the planes ((rows, 128) each): the sliced
    qubit's halves c select blocks B[r*2+c] applied on the op side,
    out_r = sum_c B[r*2+c] x_c (ref _apply_pair_stage). 2-wide forms
    take per-axis views of both bits; 'lane' and 'b1' forms contract with
    the 128x128 embedded blocks as the reference does."""
    q_sl = LANE_QUBITS + st.sliced_bit
    nre, nim = torch.empty_like(re), torch.empty_like(im)
    if st.op_dim == 2:
        v = g.cpu().numpy()
        q_op = LANE_QUBITS + st.op_bit
        dims, axis_of = _states_view(n, (q_op, q_sl), batch)
        a_op, a_sl = axis_of[q_op], axis_of[q_sl]

        def part(x, sl, o):
            return x.view(dims).narrow(a_sl, sl, 1).narrow(a_op, o, 1)
        for r in range(2):
            for ao in range(2):
                acc_r = acc_i = 0.0
                for c in range(2):
                    for ai in range(2):
                        gr = float(v[0, r * 2 + c, ao, ai])
                        gi = float(v[1, r * 2 + c, ao, ai])
                        xr, xi = part(re, c, ai), part(im, c, ai)
                        acc_r = acc_r + gr * xr
                        acc_i = acc_i + gr * xi
                        if not st.real_only:
                            acc_r = acc_r - gi * xi
                            acc_i = acc_i + gi * xr
                part(nre, r, ao).copy_(acc_r)
                part(nim, r, ao).copy_(acc_i)
        return nre, nim
    dims, _ = _states_view(n, (q_sl,), batch)

    def half(x, c):
        return x.view(dims).narrow(1, c, 1)

    def block(gg, x):
        if st.op_kind == "lane":            # X @ G^T, G^T stored
            return torch.matmul(x.reshape(-1, LANES), gg)
        # 'b1': contract the lowest 7 row bits, G^T stored
        return torch.matmul(gg.T, x.reshape(-1, LANES, LANES))
    for r in range(2):
        acc_r = acc_i = 0.0
        for c in range(2):
            gre, gim = g[0, r * 2 + c], g[1, r * 2 + c]
            xr, xi = half(re, c), half(im, c)
            acc_r = acc_r + block(gre, xr).reshape(xr.shape)
            acc_i = acc_i + block(gre, xi).reshape(xi.shape)
            if not st.real_only:
                acc_r = acc_r - block(gim, xi).reshape(xi.shape)
                acc_i = acc_i + block(gim, xr).reshape(xr.shape)
        half(nre, r).copy_(acc_r)
        half(nim, r).copy_(acc_i)
    return nre, nim


def _diagvec(re, im, g, st: DiagVecStage, n: int, batch: int):
    """Multiply each amplitude by the table entry its target bits select,
    where its predicates hold (ref _apply_diagvec_stage): the table is
    expanded over one axis per target and predicate bit of a per-axis
    view and multiplied in by broadcasting."""
    preds = ([(b, w) for b, w in st.lane_preds]
             + [(LANE_QUBITS + b, w) for b, w in st.row_preds])
    qubits = sorted(set(st.targets) | {q for q, _ in preds}, reverse=True)
    dims, axis_of = _states_view(n, qubits, batch)
    v = g.cpu().numpy().astype(np.float64)
    table = v[0] + 1j * v[1]
    bits = np.arange(1 << len(qubits))    # bit i of a combo <-> qubits[i]
    val = {q: (bits >> i) & 1 for i, q in enumerate(qubits)}
    idx = sum(val[q] << j for j, q in enumerate(st.targets))
    factor = table[idx]
    for q, want in preds:
        factor = np.where(val[q] == want, factor, 1.0)
    # combos enumerate qubits[0] fastest; the view has qubits[0] first
    shape = [2 if a in axis_of.values() else 1 for a in range(len(dims))]
    factor = factor.reshape((2,) * len(qubits), order="F").reshape(shape)
    fre = torch.as_tensor(factor.real, dtype=torch.float32, device=re.device)
    fim = torch.as_tensor(factor.imag, dtype=torch.float32, device=re.device)
    xr, xi = re.view(dims), im.view(dims)
    nre = xr * fre - xi * fim
    nim = xr * fim + xi * fre
    return nre.reshape(re.shape), nim.reshape(im.shape)


def _batchsel(re, im, rows, q: int):
    """Apply each state's 2x2 (its (8,) row of `rows`, (B, 8)) on qubit q:
    new_0 = g00 x_0 + g01 x_1, new_1 = g10 x_0 + g11 x_1 (ref
    _apply_batchsel_stage, here on a per-state view of the bit)."""
    b = rows.shape[0]
    v = [rows[:, j].reshape(b, 1, 1) for j in range(SEL_WORDS)]
    xr = re.reshape(b, -1, 2, 1 << q)
    xi = im.reshape(b, -1, 2, 1 << q)
    r0, r1, i0, i1 = xr[:, :, 0], xr[:, :, 1], xi[:, :, 0], xi[:, :, 1]
    out = []
    for a in (0, 4):           # output bit 0 from row 0, bit 1 from row 1
        out.append((v[a] * r0 - v[a + 1] * i0 + v[a + 2] * r1 - v[a + 3] * i1,
                    v[a] * i0 + v[a + 1] * r0 + v[a + 2] * i1 + v[a + 3] * r1))
    nre = torch.stack([out[0][0], out[1][0]], dim=2).reshape(re.shape)
    nim = torch.stack([out[0][1], out[1][1]], dim=2).reshape(im.shape)
    return nre, nim


def segment_sweep_reference(amps: torch.Tensor, stages: Sequence,
                            arrays: Sequence, n: int,
                            sel: torch.Tensor = None,
                            tier: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of one segment: every stage applied to the
    whole state, or to every state of a batch, in turn, the b0/b1/scb
    contractions at matmul `tier`. `arrays` are the planner's operands
    (numpy or torch); a BatchSelStage reads its slot of the selection
    table `sel` (slots, B, 8) instead. Returns new (2, 2^(n-7), 128)
    planes, or (B, 2, 2^(n-7), 128) for a batch; `amps` is not
    changed."""
    check_supported(stages)
    precision.check_tier(tier)
    precision.ieee_fp32()
    dev = amps.device
    batched = batch_of(amps, n)
    batch = max(1, batched)
    # the states end to end in each plane: the batch index becomes the
    # highest row bits, which no stage's masks or bits reach
    x = amps.reshape(batch, 2, -1, LANES)
    re, im = x[:, 0].reshape(-1, LANES), x[:, 1].reshape(-1, LANES)
    rows = re.shape[0]
    lane = torch.arange(LANES, device=dev).reshape(1, LANES)
    row = torch.arange(rows, device=dev).reshape(rows, 1)
    for st, arr in zip(stages, arrays):
        if isinstance(st, BatchSelStage):
            if sel is None or tuple(sel.shape[1:]) != (batch, SEL_WORDS):
                raise ValueError(f"BatchSelStage needs a selection table "
                                 f"(slots, {batch}, 8)")
            re, im = _batchsel(re, im, sel[st.index].to(dev), st.qubit)
            continue
        g = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        if isinstance(st, DiagVecStage):
            re, im = _diagvec(re, im, g, st, n, batch)
            continue
        if isinstance(st, (MatStage, PairStage)):
            if isinstance(st, PairStage):
                nre, nim = _pair(re, im, g, st, n, batch)
            else:
                nre, nim = _contract(re, im, g, st, n, tier)
                nre, nim = nre.reshape(rows, LANES), nim.reshape(rows, LANES)
            mask = _pred_mask(lane, row, st.lane_preds, st.row_preds)
            if mask is not None:
                nre = torch.where(mask, nre, re)
                nim = torch.where(mask, nim, im)
            re, im = nre, nim
            continue
        v = g.cpu().tolist()
        if isinstance(st, PhaseStage):
            tre, tim, lm, lw = v[0][0], v[0][1], int(v[0][2]), int(v[0][3])
            rm, rw = _row_mask(v[0][4], v[0][5]), _row_mask(v[0][6], v[0][7])
            mask = ((lane & lm) == lw) & ((row & rm) == rw)
            nre = re * tre - im * tim
            nim = re * tim + im * tre
            re, im = torch.where(mask, nre, re), torch.where(mask, nim, im)
        elif isinstance(st, ParityStage):
            c, s, lm = v[0][0], v[0][1], int(v[0][2])
            rm = _row_mask(v[0][3], v[0][4])
            sn = (s * _sign(lane, lm)) * _sign(row, rm)
            re, im = re * c + im * sn, im * c - re * sn
        else:
            tot = torch.zeros_like(re)
            for form, (ang, lm, lo, hi, *_) in zip(st.forms, v):
                lm, rm = int(lm), _row_mask(lo, hi)
                if form == "a":
                    match = ((lane & lm) == lm) & ((row & rm) == rm)
                    tot = tot + torch.where(match, ang, 0.0)
                else:
                    tot = tot + (ang * _sign(lane, lm)) * _sign(row, rm)
            cs, sn = torch.cos(tot), torch.sin(tot)
            re, im = re * cs - im * sn, re * sn + im * cs
    if not batched:
        return torch.stack([re, im])
    return torch.stack([re.reshape(batch, -1, LANES),
                        im.reshape(batch, -1, LANES)], dim=1)
