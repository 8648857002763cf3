"""Planning half of the band-segment engine: stage descriptors, segment
and sweep planning, and block geometry.

A port of the planning code in quest_tpu/ops/pallas_band.py:75-991 and
:1898 (that module imports Pallas at its top, so the port keeps its own
copy). The (2, 2^n) re/im planes are viewed as (2, rows, 128): qubits
0..6 are the lane axis, row bits make up the rest. A segment is a list
of stages applied to one tile of the state per thread block, in one
launch:

  b0   composed 128x128 operator on the lane band (qubits 0..6)
  b1   composed d x d operator on the lowest log2(d) row bits
  scb  composed 2^w x 2^w operator over w scattered HIGH row bits
  sc   2x2 butterfly on one scattered row bit
  phase / parity / multiphase stages on any qubits

The budgets that decide where a segment ends are one frozen `Budgets`
object. `TPU_GEOMETRY` holds the reference's values (v5e VMEM sizes)
and reproduces its plans stage for stage; `HOPPER_GEOMETRY` is sized
for an H100 thread block and is what the port's engine plans with.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from quest_tpu_torch.env import knob_value
from quest_tpu_torch.ops import fusion as F

LANE_QUBITS = 7
LANES = 1 << LANE_QUBITS
SUBLANE_TOP = 2 * LANE_QUBITS  # first qubit above the sublane band


@dataclasses.dataclass(frozen=True)
class Budgets:
    """Block-geometry budgets of one target.

    rows_eff_bits       log2 of the rows a block holds when the stages
                        ask for fewer (scattered x inner rows)
    max_block_row_bits  cap on in-block row bits: sublane floor plus
                        scattered axes
    scatter_max         scattered high row bits per segment
    max_segment_stages  stages per segment as segment_plan emits them
    max_sweep_stages    stages per merged sweep (sweep_plan)
    sweep_operand_bytes operand bytes per merged sweep under the
                        decoupled driver (K1, the default)
    inplace_operand_bytes  the same under the in-place (K2) or grid (K3)
                        driver
    block_memory        where a block's slots live: 'vmem' (the TPU's
                        whole-block slots) or 'smem' (the port's plane
                        slots); picks the schedule pipeline_stats reports
    """
    name: str
    rows_eff_bits: int
    max_block_row_bits: int
    scatter_max: int
    max_segment_stages: int
    max_sweep_stages: int
    sweep_operand_bytes: int
    inplace_operand_bytes: int
    block_memory: str

    @property
    def tile_bytes(self) -> int:
        """Bytes of the largest block: both f32 planes of
        2^max_block_row_bits rows of 128 lanes."""
        return 2 * 4 * LANES << self.max_block_row_bits


# The reference's values (quest_tpu/ops/pallas_band.py:78-101, :671-691):
# a block of up to 2^13 rows (8 MiB) in TPU VMEM, operands VMEM-resident;
# 40 MiB of operands per sweep beside the decoupled driver's 4 block slots,
# 48 MiB beside the in-place driver's 3 (or the grid driver's 2).
TPU_GEOMETRY = Budgets(
    name="tpu", rows_eff_bits=12, max_block_row_bits=13, scatter_max=7,
    max_segment_stages=32, max_sweep_stages=64,
    sweep_operand_bytes=40 * (1 << 20), inplace_operand_bytes=48 * (1 << 20),
    block_memory="vmem")

# H100 thread block. The tile (2 planes x 2^(7 + row bits) f32) lives in
# dynamic shared memory, at most 227 KB per block, so a block holds at
# most 14 index bits: 7 lane bits + 7 row bits = 2 x 2^14 x 4 B = 128 KiB
# (15 bits would be 256 KiB). Seven row bits are also the least that a
# 128-wide b1 stage (7 inner row bits) or a full-band scb stage (7
# scattered bits) needs, so rows_eff_bits = max_block_row_bits = 7 and
# every tile at n >= 14 is 128 KiB: one block per SM. A b1 d=128 stage
# and any scattered bit therefore land in separate segments (on the TPU,
# 13 row bits let a b1 share its segment with up to 6 scattered bits).
# Operands are read from global memory through L1/L2, not staged in
# shared memory; every block re-reads every operand of its segment, so a
# sweep's operands are capped at 32 MiB to stay inside the 50 MB L2,
# whatever the driver (no driver holds operands in shared memory, so the
# plans do not depend on it). A dense 128x128 complex operand is 128 KiB,
# so the stage caps, kept at the reference's 32/64, bind first.
#
# Kraus pairs under this budget. A 1-qubit channel on a density register
# is a 2-qubit superoperator on (t, t + N); when its op-side qubit is a
# sublane qubit q = 7 + j and its sliced qubit is scattered, the
# reference emits a 'b1'-op PairStage (an embedded 128x128 operator
# contracted over all 7 low row bits) and reserves the full 7-bit
# sublane floor plus the scattered bit: 8 row bits, which no Hopper tile
# holds. _try_pair_stage therefore lowers the pair to a 2x2-block
# butterfly on two tile bits whenever the budget cannot hold that floor
# plus one scattered bit (max_block_row_bits < 8):
#   j + 2 <= max_block_row_bits (j <= 5): op_kind 'sub' — row bit j stays
#       an inner row (floor j + 1) beside one scattered bit;
#   otherwise (j = 6): op_kind 'sc' — row bit j becomes a scattered axis
#       (the reference's own sc/scat form, (2, 4, 2, 2) operand); the tile
#       keeps 5 inner rows (_geometry: inner rows stop below the lowest
#       scattered bit) and 14 bits.
# Scattering every j instead would shrink the inner rows to j: at j = 0
# the tile would drop to 9 bits, below the kernel's 10-bit minimum.
# TPU_GEOMETRY (13 row bits) keeps the reference's b1 form.
HOPPER_GEOMETRY = Budgets(
    name="hopper", rows_eff_bits=7, max_block_row_bits=7, scatter_max=7,
    max_segment_stages=32, max_sweep_stages=64,
    sweep_operand_bytes=32 * (1 << 20), inplace_operand_bytes=32 * (1 << 20),
    block_memory="smem")


def plan_bands(n: int) -> List[Tuple[int, int]]:
    """Band layout matching the kernel's reach: 7-qubit bands everywhere.
    Width-1 remainders stay scattered-axis butterflies."""
    bands = []
    ql = 0
    while ql < n:
        w = min(LANE_QUBITS, n - ql)
        bands.append((ql, w))
        ql += w
    return bands


# ---------------------------------------------------------------------------
# stage descriptors (structure only — matrices are kernel inputs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatStage:
    kind: str                  # 'b0' | 'b1' | 'sc' | 'scb'
    dim: int                   # operator dimension D
    real_only: bool
    lane_preds: Tuple[Tuple[int, int], ...]   # (lane bit, want)
    row_preds: Tuple[Tuple[int, int], ...]    # (GLOBAL row bit, want)
    bit: int = -1              # 'sc': the GLOBAL row bit this acts on;
    # 'scb': the LOWEST of the log2(dim) contiguous row bits the composed
    # high-band operator contracts over (each a scattered block axis)


@dataclasses.dataclass(frozen=True)
class PhaseStage:
    """allones phase: multiply amplitudes whose condition bits match by
    (tre + i*tim). The phase value AND the bit predicates ride in one
    (1, 8) operand [tre, tim, lane_mask, lane_want, row_mask_lo,
    row_mask_hi, row_want_lo, row_want_hi] (row masks split at bit 15 so
    each half is an exact integer in f32), so every phase stage shares
    one structure."""


@dataclasses.dataclass(frozen=True)
class ParityStage:
    """exp(-i angle/2 Z...Z); the (1, 8) operand is [cos, sin, lane_mask,
    row_mask_lo, row_mask_hi, 0, 0, 0] of the half angle and the
    target-bit masks (parity computed per element)."""


@dataclasses.dataclass(frozen=True)
class PairStage:
    """General 2-qubit matrix on (q_op, q_sliced): the sliced qubit's two
    halves select 2x2 blocks M[r][c], each applied on the op-side qubit.
    Emitted for Kraus superoperators on density registers. op_kind:
      'lane'  op qubit on the lane axis; each block embedded in 128x128
              and stored transposed (X @ G^T form)
      'b1'    op qubit a sublane row bit, embedded 128x128 over the
              lowest 7 row bits, stored transposed (TPU budgets only)
      'sub'   op qubit the inner row bit op_bit, 2x2 blocks (Hopper)
      'sc'    op qubit the scattered row bit op_bit, 2x2 blocks
    The operand is (2, 4, D, D), block r * 2 + c for sliced output r and
    input c."""
    op_kind: str
    op_dim: int                               # 128 or 2
    op_bit: int                               # 'sc'/'sub': GLOBAL row bit
    sliced_kind: str
    sliced_bit: int                           # GLOBAL row bit
    real_only: bool
    lane_preds: Tuple[Tuple[int, int], ...]
    row_preds: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class MultiPhaseStage:
    """A scheduler-composed GROUP of unit phases applied ADDITIVELY: each
    row contributes an angle and the stage pays one cos/sin and one
    complex multiply for the whole group. The (m, 8) operand rows are
    [angle, lane_mask, row_mask_lo, row_mask_hi, 0, 0, 0, 0]; `forms`
    gives each row's static interpretation: 'a' = allones, 'p' =
    parity."""
    forms: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class BatchSelStage:
    """Per-STATE 2x2 operator on one GLOBAL qubit (the batched trajectory
    engine's channel stage): each state of the batch applies its own row
    of a per-call selection table (ops/segment.py). `index` is the
    channel's index in program order, which is also its table slot. A
    barrier stage (a state-dependent draw) pins itself to the front of
    its launch."""
    qubit: int
    index: int
    barrier: bool = True


@dataclasses.dataclass(frozen=True)
class ChannelItem:
    """Plan-stream marker for a batched per-state channel on GLOBAL
    qubit `qubit`; segment_plan turns each into a BatchSelStage with a
    (batch, 8) placeholder operand."""
    qubit: int
    index: int
    barrier: bool = True

    def qubits(self):
        return (self.qubit,)


@dataclasses.dataclass(frozen=True)
class DiagVecStage:
    """General k-qubit diagonal from a (2, 2^k) entry table selected by
    the target-bit pattern (bit j of the entry index = targets[j])."""
    targets: Tuple[int, ...]                  # GLOBAL qubits
    lane_preds: Tuple[Tuple[int, int], ...]
    row_preds: Tuple[Tuple[int, int], ...]


# ---------------------------------------------------------------------------
# segmentation of a fusion plan
# ---------------------------------------------------------------------------


def _split_preds(preds):
    lane_p, row_p = [], []
    for q, s in preds:
        if q < LANE_QUBITS:
            lane_p.append((q, s))
        else:
            row_p.append((q - LANE_QUBITS, s))
    return tuple(lane_p), tuple(row_p)


def stage_requirements(stages) -> Tuple[set, int]:
    """(scattered GLOBAL row bits, sublane floor) a stage list needs
    resident in one block — the accounting shared by segment_geometry
    (which sizes the block from it) and sweep_plan (which merges
    segments only when the union still fits the budgets)."""
    scat: set = set()
    floor = 0
    for st in stages:
        if isinstance(st, MatStage):
            if st.kind == "sc":
                scat.add(st.bit)
            elif st.kind == "scb":
                scat |= set(range(st.bit, st.bit + st.dim.bit_length() - 1))
            elif st.kind == "b1":
                floor = max(floor, st.dim.bit_length() - 1)
        elif isinstance(st, PairStage):
            if st.sliced_kind == "scat":
                scat.add(st.sliced_bit)
            if st.op_kind == "sc":
                scat.add(st.op_bit)
            if st.op_kind == "b1":
                floor = max(floor, LANE_QUBITS)
            if st.op_kind == "sub":
                floor = max(floor, st.op_bit + 1)
            if st.sliced_kind == "sub":
                floor = max(floor, st.sliced_bit + 1)
        elif isinstance(st, BatchSelStage):
            if st.qubit >= SUBLANE_TOP:
                scat.add(st.qubit - LANE_QUBITS)
            elif st.qubit >= LANE_QUBITS:
                # sublane bit j contracts the lowest j+1 row bits
                floor = max(floor, st.qubit - LANE_QUBITS + 1)
    return scat, floor


def segment_plan(items: Sequence, n: int, batch: int = 1, *,
                 budgets: Budgets = HOPPER_GEOMETRY):
    """Split fusion-plan items into kernel segments and passthroughs.
    Returns a list of ("segment", [stages], [op_arrays]) and
    ("xla", item) entries, in program order. ("xla" names the parts the
    reference runs on its XLA band path between segments; the port runs
    them through ops/apply, circuit.XlaPass.) `batch` sizes the (batch, 8)
    placeholder operands of ChannelItem stages."""
    del n
    scatter_max = budgets.scatter_max
    parts: List = []
    stages: List = []
    arrays: List = []
    scat_bits: set = set()
    b1_floor = 0    # in-block sublane bits forced by b1/pair stages
    row_budget = budgets.max_block_row_bits

    def flush():
        nonlocal stages, arrays, scat_bits, b1_floor
        if stages:
            parts.append(("segment", stages, arrays))
            stages, arrays = [], []
        scat_bits = set()
        b1_floor = 0

    def emit_xla(it):
        parts.append(("xla", it))

    def reserve(bits=frozenset(), floor=0):
        """Claim scattered row bits / a sublane floor for the next stage,
        flushing first if the block would outgrow its row or scatter
        budget. Returns False — claiming nothing — when the stage's OWN
        requirement exceeds the budgets even in a fresh segment."""
        nonlocal scat_bits, b1_floor
        if (len(set(bits)) > scatter_max
                or floor + len(set(bits)) > row_budget):
            return False
        new_scat = scat_bits | set(bits)
        new_floor = max(b1_floor, floor)
        if (len(new_scat) > scatter_max
                or new_floor + len(new_scat) > row_budget):
            flush()
            new_scat = set(bits)
            new_floor = floor
        scat_bits = new_scat
        b1_floor = new_floor
        return True

    for it in items:
        if len(stages) >= budgets.max_segment_stages:
            flush()
        if isinstance(it, ChannelItem):
            if it.barrier:
                flush()
            q = it.qubit

            def reserve_channel():
                if q >= SUBLANE_TOP:
                    return reserve(bits=(q - LANE_QUBITS,))
                if q >= LANE_QUBITS:
                    return reserve(floor=q - LANE_QUBITS + 1)
                return True
            if not reserve_channel():
                flush()
                if not reserve_channel():
                    raise ValueError(
                        f"channel qubit {q} does not fit an empty "
                        f"segment under the caller's scatter budget")
            stages.append(BatchSelStage(q, it.index, it.barrier))
            arrays.append(np.zeros((batch, 8), dtype=np.float32))
            continue
        if isinstance(it, F.BandOp):
            lane_p, row_p = _split_preds(it.preds)
            if it.ql == 0:
                kind, bit = "b0", -1
                g = it.gre.T + 1j * it.gim.T       # X @ G^T form
            elif it.ql == LANE_QUBITS:
                kind, bit = "b1", -1
                g = (it.gre + 1j * it.gim).T       # X @ G^T form
                reserve(floor=it.w)
            elif it.w == 1:
                kind, bit = "sc", it.ql - LANE_QUBITS
                g = it.gre + 1j * it.gim
                if not reserve(bits=(bit,)):
                    flush()
                    emit_xla(it)
                    continue
            else:                  # high band: one contraction over its
                kind = "scb"       # merged scattered axes
                bit = it.ql - LANE_QUBITS
                g = it.gre + 1j * it.gim
                w = it.w
                # a run that only mixed SOME of the band's qubits is
                # often an exact embedding over a narrower sub-range:
                # contract only the spanning sub-band
                nd = sorted(q - it.ql for q in it.nondiag
                            if it.ql <= q < it.ql + it.w)
                if nd and (nd[0] > 0 or nd[-1] < it.w - 1):
                    j0, w2 = nd[0], nd[-1] - nd[0] + 1
                    idx = [x << j0 for x in range(1 << w2)]
                    sub = g[np.ix_(idx, idx)]
                    if np.allclose(g, F.embed_operator(
                            sub, list(range(j0, j0 + w2)), [], [], it.w)):
                        kind = "scb" if w2 > 1 else "sc"
                        bit = bit + j0
                        g = sub
                        w = w2
                if not reserve(bits=range(bit, bit + w)):
                    flush()
                    emit_xla(it)
                    continue
            real_only = bool(np.all(g.imag == 0.0))
            if kind == "scb" and g.shape[0] == LANES:
                # X @ G^T form for the full-width band; narrow scb and
                # sc keep G (the reference's left-dot orientation)
                g = g.T
            stages.append(MatStage(kind, g.shape[0], real_only, lane_p,
                                   row_p, bit))
            arrays.append(np.stack([g.real, g.imag]).astype(np.float32))
            continue
        if isinstance(it, F.DiagItem):
            op = it.op
            targets = tuple(op.targets)
            if op.kind == "parity":
                half = float(op.operand) / 2.0
                lm = sum(1 << q for q in targets if q < LANE_QUBITS)
                rm = sum(1 << (q - LANE_QUBITS) for q in targets
                         if q >= LANE_QUBITS)
                stages.append(ParityStage())
                arrays.append(np.array(
                    [[np.cos(half), np.sin(half), lm,
                      rm & 0x7FFF, rm >> 15, 0, 0, 0]], dtype=np.float32))
                continue
            if op.kind == "diagonal":
                parts_rel = getattr(op, "parts", ())
                if parts_rel:
                    # scheduler-composed phase group: one additive
                    # MultiPhaseStage instead of a 2^k select chain
                    rows, forms = [], []
                    for form, bits, val in parts_rel:
                        qs = [targets[b] for b in bits]
                        lm = sum(1 << q for q in qs if q < LANE_QUBITS)
                        rm = sum(1 << (q - LANE_QUBITS) for q in qs
                                 if q >= LANE_QUBITS)
                        ang = val if form == "allones" else -val / 2.0
                        rows.append([ang, lm, rm & 0x7FFF, rm >> 15,
                                     0, 0, 0, 0])
                        forms.append("a" if form == "allones" else "p")
                    stages.append(MultiPhaseStage(tuple(forms)))
                    arrays.append(np.array(rows, dtype=np.float32))
                    continue
                d = np.asarray(op.operand, dtype=np.complex128).reshape(-1)
                lane_p, row_p = _split_preds(
                    tuple(zip(op.controls, op.cstates or
                              (1,) * len(op.controls))))
                stages.append(DiagVecStage(targets, lane_p, row_p))
                arrays.append(np.stack([d.real, d.imag]).astype(np.float32))
                continue
            if op.kind == "allones" and isinstance(
                    op.operand, (int, float, complex)):
                bits = targets + tuple(op.controls)
                want = (1,) * len(targets) + (tuple(op.cstates) or
                                              (1,) * len(op.controls))
                lm = lw = rm = rw = 0
                for q, s in zip(bits, want):
                    if q < LANE_QUBITS:
                        lm |= 1 << q
                        lw |= s << q
                    else:
                        rm |= 1 << (q - LANE_QUBITS)
                        rw |= s << (q - LANE_QUBITS)
                t = complex(op.operand)
                stages.append(PhaseStage())
                arrays.append(np.array(
                    [[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15,
                      rw & 0x7FFF, rw >> 15]], dtype=np.float32))
                continue
            flush()
            emit_xla(it)
            continue
        if isinstance(it, F.PassOp):
            st = _try_pair_stage(it, scatter_max, row_budget)
            if st is not None:
                stage, arr, new_scat = st
                _, floor = stage_requirements([stage])
                if reserve(bits=new_scat or frozenset(), floor=floor):
                    stages.append(stage)
                    arrays.append(arr)
                    continue
        flush()
        emit_xla(it)
    flush()
    return parts


def _try_pair_stage(it, scatter_max, row_budget):
    """PassOp -> (PairStage, operand array, scat bits needed) when the op
    is an uncontrolled 2-target matrix whose qubits the kernel can reach;
    None otherwise. A sublane op qubit beside a scattered sliced qubit
    keeps the reference's b1 form when `row_budget` holds its 7-bit floor
    plus the scattered bit, and becomes a 2x2 butterfly ('sub' or 'sc')
    otherwise (see HOPPER_GEOMETRY)."""
    op = it.op
    if op.kind != "matrix" or len(op.targets) != 2 or op.controls:
        return None
    m = np.asarray(op.operand)
    if m.shape != (4, 4) or not np.issubdtype(m.dtype, np.number):
        return None
    qa, qb = op.targets           # matrix bit 0 = qa, bit 1 = qb

    def locate(q):
        if q < LANE_QUBITS:
            return "lane"
        if q < SUBLANE_TOP:
            return "sub"
        return "scat"

    la, lb = locate(qa), locate(qb)
    # pick the sliced qubit: prefer a scattered one; a sublane qubit may
    # only be sliced when the op side is a lane qubit
    if lb == "scat":
        q_op, q_sl, bit_op = qa, qb, 0
    elif la == "scat":
        q_op, q_sl, bit_op = qb, qa, 1
    elif la == "lane" and lb == "sub":
        q_op, q_sl, bit_op = qa, qb, 0
    elif lb == "lane" and la == "sub":
        q_op, q_sl, bit_op = qb, qa, 1
    else:
        return None               # same-band pairs are composed upstream
    op_loc = locate(q_op)
    sliced_kind = "scat" if locate(q_sl) == "scat" else "sub"
    kind = {"lane": "lane", "sub": "b1", "scat": "sc"}[op_loc]
    if kind == "b1" and row_budget < LANE_QUBITS + 1:
        j = q_op - LANE_QUBITS
        kind = "sub" if j + 2 <= row_budget else "sc"

    need = set()
    if sliced_kind == "scat":
        need.add(q_sl - LANE_QUBITS)
    if kind == "sc":
        need.add(q_op - LANE_QUBITS)
    if len(need) > scatter_max:
        return None

    m = m.astype(np.complex128)
    blocks = np.empty((2, 4), dtype=object)
    for r in range(2):
        for c in range(2):
            sub = np.empty((2, 2), dtype=np.complex128)
            for ao in range(2):
                for ai in range(2):
                    row = (ao << bit_op) | (r << (1 - bit_op))
                    col = (ai << bit_op) | (c << (1 - bit_op))
                    sub[ao, ai] = m[row, col]
            if kind == "lane":
                emb = _embed_2x2(sub, q_op).T            # X @ G^T form
            elif kind == "b1":
                emb = _embed_2x2(sub, q_op - LANE_QUBITS).T  # X @ G^T form
            else:
                emb = sub
            blocks[0, r * 2 + c] = emb.real.astype(np.float32)
            blocks[1, r * 2 + c] = emb.imag.astype(np.float32)
    d = blocks[0, 0].shape[0]
    arr = np.stack([np.stack(list(blocks[p])) for p in range(2)])
    real_only = bool(np.all(m.imag == 0.0))
    st = PairStage(kind, d, q_op - LANE_QUBITS if d == 2 else -1,
                   sliced_kind, q_sl - LANE_QUBITS, real_only, (), ())
    return st, arr, (need if need else None)


def _embed_2x2(sub, pos):
    """Embed a 2x2 at bit `pos` of a 7-bit space (lane or sublane)."""
    return F.embed_operator(sub, [pos], [], [], LANE_QUBITS)


# ---------------------------------------------------------------------------
# sweep fusion: many segments per launch
# ---------------------------------------------------------------------------
#
# segment_plan flushes greedily, forward only. sweep_plan re-merges
# CONSECUTIVE segment parts whose combined stage list still fits one
# block geometry (scattered-bit union within the scatter budget, sublane
# floor + scattered axes within the row budget, bounded stage count and
# operand bytes) — including across the repeated applications of an
# `iters` program. Any non-segment part is a barrier.


def sweep_plan(parts, n: int, *, budgets: Budgets = HOPPER_GEOMETRY,
               driver: str = None):
    """Merge consecutive ("segment", stages, arrays) parts into maximal
    single-launch sweeps under `budgets` and the operand budget of
    `driver` (None: the knobs'), preserving program order. Returns the
    same part format."""
    del n
    scatter_max = budgets.scatter_max
    row_budget = budgets.max_block_row_bits
    max_stages = budgets.max_sweep_stages
    operand_bytes = sweep_operand_budget(budgets, driver)
    out = []
    cur_scat: set = set()
    cur_floor = 0
    cur_bytes = 0
    for part in parts:
        if part[0] != "segment":
            out.append(part)            # passthrough: a sweep barrier
            cur_scat, cur_floor, cur_bytes = set(), 0, 0
            continue
        stages, arrays = list(part[1]), list(part[2])
        scat, floor = stage_requirements(stages)
        nbytes = sum(a.nbytes for a in arrays)
        # a barrier BatchSelStage reads the state as it stands at ITS
        # launch boundary: never merge its segment into an earlier one
        barrier = any(isinstance(st, BatchSelStage) and st.barrier
                      for st in stages)
        if out and out[-1][0] == "segment" and not barrier:
            u_scat = cur_scat | scat
            u_floor = max(cur_floor, floor)
            prev = out[-1]
            if (len(prev[1]) + len(stages) <= max_stages
                    and len(u_scat) <= scatter_max
                    and u_floor + len(u_scat) <= row_budget
                    and cur_bytes + nbytes <= operand_bytes):
                out[-1] = ("segment", prev[1] + stages, prev[2] + arrays)
                cur_scat, cur_floor = u_scat, u_floor
                cur_bytes += nbytes
                continue
        out.append(("segment", stages, arrays))
        cur_scat, cur_floor, cur_bytes = set(scat), floor, nbytes
    return out


def maybe_sweep(parts, n: int, *, budgets: Budgets = HOPPER_GEOMETRY,
                driver: str = None):
    """sweep_plan honouring the QUEST_SWEEP_FUSION knob (ref
    pallas_band.maybe_sweep)."""
    if not knob_value("QUEST_SWEEP_FUSION"):
        return list(parts)
    return sweep_plan(parts, n, budgets=budgets, driver=driver)


def sweep_stats(parts) -> dict:
    """Sweep statistics of a (swept) part list: every part, kernel sweep
    or passthrough, is one full-state pass per application (ref
    pallas_band.sweep_stats)."""
    segs = [p for p in parts if p[0] == "segment"]
    return {
        "hbm_sweeps": len(parts),
        "kernel_sweeps": len(segs),
        "xla_passthroughs": len(parts) - len(segs),
        "sweep_stages": [len(p[1]) for p in segs],
    }


def batched_stats(parts, batch: int, bucket: int = None) -> dict:
    """Batched-plan statistics of a (swept) part list (ref
    pallas_band.batched_stats:822): every state of the bucket rides every
    sweep of the same part list, so `hbm_sweeps` (launches and
    passthroughs per application) does not depend on the batch."""
    sw = sweep_stats(parts)
    bucket = int(batch) if bucket is None else int(bucket)
    return {
        "batch": int(batch),
        "bucket": bucket,
        "states_per_sweep": bucket,
        "hbm_sweeps": sw["hbm_sweeps"],
        "kernel_sweeps": sw["kernel_sweeps"],
        "batched_stages": sum(
            1 for p in parts if p[0] == "segment"
            for st in p[1] if isinstance(st, BatchSelStage)),
    }


def sweep_steps(stages, n: int, batch: int = 1, *,
                budgets: Budgets = HOPPER_GEOMETRY) -> int:
    """Thread blocks one launch of `stages` runs: tiles per state times
    the batch (ref pallas_band.sweep_steps:846, the grid steps of one
    compiled sweep)."""
    return segment_geometry(stages, n, budgets=budgets).blocks * int(batch)


# ---------------------------------------------------------------------------
# segment drivers: the schedule's planning half
# ---------------------------------------------------------------------------
#
# The reference has three drivers of one stage chain (pallas_band.py:1553,
# :1628, :1715), picked by QUEST_FUSED_DRIVER and QUEST_FUSED_PIPELINE:
#   decoupled  K1, the default: separate in/out slot rings, neither DMA
#              direction gating the other;
#   inplace    K2 (QUEST_FUSED_PIPELINE=0): NBUF in-place slots, a slot
#              refilled once its previous write-back has drained;
#   grid       K3 (QUEST_FUSED_DRIVER=grid): one grid step per block.
# A driver changes when a block's bytes move, never what the chain
# computes. Under TPU_GEOMETRY the functions below return what the
# reference's return; under HOPPER_GEOMETRY they describe the port's
# kernels (csrc/segment.cu): K1 and K2 are persistent blocks whose tile
# planes sit in a ring of plane slots in shared memory, K3 one block per
# tile. `ring_schedule` is the model of one block's order of events (K3:
# of the blocks one SM runs in turn), from which pipeline_stats derives
# the port's read-ahead.

DRIVERS = ("decoupled", "inplace", "grid")      # K1, K2, K3
PIPELINE_IN_SLOTS = 2          # the reference's decoupled rings (:682)
PIPELINE_OUT_SLOTS = 2
VMEM_LIMIT_BYTES = 100 * (1 << 20)   # the reference's scoped VMEM limit
BLOCK_SMEM_BYTES = 232448      # H100: dynamic shared memory of one block
RING_SLOTS = 3                 # K1's plane slots on the port
MAX_RING_SLOTS = 8             # QUEST_FUSED_NBUF's upper bound
ROW_ID_BYTES = 4 << (14 - LANE_QUBITS)   # csrc MAX_ROWS ints
MULTIPHASE_BYTES = 3 * 64 * 4  # csrc MAX_MULTIPHASE_ROWS x (angle, 2 masks)
MBARRIER_BYTES = 8
OP_SLOTS = 2                   # csrc OpRing: operator slices in flight
OP_SLICE_BYTES = 16384         # csrc OP_SLICE_BYTES
OP_RING_BYTES = OP_SLOTS * (OP_SLICE_BYTES + MBARRIER_BYTES)  # + barriers
DIAG_TABLE_BYTES = 2 * 128 * 4  # csrc DIAG_TABLE_WORDS: S8's (2, 2^7)
# table, or S7's 64 term bits of each of a tile's 128 rows
FIXED_SMEM_BYTES = (ROW_ID_BYTES + MULTIPHASE_BYTES + DIAG_TABLE_BYTES
                    + OP_RING_BYTES)  # beside the plane slots, every driver
TMA_PARTS = 1                  # parts of a plane (one store bulk group
# each) by default: one box a plane; 2 and 4 parts measured slower
MAX_TMA_PARTS = 4              # csrc MAX_TMA_PARTS
MAX_TMA_BOX = 256              # elements along one dimension of a box
MAX_TMA_RANK = 5
HOPPER_SMS = 132               # H100 SXM: the persistent grid, for stats
STATS_STEPS = 16               # steps per block the schedule model walks
# for pipeline_stats (its read-ahead is periodic after a few steps)


def pipeline_enabled() -> bool:
    """QUEST_FUSED_PIPELINE: True (default) runs the decoupled driver
    under the pipelined one, False the in-place slots (ref
    pallas_band.pipeline_enabled :694)."""
    return knob_value("QUEST_FUSED_PIPELINE")


def active_driver() -> str:
    """The driver the knobs select: 'grid' under QUEST_FUSED_DRIVER=grid,
    else 'decoupled' or 'inplace' by QUEST_FUSED_PIPELINE. Read when a
    program is compiled; the program keeps it."""
    if knob_value("QUEST_FUSED_DRIVER") == "grid":
        return "grid"
    return "decoupled" if pipeline_enabled() else "inplace"


def check_driver(driver: str = None) -> str:
    """`driver`, or the knobs' when None; ValueError if it is not one of
    DRIVERS."""
    driver = active_driver() if driver is None else driver
    if driver not in DRIVERS:
        raise ValueError(f"segment driver must be one of {DRIVERS}, "
                         f"got {driver!r}")
    return driver


def decoupled_active(driver: str = None) -> bool:
    """Whether segments run the decoupled driver (ref
    pallas_band.decoupled_active :704): the one predicate behind the
    operand budget and pipeline_stats."""
    return check_driver(driver) == "decoupled"


def sweep_operand_budget(budgets: Budgets = HOPPER_GEOMETRY,
                         driver: str = None) -> int:
    """Operand bytes per sweep under `driver` (ref
    pallas_band.sweep_operand_budget :713): the decoupled driver's budget,
    or the in-place/grid one (TPU: 40 vs 48 MiB; Hopper: 32 MiB both)."""
    if decoupled_active(driver):
        return budgets.sweep_operand_bytes
    return budgets.inplace_operand_bytes


def _nbuf(nbuf: int = None) -> int:
    return knob_value("QUEST_FUSED_NBUF") if nbuf is None else int(nbuf)


def ring_fit(tile_bits: int) -> int:
    """Most plane slots one block's shared memory holds beside the row
    ids, the multiphase rows, the diagonal table, the operator ring and
    one mbarrier per slot (at most MAX_RING_SLOTS): 3 at 14-bit tiles, 6
    at 13 bits, 8 below."""
    plane = 4 << tile_bits
    return min(MAX_RING_SLOTS,
               (BLOCK_SMEM_BYTES - FIXED_SMEM_BYTES)
               // (plane + MBARRIER_BYTES))


def ring_slots(tile_bits: int, steps: int, driver: str = None,
               nbuf: int = None) -> int:
    """Plane slots of one launch: K3's two planes; K1's RING_SLOTS; K2's
    QUEST_FUSED_NBUF (or `nbuf`); the rings clamped to what shared memory
    holds (ring_fit) and to the 2 x `steps` planes the launch moves."""
    driver = check_driver(driver)
    if driver == "grid":
        return 2
    want = RING_SLOTS if driver == "decoupled" else _nbuf(nbuf)
    return max(2, min(want, ring_fit(tile_bits), 2 * int(steps)))


def ring_wait_groups(last: int, plane: int, part: int, parts: int) -> int:
    """N of the wait_group (K1: wait_group.read) that the ring kernel
    issues before refilling part `part` of the slot that held `plane`,
    when the stores of every plane up to `last` are committed: the store
    bulk groups committed after that part's (csrc ring_kernel commits
    one group per part, re's parts then im's)."""
    return (last - plane) * parts + parts - 1 - part


def ring_schedule(driver: str, steps: int, slots: int,
                  parts: int = 1) -> List[tuple]:
    """The order of events of one block of the port's kernel walking
    `steps` tiles (step k: plane 2k = re, 2k + 1 = im) through `slots`
    plane slots, each plane moved in `parts` parts of consecutive tile
    rows (TMA_PARTS in the kernel unless a measurement asks for more), as
    csrc/segment.cu issues and waits for them:

      ("load", j, slot, part)     tensor-map loads of part `part` of plane
                                  j into slot j mod slots
      ("landed", k)               the block waits until step k's planes
                                  landed
      ("chain", k, (re slot, im slot))
      ("store", j, slot, part)    tensor-map stores of that part of plane
                                  j, committed as one bulk group
      ("read", j, part, N)        wait_group.read N: every store group up
                                  to (j, part) has read its slot (K1)
      ("drained", j, part, N)     wait_group N: every store group up to
                                  (j, part) has landed (K2; K1 and K2 at
                                  exit)

    K1 ('decoupled') and K2 ('inplace'): the block first loads planes [0,
    slots). Plane j >= slots refills the slot of plane j - slots, part by
    part, each part after waiting for the store of the same part of that
    plane ("read" for K1, "drained" for K2; N from ring_wait_groups). A
    refill for the next step goes out as soon as the store that frees its
    slot is committed, ahead of the step's other store (K1 at 3 slots:
    im(k + 1) right after re(k)'s store, before im(k)'s); a refill for a
    later step goes out once the block's tile has landed, before its
    chain (K1: re(k + 1) under chain k). K3 ('grid') runs one tile per
    block through two planes (both loads on one mbarrier, each plane's
    stores one bulk group); the block exits, and the next tile's block on
    its SM loads, once the stores have read the planes (wait_group.read
    0)."""
    driver = check_driver(driver)
    ev: List[tuple] = []
    if driver == "grid":
        for k in range(steps):
            ev += [("load", 2 * k, 0, 0), ("load", 2 * k + 1, 1, 0),
                   ("landed", k), ("chain", k, (0, 1)),
                   ("store", 2 * k, 0, 0), ("store", 2 * k + 1, 1, 0),
                   ("read", 2 * k + 1, 0, 0)]
        return ev
    if slots < 2:
        raise ValueError(f"a ring needs at least 2 plane slots, got {slots}")
    if not 1 <= parts <= MAX_TMA_PARTS:
        raise ValueError(f"a plane moves in 1..{MAX_TMA_PARTS} parts, "
                         f"got {parts}")
    release = "read" if driver == "decoupled" else "drained"

    def refill(j, last):
        for i in range(parts):
            if j >= slots:
                ev.append((release, j - slots, i,
                           ring_wait_groups(last, j - slots, i, parts)))
            ev.append(("load", j, j % slots, i))

    for j in range(min(slots, 2 * steps)):
        refill(j, -1)
    for k in range(steps):
        ev.append(("landed", k))
        for j in range(max(2 * k + 2, 2 * k - 2 + slots, slots),
                       min(2 * k + slots, 2 * steps)):
            refill(j, 2 * k - 1)
        ev.append(("chain", k, (2 * k % slots, (2 * k + 1) % slots)))
        for p in (2 * k, 2 * k + 1):
            ev += [("store", p, p % slots, i) for i in range(parts)]
            j = p + slots
            if j < 2 * steps and j // 2 == k + 1:
                refill(j, p)
    if steps:
        ev.append(("drained", 2 * steps - 1, parts - 1, 0))
    return ev


def overlap_steps(events: Sequence[tuple]) -> int:
    """Read-ahead of a schedule: the least, over every chain but the
    last, of the later steps whose loads were issued before it starts
    (0 for a single step)."""
    ahead, loaded, chains = [], set(), 0
    for e in events:
        if e[0] == "load":
            loaded.add(e[1] // 2)
        elif e[0] == "chain":
            chains += 1
            ahead.append(sum(1 for s in loaded if s > e[1]))
    return min(ahead[:-1]) if chains > 1 else 0


def readahead_bytes(events: Sequence[tuple], part_bytes: int) -> int:
    """Bytes in flight when a chain starts: the least, over every chain
    but the last, of the load bytes issued for later steps' planes
    (`part_bytes` per load event) before it starts (0 for a single
    step)."""
    ahead, loads, chains = [], [], 0
    for e in events:
        if e[0] == "load":
            loads.append(e[1] // 2)
        elif e[0] == "chain":
            chains += 1
            ahead.append(part_bytes * sum(1 for s in loads if s > e[1]))
    return min(ahead[:-1]) if chains > 1 else 0


def smem_layout(tile_bits: int, steps: int, driver: str = None,
                nbuf: int = None) -> dict:
    """Dynamic shared memory of one launch of the port's kernel moving
    `steps` tiles of `tile_bits` bits under `driver`: the plane slots
    (K3: the tile's two planes), the row ids and multiphase rows, the
    stage scratch (S8's table, S7's row term bits), the operator ring
    (OP_SLOTS slices and their mbarriers, every driver), one mbarrier per
    ring slot (K3: one for the tile); against BLOCK_SMEM_BYTES. The one
    source the wrapper sizes a launch from (ops/segment.py; csrc
    quest_segment_smem_bytes must agree)."""
    driver = check_driver(driver)
    plane = 4 << tile_bits
    slots = ring_slots(tile_bits, steps, driver, nbuf)
    barriers = MBARRIER_BYTES * (1 if driver == "grid" else slots)
    total = slots * plane + FIXED_SMEM_BYTES + barriers
    return {"driver": driver, "tile_bits": tile_bits, "steps": int(steps),
            "plane_bytes": plane, "slots": slots,
            "slot_bytes": slots * plane, "row_id_bytes": ROW_ID_BYTES,
            "multiphase_bytes": MULTIPHASE_BYTES,
            "diag_table_bytes": DIAG_TABLE_BYTES,
            "op_ring_bytes": OP_RING_BYTES, "barrier_bytes": barriers,
            "total_bytes": total, "budget_bytes": BLOCK_SMEM_BYTES}


def sweep_smem_bytes(stages, n: int, batch: int = 1, *, driver: str = None,
                     nbuf: int = None,
                     budgets: Budgets = HOPPER_GEOMETRY) -> dict:
    """smem_layout of one launch of `stages` over `batch` states of n
    qubits: the Hopper counterpart of sweep_vmem_bytes."""
    geo = segment_geometry(stages, n, budgets=budgets)
    return smem_layout(geo.tile_bits, geo.blocks * int(batch), driver, nbuf)


def sweep_vmem_bytes(stages, arrays, n: int, batch: int = 1, *,
                     driver: str = None, nbuf: int = None,
                     budgets: Budgets = TPU_GEOMETRY) -> dict:
    """VMEM residency of one launch of the REFERENCE's kernel (ref
    pallas_band.sweep_vmem_bytes :910): its block slots under `driver`
    (2 + 2 decoupled, NBUF in place, 2 for the grid driver's double
    buffering, clamped by the steps) plus whole-array operands, against
    the 100 MiB scoped limit."""
    driver = check_driver(driver)
    geo = segment_geometry(stages, n, budgets=budgets)
    steps = sweep_steps(stages, n, batch, budgets=budgets)
    block_bytes = 2 * geo.rows_eff * LANES * 4
    if driver == "decoupled":
        slots = min(PIPELINE_IN_SLOTS, steps) + min(PIPELINE_OUT_SLOTS, steps)
    elif driver == "inplace":
        slots = min(_nbuf(nbuf), steps)
    else:
        slots = 2
    operand_bytes = sum(int(a.nbytes) for a in arrays)
    return {"block_bytes": block_bytes, "slots": slots,
            "slot_bytes": slots * block_bytes, "operand_bytes": operand_bytes,
            "total_bytes": slots * block_bytes + operand_bytes,
            "budget_bytes": VMEM_LIMIT_BYTES}


def pipeline_stats(parts, n: int, batch: int = 1, *, driver: str = None,
                   nbuf: int = None,
                   budgets: Budgets = HOPPER_GEOMETRY) -> dict:
    """Schedule of a (swept) part list (ref pallas_band.pipeline_stats
    :857). Under TPU budgets ('vmem'), the reference's record: the
    decoupled rings' slots and read-ahead (in_slots - 1 clamped by each
    sweep's steps, the least over the sweeps), {} under the other
    drivers. Under the port's ('smem'), for every driver: the plane
    slots (the least over the sweeps), pipeline_overlap_steps, the least
    read-ahead ring_schedule gives a block of the persistent grid
    (min(steps, HOPPER_SMS) blocks) on any sweep, and
    pipeline_readahead_bytes, the least bytes such a block has in flight
    for later steps when a chain starts (readahead_bytes)."""
    driver = check_driver(driver)
    sweeps = [p[1] for p in parts if p[0] == "segment"]
    if budgets.block_memory == "vmem":
        if driver != "decoupled":
            return {}
        overlaps = [min(PIPELINE_IN_SLOTS,
                        sweep_steps(st, n, batch, budgets=budgets)) - 1
                    for st in sweeps]
        return {"pipeline_in_slots": PIPELINE_IN_SLOTS,
                "pipeline_out_slots": PIPELINE_OUT_SLOTS,
                "pipeline_overlap_steps": min(overlaps) if overlaps else 0}
    slots, overlaps, inflight = [], [], []
    parts = 1 if driver == "grid" else TMA_PARTS
    for st in sweeps:
        geo = segment_geometry(st, n, budgets=budgets)
        steps = geo.blocks * int(batch)
        s = ring_slots(geo.tile_bits, steps, driver, nbuf)
        per_block = steps // min(steps, HOPPER_SMS)
        ev = ring_schedule(driver, min(per_block, STATS_STEPS), s, parts)
        slots.append(s)
        overlaps.append(overlap_steps(ev))
        inflight.append(readahead_bytes(ev, (4 << geo.tile_bits) // parts))
    return {"pipeline_driver": driver,
            "pipeline_slots": min(slots) if slots else 0,
            "pipeline_overlap_steps": min(overlaps) if overlaps else 0,
            "pipeline_readahead_bytes": min(inflight) if inflight else 0}


def fused_record(parts, swept, n: int, *, driver: str = None,
                 nbuf: int = None, budgets: Budgets = HOPPER_GEOMETRY) -> dict:
    """The fused engine's plan record (ref pallas_band.fused_record :888,
    Circuit.plan_stats()['fused']): segment and passthrough counts and
    the stage count of the raw segment plan `parts`, the sweeps of the
    swept plan `swept`, and pipeline_stats of the swept plan."""
    segs = sum(1 for p in parts if p[0] == "segment")
    sw = sweep_stats(swept)
    rec = {
        "kernel_segments": segs,
        "xla_passthroughs": len(parts) - segs,
        "full_state_passes": len(parts),
        "stages": sum(len(p[1]) for p in parts if p[0] == "segment"),
        "sweeps_enabled": knob_value("QUEST_SWEEP_FUSION"),
        "hbm_sweeps": sw["hbm_sweeps"],
        "sweep_stages": sw["sweep_stages"],
    }
    rec.update(pipeline_stats(swept, n, driver=driver, nbuf=nbuf,
                              budgets=budgets))
    return rec


# ---------------------------------------------------------------------------
# block geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Block/row geometry of one segment (the reference's _Geometry)."""
    n: int
    scat: Tuple[int, ...]       # scattered GLOBAL row bits, descending
    inner_bits: int
    gaps: Tuple[Tuple[int, int], ...]  # grid dims as (lo_bit, width_bits),
    # outermost first — one per gap above/between scattered axes plus the
    # gap between the lowest scattered bit and the inner rows

    @property
    def rows_eff(self) -> int:
        return 1 << (len(self.scat) + self.inner_bits)

    @property
    def tile_bits(self) -> int:
        """Index bits one tile holds: 7 lane bits + the in-block row bits."""
        return LANE_QUBITS + len(self.scat) + self.inner_bits

    @property
    def blocks(self) -> int:
        """Tiles (thread blocks) per launch."""
        return 1 << sum(w for (_, w) in self.gaps)

    def tile_row_bit(self, row_bit: int) -> int:
        """Position inside a tile's row index of GLOBAL row bit
        `row_bit`, which must be an inner or scattered bit. Tile rows are
        [scattered axes, highest first][inner rows] (the reference's
        _row_ids)."""
        if row_bit < self.inner_bits:
            return row_bit
        a = self.scat.index(row_bit)
        return self.inner_bits + len(self.scat) - 1 - a


def _geometry(n: int, scat_bits, rows_eff_bits: int) -> Geometry:
    total_row_bits = n - LANE_QUBITS
    scat = tuple(sorted(scat_bits, reverse=True))
    h = len(scat)
    inner_bits = min(rows_eff_bits - h,
                     scat[-1] if scat else total_row_bits,
                     total_row_bits)
    gaps = []
    hi = total_row_bits
    for s in scat:
        gaps.append((s + 1, hi - s - 1))
        hi = s
    gaps.append((inner_bits, hi - inner_bits))
    return Geometry(n, scat, inner_bits, tuple(gaps))


def segment_geometry(stages: Sequence, n: int, *,
                     budgets: Budgets = HOPPER_GEOMETRY) -> Geometry:
    """Block geometry of a stage list: `budgets.rows_eff_bits` rows,
    widened to what stage_requirements asks for."""
    total_row_bits = n - LANE_QUBITS
    rows_eff_bits = min(budgets.rows_eff_bits, total_row_bits)
    scat_bits, b1_bits = stage_requirements(stages)
    rows_eff_bits = max(rows_eff_bits, b1_bits + len(scat_bits))
    return _geometry(n, scat_bits, rows_eff_bits)


# ---------------------------------------------------------------------------
# tile copies: the launch's tensor map
# ---------------------------------------------------------------------------
#
# Every driver moves a tile's planes with cp.async.bulk.tensor requests on
# one f32 tensor map per launch (csrc quest_segment_sweep encodes it from the
# same numbers): the batch's planes as 5 dimensions, innermost first,
#   1. the 128 lanes of a row (contiguous, 512 B);
#   2. the rows below the lowest scattered row bit s0: 2^s0 rows of 512 B;
#   3. the lowest contiguous group of scattered row bits: 2^w rows at a
#      stride of 2^s0 rows;
#   4. the rows above that group;
#   5. the 2B planes of the batch (state s, plane p at 2s + p).
# A tile without scattered bits takes s0 = n - 7 and w = 0 (dimensions 3
# and 4 of size 1). A box covers 2^b consecutive tile rows in slot order:
# inner rows along dimension 2, then the group's bits along dimension 3.
# The free row bits and the bits of higher scattered groups go into the
# coordinates, one request per box; by default a box is as many tile rows
# as are contiguous in slot order, the whole plane on every plan of the
# paths but (0,(6,1)), (5,(1,1)) (2 boxes) and (4,(1,1,1)) (4). A plane
# may also move in `parts` parts of consecutive tile rows, each part's
# stores one bulk group and each part of a slot refilled on its own
# (ring_schedule); on an H100 2 and 4 parts measured no faster than one
# (PERF.md), so TMA_PARTS is 1 and more parts serve measurements. K3 takes
# the same map and boxes (a block's plane coordinate is 2 (state0 + y) +
# p, so the map spans the whole batch, every slice of it); it has no
# refills to split, and issues a plane's boxes in row order whatever the
# parts.


def _lowest_group(geo: Geometry) -> Tuple[int, int]:
    """(s0, w): the lowest scattered row bit and the width of the
    contiguous group it starts; (n - 7, 0) without scattered bits."""
    if not geo.scat:
        return geo.n - LANE_QUBITS, 0
    s0 = min(geo.scat)
    w = 1
    while s0 + w in geo.scat:
        w += 1
    return s0, w


def tma_boxes(geo: Geometry, batch: int = 1, *, parts: int = TMA_PARTS,
              box_rows: int = None) -> dict:
    """The tensor map of one launch over `batch` states of segment
    geometry `geo`: rank, dims and byte strides (dimensions 2-5), the box,
    and the copy unit — `parts` parts per plane, `box_rows` tile rows per
    request (None: as many as a part and the contiguous run of tile rows
    allow, the kernel's default). Raises ValueError for a copy unit the
    geometry cannot take or a map outside the tensor-map limits (rank <=
    5, box <= 256 per dimension, strides multiples of 16 below 2^40)."""
    row_bits = geo.n - LANE_QUBITS
    rows_log2 = geo.tile_bits - LANE_QUBITS
    if parts & (parts - 1) or not 1 <= parts <= min(MAX_TMA_PARTS,
                                                     1 << rows_log2):
        raise ValueError(f"a plane moves in 1, 2 or {MAX_TMA_PARTS} parts, "
                         f"got {parts}")
    part_log2 = rows_log2 - (parts.bit_length() - 1)
    s0, w = _lowest_group(geo)
    most = min(part_log2, geo.inner_bits + w)
    b = most if box_rows is None else box_rows.bit_length() - 1
    if box_rows is not None and (box_rows < 1 or box_rows & (box_rows - 1)
                                 or b > most):
        raise ValueError(f"a box of {box_rows} rows does not fit parts of "
                         f"2^{part_log2} rows with 2^{most} contiguous")
    b2 = min(b, geo.inner_bits)
    row_bytes = LANES * 4
    rec = {"rank": MAX_TMA_RANK,
           "dims": (LANES, 1 << s0, 1 << w, 1 << (row_bits - s0 - w),
                    2 * int(batch)),
           "strides": (row_bytes, row_bytes << s0, row_bytes << (s0 + w),
                       4 << geo.n),
           "box": (LANES, 1 << b2, 1 << (b - b2), 1, 1),
           "s0": s0, "w": w, "parts": parts, "box_rows": 1 << b,
           "requests_per_part": 1 << (part_log2 - b),
           "requests_per_plane": parts << (part_log2 - b),
           "box_bytes": row_bytes << b, "part_bytes": row_bytes << part_log2}
    if (max(rec["box"]) > MAX_TMA_BOX or len(rec["dims"]) > MAX_TMA_RANK
            or any(x % 16 or x >= 1 << 40 for x in rec["strides"])
            or max(rec["dims"]) >= 1 << 32):
        raise ValueError(f"tensor map outside the TMA limits: {rec}")
    return rec


def tile_rows(geo: Geometry, tile: int,
              skip: Tuple[int, int] = (0, 0)) -> List[int]:
    """Global row of each tile row of tile `tile` (slot order), as csrc
    tile_base and tile_row build it: the tile index spread over the free
    row bits (low first), then the inner rows and the scattered bits.
    `skip` = (fixed mask, fixed rows) of a launch that holds some free
    bits fixed (ops.segment.phase_skip): the index walks the other free
    bits, and those take their fixed value."""
    scat = sorted(geo.scat)
    free = [b for b in range(geo.inner_bits, geo.n - LANE_QUBITS)
            if b not in geo.scat and not (skip[0] >> b) & 1]
    base = sum(((tile >> k) & 1) << b for k, b in enumerate(free)) | skip[1]
    rows = []
    for r in range(geo.rows_eff):
        row = base | (r & ((1 << geo.inner_bits) - 1))
        for k, b in enumerate(scat):
            row |= ((r >> (geo.inner_bits + k)) & 1) << b
        rows.append(row)
    return rows


def tma_requests(boxes: dict, geo: Geometry, tile: int,
                 skip: Tuple[int, int] = (0, 0)) -> List[tuple]:
    """(part, first tile row, (c1, c2, c3, c4)) of each request that moves
    one plane of tile `tile` (of a launch holding `skip`, tile_rows) under
    `boxes` (tma_boxes), in the kernel's order; the plane's coordinate (2
    * state + plane) comes fifth. Raises ValueError if a box would leave
    the tensor: TMA would count the full box either way, and the step's
    mbarrier would never complete."""
    rows = tile_rows(geo, tile, skip)
    s0, w = boxes["s0"], boxes["w"]
    per_part = len(rows) // boxes["parts"]
    out = []
    for i in range(boxes["parts"]):
        for q in range(boxes["requests_per_part"]):
            r0 = i * per_part + q * boxes["box_rows"]
            row = rows[r0]
            c = (0, row & ((1 << s0) - 1), (row >> s0) & ((1 << w) - 1),
                 row >> (s0 + w))
            if any(c[d] + boxes["box"][d] > boxes["dims"][d]
                   for d in range(4)):
                raise ValueError(f"box at {c} leaves the tensor {boxes}")
            out.append((i, r0, c))
    return out


def usable(n: int) -> bool:
    """Need at least one (8, 128) f32 tile per block."""
    return n >= LANE_QUBITS + 3
