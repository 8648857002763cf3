"""Band-fusion planner: compose gate runs into per-band operators.

The port's copy of quest_tpu/ops/fusion.py (jax-free there too), kept
so that quest_tpu_torch imports nothing of the JAX package; the
text below is the reference's.

THE central TPU kernel-engineering idea of this framework (SURVEY.md §7
"hard parts"): strided 2-element butterflies map terribly onto the TPU's
(8, 128) tiles and the 128x128 MXU, but a 7-qubit-aligned BAND of the
amplitude index is exactly one hardware axis:

    band 0 = qubits 0..6    the 128-lane axis
    band 1 = qubits 7..13   the sublane axis (rows within a 128-row tile)
    band 2 = qubits 14..20  the tile index
    band 3 = qubits 21..27  ... and so on, 7 bits per axis.

Any single-qubit gate (with controls anywhere) therefore becomes a
128x128 operator acting on ONE axis of the reshaped state — a batched
matmul the MXU executes natively. Consecutive commuting gates in the same
band compose into a single operator at trace time (numpy), so a whole
layer of single-qubit rotations costs ceil(n/7) memory passes instead of
n, each pass a dense contraction.

This is the role the reference's per-gate kernel zoo plays on CPU/GPU
(QuEST_cpu.c:1656-3620, QuEST_gpu.cu) — re-thought for the MXU instead of
translated.

Fused item kinds produced by `plan`:
  BandOp      composed 2^w x 2^w operator on one band, with optional
              out-of-band control predicates (masked matmul)
  DiagItem    diagonal / parity / all-ones phase GateOp — elementwise,
              any qubits; XLA fuses these into neighbouring passes for
              free (the reference's "diagonals never communicate" insight,
              QuEST_cpu.c:2940-3109, taken one step further)
  PassOp      anything else (cross-band multi-target unitaries, Kraus
              superoperators) — falls through to the general apply path.

Commutation rule used when merging across intervening items: two ops
commute if on every shared qubit BOTH act diagonally (controls and
diagonal/parity ops act diagonally; matrix targets do not). This is a
sufficient condition, checked structurally — no numerics involved.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

BAND_W = 7  # qubits per hardware axis: 2^7 = 128 lanes / sublanes / tiles

_SWAP_MATRIX = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


@dataclasses.dataclass(frozen=True)
class _PhaseOp:
    """Synthetic GateOp-shaped record for planner-generated phase ops."""
    kind: str
    targets: Tuple[int, ...]
    controls: Tuple[int, ...]
    cstates: Tuple[int, ...]
    operand: object


# ---------------------------------------------------------------------------
# plan items
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BandOp:
    ql: int                     # first qubit of the band
    w: int                      # band width in qubits (<= BAND_W)
    gre: np.ndarray             # (2^w, 2^w) composed operator, real part
    gim: np.ndarray
    preds: Tuple[Tuple[int, int], ...]  # out-of-band (qubit, want) controls
    nondiag: frozenset          # qubits the operator genuinely mixes
    touched: frozenset          # all qubits involved (targets + controls)

    def qubits(self):
        return self.touched | {q for q, _ in self.preds}


@dataclasses.dataclass
class DiagItem:
    op: object                  # the original GateOp (diag/parity/allones)
    qubits_: frozenset

    def qubits(self):
        return self.qubits_


@dataclasses.dataclass
class PassOp:
    op: object
    nondiag: frozenset
    qubits_: frozenset

    def qubits(self):
        return self.qubits_


# ---------------------------------------------------------------------------
# operator embedding (band-local)
# ---------------------------------------------------------------------------


def embed_operator(matrix: np.ndarray, targets_rel: Sequence[int],
                   controls_rel: Sequence[int], cstates: Sequence[int],
                   width: int) -> np.ndarray:
    """Embed a k-qubit operator with in-band controls into the full
    2^width-dim band space (the full-operator construction the reference's
    test oracle uses, tests/utilities.hpp getFullOperatorMatrix — here it
    runs at trace time to build composed band operators)."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    k = len(targets_rel)
    dim = 1 << width
    op = np.zeros((dim, dim), dtype=np.complex128)
    for col in range(dim):
        if any(((col >> c) & 1) != s for c, s in zip(controls_rel, cstates)):
            op[col, col] = 1.0
            continue
        sub = 0
        for bit, t in enumerate(targets_rel):
            sub |= ((col >> t) & 1) << bit
        rest = col
        for t in targets_rel:
            rest &= ~(1 << t)
        for sub_out in range(1 << k):
            row = rest
            for bit, t in enumerate(targets_rel):
                if (sub_out >> bit) & 1:
                    row |= 1 << t
            op[row, col] = matrix[sub_out, sub]
    return op


def _diag_to_matrix(operand, kind) -> np.ndarray:
    if kind == "diagonal":
        return np.diag(np.asarray(operand, dtype=np.complex128).reshape(-1))
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _commutes(a_nondiag, a_all, b_nondiag, b_all) -> bool:
    """Structural commutation: every shared qubit must be diagonal-acting
    on both sides."""
    shared = a_all & b_all
    if not shared:
        return True
    return not (shared & (a_nondiag | b_nondiag))


def _band_of(q: int) -> int:
    return q // BAND_W


def band_range(n: int, b: int) -> Tuple[int, int]:
    """(first qubit, width) of band b for an n-qubit register."""
    ql = b * BAND_W
    return ql, min(BAND_W, n - ql)


class _SrcTrackedList(list):
    """plan()'s item list with per-item input-op attribution: append
    records the planner loop's current op index (`cur`) into a parallel
    `src` list; try_merge unions merged ops' indices in place. Kept
    inside the planner — callers see plain items plus the optional
    `attr` out-list."""

    __slots__ = ("src", "cur")

    def __init__(self):
        super().__init__()
        self.src: List[set] = []
        self.cur = -1

    def append(self, x):
        super().append(x)
        self.src.append({self.cur})


def plan(ops: Sequence, n: int, bands: Sequence[Tuple[int, int]] = None,
         attr: Optional[List] = None) -> List:
    """Fuse a GateOp sequence into [BandOp | DiagItem | PassOp], preserving
    semantics. Gate operands must be concrete (numpy) to compose; ops with
    traced operands become PassOps.

    `bands` optionally overrides the default 7-wide band layout with a
    list of (ql, w) ranges covering [0, n) — the Pallas engine uses this
    to align the tile band with its block top (pallas_band.plan_bands).

    `attr`, when a list, receives one frozenset per emitted item holding
    the INPUT op indices that item consumed (composition unions them; an
    op the planner decomposes — cross-band SWAP/KAK — attributes every
    piece). The durable executor's elastic-resume layer maps plan-step
    boundaries back to op-stream positions through this
    (quest_tpu/resilience/durable.py, docs/RESILIENCE.md §elastic)."""
    if bands is None:
        band_of = _band_of
        band_rng = lambda b: band_range(n, b)  # noqa: E731
    else:
        starts = [ql for ql, _ in bands]

        def band_of(q):
            import bisect
            return bisect.bisect_right(starts, q) - 1

        def band_rng(b):
            return bands[b]

    items = _SrcTrackedList()

    def try_merge(band: int, emb: np.ndarray, preds, nondiag, touched):
        """Merge emb into an existing BandOp for `band` if every item in
        between commutes with the new op. Returns True on success."""
        new_all = frozenset(touched) | {q for q, _ in preds}
        for i in range(len(items) - 1, -1, -1):
            g = items[i]
            if (isinstance(g, BandOp) and band_of(g.ql) == band
                    and g.preds == preds):
                comp = emb @ (g.gre.astype(np.complex128) + 1j * g.gim)
                items[i] = BandOp(g.ql, g.w, comp.real, comp.imag, preds,
                                  g.nondiag | nondiag, g.touched | touched)
                items.src[i].add(items.cur)
                return True
            g_nondiag = getattr(g, "nondiag", frozenset())
            if not _commutes(nondiag, new_all, g_nondiag, g.qubits()):
                return False
        return False

    for op_idx, op in enumerate(ops):
        items.cur = op_idx
        targets = tuple(op.targets)
        controls = tuple(op.controls)
        cstates = tuple(op.cstates) if op.cstates else (1,) * len(controls)

        if op.kind in ("measure", "measure_dm", "classical"):
            # dynamic-circuit items: opaque to fusion (a measurement or a
            # classically-conditioned gate commutes only with ops on
            # disjoint qubits; targets already claim density duals)
            items.append(PassOp(op, frozenset(targets),
                                frozenset(targets) | frozenset(controls)))
            continue

        if op.kind == "relabel":
            # whole-register relabel event (parallel/relabel.py
            # plan_full_relabels): a full barrier — it re-homes every
            # qubit, so nothing commutes across it
            items.append(PassOp(op, frozenset(range(n)),
                                frozenset(range(n))))
            continue

        if op.kind in ("parity", "allones"):
            # single-band phase ops fold into the band operator as diagonal
            # embeddings (an rz or a neighbour CZ costs nothing once the
            # band matmul runs anyway); cross-band ones stay elementwise
            opbands = {band_of(q) for q in targets + controls}
            if len(opbands) == 1 and isinstance(op.operand,
                                                (int, float, complex)):
                b = opbands.pop()
                ql, w = band_rng(b)
                if op.kind == "parity":
                    half = float(op.operand) / 2.0
                    diag = np.ones(1 << len(targets), dtype=np.complex128)
                    for i in range(diag.size):
                        parity = bin(i).count("1") & 1
                        diag[i] = np.exp(-1j * half * (-1.0) ** parity)
                    mat = np.diag(diag)
                    emb = embed_operator(mat, [t - ql for t in targets],
                                         [], [], w)
                else:  # allones: phase `term` where all listed qubits are 1
                    mat = np.diag([1.0, complex(op.operand)])
                    emb = embed_operator(
                        mat, [targets[0] - ql],
                        [q - ql for q in targets[1:] + controls],
                        [1] * (len(targets) - 1 + len(controls)), w)
                touched = frozenset(targets) | frozenset(controls)
                # fold ONLY into an existing band matmul (then it is free);
                # a phase op alone is cheaper elementwise than as a matmul
                if try_merge(b, emb, (), frozenset(), touched):
                    continue
            items.append(DiagItem(op, frozenset(targets) | frozenset(controls)))
            continue

        if (op.kind == "diagonal" and _concrete(op.operand)
                and len({band_of(q) for q in targets + controls}) > 1):
            # CONCRETE cross-band multi-qubit diagonal (the scheduler's
            # composed groups land here): elementwise on any qubits,
            # exactly like parity/allones — never a PassOp (a PassOp
            # would serialize a full general-apply pass AND split kernel
            # segments). Traced operands keep falling through to the
            # PassOp guard below: segment_plan's DiagVecStage lowering
            # needs a numpy table.
            items.append(DiagItem(op, frozenset(targets)
                                  | frozenset(controls)))
            continue

        operand = op.operand
        if not isinstance(operand, np.ndarray):
            operand = np.asarray(operand)
        if operand.dtype == object or not np.issubdtype(
                operand.dtype, np.number):
            items.append(PassOp(op, frozenset(targets),
                                frozenset(targets) | frozenset(controls)))
            continue

        tbands = {band_of(t) for t in targets}
        if len(tbands) != 1:
            # cross-band SWAP: decompose into 3 CNOTs (each a 1q target
            # with a control — controls fuse as masks, so the whole swap
            # stays in-kernel). The reference instead relabels qubits via
            # distributed swaps (QuEST_cpu_distributed.c:1441-1483).
            if (op.kind == "matrix" and len(targets) == 2 and not controls
                    and operand.shape == (4, 4)
                    and np.allclose(operand, _SWAP_MATRIX)):
                a_q, b_q = targets
                x_mat = np.array([[0.0, 1.0], [1.0, 0.0]])
                for tgt, ctl in ((b_q, a_q), (a_q, b_q), (b_q, a_q)):
                    # targets sit in different bands, so the control is
                    # always out-of-band: a masked-matmul predicate
                    b = band_of(tgt)
                    ql, w = band_rng(b)
                    preds = ((ctl, 1),)
                    emb = embed_operator(x_mat, [tgt - ql], [], [], w)
                    nd = frozenset((tgt,))
                    tc = frozenset((tgt, ctl))
                    if not try_merge(b, emb, preds, nd, tc):
                        items.append(BandOp(ql, w, emb.real, emb.imag,
                                            preds, nd, tc))
                continue
            # general cross-band 2q UNITARY: KAK-decompose into local 1q
            # factors + parity rotations (quest_tpu/ops/kak.py) — every
            # piece fuses, so the gate never leaves the kernel
            if (op.kind == "matrix" and len(targets) == 2 and not controls
                    and operand.shape == (4, 4)
                    and np.allclose(operand @ operand.conj().T, np.eye(4),
                                    atol=1e-9)):
                from quest_tpu_torch.ops import kak as K
                for item in K.kak_gate_sequence(operand, *targets):
                    if item[0] == "1q":
                        _, tq, mat = item
                        b = band_of(tq)
                        ql, w = band_rng(b)
                        emb = embed_operator(mat, [tq - ql], [], [], w)
                        nd, tc = frozenset((tq,)), frozenset((tq,))
                        if not try_merge(b, emb, (), nd, tc):
                            items.append(BandOp(ql, w, emb.real, emb.imag,
                                                (), nd, tc))
                    else:
                        _, pq, ang = item
                        pop = _PhaseOp("parity", tuple(pq), (), (),
                                       float(ang))
                        items.append(DiagItem(pop, frozenset(pq)))
                continue
            # remaining cross-band multi-target ops (superop targets,
            # controlled 2q across bands, non-unitary) — general apply path
            items.append(PassOp(op, frozenset(targets),
                                frozenset(targets) | frozenset(controls)))
            continue

        b = tbands.pop()
        ql, w = band_rng(b)
        in_c = [c for c in controls if band_of(c) == b]
        in_s = [s for c, s in zip(controls, cstates) if band_of(c) == b]
        preds = tuple(sorted((c, s) for c, s in zip(controls, cstates)
                             if band_of(c) != b))
        mat = (_diag_to_matrix(operand, "diagonal")
               if op.kind == "diagonal" else np.asarray(operand))
        emb = embed_operator(mat, [t - ql for t in targets],
                             [c - ql for c in in_c], in_s, w)
        nondiag = (frozenset() if op.kind == "diagonal"
                   else frozenset(targets))
        touched = frozenset(targets) | frozenset(controls)
        if try_merge(b, emb, preds, nondiag, touched):
            continue
        if op.kind == "diagonal":
            # same policy as parity/allones: a diagonal alone is cheaper
            # elementwise than as a band matmul
            items.append(DiagItem(op, touched))
            continue
        items.append(BandOp(ql, w, emb.real, emb.imag, preds, nondiag,
                            touched))
    if attr is not None:
        attr.extend(frozenset(s) for s in items.src)
    return list(items)


# ---------------------------------------------------------------------------
# commutation-aware gate scheduler (runs BEFORE plan)
# ---------------------------------------------------------------------------
#
# plan() composes runs in PROGRAM ORDER: try_merge walks backward past
# structurally-commuting items, but a diagonal op emitted between two
# non-commuting gates stays where the program put it. On phase-heavy
# circuits that order is the binding constraint — QFT-30 interleaves its
# 435 controlled phases with the Hadamard cascade, so the fused engine
# sees 465 alternating stages and flushes a kernel segment every
# MAX_SEGMENT_STAGES of them (14 full-state HBM passes measured r5;
# the 3x QFT-vs-RCS gates/s gap of VERDICT r5 weak #3).
#
# schedule() legally reorders the flat op list before planning:
#
#   * every diagonal-class op (diagonal / parity / allones — ops that act
#     diagonally on ALL their qubits) is held in a pending pool and
#     DELAYED past later ops it structurally commutes with (the same
#     diagonal-on-shared-qubits rule plan() merges by, used in the other
#     direction);
#   * a non-diagonal op forces out only the pool entries sharing one of
#     its mixed qubits — everything else keeps floating, so phases from
#     MANY original layers pool together;
#   * each forced flush greedily packs the pooled ops into groups of
#     union support <= DIAG_FUSE_MAX qubits and COMPOSES every group
#     into one explicit k-qubit diagonal (a 2^k table op all engines
#     already execute: apply_diagonal on XLA, DiagVecStage or the
#     additive MultiPhaseStage in the Pallas kernels, the
#     communication-free _diagonal_op on the mesh). QFT's per-layer
#     phase runs collapse into ~a group per support-window instead of
#     one stage per phase.
#
# The reorder never crosses a dynamic op (measure / classical), a
# relabel event, or any op the pooled diagonal shares a mixed qubit
# with — the commutation argument is exactly plan()'s structural rule,
# so scheduled and unscheduled programs are unitarily identical (up to
# float reassociation inside composed tables; equivalence-fuzzed across
# engines in tests/test_scheduler.py).

DIAG_FUSE_MAX = 7   # composed-diagonal support cap: 2^7 table entries,
                    # segment views stay rank <= 15 (TPU-supported), and
                    # one band can still host the whole table


def _schedule_enabled() -> bool:
    """QUEST_SCHEDULE knob: '1' (default) runs the commutation-aware
    scheduler in front of every fusing engine's planner; '0' disables.
    Parsed loudly per the config convention; part of every compiled
    program's cache key (circuit._engine_mode_key)."""
    from quest_tpu_torch.env import knob_value
    return knob_value("QUEST_SCHEDULE")


@dataclasses.dataclass(frozen=True)
class ComposedDiag:
    """Scheduler-built k-qubit diagonal: the composition of a group of
    commuting diagonal-class GateOps. Duck-types as a GateOp of kind
    'diagonal' (every engine applies `operand` as a (2^k,) table over
    `targets`); `parts` additionally carries the components in
    TARGET-RELATIVE form — ('allones', idx_tuple, theta) /
    ('parity', idx_tuple, angle), idx indexing into `targets` — so the
    Pallas planner can lower phase-only groups to one additive
    MultiPhaseStage instead of a 2^k select chain. Relative encoding
    keeps parts valid under target remapping (the sharded relabel pass
    rewrites targets via dataclasses.replace)."""
    kind: str
    targets: Tuple[int, ...]
    controls: Tuple[int, ...]
    cstates: Tuple[int, ...]
    operand: object
    parts: Tuple = ()


def _diag_class(op) -> bool:
    """Ops the scheduler may pool: structurally diagonal on every qubit
    they touch AND spanning more than one 7-qubit band. Single-band
    diagonals are deliberately left in program order — plan() folds them
    into the neighbouring band operator for FREE (try_merge), which
    beats any composition; pooling them away from their band op was
    measured to UNDO that fold (band passes 48 -> 73 on QFT-30).
    Controlled allones ops are excluded — the eager XLA applier ignores
    allones controls (circuit._apply_one), so their semantics are not
    uniform enough to move around."""
    if op.kind == "diagonal":
        qs = tuple(op.targets) + tuple(op.controls)
    elif op.kind in ("parity", "allones") and not op.controls:
        qs = tuple(op.targets)
    else:
        return False
    return len({_band_of(q) for q in qs}) > 1


def _concrete(x) -> bool:
    if isinstance(x, (int, float, complex)):
        return True
    if isinstance(x, np.ndarray):
        return (x.dtype != object
                and np.issubdtype(x.dtype, np.number))
    return False


def _nondiag_qubits(op) -> frozenset:
    """Qubits on which `op` acts NON-diagonally (the set a pooled
    diagonal must not share): matrix targets mix; controls are diagonal;
    dynamic/relabel ops conservatively claim everything they touch."""
    if op.kind in ("measure", "measure_dm", "classical", "relabel"):
        return frozenset(op.targets) | frozenset(op.controls)
    if op.kind in ("diagonal", "parity", "allones"):
        return frozenset()
    return frozenset(op.targets)


def _compose_diag_group(group) -> ComposedDiag:
    """Multiply a group of commuting diagonal-class ops into ONE
    explicit diagonal over the sorted union of their qubits. Exact
    up to float reassociation: every component is itself diagonal, so
    the product is the elementwise product of their embedded tables."""
    support = sorted(set().union(*(set(op.targets) | set(op.controls)
                                   for op in group)))
    idx_of = {q: j for j, q in enumerate(support)}
    k = len(support)
    table = np.ones(1 << k, dtype=np.complex128)
    ids = np.arange(1 << k)
    parts: List[Tuple] = []
    phase_only = True
    for op in group:
        if op.kind == "parity":
            bits = tuple(idx_of[q] for q in op.targets)
            sel = np.zeros(1 << k, dtype=np.int64)
            for b in bits:
                sel ^= (ids >> b) & 1
            half = float(op.operand) / 2.0
            table *= np.exp(-1j * half * np.where(sel, -1.0, 1.0))
            parts.append(("parity", bits, float(op.operand)))
        elif op.kind == "allones":
            bits = tuple(idx_of[q] for q in op.targets)
            match = np.ones(1 << k, dtype=bool)
            for b in bits:
                match &= ((ids >> b) & 1) == 1
            t = complex(op.operand)
            table = np.where(match, table * t, table)
            if abs(abs(t) - 1.0) < 1e-12:
                parts.append(("allones", bits, float(np.angle(t))))
            else:
                phase_only = False
        else:  # diagonal (possibly controlled)
            d = np.asarray(op.operand,
                           dtype=np.complex128).reshape(-1)
            tbits = [idx_of[q] for q in op.targets]
            sub = np.zeros(1 << k, dtype=np.int64)
            for j, b in enumerate(tbits):
                sub |= ((ids >> b) & 1) << j
            factor = d[sub]
            cstates = op.cstates or (1,) * len(op.controls)
            for c, s in zip(op.controls, cstates):
                factor = np.where(((ids >> idx_of[c]) & 1) == s,
                                  factor, 1.0)
            table *= factor
            phase_only = False
    return ComposedDiag("diagonal", tuple(support), (), (), table,
                        tuple(parts) if phase_only else ())


def compose_diag_runs(ops: Sequence, diag_max: int = DIAG_FUSE_MAX
                      ) -> List:
    """Pooling entry for SYNTHESIZED diagonal layers (the evolution
    compiler's Trotter blocks, quest_tpu/evolution.py): greedily pack a
    flat run of diagonal-class ops — parity / allones / concrete
    diagonal, which all mutually commute by construction — into
    `ComposedDiag` groups of union support <= diag_max, preserving
    first-op order between groups.

    This deliberately pools SINGLE-band diagonals too: schedule()'s
    `_diag_class` leaves those in program order because a neighbouring
    band matmul absorbs them for free (try_merge), but a synthesized
    diagonal layer has no adjacent band operator — left unpooled, a
    30-term Trotter diagonal block runs as 30 separate kernel phase
    stages where ~5 additive MultiPhaseStage groups carry the same
    math. Ops that cannot compose (traced operands, support wider than
    diag_max, non-diagonal kinds) pass through unchanged in place.

    The caller asserts mutual commutation — this entry does NO
    commutation analysis, unlike schedule(); do not feed it ops that
    mix with non-diagonal gates."""
    groups: List[list] = []       # [support_set, [ops], first_pos]
    passthrough: List[Tuple[int, object]] = []
    for pos, op in enumerate(ops):
        qs = set(op.targets) | set(op.controls)
        # controlled parity/allones pass through: _compose_diag_group's
        # parity/allones branches read targets only (schedule()'s
        # _diag_class excludes them for the same reason) — composing
        # one would silently drop its controls; controlled 'diagonal'
        # composes fine (the group table embeds controls as identity
        # rows)
        composable = (op.kind in ("parity", "allones", "diagonal")
                      and _concrete(op.operand) and len(qs) <= diag_max
                      and not (op.controls and op.kind != "diagonal"))
        if not composable:
            passthrough.append((pos, op))
            continue
        placed = False
        for g in groups:
            if len(g[0] | qs) <= diag_max:
                g[0] |= qs
                g[1].append(op)
                placed = True
                break
        if not placed:
            groups.append([qs, [op], pos])
    emitted: List[Tuple[int, object]] = list(passthrough)
    for _, members, pos in groups:
        if len(members) >= 2:
            emitted.append((pos, _compose_diag_group(members)))
        else:
            emitted.append((pos, members[0]))
    emitted.sort(key=lambda e: e[0])
    return [op for _, op in emitted]


def fixed_run_plan(ops: Sequence, n: int) -> List:
    """Band-fuse a CONSTANT op run for the adjoint engine's fixed
    segments (quest_tpu/adjoint.py): a plain `plan()` call with the
    adjoint contract asserted up front — every operand concrete (a
    traced operand would silently become an unfusable PassOp and the
    backward walk could no longer invert it exactly) and no dynamic
    ops (measurement/classical control have no inverse stream). The
    returned items feed circuit._apply_banded_items on both the
    forward sweep and, rebuilt from the inverted run, the backward
    walk."""
    for i, op in enumerate(ops):
        if op.kind in ("superop", "measure", "measure_dm", "classical",
                       "relabel"):
            raise ValueError(
                f"fixed_run_plan: op {i} ({op.kind}) is not a constant "
                f"invertible gate")
        if not _concrete(op.operand):
            raise ValueError(
                f"fixed_run_plan: op {i} ({op.kind}) carries a traced "
                f"operand; the adjoint engine needs concrete gates")
    return plan(ops, n)


def schedule(flat: Sequence, n: int,
             diag_max: int = DIAG_FUSE_MAX) -> Tuple[List, dict]:
    """Commutation-aware reorder + diagonal composition of a FLAT op
    list (density duals already expanded — run after flatten_ops).
    Returns (new op list, stats). Stats keys:

      pooled       diagonal-class ops that entered the pool
      delayed      pool entries that legally crossed >= 1 later op
      hoisted      emitted diagonals moved EARLIER past commuting ops
      fused_ops    ops absorbed into composed diagonals
      fused_groups composed diagonals emitted (size >= 2)
    """
    out: List = []
    pool: List[list] = []    # [op, delayed_flag]
    stats = {"pooled": 0, "delayed": 0, "fused_ops": 0,
             "fused_groups": 0, "hoisted": 0}

    def _insert_diag(op):
        """Place an emitted diagonal at its EARLIEST legal position in
        `out`: walk backward past every op it structurally commutes
        with (all diagonals, and non-diagonal ops on disjoint qubits).
        Without this hoist a forced group lands right before the gate
        that forced it — BETWEEN a band operator and the same-band gate
        try_merge would have composed into it (measured on QFT-30:
        emission-order placement broke the Hadamard band composition,
        52 -> 98 banded passes). Hoisting also piles the groups of
        neighbouring flushes into adjacent runs, which is what lets the
        banded engine fuse them into one elementwise pass."""
        qs = frozenset(op.targets) | frozenset(op.controls)
        i = len(out)
        while i > 0:
            prev = out[i - 1]
            if prev.kind in ("measure", "measure_dm", "classical",
                             "relabel"):
                break
            if _nondiag_qubits(prev) & qs:
                break
            i -= 1
        if i != len(out):
            stats["hoisted"] += 1
        out.insert(i, op)

    def flush(conflict: Optional[frozenset]):
        """Emit pool entries touching `conflict` (None = all), packing
        them — plus any still-floating entries that fit — into composed
        groups of union support <= diag_max."""
        if not pool:
            return
        if conflict is None:
            forced = list(pool)
        else:
            forced = [e for e in pool
                      if (frozenset(e[0].targets)
                          | frozenset(e[0].controls)) & conflict]
        if not forced:
            return
        groups: List[list] = []      # [support_set, [entries], open]
        # membership by IDENTITY: GateOp equality compares ndarray
        # operands elementwise, which raises on duplicate ops
        forced_ids = {id(e) for e in forced}
        floating = [e for e in pool if id(e) not in forced_ids]
        for e in forced + floating:
            op = e[0]
            qs = set(op.targets) | set(op.controls)
            composable = (_concrete(op.operand)
                          and len(qs) <= diag_max)
            placed = False
            if composable:
                for g in groups:
                    if g[2] and len(g[0] | qs) <= diag_max:
                        g[0] |= qs
                        g[1].append(e)
                        placed = True
                        break
            if id(e) in forced_ids and not placed:
                # no room, or the op itself is uncomposable (traced
                # operand / support wider than diag_max): a CLOSED
                # single-op group — later ops must not join it, or the
                # emission below would compose past the diag_max cap
                groups.append([qs, [e], composable])
            elif not placed:
                continue             # floating op stays pooled
        emitted = set()
        for _, entries, open_ in groups:
            ops = [e[0] for e in entries]
            if open_ and len(ops) >= 2:
                _insert_diag(_compose_diag_group(ops))
                stats["fused_ops"] += len(ops)
                stats["fused_groups"] += 1
            else:
                for o in ops:
                    _insert_diag(o)
            for e in entries:
                if e[1]:
                    stats["delayed"] += 1
                emitted.add(id(e))
        pool[:] = [e for e in pool if id(e) not in emitted]

    for op in flat:
        if _diag_class(op):
            pool.append([op, False])
            stats["pooled"] += 1
            continue
        if op.kind in ("measure", "measure_dm", "classical", "relabel"):
            flush(None)
            out.append(op)
            continue
        flush(_nondiag_qubits(op))
        for e in pool:
            e[1] = True              # survived past a later op
        out.append(op)
    flush(None)
    return out, stats


def maybe_schedule(flat: Sequence, n: int) -> List:
    """schedule() honoring the QUEST_SCHEDULE knob — the engines' entry
    point (stats consumers call schedule() / schedule_summary)."""
    if not _schedule_enabled():
        return list(flat)
    return schedule(flat, n)[0]


def schedule_summary(flat: Sequence, n: int) -> dict:
    """Scheduler stats for introspection (explain / explain_sharded):
    runs the scheduler on a copy whether or not the knob is on, and
    reports whether the engines will actually use it."""
    enabled = _schedule_enabled()
    _, stats = schedule(flat, n)
    stats["enabled"] = enabled
    return stats


def plan_stats(items: Sequence) -> dict:
    """Hardware-independent pass statistics of a fusion plan under the
    BANDED-engine cost model: every BandOp and PassOp is one full-state
    pass; a maximal run of consecutive DiagItems fuses into ONE pass
    (XLA fuses adjacent elementwise ops). The Pallas engine's segment
    count is the fused-model equivalent (pallas_band.segment_plan);
    circuit.Circuit.plan_stats reports both."""
    band_passes = sum(1 for it in items if isinstance(it, BandOp))
    pass_ops = sum(1 for it in items if isinstance(it, PassOp))
    diag_items = 0
    diag_runs = 0
    prev_diag = False
    for it in items:
        is_diag = isinstance(it, DiagItem)
        if is_diag:
            diag_items += 1
            if not prev_diag:
                diag_runs += 1
        prev_diag = is_diag
    return {
        "band_passes": band_passes,
        "pass_ops": pass_ops,
        "diag_items": diag_items,
        "diag_runs": diag_runs,
        "full_state_passes": band_passes + pass_ops + diag_runs,
    }
