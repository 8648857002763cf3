"""Circuit transpiler: deterministic gate-count reduction BEFORE planning.

A port of quest_tpu/transpile.py: the same five passes, barriers, cost
model (the port's fusion.plan_stats) and report, op for op. An angle
that is a torch tensor (requires_grad included) folds by tensor
addition, so its autograd graph runs through the folded operand.

Every engine in the stack executes the op stream as the author wrote it —
fusion packs gates into bands, the autotuner picks the cheapest engine/
comm/geometry, but nothing reduces the gate count itself. Foreign circuits
(OpenQASM corpora, Qiskit exports) arrive rebased into long 1q+CX chains
(the Q-GEAR observation, arXiv:2504.03967): adjacent inverses, mergeable
1q runs, foldable Rz chains and re-synthesizable 2q runs all pay full HBM
sweeps. This module rewrites the stream into a provably-equivalent cheaper
one; `plan.autotune` prices raw-vs-transpiled with the same
incumbent-wins-ties discipline as every other plan axis (docs/TRANSPILE.md).

Five composable passes, applied per measurement-free stretch (dynamic ops
— measure / classical feedback / noise channels — are barriers; the
stream between barriers is rewritten, the barriers themselves never move):

  cancel     adjacent gate/inverse pairs, including through structurally-
             commuting separators (fusion._commutes legality), plus
             identity and global-phase elimination. The residual global
             phase is re-emitted as ONE [c, c] diagonal so statevector
             equivalence is exact, not up-to-phase.
  fold       same-axis parametric runs merge additively: Rz(a)·Rz(b) ->
             Rz(a+b) via the `as_rotation` contract, elementwise
             products for diagonal/allones pairs. Parity folding adds the
             stored operands directly, never through float(), so a
             tensor angle keeps its autograd graph.
  merge1q    maximal single-qubit runs composed into one u3 (exact 2x2
             product accumulated in complex128); a diagonal result is
             emitted as a diagonal op so it stays poolable downstream.
  resynth2q  maximal 2-qubit runs are KAK-decomposed through ops/kak.py
             into <= 3 parity cores + a 1q layer, accepted ONLY when the
             rewrite is cheaper under the target engine's own cost model
             (fusion.plan_stats full-state passes, tie-broken on op
             count) — never a blind rebase.
  cancel3q   identity-window elimination over <= 3-qubit neighborhoods:
             a prefix-product scan drops every contiguous window whose
             dense composition is a global phase — the block-level
             cancellations pairwise peephole can't see (a toffoli pair
             in its 15-op Clifford+T form, an uncompute block).

Equivalence contract (pinned in tests/test_transpile.py and
scripts/check_transpile_golden.py):

  * exact_only=True restricts to the bit-identical subset: only ops whose
    pairwise product is EXACTLY the identity (permutation matrices,
    exact-inverse diagonal tables) are cancelled, and only exact
    identities are dropped. Executing the rewritten stream is
    bit-for-bit the original on every engine.
  * The default mode additionally merges/resynthesizes: rewritten
    unitaries are eps-close to the dense composed oracle (f32 1e-5 /
    f64 1e-12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from quest_tpu_torch import circuit as CC
from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.env import knob_value
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import kak as K
from quest_tpu_torch.ops import matrices as M

PASSES = ("cancel", "fold", "merge1q", "resynth2q", "cancel3q")

# op kinds the passes may touch; everything else (measure, measure_dm,
# classical, superop, relabel, future kinds) is a barrier the rewrite
# never crosses and never reorders
_STATIC_KINDS = frozenset({"matrix", "diagonal", "parity", "allones"})

_ID2 = np.eye(2, dtype=np.complex128)
_ATOL = 1e-12          # complex128 composition tolerance
_FIXPOINT_ITERS = 8    # peephole cascade bound per stretch


# ---------------------------------------------------------------------------
# structural helpers
# ---------------------------------------------------------------------------


def _all_qubits(op: GateOp) -> frozenset:
    return frozenset(op.targets) | frozenset(op.controls)


def _commutes(a: GateOp, b: GateOp) -> bool:
    return F._commutes(F._nondiag_qubits(a), _all_qubits(a),
                       F._nondiag_qubits(b), _all_qubits(b))


def _static(op: GateOp) -> bool:
    """Ops the rewrite may reason about. Controlled allones ops are
    excluded (the eager applier ignores allones controls — see
    fusion._diag_class — so their semantics are not the dense embedding);
    scheduler-shaped ComposedDiag items (carry `parts`) never appear in a
    raw builder stream but are excluded defensively."""
    if op.kind not in _STATIC_KINDS:
        return False
    if op.kind == "allones" and op.controls:
        return False
    if getattr(op, "parts", None) is not None:
        return False
    return True


def _concrete(op: GateOp) -> bool:
    return F._concrete(op.operand)


def _ctrl_sig(op: GateOp):
    """Order-insensitive (control qubit -> required state) signature.
    Circuit._add always fills cstates, but normalize anyway."""
    cstates = op.cstates if op.cstates else (1,) * len(op.controls)
    return frozenset(zip(op.controls, cstates))


def _identity_phase(op: GateOp, exact_only: bool) -> Optional[complex]:
    """c such that dropping `op` and multiplying the global phase by c is
    equivalent, or None. In exact mode only EXACT identities (c == 1,
    operand bitwise trivial) qualify — executing them is bit-identical to
    skipping them (multiply by exact 1.0/0.0)."""
    if not _static(op) or not _concrete(op):
        return None
    if op.kind == "parity":
        return 1.0 if float(op.operand) == 0.0 else None
    if op.kind == "allones":
        return 1.0 if complex(op.operand) == 1.0 else None
    if op.kind == "diagonal":
        d = np.asarray(op.operand)
        if exact_only:
            return 1.0 if np.array_equal(d, np.ones_like(d)) else None
        c = complex(d.flat[0])
        if not np.allclose(d, c, atol=_ATOL):
            return None
        if abs(c - 1.0) <= _ATOL:
            return 1.0
        # a uniform non-1 diagonal is a global phase only when uncontrolled
        return c if not op.controls and abs(abs(c) - 1.0) <= _ATOL else None
    # matrix
    m = np.asarray(op.operand)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        return None
    eye = np.eye(m.shape[0], dtype=m.dtype)
    if exact_only:
        return 1.0 if np.array_equal(m, eye) else None
    c = complex(m[0, 0])
    if not np.allclose(m, c * eye, atol=_ATOL):
        return None
    if abs(c - 1.0) <= _ATOL:
        return 1.0
    return c if not op.controls and abs(abs(c) - 1.0) <= _ATOL else None


# ---------------------------------------------------------------------------
# pass 1+3: peephole cancellation + rotation folding (one backward scan)
# ---------------------------------------------------------------------------


def _cancel_rule(a: GateOp, b: GateOp, exact_only: bool):
    """('drop2', phase) when b composed onto a is the identity up to a
    unit global phase (exact mode: exactly the identity), else None."""
    if a.kind != b.kind or _ctrl_sig(a) != _ctrl_sig(b):
        return None
    if not (_concrete(a) and _concrete(b)):
        return None
    if a.kind == "matrix":
        if a.targets != b.targets:
            return None
        p = np.asarray(b.operand) @ np.asarray(a.operand)
        eye = np.eye(p.shape[0], dtype=p.dtype)
        if exact_only:
            return ("drop2", 1.0) if np.array_equal(p, eye) else None
        c = complex(p[0, 0])
        if np.allclose(p, c * eye, atol=_ATOL) and abs(abs(c) - 1.0) <= _ATOL:
            if abs(c - 1.0) <= _ATOL:
                return ("drop2", 1.0)
            if not a.controls:
                return ("drop2", c)
        return None
    if a.kind == "diagonal":
        if a.targets != b.targets:
            return None
        p = np.asarray(a.operand) * np.asarray(b.operand)
        if exact_only:
            return (("drop2", 1.0)
                    if np.array_equal(p, np.ones_like(p)) else None)
        c = complex(p.flat[0])
        if np.allclose(p, c, atol=_ATOL) and abs(abs(c) - 1.0) <= _ATOL:
            if abs(c - 1.0) <= _ATOL:
                return ("drop2", 1.0)
            if not a.controls:
                return ("drop2", c)
        return None
    if a.kind == "parity":
        if frozenset(a.targets) != frozenset(b.targets):
            return None
        # IEEE: x + (-x) == 0.0 exactly, so the inverse-pair case is hit
        # without a tolerance; removal is eps-valid (strictly MORE
        # accurate than executing both rotations)
        if exact_only:
            return None
        return ("drop2", 1.0) if float(a.operand) + float(b.operand) == 0.0 \
            else None
    if a.kind == "allones":
        if frozenset(a.targets) != frozenset(b.targets):
            return None
        p = complex(a.operand) * complex(b.operand)
        if exact_only:
            return ("drop2", 1.0) if p == 1.0 else None
        return ("drop2", 1.0) if abs(p - 1.0) <= _ATOL else None
    return None


def _fold_rule(a: GateOp, b: GateOp):
    """('merge', op) folding b into a: additive parity angles (a tensor
    operand stays a tensor, its autograd graph intact), elementwise
    diagonal/allones products, same-axis rx/ry via as_rotation."""
    if a.kind != b.kind or _ctrl_sig(a) != _ctrl_sig(b):
        return None
    if a.kind == "parity":
        if frozenset(a.targets) != frozenset(b.targets):
            return None
        return ("merge", dataclasses.replace(a, operand=a.operand + b.operand))
    if not (_concrete(a) and _concrete(b)):
        return None
    if a.kind == "diagonal":
        if a.targets != b.targets:
            return None
        return ("merge", dataclasses.replace(
            a, operand=np.asarray(a.operand) * np.asarray(b.operand)))
    if a.kind == "allones":
        if frozenset(a.targets) != frozenset(b.targets):
            return None
        return ("merge", dataclasses.replace(
            a, operand=complex(a.operand) * complex(b.operand)))
    if a.kind == "matrix" and a.targets == b.targets and not a.controls:
        ra, rb = CC.as_rotation(a), CC.as_rotation(b)
        if ra is None or rb is None or ra[0] != rb[0]:
            return None
        if ra[0] == "rx":
            axis = (1.0, 0.0, 0.0)
        elif ra[0] == "ry":
            axis = (0.0, 1.0, 0.0)
        else:
            return None
        return ("merge", dataclasses.replace(
            a, operand=np.asarray(M.rotation(ra[1] + rb[1], axis))))
    return None


def _peephole(ops: List[GateOp], exact_only: bool, stats: dict,
              phase_cell: List[complex]) -> List[GateOp]:
    """One forward pass with a backward commuting-separator scan: each
    incoming op walks back through the output past structurally-commuting
    ops (fusion._commutes legality) looking for a cancel partner or a
    fold partner. Cascades (X Y Y X -> empty) because later ops rescan
    the shortened output.

    The scan is indexed per qubit: ops DISJOINT from the incoming op
    always commute (fusion._commutes on an empty shared set) and can
    never be rule partners (both rules require equal targets), so only
    ops that share a qubit are visited — the walk is bounded by the
    per-qubit overlap depth, not the stream length (the difference
    between O(ops) and O(ops^2) on wide foreign circuits). Cancelled
    ops become tombstones (None) compacted at the end so the per-qubit
    indices stay valid; a non-static op is a full barrier exactly as in
    the linear scan (no candidate behind it is reachable)."""
    out: List[Optional[GateOp]] = []
    touch: dict = {}            # qubit -> indices into out (append-only)
    barrier = -1                # index of the newest non-static op
    for op in ops:
        c = _identity_phase(op, exact_only)
        if c is not None:
            stats["identity"] += 1
            phase_cell[0] *= c
            continue
        if not _static(op):
            barrier = len(out)
            out.append(op)
            continue
        lists = []
        ptrs = []
        for q in {*op.targets, *op.controls}:
            lst = touch.get(q)
            if lst:
                lists.append(lst)
                ptrs.append(len(lst) - 1)
        placed = False
        while True:
            # lazy descending merge of the per-qubit index lists: the
            # scan almost always stops at the first overlapping op, so
            # materializing/sorting the union would dominate the pass
            j = -1
            for i, lst in enumerate(lists):
                p = ptrs[i]
                if p >= 0 and lst[p] > j:
                    j = lst[p]
            if j <= barrier:
                break
            for i, lst in enumerate(lists):
                p = ptrs[i]
                while p >= 0 and lst[p] >= j:
                    p -= 1
                ptrs[i] = p
            prev = out[j]
            if prev is None:
                continue
            r = _cancel_rule(prev, op, exact_only)
            if r is not None:
                out[j] = None
                stats["cancel"] += 1
                phase_cell[0] *= r[1]
                placed = True
                break
            if not exact_only:
                r = _fold_rule(prev, op)
                if r is not None:
                    merged = r[1]
                    cm = _identity_phase(merged, exact_only)
                    if cm is not None:
                        out[j] = None
                        phase_cell[0] *= cm
                    else:
                        out[j] = merged
                    stats["fold"] += 1
                    placed = True
                    break
            if not _commutes(prev, op):
                break
        if not placed:
            idx = len(out)
            out.append(op)
            for q in op.targets:
                touch.setdefault(q, []).append(idx)
            for q in op.controls:
                touch.setdefault(q, []).append(idx)
    return [o for o in out if o is not None]


# ---------------------------------------------------------------------------
# pass 2: 1q run merging
# ---------------------------------------------------------------------------


def _u2_of(op: GateOp) -> Optional[np.ndarray]:
    """The 2x2 unitary of an eligible uncontrolled single-qubit op."""
    if not _static(op) or op.controls or len(op.targets) != 1 \
            or not _concrete(op):
        return None
    if op.kind == "matrix":
        m = np.asarray(op.operand, dtype=np.complex128)
        return m if m.shape == (2, 2) else None
    if op.kind == "diagonal":
        d = np.asarray(op.operand, dtype=np.complex128)
        return np.diag(d) if d.shape == (2,) else None
    if op.kind == "parity":
        half = float(op.operand) / 2.0
        return np.diag([np.exp(-1j * half), np.exp(1j * half)])
    # allones on one target: phase on |1>
    return np.diag([1.0, complex(op.operand)])


def _op_from_2x2(u: np.ndarray, q: int) -> Optional[GateOp]:
    """Re-emit a composed 2x2 as the cheapest op kind: None for identity
    (caller handles the phase), a diagonal op when the off-diagonals
    vanish (stays poolable downstream), else one dense u3 matrix op."""
    if abs(u[0, 1]) <= _ATOL and abs(u[1, 0]) <= _ATOL:
        d = np.array([u[0, 0], u[1, 1]], dtype=np.complex128)
        return GateOp("diagonal", (q,), operand=d)
    return GateOp("matrix", (q,), operand=np.asarray(u, dtype=np.complex128))


def _merge1q(ops: List[GateOp], stats: dict,
             phase_cell: List[complex]) -> List[GateOp]:
    """Compose maximal per-qubit runs of uncontrolled 1q ops into one op,
    emitted at the LAST member's position (ops between run members never
    touch the run qubit, so the move commutes)."""
    runs: dict = {}                 # qubit -> [indices of open run]
    replace: dict = {}              # last index -> composed GateOp | None
    drop = set()
    mats = [None] * len(ops)

    def close(q):
        run = runs.pop(q, None)
        if run is None or len(run) < 2:
            return
        u = _ID2
        for i in run:
            u = mats[i] @ u
        c = complex(u[0, 0])
        if (abs(u[0, 1]) <= _ATOL and abs(u[1, 0]) <= _ATOL
                and abs(u[1, 1] - c) <= _ATOL and abs(abs(c) - 1.0) <= _ATOL):
            phase_cell[0] *= c
            newop = None
            removed = len(run)
        else:
            newop = _op_from_2x2(u, q)
            removed = len(run) - 1
        for i in run[:-1]:
            drop.add(i)
        replace[run[-1]] = newop
        if newop is None:
            drop.add(run[-1])
        stats["merge1q"] += removed

    for i, op in enumerate(ops):
        u = _u2_of(op)
        if u is not None:
            q = op.targets[0]
            mats[i] = u
            runs.setdefault(q, []).append(i)
            continue
        for q in sorted(_all_qubits(op)):
            close(q)
        if op.kind not in _STATIC_KINDS and not _all_qubits(op):
            for q in sorted(runs):       # unknown claim: close everything
                close(q)
    for q in sorted(runs):
        close(q)

    out: List[GateOp] = []
    for i, op in enumerate(ops):
        if i in drop and i not in replace:
            continue
        if i in replace:
            if replace[i] is not None:
                out.append(replace[i])
            continue
        out.append(op)
    return out


# ---------------------------------------------------------------------------
# dense composition (shared by pass 4, the tests, and the goldens)
# ---------------------------------------------------------------------------


def dense_unitary(ops: Sequence[GateOp], qubits: Sequence[int]) -> np.ndarray:
    """The exact 2^k x 2^k unitary of an op sequence whose support lies
    inside `qubits` (little-endian: matrix bit j <-> qubits[j], the
    tests/oracle.py convention), accumulated in complex128."""
    qubits = tuple(int(q) for q in qubits)
    k = len(qubits)
    idx = {q: j for j, q in enumerate(qubits)}
    u = np.eye(1 << k, dtype=np.complex128)
    for op in ops:
        u = _embed(op, idx, k) @ u
    return u


def _embed(op: GateOp, idx: dict, k: int) -> np.ndarray:
    dim = 1 << k
    if not _static(op) or not _concrete(op):
        raise ValueError(f"dense_unitary: cannot embed op kind "
                         f"{op.kind!r} (controls={op.controls})")
    controls = tuple(idx[c] for c in op.controls)
    cstates = op.cstates if op.cstates else (1,) * len(op.controls)

    def ctrl_ok(i):
        return all(((i >> c) & 1) == s for c, s in zip(controls, cstates))

    if op.kind == "matrix":
        m = np.asarray(op.operand, dtype=np.complex128)
        tbits = [idx[t] for t in op.targets]
        out = np.zeros((dim, dim), dtype=np.complex128)
        for col in range(dim):
            if not ctrl_ok(col):
                out[col, col] = 1.0
                continue
            a = 0
            for bit, t in enumerate(tbits):
                a |= ((col >> t) & 1) << bit
            rest = col
            for t in tbits:
                rest &= ~(1 << t)
            for ap in range(1 << len(tbits)):
                row = rest
                for bit, t in enumerate(tbits):
                    if (ap >> bit) & 1:
                        row |= 1 << t
                out[row, col] = m[ap, a]
        return out

    vals = np.ones(dim, dtype=np.complex128)
    if op.kind == "diagonal":
        d = np.asarray(op.operand, dtype=np.complex128).reshape(-1)
        tbits = [idx[t] for t in op.targets]
        for i in range(dim):
            if not ctrl_ok(i):
                continue
            a = 0
            for bit, t in enumerate(tbits):
                a |= ((i >> t) & 1) << bit
            vals[i] = d[a]
    elif op.kind == "parity":
        # exp(-i theta/2 Z..Z): factor exp(-i theta/2 * (-1)^parity)
        # (apply.apply_parity_phase, ref statevec_multiRotateZ)
        half = float(op.operand) / 2.0
        tbits = [idx[t] for t in op.targets]
        for i in range(dim):
            ones = sum((i >> t) & 1 for t in tbits) & 1
            vals[i] = np.exp(-1j * half * (1.0 - 2.0 * ones))
    else:                                        # allones (uncontrolled)
        term = complex(op.operand)
        tbits = [idx[t] for t in op.targets]
        for i in range(dim):
            if all((i >> t) & 1 for t in tbits):
                vals[i] = term
    return np.diag(vals)


# ---------------------------------------------------------------------------
# pass 4: 2q KAK resynthesis
# ---------------------------------------------------------------------------


def _stream_cost(ops: Sequence[GateOp], n: int) -> Tuple[int, int]:
    """(full-state passes, op count) under the banded engine's own cost
    model — the acceptance metric for resynthesis."""
    items = F.plan(list(ops), n)
    return (F.plan_stats(items)["full_state_passes"], len(ops))


def _try_kak(items: List[GateOp], qubits: frozenset, n: int,
             stats: dict, phase_cell: List[complex]) -> Optional[List[GateOp]]:
    if len(qubits) != 2 or len(items) < 2:
        return None
    if sum(1 for op in items if len(_all_qubits(op)) == 2) < 2:
        return None
    qa, qb = sorted(qubits)
    try:
        u4 = dense_unitary(items, (qa, qb))
        seq = K.kak_gate_sequence(u4, qa, qb)
    except Exception:
        return None
    new_ops: List[GateOp] = []
    local_phase = 1.0
    for kind, where, what in seq:
        if kind == "1q":
            u = np.asarray(what, dtype=np.complex128)
            c = complex(u[0, 0])
            if (abs(u[0, 1]) <= _ATOL and abs(u[1, 0]) <= _ATOL
                    and abs(u[1, 1] - c) <= _ATOL
                    and abs(abs(c) - 1.0) <= _ATOL):
                local_phase *= c
                continue
            new_ops.append(_op_from_2x2(u, where))
        else:                                    # ("parity", (qa, qb), ang)
            new_ops.append(GateOp("parity", tuple(where),
                                  operand=float(what)))
    # kak_gate_sequence emits raw conjugation layers (H / S.H pairs
    # bracketing each interaction core); clean them up locally before
    # pricing, with a scratch stats sink so the report only attributes
    # the net resynthesis
    scratch = {"cancel": 0, "identity": 0, "global_phase": 0, "fold": 0,
               "merge1q": 0, "resynth2q": 0, "cancel3q": 0}
    ph = [1.0 + 0.0j]
    for _ in range(4):
        before = len(new_ops)
        new_ops = _peephole(new_ops, False, scratch, ph)
        if len(new_ops) == before:
            break
    new_ops = _merge1q(new_ops, scratch, ph)
    new_ops = _peephole(new_ops, False, scratch, ph)
    local_phase *= ph[0]
    if abs(local_phase - 1.0) > _ATOL:
        # keep the phase local so the rewrite is exactly unitary-equal
        new_ops.append(GateOp("diagonal", (qa,), operand=np.array(
            [local_phase, local_phase], dtype=np.complex128)))
    try:
        err = np.max(np.abs(dense_unitary(new_ops, (qa, qb)) - u4))
    except Exception:
        return None
    if err > 1e-9:
        return None
    # candidate B: the run as ONE dense 2q op — a diagonal table when the
    # composition is diagonal (poolable downstream: a cp chain becomes
    # one diag item), else a 4x4 matrix (a 3-cx swap becomes one band op)
    if np.allclose(u4, np.diag(np.diag(u4)), atol=_ATOL):
        dense_ops = [GateOp("diagonal", (qa, qb),
                            operand=np.diag(u4).astype(np.complex128))]
    else:
        dense_ops = [GateOp("matrix", (qa, qb), operand=u4)]
    old_cost = _stream_cost(items, n)
    best, best_cost = None, old_cost
    for cand in (new_ops, dense_ops):
        cost = _stream_cost(cand, n)
        if cost < best_cost:
            best, best_cost = cand, cost
    if best is not None:
        stats["resynth2q"] += 1
        return best
    return None


def _drop_identity_windows(items: List[GateOp], qubits, stats: dict,
                           phase_cell: List[complex]):
    """Erase every contiguous window of `items` (all supported inside
    `qubits`, <= 3 of them) whose dense composition is a global phase
    c*I — the block-level cancellations pairwise peephole can't see: a
    toffoli pair in its 15-op Clifford+T form, a conjugation sandwich
    closing over its own inverse, an uncompute block. Prefix-product
    scan: with P_j = U_j ... U_1, a window (i, j] composes to c*I iff
    P_i^dag P_j ~ c*I; greedy longest-window-first, re-scanned until
    dry. Exact-mode streams never reach here (fp products)."""
    qubits = tuple(sorted(qubits))
    k = len(qubits)
    idx = {q: j for j, q in enumerate(qubits)}
    dim = 1 << k
    changed = False
    while len(items) >= 2:
        pre = [np.eye(dim, dtype=np.complex128)]
        for op in items:
            pre.append(_embed(op, idx, k) @ pre[-1])
        hit = None
        for width in range(len(items), 1, -1):
            for i in range(len(items) - width + 1):
                m = pre[i].conj().T @ pre[i + width]
                c = np.trace(m) / dim
                if abs(abs(c) - 1.0) < 1e-9 and \
                        np.max(np.abs(m - c * np.eye(dim))) < 1e-9:
                    hit = (i, width, c)
                    break
            if hit is not None:
                break
        if hit is None:
            break
        i, width, c = hit
        items = items[:i] + items[i + width:]
        phase_cell[0] *= c
        stats["cancel3q"] += 1
        changed = True
    return items, changed


def _cancel_windows3(ops: List[GateOp], n: int, stats: dict,
                     phase_cell: List[complex]) -> List[GateOp]:
    """Pass 5: identity-window elimination over <= 3-qubit
    neighborhoods. Same concurrent-run collection discipline as
    _resynth2q but with a 3-qubit support budget; each run is scanned
    by _drop_identity_windows, and a rewritten run is accepted only
    when it prices no worse under the banded cost model (dropping ops
    can never add sweeps in practice — the guard is against a greedy
    band packer pathologically preferring the longer stream)."""
    out: List[GateOp] = []
    open_runs: List[dict] = []

    def flush(run):
        open_runs.remove(run)
        items = run["items"]
        if len(items) < 2:
            out.extend(items)
            return
        scratch = dict(stats)
        ph = [1.0 + 0.0j]
        new, changed = _drop_identity_windows(
            items, run["qubits"], scratch, ph)
        if not changed or _stream_cost(new, n) > _stream_cost(items, n):
            out.extend(items)
            return
        stats["cancel3q"] = scratch["cancel3q"]
        phase_cell[0] *= ph[0]
        out.extend(new)

    for op in ops:
        support = _all_qubits(op)
        eligible = _static(op) and _concrete(op) and 0 < len(support) <= 3
        touching = [r for r in open_runs if r["qubits"] & support]
        if not eligible:
            for r in list(touching):
                flush(r)
            if op.kind not in _STATIC_KINDS and not support:
                for r in list(open_runs):        # unknown claim
                    flush(r)
            out.append(op)
            continue
        union = set(support)
        for r in touching:
            union |= r["qubits"]
        if touching and len(union) <= 3:
            first = touching[0]
            for r in touching[1:]:               # merge overlapping runs
                first["items"].extend(r["items"])
                first["qubits"] |= r["qubits"]
                open_runs.remove(r)
            first["qubits"] = union
            first["items"].append(op)
        else:
            for r in list(touching):
                flush(r)
            open_runs.append({"qubits": set(support), "items": [op]})
    for r in list(open_runs):
        flush(r)
    return out


def _resynth2q(ops: List[GateOp], n: int, stats: dict,
               phase_cell: List[complex]) -> List[GateOp]:
    """Collect maximal runs whose support fits in one qubit pair (runs on
    disjoint pairs stay concurrently open; ops disjoint from every open
    run pass straight through) and KAK-resynthesize each run when the
    rewrite prices cheaper."""
    out: List[GateOp] = []
    open_runs: List[dict] = []      # {qubits: set, items: [GateOp]}

    def flush(run):
        open_runs.remove(run)
        new = _try_kak(run["items"], frozenset(run["qubits"]), n, stats,
                       phase_cell)
        out.extend(new if new is not None else run["items"])

    for op in ops:
        support = _all_qubits(op)
        eligible = _static(op) and _concrete(op) and 0 < len(support) <= 2
        touching = [r for r in open_runs if r["qubits"] & support]
        if not eligible:
            for r in list(touching):
                flush(r)
            if op.kind not in _STATIC_KINDS and not support:
                for r in list(open_runs):        # unknown claim
                    flush(r)
            out.append(op)
            continue
        union = set(support)
        for r in touching:
            union |= r["qubits"]
        if touching and len(union) <= 2:
            if len(touching) == 2:               # merge two 1q partials
                touching[0]["items"].extend(touching[1]["items"])
                touching[0]["qubits"] |= touching[1]["qubits"]
                open_runs.remove(touching[1])
            run = touching[0]
            run["qubits"] = union
            run["items"].append(op)
        else:
            for r in list(touching):
                flush(r)
            open_runs.append({"qubits": set(support), "items": [op]})
    for r in list(open_runs):
        flush(r)
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _transpile_stretch(ops: List[GateOp], n: int, exact_only: bool,
                       stats: dict) -> List[GateOp]:
    cur = list(ops)
    phase = [1.0 + 0.0j]
    for _ in range(_FIXPOINT_ITERS):
        before = len(cur)
        snap = (stats["cancel"], stats["fold"], stats["identity"])
        cur = _peephole(cur, exact_only, stats, phase)
        if len(cur) == before and snap == (stats["cancel"], stats["fold"],
                                           stats["identity"]):
            break
    if not exact_only:
        cur = _merge1q(cur, stats, phase)
        cur = _resynth2q(cur, n, stats, phase)
        cur = _cancel_windows3(cur, n, stats, phase)
        for _ in range(_FIXPOINT_ITERS):
            before = len(cur)
            snap = (stats["cancel"], stats["fold"], stats["identity"])
            cur = _peephole(cur, exact_only, stats, phase)
            if len(cur) == before and snap == (stats["cancel"],
                                               stats["fold"],
                                               stats["identity"]):
                break
        cur = _merge1q(cur, stats, phase)
    if abs(phase[0] - 1.0) > _ATOL:
        # exact mode never accumulates phase (!= 1 products are rejected)
        stats["global_phase"] += 1
        cur.append(GateOp("diagonal", (0,), operand=np.array(
            [phase[0], phase[0]], dtype=np.complex128)))
    return cur


def transpile_ops(ops: Sequence[GateOp], num_qubits: int, *,
                  exact_only: bool = False) -> Tuple[List[GateOp], dict]:
    """Rewrite an op stream; returns (new_ops, report). Dynamic/noise ops
    are barriers: each measurement-free stretch is rewritten
    independently, barriers keep their positions."""
    ops = list(ops)
    stats = {"cancel": 0, "identity": 0, "global_phase": 0, "fold": 0,
             "merge1q": 0, "resynth2q": 0, "cancel3q": 0}
    out: List[GateOp] = []
    stretch: List[GateOp] = []
    nstretches = 0
    for op in ops:
        if _static(op):
            stretch.append(op)
            continue
        if stretch:
            nstretches += 1
            out.extend(_transpile_stretch(stretch, num_qubits, exact_only,
                                          stats))
            stretch = []
        out.append(op)
    if stretch:
        nstretches += 1
        out.extend(_transpile_stretch(stretch, num_qubits, exact_only,
                                      stats))
    report = {
        "ops_in": len(ops),
        "ops_out": len(out),
        "stretches": nstretches,
        "exact_only": bool(exact_only),
        "changed": any(v > 0 for v in stats.values()),
        "passes": dict(stats),
    }
    return out, report


def transpile(circuit: Circuit, *,
              exact_only: bool = False) -> Tuple[Circuit, dict]:
    """Rewrite a Circuit into an equivalent cheaper one. The result is a
    fresh Circuit over the same qubit count; the input is not mutated."""
    new_ops, report = transpile_ops(circuit.ops, circuit.num_qubits,
                                    exact_only=exact_only)
    if not report["changed"]:
        return circuit, report
    out = Circuit(circuit.num_qubits)
    out.ops = list(new_ops)
    out._transpile_report = report
    return out, report


def transpile_cached(circuit: Circuit, *,
                     exact_only: bool = False) -> Tuple[Circuit, dict]:
    """transpile() memoized per circuit (Circuit._add clears the memo on
    mutation, which is exactly the invalidation we need). The memo is
    NOT Circuit._compiled: planning-only surfaces (explain, plan_stats)
    transpile, and they contract to leave the compiled-program cache
    empty."""
    key = ("transpiled", bool(exact_only))
    cache = circuit._transpiled
    hit = cache.get(key)
    if hit is None:
        hit = transpile(circuit, exact_only=exact_only)
        cache[key] = hit
    return hit


def stream_cost(circuit: Circuit) -> Tuple[Optional[int], int]:
    """(banded full-state passes | None for noise circuits, op count) —
    the comparison key maybe_transpile/'auto' routes on."""
    ops = list(circuit.ops)
    if any(op.kind == "superop" for op in ops):
        return (None, len(ops))
    flat = CC.flatten_ops(ops, circuit.num_qubits, False)
    try:
        passes = F.plan_stats(F.plan(flat, circuit.num_qubits))[
            "full_state_passes"]
    except Exception:
        return (None, len(ops))
    return (passes, len(flat))


def maybe_transpile(circuit: Circuit) -> Tuple[Circuit, Optional[dict]]:
    """Route a circuit through the transpiler per QUEST_TRANSPILE:
    '0' never rewrites; '1' takes the rewritten stream whenever it
    changed; 'auto' takes it only when STRICTLY cheaper (banded
    full-state passes, then op count) — the incumbent raw stream wins
    ties, mirroring the planner's discipline."""
    knob = knob_value("QUEST_TRANSPILE")
    if knob == "0":
        return circuit, None
    tc, report = transpile_cached(circuit)
    if not report["changed"]:
        return circuit, report
    if knob == "1":
        return tc, report
    raw_p, raw_ops = stream_cost(circuit)
    new_p, new_ops = stream_cost(tc)
    if raw_p is not None and new_p is not None:
        take = (new_p, new_ops) < (raw_p, raw_ops)
    else:
        take = new_ops < raw_ops
    return (tc, report) if take else (circuit, report)
