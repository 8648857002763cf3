"""The segment kernel's plain version and packing against the reference.

For every stage kind S1-S7 of the RCS path (b0, b1, scb, sc, phase,
parity, multiphase), with and without predicates, the port's
segment_sweep on CPU tensors (its plain PyTorch version) must match
quest_tpu.ops.pallas_band.compile_segment run in the Pallas interpreter,
on the same seeded numpy state and operands, within 2e-5 x max|amp| (the
f32 tolerance of tests/conftest.py `tol`).

The CUDA kernel itself runs only on the card. Its packing — geometry,
block-to-row mapping, descriptor table, operand offsets and strides,
predicate decoding — is checked here through `emulate_kernel`, a numpy
model that reads exactly what the kernel reads (Segment.desc, .ops,
.scat_mask, .free_mask) and follows its per-tile arithmetic. Two stage
bodies have a thread-level model besides: S8's hoisted index
(`hoisted_diag`) and S7's angle factored into lane and row parts
(`factored_multiphase`, equal bit for bit to the per-element f32 sums
of the kernel before it). The test marked `cuda` runs the kernel itself
against the plain version on a card.
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

from quest_tpu.ops import pallas_band as PB

from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import segment as S
import quest_tpu_torch.circuit as TC

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

TOL = 2e-5
LANE_BITS = 7


def emulate_kernel(planes: np.ndarray, seg: S.Segment,
                   sel: np.ndarray = None, *,
                   sequential: bool = False) -> np.ndarray:
    """numpy model of csrc/segment.cu on (2, 2^n) planes, or on a batch
    (B, 2, 2^n) launched as grid (tiles, B): each state's planes at
    offset state * 2 * 2^n of the flat buffer. Per block, the tile's
    global rows from blockIdx.x (free bits, Segment.free_mask) +
    fixed_rows + inner rows + scattered bits, over the launch's
    Segment.tiles tiles a state (a tile a phase-only segment skips keeps
    its input); a run of phase and parity stages (F_RUN in its first
    descriptor) as diag_run applies it, each element's stage bits from
    the run's lane and row words (run_words), or in the angle form from
    its summed turns (angle_turns); every other descriptor
    applied to the tile as the kernel does
    (matrix stages as a (fibers x D) product at tile position F_POS with
    operand strides F_SI/F_SJ, predicates as lane/row masks, phase rows
    decoded from the f32 operand; Kraus pairs as a 4x4 butterfly on the
    tile bits F_POS (op) and F_POS2 (sliced) with (2, 4, 2, 2) cores;
    diagonals as a table lookup by the target bits of each element's
    global index; a BatchSelStage as a 2x2 butterfly on tile bit F_POS
    with row (F_SLOT * B + state) * 8 of the flat selection table `sel`
    (slots, B, 8)). Returns new planes of the input's shape.
    `sequential`: the model before runs and the skip — every tile of the
    geometry, each phase and parity stage alone from its predicate."""
    n = seg.n
    flat = planes.reshape(-1).astype(np.float64).copy()
    batch = flat.size // (2 << n)
    table = None if sel is None else np.asarray(sel, np.float64).reshape(-1)
    for state in range(batch):
        view = flat[state * (2 << n):(state + 1) * (2 << n)]
        view[:] = _emulate_state(view.reshape(2, -1), seg, table, batch,
                                 state, sequential).reshape(-1)
    return flat.reshape(planes.shape)


def rmask(lo, hi):
    """A row mask from its f32 halves split at bit 15 (csrc row_mask)."""
    return int(lo) | (int(hi) << 15)


def _parity_bits(x):
    out = np.zeros_like(x)
    for b in range(32):
        out ^= (x >> b) & 1
    return out


def run_bits(x, descs, ops, row: bool) -> np.ndarray:
    """csrc run_bits: uint64 word of each x (lanes, or with `row` tile
    rows' global ids) under the run's descriptors `descs` (k rows): bit s
    is, for a phase stage, whether x matches its lane (row) predicate; for
    a parity stage, the parity of x under its lane (row) mask."""
    x = np.asarray(x, np.int64)
    out = np.zeros(x.shape, np.uint64)
    for s, d in enumerate(descs):
        g = ops[int(d[S.F_OP_OFF]):]
        if int(d[S.F_KIND]) == S.K_PHASE:
            m, w = ((rmask(g[4], g[5]), rmask(g[6], g[7])) if row
                    else (int(g[2]), int(g[3])))
            on = (x & m) == w
        else:
            m = rmask(g[3], g[4]) if row else int(g[2])
            on = _parity_bits(x & m) == 1
        out |= on.astype(np.uint64) << np.uint64(s)
    return out


def run_words(descs, ops, lanes, rows):
    """(par, L, R) of a run as diag_run builds them: bit s of par is set
    for a parity stage; L and R are run_bits of the lanes and tile rows."""
    par = sum(1 << s for s, d in enumerate(descs)
              if int(d[S.F_KIND]) == S.K_PARITY)
    return (np.uint64(par), run_bits(lanes, descs, ops, False),
            run_bits(rows, descs, ops, True))


def run_element_bits(par, lw, rw):
    """Each element's stage bits from its lane word and row word: S5
    applies where bit s of L & R is set, S6 takes the minus sign of its
    sine where bit s of L ^ R is (csrc run_rows)."""
    return (par & (lw ^ rw)) | (~par & lw & rw)


def _stage_masks(d, ops):
    """(lane mask, lane want, row mask, row want) of a phase or parity
    descriptor's operand, wants -1 for parity (csrc RunStages)."""
    g = ops[int(d[S.F_OP_OFF]):]
    if int(d[S.F_KIND]) == S.K_PHASE:
        return int(g[2]), int(g[3]), rmask(g[4], g[5]), rmask(g[6], g[7])
    return int(g[2]), -1, rmask(g[3], g[4]), -1


def _stage_bits(x, m, w):
    """Each x's bit under mask m and want w (w < 0: parity)."""
    x = np.asarray(x, np.int64)
    return (_parity_bits(x & m) if w < 0 else ((x & m) == w)).astype(np.int64)


def angle_turns(descs, raw, lanes, rows):
    """csrc angle_run's turns (rows, lanes), uint64 below 2^32: the lane
    part (stages with no row mask), the row part (stages with no lane
    mask, and every T_off of the rest) and the mixed stages' bits, summed
    as the kernel splits them."""
    head = descs[0]
    tab = raw.view(np.int32)[int(head[S.F_TARGETS]):][:2 * len(descs)]
    tab = tab.astype(np.int64).reshape(-1, 2)
    lanes, rows = np.asarray(lanes, np.int64), np.asarray(rows, np.int64)
    lsum, rsum = np.zeros(lanes.shape, np.int64), np.zeros(rows.shape, np.int64)
    mixed = np.zeros((len(rows), len(lanes)), np.int64)
    for d, (o, dd) in zip(descs, tab):
        lm, lw, rm, rw = _stage_masks(d, raw)
        lb, rb = _stage_bits(lanes, lm, lw), _stage_bits(rows, rm, rw)
        on = (lb[None, :] ^ rb[:, None]) if lw < 0 else (lb[None, :]
                                                         & rb[:, None])
        if rm == 0:
            lsum += o + on[0] * dd
        elif lm == 0:
            rsum += o + on[:, 0] * dd
        else:
            rsum += o
            mixed += on * dd
    return (lsum[None, :] + rsum[:, None] + mixed) % (1 << 32)


def direct_turns(descs, raw, lanes, rows):
    """The same turns summed stage by stage for every element: T_off + bit
    x D."""
    head = descs[0]
    tab = raw.view(np.int32)[int(head[S.F_TARGETS]):][:2 * len(descs)]
    tot = np.zeros((len(rows), len(lanes)), np.int64)
    for d, (o, dd) in zip(descs, tab.astype(np.int64).reshape(-1, 2)):
        lm, lw, rm, rw = _stage_masks(d, raw)
        lb, rb = _stage_bits(lanes, lm, lw), _stage_bits(rows, rm, rw)
        on = (lb[None, :] ^ rb[:, None]) if lw < 0 else (lb[None, :]
                                                         & rb[:, None])
        tot += o + on * dd
    return tot % (1 << 32)


def _emulate_run(x, descs, ops, lane, row_ids, e, raw):
    """A run on one tile's elements x, as diag_run applies it: the run's
    stages in order, each element's bits from the run's words; or, for a
    run in the angle form (F_FORMS bit 0 of its head), each element times
    e^{i pi T / 2^31} of its turns T (angle_turns; T as int32, then f32,
    as the kernel converts it)."""
    if int(descs[0][S.F_FORMS]) & 1:
        t = angle_turns(descs, raw, np.arange(128), row_ids)
        t = t.astype(np.uint32).view(np.int32).astype(np.float32)
        ang = (t * np.float32(2.0 ** -31)).astype(np.float64) * np.pi
        return x * np.exp(1j * ang).reshape(-1)
    par, lw, rw = run_words(descs, ops, np.arange(128), row_ids)
    on = run_element_bits(par, lw[lane], rw[e >> 7])
    for s, d in enumerate(descs):
        g = ops[int(d[S.F_OP_OFF]):]
        bit = ((on >> np.uint64(s)) & np.uint64(1)).astype(np.int64)
        if int(d[S.F_KIND]) == S.K_PHASE:
            x = np.where(bit == 1, x * (g[0] + 1j * g[1]), x)
        else:
            x = x * (g[0] - 1j * g[1] * (1 - 2 * bit))
    return x


def tile_base(seg, blk, sequential=False):
    """Global row bits of tile `blk` of a launch of `seg` (csrc
    tile_base | fixed_rows): the index spread over the free bits it walks
    (every free bit of the geometry when `sequential`), OR'd with the
    fixed rows."""
    free_mask, fixed = seg.free_mask, seg.fixed_rows
    if sequential:
        free_mask, fixed = free_mask | seg.fixed_mask, 0
    free = [b for b in range(32) if (free_mask >> b) & 1]
    return fixed | sum(((blk >> k) & 1) << bit for k, bit in enumerate(free))


def launch_tiles(seg, sequential=False):
    """tile_base of every tile one launch of `seg` runs per state."""
    tiles = seg.geometry.blocks if sequential else seg.tiles
    return [tile_base(seg, blk, sequential) for blk in range(tiles)]


def _emulate_state(planes, seg, table, batch, state_idx, sequential=False):
    """emulate_kernel on the blocks of state `state_idx` of the launch."""
    n, geo = seg.n, seg.geometry
    desc = seg.desc.cpu().numpy()
    raw = seg.ops.cpu().numpy()
    with np.errstate(invalid="ignore"):    # angle tables are int32 bits
        ops = raw.astype(np.float64)
    state = planes.reshape(2, -1).astype(np.float64).copy()
    tb = geo.tile_bits
    rows = 1 << (tb - 7)
    scat = [b for b in range(32) if (seg.scat_mask >> b) & 1]
    r = np.arange(rows)
    local = r & ((1 << geo.inner_bits) - 1)
    for k, bit in enumerate(scat):
        local = local | (((r >> (geo.inner_bits + k)) & 1) << bit)
    e = np.arange(1 << tb)
    lane = e & 127
    parity = _parity_bits

    for base in launch_tiles(seg, sequential):
        row_id = base | local
        row = row_id[e >> 7]
        idx = (row_id[:, None] * 128 + np.arange(128)[None, :]).reshape(-1)
        x = state[0, idx] + 1j * state[1, idx]
        si = 0
        while si < len(desc):
            d = desc[si]
            si += 1
            kind, off = int(d[S.F_KIND]), int(d[S.F_OP_OFF])
            if kind in (S.K_PHASE, S.K_PARITY) and not sequential:
                k = int(d[S.F_RUN])
                x = _emulate_run(x, desc[si - 1:si - 1 + k], ops, lane,
                                 row_id, e, raw)
                si += k - 1
                continue
            if kind == S.K_MAT:
                dim, p = int(d[S.F_DIM]), int(d[S.F_POS])
                w = dim.bit_length() - 1
                i = np.arange(dim)
                f = np.arange(1 << (tb - w))
                fbase = ((f >> p) << (p + w)) | (f & ((1 << p) - 1))
                addr = fbase[:, None] + (i[None, :] << p)
                new = x.copy()
                tier = int(d[S.F_TIER])
                if tier:
                    new[addr] = _emulate_tier_mat(x[addr], d, raw, off, tier)
                else:
                    g = _highest_operator(d, ops, off)
                    new[addr] = x[addr] @ g.T
                if d[S.F_MASKED]:
                    ok = (((lane & int(d[S.F_LANE_MASK])) == d[S.F_LANE_WANT])
                          & ((row & int(d[S.F_ROW_MASK])) == d[S.F_ROW_WANT]))
                    new = np.where(ok, new, x)
                x = new
                continue
            if kind == S.K_PAIR:
                pa, pb = int(d[S.F_POS]), int(d[S.F_POS2])
                core = ops[off:off + 16] + (
                    0 if d[S.F_REAL] else 1j * ops[off + 16:off + 32])
                core = core.reshape(4, 2, 2)
                lo, hi = min(pa, pb), max(pa, pb)
                f = np.arange(1 << (tb - 2))
                base = ((f >> lo) << (lo + 1)) | (f & ((1 << lo) - 1))
                base = ((base >> hi) << (hi + 1)) | (base & ((1 << hi) - 1))

                def at(sl, o):
                    return base | (sl << pb) | (o << pa)
                new = x.copy()
                for r in range(2):
                    for o in range(2):
                        new[at(r, o)] = sum(core[r * 2 + c, o, a] * x[at(c, a)]
                                            for c in range(2) for a in range(2))
                if d[S.F_MASKED]:
                    ok = (((lane & int(d[S.F_LANE_MASK])) == d[S.F_LANE_WANT])
                          & ((row & int(d[S.F_ROW_MASK])) == d[S.F_ROW_WANT]))
                    new = np.where(ok, new, x)
                x = new
                continue
            if kind == S.K_DIAGVEC:
                k = int(d[S.F_DIM])
                tab = ops[off:off + (1 << k)] + 1j * ops[off + (1 << k):
                                                         off + (2 << k)]
                entry = diag_entries(d, lane, row)
                ok = (((lane & int(d[S.F_LANE_MASK])) == d[S.F_LANE_WANT])
                      & ((row & int(d[S.F_ROW_MASK])) == d[S.F_ROW_WANT]))
                x = np.where(ok, x * tab[entry], x)
                continue
            if kind == S.K_BATCHSEL:
                p = int(d[S.F_POS])
                base = (int(d[S.F_SLOT]) * batch + state_idx) * S.SEL_WORDS
                v = table[base:base + S.SEL_WORDS]
                g = v[0::2] + 1j * v[1::2]          # g00, g01, g10, g11
                f = np.arange(1 << (tb - 1))
                e0 = ((f >> p) << (p + 1)) | (f & ((1 << p) - 1))
                e1 = e0 | (1 << p)
                new = x.copy()
                new[e0] = g[0] * x[e0] + g[1] * x[e1]
                new[e1] = g[2] * x[e0] + g[3] * x[e1]
                x = new
                continue
            g = ops[off:]
            if kind == S.K_PHASE:
                ok = (((lane & int(g[2])) == int(g[3]))
                      & ((row & rmask(g[4], g[5])) == rmask(g[6], g[7])))
                x = np.where(ok, x * (g[0] + 1j * g[1]), x)
            elif kind == S.K_PARITY:
                par = parity(lane & int(g[2])) ^ parity(row & rmask(g[3], g[4]))
                x = x * (g[0] - 1j * g[1] * (1 - 2 * par))
            else:
                tot = np.zeros(len(x))
                for rr in range(int(d[S.F_DIM])):
                    ang, lm = g[8 * rr], int(g[8 * rr + 1])
                    rm = rmask(g[8 * rr + 2], g[8 * rr + 3])
                    if (int(d[S.F_FORMS]) >> rr) & 1:
                        par = parity(lane & lm) ^ parity(row & rm)
                        tot += ang * (1 - 2 * par)
                    else:
                        tot += np.where(((lane & lm) == lm)
                                        & ((row & rm) == rm), ang, 0.0)
                x = x * np.exp(1j * tot)
        state[0, idx], state[1, idx] = x.real, x.imag
    return state


def _highest_operator(d, ops, off):
    """G (dim, dim) complex of a HIGHEST matrix stage as the kernel reads
    it: d >= 16 from the slice rows (row j = [Gre[:, j], Gim[:, j]]),
    narrower through the strides F_SI/F_SJ (G[i, j] = op[i*si + j*sj])."""
    dim = int(d[S.F_DIM])
    if dim >= S.SLICED_MIN_DIM:
        rows = ops[off:off + 2 * dim * dim].reshape(dim, 2, dim)
        g = rows[:, 0].T + (0 if d[S.F_REAL] else 1j * rows[:, 1].T)
        return g
    i = np.arange(dim)
    o = off + i[:, None] * int(d[S.F_SI]) + i[None, :] * int(d[S.F_SJ])
    return ops[o] + (0 if d[S.F_REAL] else 1j * ops[o + dim * dim])


def diag_entries(d, lane, row):
    """Table index of each element (lane, tile row id) under a diagonal
    descriptor, as the kernel computes it: bit j is the element's global
    bit targets[j], read from the lane (q < 7) or from bit q - 7 of the
    row id (int32 arithmetic; the row id of an n-qubit element is below
    2^(n - 7))."""
    lane = np.asarray(lane, np.int32)
    row = np.asarray(row, np.int32)
    entry = np.zeros(np.broadcast(lane, row).shape, dtype=np.int32)
    for j in range(int(d[S.F_DIM])):
        q = (int(d[S.F_TARGETS]) >> (S.TARGET_BITS * j)) & 63
        bit = (lane >> q) & 1 if q < LANE_BITS else (row >> (q - LANE_BITS)) & 1
        entry = entry | (bit << j)
    return entry


def bf16_rne(v: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, round-to-nearest-even, from the bits."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def np_tier_parts(v: np.ndarray, tier: str):
    """(hi, lo) f64 of the f32 values v at a tier, from bit masks and RNE:
    'high' -> (v & 0xFFFF0000, bf16(v - hi)), 'default' -> (bf16(v), 0)."""
    v = np.asarray(v, np.float32)
    if tier == "default":
        return bf16_rne(v).astype(np.float64), np.zeros(v.shape)
    hi = (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return hi.astype(np.float64), bf16_rne(v - hi).astype(np.float64)


def np_tier_dot(x: np.ndarray, g: np.ndarray, tier: str) -> np.ndarray:
    """x @ g (real f32 operands) as the tier's exact bf16 products summed
    in f64."""
    xh, xl = np_tier_parts(x, tier)
    gh, gl = np_tier_parts(g, tier)
    out = xh @ gh
    if tier == "high":
        out = out + xh @ gl + xl @ gh
    return out


TIER_NAMES = {1: "high", 2: "default"}


def tier_operator_parts(raw, off, dim, nparts):
    """(nparts, dim, dim) f32 parts [out i, in j] of a tier stage decoded
    from the kernel's slices: per k-step and part a wgmma B tile, K-major
    8x8 core matrices (output group, input half, output, input), inputs
    and outputs in operand_perm order, two bf16 to a word."""
    w = raw[off:off + dim * dim * nparts // 2].view(np.uint32)
    b = np.stack([w & 0xFFFF, w >> 16], -1).reshape(
        dim // 16, nparts, dim // 8, 2, 8, 8)       # ks p ng kh nr kr
    b = b.transpose(1, 2, 4, 0, 3, 5).reshape(nparts, dim, dim)  # p n k
    perm = S.operand_perm(dim)
    parts = np.empty_like(b)
    parts[:, perm[:, None], perm[None, :]] = b
    return (parts.astype(np.uint32) << 16).view(np.float32)


def _emulate_tier_mat(xf, d, raw, off, tier):
    """A matrix stage at a tier, as the kernel computes it: fibers xf
    (F, dim) complex, rounded from the f32 tile; the operator from the
    buffer — wgmma B tiles (dim >= 16, tier_operator_parts) or f32 planes
    read through the strides (narrower) — and the real-block form of the
    products."""
    name = TIER_NAMES[tier]
    dim = int(d[S.F_DIM])
    if dim >= S.SLICED_MIN_DIM:
        nparts = 4 if name == "high" else 2
        vals = tier_operator_parts(raw, off, dim, nparts)
        vals = vals.astype(np.float64)
        if name == "high":
            gre, gim = (vals[0], vals[1]), (vals[2], vals[3])
        else:
            gre, gim = (vals[0], 0.0), (vals[1], 0.0)

        def dot(x, gparts):
            xh, xl = np_tier_parts(x, name)
            gh, gl = gparts
            out = xh @ gh.T
            if name == "high":
                out = out + xh @ gl.T + xl @ gh.T
            return out
    else:
        i = np.arange(dim)
        o = off + i[:, None] * int(d[S.F_SI]) + i[None, :] * int(d[S.F_SJ])
        f32 = raw.view(np.float32)
        gre, gim = f32[o], f32[o + dim * dim]

        def dot(x, g):
            return np_tier_dot(x, g.T, name)
    xr = xf.real.astype(np.float32)
    xi = xf.imag.astype(np.float32)
    if d[S.F_REAL]:
        return dot(xr, gre) + 1j * dot(xi, gre)
    return ((dot(xr, gre) - dot(xi, gim))
            + 1j * (dot(xi, gre) + dot(xr, gim)))


# ---------------------------------------------------------------------------
# stage cases: (jax stage, port stage, operand) built from one seed
# ---------------------------------------------------------------------------


def _mat(rng, name, kind, dim, real_only=False, lane_preds=(), row_preds=(),
         bit=-1):
    g = (rng.standard_normal((2, dim, dim)) / np.sqrt(dim)).astype(np.float32)
    if real_only:
        g[1] = 0.0
    args = (kind, dim, real_only, tuple(lane_preds), tuple(row_preds), bit)
    return name, PB.MatStage(*args), BP.MatStage(*args), g


def _phase(rng, lm, lw, rm, rw):
    t = np.exp(1j * rng.uniform(0, 2 * np.pi))
    g = np.array([[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15,
                   rw & 0x7FFF, rw >> 15]], np.float32)
    return "phase", PB.PhaseStage(), BP.PhaseStage(), g


def _parity(rng, lm, rm):
    half = rng.uniform(0, 2 * np.pi) / 2
    g = np.array([[np.cos(half), np.sin(half), lm, rm & 0x7FFF, rm >> 15,
                   0, 0, 0]], np.float32)
    return "parity", PB.ParityStage(), BP.ParityStage(), g


def _multiphase(rng, terms):
    rows = [[rng.uniform(-np.pi, np.pi), lm, rm & 0x7FFF, rm >> 15, 0, 0, 0, 0]
            for _, lm, rm in terms]
    forms = tuple(f for f, _, _ in terms)
    return ("multiphase", PB.MultiPhaseStage(forms), BP.MultiPhaseStage(forms),
            np.array(rows, np.float32))


def stage_cases():
    """Single-stage and chained segments at n = 10..12 (row bits 0..4),
    covering each stage kind with and without predicates."""
    rng = np.random.default_rng(20261016)
    single = [
        (12, [_mat(rng, "b0", "b0", 128)]),
        (12, [_mat(rng, "b0_real_preds", "b0", 128, True, ((3, 1),),
                   ((1, 1), (4, 0)))]),
        (12, [_mat(rng, "b1_32", "b1", 32)]),
        (10, [_mat(rng, "b1_8_preds", "b1", 8, False, ((2, 1),), ((0, 0),))]),
        (12, [_mat(rng, "scb_4", "scb", 4, bit=3)]),
        (12, [_mat(rng, "scb_8_real_preds", "scb", 8, True, (), ((0, 1),),
                   bit=2)]),
        (12, [_mat(rng, "sc", "sc", 2, bit=4)]),
        (11, [_mat(rng, "sc_preds", "sc", 2, False, ((6, 0),), ((1, 1),),
                   bit=3)]),
        (12, [_phase(rng, 0b1000001, 0b0000001, 0b10010, 0b10000)]),
        (12, [_phase(rng, 0, 0, 0, 0)]),
        (12, [_parity(rng, 0b0100110, 0b01001)]),
        (12, [_multiphase(rng, [("a", 0b11, 0), ("p", 0b1000000, 0b10100),
                                ("a", 0b100, 0b1), ("p", 0, 0b11000)])]),
    ]
    chain = (12, [_mat(rng, "b0", "b0", 128),
                  _phase(rng, 0b10, 0b10, 0b100, 0b100),
                  _mat(rng, "b1_8", "b1", 8, False, (), ((4, 1),)),
                  _mat(rng, "sc", "sc", 2, bit=4),
                  _parity(rng, 0b11, 0b11001),
                  _mat(rng, "scb_4", "scb", 4, bit=3),
                  _multiphase(rng, [("p", 0b1, 0b1), ("a", 0b10, 0b10000)])])
    cases = [(c[1][0][0], c[0], c[1]) for c in single]
    cases.append(("chain", chain[0], chain[1]))
    return cases


def _state(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 1 << n)).astype(np.float32)


def _port_segment(n, case):
    return S.prepare_segment([c[2] for c in case], [c[3] for c in case], n,
                             "cpu")


@pytest.mark.parametrize("case", stage_cases(), ids=lambda c: c[0])
def test_plain_version_matches_interpreted_reference(case):
    _, n, stages = case
    planes = _state(n)
    want = np.asarray(PB.compile_segment([c[1] for c in stages], n,
                                         interpret=True)(
        jnp.asarray(planes).reshape(2, -1, PB.LANES), [c[3] for c in stages]))
    seg = _port_segment(n, stages)
    amps = torch.from_numpy(planes.copy())
    out = S.segment_sweep(amps, seg)
    assert out is amps                      # in place, like the kernel
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.numpy(), want.reshape(2, -1),
                               atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("case", stage_cases(), ids=lambda c: c[0])
def test_kernel_packing_matches_plain_version(case):
    _, n, stages = case
    planes = _state(n, seed=11)
    seg = _port_segment(n, stages)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n).numpy()
    got = emulate_kernel(planes, seg)
    np.testing.assert_allclose(got, want.reshape(2, -1),
                               atol=TOL * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("n,depth", [(14, 2), (21, 1), (22, 1)])
def test_kernel_packing_on_hopper_plans(n, depth):
    """Every swept segment the engine plans for RCS circuits (b1 d=128,
    scb d=128 with its transposed operand, sc on the width-1 top band),
    through the kernel model and the plain version."""
    c = TC.random_circuit(n, depth, seed=7)
    prog = c.compiled_fused(n, device="cpu")
    planes = _state(n, seed=3)
    for seg in prog.segments:
        want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                         seg.operands, n).numpy()
        got = emulate_kernel(planes, seg)
        np.testing.assert_allclose(got, want.reshape(2, -1),
                                   atol=TOL * float(np.abs(want).max()),
                                   rtol=0)
        planes = want.reshape(2, -1)


def test_row_masks_above_bit_15():
    """Row predicates split at bit 15 (_row_halves): phase, parity and
    multiphase masks on row bit 15 (qubit 22) against a direct numpy
    oracle of the global index bits."""
    n = 23
    rng = np.random.default_rng(5)
    rm = (1 << 15) | (1 << 3) | 1
    stages = [_phase(rng, 0b1, 0b1, rm, (1 << 15) | 1),
              _parity(rng, 0b10, rm),
              _multiphase(rng, [("a", 0, 1 << 15), ("p", 0b100, 1 << 3)])]
    seg = _port_segment(n, stages)
    planes = _state(n, seed=9)
    got = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                    seg.operands, n).numpy().reshape(2, -1)
    k = np.arange(1 << n)
    lane, row = k & 127, k >> 7
    x = planes[0].astype(np.complex128) + 1j * planes[1]
    g0, g1, g2 = (a for *_, a in stages)
    hit = ((lane & 1) == 1) & ((row & rm) == ((1 << 15) | 1))
    x = np.where(hit, x * (float(g0[0, 0]) + 1j * float(g0[0, 1])), x)

    def par(v):
        out = np.zeros_like(v)
        for b in range(16):
            out ^= (v >> b) & 1
        return out
    p = par(lane & 0b10) ^ par(row & rm)
    x = x * (float(g1[0, 0]) - 1j * float(g1[0, 1]) * (1 - 2 * p))
    tot = (np.where((row >> 15) & 1, float(g2[0, 0]), 0.0)
           + float(g2[1, 0]) * (1 - 2 * (par(lane & 0b100) ^ ((row >> 3) & 1))))
    x = x * np.exp(1j * tot)
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got[0], x.real, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(got[1], x.imag, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(emulate_kernel(planes, seg), got,
                               atol=TOL * scale, rtol=0)


def test_wrapper_checks_and_counts_only_kernel_launches():
    n = 10
    seg = _port_segment(n, [_phase(np.random.default_rng(1), 0, 0, 0, 0)])
    before = S.segment_sweep.launches
    S.segment_sweep(torch.zeros((2, 1 << n)), seg)
    assert S.segment_sweep.launches == before      # CPU: plain version
    with pytest.raises(TypeError):
        S.segment_sweep(torch.zeros((2, 1 << n), dtype=torch.float64), seg)
    with pytest.raises(ValueError):
        S.segment_sweep(torch.zeros((2, 1 << (n - 1))), seg)
    with pytest.raises(ValueError):
        S.segment_sweep(torch.zeros((1 << n, 2)).T, seg)


def test_unported_stage_kinds_raise(monkeypatch):
    """Every stage kind runs now (BatchSelStage since the batched slice,
    the HIGH/DEFAULT contraction tiers since S11: a segment keeps the tier
    it was packed at); stage kinds the kernel does not know raise."""
    st = BP.BatchSelStage(8, 0)
    seg = S.prepare_segment([st], [np.zeros((1, 8), np.float32)], 10, "cpu")
    assert seg.slots == (0,) and seg.labels == {"batchsel"}
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "high")
    out = S.segment_sweep(torch.zeros((2, 1 << 10)), seg,
                          torch.zeros((1, 1, 8)))
    assert seg.tier == "highest" and not out.abs().max().item()
    assert S.prepare_segment([st], [np.zeros((1, 8), np.float32)], 10,
                             "cpu").tier == "high"
    monkeypatch.delenv("QUEST_MATMUL_PRECISION")
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        S.check_supported([object()])


# ---------------------------------------------------------------------------
# the diagonal's index above bit 31 (ROADMAP C2)
# ---------------------------------------------------------------------------


def _tile_row_ids(seg, blk):
    """Global row ids of tile `blk`'s rows as the kernel builds them: the
    free row bits from the tile index and the fixed rows, then inner rows
    and scattered bits (tile_base, tile_row)."""
    geo = seg.geometry
    scat = [b for b in range(32) if (seg.scat_mask >> b) & 1]
    base = tile_base(seg, blk)
    r = np.arange(1 << (geo.tile_bits - LANE_BITS))
    local = r & ((1 << geo.inner_bits) - 1)
    for k, bit in enumerate(scat):
        local = local | (((r >> (geo.inner_bits + k)) & 1) << bit)
    return base | local


def test_diag_index_keeps_target_bits_above_31():
    """At 33 qubits a diagonal on qubits (32, 3, 25): the kernel's table
    index (diag_entries: lane bits below 7, tile-row-id bits above, the
    reference's _bit_of) equals the bits of each element's global index,
    on the first and last tiles and one between (row bit 25, qubit 32,
    clear and set). The 32-bit global index the kernel built before,
    (row << 7 | lane) as an unsigned 32-bit value, loses qubit 32: it
    disagrees here, so this check catches that form."""
    n = 33
    st = BP.DiagVecStage((32, 3, 25), (), ())
    table = np.zeros((2, 8), np.float32)
    table[0] = 1.0
    seg = S.prepare_segment([st], [table], n, "cpu")
    d = seg.desc.numpy()[0]
    lane = np.arange(128)[None, :]
    seen = set()
    for blk in (0, seg.geometry.blocks // 2 + 5, seg.geometry.blocks - 1):
        rows = _tile_row_ids(seg, blk)[:, None]
        got = diag_entries(d, lane, rows)
        gidx = (rows.astype(np.int64) << 7) | lane
        want = sum(((gidx >> q) & 1) << j for j, q in enumerate(st.targets))
        np.testing.assert_array_equal(got, want)
        seen |= set(np.unique((gidx >> 32) & 1).tolist())
        old = ((gidx & 0xFFFFFFFF) >> 32) & 1       # bit 32 of a u32: gone
        if (gidx >> 32).any():
            assert ((old << 0) != ((gidx >> 32) & 1)).any()
    assert seen == {0, 1}


NTHREADS = 256                # csrc NTHREADS: threads of a block


def hoisted_diag(d, row_ids):
    """S8 on one tile as csrc diagvec_stage hoists it: thread t takes the
    float4 of lanes 4 (t % 32) .. 4 (t % 32) + 3 in rows t // 32, t // 32
    + 8, ...; it works out the table index's lane part and the lane
    predicate once for its four lanes, and the row part (the targets at
    or above bit 7, from the row id) and the row predicate once per row.
    Returns (index, applied, visits) per element, each (rows, 128); index
    is -1 where a predicate fails."""
    k = int(d[S.F_DIM])
    q = [(int(d[S.F_TARGETS]) >> (S.TARGET_BITS * j)) & 63 for j in range(k)]
    masked = bool(d[S.F_MASKED])
    lm, lw = int(d[S.F_LANE_MASK]), int(d[S.F_LANE_WANT])
    rm, rw = int(d[S.F_ROW_MASK]), int(d[S.F_ROW_WANT])
    rows = len(row_ids)
    index = np.full((rows, 128), -1, np.int64)
    visits = np.zeros((rows, 128), np.int64)
    for t in range(NTHREADS):
        l0 = (t & 31) * 4
        lidx = [sum((((l0 + c) >> q[j]) & 1) << j for j in range(k)
                    if q[j] < LANE_BITS) for c in range(4)]
        lok = [not masked or ((l0 + c) & lm) == lw for c in range(4)]
        for r in range(t >> 5, rows, NTHREADS // 32):
            visits[r, l0:l0 + 4] += 1
            row = int(row_ids[r])
            if masked and (row & rm) != rw:
                continue
            ridx = sum(((row >> (q[j] - LANE_BITS)) & 1) << j
                       for j in range(k) if q[j] >= LANE_BITS)
            for c in range(4):
                if lok[c]:
                    index[r, l0 + c] = lidx[c] | ridx
    return index, index >= 0, visits


DIAG_CASES = [("k1_row", (17,), (), ()),
              ("k3_preds", (0, 9, 12), ((2, 1),), ((1, 0),)),
              ("k7_mixed", (1, 5, 8, 9, 12, 14, 19), ((6, 0),), ((11, 1),)),
              ("k2_free_bits", (15, 3), (), ((0, 1), (12, 0)))]


@pytest.mark.parametrize("case", DIAG_CASES, ids=lambda c: c[0])
def test_hoisted_diag_index_matches_diag_entries(case):
    """On every tile of a 20-qubit segment whose tiles hold scattered row
    bits (an sc stage on row bit 9 beside the diagonal): the hoisted
    index equals diag_entries (the per-element index of the kernel before
    its redesign) wherever the predicates hold, the identity elsewhere,
    and each element is visited by exactly one thread once."""
    _, targets, lane_preds, row_preds = case
    n = 20
    rng = np.random.default_rng(41)
    t = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << len(targets)))
    table = np.stack([t.real, t.imag]).astype(np.float32)
    seg = S.prepare_segment(
        [BP.MatStage("sc", 2, False, (), (), 9),
         BP.DiagVecStage(targets, lane_preds, row_preds)],
        [np.stack([np.eye(2), np.zeros((2, 2))]).astype(np.float32), table],
        n, "cpu")
    d = seg.desc.numpy()[1]
    lane = np.arange(128)[None, :]
    for blk in range(seg.geometry.blocks):
        rows = _tile_row_ids(seg, blk)[:, None]
        index, applied, visits = hoisted_diag(d, rows[:, 0])
        assert (visits == 1).all()
        ok = ((lane & int(d[S.F_LANE_MASK])) == d[S.F_LANE_WANT]) & (
            (rows & int(d[S.F_ROW_MASK])) == d[S.F_ROW_WANT])
        np.testing.assert_array_equal(applied, ok)
        want = diag_entries(d, lane, rows)
        np.testing.assert_array_equal(index[ok], want[ok])


@pytest.mark.parametrize("case", DIAG_CASES, ids=lambda c: c[0])
def test_hoisted_diag_matches_plain_version(case):
    """The hoisted S8 applied tile by tile to a seeded 20-qubit state (the
    kernel's table lookup and complex multiply in f32) against the plain
    version _diagvec (segment_sweep on a CPU tensor), within TOL x
    max|amp|."""
    _, targets, lane_preds, row_preds = case
    n = 20
    rng = np.random.default_rng(43)
    t = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << len(targets)))
    table = np.stack([t.real, t.imag]).astype(np.float32)
    seg = S.prepare_segment([BP.DiagVecStage(targets, lane_preds, row_preds)],
                            [table], n, "cpu")
    d = seg.desc.numpy()[0]
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    got = planes.copy()
    tab = seg.ops.numpy()
    k = len(targets)
    for blk in range(seg.geometry.blocks):
        rows = _tile_row_ids(seg, blk)
        index, applied, _ = hoisted_diag(d, rows)
        idx = (rows.astype(np.int64)[:, None] << 7) | np.arange(128)[None, :]
        fr = np.where(applied, tab[np.maximum(index, 0)], np.float32(1))
        fi = np.where(applied, tab[(1 << k) + np.maximum(index, 0)],
                      np.float32(0))
        re, im = planes[0, idx], planes[1, idx]
        got[0, idx] = re * fr - im * fi
        got[1, idx] = re * fi + im * fr
    want = S.segment_sweep(torch.from_numpy(planes.copy()), seg).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


def test_hoisted_diag_index_at_33_qubits():
    """At 33 qubits, a diagonal on qubits (32, 3, 25) under a lane control
    (lane bit 1 set) and a row control (row bit 24, qubit 31, clear):
    on the first, a middle and the last tile the hoisted index and
    predicates equal those read off each element's 64-bit global index,
    qubit 32 included."""
    n = 33
    st = BP.DiagVecStage((32, 3, 25), ((1, 1),), ((24, 0),))
    table = np.zeros((2, 8), np.float32)
    table[0] = 1.0
    seg = S.prepare_segment([st], [table], n, "cpu")
    d = seg.desc.numpy()[0]
    lane = np.arange(128)[None, :]
    seen = set()
    for blk in (0, seg.geometry.blocks // 2 + 5, seg.geometry.blocks - 1):
        rows = _tile_row_ids(seg, blk)
        index, applied, visits = hoisted_diag(d, rows)
        assert (visits == 1).all()
        gidx = (rows.astype(np.int64)[:, None] << 7) | lane
        ok = (((gidx >> 1) & 1) == 1) & (((gidx >> 31) & 1) == 0)
        np.testing.assert_array_equal(applied, ok)
        want = sum(((gidx >> q) & 1) << j for j, q in enumerate(st.targets))
        np.testing.assert_array_equal(index[ok], want[ok])
        seen |= set(np.unique(want[ok] & 1).tolist())
    assert seen == {0, 1}


# ---------------------------------------------------------------------------
# the sliced operators of d >= 16 (HIGHEST slice rows, wgmma B tiles)
# ---------------------------------------------------------------------------


SLICED = [("b0", 128, -1), ("b1", 16, -1), ("b1", 32, -1), ("b1", 64, -1),
          ("b1", 128, -1), ("scb", 16, 3), ("scb", 64, 2), ("scb", 128, 0)]


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
@pytest.mark.parametrize("kind,dim,bit", SLICED, ids=lambda v: str(v))
def test_sliced_operator_round_trips(kind, dim, bit, tier):
    """The kernel's slices decode to the operator G[out, in] (the
    planner's orientation undone): HIGHEST rows [Gre[:, j], Gim[:, j]];
    at a tier, the tier's bf16 parts through the wgmma tiles and
    operand_perm. Slices are whole: OP_SLICE_BYTES each, or the whole
    operator when it is smaller."""
    rng = np.random.default_rng(dim + len(kind))
    _, _, st, g = _mat(rng, kind, kind, dim, bit=bit)
    flat = S.slice_operator(st, g, tier)
    G = S._operator(st, g)
    if tier == "highest":
        d = np.zeros(S.DESC_WORDS, np.int64)
        d[S.F_DIM] = dim
        got = _highest_operator(d, flat.astype(np.float64), 0)
        np.testing.assert_array_equal(got, G[0] + 1j * G[1].astype(np.float64))
    else:
        nparts = 4 if tier == "high" else 2
        got = tier_operator_parts(flat, 0, dim, nparts)
        want = S.tier_parts(G, tier).astype(np.uint32) << 16
        np.testing.assert_array_equal(got.view(np.uint32), want)
    assert flat.nbytes == (2 if tier == "highest" else nparts // 2) * 4 * (
        dim * dim)
    assert flat.nbytes % min(flat.nbytes, S.OP_SLICE_BYTES) == 0


def test_operand_perm_places_four_consecutive_elements():
    """perm16: fragment columns 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-group
    carry elements 4t .. 4t + 3 (one float4 per thread), a permutation."""
    perm = S.operand_perm(128)
    assert sorted(perm.tolist()) == list(range(128))
    for g16 in range(0, 128, 16):
        for t in range(4):
            cols = [g16 + 2 * t, g16 + 2 * t + 1, g16 + 2 * t + 8,
                    g16 + 2 * t + 9]
            assert perm[cols].tolist() == list(range(g16 + 4 * t,
                                                     g16 + 4 * t + 4))


@pytest.mark.parametrize("real", [False, True], ids=["complex", "real"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
@pytest.mark.parametrize("kind,dim,bit", SLICED, ids=lambda v: str(v))
def test_emulated_sliced_stage_matches_plain_version(kind, dim, bit, tier,
                                                     real):
    """Every width, tier and real form of a d >= 16 matrix stage, with
    lane and row predicates, through the kernel model on its slices and
    the plain version at the tier (15 qubits: two tiles of a b1 d=128
    stage, more for the narrower ones)."""
    n = 15
    rng = np.random.default_rng(dim * 7 + len(kind) + real)
    stage = _mat(rng, kind, kind, dim, real, ((5, 1),), ((2, 0),), bit=bit)
    seg = S.prepare_segment([stage[2]], [stage[3]], n, "cpu", tier=tier)
    planes = _state(n, seed=dim)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n, tier=tier).numpy()
    got = emulate_kernel(planes, seg)
    np.testing.assert_allclose(got, want.reshape(2, -1),
                               atol=TOL * float(np.abs(want).max()), rtol=0)
    assert int(seg.desc.numpy()[0, S.F_OP_OFF]) % 4 == 0   # bulk copies


# ---------------------------------------------------------------------------
# S7 with the angle factored into a lane part and a row part
# ---------------------------------------------------------------------------


def _parity32(x):
    """Parity of the low 32 bits of each value of x (int array)."""
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return (x & 1).astype(bool)


def multiphase_rows(d, g):
    """(parity-form flags, angles f32, lane masks, row masks) of an S7
    descriptor and its (m, 8) rows as the kernel reads them: forms from
    F_FORMS, row masks joined from their f32 halves at bit 15 (32-bit
    patterns)."""
    m = int(d[S.F_DIM])
    rows = np.asarray(g, np.float32).reshape(-1)[:8 * m].reshape(m, 8)
    par = np.array([(int(d[S.F_FORMS]) >> r) & 1 for r in range(m)], bool)
    lm = rows[:, 1].astype(np.int64)
    rm = (rows[:, 2].astype(np.int64) | (rows[:, 3].astype(np.int64) << 15)
          ) & 0xFFFFFFFF
    return par, rows[:, 0].astype(np.float32), lm, rm


def term_bits(x, masks, par):
    """(len(x), m) bools: csrc term_bits of each x (lanes, or row ids)."""
    y = (np.asarray(x, np.int64)[:, None] & 0xFFFFFFFF) & masks[None, :]
    return np.where(par[None, :], _parity32(y), y == masks[None, :])


def factored_multiphase(d, g, row_ids):
    """S7's angle sums on one tile as csrc multiphase_stage computes them:
    each row's term bits once (the table in shared memory), each
    thread's four lanes' bits once; then per element, in order r = 0..m-1,
    +angle where the plus bit is set, -angle where the minus bit is, +0
    else, in f32. Thread t takes lanes 4 (t % 32) .. + 3 in rows t // 32,
    t // 32 + 8, ... Returns (sums (rows, 128) f32, visits per
    element)."""
    par, ang, lm, rm = multiphase_rows(d, g)
    rows = len(row_ids)
    rb = term_bits(row_ids, rm, par)                      # (rows, m)
    tot = np.zeros((rows, 128), np.float32)
    visits = np.zeros((rows, 128), np.int64)
    for t in range(NTHREADS):
        l0 = (t & 31) * 4
        lb = term_bits(np.arange(l0, l0 + 4), lm, par)    # (4, m)
        rr = np.arange(t >> 5, rows, NTHREADS // 32)
        r_b = rb[rr][:, None, :]
        differ = lb[None] ^ r_b
        minus = par & differ
        plus = (par & ~differ) | (~par & lb[None] & r_b)
        acc = np.zeros((len(rr), 4), np.float32)
        for r in range(len(ang)):
            acc = acc + np.where(plus[..., r], ang[r],
                                 np.where(minus[..., r], -ang[r],
                                          np.float32(0)))
        tot[rr, l0:l0 + 4] = acc
        visits[rr, l0:l0 + 4] += 1
    return tot, visits


def unfactored_multiphase(d, g, row_ids):
    """The same sums as the kernel took them before the factoring: per
    element and term, the parity or the match from the element's own lane
    and row id, added in order in f32 (an all-ones term that does not
    match adds nothing)."""
    par, ang, lm, rm = multiphase_rows(d, g)
    lane = np.arange(128)[None, :]
    row = (np.asarray(row_ids, np.int64) & 0xFFFFFFFF)[:, None]
    tot = np.zeros((len(row_ids), 128), np.float32)
    for r in range(len(ang)):
        if par[r]:
            odd = _parity32(lane & lm[r]) ^ _parity32(row & rm[r])
            tot = tot + np.where(odd, -ang[r], ang[r])
        else:
            hit = ((lane & lm[r]) == lm[r]) & ((row & rm[r]) == rm[r])
            tot = np.where(hit, tot + ang[r], tot)
    return tot


def _mp_terms(rng, m, row_bits, forms=None):
    """m (form, lane mask, row mask) terms over `row_bits` row bits: forms
    at random unless given; a parity term's masks at random, an all-ones
    term's of one or two bits (so that it matches part of a tile)."""
    out = []
    for r in range(m):
        form = forms[r] if forms else ("a", "p")[int(rng.integers(2))]
        if form == "p":
            out.append((form, int(rng.integers(0, 128)),
                        int(rng.integers(0, 1 << row_bits))))
        else:
            bits = rng.choice(7 + row_bits, size=int(rng.integers(1, 3)),
                              replace=False)
            out.append((form, sum(1 << int(b) for b in bits if b < 7),
                        sum(1 << int(b - 7) for b in bits if b >= 7)))
    return out


# (name, m, forms or None for mixed): every m the kernel dispatches on,
# mixed forms, and the main paths' two all-ones terms
MP_CASES = [("m1_parity", 1, ("p",)), ("m1_allones", 1, ("a",)),
            ("m2_aa", 2, ("a", "a")), ("m2_mixed", 2, None),
            ("m8_mixed", 8, None), ("m8_aa", 8, ("a",) * 8),
            ("m64_mixed", 64, None)]


@pytest.mark.parametrize("case", MP_CASES, ids=lambda c: c[0])
def test_factored_multiphase_sum_is_bit_identical(case):
    """On a tile of 128 rows whose ids use all 32 bits (bit 31 included)
    under row masks up to row bit 31: the factored sums (lane part once
    per thread, row part once per row) equal the per-element f32 sums bit
    for bit, and every element is visited once."""
    name, m, forms = case
    rng = np.random.default_rng(sum(map(ord, name)))
    terms = _mp_terms(rng, m, 32, forms)
    form, lm, rm = terms[-1]
    terms[-1] = (form, lm, rm | 1 << 31)          # row bit 31 in a mask
    _, _, st, g = _multiphase(rng, terms)
    d = S.prepare_segment([st], [g], 14, "cpu").desc.numpy()[0]
    row_ids = rng.integers(0, 1 << 32, size=128, dtype=np.int64)
    row_ids[:2] = (0, 0xFFFFFFFF)
    got, visits = factored_multiphase(d, g, row_ids)
    want = unfactored_multiphase(d, g, row_ids)
    assert (visits == 1).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (multiphase_rows(d, g)[3] >> 31).any()


@pytest.mark.parametrize("case", MP_CASES, ids=lambda c: c[0])
def test_factored_multiphase_matches_references(case):
    """The factored S7 applied tile by tile to a seeded 12-qubit state
    (its sums, then cos/sin and the complex multiply in f32) against the
    plain version (segment_sweep on a CPU tensor) and the reference's
    compile_segment in the Pallas interpreter, within TOL x max|amp|."""
    name, m, forms = case
    n = 12
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    if forms == ("a", "a"):               # the main paths' CZ pair
        terms = [("a", 1 << 6, 1), ("a", 0, 3 << 3)]
    else:
        terms = _mp_terms(rng, m, n - LANE_BITS, forms)
    stage = _multiphase(rng, terms)
    seg = _port_segment(n, [stage])
    d = seg.desc.numpy()[0]
    g = stage[3]
    planes = _state(n, seed=21)
    got = planes.copy()
    for blk in range(seg.geometry.blocks):
        rows = _tile_row_ids(seg, blk)
        tot, _ = factored_multiphase(d, g, rows)
        idx = (rows.astype(np.int64)[:, None] << 7) | np.arange(128)[None, :]
        cs, sn = np.cos(tot), np.sin(tot)
        re, im = planes[0, idx], planes[1, idx]
        got[0, idx] = re * cs - im * sn
        got[1, idx] = re * sn + im * cs
    plain = S.segment_sweep(torch.from_numpy(planes.copy()), seg).numpy()
    ref = np.asarray(PB.compile_segment([stage[1]], n, interpret=True)(
        jnp.asarray(planes).reshape(2, -1, PB.LANES), [g])).reshape(2, -1)
    for want in (plain, ref):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))
