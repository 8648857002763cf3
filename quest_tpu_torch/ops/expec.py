"""Grouped Pauli-sum expectation engine on split re/im planes.

A port of quest_tpu/ops/expec.py (ROADMAP A6). Every term's value is an
elementwise functional of the state read against ONE bit-flip-permuted
view of itself,

    <P> = sum_j conj(a_j) (-i)^ny (-1)^parity(j & zy) a_{j ^ x}

with x the term's X/Y support (its flip mask), zy its Z/Y support and ny
its Y count. The plan (`plan_expec`, ref :87-203) groups the terms by
flip mask — the diagonal group (x = 0) first, then one group per mask —
and packs up to QUEST_EXPEC_MAX_MASKS off-diagonal groups into one
sweep. Under equal knobs the port's plans equal the reference's, group
for group and pack for pack; `plan_stats` and `explain` report them on
the host.

The evaluators are plain torch ops (the reference leaves them to XLA,
which fuses each pack into one loop). Eager PyTorch fuses nothing, so
the port bounds its temporaries itself: every evaluation runs over
chunks of 2^CHUNK_BITS amplitudes (2^24, the chunk of ops/apply's
primitives). A flip bit at or above the chunk width pairs chunk c with
chunk c ^ (x >> CHUNK_BITS); a flip bit below it flips inside the chunk.
Signs stay the reference's factored tables of at most 256 entries a
view axis (`_group_view`, `_parity_tables`); the sign of the bits above
the chunk is one scalar per chunk. Nothing 2^n-sized is built besides
the output of `apply_pauli_sum_planes`, filled chunk by chunk.

Within a chunk each group forms its shared product plane once (|a|^2
for the diagonal group, conj(a) a_flip otherwise), in the plane dtype
as the reference does, takes it to the accumulator dtype (f64), and
reduces it against the terms' sign tables: terms whose tables touch the
same view axes share one weight table (the sum of their signed,
coefficient-weighted sign products), and each distinct axis set costs
one marginal reduction of the plane, not one pass a term. An
off-diagonal group reads only half of its pairs: conj(a_j) a_{j^x} and
its partner's term carry the same value for the term's real or
imaginary part (the other part cancels), so the half with the highest
flip bit clear counts twice. Every pack accumulates in f64 chunk by
chunk; no full-size f64 copy and no full-size flipped copy exists.

Differentiable by torch.autograd: `expec_traced` (in the planes and the
coefficients), `apply_pauli_sum_planes` and `flipped_trace_diag` are
plain differentiable tensor code, which the variational energies
(variational.expectation) and the taped gradient engine
(adjoint.value_and_grad(engine='taped')) tape through. `expec_value`,
`batched_reducer` and `plan_stats` return values, not graphs.

The sharded evaluators (`expec_sharded`, `apply_pauli_sum_planes_sharded`,
ref :484-625) run on a parallel.ShardedAmps: local flip bits flip inside
the shard, each DISTINCT global flip mask costs one AmpMesh.permute pair
exchange (shard d reads shard d ^ mask), fetched once and shared by every
group that carries it, and freed before the next mask's; global zy bits
fold into a per-shard sign of the term's coefficient. Each shard's
partial is in f64 and one AmpMesh.reduce sums them. Density registers
need no exchange at all: the entry rho[c ^ x, c] a trace reads lies in
column c, which one shard holds whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val

# Axis chunk width of the parity-sign tables (ref :76): every non-flip
# axis of a group view spans at most 2^_SEG_BITS indices.
_SEG_BITS = 8
# log2 amplitudes per plane per chunk of an evaluation (ops/apply's
# CHUNK_AMPS); the tests set it small to put flip bits above the chunk.
CHUNK_BITS = 24


# ---------------------------------------------------------------------------
# term parsing (memoised by value)
# ---------------------------------------------------------------------------


_PARSE_CACHE: Dict = {}


def parse_pauli_sum(all_codes, num_qubits: int) -> Tuple[Tuple[int, ...], ...]:
    """Validated (M, num_qubits) Pauli-code rows as a nested tuple,
    memoised by value (ref :87): the tuple is the plan cache key, so
    equal code arrays resolve to the same plan."""
    codes = np.ascontiguousarray(
        np.asarray(all_codes, dtype=np.int32).reshape(-1, num_qubits))
    key = (num_qubits, codes.shape[0], codes.tobytes())
    hit = _PARSE_CACHE.get(key)
    if hit is not None:
        return hit
    val.validate_num_pauli_sum_terms(codes.shape[0])
    val.validate_pauli_codes(codes)
    codes_key = tuple(tuple(int(c) for c in row) for row in codes)
    _PARSE_CACHE[key] = codes_key
    return codes_key


# ---------------------------------------------------------------------------
# the plan (ref :113-203)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Term:
    """One Pauli string in flip form: coefficient row `index`, X/Y
    support `x_bits` (the flip mask), Z/Y support `zy_bits` (the sign
    mask), Y count `ny` (the (-i)^ny quarter-turn)."""
    index: int
    x_bits: Tuple[int, ...]
    zy_bits: Tuple[int, ...]
    ny: int


@dataclasses.dataclass(frozen=True)
class _Group:
    """Terms sharing one flip mask; x_bits == () is the diagonal group."""
    x_bits: Tuple[int, ...]
    terms: Tuple[_Term, ...]


@dataclasses.dataclass(frozen=True)
class ExpecPlan:
    """Static (hashable) evaluation plan; the coefficient vector stays a
    runtime operand."""
    n: int                                  # state qubits (2N for density)
    density: bool
    num_terms: int
    groups: Tuple[_Group, ...]
    sweeps: Tuple[Tuple[int, ...], ...]     # packs of group indices


def fusion_enabled() -> bool:
    """QUEST_EXPEC_FUSION (keyed, default 1): the grouped engine; 0
    evaluates term by term (calculations._expec_pauli_sum)."""
    from quest_tpu_torch.env import knob_value
    return knob_value("QUEST_EXPEC_FUSION")


def max_masks_per_sweep() -> int:
    """QUEST_EXPEC_MAX_MASKS (keyed): off-diagonal groups per sweep."""
    from quest_tpu_torch.env import knob_value
    return knob_value("QUEST_EXPEC_MAX_MASKS")


def _flip_form(term: Sequence[int], index: int) -> _Term:
    x_bits = tuple(q for q, p in enumerate(term) if p in (1, 2))
    zy_bits = tuple(q for q, p in enumerate(term) if p in (2, 3))
    ny = sum(1 for p in term if p == 2)
    return _Term(index, x_bits, zy_bits, ny)


@functools.lru_cache(maxsize=512)
def _plan_cached(codes_key, n: int, density: bool,
                 max_masks: int) -> ExpecPlan:
    terms = [_flip_form(t, i) for i, t in enumerate(codes_key)]
    by_mask: Dict[Tuple[int, ...], list] = {}
    order = []
    for t in terms:
        if t.x_bits not in by_mask:
            by_mask[t.x_bits] = []
            order.append(t.x_bits)
        by_mask[t.x_bits].append(t)
    # diagonal group first: it is always its own (|a|^2) sweep
    order.sort(key=lambda m: (m != (),))
    groups = tuple(_Group(m, tuple(by_mask[m])) for m in order)
    sweeps = []
    pack = []
    for gi, g in enumerate(groups):
        if not g.x_bits:
            sweeps.append((gi,))
            continue
        pack.append(gi)
        if len(pack) >= max_masks:
            sweeps.append(tuple(pack))
            pack = []
    if pack:
        sweeps.append(tuple(pack))
    return ExpecPlan(n=n, density=density, num_terms=len(terms),
                     groups=groups, sweeps=tuple(sweeps))


def plan_expec(codes_key, num_qubits: int, *, density: bool) -> ExpecPlan:
    """The grouped plan of validated code rows over `num_qubits` logical
    qubits; a density plan evaluates on the doubled register."""
    n = 2 * num_qubits if density else num_qubits
    return _plan_cached(tuple(tuple(t) for t in codes_key), n,
                        bool(density), max_masks_per_sweep())


# ---------------------------------------------------------------------------
# view geometry + parity sign tables (ref :210-262)
# ---------------------------------------------------------------------------


def _group_view(n: int, x_bits: Tuple[int, ...], seg_bits: int = _SEG_BITS):
    """Axis layout of a (2^n,) plane: a size-2 axis per flip bit, the
    bit ranges between them cut into chunks of at most `seg_bits` bits.
    Returns (dims, axis_of_flip_bit, ranges), ranges[axis] = (lo_bit,
    width), axes most significant first."""
    dims, ranges = [], []
    axis_of: Dict[int, int] = {}

    def push(lo, hi):
        cut = hi
        while cut > lo:
            w = min(seg_bits, cut - lo)
            dims.append(1 << w)
            ranges.append((cut - w, w))
            cut -= w

    prev = n
    for q in sorted(x_bits, reverse=True):
        if prev > q + 1:
            push(q + 1, prev)
        dims.append(2)
        ranges.append((q, 1))
        axis_of[q] = len(dims) - 1
        prev = q
    if prev > 0:
        push(0, prev)
    if not dims:                      # n == 0 edge
        dims, ranges = [1], [(0, 0)]
    return tuple(dims), axis_of, tuple(ranges)


def _parity_tables(ranges, zy_bits, rdt):
    """[(axis, (+1/-1) vector)] for the axes whose bit range meets
    `zy_bits`: table[v] = (-1)^parity(v & local mask); their broadcast
    product along the view is the term's sign."""
    zy = frozenset(zy_bits)
    out = []
    for ax, (lo, w) in enumerate(ranges):
        bits = [b for b in range(lo, lo + w) if b in zy]
        if not bits:
            continue
        idx = np.arange(1 << w)
        par = np.zeros(1 << w, dtype=np.int64)
        for b in bits:
            par ^= (idx >> (b - lo)) & 1
        out.append((ax, (1.0 - 2.0 * par).astype(rdt)))
    return out


# ---------------------------------------------------------------------------
# weight tables: the terms of a group, bucketed by the axes they touch
# ---------------------------------------------------------------------------

# (plane, signed factor) of a term by ny % 4: statevector values read
# Re[(-i)^ny (T_re + i T_im)]; density values Re[i^ny (r + i m)] and the
# operator apply's (-i)^ny as (re, im) weights of the flipped read share
# one table
_SV_PLANES = {0: (("re", 1.0),), 1: (("im", 1.0),), 2: (("re", -1.0),),
              3: (("im", -1.0),)}
_QUARTER_PLANES = {0: (("re", 1.0),), 1: (("im", -1.0),),
                   2: (("re", -1.0),), 3: (("im", 1.0),)}
_FORMS = {"sv": _SV_PLANES, "dm": _QUARTER_PLANES, "apply": _QUARTER_PLANES}


@functools.lru_cache(maxsize=4096)
def _bucket_layout(group: _Group, C: int, form: str):
    """Host layout of one group's terms on a chunk of 2^C amplitudes:
    (dims, flip axes, half-split axis, buckets). Each bucket is (plane,
    key axes, high sign mask m, stacked numpy sign products F (T, ...),
    term indices, signs): its weight table is sum_t sign_t cf[idx_t]
    F_t, times (-1)^popcount(c & m) on chunk c."""
    x_lo = tuple(q for q in group.x_bits if q < C)
    dims, axis_of, ranges = _group_view(C, x_lo)
    nd = len(dims)
    flip_axes = tuple(axis_of[q] for q in x_lo)
    raw: Dict[tuple, list] = {}
    for t in group.terms:
        zy_lo = tuple(b for b in t.zy_bits if b < C)
        m = sum(1 << (b - C) for b in t.zy_bits if b >= C)
        tabs = _parity_tables(ranges, zy_lo, np.float64)
        key = tuple(ax for ax, _ in tabs)
        F = np.ones([dims[ax] if ax in key else 1 for ax in range(nd)])
        for ax, tab in tabs:
            shape = [1] * nd
            shape[ax] = tab.size
            F = F * tab.reshape(shape)
        for plane, sgn in _FORMS[form][t.ny % 4]:
            raw.setdefault((plane, key, m), []).append((t.index, sgn, F))
    buckets = tuple(
        (plane, key, m, np.stack([f for _, _, f in items]),
         np.asarray([i for i, _, _ in items], dtype=np.int64),
         np.asarray([s for _, s, _ in items], dtype=np.float64))
        for (plane, key, m), items in raw.items())
    return dims, flip_axes, buckets


def _weights(layout, cf: torch.Tensor, dtype, narrow=None):
    """{plane: {key: [(m, weight table)]}} of a bucket layout on the
    coefficient tensor `cf` (differentiable in cf), in `dtype`;
    `narrow` = (axis, index) keeps one index of a half-split axis."""
    dims, _, buckets = layout
    nd = len(dims)
    out: Dict[str, Dict[tuple, list]] = {}
    for plane, key, m, F, idx, sgn in buckets:
        Ft = torch.as_tensor(F, dtype=dtype, device=cf.device)
        w = (cf[torch.as_tensor(idx, device=cf.device)].to(dtype)
             * torch.as_tensor(sgn, dtype=dtype, device=cf.device))
        W = (w.reshape((-1,) + (1,) * nd) * Ft).sum(0)
        if narrow is not None and W.shape[narrow[0]] == 2:
            W = W.narrow(narrow[0], narrow[1], 1)
        out.setdefault(plane, {}).setdefault(key, []).append((m, W))
    return out


def _at_chunk(entries, c: int):
    """A key's weight table on chunk c: sum_m (-1)^popcount(c & m) W_m."""
    W = None
    for m, Wm in entries:
        t = -Wm if bin(c & m).count("1") & 1 else Wm
        W = t if W is None else W + t
    return W


def _reduce(base: torch.Tensor, keyed, c: int, acc: torch.dtype):
    """sum_j base_j W(j) over every key's weight table: one marginal
    reduction of `base` (already in `acc`) per distinct axis set."""
    total = None
    nd = base.dim()
    for key, entries in keyed.items():
        W = _at_chunk(entries, c)
        other = [ax for ax in range(nd) if ax not in key]
        marg = base.sum(dim=other, keepdim=True) if other else base
        v = (marg * W).sum() if key else marg.sum() * W.reshape(())
        total = v if total is None else total + v
    return total


def _chunking(n: int):
    """(chunk bits C, chunk count) of an n-qubit plane."""
    C = min(n, CHUNK_BITS)
    return C, 1 << (n - C)


def _chunk_view(flat: torch.Tensor, c: int, C: int, dims):
    return flat[c << C:(c + 1) << C].view(dims)


# ---------------------------------------------------------------------------
# statevector evaluation (ref :292-358)
# ---------------------------------------------------------------------------


def _group_value_sv(planes, cf, g: _Group, n: int, acc: torch.dtype,
                    src=None):
    """sum_t c_t <P_t> of one mask group over every chunk, in `acc`.
    `src`, when given, holds the flipped amplitudes a_{j ^ x} for flip
    bits beyond these planes (a sharded register's partner shard): every
    pair is then read from both sides, without the half split."""
    C, nchunks = _chunking(n)
    layout = _bucket_layout(g, C, "sv")
    dims, flip_axes, _ = layout
    x_hi = sum(1 << (q - C) for q in g.x_bits if q >= C)
    h = max(g.x_bits) if g.x_bits else None
    paired = src is not None
    inner_half = h is not None and h < C and not paired
    narrow = (flip_axes[0], 0) if inner_half else None
    weights = _weights(layout, cf, acc, narrow)
    re, im = planes[0], planes[1]
    sre, sim = (src[0], src[1]) if paired else (re, im)
    total = None
    for c in range(nchunks):
        if (g.x_bits and not inner_half and not paired
                and (c >> (h - C)) & 1):
            continue                 # this chunk is the partner's half
        ar = _chunk_view(re, c, C, dims)
        ai = _chunk_view(im, c, C, dims)
        if not g.x_bits and not paired:
            base = {"re": torch.addcmul(ar * ar, ai, ai).to(acc)}
            twice = 1.0
        else:
            if inner_half:
                ax = flip_axes[0]
                br, bi = ar.narrow(ax, 1, 1), ai.narrow(ax, 1, 1)
                ar, ai = ar.narrow(ax, 0, 1), ai.narrow(ax, 0, 1)
                rest = list(flip_axes[1:])
            else:
                p = c ^ x_hi
                br = _chunk_view(sre, p, C, dims)
                bi = _chunk_view(sim, p, C, dims)
                rest = list(flip_axes)
            if rest:
                br, bi = br.flip(rest), bi.flip(rest)
            base = {}
            if "re" in weights:
                base["re"] = torch.addcmul(ar * br, ai, bi).to(acc)
            if "im" in weights:
                base["im"] = torch.addcmul(ar * bi, ai, br, value=-1).to(acc)
            twice = 1.0 if paired else 2.0
        for plane, keyed in weights.items():
            v = _reduce(base[plane], keyed, c, acc) * twice
            total = v if total is None else total + v
    return total


def expec_traced(amps: torch.Tensor, coeffs, plan: ExpecPlan) -> torch.Tensor:
    """sum_t c_t <P_t> over `plan` with runtime `coeffs` (a tensor, or
    anything torch.as_tensor takes): a 0-dim f64 tensor on the planes'
    device. Differentiable in `amps` and `coeffs`. `amps` is (2, 2^n)
    planes or the fused view (2, 2^(n-7), 128)."""
    acc = precision.torch_dtype(precision.accum_dtype(amps.dtype))
    cf = torch.as_tensor(coeffs, dtype=amps.dtype, device=amps.device)
    planes = amps.reshape(2, -1)
    total = torch.zeros((), dtype=acc, device=amps.device)
    for pack in plan.sweeps:
        for gi in pack:
            g = plan.groups[gi]
            if plan.density:
                v = _group_value_density(planes, cf, g, plan.n // 2, acc)
            else:
                v = _group_value_sv(planes, cf, g, plan.n, acc)
            if v is not None:
                total = total + v
    return total


# ---------------------------------------------------------------------------
# operator application (ref :361-412)
# ---------------------------------------------------------------------------


def apply_pauli_sum_planes(amps: torch.Tensor, coeffs,
                           plan: ExpecPlan) -> torch.Tensor:
    """(2, 2^n) planes of (sum_t c_t P_t)|a>:

        out_j = sum_t c_t (-i)^ny_t (-1)^parity(j & zy_t) a_{j ^ x_t}

    one flipped read per mask group a chunk (the partner chunk for flip
    bits above it), the terms' signs and quarter-turns as one complex
    weight table per group; no 2^n x 2^n operator is formed. It seeds
    the adjoint engine's bra register lambda = H|psi>. Statevector plans
    only. Differentiable; a new tensor, written chunk by chunk."""
    assert not plan.density
    cf = torch.as_tensor(coeffs, dtype=amps.dtype, device=amps.device)
    return _apply_groups(amps.reshape(2, -1), cf, plan.groups, plan.n)


def _apply_groups(planes: torch.Tensor, cf: torch.Tensor, groups_in,
                  n: int, out: torch.Tensor = None) -> torch.Tensor:
    """sum over `groups_in` of their terms' flipped, signed, weighted
    reads of `planes` (2, 2^n): a new tensor, or added into `out`."""
    C, nchunks = _chunking(n)
    re, im = planes[0], planes[1]
    accumulate = out is not None
    groups = []
    for g in groups_in:
        layout = _bucket_layout(g, C, "apply")
        w = _weights(layout, cf, planes.dtype)
        groups.append((layout[0], list(layout[1]),
                       sum(1 << (q - C) for q in g.x_bits if q >= C),
                       w.get("re"), w.get("im")))
    if out is None and nchunks > 1:
        out = torch.empty_like(planes)
    for c in range(nchunks):
        o_re = o_im = None
        for dims, flip_axes, x_hi, wre, wim in groups:
            fr = _chunk_view(re, c ^ x_hi, C, dims)
            fi = _chunk_view(im, c ^ x_hi, C, dims)
            if flip_axes:
                fr, fi = fr.flip(flip_axes), fi.flip(flip_axes)
            gre, gim = _full_weight(wre, c), _full_weight(wim, c)
            tre = tim = None
            if gre is not None:
                tre, tim = fr * gre, fi * gre
            if gim is not None:
                ure, uim = -(fi * gim), fr * gim
                tre = ure if tre is None else tre + ure
                tim = uim if tim is None else tim + uim
            tre, tim = tre.reshape(-1), tim.reshape(-1)
            o_re = tre if o_re is None else o_re + tre
            o_im = tim if o_im is None else o_im + tim
        if out is None:
            return torch.stack([o_re, o_im])
        if accumulate:
            out[0, c << C:(c + 1) << C] += o_re
            out[1, c << C:(c + 1) << C] += o_im
        else:
            out[0, c << C:(c + 1) << C] = o_re
            out[1, c << C:(c + 1) << C] = o_im
    return out


def _full_weight(keyed, c: int):
    """A group's weight table on chunk c as one broadcastable tensor (the
    sum of its keyed tables), or None."""
    if not keyed:
        return None
    W = None
    for entries in keyed.values():
        t = _at_chunk(entries, c)
        W = t if W is None else W + t
    return W


# ---------------------------------------------------------------------------
# density evaluation: grouped tr(H rho) (ref :420-474)
# ---------------------------------------------------------------------------


def flipped_trace_diag(amps: torch.Tensor, N: int, x_bits):
    """(Re, Im) of the flipped diagonal rho[k, k ^ x] as (2^N,) tensors:
    the 2^N entries a Pauli trace reads of the 4^N register (ref :420).
    rho[r, c] is stored at r + c 2^N. Differentiable (a gather)."""
    dim = 1 << N
    x = sum(1 << q for q in x_bits)
    k = torch.arange(dim, device=amps.device)
    idx = k + (k ^ x) * dim
    flat = amps.reshape(2, -1)
    return flat[0][idx], flat[1][idx]


def _group_value_density(planes, cf, g: _Group, N: int, acc: torch.dtype):
    """Re sum_t c_t Tr(P_t rho) of one mask group: one flipped diagonal
    of 2^N entries, reduced against the terms' weight tables."""
    layout = _density_layout(g, N)
    dims = layout[0]
    weights = _weights(layout, cf, acc)
    rdiag, idiag = flipped_trace_diag(planes, N, g.x_bits)
    base = {"re": rdiag.reshape(dims).to(acc),
            "im": idiag.reshape(dims).to(acc)}
    total = None
    for plane, keyed in weights.items():
        v = _reduce(base[plane], keyed, 0, acc)
        total = v if total is None else total + v
    return total


@functools.lru_cache(maxsize=4096)
def _density_layout(group: _Group, N: int):
    """The density form reads the diagonal's own view (no flip axes):
    the group's terms laid out as a diagonal group over N bits."""
    return _bucket_layout(_Group((), group.terms), N, "dm")


# ---------------------------------------------------------------------------
# register-level entry + introspection (ref :651-750)
# ---------------------------------------------------------------------------


def expec_value(q, coeffs, codes_key) -> float:
    """sum_t c_t <P_t> of register `q` through the grouped engine: the
    sharded evaluators on a ShardedAmps register (ref :651)."""
    plan = plan_expec(codes_key, q.num_qubits, density=q.is_density)
    cf = torch.as_tensor(np.asarray(coeffs, dtype=q.real_dtype),
                         device=q.amps.device)
    with torch.no_grad():
        if not torch.is_tensor(q.amps):
            return float(expec_sharded(q.amps, cf, plan))
        return float(expec_traced(q.amps, cf, plan))


# ---------------------------------------------------------------------------
# sharded evaluation: per-shard partials + one reduce (ref :484-625)
# ---------------------------------------------------------------------------


def _localize(g: _Group, local_n: int):
    """(the group's in-shard form, its global flip mask): x and zy bits
    below local_n; the terms keep their coefficient index."""
    lx = tuple(q for q in g.x_bits if q < local_n)
    gxm = sum(1 << (q - local_n) for q in g.x_bits if q >= local_n)
    terms = tuple(_Term(t.index, lx,
                        tuple(b for b in t.zy_bits if b < local_n), t.ny)
                  for t in g.terms)
    return _Group(lx, terms), gxm


def _shard_coeffs(cf: torch.Tensor, plan: ExpecPlan, local_n: int,
                  d: int, device) -> torch.Tensor:
    """The coefficients as shard d reads them: each term's times the
    parity sign of its global zy bits on this shard (constant over it)."""
    sign = np.ones(plan.num_terms)
    for g in plan.groups:
        for t in g.terms:
            par = 0
            for b in t.zy_bits:
                if b >= local_n:
                    par ^= (d >> (b - local_n)) & 1
            sign[t.index] = -1.0 if par else 1.0
    return cf.to(device) * torch.as_tensor(sign, dtype=cf.dtype,
                                           device=device)


def global_flip_masks(plan: ExpecPlan, local_n: int):
    """The distinct nonzero global flip masks of a plan in first-use
    order: one pair exchange each (the issued count is held equal to it
    in the tests)."""
    out = []
    for g in plan.groups:
        m = _localize(g, local_n)[1]
        if m and m not in out:
            out.append(m)
    return out


def _by_mask(plan: ExpecPlan, local_n: int):
    """[(global mask, [local groups])], mask 0 first, then first use."""
    table: Dict[int, list] = {}
    for g in plan.groups:
        lg, m = _localize(g, local_n)
        table.setdefault(m, []).append(lg)
    return sorted(table.items(), key=lambda kv: kv[0] != 0)


def expec_sharded(amps, coeffs, plan: ExpecPlan) -> torch.Tensor:
    """sum_t c_t <P_t> of a sharded register (a parallel.ShardedAmps):
    a 0-dim f64 tensor on the first shard's device, differentiable in the
    shards and the coefficients (ref expec_sharded :625). Statevector
    plans: per group and shard the in-shard evaluator, reading a global
    mask's flipped amplitudes from the partner shard the mask's one
    exchange brought; density plans: each shard's own columns, no
    exchange."""
    mesh = amps.mesh
    local_n = amps.local_n
    cf = torch.as_tensor(coeffs, dtype=amps.dtype, device=amps.device)
    acc = precision.torch_dtype(precision.accum_dtype(amps.dtype))
    views = amps.views()
    mine = mesh.local_ids
    cfs = [None if v is None else _shard_coeffs(cf, plan, local_n, d,
                                                 v.device)
           for d, v in enumerate(views)]
    parts = [None if v is None else torch.zeros((), dtype=acc,
                                                device=v.device)
             for v in views]
    if plan.density:
        for d in mine:
            v = views[d]
            parts[d] = parts[d] + _density_shard_value(
                v, cf.to(v.device), plan, d, local_n, acc)
        return mesh.reduce(parts)
    for mask, groups in _by_mask(plan, local_n):
        src = mesh.permute(views, None, mask=mask) if mask else None
        for d in mine:
            v = views[d]
            for lg in groups:
                val = _group_value_sv(v, cfs[d], lg, local_n, acc,
                                      src=None if src is None else src[d])
                if val is not None:
                    parts[d] = parts[d] + val
        del src
    return mesh.reduce(parts)


def _density_shard_value(x: torch.Tensor, cf: torch.Tensor,
                         plan: ExpecPlan, d: int, local_n: int, acc):
    """Re sum_t c_t Tr(P_t rho) over the columns shard d holds: column c
    contributes i^ny (-1)^parity(k & zy) rho[k, c] at k = c ^ x, an entry
    of the same column. Needs whole columns on the shard."""
    N = plan.n // 2
    dim = 1 << N
    cols = (1 << local_n) // dim
    if cols < 1:
        raise val.QuESTError(
            "Invalid operation: calcExpecPauliSum cannot run on a sharded "
            "register: a density register needs 2^numQubits >= the mesh "
            "size (whole columns on each shard)")
    c = torch.arange(d * cols, (d + 1) * cols, device=x.device)
    total = torch.zeros((), dtype=acc, device=x.device)
    for g in plan.groups:
        xm = sum(1 << q for q in g.x_bits)
        k = c ^ xm
        off = (c - d * cols) * dim + k
        r, m = x[0][off].to(acc), x[1][off].to(acc)
        for t in g.terms:
            par = torch.zeros_like(k)
            for b in t.zy_bits:
                par ^= (k >> b) & 1
            sgn = (1 - 2 * par).to(acc)
            (plane, f), = _QUARTER_PLANES[t.ny % 4]
            v = (r if plane == "re" else m) * sgn
            total = total + cf[t.index].to(acc) * f * v.sum()
    return total


def apply_pauli_sum_planes_sharded(amps, coeffs, plan: ExpecPlan):
    """A new ShardedAmps holding (sum_t c_t P_t)|a> of a sharded register
    (ref :552): per shard the in-shard apply of each local group, reading
    the partner shard one exchange per distinct global flip mask brought,
    the global zy bits as a per-shard coefficient sign. Statevector plans
    only; differentiable."""
    from quest_tpu_torch.parallel.mesh import ShardedAmps
    assert not plan.density
    mesh = amps.mesh
    local_n = amps.local_n
    cf = torch.as_tensor(coeffs, dtype=amps.dtype, device=amps.device)
    views = amps.views()
    cfs = [None if v is None else _shard_coeffs(cf, plan, local_n, d,
                                                 v.device)
           for d, v in enumerate(views)]
    outs = [None if v is None else torch.zeros_like(v) for v in views]
    for mask, groups in _by_mask(plan, local_n):
        src = mesh.permute(views, None, mask=mask) if mask else views
        if src is None:
            continue
        for d in mesh.local_ids:
            outs[d] = _apply_groups(src[d], cfs[d], groups, local_n,
                                    out=outs[d])
        del src
    return ShardedAmps(outs, mesh, amps.n)


def plan_stats(all_codes, num_qubits: int, *, density: bool = False) -> dict:
    """Host-side plan introspection (ref :667): term, group and sweep
    counts of the grouped plan beside the per-term baseline's passes;
    with QUEST_EXPEC_FUSION=0 `expec_hbm_sweeps` is the baseline's."""
    codes_key = parse_pauli_sum(all_codes, num_qubits)
    plan = plan_expec(codes_key, num_qubits, density=density)
    diag = sum(len(g.terms) for g in plan.groups if not g.x_bits)
    baseline = (1 if density else 2) * plan.num_terms
    fused = fusion_enabled()
    return {
        "terms": plan.num_terms,
        "expec_groups": len(plan.groups),
        "diagonal_terms": diag,
        "expec_hbm_sweeps": len(plan.sweeps) if fused else baseline,
        "baseline_hbm_sweeps": baseline,
        "max_masks_per_sweep": max_masks_per_sweep(),
        "fusion": fused,
    }


def explain(all_codes, num_qubits: int, *, density: bool = False) -> str:
    """The plan as text: one line per sweep with its mask groups."""
    codes_key = parse_pauli_sum(all_codes, num_qubits)
    plan = plan_expec(codes_key, num_qubits, density=density)
    stats = plan_stats(all_codes, num_qubits, density=density)
    of_kind = "density tr(H rho)" if density else "statevec"
    lines = [f"expec plan: {plan.num_terms} terms -> "
             f"{stats['expec_groups']} mask groups -> "
             f"{len(plan.sweeps)} sweeps ({of_kind}; baseline "
             f"{stats['baseline_hbm_sweeps']} passes)"]
    for si, pack in enumerate(plan.sweeps):
        parts = []
        for gi in pack:
            g = plan.groups[gi]
            mask = ("diagonal" if not g.x_bits
                    else "x=" + ",".join(map(str, g.x_bits)))
            parts.append(f"{mask}({len(g.terms)}t)")
        lines.append(f"  sweep {si}: " + "  ".join(parts))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pauli-sum observable spec (ref :718-800)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PauliSum:
    """Value-hashable Pauli sum: `codes` an (M, num_qubits) nested tuple
    of codes (0=I 1=X 2=Y 3=Z), `coeffs` the M real weights. Build it
    with `PauliSum.of(...)`, which validates and normalises."""
    codes: Tuple[Tuple[int, ...], ...]
    coeffs: Tuple[float, ...]

    @classmethod
    def of(cls, all_codes, coeffs, num_qubits: int) -> "PauliSum":
        codes_key = parse_pauli_sum(all_codes, num_qubits)
        cf = np.asarray(coeffs, dtype=np.float64).reshape(-1)
        if len(cf) != len(codes_key):
            val.err("Invalid Pauli sum: must give exactly one "
                    "coefficient per term.")
        return cls(codes=codes_key, coeffs=tuple(float(c) for c in cf))

    @property
    def num_qubits(self) -> int:
        return len(self.codes[0]) if self.codes else 0

    def plan_stats(self, density: bool = False) -> dict:
        return plan_stats(self.codes, self.num_qubits, density=density)


def batched_reducer(spec: PauliSum, num_qubits: int, density: bool = False):
    """(B, 2, ...) planes -> (B,) f64 expectations on their device: the
    per-state grouped reduction, cached by spec value and the co-ride
    budget (a QUEST_EXPEC_MAX_MASKS flip resolves to a fresh plan)."""
    return _batched_reducer_cached(spec, num_qubits, density,
                                   max_masks_per_sweep())


@functools.lru_cache(maxsize=128)
def _batched_reducer_cached(spec: PauliSum, num_qubits: int, density: bool,
                            max_masks: int):
    plan = _plan_cached(spec.codes,
                        2 * num_qubits if density else num_qubits,
                        density, max_masks)
    coeffs = np.asarray(spec.coeffs, dtype=np.float64)

    def reduce(planes_b: torch.Tensor) -> torch.Tensor:
        cf = torch.as_tensor(coeffs, dtype=planes_b.dtype,
                             device=planes_b.device)
        with torch.no_grad():
            return torch.stack([expec_traced(a, cf, plan)
                                for a in planes_b])

    return reduce


def resolve_observable(spec, num_qubits: int, density: bool = False):
    """A `PauliSum` (or a (codes, coeffs) pair) as its cached batched
    reducer; a width mismatch fails here."""
    if not isinstance(spec, PauliSum):
        if isinstance(spec, tuple) and len(spec) == 2:
            spec = PauliSum.of(spec[0], spec[1], num_qubits)
        else:
            raise TypeError(
                f"observable must be a callable, a PauliSum, or a "
                f"(codes, coeffs) pair; got {type(spec).__name__}")
    if spec.num_qubits != num_qubits:
        raise ValueError(
            f"PauliSum is over {spec.num_qubits} qubits but the "
            f"circuit has {num_qubits}")
    return batched_reducer(spec, num_qubits, density)
