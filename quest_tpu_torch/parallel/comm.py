"""Communication planner for the sharded engines — the `sweep_plan` of ICI.

The port's copy of quest_tpu/parallel/comm.py (pure host math, line for
line), so that quest_tpu_torch imports nothing of the JAX package. In
the port the "lowered StableHLO accounting" below is the mesh's
collective recorder (parallel/mesh.py), which counts every copy the
engines issue, and a collective-permute is a pair permute between shard
tensors; `topology()` reads the planned mesh's process count, one host
per process, so an unset QUEST_COMM_TOPOLOGY prices a one-process mesh
flat. The text below is the reference's.

`hbm_sweeps` made the fused engine's HBM traffic a CPU-assertable plan
metric (docs/SWEEPS.md); this module does the same for the interconnect,
which the TPU-pod statevector work identifies as the binding resource at
pod scale (arXiv:2111.10466 — ICI collectives, not FLOPs, bound
distributed throughput). Three pieces, one discipline
(plan -> predict -> assert):

* **routing table** (`matrix_route`) — the single home of the sharded
  engines' per-op communication dispatch (diagonal / one-global-target
  pair exchange / single-qubit butterfly / swap-to-local dance), shared
  by `parallel.sharded._matrix_op` and the predictor below so the
  predicted schedule CANNOT drift from the executed one;

* **reshard coalescing** (`coalesce`) — mpiQulacs-style batched qubit
  reordering (arXiv:2203.16044): defer commuting global-qubit matrix
  work, then move ALL the qubits a stretch needs local in ONE
  `all_to_all` relabel event instead of per-gate exchanges or per-qubit
  SWAPs, choosing per stretch between the a2a and ppermute forms by
  predicted (bytes, collective-steps) cost. `choose_plan` then picks the
  cheapest of {plain, coalesce, relabel-events, lazy} per circuit and
  per engine through the SAME predictor — so the banded engine can never
  select a plan costlier than its incumbent (the lazy-relabel regression
  class, docs/DISTRIBUTED.md), by construction;

* **comm_stats** (`predict_*` / `comm_stats`) — CPU-side predicted
  exchange counts and per-device ICI payload bytes, asserted EQUAL to
  XLA's lowered StableHLO collective accounting
  (`parallel.introspect.parse_collectives`) in tests/test_comm.py and
  inside `bench.py multichip`. Pure host math: a 40q/256-device schedule
  prices on a laptop (scripts/pod_projection.py builds on it).

A fourth piece makes the pricing TOPOLOGY-AWARE (`Topology`,
docs/DISTRIBUTED.md §topology): devices group into hosts — low device
bits stay on intra-host ICI, high bits cross the data-center
interconnect — and every exchange carries the device bit it crosses, so
`comm_stats` splits predicted bytes into `comm_ici_bytes` /
`comm_dci_bytes` and the planner's cost scale weights DCI bytes at
their (slower) link weight. `choose_plan` then prefers plans that
defer, coalesce and cluster DCI-crossing work (`coalesce_clusters`,
the mpiQulacs rank-reordering idea lifted to a cost model:
arXiv:2203.16044; PennyLane-Lightning MPI measures the same
inter-vs-intra-node split dominating past one node, arXiv:2508.13615),
and relabel victims are placed hot-first on ICI device bits (the
lookahead in parallel/relabel.py).

Knobs (quest_tpu_torch/env.py registry, all keyed):

* `QUEST_COMM_PLAN` (default 1): enables the per-circuit plan choice in
  the sharded builders; 0 restores the legacy fixed policies (plain
  per-gate schedule, layer-amortized relabel on banded/fused).
* `QUEST_COMM_TOPOLOGY` (default unset = auto from the mesh's devices:
  one process is one host): 'hosts=H[,ici=X][,dci=Y]' hierarchical link
  model; 0 forces the flat single-tier model, reproducing the
  pre-topology planner bit-for-bit (golden-gated in
  scripts/check_comm_golden.py).
* `QUEST_EXCHANGE_SLICES` (default 1): split each pair exchange into
  this many collective-permute slices so transfer can overlap the local
  compute that consumes it on real ICI (the collective-matmul overlap
  pattern). Structure-verifiable on the CPU mesh; NOT silicon-validated
  — A/B against QUEST_EXCHANGE_SLICES=1 on first chip run, exactly like
  MAX_SWEEP_STAGES.
* `QUEST_EXCHANGE_SLICES_DCI` (default 0 = follow the knob above):
  slice count for exchanges that cross the host boundary — slower
  links want finer slicing (scripts/ab_silicon.py carries the A/B
  leg).

Reference analogue: none. The reference's exchange schedule is implicit
in C control flow (QuEST_cpu_distributed.c:481-509) and fixed: one
full-chunk MPI_Sendrecv per global gate, swap-in/swap-out per relabel
(:1441-1483), nothing planned, predicted, or assertable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# hierarchical mesh topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-tier interconnect model of a 1-D amplitude mesh: `hosts`
    groups of contiguous devices (jax's device order is host-major, and
    the mesh builders keep it — parallel/mesh.py), intra-host links
    weighted `ici`, cross-host links `dci`. With contiguous grouping the
    LOW device-index bits connect chips on one host and the HIGH bits
    cross the data-center interconnect, so a pair exchange over global
    bit j is an ICI event iff j < ici_bits(D). hosts=1 is the flat
    single-tier model — every weight cancels and the planner prices
    exactly as it did before topologies existed (the bit-for-bit
    knob-off contract, scripts/check_comm_golden.py)."""
    hosts: int = 1
    ici: float = 1.0
    dci: float = 4.0

    @property
    def hierarchical(self) -> bool:
        return self.hosts > 1

    def devices_per_host(self, num_devices: int) -> int:
        # a topology naming more hosts than devices degenerates to one
        # device per host: every link crosses DCI
        return max(1, num_devices // min(self.hosts, num_devices))

    def ici_bits(self, num_devices: int) -> int:
        """Device-index bits whose pair exchanges stay intra-host."""
        return self.devices_per_host(num_devices).bit_length() - 1

    def link_of(self, gbit: Optional[int], num_devices: int) -> str:
        """'ici' or 'dci' for an exchange over device bit `gbit`
        (None = an all_to_all touching every bit: 'dci' whenever the
        topology is hierarchical — its payload crosses hosts).
        Delegates to the ONE classifier (_link below) the predictor
        also uses, so planned and lowered link classes cannot drift."""
        if not self.hierarchical:
            return "ici"
        return _link(gbit, self.ici_bits(num_devices))

    def weight(self, link: str) -> float:
        return self.dci if link == "dci" else self.ici

    def describe(self, num_devices: int) -> dict:
        return {"hosts": min(self.hosts, num_devices),
                "ici_weight": self.ici, "dci_weight": self.dci,
                "ici_device_bits": self.ici_bits(num_devices)}


FLAT = Topology(hosts=1, ici=1.0, dci=1.0)


def topology(num_devices: int, mesh=None) -> Topology:
    """The Topology the planner prices `num_devices` with, resolved
    from QUEST_COMM_TOPOLOGY: 0 -> flat; 'hosts=H,ici=X,dci=Y' -> that
    model (hosts clamped to the device count); unset -> one host per
    process of `mesh` (the mesh being planned, or its dry copy) when it
    has `num_devices` shards over several processes, else the flat
    model: a one-process mesh is one host, and host planning without a
    mesh stays flat (ref comm.topology reads jax.devices() process
    ids)."""
    from quest_tpu_torch.env import knob_value
    raw = knob_value("QUEST_COMM_TOPOLOGY")
    if raw == 0:
        return FLAT
    if raw is None:
        hosts = getattr(mesh, "hosts", 1)
        if hosts <= 1 or mesh.size != num_devices or num_devices % hosts:
            return FLAT
        return Topology(hosts=hosts)
    hosts, ici, dci = raw
    return Topology(hosts=min(hosts, num_devices), ici=ici, dci=dci)


# ---------------------------------------------------------------------------
# shared routing table
# ---------------------------------------------------------------------------

def dense_operand(m_pair, k: int) -> Optional[np.ndarray]:
    """The (2^k, 2^k) complex operator of a packed (re, im) operand pair,
    or None when either plane is traced (runtime operands skip structure
    specialization — the engines' existing contract)."""
    if not (isinstance(m_pair[0], np.ndarray)
            and isinstance(m_pair[1], np.ndarray)):
        return None
    dim = 1 << k
    return (np.asarray(m_pair[0]) + 1j * np.asarray(m_pair[1])).reshape(
        dim, dim)


def pair2t_blocks(sup: np.ndarray, jg: int):
    """Split a 4x4 two-target operator by the global index bit `jg` into
    same-block and cross-block 2x2s, plus the input values of the local
    bit each parity's cross-block actually reads (`need`). Shared by
    sharded._pair_exchange_2t and matrix_route, so the engine's
    half-vs-full-chunk exchange decision and the predictor's byte count
    come from one computation."""
    def sub(out_v, in_v):
        rows = [i for i in range(4) if ((i >> jg) & 1) == out_v]
        cols = [j for j in range(4) if ((j >> jg) & 1) == in_v]
        return sup[np.ix_(rows, cols)]

    same = [sub(0, 0), sub(1, 1)]
    cross = [sub(0, 1), sub(1, 0)]
    need = [sorted(set(np.nonzero(np.abs(cross[gv]) > 0)[1].tolist()))
            for gv in (0, 1)]
    return same, cross, need


def matrix_route(sup: Optional[np.ndarray], targets, controls,
                 local_n: int) -> Tuple:
    """Route of ONE matrix op through the sharded engines' distributed
    dispatch (parallel.sharded._matrix_op) — the single home of the
    decision table. Returns one of

      ("local",)                      all targets inside the chunk
      ("diagonal",)                   diagonal operand: rerouted, 0 comm
      ("pair2t", half, t, jg, gbit)   2 targets, 1 global: ONE direct
                                      pair exchange (half chunk when
                                      every cross-block reads <= 1
                                      column, else full chunk)
      ("butterfly", gbit)             single global target: full-chunk
                                      pair exchange
      ("swapdance", gbits)            global targets on device bits
                                      `gbits` swap-to-local and back
                                      (2 half-chunk exchanges each)
    """
    glob = [t for t in targets if t >= local_n]
    if not glob:
        return ("local",)
    if sup is not None and not controls:
        if np.count_nonzero(sup - np.diag(np.diagonal(sup))) == 0:
            return ("diagonal",)
        if len(targets) == 2 and len(glob) == 1:
            jg = list(targets).index(glob[0])
            t = targets[1 - jg]
            if t < local_n:
                _, _, need = pair2t_blocks(sup, jg)
                half = all(len(nd) <= 1 for nd in need)
                return ("pair2t", half, t, jg, glob[0] - local_n)
    if len(targets) == 1:
        return ("butterfly", glob[0] - local_n)
    return ("swapdance", tuple(t - local_n for t in glob))


def route_gateop(op, local_n: int) -> Tuple:
    """matrix_route for a flat GateOp (flattened kinds + relabel).
    Superops must be flattened to doubled-target matrix ops first
    (circuit.flatten_ops) — every sharded builder's input already is."""
    kind = op.kind
    if kind == "relabel":
        return ("relabel",)
    if kind in ("diagonal", "parity", "allones"):
        return ("none",)
    if kind in ("measure", "measure_dm", "classical"):
        raise ValueError(
            f"comm planning applies to static circuits only (got "
            f"kind={op.kind!r}); the dynamic engine prices per stretch "
            "(introspect.sharded_measured_schedule)")
    from quest_tpu_torch import cplx
    sup = dense_operand(cplx.pack(op.operand), len(op.targets))
    return matrix_route(sup, tuple(op.targets), tuple(op.controls), local_n)


# ---------------------------------------------------------------------------
# exchange slicing
# ---------------------------------------------------------------------------

def effective_slices(x: int, link: str = "ici") -> int:
    """Number of collective-permute slices one pair exchange of `x`
    per-plane elements splits into: QUEST_EXCHANGE_SLICES — or, for
    exchanges crossing the host boundary (`link='dci'`),
    QUEST_EXCHANGE_SLICES_DCI when set — clamped to the block (slices
    must divide it; x is a power of two on every engine path, as are
    the validated knobs). The ONE clamp — the engines' sliced ppermutes
    and the predictor both call it, so planned and lowered collective
    counts agree at any knob value and per link class."""
    from quest_tpu_torch.env import knob_value
    s = int(knob_value("QUEST_EXCHANGE_SLICES"))
    if link == "dci":
        sd = int(knob_value("QUEST_EXCHANGE_SLICES_DCI"))
        if sd:
            s = sd
    s = min(s, int(x))
    while x % s:            # non-pow2 x cannot occur today; stay safe
        s >>= 1
    return max(s, 1)


def _link(gbit: Optional[int], ici_bits: Optional[int]) -> str:
    """THE link classifier: exchange over device bit `gbit` when the
    low `ici_bits` device bits are intra-host (ici_bits None = flat:
    everything is ICI; gbit None = an all_to_all touching every bit).
    The predictor's slicing calls it directly and Topology.link_of
    (the engines' entry) delegates here — one implementation, so the
    planned and lowered slice counts cannot desynchronize."""
    if ici_bits is None:
        return "ici"
    if gbit is None:
        return "dci"
    return "ici" if gbit < ici_bits else "dci"


def _route_exchanges(route: Tuple, local_n: int,
                     ici_bits: Optional[int] = None
                     ) -> List[Tuple[str, int, Optional[int]]]:
    """(kind, per-device operand elements, crossed device bit)
    collective list of one routed op: 'cp' = lax.ppermute
    (collective-permute), 'a2a' = lax.all_to_all (bit None — it touches
    every device bit). Elements count BOTH planes of the
    (2, 2^local_n) chunk, mirroring the lowered operand tensors
    parse_collectives sizes. `ici_bits` (Topology.ici_bits) selects the
    per-link slice count — None prices flat, exactly the pre-topology
    schedule."""
    m = 1 << local_n
    tag = route[0]
    if tag in ("local", "none", "diagonal"):
        return []
    if tag == "relabel":
        return [("a2a", 2 * m, None)]
    if tag == "pair2t":
        x = (m // 2) if route[1] else m
        gbit = route[4]
        s = effective_slices(x, _link(gbit, ici_bits))
        return [("cp", 2 * x // s, gbit)] * s
    if tag == "butterfly":
        gbit = route[1]
        s = effective_slices(m, _link(gbit, ici_bits))
        return [("cp", 2 * m // s, gbit)] * s
    # swapdance: one half-chunk exchange in + one out per global target
    x = m // 2
    out: List = []
    for gbit in route[1]:
        s = effective_slices(x, _link(gbit, ici_bits))
        out += [("cp", 2 * x // s, gbit)] * (2 * s)
    return out


def gateop_exchanges(op, local_n: int,
                     ici_bits: Optional[int] = None) -> List:
    return _route_exchanges(route_gateop(op, local_n), local_n, ici_bits)


def predict_exchanges_flat(flat: Sequence, local_n: int,
                           ici_bits: Optional[int] = None) -> List:
    """Collective schedule of a FLAT op list through the per-gate engine
    (compile_circuit_sharded executes exactly one routed op per list
    entry)."""
    out: List = []
    for op in flat:
        out += gateop_exchanges(op, local_n, ici_bits)
    return out


def predict_exchanges_items(items: Sequence, local_n: int,
                            ici_bits: Optional[int] = None) -> List:
    """Collective schedule of a fusion plan (F.plan output) through the
    banded/fused sharded engines: local BandOps and diagonal items never
    communicate; width-1 global BandOps ride the single-qubit routes
    (including the diagonal-2x2 zero-comm reroute); PassOps price as
    their underlying GateOp. The fused engine's kernel segments are
    purely local, so banded and fused share this walk."""
    from quest_tpu_torch.ops import fusion as F
    out: List = []
    for it in items:
        if isinstance(it, F.BandOp):
            if it.ql < local_n:
                continue
            sup = (np.asarray(it.gre, dtype=np.complex128)
                   + 1j * np.asarray(it.gim))
            route = matrix_route(sup, (it.ql,),
                                 tuple(q for q, _ in it.preds), local_n)
            out += _route_exchanges(route, local_n, ici_bits)
            continue
        op = getattr(it, "op", it)
        out += gateop_exchanges(op, local_n, ici_bits)
    return out


def comm_stats(exchanges: Sequence, *, num_devices: int,
               bytes_per_real: int, topo: Optional[Topology] = None
               ) -> dict:
    """The comm_stats record: counts plus per-device ICI payload bytes,
    in EXACTLY parse_collectives' accounting (collective-permutes ship
    their whole operand; an all_to_all ships (D-1)/D of it, floored on
    bytes) — the parity the tests assert. Under a hierarchical `topo`
    the bytes additionally split into `comm_ici_bytes` /
    `comm_dci_bytes` (pair exchanges classify by the device bit they
    cross; an all_to_all ships (dph-1)/D of its operand to same-host
    partners and (D-dph)/D across hosts), with ici + dci == comm_bytes
    EXACTLY (the DCI share floors, ICI takes the remainder) so the
    lowered-HLO parity stays a total-byte equality."""
    topo = topo if topo is not None else FLAT
    d = num_devices
    dph = topo.devices_per_host(d)
    ib = topo.ici_bits(d)
    total = 0
    dci = 0
    cp_n = a2a_n = dci_n = 0
    for k, e, gbit in exchanges:
        b = e * bytes_per_real
        if k == "a2a":
            a2a_n += 1
            total += b * (d - 1) // d
            share = b * (d - dph) // d
            if share:
                dci += share
                dci_n += 1
        else:
            cp_n += 1
            total += b
            if _link(gbit, ib) == "dci" and topo.hierarchical:
                dci += b
                dci_n += 1
    return {
        "comm_collective_permutes": cp_n,
        "comm_all_to_alls": a2a_n,
        "comm_exchanges": cp_n + a2a_n,
        "comm_bytes": int(total),
        "comm_ici_bytes": int(total - dci),
        "comm_dci_bytes": int(dci),
        "comm_dci_exchanges": dci_n,
    }


def _cost(exchanges: Sequence, num_devices: int,
          topo: Optional[Topology] = None) -> Tuple[float, int]:
    """(per-device weighted element-bytes, collective steps) of an
    exchange list — the planner's bytes x steps cost scale. Fractional
    a2a payload (no byte floor): selection is dtype-free. Under a
    hierarchical `topo` each exchange's elements are weighted by its
    link class (an all_to_all splits (dph-1)/D intra-host vs (D-dph)/D
    across hosts), so DCI-crossing work prices at its real relative
    cost; the flat default weights everything 1 and reproduces the
    pre-topology selection exactly."""
    topo = topo if topo is not None else FLAT
    d = num_devices
    dph = topo.devices_per_host(d)
    ib = topo.ici_bits(d)
    w_i, w_d = topo.ici, topo.dci
    total = 0.0
    for k, e, gbit in exchanges:
        if k == "a2a":
            total += e * ((dph - 1) / d * w_i + (d - dph) / d * w_d)
        else:
            total += e * (w_d if (topo.hierarchical
                                  and _link(gbit, ib) == "dci") else w_i)
    return (total, len(exchanges))


# ---------------------------------------------------------------------------
# reshard coalescing
# ---------------------------------------------------------------------------

def _home_order(victims: List[int], tr,
                hot_key=None) -> List[int]:
    """Assign the Belady-chosen victim SET to device bits so any victim
    whose occupant is an owed global logical (local_n + j) lands on its
    HOME bit j: alternating layers then undo each other's permutation
    exactly and the trailing restore costs zero events instead of two
    (measured 8 -> 6 all-to-alls on the deep-global testbed).

    `hot_key` (hierarchical topologies only) orders the NON-home
    victims by their occupant's next use, soonest first, onto the
    lowest free device bits — intra-host ICI under the contiguous host
    grouping — so the qubits the upcoming window touches most stay a
    cheap exchange away while cold qubits absorb the DCI bits (the
    hot-qubit victim rule, docs/DISTRIBUTED.md §topology). None keeps
    the flat planner's original fill order bit-for-bit."""
    g = len(victims)
    order: List[Optional[int]] = [None] * g
    rest = []
    for s in victims:
        j = tr.inv[s] - tr.local_n
        if 0 <= j < g and order[j] is None:
            order[j] = s
        else:
            rest.append(s)
    if hot_key is None:
        for j in range(g):
            if order[j] is None:
                order[j] = rest.pop()
    else:
        rest.sort(key=hot_key)          # soonest next use first
        for j in range(g):              # ascending bit = ICI first
            if order[j] is None:
                order[j] = rest.pop(0)
    return order


def coalesce(flat: Sequence, n: int, local_n: int,
             topo: Optional[Topology] = None) -> List:
    """Rewrite a flat op list so commuting stretches of global-qubit
    matrix work run LOCALLY after one all_to_all relabel event each
    (mpiQulacs-style batched reordering): global-target matrix ops are
    DEFERRED while later ops that structurally commute with them slide
    ahead; when a non-commuting op (or the end) forces a flush, the
    whole pending batch localizes through either

      * ONE relabel event (all g device bits swap with g Belady-chosen
        local slots — (1 - 1/D) of the chunk, one collective), or
      * the engines' per-op exchanges at current positions,

    whichever predicts fewer (bytes, steps) — an isolated global gate
    keeps its single pair exchange; a rotation layer's g global qubits
    share one a2a. A trailing restore returns standard order (at most
    two events + free local swaps, parallel.relabel._PermTracker).

    Where plan_full_relabels walks strictly in program order — on a
    layer that rotates the currently-LOCAL half first it fires TWO
    events per layer (measured 12 events / 1344 B on the deep-global
    testbed) — the deferral here reaches the one-event-per-layer floor
    (6 events / 672 B, tests/test_comm.py goldens). Reordering is
    restricted to structurally-commuting ops (fusion._commutes), the
    same legality rule the gate scheduler uses.

    `topo` (default flat) weights the flush's a2a-vs-per-op decision by
    link class and orders event victims hot-first onto ICI device bits;
    the flat default reproduces the pre-topology rewrite bit-for-bit."""
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import relabel as R

    topo = topo if topo is not None else FLAT
    g = n - local_n
    ici_b = topo.ici_bits(1 << g) if topo.hierarchical else None
    if g == 0 or g > local_n:
        return list(flat)
    R.reject_dynamic_ops(flat, "coalesce")
    if not any(op.kind == "matrix" and any(t >= local_n for t in op.targets)
               for op in flat):
        return list(flat)

    uses = R._uses(flat, n)
    ptr = [0] * n
    out: List = []
    tr = R._PermTracker(n, local_n, out)
    pending: List = []        # (op, nondiag_logical, all_logical)

    def next_use(lq, i):
        u, p = uses[lq], ptr[lq]
        while p < len(u) and u[p] <= i:
            p += 1
        ptr[lq] = p
        return u[p] if p < len(u) else len(flat) + 1

    def route_phys(op):
        """The op's route at CURRENT physical positions."""
        if op.kind != "matrix":
            return ("none",)
        from quest_tpu_torch import cplx
        sup = dense_operand(cplx.pack(op.operand), len(op.targets))
        return matrix_route(sup, tuple(tr.perm[t] for t in op.targets),
                            tuple(tr.perm[c] for c in op.controls),
                            local_n)

    def emit(op):
        out.append(dataclasses.replace(
            op, targets=tuple(tr.perm[t] for t in op.targets),
            controls=tuple(tr.perm[c] for c in op.controls)))

    def flush(i):
        if not pending:
            return
        ops_p = [op for op, _, _ in pending]
        pp: List = []
        paying = 0
        for op in ops_p:
            ex = _route_exchanges(route_phys(op), local_n, ici_b)
            paying += bool(ex)
            pp += ex
        need_local = {t for op in ops_p for t in op.targets}
        slots = [s for s in range(local_n) if tr.inv[s] not in need_local]
        D = 1 << g
        a2a_cost = _cost([("a2a", 2 << local_n, None)], D, topo)
        if (paying >= 2 and len(slots) >= g
                and len(need_local) <= local_n
                and a2a_cost < _cost(pp, D, topo)):
            slots.sort(key=lambda s: next_use(tr.inv[s], i), reverse=True)
            hot = ((lambda s: next_use(tr.inv[s], i))
                   if topo.hierarchical else None)
            tr.emit_relabel(_home_order(slots[:g], tr, hot_key=hot))
        for op in ops_p:
            emit(op)
        pending.clear()

    for i, op in enumerate(flat):
        nd = F._nondiag_qubits(op)
        al = frozenset(op.targets) | frozenset(op.controls)
        if (op.kind == "matrix"
                and route_phys(op)[0] in ("pair2t", "butterfly",
                                          "swapdance")):
            # exchange-paying ops JOIN the batch unconditionally: batch
            # members keep their relative order, so they need not
            # commute with each other — only ops that slide PAST the
            # batch do (the flush below preserves program order)
            pending.append((op, nd, al))
            continue
        if pending and not all(F._commutes(nd, al, pnd, pal)
                               for _, pnd, pal in pending):
            flush(i)
        emit(op)
    flush(len(flat))
    tr.restore()
    return out


# ---------------------------------------------------------------------------
# hot-qubit cluster coalescing (hierarchical topologies)
# ---------------------------------------------------------------------------


def _price_ops(ops, local_n: int, ici_b, D: int, topo: Topology):
    """Weighted cost of already-rewritten ops (PHYSICAL positions):
    relabel events price as their a2a, matrix ops through the shared
    route table — the scale the restore choice below compares on."""
    from quest_tpu_torch import cplx
    ex: List = []
    for op in ops:
        if op.kind == "relabel":
            ex += [("a2a", 2 << local_n, None)]
        elif op.kind == "matrix":
            sup = dense_operand(cplx.pack(op.operand), len(op.targets))
            ex += _route_exchanges(
                matrix_route(sup, tuple(op.targets), tuple(op.controls),
                             local_n), local_n, ici_b)
    return _cost(ex, D, topo)


def _weighted_restore(tr, local_n: int, ici_b, D: int,
                      topo: Topology) -> None:
    """Restore standard order through whichever of the two mechanisms
    predicts cheaper under the topology weights: the event-based
    _PermTracker.restore (at most two a2as + free local swaps — each
    a2a crosses DCI) or a per-qubit SWAP walk (half-chunk exchanges,
    each priced at ITS OWN device bit's link class — often entirely ICI
    when only intra-host bits are misplaced). The flat planner never
    calls this; its restore stays the event form bit-for-bit."""
    from quest_tpu_torch.parallel import relabel as R

    def sim(strategy):
        sink: List = []
        c = R._PermTracker(tr.n, local_n, sink)
        c.perm[:] = tr.perm
        c.inv[:] = tr.inv
        strategy(c)
        return sink

    def swap_walk(c):
        for q in range(c.n):
            while c.perm[q] != q:
                a, b = c.perm[q], q
                if a >= local_n and b >= local_n:
                    # global-global: conjugate through local slot 0
                    # (lazy_relabel_ops' restore idiom)
                    c.emit_swap(a, 0)
                    c.emit_swap(b, 0)
                    c.emit_swap(a, 0)
                else:
                    c.emit_swap(a, b)

    events = sim(lambda c: c.restore())
    swaps = sim(swap_walk)
    chosen = events
    if _price_ops(swaps, local_n, ici_b, D, topo) \
            < _price_ops(events, local_n, ici_b, D, topo):
        chosen = swaps
    for op in chosen:
        if op.kind == "relabel":
            tr.emit_relabel(op.operand)
        else:
            tr.emit_swap(op.targets[0], op.targets[1])


def coalesce_clusters(flat: Sequence, n: int, local_n: int,
                      topo: Topology) -> List:
    """Hot-qubit lookahead rewrite for HIERARCHICAL topologies: defer
    exchange-paying work per qubit CLUSTER (connected components of the
    op stream's qubit-sharing graph, grown op by op) instead of per
    commuting stretch, so all the work one cluster of qubits will ever
    do localizes behind a single exchange for that cluster — a
    DCI-crossing qubit pays its hop ONCE for its whole gate chain
    instead of once per layer.

    Where `coalesce` must flush its whole pending batch the moment ANY
    later op fails to commute with it — on the deep-global testbed
    every layer's trailing entangler does, so every layer pays one
    all_to_all whose (D-dph)/D payload crosses DCI — clusters are
    support-disjoint by construction, so a conflicting op simply JOINS
    its cluster and disjoint clusters keep deferring past it
    (disjoint-support ops always structurally commute, the same
    fusion._commutes legality rule). Each cluster flushes at most once
    (when its qubit set outgrows the chunk, or at the end of the
    stream), localizing through the cheapest of {per-op exchanges, one
    a2a relabel event with hot-ordered victims, one half-chunk SWAP per
    global qubit priced at its own link class} under the topology
    weights; the trailing restore picks event-vs-swap form the same
    way. Measured on the deep-global hosts=2 testbed: 6 DCI-crossing
    a2as (384 B DCI) -> the cluster plan's <= 2 DCI events
    (tests/test_topology.py pins the exact counts;
    scripts/check_comm_golden.py gates the >= 2x byte ceiling).

    Only `choose_plan` calls this, and only under a hierarchical
    topology — the weighted rescoring there is the final arbiter, so a
    cluster plan ships only when the exact cost model prefers it."""
    from quest_tpu_torch import cplx
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import relabel as R

    g = n - local_n
    if g == 0 or g > local_n:
        return list(flat)
    R.reject_dynamic_ops(flat, "coalesce_clusters")
    if not any(op.kind == "matrix" and any(t >= local_n for t in op.targets)
               for op in flat):
        return list(flat)

    D = 1 << g
    ici_b = topo.ici_bits(D)
    uses = R._uses(flat, n)
    ptr = [0] * n
    out: List = []
    tr = R._PermTracker(n, local_n, out)
    clusters: List[dict] = []     # {"qubits": set, "ops": [(op, nd, al)]}

    def next_use(lq, i):
        u, p = uses[lq], ptr[lq]
        while p < len(u) and u[p] <= i:
            p += 1
        ptr[lq] = p
        return u[p] if p < len(u) else len(flat) + 1

    def route_phys(op):
        if op.kind != "matrix":
            return ("none",)
        sup = dense_operand(cplx.pack(op.operand), len(op.targets))
        return matrix_route(sup, tuple(tr.perm[t] for t in op.targets),
                            tuple(tr.perm[c] for c in op.controls),
                            local_n)

    def emit(op):
        out.append(dataclasses.replace(
            op, targets=tuple(tr.perm[t] for t in op.targets),
            controls=tuple(tr.perm[c] for c in op.controls)))

    def flush_cluster(cl, i):
        """Localize one cluster's needed qubits through the cheapest
        weighted mechanism, then emit its ops in arrival order."""
        ops_c = [op for op, _, _ in cl["ops"]]
        need_local = {t for op in ops_c if op.kind == "matrix"
                      for t in op.targets}
        glob_need = sorted(q for q in need_local
                           if tr.perm[q] >= local_n)
        # option A: per-op exchanges at current positions (always legal)
        pp: List = []
        for op in ops_c:
            pp += _route_exchanges(route_phys(op), local_n, ici_b)
        best_cost = _cost(pp, D, topo)
        mechanism = "plain"
        free = [s for s in range(local_n) if tr.inv[s] not in need_local]
        if glob_need and len(need_local) <= local_n:
            if len(free) >= g:
                a2a_cost = _cost([("a2a", 2 << local_n, None)], D, topo)
                if a2a_cost < best_cost:
                    best_cost, mechanism = a2a_cost, "event"
            if len(free) >= len(glob_need):
                sw: List = []
                for q in glob_need:
                    gbit = tr.perm[q] - local_n
                    s = effective_slices(1 << (local_n - 1),
                                         _link(gbit, ici_b))
                    sw += [("cp", (1 << local_n) // s, gbit)] * s
                sw_cost = _cost(sw, D, topo)
                if sw_cost < best_cost:
                    best_cost, mechanism = sw_cost, "swaps"
        if mechanism == "event":
            free.sort(key=lambda s: next_use(tr.inv[s], i), reverse=True)
            tr.emit_relabel(_home_order(
                free[:g], tr, hot_key=lambda s: next_use(tr.inv[s], i)))
        elif mechanism == "swaps":
            for q in glob_need:
                free.sort(key=lambda s: next_use(tr.inv[s], i),
                          reverse=True)
                victim = free.pop(0)
                tr.emit_swap(tr.perm[q], victim)
        for op in ops_c:
            emit(op)

    for i, op in enumerate(flat):
        nd = F._nondiag_qubits(op)
        al = frozenset(op.targets) | frozenset(op.controls)
        hit = [c for c in clusters if c["qubits"] & al]
        pays = (op.kind == "matrix"
                and route_phys(op)[0] in ("pair2t", "butterfly",
                                          "swapdance"))
        if not hit:
            if pays:
                clusters.append({"qubits": set(al), "ops": [(op, nd, al)]})
            else:
                # support-disjoint from every pending cluster: commutes
                # with all deferred work, safe to slide ahead
                emit(op)
            continue
        commutes = all(F._commutes(nd, al, pnd, pal)
                       for c in hit for _, pnd, pal in c["ops"])
        if commutes and not pays:
            emit(op)
            continue
        # join: merge every intersected cluster (their op sets are
        # mutually support-disjoint up to now, so concatenating in
        # cluster-creation order is a legal interleaving), then append
        merged = hit[0]
        for c in hit[1:]:
            merged["qubits"] |= c["qubits"]
            merged["ops"] += c["ops"]
            clusters.remove(c)
        merged["qubits"] |= al
        merged["ops"].append((op, nd, al))
        need = {t for o, _, _ in merged["ops"] if o.kind == "matrix"
                for t in o.targets}
        if len(need) > local_n:
            # the cluster outgrew the chunk: no single localization can
            # host it — flush now (per-op exchanges remain legal)
            flush_cluster(merged, i)
            clusters.remove(merged)
    for cl in clusters:
        flush_cluster(cl, len(flat))
    _weighted_restore(tr, local_n, ici_b, D, topo)
    return out


# ---------------------------------------------------------------------------
# per-circuit, per-engine plan choice
# ---------------------------------------------------------------------------

def plan_enabled() -> bool:
    from quest_tpu_torch.env import knob_value
    return bool(knob_value("QUEST_COMM_PLAN"))


def choose_plan(flat: Sequence, n: int, local_n: int, *,
                engine: str = "banded",
                bands: Optional[Sequence] = None,
                topo: Optional[Topology] = None) -> Tuple[List, dict]:
    """Pick the cheapest rewrite of `flat` among {plain, coalesce,
    relabel-events, lazy — plus hot-qubit clustering under a
    hierarchical topology} by PREDICTED weighted (bytes, steps) through
    the target engine's own pricing: the per-gate engine prices one
    routed op per list entry; the banded/fused engines price the fusion
    plan their run loop executes (F.plan over `bands`). The incumbent
    policy (plain for per-gate, layer-amortized relabel for
    banded/fused) wins ties, so no engine can select a plan costlier
    than what it ran before the planner existed — the lazy-relabel
    banded regression is impossible by construction. `topo` defaults to
    topology(D) (the QUEST_COMM_TOPOLOGY resolution); the flat model
    weights every link 1 and selects exactly the pre-topology plans.
    Returns (chosen list, info dict with the strategy, every
    candidate's predicted cost, and the topology priced under)."""
    from quest_tpu_torch.parallel import relabel as R

    D = 1 << (n - local_n)
    if topo is None:
        topo = topology(D)
    ici_b = topo.ici_bits(D) if topo.hierarchical else None
    cands = {"plain": list(flat)}
    if any(op.kind == "matrix" and any(t >= local_n for t in op.targets)
           for op in flat):
        cands["coalesce"] = coalesce(flat, n, local_n, topo=topo)
        cands["relabel"] = R.plan_full_relabels(flat, n, local_n,
                                                topo=topo)
        cands["lazy"] = R.lazy_relabel_ops(flat, n, local_n)
        if topo.hierarchical:
            cands["hier"] = coalesce_clusters(flat, n, local_n, topo)

    plans: dict = {}

    def score(name, lst):
        if engine == "pergate":
            ex = predict_exchanges_flat(lst, local_n, ici_b)
        else:
            from quest_tpu_torch.ops import fusion as F
            plans[name] = F.plan(lst, n, bands=bands)
            ex = predict_exchanges_items(plans[name], local_n, ici_b)
        return _cost(ex, D, topo)

    incumbent = "plain" if engine == "pergate" else "relabel"
    if incumbent not in cands:
        incumbent = "plain"
    scores = {name: score(name, lst) for name, lst in cands.items()}
    best = incumbent
    for name in ("hier", "coalesce", "relabel", "plain", "lazy"):
        if name in scores and scores[name] < scores[best]:
            best = name
    info = {"strategy": best,
            "candidates": {k: {"elem_bytes": v[0], "exchanges": v[1]}
                           for k, v in scores.items()},
            "topology": topo.describe(D)}
    if best in plans:
        # the winner's fusion plan rides along so the calling engine
        # (and introspect) need not re-run F.plan on the identical
        # input — scoring already paid that O(ops x items) pass
        info["items"] = plans[best]
    return cands[best], info
