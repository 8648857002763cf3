"""Profiling on the card: traces, named regions, counted work and bounds,
the per-stage audit of the cost model, the per-sweep split of a fused
plan's time into its copy floor and its compute, and where a launch's
blocks spend their cycles. A port of quest_tpu/profiling.py:

  * `trace(log_dir)` — context manager capturing a torch.profiler trace
    (CPU and CUDA activities) into a Chrome-trace JSON under `log_dir`
    that TensorBoard's profiler plugin or Perfetto opens;
    `annotated_kernels` reads the device kernels of a named region back
    out of it.
  * `annotate(name, device=None)` — the program's span: a count and
    host seconds by name (`span_totals()`) and, on a CUDA machine, an
    NVTX range on an Nsight timeline, always; while a torch profiler
    runs, also a record_function region on the Kineto timeline and a
    record with its parent, its time.time_ns() bounds and its device
    time from CUDA events (`spans()`, the latest session's). Keep it
    out of hot loops: it is cheap, not free.
  * `op_metrics(fn, *args)` — the work one call of `fn` makes: every
    segment launch, passthrough and XLA-engine program call it makes,
    counted by the rules below ("flops", "bytes accessed" and the H100
    bound "optimal_seconds"). Counted, not measured, and from the port's
    own plan: the reference's values come from XLA's cost analysis and
    are not comparable number for number. Planes on the meta device
    count without running anything (no card needed).
  * `stage_report(n)` — one probe segment per stage family, timed with
    CUDA events against the Hopper cost model (circuit._COST_MODELS).
  * `sweep_dma_report` (ref :198-320), `segment_phase_report` (the
    kernel's COUNTERS build, ops/_build.py: per-phase cycle counters)
    and `fma_rate` (the same build's fp32 FMA yardstick kernel).

The counting rules (stage_flops ... program_bound) are the ones every
bound in PERF.md comes from; chip_smoke.py imports them from here. The
card's rates are the H100 SXM data sheet's. Everything that times runs
on a CUDA device, with CUDA events or the SMs' clocks, and raises
without one unless the caller passes device="cpu" (stage_report then
runs the plain versions and gives no verdict); counting needs no card.

CLI: python -m quest_tpu_torch.profiling [--n N] [--reps R] [--sweeps]
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import socket
import sys
import threading
import time

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.ops import segment as S
from quest_tpu_torch.ops.segment import prepare_segment, segment_sweep
from quest_tpu_torch.state import basis_planes, fused_state_shape

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
TIER_PRODUCTS = {"highest": 1, "high": 3, "default": 1}


# ---------------------------------------------------------------------------
# traces and named regions
# ---------------------------------------------------------------------------


class Trace:
    """What `trace` yields: the profiler while the region runs (`prof`)
    and, once it has exited, the Chrome-trace JSON it wrote (`path`)."""

    def __init__(self, prof):
        self.prof = prof
        self.path = None


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Capture a trace of the region: `with profiling.trace("tr") as t:
    ...`, then t.path. CPU and CUDA activities on the card (device None:
    the card, raising without one); CPU activities only with
    device="cpu". The file is `<host>_<pid>.<ns>.pt.trace.json` under
    `log_dir`, the name TensorBoard's profiler plugin lists."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        _SPANS.new_session()
        rec = Trace(prof)
        yield rec
    rec.path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                     f".{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(rec.path)


# ---------------------------------------------------------------------------
# spans: the program's named regions, their totals and their records
# ---------------------------------------------------------------------------

# span records kept of a profiler session: the newest; older ones are
# counted as dropped
SPAN_BUFFER = 1 << 16


def _profiler_on() -> bool:
    # torch's own flag: set while any thread's profiler runs
    # (profiling.trace, any torch.profiler.profile)
    return torch.autograd.profiler._is_profiler_enabled


class _SpanStore:
    """The process's span totals (name -> [calls, host seconds]) and the
    records of its latest profiler session: the newest `capacity`, with
    the count of older ones dropped. A session starts at
    `profiling.trace` and at the first span that ends under a profiler
    after one ended without it; its start forgets the records before."""

    _GUARDED_BY = {"_lock": ("_totals", "_records", "_dropped", "_live")}

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._totals = {}
        self._records = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._live = False

    def add(self, name: str, seconds: float, record, profiling: bool
            ) -> None:
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                self._totals[name] = [1, seconds]
            else:
                t[0] += 1
                t[1] += seconds
            if not profiling:
                self._live = False
            elif not self._live:
                self._records.clear()
                self._dropped = 0
                self._live = True
            if record is not None:
                if len(self._records) == self._records.maxlen:
                    self._dropped += 1
                self._records.append(record)

    def new_session(self) -> None:
        """Forget the records: a profiler session starts."""
        with self._lock:
            self._records.clear()
            self._dropped = 0
            self._live = True

    def snapshot(self):
        """(totals, records, dropped) as they stand."""
        with self._lock:
            return ({k: tuple(v) for k, v in self._totals.items()},
                    list(self._records), self._dropped)

    def reset(self, capacity: int) -> None:
        with self._lock:
            self._totals = {}
            self._records = collections.deque(maxlen=capacity)
            self._dropped = 0
            self._live = False


_SPANS = _SpanStore(SPAN_BUFFER)
_OPEN = threading.local()          # .names: this thread's open spans


class _Record:
    """One span opened while a profiler ran: its record_function region
    and, on a CUDA device, its timing events on the device's current
    stream; `as_dict()` is what `spans()` returns, its device time
    resolved on first read."""

    __slots__ = ("name", "parent", "depth", "thread", "t0_ns", "t1_ns",
                 "region", "stream", "events", "device_ms")

    def __init__(self, name: str, names: list, device):
        self.name = name
        self.parent = names[-1] if names else None
        self.depth = len(names)
        self.thread = threading.get_ident()
        self.device_ms = self.events = self.stream = None
        self.t1_ns = 0
        self.t0_ns = time.time_ns()
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.region = torch.profiler.record_function(name)
        self.region.__enter__()

    def close(self) -> None:
        self.region.__exit__(None, None, None)
        self.region = None
        if self.events is not None:
            self.events[1].record(self.stream)
            self.stream = None
        self.t1_ns = time.time_ns()

    def as_dict(self) -> dict:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self.events = None
        return {"name": self.name, "parent": self.parent,
                "depth": self.depth, "thread": self.thread,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
                "device_ms": self.device_ms}


class annotate:
    """The program's span: `with profiling.annotate("plan.fused"): ...`.

    Always: one more call and its host seconds in the totals of its
    name (`span_totals()`), and, where CUDA is present, an NVTX range on
    an Nsight timeline. While a torch profiler runs (profiling.trace, or
    any torch.profiler.profile): also a record_function region on the
    Kineto timeline and a record in the span buffer (`spans()`): the
    name, the enclosing span on its thread (`parent`), `t0_ns` / `t1_ns`
    on time.time_ns() (the clock the profiler stamps device operations
    with) and, when `device` is a CUDA device, timing events on its
    current stream at entry and exit: the span's device time, resolved
    when the buffer is read, never at exit (a span does not
    synchronise). Keep it out of per-launch loops: it is cheap, not
    free."""

    __slots__ = ("name", "device", "_t0", "_names", "_rec", "_nvtx")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        names = getattr(_OPEN, "names", None)
        if names is None:
            names = _OPEN.names = []
        self._names = names
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rec = (_Record(self.name, names, self.device)
                     if _profiler_on() else None)
        names.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self._t0
        self._names.pop()
        rec = self._rec
        if rec is not None:
            rec.close()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        _SPANS.add(self.name, seconds, rec, _profiler_on())
        return False


def device_of(q):
    """The device of register `q`'s planes, as a span's `device`; None
    for a sharded register."""
    return q.amps.device if torch.is_tensor(q.amps) else None


def span_totals() -> dict:
    """{name: {"calls", "seconds"}}: every span of the process so far,
    its calls and summed host seconds, profiler or not. A fused
    program's build (`plan.fused`) splits into its fusion plan
    (`plan.fusion`), sweep plan (`plan.sweep`) and operand upload
    (`plan.upload`); `plan.trotter` and `plan.expec` are the Trotter
    and expectation plans built."""
    totals, _, _ = _SPANS.snapshot()
    return {k: {"calls": c, "seconds": s} for k, (c, s) in totals.items()}


def spans() -> list:
    """The span records of the latest profiler session, in the order
    they ended (see `annotate`), each with its device time in ms
    (`device_ms`, None without a CUDA device); reading them waits for
    the device to reach the last of them."""
    return [r.as_dict() for r in _SPANS.snapshot()[1]]


def spans_dropped() -> int:
    """Span records of the latest session let go for newer ones."""
    return _SPANS.snapshot()[2]


def reset_spans(buffer: int = SPAN_BUFFER) -> None:
    """Forget the totals and records; keep the newest `buffer` records
    from now on."""
    _SPANS.reset(buffer)


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def annotated_kernels(path: str, name: str) -> list:
    """The device kernel events of a trace (`path`, as `trace` wrote it)
    that the region `name` launched: each kernel whose launch call (the
    runtime or driver event of its correlation id) lies inside the
    region's CPU span, and any kernel without such a record that runs
    inside the span. Each is the trace's event dict (name, ts, dur in
    µs). Raises when the region is not in the trace."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == name and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no region {name!r} in {path}")

    def inside(ts):
        return any(lo <= ts <= hi for lo, hi in spans)
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in _LAUNCH_CATS and e.get("ph") == "X"
                and "correlation" in e.get("args", {}) and inside(e["ts"])}
    seen = {e["args"]["correlation"] for e in events
            if e.get("cat") in _LAUNCH_CATS
            and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in launched or (corr not in seen and inside(e["ts"])
                                and inside(e["ts"] + e.get("dur", 0))):
            out.append(e)
    return sorted(out, key=lambda e: e["ts"])


# ---------------------------------------------------------------------------
# work accounting for the bound: bytes moved and operations done
# ---------------------------------------------------------------------------


def stage_flops(st, arr, n: int, tier: str = "highest"):
    """(fp32 operations, bf16 tensor-core operations) a stage needs on a
    2^n state (only where its predicates select): a b0/b1/scb stage at
    HIGH or DEFAULT does its products as the tier's bf16 products (3 or
    1 per real product), everything else fp32."""
    amps = float(1 << n)
    if isinstance(st, BP.MatStage):
        sel = amps / (1 << (len(st.lane_preds) + len(st.row_preds)))
        per_mac = 4 if st.real_only else 8   # complex MAC: 4 mul + 4 add
        work = sel * st.dim * per_mac
        if tier != "highest" and S.rounds(st):
            return 0.0, work * TIER_PRODUCTS[tier]
        return work, 0.0
    return _elementwise_flops(st, arr, amps), 0.0


def _elementwise_flops(st, arr, amps: float) -> float:
    """fp32 operations of a stage that is not a matrix contraction."""
    if isinstance(st, BP.PhaseStage):
        bits = bin(int(arr[0, 2])).count("1") + bin(
            int(arr[0, 4]) | (int(arr[0, 5]) << 15)).count("1")
        return amps / (1 << bits) * 6        # one complex multiply
    if isinstance(st, BP.ParityStage):
        return amps * 6
    if isinstance(st, BP.PairStage):
        # 4 complex MACs per amplitude: the 2x2 cores, however packed
        sel = amps / (1 << (len(st.lane_preds) + len(st.row_preds)))
        return sel * 4 * (4 if st.real_only else 8)
    if isinstance(st, BP.DiagVecStage):
        sel = amps / (1 << (len(st.lane_preds) + len(st.row_preds)))
        return sel * 6                       # one complex multiply
    if isinstance(st, BP.BatchSelStage):
        return amps * 2 * 8                  # 2 complex MACs per amplitude
    return amps * (len(st.forms) + 2 + 6)   # angle sum, sincos, multiply


MOVED_ROWS_MAX_BITS = 24       # moved_rows enumerates at most 2^24 rows


def moved_rows(seg) -> int:
    """Rows (of 128 amplitudes) of a state that one launch of `seg` must
    read and write: every row, but for a segment of phase stages only the
    rows where some stage's row predicate holds (no other row holds an
    amplitude it changes), counted over the bits the predicates name."""
    rows = 1 << (seg.n - 7)
    if not seg.stages or not all(isinstance(st, BP.PhaseStage)
                                 for st in seg.stages):
        return rows
    preds = [(int(a[0, 4]) | (int(a[0, 5]) << 15),
              int(a[0, 6]) | (int(a[0, 7]) << 15)) for a in seg.arrays]
    bits = [b for b in range(seg.n - 7)
            if any(rm >> b & 1 for rm, _ in preds)]
    if len(bits) > MOVED_ROWS_MAX_BITS:
        return rows
    v = np.arange(1 << len(bits), dtype=np.int64)
    vals = np.zeros_like(v)
    for k, b in enumerate(bits):
        vals |= ((v >> k) & 1) << b
    hit = np.zeros(v.shape, bool)
    for rm, rw in preds:
        hit |= (vals & rm) == rw
    return int(hit.sum()) << (seg.n - 7 - len(bits))


def segment_work(seg, batch=1):
    """(bytes, fp32 flops, bf16 tensor flops) of one launch over `batch`
    states: each state's rows the launch must move (moved_rows: all of
    them unless it holds phase stages only) read and written once, each
    operand and selection row read once; the stages' operations on every
    state, at the segment's tier."""
    nbytes = (batch * 2 * 2 * 4 * 128 * moved_rows(seg)
              + 4 * seg.ops.numel() + len(seg.slots) * batch * 8 * 4)
    work = [stage_flops(st, a, seg.n, seg.tier)
            for st, a in zip(seg.stages, seg.arrays)]
    return (nbytes, batch * sum(w[0] for w in work),
            batch * sum(w[1] for w in work))


def xla_item_work(item, n: int):
    """(share of the state read and written, real operations) of one
    ops/apply step on a 2^n state: a plan item (BandOp, DiagItem,
    PassOp) or a flat GateOp. Controls and predicates select a share; a
    band is a Gauss three-product contraction (two for a real operator),
    a matrix four real products (two), a diagonal or phase one complex
    multiply per selected amplitude."""
    amps = float(1 << n)
    if isinstance(item, F.BandOp):
        share = 1.0 / (1 << len(item.preds))
        per_mac = 4 if not np.any(item.gim) else 6
        return share, amps * share * (1 << item.w) * per_mac
    op = item.op if isinstance(item, (F.DiagItem, F.PassOp)) else item
    if op.kind == "parity":
        return 1.0, amps * 6
    if op.kind == "allones":
        share = 1.0 / (1 << len(op.targets))
        return share, amps * share * 6
    share = 1.0 / (1 << len(op.controls))
    if op.kind == "diagonal":
        return share, amps * share * 6
    targets = (M.superop_targets(op.targets, n // 2)
               if op.kind == "superop" else op.targets)
    per_mac = 4 if not np.any(np.imag(op.operand)) else 8
    return share, amps * share * (1 << len(targets)) * per_mac


def xla_item_split(item, n: int, tier: str, rbytes=4):
    """(share, fp32 or fp64 flops, bf16 tensor flops) of one ops/apply
    step: a band's or matrix's products on f32 planes below HIGHEST are
    the tier's bf16 products (TIER_PRODUCTS of them a real product),
    every other operation runs at its planes' precision."""
    share, flops = xla_item_work(item, n)
    op = item if isinstance(item, F.BandOp) else getattr(item, "op", item)
    rounds = isinstance(op, F.BandOp) or op.kind not in (
        "parity", "allones", "diagonal")
    if rbytes != 4 or tier == "highest" or not rounds:
        return share, flops, 0.0
    return share, 0.0, flops * TIER_PRODUCTS[tier]


def passthrough_work(step, batch=1):
    """(bytes, fp32 flops, bf16 tensor flops) of a passthrough
    (circuit.XlaPass) over `batch` f32 states: the selected share read
    and written once; a band or matrix's products at the step's tier."""
    share, flops, tc = xla_item_split(step.item, step.n, step.tier)
    nbytes = batch * share * 2 * 2 * 4 * (1 << step.n)
    return nbytes, batch * flops, batch * tc


def xla_program_work(prog, rbytes=4, batch=1):
    """(state passes, bytes, fp32 or fp64 flops, bf16 tensor flops) of
    one call of a per-gate or banded program (circuit.XlaProgram) over
    `batch` states of `rbytes`-byte planes: a pass is the whole state
    read and written once, a step counting the share it selects."""
    work = [xla_item_split(it, prog.n, prog.tier, rbytes)
            for it in prog.items]
    passes = prog.iters * sum(w[0] for w in work)
    nbytes = passes * batch * 2 * 2 * rbytes * (1 << prog.n)
    return (passes, nbytes, prog.iters * batch * sum(w[1] for w in work),
            prog.iters * batch * sum(w[2] for w in work))


def xla_bound(prog, rbytes=4, batch=1):
    """{passes, bound_ms, bound_by, bytes_ms, ops_ms} of one call of an
    XlaProgram: the larger of the bytes over 3.35 TB/s and the
    operations over their peaks (67 TFLOP/s for fp32 outside the tensor
    cores or fp64 on them, 989 for the tiers' bf16 products)."""
    passes, nbytes, flops, tc = xla_program_work(prog, rbytes, batch)
    ms, by = bound_ms(nbytes, flops, tc)
    return {"passes": passes, "bound_ms": ms, "bound_by": by,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": (flops / FP32_FLOPS_PER_S + tc / BF16_FLOPS_PER_S)
            * 1e3}


def bound_ms(nbytes, flops, tc_flops=0.0):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the
    card's memory rate and the operations over their peaks (fp32 at 67
    TFLOP/s, the tiers' bf16 products at 989)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOPS_PER_S + tc_flops / BF16_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_of(segments, passthroughs=(), repeat=1, batch=1):
    work = ([segment_work(s, batch) for s in segments]
            + [passthrough_work(p) for p in passthroughs])
    return bound_ms(*(repeat * sum(w[k] for w in work) for k in range(3)))


def program_bound(fn):
    """Bound of one call of a FusedProgram: its segments and passthroughs,
    loop_iters times."""
    from quest_tpu_torch.circuit import XlaPass
    passes = [s for s in fn.steps if isinstance(s, XlaPass)]
    return bound_of(fn.segments, passes, fn.loop_iters)


DMA_BOUND_SHARE = 0.15      # adder within 15 % of the floor: copy-bound


def _launch_ms(amps: torch.Tensor, seg, reps: int) -> float:
    """Mean device ms of one launch of `seg` on `amps` over `reps`
    launches after one warm launch (CUDA events)."""
    segment_sweep(amps, seg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        segment_sweep(amps, seg)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sweep_dma_report(n: int = 28, reps: int = 5, circuit=None,
                     iters: int = 1, driver: str = None, nbuf: int = None,
                     device=None, out=None) -> dict:
    """Per-sweep copy-floor vs compute split of a fused plan on the card,
    under `driver` (None: the knobs'; the in-place driver with `nbuf`
    plane slots). For each kernel sweep of the plan it measures

      * the sweep's launch (its stage chain under the driver), and
      * one stage-free launch — the same driver moving the same state
        bytes with an empty stage chain: the plan's copy floor —

    and reports per sweep `total_ms`, the shared `dma_ms` floor and
    `compute_adder_ms = total - dma` (0 at least). A sweep whose adder is
    within DMA_BOUND_SHARE of the floor is copy-bound (the driver hides
    its chain); a large adder says the chain overruns the copy stream.

    Defaults: the flagship circuit (random_circuit(n, 4, seed 7)) at n =
    28, one application. The launches run in place on one |0..0> state
    of n qubits, at the session's matmul tier. Returns the record; prints
    one line per sweep to `out` when given."""
    from quest_tpu_torch.entry import flagship_circuit
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"sweep_dma_report times the CUDA kernel; got "
                         f"device {dev}")
    driver = BP.check_driver(driver)
    nbuf = knob_value("QUEST_FUSED_NBUF") if nbuf is None else nbuf
    tier = precision.matmul_precision()
    circuit = flagship_circuit(n) if circuit is None else circuit
    parts = BP.maybe_sweep(circuit.segment_parts(n) * iters, n, driver=driver)
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=dev)

    def time_launch(stages, arrays):
        seg = prepare_segment(stages, arrays, n, dev, tier=tier,
                              driver=driver, nbuf=nbuf)
        return _launch_ms(amps, seg, reps)

    dma_ms = time_launch((), ())
    rec = {"device": torch.cuda.get_device_name(dev), "n": n, "reps": reps,
           "iters": iters, "driver": driver, "tier": tier,
           "slots": BP.sweep_smem_bytes((), n, driver=driver,
                                        nbuf=nbuf)["slots"],
           "dma_ms": dma_ms, "sweeps": []}
    say = (lambda s: print(f"[sweep_dma_report] {s}", file=out)) if out \
        else (lambda s: None)
    say(f"{rec['device']} n={n} driver={driver} tier={tier}: copy floor "
        f"(stage-free launch) {dma_ms:.3f} ms")
    for i, part in enumerate(parts):
        if part[0] != "segment":
            rec["sweeps"].append({"sweep": i, "kind": "passthrough"})
            say(f"sweep {i}: passthrough (not a kernel launch)")
            continue
        ms = time_launch(part[1], part[2])
        adder = max(0.0, ms - dma_ms)
        bound = adder <= DMA_BOUND_SHARE * dma_ms
        rec["sweeps"].append({"sweep": i, "kind": "kernel",
                              "stages": len(part[1]), "total_ms": ms,
                              "compute_adder_ms": adder, "dma_bound": bound})
        say(f"sweep {i}: {len(part[1])} stages, {ms:.3f} ms, compute adder "
            f"{adder:.3f} ms ({'copy-bound' if bound else 'chain-bound'})")
    del amps
    return rec


# csrc/segment.cu PC_* counters, in order
PHASES = ("slice_wait", "slice_release", "prologue", "chain", "store",
          "block")
PHASE_COUNTERS = 7                # csrc PC_COUNT (the last: blocks)


def _counters_lib() -> ctypes.CDLL:
    lib = _build.load(_build.COUNTERS)
    lib.quest_segment_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.quest_segment_phase_cycles.restype = ctypes.c_int
    lib.quest_fma_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.quest_fma_probe.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def segment_phase_report(amps: torch.Tensor, seg, reps: int = 3) -> dict:
    """Where one launch of `seg` on `amps` (in place, on the card) spends
    its cycles, from the COUNTERS build: per block (thread 32, a compute
    warp), the cycles waiting for operator slices (`slice_wait`), in the
    block barriers that release them and refill their slots
    (`slice_release`), in step prologues (K1/K2: from the end of the
    previous chain until the tile has landed, thread 0's stores and the
    refill they free included; the later steps' refills that thread 0
    issues after the tile lands fall in the chain; K3: from the block's
    start until its tile has landed), in the stage chain (`chain`, which
    holds the slice waits and releases), in K3's stores (`store`, thread
    0's, from the end of the chain until the stores let the block exit;
    0 under K1/K2, whose stores fall in the next prologue) and in the
    whole block (`block`; K3: thread 0's, the stores included); each
    beside its share of `block`. `ms` is the counters build's mean launch
    time over `reps` launches (CUDA events); the counters add a few
    atomics per phase."""
    if amps.device.type != "cuda":
        raise ValueError(f"segment_phase_report reads the card's counters; "
                         f"got device {amps.device}")
    lib = _counters_lib()
    cycles = (ctypes.c_ulonglong * PHASE_COUNTERS)()
    with _build.active(_build.COUNTERS):
        ms = _launch_ms(amps, seg, reps)
        torch.cuda.synchronize()
        _check(lib.quest_segment_phase_cycles(cycles, 1), "counter reset")
        segment_sweep(amps, seg)
        torch.cuda.synchronize()
        _check(lib.quest_segment_phase_cycles(cycles, 1), "counter read")
    blocks = max(1, int(cycles[PHASE_COUNTERS - 1]))
    per_block = {k: cycles[i] / blocks for i, k in enumerate(PHASES)}
    share = {k: per_block[k] / max(1.0, per_block["block"]) for k in PHASES}
    return {"ms": ms, "blocks": blocks, "cycles_per_block": per_block,
            "share_of_block": share}


def fma_rate(device=None, iters: int = 20000, reps: int = 5) -> dict:
    """The fp32 FMA rate the card sustains at its clocks and power limit:
    one block of 256 threads per SM, 128 independent FMA chains a thread
    (the COUNTERS build's yardstick kernel), median of `reps` launches
    (CUDA events). Returns tflops beside the launch's ms."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"fma_rate times the card; got device {dev}")
    lib = _counters_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        _check(lib.quest_fma_probe(out.data_ptr(), sms, iters, stream),
               "fma probe launch")
    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = sorted(times)[len(times) // 2]
    flops = 2.0 * 128 * iters * 256 * sms
    return {"ms": ms, "tflops": flops / ms / 1e9, "sms": sms,
            "iters": iters}



def op_metrics(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once and count its work: every segment
    launch (segment_work), passthrough (passthrough_work) and XLA-engine
    program call (xla_program_work) it makes, by the rules above. Returns
    the reference's keys, "flops" (fp32 and bf16 tensor operations) and
    "bytes accessed", with "optimal_seconds" (the H100 bound), and
    "bound_ms", "bound_by", "fp32_flops", "tensor_flops",
    "segment_launches", "passthroughs" and "xla_calls". When every tensor
    argument lies on the meta device the count is dry: the wrappers
    record and skip the work, so a 30-qubit program counts on any host
    (other tensor code of `fn` must accept meta tensors)."""
    tensors = [a for a in (*args, *kwargs.values()) if torch.is_tensor(a)]
    dry = bool(tensors) and all(t.device.type == "meta" for t in tensors)
    work, counts = [], {"segment": 0, "pass": 0, "xla": 0}

    def record(kind, obj, batch, rbytes):
        counts[kind] += 1
        if kind == "segment":
            work.append(segment_work(obj, batch))
        elif kind == "pass":
            work.append(passthrough_work(obj, batch))
        else:
            work.append(xla_program_work(obj, rbytes, batch)[1:])
        return dry
    S.WORK_RECORDERS.append(record)
    try:
        fn(*args, **kwargs)
    finally:
        S.WORK_RECORDERS.remove(record)
    nbytes, flops, tc = (sum(w[k] for w in work) for k in range(3))
    ms, by = bound_ms(nbytes, flops, tc)
    return {"flops": flops + tc, "bytes accessed": nbytes,
            "optimal_seconds": ms / 1e3, "bound_ms": ms, "bound_by": by,
            "fp32_flops": flops, "tensor_flops": tc,
            "segment_launches": counts["segment"],
            "passthroughs": counts["pass"], "xla_calls": counts["xla"]}


# ---------------------------------------------------------------------------
# the stage report: the cost model's per-stage constants on the card
# ---------------------------------------------------------------------------


def _single_segment(ops, n: int, budgets: BP.Budgets = BP.HOPPER_GEOMETRY):
    """(stages, arrays) of the one kernel segment a probe circuit plans
    into under `budgets` (ref profiling.py:57): the report measures what
    the planner emits, not hand-built stages."""
    from quest_tpu_torch.circuit import flatten_ops
    items = F.plan(flatten_ops(ops, n, False), n, bands=BP.plan_bands(n))
    segs = [p for p in BP.segment_plan(items, n, budgets=budgets)
            if p[0] == "segment"]
    if len(segs) != 1:
        raise RuntimeError(
            f"probe circuit planned into {len(segs)} segments (want 1)")
    return segs[0][1], segs[0][2]


def _stage_cases(n: int):
    """Probe circuits, one per stage family (ref profiling.py:76): a lone
    phase (the copy floor: its compute is tiny, so its time is about one
    pass over the state), a full-width band operator in each band
    position (b0 lanes, b1 the next 7 qubits, scb the scattered bands)
    and the width-1 remainder band (sc) where this n has one."""
    from quest_tpu_torch.circuit import Circuit
    angles = [0.3 + 0.1 * i for i in range(7)]

    def rot_band(ql, w):
        c = Circuit(n)
        for i in range(w):
            c.rx(ql + i, angles[i % 7])
        return c
    cases = [("phase (DMA floor)", Circuit(n).cphase(0.37, 0, 1))]
    kinds = {0: "b0", 1: "b1"}
    for bi, (ql, w) in enumerate(BP.plan_bands(n)):
        label = kinds.get(bi, "sc" if w == 1 else "scb")
        if label not in dict(cases):
            cases.append((label, rot_band(ql, w)))
    return cases


FLOOR_CASE = "phase (DMA floor)"


def stage_report(n: int = None, reps: int = 5, out=None, device=None,
                 check: bool = False) -> dict:
    """Time one launch of each probe segment (_stage_cases) on the card
    and print it beside the Hopper cost model's band (circuit.
    _COST_MODELS, _estimate_ms) with the reference's verdict: OK when
    0.8 lo <= ms <= 1.3 hi, else DRIFT (ref profiling.py:102-195). Each
    case runs on a |0..0> state of n qubits (default 30 on the card,
    where the model's constants are scaled to; 12 on the CPU): one warm
    launch, then `reps` launches between two CUDA events, at the
    session's matmul tier under the knobs' driver; the state is freed
    before the next case allocates its own. Then the copy floor and the
    compute adder of each band case (its time minus the floor's).

    device="cpu" runs the plain versions and says loudly that the times
    are not the card's: every verdict is then "n/a (plain version on the
    CPU)". `check` holds each case's final state against the plain
    version applied as often, recording max_abs_err, max_amp and norm.
    Returns {case: {"measured_ms", "model_lo_ms", "model_hi_ms",
    "verdict", "stages", ...}}; prints to `out` (default stdout).

    CLI: python -m quest_tpu_torch.profiling [--n N] [--reps R]"""
    from quest_tpu_torch.circuit import _cost_model_for, _estimate_ms
    out = out or sys.stdout
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if n is None:
        n = 30 if on_card else 12
    if not BP.usable(n):
        raise ValueError(f"n={n} is below the kernel tier's minimum")
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    model, matched = _cost_model_for(kind)
    tier = precision.matmul_precision()
    driver = BP.check_driver(None)
    print(f"[stage_report] device={dev} kind={kind!r} n={n} reps={reps} "
          f"tier={tier} driver={driver} model=h100 "
          f"({model['provenance']})", file=out)
    if not on_card:
        print("[stage_report] CAUTION: CPU host: the plain PyTorch versions "
              "run instead of the kernel; times exercise the path but are "
              "NOT card constants. Run on the card for the real audit.",
              file=out)
    elif not matched:
        print(f"[stage_report] CAUTION: no cost model for {kind!r}: the "
              f"H100 constants are compared anyway", file=out)
    rec = {}
    for label, circ in _stage_cases(n):
        stages, arrays = _single_segment(circ.ops, n)
        seg = prepare_segment(stages, arrays, n, dev, tier=tier,
                              driver=driver)
        want = None
        if check:
            want = basis_planes(0, n=n, shape=fused_state_shape(n),
                                device=dev)
            for _ in range(reps + 1):
                want = S.segment_sweep_reference(want, seg.stages,
                                                 seg.operands, n,
                                                 tier=seg.tier)
        amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=dev)
        if on_card:
            ms = _launch_ms(amps, seg, reps)
        else:
            segment_sweep(amps, seg)
            t0 = time.perf_counter()
            for _ in range(reps):
                segment_sweep(amps, seg)
            ms = (time.perf_counter() - t0) / reps * 1e3
        lo, hi = _estimate_ms([("segment", stages, arrays)], n, model)
        verdict = ("OK" if lo * 0.8 <= ms <= hi * 1.3 else "DRIFT") \
            if on_card else "n/a (plain version on the CPU)"
        r = rec[label] = {"measured_ms": ms, "model_lo_ms": lo,
                          "model_hi_ms": hi, "verdict": verdict,
                          "stages": [type(s).__name__ for s in stages]}
        if check:
            r["max_abs_err"] = (amps - want).abs().max().item()
            r["max_amp"] = want.abs().max().item()
            r["norm"] = (amps.double() ** 2).sum().item()
        del amps, want      # one live state at a time: two 30-qubit states
        # and the plain version's temporaries would crowd the card
        if on_card:
            torch.cuda.empty_cache()
        print(f"[stage_report] {label:<18} measured {ms:8.3f} ms   model "
              f"[{lo:.3f}, {hi:.3f}] ms   {verdict}", file=out)
    if FLOOR_CASE in rec:
        dma = rec[FLOOR_CASE]["measured_ms"]
        for label, r in rec.items():
            if label != FLOOR_CASE:
                r["compute_adder_ms"] = max(0.0, r["measured_ms"] - dma)
        print(f"[stage_report] DMA floor {dma:.3f} ms; per-stage compute "
              f"adders: " + ", ".join(
                  f"{k}={v['compute_adder_ms']:.3f}" for k, v in rec.items()
                  if "compute_adder_ms" in v), file=out)
    return rec


def _main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m quest_tpu_torch.profiling",
        description=stage_report.__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweeps", action="store_true",
                    help="the per-sweep copy-floor vs compute split "
                         "(sweep_dma_report) instead of the per-stage "
                         "cost-model audit")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions (no verdicts); "
                         "default: the card")
    args = ap.parse_args(argv)
    if args.sweeps:
        sweep_dma_report(n=args.n or 28, reps=args.reps, device=args.device,
                         out=sys.stdout)
    else:
        stage_report(n=args.n, reps=args.reps, device=args.device)


if __name__ == "__main__":
    _main()
