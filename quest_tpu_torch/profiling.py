"""Profiling on the card: the per-sweep split of a fused plan's time into
its copy floor and its compute, and where a launch's blocks spend their
cycles.

sweep_dma_report is a port of quest_tpu/profiling.py:198-320; the rest of
that module is not ported yet (ROADMAP A13). segment_phase_report runs
launches through the kernel's COUNTERS build (ops/_build.py: the same
source with -DQUEST_PHASE_COUNTERS) and reads its per-phase cycle
counters; fma_rate measures the fp32 FMA pipe with the same build's
yardstick kernel. Everything here measures on a CUDA device only, with
CUDA events or the SMs' clocks, and raises without one: a time taken on
the CPU says nothing of the kernel.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from quest_tpu_torch import precision
from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops.segment import prepare_segment, segment_sweep
from quest_tpu_torch.state import basis_planes, fused_state_shape

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


if __name__ == "__main__":
    sweep_dma_report(out=sys.stdout)
