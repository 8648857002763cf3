#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --upto stages   # build + per-stage checks only

Drives quest_tpu_torch (never JAX, never quest_tpu) on the card:

  1. prints the card's name and power limit (nvidia-smi) and builds the
     segment kernel (csrc/segment.cu) for sm_90a from the checkout;
  2. per-stage check at 20 qubits: one segment per stage kind S1-S7
     (b0; b1 d=128 and d=32; scb d=128/64/4, one real; sc; phase; parity;
     multiphase; a matrix stage with lane and row predicates; a chain),
     plus phase masks above row bit 15 at 23 qubits: kernel against its
     plain PyTorch version on the same inputs, max|diff| <= 1e-5 max|amp|;
  3. the main path: quest_tpu_torch.entry.entry() (28 qubits, RCS depth 4,
     seed 7) through the kernel, with the launch counters (all launches
     and launches per stage kind) set to 0 just before and read just after; compared with the plain path on the card
     (max|diff| <= 1e-4 max|amp|, |1 - norm| <= 1e-4); median of 5 warm
     steps;
  4. the BASELINE config, 30-qubit RCS depth 20 on one card: launch
     count, compared with the plain path on the card (max|diff| <= 1e-4
     max|amp|), norm, median time;
  5. single-stage b0, b1 and scb-128 segments at 28 qubits: kernel, plain
     version, and one torch.matmul call of the same contraction (the
     yardstick; the port never calls it).

Each phase prints one JSON line. Before the last line come the kernels
line {"kernels": [...]} and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0
and no result line is printed. Without a CUDA device it exits 2 at once.
Everything it prints also goes to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
KERNEL_SOURCE = "quest_tpu_torch/csrc/segment.cu"
STAGE_TOL = 1e-5
PATH_TOL = 1e-4
PHASES = ("build", "stages", "flagship", "baseline", "stage_timing")

RECORD = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    RECORD.append(obj)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of `fn` over `reps` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# work accounting for the bound: bytes moved and operations done
# ---------------------------------------------------------------------------


def stage_flops(st, arr, n: int) -> float:
    """fp32 operations a stage needs on a 2^n state (only where its
    predicates select)."""
    from quest_tpu_torch.ops import band_plan as BP
    amps = float(1 << n)
    if isinstance(st, BP.MatStage):
        sel = amps / (1 << (len(st.lane_preds) + len(st.row_preds)))
        per_mac = 4 if st.real_only else 8   # complex MAC: 4 mul + 4 add
        return sel * st.dim * per_mac
    if isinstance(st, BP.PhaseStage):
        bits = bin(int(arr[0, 2])).count("1") + bin(
            int(arr[0, 4]) | (int(arr[0, 5]) << 15)).count("1")
        return amps / (1 << bits) * 6        # one complex multiply
    if isinstance(st, BP.ParityStage):
        return amps * 6
    return amps * (len(st.forms) + 2 + 6)   # angle sum, sincos, multiply


def segment_work(seg):
    """(bytes, flops) of one launch: the state read and written once,
    each operand read once; the stages' operations."""
    nbytes = 2 * 2 * 4 * (1 << seg.n) + 4 * seg.ops.numel()
    flops = sum(stage_flops(st, a, seg.n)
                for st, a in zip(seg.stages, seg.arrays))
    return nbytes, flops


def bound_of(segments):
    nbytes = sum(segment_work(s)[0] for s in segments)
    flops = sum(segment_work(s)[1] for s in segments)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from quest_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    from quest_tpu_torch.ops import segment as S
    S._lib()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "ptxas": ptxas[:12]})


def _random_mat(rng, dim, real=False):
    g = rng.standard_normal((2, dim, dim)) / np.sqrt(dim)
    if real:
        g[1] = 0.0
    return g.astype(np.float32)


def mat_op(rng, kind, dim, bit=-1, real=False, lane_preds=(), row_preds=()):
    """(MatStage, random operand in the planner's packing)."""
    from quest_tpu_torch.ops import band_plan as BP
    return (BP.MatStage(kind, dim, real, tuple(lane_preds), tuple(row_preds),
                        bit), _random_mat(rng, dim, real))


def phase_op(rng, lm, lw, rm, rw):
    """(PhaseStage, (1, 8) operand) for a random unit phase."""
    from quest_tpu_torch.ops import band_plan as BP
    t = np.exp(1j * rng.uniform(0, 2 * np.pi))
    return BP.PhaseStage(), np.array(
        [[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15, rw & 0x7FFF,
          rw >> 15]], np.float32)


def parity_op(rng, lm, rm):
    from quest_tpu_torch.ops import band_plan as BP
    h = rng.uniform(0, np.pi)
    return BP.ParityStage(), np.array(
        [[np.cos(h), np.sin(h), lm, rm & 0x7FFF, rm >> 15, 0, 0, 0]],
        np.float32)


def multiphase_op(rng, terms):
    """terms: (form 'a' | 'p', lane mask, row mask) per row."""
    from quest_tpu_torch.ops import band_plan as BP
    rows = [[rng.uniform(-np.pi, np.pi), lm, rm & 0x7FFF, rm >> 15,
             0, 0, 0, 0] for _, lm, rm in terms]
    return (BP.MultiPhaseStage(tuple(f for f, _, _ in terms)),
            np.array(rows, np.float32))


def stage_cases(rng):
    """(name, n, stages, arrays): single-stage segments of every kind on
    the path, a predicated matrix stage, a chain, and phase masks above
    row bit 15."""
    mat = functools.partial(mat_op, rng)
    phase = functools.partial(phase_op, rng)
    parity = functools.partial(parity_op, rng)
    multiphase = functools.partial(multiphase_op, rng)
    n = 20
    singles = [
        ("b0", mat("b0", 128)),
        ("b1_128", mat("b1", 128)),
        ("b1_32", mat("b1", 32)),
        ("scb_128", mat("scb", 128, bit=6)),
        ("scb_64_real", mat("scb", 64, bit=7, real=True)),
        ("scb_4", mat("scb", 4, bit=11)),
        ("sc", mat("sc", 2, bit=12)),
        ("phase", phase(0b1000001, 0b1, 0b100000000010, 0b100000000000)),
        ("parity", parity(0b110, 0b1000000001001)),
        ("multiphase", multiphase([("a", 0b11, 0), ("p", 0b1000000, 0b10100),
                                   ("a", 0b100, 0b1000000000001),
                                   ("p", 0, 0b11000)])),
        ("b0_preds", mat("b0", 128, lane_preds=((3, 1),),
                         row_preds=((2, 1), (12, 0)))),
        ("scb_4_preds", mat("scb", 4, bit=10, lane_preds=((0, 0),),
                            row_preds=((1, 1),))),
    ]
    cases = [(name, n, [s], [a]) for name, (s, a) in singles]
    chain = [mat("b0", 128), phase(0b10, 0b10, 0b100, 0b100),
             mat("sc", 2, bit=12), parity(0b11, 0b11001),
             mat("scb", 4, bit=9, row_preds=((3, 1),)),
             multiphase([("p", 0b1, 0b1), ("a", 0b10, 0b10000)]),
             mat("b1", 16)]
    cases.append(("chain", n, [s for s, _ in chain], [a for _, a in chain]))
    rm = (1 << 15) | (1 << 3) | 1
    high = [phase(0b1, 0b1, rm, (1 << 15) | 1), parity(0b10, rm),
            multiphase([("a", 0, 1 << 15), ("p", 0b100, 1 << 15)])]
    cases.append(("row_bit_15", 23, [s for s, _ in high], [a for _, a in high]))
    return cases


def phase_stages(torch):
    from quest_tpu_torch.ops import segment as S
    rng = np.random.default_rng(20261016)
    worst = 0.0
    results = []
    for name, n, stages, arrays in stage_cases(rng):
        seg = S.prepare_segment(stages, arrays, n, "cuda")
        planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
        amps = torch.from_numpy(planes).cuda()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
        S.segment_sweep(amps, seg)
        torch.cuda.synchronize()
        err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
        scale = want.abs().max().item()
        rel = err / scale
        results.append({"case": name, "n": n, "max_abs_err": err,
                        "rel_err": rel, "tile_bits": seg.geometry.tile_bits,
                        "blocks": seg.geometry.blocks})
        if not rel <= STAGE_TOL:
            raise AssertionError(f"stage case {name}: max|diff| {err} > "
                                 f"{STAGE_TOL} x max|amp| {scale}")
        worst = max(worst, rel)
    emit({"phase": "stages", "tol": STAGE_TOL, "worst_rel_err": worst,
          "cases": results})
    return worst


def phase_flagship(torch):
    from quest_tpu_torch.entry import entry
    from quest_tpu_torch.ops import segment as S
    t0 = time.perf_counter()
    fn, (amps,) = entry()
    setup_s = time.perf_counter() - t0
    amps0 = amps.clone()
    S.segment_sweep.launches = 0
    S.segment_sweep.stage_launches = {}
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    stage_launches = dict(S.segment_sweep.stage_launches)
    if launches != fn.launches_per_call or launches == 0:
        raise AssertionError(f"main path launched the segment kernel "
                             f"{launches} times for {fn.launches_per_call} "
                             f"segments")
    planned = {}
    for seg in fn.segments:
        for label in seg.labels:
            planned[label] = planned.get(label, 0) + fn.loop_iters
    if stage_launches != planned:
        raise AssertionError(f"main path launches per stage kind "
                             f"{stage_launches}, planned {planned}")
    want = fn.plain(amps0.clone())
    torch.cuda.synchronize()
    err = (amps - want).abs().max().item()
    scale = want.abs().max().item()
    norm = (amps.double() ** 2).sum().item()
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL):
        raise AssertionError(f"flagship: max|diff| {err} (max|amp| {scale}), "
                             f"norm {norm}")
    if not torch.isfinite(amps).all():
        raise AssertionError("flagship: non-finite amplitudes")
    step_ms = time_ms(torch, lambda: fn(amps), 5)
    plain_ms = time_ms(torch, lambda: fn.plain(amps0), 3)
    bound_ms, bound_by = bound_of(fn.segments)
    kinds = {}
    for seg in fn.segments:
        for st in seg.stages:
            k = getattr(st, "kind", type(st).__name__)
            k = f"{k}{st.dim}" if hasattr(st, "dim") else k
            kinds[k] = kinds.get(k, 0) + 1
    rec = {"phase": "flagship", "n": fn.n, "depth": 4, "segments":
           len(fn.segments), "launches": launches, "max_abs_err": err,
           "rel_err": err / scale, "norm": norm, "median_ms": step_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "setup_s": setup_s, "stages": kinds,
           "stage_launches": stage_launches}
    emit(rec)
    del fn, amps, amps0, want
    torch.cuda.empty_cache()
    return rec


def phase_baseline(torch):
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.ops import segment as S
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    n, depth = 30, 20
    fn = random_circuit(n, depth, seed=7, entangler="cz").compiled_fused(
        n, device="cuda")
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device="cuda")
    # the plain path first (out of place, so no second copy of the 8 GiB
    # input): the kernel is held against it at 30 qubits, the only check
    # of scb d=4 stages inside a plan and of plane 1 starting 2^30 floats in
    want = fn.plain(amps)
    torch.cuda.synchronize()
    S.segment_sweep.launches = 0
    fn(amps)
    torch.cuda.synchronize()
    launches = S.segment_sweep.launches
    if launches != fn.launches_per_call:
        raise AssertionError(f"baseline: {launches} launches for "
                             f"{fn.launches_per_call} segments")
    err = max((amps[p] - want[p]).abs().max().item() for p in range(2))
    scale = want.abs().max().item()
    del want
    norm = (amps.double() ** 2).sum().item()
    if not (err <= PATH_TOL * scale and abs(1.0 - norm) <= PATH_TOL
            and torch.isfinite(amps).all()):
        raise AssertionError(f"baseline: max|diff| {err} (max|amp| "
                             f"{scale}), norm {norm}")
    ms = time_ms(torch, lambda: fn(amps), 3)
    bound_ms, bound_by = bound_of(fn.segments)
    rec = {"phase": "baseline", "n": n, "depth": depth,
           "segments": len(fn.segments), "launches": launches,
           "max_abs_err": err, "rel_err": err / scale, "norm": norm,
           "median_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    del amps
    torch.cuda.empty_cache()
    return rec


def phase_stage_timing(torch):
    """Single-stage segments at 28 qubits: b0, b1, scb-128 and sc (with
    one complex64 torch.matmul in the stage's frame as the yardstick),
    phase, parity and an 8-term multiphase (no single library call)."""
    from quest_tpu_torch.ops import segment as S
    n = 28
    rng = np.random.default_rng(7)
    planes = torch.from_numpy(
        rng.standard_normal((2, 1 << n)).astype(np.float32)).cuda()
    planes /= planes.double().pow(2).sum().sqrt().float()
    # (name, (stage, operand), first qubit of the contracted bits or None)
    cases = [("b0", mat_op(rng, "b0", 128), 0),
             ("b1", mat_op(rng, "b1", 128), 7),
             ("scb128", mat_op(rng, "scb", 128, bit=7), 14),
             ("sc", mat_op(rng, "sc", 2, bit=20), 27),
             ("phase", phase_op(rng, 0b1, 0b1, 1 << 20, 1 << 20), None),
             ("parity", parity_op(rng, 0b11, 1 << 20), None),
             ("multiphase", multiphase_op(
                 rng, [("a" if k % 2 else "p", 1 << (k % 7), 1 << (2 * k + 5))
                       for k in range(8)]), None)]
    out = []
    for name, (st, arr), q0 in cases:
        seg = S.prepare_segment([st], [arr], n, "cuda")
        amps = planes.clone()
        want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
        S.segment_sweep(amps, seg)
        torch.cuda.synchronize()
        err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
        if not err <= STAGE_TOL * want.abs().max().item():
            raise AssertionError(f"28q {name}: max|diff| {err}")
        del want
        ms = time_ms(torch, lambda: S.segment_sweep(amps, seg), 5)
        plain_ms = time_ms(torch, lambda: S.segment_sweep_reference(
            amps, seg.stages, seg.operands, n), 3)
        lib_ms = None
        if q0 is not None:
            # yardstick: out[a, i, b] = sum_j G[i, j] x[a, j, b] as one
            # complex64 matmul (b0/b1/scb-128 store G^T, sc stores G)
            d = st.dim
            x = torch.complex(amps.reshape(2, -1)[0], amps.reshape(2, -1)[1])
            x = x.reshape(1 << (n - q0 - d.bit_length() + 1), d, 1 << q0)
            gt = arr if st.kind != "sc" else arr.transpose(0, 2, 1)
            g = torch.from_numpy(gt[0].T + 1j * gt[1].T).to(
                torch.complex64).cuda()
            if q0 == 0:
                x = x.reshape(-1, d)
                lib_ms = time_ms(torch, lambda: torch.matmul(x, g.T), 5)
            else:
                lib_ms = time_ms(torch, lambda: torch.matmul(g, x), 5)
            del x
        bound_ms, bound_by = bound_of([seg])
        out.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": err})
        del amps
        torch.cuda.empty_cache()
    emit({"phase": "stage_timing", "n": n, "stages": out})
    return out


REPLACES = {
    "segment_sweep": "quest_tpu/ops/pallas_band.py:1715",
    "b0": "quest_tpu/ops/pallas_band.py:1135",
    "b1": "quest_tpu/ops/pallas_band.py:1139",
    "scb128": "quest_tpu/ops/pallas_band.py:1156",
    "sc": "quest_tpu/ops/pallas_band.py:1213",
    "phase": "quest_tpu/ops/pallas_band.py:1256",
    "parity": "quest_tpu/ops/pallas_band.py:1273",
    "multiphase": "quest_tpu/ops/pallas_band.py:1289",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upto", choices=PHASES, default=PHASES[-1],
                    help="stop after this phase (default: run all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # the port must be importable before anything is printed: run from a
    # directory without it, the script fails here and prints no result
    import quest_tpu_torch  # noqa: F401
    last = PHASES.index(args.upto)
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    phase_build()
    if last >= PHASES.index("stages"):
        phase_stages(torch)
    kernels = []
    if last >= PHASES.index("flagship"):
        fl = phase_flagship(torch)
        kernels.append({
            "name": "segment_sweep", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES["segment_sweep"], "launches": fl["launches"],
            "max_abs_err": fl["max_abs_err"], "ms": fl["median_ms"],
            "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
            "bound_by": fl["bound_by"], "library_ms": None})
    if last >= PHASES.index("baseline"):
        phase_baseline(torch)
    if last >= PHASES.index("stage_timing"):
        for rec in phase_stage_timing(torch):
            # launches of the flagship step whose segment holds the stage
            launches = fl["stage_launches"].get(rec["name"], 0)
            if not launches:
                continue        # e.g. sc: no width-1 band at 28 qubits
            kernels.append({
                "name": f"segment_sweep[{rec['name']}]", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[rec["name"]],
                "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    if kernels:
        emit({"kernels": kernels})
    print(smi, flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
