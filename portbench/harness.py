"""One run of one cell: find its files by name, make its inputs from the
seed, build and warm its program, measure for the window, read the
trace, check what the timed path produced against the reference, and
print the result's line.

A cell is an entry of BENCHMARK.json's "workloads". Its files, found by
name alone:

  configs  the file BENCHMARK.json's "configs" entry names; its "engine"
           names engines/<engine>.py
  mixes/<traffic>.json     the mix's parameters; its "kind" names
                           kinds/<kind>.py (portbench/workloads.py) and
                           its "generator" generators/<generator>.py
                           (portbench/traffic.py)
  limits/<workload>.json   the limit of each number the check compares
  metrics/<metric>.py      the reader of each metric, `read(record)`

A run that compiles the port's kernel library (a checkout's first run)
says so in the result line's "build" key, with nvcc's seconds, which
`setup_s` includes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quest_tpu")
# A traced run traces at most this many seconds of jobs: the quench's
# 30 s hold a million device operations, which took the profiler 50 s to
# stop and read on an H100 host.
TRACE_SECONDS = 10.0


def cache_env(root: Path) -> dict:
    """The environment every run sets before torch loads: the build and
    kernel caches at fixed folders inside the checkout, and one thread for
    the host's BLAS and OpenMP pools."""
    cache = root / "build" / "portbench"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "CUDA_CACHE_PATH": str(cache / "cuda"),
            "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
            "MKL_NUM_THREADS": "1"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    limits = HERE / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        mix=_json(HERE / "mixes" / f"{w['traffic']}.json"),
        # a new cell has none until portbench/readings.py has read them
        limits=_json(limits) if limits.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, name)])


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    from portbench import byname
    return byname.module("metrics", metric).read


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    setup_s: float = 0.0
    plan_s: float = 0.0
    window_s: float = 0.0
    jobs: int = 0
    job_s: list = dataclasses.field(default_factory=list)
    least_s: float = 0.0
    trace: object = None
    probes: dict = dataclasses.field(default_factory=dict)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Laps:
    """Host seconds spent in each stage of a run, for the log."""

    def __init__(self, t_start: float):
        self.last, self.laps = t_start, []

    def lap(self, name: str) -> float:
        now = time.time()
        self.laps.append((name, now - self.last))
        self.last = now
        return self.laps[-1][1]

    def __str__(self):
        return ", ".join(f"{k} {v:.2f}" for k, v in self.laps)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path, t_start: float, device: str = "cuda",
             qubits: int = None, log=sys.stderr) -> dict:
    """Run the cell and return the result (the line's object). `device`
    and `qubits` other than the cell's are for the CPU tests: off the
    card the result carries no metric."""
    laps = Laps(t_start)
    import torch
    from portbench import counting, workloads
    cell = load_cell(name, root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = dict(cell.config, **({"qubits": qubits} if qubits else {}))

    from quest_tpu_torch import precision
    precision.set_matmul_precision(cfg["matmul_tier"])
    job = workloads.make(cfg, cell.mix, seed, dev)
    rec = Record(least_s=counting.least_seconds(job.work))
    laps.lap("start")
    build = None
    if on_card:
        from quest_tpu_torch.ops import _build
        build = {"compiled": False, "seconds": _build.build()}
        laps.lap("library")
    job.build()
    _sync(dev)
    rec.plan_s = laps.lap("plan")
    job.start()
    job.job(keep=False)
    _sync(dev)
    laps.lap("warm")

    prof = phases = None
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
        from torch.profiler import ProfilerActivity, profile
        from portbench.devtrace import Phases
        prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        phases = Phases()
        job.phase = phases.phase
        laps.lap("profiler")

    attempted = failed = 0
    events = []
    t0 = time.perf_counter()
    lo_ns = time.time_ns()
    rec.setup_s = time.time() - t_start
    deadline = t0 + seconds
    while True:
        attempted += 1
        try:
            if on_card:
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
            job.job()
            if on_card:
                b.record()
                events.append((a, b))
        except Exception:
            failed += 1
            traceback.print_exc(file=log)
            break
        if time.perf_counter() >= deadline:
            break
    _sync(dev)
    rec.window_s = time.perf_counter() - t0
    hi_ns = time.time_ns()
    rec.jobs = attempted - failed
    laps.lap("window")
    if prof is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prof.__exit__(None, None, None)
        job.phase = lambda p: contextlib.nullcontext()
        laps.lap("profiler stop")
    rec.job_s = [a.elapsed_time(b) / 1000.0 for a, b in events]
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": cell.chips if on_card else 1,
                   "memory_peak_bytes": int(peak)}

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": device_info}
    if trace:
        from portbench.devtrace import Trace
        rec.trace = Trace(prof, lo_ns, hi_ns, phases.spans)
        print(rec.trace.summary(), file=log)
        laps.lap("trace read")
        rec.probes = job.probes()
        laps.lap("probes")
        device_info["busy_s"] = rec.trace.busy_s()
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    metrics = cell.per_layer if trace else cell.end_to_end
    if on_card:
        for m in metrics:
            value = reader(m["name"])(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
    del prof, rec

    if build is not None:
        # every library this process compiled, the kernel's first use too
        build["compiled"] = _build.BUILDS > 0
        result["build"] = build

    checks = {}
    try:
        out = job.output()
        if on_card:
            torch.cuda.empty_cache()
        nums = job.compare(out)
        checks = {k: {"value": v, "limit": cell.limits.get(k)}
                  for k, v in nums.items()}
        result["correct"] = failed == 0 and all(
            c["limit"] is not None and c["value"] <= c["limit"]
            for c in checks.values())
    except Exception:
        traceback.print_exc(file=log)
    laps.lap("check")
    print(f"seconds: {laps}", file=log)
    result["checks"] = checks
    return result


def report(result: dict, log=sys.stderr, out=sys.stdout) -> None:
    """Each number compared beside its limit as the last lines on
    standard error, and the result as the last line on standard out."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    if not result["checks"]:
        print("check none: the comparison did not run", file=log)
    log.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(argv=None, t_start: float = None) -> int:
    import argparse
    t_start = time.time() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    cell = load_cell(args.workload, root)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=root, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    report(result)
    return 0
