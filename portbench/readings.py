"""The readings each limit of limits/<cell>.json is set from: the numbers
the check compares, for the program over many seeds and for the control
(the reference at TF32 in the program's place) over a few, at the cell's
own size, in one process so the set-up is paid once:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 0] [--jobs 2] [--out readings.jsonl]

Each program seed is a run of the cell (harness.run_cell, without its
metrics' line) with a window of `--seconds` (0: one job after the warm
one), compared as every run compares; each control seed reads out
`--jobs` jobs from the control. One JSON line each. The benchmark's runs
never run this.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def program_reading(cell, seed: int, seconds: float, device,
                    qubits=None) -> dict:
    """The numbers a run of the cell compares: harness.run_cell itself,
    its window `seconds` long (0: one job after the warm one)."""
    from portbench import harness
    result = harness.run_cell(cell.name, seed, seconds, False, root=ROOT,
                              t_start=time.time(), device=device,
                              qubits=qubits)
    if not result["checks"]:
        raise RuntimeError("the comparison did not run")
    return {k: c["value"] for k, c in result["checks"].items()}


def control_reading(cell, seed: int, jobs: int, device, qubits=None) -> dict:
    from portbench import workloads
    cfg = dict(cell.config, **({"qubits": qubits} if qubits else {}))
    job = workloads.make(cfg, cell.mix, seed, device)
    return job.compare(job.control_output(jobs))


def main(argv=None) -> int:
    import argparse
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--jobs", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None
    todo = [("program", int(s)) for s in args.seeds.split(",") if s] + \
        [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for who, seed in todo:
        t = time.perf_counter()
        try:
            if who == "program":
                nums = program_reading(cell, seed, args.seconds, "cuda")
            else:
                nums = control_reading(cell, seed, args.jobs, "cuda")
        except Exception as exc:          # a control that crashes has failed
            nums = {"error": repr(exc)[:300]}
        torch.cuda.empty_cache()
        line = json.dumps({"workload": args.workload, "who": who,
                           "seed": seed, **nums,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    from portbench import harness
    os.environ.update(harness.cache_env(ROOT))
    sys.exit(main())
