"""Cold-start control for the serving engine: build a workload's programs
before its first request.

A port of quest_tpu/serve/warmup.py. A cold ServeEngine builds each
program on the first request that needs it: plans, packed segments,
operands on the device and, on the card, the first kernel launches.
`warmup()` walks a declared workload up front so the first real request
finds its program built. The port's batched programs take any batch size
(no bucket grid to compile), so each circuit's program is built once and
then run once per distinct batch shape the workload declares; the
returned seconds show what each took.

Standard library only at import time: the serving package imports this
module eagerly.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence


def default_buckets(max_batch: int) -> tuple:
    """Batch sizes to warm for a `max_batch` bound: the powers of two
    below it and the bound itself. The programs take any batch, so these
    are only the shapes warmed; warm the sizes the workload really sends
    where they are known."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(max_batch)
    return tuple(dict.fromkeys(buckets))


def warmup(engine, circuits, buckets: Optional[Sequence[int]] = None,
           density: bool = False, dtype=None,
           kind: Optional[str] = None) -> Dict:
    """Build and run once every program `engine` (a ServeEngine) will
    dispatch for a declared workload.

    `circuits`: the Circuit objects later submitted (programs are cached
    on the instance). `kind`: 'apply' (state= submits), 'traj' (shots=
    submits, always statevector unravelings) or None, which infers per
    circuit: a circuit with noise channels warms its trajectory program,
    a unitary one its batched apply program (shots= is valid on a
    unitary circuit too, so such a workload passes kind='traj').
    `buckets`: declared batch sizes (default: default_buckets of the
    engine's max_batch), mapped through the dispatch rule — apply
    batches run at their size, trajectory batches at
    traj_dispatch_bucket(size, max_batch) — and each distinct size runs
    once. `dtype`: the plane dtype the workload submits (default f32;
    f64 runs the banded items, another program).

    Returns {"programs": {label: seconds}, "plans": {label: plan
    summary}, "plan_cache": counter deltas, "total_s": seconds}, labels
    "c{i}:b{batch}" in order: the build-and-run seconds of each program
    and batch, and for each apply circuit the priced autotuner's verdict
    through the plan cache (engine, total_ms, source)."""
    import numpy as np
    import torch

    from quest_tpu_torch import plan as P
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.serve.admission import RejectedError
    from quest_tpu_torch.serve.engine import traj_dispatch_bucket

    if kind not in (None, "apply", "traj"):
        raise ValueError(f"kind must be 'apply', 'traj' or None (infer per "
                         f"circuit), got {kind!r}")
    if engine.state in ("closed", "failed"):
        raise RejectedError(f"Invalid operation: cannot warm a "
                            f"{engine.state} ServeEngine")
    if buckets is None:
        buckets = default_buckets(engine.max_batch)
    buckets = tuple(dict.fromkeys(int(b) for b in buckets))
    dtype = np.dtype(np.float32 if dtype is None else dtype)
    tdtype = getattr(torch, dtype.name)
    report: Dict[str, float] = {}
    plans: Dict[str, dict] = {}
    stats0 = P.cache_stats()
    t_all = time.perf_counter()
    for i, c in enumerate(circuits):
        c_kind = kind or ("traj" if any(op.kind == "superop"
                                        for op in c.ops) else "apply")
        if c_kind == "apply":
            # price through the persistent plan cache first; an
            # unpriceable circuit still warms its programs
            try:
                pl = engine.plan(c, density=density, dtype=dtype)
                plans[f"c{i}"] = {"engine": pl.engine, "source": pl.source,
                                  "total_ms": pl.cost.get("total_ms")}
            except Exception as e:      # noqa: BLE001 - reported
                print(f"[quest_tpu_torch.serve] warmup could not price "
                      f"circuit c{i}: {e!r}", file=sys.stderr, flush=True)
                plans[f"c{i}"] = {"engine": None, "source": "error",
                                  "total_ms": None}
        else:
            plans[f"c{i}"] = {"engine": None, "source": "unpriced:traj",
                              "total_ms": None}
        n = c.num_qubits * 2 if density else c.num_qubits
        warmed = set()
        for b in buckets:
            if c_kind == "traj":
                b = traj_dispatch_bucket(b, engine.max_batch)
            if b in warmed:
                continue
            warmed.add(b)
            t0 = time.perf_counter()
            if c_kind == "traj":
                fn = T._compiled_traj(c, c.num_qubits, engine.device,
                                      q_engine_name(engine, c))
                fn(torch.zeros((b, fn.num_channels), dtype=torch.float64))
            else:
                fn = c.compiled_batched(b, density=density,
                                        device=engine.device)
                x = torch.zeros((b, 2, 1 << n), dtype=tdtype,
                                device=engine.device)
                x[:, 0, 0] = 1.0
                fn(x)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            report[f"c{i}:b{b}"] = time.perf_counter() - t0
    stats1 = P.cache_stats()
    return {"programs": report, "plans": plans,
            "plan_cache": {k: stats1[k] - stats0[k] for k in stats1},
            "total_s": time.perf_counter() - t_all}


def q_engine_name(engine, circuit) -> str:
    """The trajectory engine `engine` would dispatch `circuit` with (the
    resolution submit() performs)."""
    from quest_tpu_torch import trajectories as T
    return T._resolve_engine(engine.traj_engine, circuit.num_qubits)
