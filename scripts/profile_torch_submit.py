"""Host time of one apply submit to quest_tpu_torch's ServeEngine on the
CPU, under three ways of reading the keyed knobs that every submit's
program key carries (env.engine_mode_key):

  encoded   the port's read: the interpreter's encoded environment, each
            raw value's parse kept (env.engine_mode_key as shipped);
  public    os.environ.get per knob, with the same parse cache;
  per_knob  env.knob_current per knob, parsed on every call.

Each variant is timed alone (microseconds a call) and inside
ServeEngine.submit (microseconds a submit, the requests held queued so
no dispatch runs while the loop is timed). The variants are interleaved
`--reps` times; min and median are printed as one JSON line.

    python scripts/profile_torch_submit.py [--qubits 10] [--requests 4000]
                                           [--reps 7]
"""
import argparse
import json
import os
import statistics
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quest_tpu_torch import circuit as C  # noqa: E402
from quest_tpu_torch import env  # noqa: E402
from quest_tpu_torch.serve import ServeEngine, metrics  # noqa: E402


def public():
    out = []
    for name in env._KEYED:
        k = env.KNOBS[name]
        if k.current is not None:
            out.append((name, k.current()))
            continue
        raw = os.environ.get(name)
        if raw is None:
            out.append((name, k.default))
            continue
        try:
            value = env._PARSED[(name, raw)]
        except KeyError:
            value = env._PARSED[(name, raw)] = k.parse(raw)
        out.append((name, value))
    return tuple(out)


def per_knob():
    return tuple((name, env.knob_current(name)) for name in env._KEYED)


def submit_us(circ, state, requests):
    with ServeEngine(device="cpu", max_wait_ms=600_000,
                     max_queue=requests + 1, max_batch=requests + 1,
                     registry=metrics.Registry()) as eng:
        eng.submit(circ, state=state)
        t0 = time.perf_counter()
        for _ in range(requests):
            eng.submit(circ, state=state)
        return (time.perf_counter() - t0) / requests * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qubits", type=int, default=10)
    ap.add_argument("--requests", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    torch.set_num_threads(1)
    n = args.qubits
    circ = C.Circuit(n)
    for q in range(n):
        circ.rx(q, 0.1 * (q + 1))
    s = np.random.default_rng(0).standard_normal((2, 1 << n))
    state = torch.from_numpy((s / np.linalg.norm(s)).astype(np.float32))
    variants = {"encoded": env.engine_mode_key, "public": public,
                "per_knob": per_knob}
    assert len({f() for f in variants.values()}) == 1
    call, sub = {}, {}
    try:
        for _ in range(args.reps):
            for name, f in variants.items():
                call.setdefault(name, []).append(
                    min(timeit.repeat(f, number=2000, repeat=3)) / 2000 * 1e6)
                C.engine_mode_key = f
                sub.setdefault(name, []).append(
                    submit_us(circ, state, args.requests))
    finally:
        C.engine_mode_key = variants["encoded"]
    print(json.dumps({
        "qubits": n, "requests": args.requests, "reps": args.reps,
        "keyed_knobs": len(env._KEYED),
        "engine_mode_key_us": {k: {"min": min(v),
                                   "median": statistics.median(v)}
                               for k, v in call.items()},
        "submit_us": {k: {"min": min(v), "median": statistics.median(v)}
                      for k, v in sub.items()}}))


if __name__ == "__main__":
    main()
