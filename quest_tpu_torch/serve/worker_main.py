"""Process-replica worker: one interpreter, one engine, one pipe.

A port of quest_tpu/serve/worker_main.py. `python -m
quest_tpu_torch.serve.worker_main --fd N` is what a serve.ipc.ReplicaProxy
execs for each replica; fd N is the worker's end of the proxy's
socketpair. Everything hard (coalescing, supervision of the worker
thread, breakers, the watchdog, durable resume) is the ordinary
ServeEngine this module wraps:

  * read the `init` frame (engine keywords with the device, heartbeat
    cadence). On the card: forbid every kernel build in this process,
    load the segment library and the native host library the parent
    built, and create this process's CUDA context. Build a ServeEngine
    over a private Registry and answer `hello`, or `hello` with the
    error (a missing library is the build's BuildError): a boot failure
    is loud, never a hang.
  * rx loop: `submit` frames rebuild value-keyed circuit descriptors
    (cached by digest) and enter the engine with their drawn uniforms;
    each result or error goes back as a `result` frame, every tensor in
    it on the CPU; `cancel` reaps, `drain` round-trips the engine's
    drain, `close` exits.
  * a heartbeat thread ships the engine's health, its registry
    snapshot, the segment kernel's launch counts and, on the card, this
    process's device memory every `heartbeat_s`: the proxy's liveness
    signal and the fleet's scrape feed in one frame.

Rejections of queued requests by a FAILED engine are not forwarded: the
heartbeat reports the state, and the proxy kills, respawns and
resubmits. A parent EOF means the proxy died: close the engine briefly
and exit, so an orphaned worker never outlives its fleet.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
from typing import Optional


def _launch_counts() -> dict:
    """The segment kernel's launch counters of this process (empty when
    no segment program ran here)."""
    seg = sys.modules.get("quest_tpu_torch.ops.segment")
    if seg is None:
        return {}
    sweep = seg.segment_sweep
    return {"launches": sweep.launches,
            "driver_launches": dict(sweep.driver_launches),
            "stage_launches": dict(sweep.stage_launches)}


def _card_memory(device) -> dict:
    """This process's view of the card's memory: free and total bytes,
    and what its caching allocator holds."""
    import torch
    free, total = torch.cuda.mem_get_info(device)
    return {"free": free, "total": total,
            "reserved": torch.cuda.memory_reserved(device),
            "allocated": torch.cuda.memory_allocated(device)}


def _prepare_card(device) -> dict:
    """Forbid kernel builds in this process, load the libraries the
    parent built (a missing one raises the build's error), and create
    the CUDA context; returns the card memory right after."""
    import torch

    from quest_tpu_torch import native
    from quest_tpu_torch.ops import _build
    _build.BUILD_ALLOWED = False
    native.BUILD_ALLOWED = False
    _build.load()
    native.build()          # raises BuildError when the library is missing
    native.load()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    return _card_memory(device)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="quest_tpu_torch serving fleet worker process (spawned "
                    "by serve.ipc.ReplicaProxy)")
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd to the proxy")
    args = ap.parse_args(argv)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM, fileno=args.fd)

    from quest_tpu_torch.serve.ipc import (encode_frame, rebuild_circuit,
                                           recv_frame, to_wire, wire_exc,
                                           write_frame)
    init = recv_frame(sock)
    if init.get("t") != "init":
        return 2
    name = init.get("name", "proc")
    heartbeat_s = float(init.get("heartbeat_s", 0.25))
    engine_kw = dict(init.get("engine_kw", {}))
    wlock = threading.Lock()

    def send(payload: dict) -> None:
        # encoded outside the lock: a heartbeat waits for one write at
        # most, never for a result's serialization
        pieces = encode_frame(payload)
        with wlock:
            write_frame(sock, pieces)

    try:
        import torch
        torch.set_num_threads(1)
        from quest_tpu_torch.serve import metrics as M
        from quest_tpu_torch.serve.admission import (DeadlineExceeded,
                                                     RejectedError)
        from quest_tpu_torch.serve import engine as SE
        device = torch.device(engine_kw.get("device", "cpu"))
        cuda = _prepare_card(device) if device.type == "cuda" else None
        reg = M.Registry()
        eng = SE.ServeEngine(registry=reg, name=name, **engine_kw)
    except BaseException as e:  # noqa: BLE001 - the boot must answer
        send({"t": "hello", "pid": os.getpid(), "error": wire_exc(e)})
        return 1
    send({"t": "hello", "pid": os.getpid(), "error": None, "cuda": cuda})

    stop = threading.Event()

    def hb_main() -> None:
        while not stop.wait(heartbeat_s):
            hb = {"t": "hb", "snapshot": reg.snapshot(),
                  "kernels": _launch_counts()}
            if device.type == "cuda":
                hb["cuda"] = _card_memory(device)
            hb.update(eng.health())
            try:
                send(hb)
            except OSError:
                return

    threading.Thread(target=hb_main, name="ipc-hb", daemon=True).start()

    circuits: dict = {}     # digest -> rebuilt Circuit
    inner: dict = {}        # rid -> the engine's future (for cancel)

    def on_done(rid: int, f) -> None:
        inner.pop(rid, None)
        if f.cancelled():
            return          # a proxy-initiated reap: nothing to report
        exc = f.exception()
        try:
            if exc is None:
                send({"t": "result", "id": rid, "ok": True,
                      "value": to_wire(f.result())})
            elif not (isinstance(exc, RejectedError)
                      and not isinstance(exc, DeadlineExceeded)
                      and eng.state == "failed"):
                # (a FAILED engine's rejections are not sent: the proxy
                # respawns the worker and resubmits)
                send({"t": "result", "id": rid, "ok": False,
                      "error": wire_exc(exc)})
        except OSError:
            pass            # parent gone; the rx loop will EOF out

    def on_submit(msg: dict) -> None:
        rid = msg["id"]
        circ = circuits.get(msg["digest"])
        if circ is None:
            desc = msg.get("circ")
            if desc is None:
                send({"t": "result", "id": rid, "ok": False,
                      "error": RejectedError(
                          f"Invalid operation: worker {name!r} has no "
                          f"circuit for digest {msg['digest'][:12]} and "
                          f"the frame carries none (proxy/worker "
                          f"shipping out of step).")})
                return
            circ = circuits[msg["digest"]] = rebuild_circuit(desc)
        try:
            SE.check_request(msg["state"], msg["shots"],
                             observable=msg["observable"],
                             density=msg["density"],
                             durable_dir=msg["durable_dir"],
                             durable_every=msg["durable_every"])
            uniforms = msg["uniforms"]
            fut = eng._submit(
                circ, state=msg["state"], shots=msg["shots"],
                uniforms=(None if uniforms is None
                          else torch.from_numpy(uniforms)),
                deadline_s=msg["deadline_s"],
                observable=msg["observable"], density=msg["density"],
                durable_dir=msg["durable_dir"],
                durable_every=msg["durable_every"])
        except BaseException as e:  # noqa: BLE001 - a typed reply
            send({"t": "result", "id": rid, "ok": False,
                  "error": wire_exc(e)})
            return
        inner[rid] = fut
        fut.add_done_callback(lambda f, rid=rid: on_done(rid, f))

    while True:
        try:
            msg = recv_frame(sock)
        except (EOFError, OSError):
            # the proxy died: never outlive the fleet
            stop.set()
            eng.close(timeout_s=5.0)
            return 0
        t = msg.get("t")
        if t == "submit":
            on_submit(msg)
        elif t == "cancel":
            f = inner.get(msg["id"])
            if f is not None and f.cancel():
                eng.reap_cancelled()
        elif t == "drain":
            try:
                eng.drain(timeout_s=msg.get("timeout_s"))
                send({"t": "drained", "id": msg["id"], "ok": True})
            except BaseException as e:  # noqa: BLE001 - a typed reply
                send({"t": "drained", "id": msg["id"], "ok": False,
                      "error": wire_exc(e)})
        elif t == "close":
            stop.set()
            try:
                eng.close(timeout_s=msg.get("timeout_s"))
            finally:
                try:
                    send({"t": "closed"})
                except OSError:
                    pass
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
