#!/usr/bin/env python3
"""Try to join two ranks on one card with NCCL, and report what happens.

    python3 scripts/nccl_one_card_probe.py      # on a machine with one GPU

The port's process meshes exchange through host buffers over gloo
(quest_tpu_torch/parallel/mesh.py), because NCCL refuses two ranks on one
card. This script checks that claim: it exec-spawns two processes, each
on cuda:0, that meet through a FileStore in a temporary directory, call
torch.distributed.init_process_group("nccl", ...) and all_reduce one
tensor. Each rank is bounded (a timeout on the group, and the parent
kills a rank still running after 90 s). It prints one JSON line per rank
(the exception's type and first lines, or "ok") and the card's name and
power limit; it exits 0 whatever NCCL did.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

RANK_WAIT_S = 90


def rank_main(rank: int, root: str) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    out = {"rank": rank, "torch": torch.__version__,
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        store = dist.FileStore(os.path.join(root, "store"), 2)
        dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["result"] = "ok"
        out["value"] = float(t[0])
    except Exception as e:                  # the finding is the error
        out["result"] = type(e).__name__
        out["error"] = str(e).strip().splitlines()[:6]
    print(json.dumps(out), flush=True)
    os._exit(0)


def main() -> int:
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
    root = tempfile.mkdtemp(prefix="nccl_probe_")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += json.dumps({"result": "killed after "
                               f"{RANK_WAIT_S} s (hung)"})
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else json.dumps(
            {"result": "no record", "tail": out[-2000:]}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
