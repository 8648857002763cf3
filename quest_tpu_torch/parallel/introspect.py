"""Collective-schedule introspection for the sharded engines.

A port of quest_tpu/parallel/introspect.py. The reference reads the
collectives from the StableHLO that XLA lowered for the mesh
(parse_collectives); the port reads them from the mesh's collective
recorder (parallel/mesh.py) on a dry walk of the SAME program: the
engine is built as for a run and walked over 'meta' shards on a dry copy
of the mesh, where every exchange records its kind, crossed bit and
bytes and copies nothing, and no local work runs. So the issued counts
come from the executed code path, never from re-deriving the dispatch
rules, and a 40-qubit, 256-shard schedule prices on a laptop.

`sharded_schedule` and `sharded_measured_schedule` return the
reference's record keys; `comm_matches_hlo` (the reference's key) holds
the comm planner's prediction (parallel/comm.py comm_stats) equal to the
issued schedule. `assert_plan_comm` asserts a plan IR's comm record
equal to it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.parallel import comm as C
from quest_tpu_torch.parallel.mesh import AmpMesh


def _dry_mesh(mesh) -> AmpMesh:
    """A dry mesh of `mesh`'s size (an AmpMesh or a device count)."""
    if isinstance(mesh, AmpMesh):
        return mesh if mesh.dry else mesh.dry_copy()
    return AmpMesh(["meta"] * int(mesh), dry=True)


def issued(prog, batch: int = 0, dtype=np.complex64, **walk) -> dict:
    """The recorder's counts of one dry call of a sharded program at the
    real width of `dtype` (the reference's parse_collectives keys);
    `walk` goes to its dry_walk (a measured program's outcomes=)."""
    rdt = torch.float64 if np.dtype(dtype).itemsize == 16 else torch.float32
    mesh = prog.dry_walk(batch=batch, dtype=rdt, **walk)
    return mesh.recorder.stats(mesh.size)


def _merge_comm(rec: dict, predicted, cinfo: dict, D: int,
                bytes_per_real: int, topo=None) -> None:
    """Fold the comm planner's predicted schedule into a schedule record
    and flag whether it matches the issued one (ref _merge_comm)."""
    if topo is None:
        topo = C.topology(D)
    rec.update(C.comm_stats(predicted, num_devices=D,
                            bytes_per_real=bytes_per_real, topo=topo))
    rec["comm_strategy"] = cinfo.get("strategy", "plain")
    rec["comm_plan_enabled"] = C.plan_enabled()
    rec["comm_topology"] = topo.describe(D)
    rec["comm_matches_hlo"] = (
        rec["comm_collective_permutes"] == rec["collective_permutes"]
        and rec["comm_all_to_alls"] == rec["all_to_alls"]
        and rec["comm_exchanges"] == rec["collective_exchanges"]
        and rec["comm_bytes"] == rec["ici_bytes_per_device"]
        and rec["comm_ici_bytes"] + rec["comm_dci_bytes"]
        == rec["comm_bytes"])


def sharded_schedule(ops: Sequence, n: int, density: bool, mesh,
                     engine: str = "banded", dtype=np.complex64) -> dict:
    """Build the sharded program for a mesh of `mesh`'s size (an AmpMesh
    or a device count), walk it dry, and report its issued exchanges
    beside the comm planner's prediction and the local plan it rides on
    (ref sharded_schedule). `n` counts state qubits (2N on a density
    register); `dtype` sets the bytes per real (complex64: 4)."""
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import sharded as S

    builders = {"banded": S.compile_circuit_sharded_banded,
                "fused": S.compile_circuit_sharded_fused,
                "pergate": S.compile_circuit_sharded}
    if engine not in builders:
        raise ValueError(f"engine must be one of {sorted(builders)}, "
                         f"got {engine!r}")
    dry = _dry_mesh(mesh)
    D = dry.size
    g = dry.global_qubits
    local_n = n - g
    bytes_per_real = precision.real_dtype_of(dtype).itemsize
    prog = builders[engine](ops, n, density, dry)
    rec = issued(prog, dtype=dtype)
    rec.update({"devices": D, "local_qubits": local_n, "global_qubits": g,
                "engine": engine,
                "chunk_bytes": 2 * bytes_per_real * (1 << n) // D})
    topo = C.topology(D)
    ici_b = topo.ici_bits(D) if topo.hierarchical else None
    if engine == "pergate":
        cinfo: dict = {}
        chosen = S.pergate_flat(ops, n, density, local_n, comm_info=cinfo)
        gate_ops = [op for op in chosen if op.kind != "relabel"]
        rec["local_ops"] = sum(1 for op in gate_ops
                               if max(op.targets) < local_n)
        rec["global_ops"] = len(gate_ops) - rec["local_ops"]
        rec["relabel_events"] = len(chosen) - len(gate_ops)
        _merge_comm(rec, C.predict_exchanges_flat(chosen, local_n, ici_b),
                    cinfo, D, bytes_per_real, topo)
        return rec
    fused_bands = S.fused_shard_bands(n, local_n) if engine == "fused" \
        else None
    bands = fused_bands if fused_bands is not None else \
        S._shard_bands(n, local_n)
    sstats: dict = {}
    cinfo = {}
    flat_r = S.engine_flat(ops, n, density, local_n, sched_stats=sstats,
                           bands=bands, comm_info=cinfo)
    rec["scheduler"] = sstats
    items = cinfo.get("items")
    if items is None:
        items = F.plan(flat_r, n, bands=bands)
    _merge_comm(rec, C.predict_exchanges_items(items, local_n, ici_b),
                cinfo, D, bytes_per_real, topo)
    rec["local_band_passes"] = sum(
        1 for it in items if isinstance(it, F.BandOp) and it.ql < local_n)
    rec["global_qubit_items"] = sum(
        1 for it in items if isinstance(it, F.BandOp) and it.ql >= local_n)
    rec["relabel_events"] = sum(1 for op in flat_r if op.kind == "relabel")
    if fused_bands is not None:
        sparts = S.plan_fused_structural(items, local_n)
        sw = BP.sweep_stats(BP.maybe_sweep(sparts, local_n,
                                           driver=prog.driver))
        rec["kernel_segments"] = sum(1 for p in sparts
                                     if p[0] == "segment")
        rec["hbm_sweeps"] = sw["hbm_sweeps"]
        rec["kernel_sweeps"] = sw["kernel_sweeps"]
        rec["sweep_stages"] = sw["sweep_stages"]
    return rec


def sharded_measured_schedule(ops: Sequence, n: int, density: bool, mesh,
                              engine: str = "banded", relabel: bool = None,
                              dtype=np.complex64, outcomes=None) -> dict:
    """The dynamic counterpart (ref sharded_measured_schedule): the
    measured program walked dry, its issued exchanges and reductions
    beside the prediction — stretch items price as the static engines'
    items, each measurement one reduction, a classically controlled
    gate's inner gates at face value — and the per-stretch plan.
    `outcomes` (a run's, one per measurement): the walk and the
    prediction take a classically controlled gate only where its
    conditions held in that run, so the record prices that run."""
    from quest_tpu_torch.ops import fusion as F
    from quest_tpu_torch.parallel import sharded as S

    dry = _dry_mesh(mesh)
    D = dry.size
    g = dry.global_qubits
    local_n = n - g
    bytes_per_real = precision.real_dtype_of(dtype).itemsize
    prog = S.compile_circuit_sharded_measured(ops, n, density, dry,
                                              engine=engine, relabel=relabel)
    rec = issued(prog, dtype=dtype, outcomes=outcomes)
    program = prog.program
    stretches = [el for el in program if el[0] == "stretch"]
    dyn = [el[1] for el in program if el[0] == "dyn"]
    relabel_events = band_passes = kernel_segments = 0
    for el in stretches:
        for it in el[1]:
            if isinstance(it, F.BandOp):
                band_passes += 1
            elif getattr(it, "op", it).kind == "relabel":
                relabel_events += 1
        if el[2] is not None:
            kernel_segments += sum(1 for p in el[2] if p[0] == "segment")
    rec.update({
        "devices": D, "local_qubits": local_n, "global_qubits": g,
        "engine": prog.engine,
        "chunk_bytes": 2 * bytes_per_real * (1 << n) // D,
        "stretches": len(stretches),
        "measurements": sum(1 for op in dyn
                            if op.kind in ("measure", "measure_dm")),
        "classical_ops": sum(1 for op in dyn if op.kind == "classical"),
        "relabel_events": relabel_events,
        "local_band_passes": band_passes,
        "kernel_segments": kernel_segments,
    })
    topo = C.topology(D)
    ici_b = topo.ici_bits(D) if topo.hierarchical else None
    predicted, pred_psums = [], 0
    for el in program:
        if el[0] == "dyn":
            op = el[1]
            if op.kind in ("measure", "measure_dm"):
                pred_psums += 1
            elif outcomes is None or all(int(outcomes[i]) == want
                                         for i, want in op.operand[1]):
                for gop in op.operand[0]:
                    predicted += C.gateop_exchanges(gop, local_n, ici_b)
        else:
            predicted += C.predict_exchanges_items(el[1], local_n, ici_b)
    _merge_comm(rec, predicted, prog.comm_info, D, bytes_per_real, topo)
    rec["comm_all_reduces"] = pred_psums
    rec["comm_matches_hlo"] = (rec["comm_matches_hlo"]
                               and pred_psums == rec["all_reduces"])
    return rec


def assert_plan_comm(plan, ops, n: int, density: bool, mesh,
                     engine: str = "banded") -> dict:
    """A plan IR's comm record asserted equal to the issued schedule of
    the sharded program over `mesh` (ref assert_plan_comm); raises
    AssertionError naming both sides on any drift. Returns the schedule
    record."""
    comm = plan.comm
    if comm is None:
        raise AssertionError(
            "plan carries no comm record (built without devices=)")
    rec = sharded_schedule(ops, n, density, mesh, engine=engine)
    checks = (("comm_exchanges", "collective_exchanges"),
              ("comm_collective_permutes", "collective_permutes"),
              ("comm_all_to_alls", "all_to_alls"),
              ("comm_bytes", "ici_bytes_per_device"))
    for pk, lk in checks:
        if comm[pk] != rec[lk]:
            raise AssertionError(
                f"plan comm prediction drifted from the issued schedule: "
                f"plan.{pk}={comm[pk]} != issued {lk}={rec[lk]} "
                f"(engine={engine}, devices={rec['devices']}, "
                f"strategy plan={comm['comm_strategy']!r} "
                f"issued={rec['comm_strategy']!r})")
    if comm["comm_strategy"] != rec["comm_strategy"]:
        raise AssertionError(
            f"plan comm strategy {comm['comm_strategy']!r} != the issued "
            f"program's {rec['comm_strategy']!r}")
    return rec
