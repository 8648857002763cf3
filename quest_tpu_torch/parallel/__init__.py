"""Distribution: the amplitude axis sharded over a mesh of torch devices.

A port of quest_tpu/parallel (ROADMAP A10, A10c). The mesh is an
explicit list of devices whose entries may repeat (mesh.py), in one
process or spread over the processes of a gloo group
(make_process_mesh): the top log2(D) qubits select the shard, as in the
reference's chunk layout.
The reference's single-controller shard_map becomes one process walking
the shards; its ppermute / all_to_all / psum become copies between shard
tensors through the mesh, counted by the mesh's collective recorder.
comm.py (the planner) and relabel.py (the relabel passes) are the
reference's host math line for line; sharded.py holds the per-gate,
banded, fused (segment kernel on every shard), batched and measured
engines; introspect.py prices their schedules on a dry walk.
"""

from quest_tpu_torch.parallel.mesh import (AmpMesh, ProcessGroupError,
                                           ShardedAmps, make_amp_mesh,
                                           make_process_mesh, shard_planes,
                                           shard_qureg)
from quest_tpu_torch.parallel.sharded import apply_circuit_sharded
from quest_tpu_torch.parallel.introspect import sharded_schedule

__all__ = [
    "AmpMesh",
    "ProcessGroupError",
    "ShardedAmps",
    "apply_circuit_sharded",
    "make_amp_mesh",
    "make_process_mesh",
    "shard_planes",
    "shard_qureg",
    "sharded_schedule",
]
