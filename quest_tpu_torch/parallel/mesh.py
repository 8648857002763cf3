"""The amplitude mesh: an explicit list of torch devices, the register
split over it, and the recorder of every exchange it issues.

The reference shards the (2, 2^n) planes over a 1-D jax Mesh
(quest_tpu/parallel/mesh.py): shard d of D holds amplitudes
[d 2^n/D, (d+1) 2^n/D), so the top log2(D) qubits select the shard
(QuEST_cpu.c:1280-1312), and D must be a power of two
(QuEST_validation.c:81). Here the mesh is a list of torch devices whose
entries may repeat: 8 shards on 'cpu' in the tests, 4 on one card, or
distinct 'cuda:i' entries on a box with several cards. A sharded register
is a `ShardedAmps`: one contiguous (2, 2^(n - g)) (or (B, 2, 2^(n - g))
for a batch) tensor per shard on that shard's device.

A mesh may span processes (`make_process_mesh`, the reference's
jax.distributed mesh): W processes of a torch.distributed gloo group each
hold L shards, and process r holds the contiguous run of shards
[r L, (r+1) L) on its own devices (`local_ids`, `local_devices`), as the
reference lays a host's slice out. `devices` and a register's `shards`
keep their global length D = W L, with None where another process holds
the shard; no process allocates, reads or copies a shard it does not
hold, except `ShardedAmps.gather`, which all-gathers the whole state to
the host when asked.

The mesh carries the exchanges the engines issue (parallel/sharded.py):

  permute     shard d receives its partner d ^ 2^gbit's block into a new
              buffer on its own device — a device-local copy when the two
              shards share a device, a peer copy between cards, and for a
              partner in another process a copy through a host buffer
              (pinned for a card) and one gloo send and receive; every
              shard receives before any shard writes, so no exchange reads
              a block another shard has already overwritten;
  all_to_all  shard d's k-th block goes to shard k (the relabel event);
              blocks between processes travel in one gloo
              all_to_all_single through host buffers;
  reduce      per-shard partial sums added on the first local shard's
              device, then summed over the processes by one gloo
              all_reduce, so every process holds the total (the psum).

and records each one in its `recorder` (`CollectiveRecorder`): the kind,
the device bit it crosses and the elements one shard sends, in the comm
planner's accounting (parallel/comm.py comm_stats); every process records
the same events. A mesh built with `dry=True` records and copies nothing
(its exchanges return None): the engines walk their program on it to
price a schedule without a state (parallel/introspect.py). A failed
collective, a dead peer or a timeout raises `ProcessGroupError`; no call
goes on with fewer processes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch


class ProcessGroupError(RuntimeError):
    """A multi-process mesh could not do its work: the process group did
    not form (missing or wrong RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT, a failed gloo init), a peer process died, or a
    collective timed out. The call fails; nothing carries on with fewer
    processes."""


class CollectiveRecorder:
    """Every exchange a mesh issued, in order: (kind, elements one shard
    sends, bytes one shard sends, crossed device bit). kind 'cp' is a
    pair permute (bit = the device bit), 'a2a' an all-to-all (bit None;
    the elements are the whole per-shard operand, of which (D-1)/D leave
    the shard) and 'reduce' a reduction (counted apart, as the reference
    counts psums apart from its exchanges)."""

    def __init__(self):
        self.events: List[tuple] = []

    def reset(self) -> None:
        self.events = []

    def record(self, kind: str, elems: int, nbytes: int,
               gbit: Optional[int]) -> None:
        self.events.append((kind, int(elems), int(nbytes), gbit))

    def stats(self, num_devices: int) -> dict:
        """The issued schedule in the keys of the reference's lowered
        accounting (introspect.parse_collectives): counts, the bytes one
        shard sent, and the reductions."""
        cp = [b for k, _, b, _ in self.events if k == "cp"]
        a2a = [b for k, _, b, _ in self.events if k == "a2a"]
        return {
            "collective_permutes": len(cp),
            "all_to_alls": len(a2a),
            "collective_exchanges": len(cp) + len(a2a),
            "ici_bytes_per_device": int(sum(cp) + sum(a2a)),
            "all_reduces": sum(1 for k, *_ in self.events if k == "reduce"),
        }


class AmpMesh:
    """A 1-D mesh of `devices` (a power of two of them, entries may
    repeat) over the amplitude axis, with its collective recorder. With
    `group` (a torch.distributed gloo process group of W processes, each
    passing its own L devices, L equal on every process) the mesh has
    W L shards and this process holds shards [rank L, (rank+1) L)."""

    def __init__(self, devices: Sequence, dry: bool = False, group=None):
        local = tuple(torch.device(d) for d in devices)
        self.group = group
        self.world, self.rank = 1, 0
        if group is not None:
            import torch.distributed as dist
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            backend = str(dist.get_backend(group))
            if backend != "gloo":
                raise ProcessGroupError(
                    f"a process mesh exchanges through host buffers over "
                    f"gloo; the group's backend is {backend!r} (NCCL "
                    f"cannot join two ranks on one card)")
            counts = torch.tensor([len(local), -len(local)],
                                  dtype=torch.int64)
            self._call("the shard count check",
                       lambda: dist.all_reduce(counts, op=dist.ReduceOp.MAX,
                                               group=group))
            most, least = int(counts[0]), -int(counts[1])
            if most != least:
                raise ValueError(
                    f"every process of a process mesh holds the same number "
                    f"of shards; the processes hold {least} to {most}")
        size = len(local) * self.world
        if size < 1 or size & (size - 1):
            raise ValueError(
                f"Invalid number of devices {size}: must be a power of 2 "
                "(ref QuEST_validation.c:81)")
        # the processes the comm planner prices as hosts (comm.topology);
        # a dry copy keeps its source's
        self.hosts = self.world
        self.local_devices = local
        self.lo = self.rank * len(local)
        self.local_ids = range(self.lo, self.lo + len(local))
        self.devices = ((None,) * self.lo + local
                        + (None,) * (size - self.lo - len(local)))
        self.dry = bool(dry)
        self.recorder = CollectiveRecorder()
        # seconds and bytes of the exchanges that crossed processes:
        # copies to the host, the gloo calls, copies back
        self.wire = {"copy_out_s": 0.0, "gloo_s": 0.0, "copy_in_s": 0.0,
                     "bytes_out": 0, "bytes_in": 0, "calls": 0}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def global_qubits(self) -> int:
        return self.size.bit_length() - 1

    def owner(self, d: int) -> int:
        """The process (group rank) holding shard d."""
        return d // len(self.local_devices)

    def is_local(self, d: int) -> bool:
        return self.lo <= d < self.lo + len(self.local_devices)

    @property
    def key(self) -> tuple:
        """The mesh's identity in a program cache key: its device tuple
        (a rebuilt mesh over the same devices finds the same programs; a
        mesh over other devices never does); a process mesh names its
        group's size and this process's rank beside its local devices."""
        names = tuple(_device_name(d) for d in self.local_devices)
        if self.world > 1:
            names = ("world", self.world, "rank", self.rank) + names
        return names + (("dry",) if self.dry else ())

    def dry_copy(self) -> "AmpMesh":
        """A mesh of the same size on 'meta' that records and copies
        nothing (the dry walk of introspect); a process mesh's dry copy
        is one process's, as every process issues the same exchanges,
        priced over the source's processes."""
        dry = AmpMesh(["meta"] * self.size, dry=True)
        dry.hosts = self.hosts
        return dry

    # -- the process group ----------------------------------------------------

    def _call(self, what: str, fn):
        """Run a collective of the group, a failure (a dead peer, a
        timeout, a torn connection) raised as ProcessGroupError."""
        try:
            return fn()
        except ProcessGroupError:
            raise
        except RuntimeError as e:
            raise ProcessGroupError(
                f"{what} failed on process {self.rank} of {self.world} of "
                f"the process mesh: {type(e).__name__}: {e}") from e

    def barrier(self) -> None:
        """Wait for every process of the mesh (nothing on one process)."""
        if self.world > 1:
            import torch.distributed as dist
            self._call("barrier", lambda: dist.barrier(group=self.group))

    def host_all_reduce(self, t: torch.Tensor, op: str = "sum"
                        ) -> torch.Tensor:
        """`t` summed (or maxed) over the processes, a new CPU tensor on
        every process; unrecorded (the engines' psums go through
        `reduce`). One process: a CPU copy of `t`."""
        host = t.detach().to("cpu", copy=True).contiguous()
        if self.world > 1:
            import torch.distributed as dist
            rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            self._call("all_reduce", lambda: dist.all_reduce(
                host, op=rop, group=self.group))
        return host

    def host_all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every process's `t` (equal shapes), CPU tensors in rank
        order."""
        host = t.detach().to("cpu", copy=True).contiguous()
        if self.world == 1:
            return [host]
        import torch.distributed as dist
        out = [torch.empty_like(host) for _ in range(self.world)]
        self._call("all_gather", lambda: dist.all_gather(
            out, host, group=self.group))
        return out

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous CPU tensor holding `t` (pinned for a card's
        tensor; a contiguous CPU tensor is sent as it is)."""
        if t.device.type == "cpu" and t.is_contiguous():
            return t
        buf = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=t.device.type == "cuda")
        buf.copy_(t)
        return buf

    def _host_buffer(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        return torch.empty(like.shape if shape is None else shape,
                           dtype=like.dtype,
                           pin_memory=like.device.type == "cuda")

    def _p2p(self, blocks, cross, bit, recv, out) -> None:
        """The pair exchange's blocks whose partner lives in another
        process: each local d of `cross` sends blocks[d] to shard
        d ^ bit and receives that shard's block, through host buffers
        and one batch of gloo sends and receives (tag: the receiving
        shard)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        sends = {d: self._to_host(blocks[d]) for d in cross}
        rbufs = {d: self._host_buffer(blocks[d]) for d in cross}
        t1 = time.perf_counter()
        ops = []
        for d in cross:
            p = d ^ bit
            ops.append(dist.P2POp(dist.isend, sends[d], self.owner(p),
                                  group=self.group, tag=p))
            ops.append(dist.P2POp(dist.irecv, rbufs[d], self.owner(p),
                                  group=self.group, tag=d))

        def run():
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        self._call("pair exchange", run)
        t2 = time.perf_counter()
        for d in cross:
            dev = self.devices[d]
            if out is None:
                recv[d] = rbufs[d].to(dev, copy=True)
            else:
                recv[d] = out[d].copy_(rbufs[d])
        t3 = time.perf_counter()
        nb = sum(sends[d].numel() * sends[d].element_size() for d in cross)
        self._tally(t1 - t0, t2 - t1, t3 - t2, nb, nb)

    def _tally(self, out_s, wire_s, in_s, nb_out, nb_in) -> None:
        w = self.wire
        w["copy_out_s"] += out_s
        w["gloo_s"] += wire_s
        w["copy_in_s"] += in_s
        w["bytes_out"] += nb_out
        w["bytes_in"] += nb_in
        w["calls"] += 1

    # -- exchanges ----------------------------------------------------------

    def permute(self, blocks: Sequence, gbit: int, out: Sequence = None,
                mask: int = None):
        """Pair exchange over device bit `gbit`: shard d receives
        blocks[d ^ 2^gbit] (a tensor or a view on that shard's device)
        into a new contiguous buffer on its own device, or into out[d]
        when given; returns the received list (None on a dry mesh;
        entries None for the shards another process holds, whose blocks
        are None too). Every shard receives before the caller writes
        anything, so the copies never read an overwritten block. `mask`
        (gbit None) pairs d with d ^ mask over several device bits at
        once, the Pauli flip exchange of the expectation engines (ref
        ops/expec.py:515). Records one 'cp' (its bit the mask's tuple of
        bits when `mask` is given)."""
        first = blocks[self.local_ids[0]]
        elems = first.numel()
        if mask is not None:
            bit = int(mask)
            tag = tuple(b for b in range(bit.bit_length()) if bit >> b & 1)
        else:
            bit, tag = 1 << gbit, gbit
        self.recorder.record("cp", elems, elems * first.element_size(), tag)
        if self.dry:
            return None
        recv = [None] * self.size
        cross = []
        for d in self.local_ids:
            dev = self.devices[d]
            if not self.is_local(d ^ bit):
                cross.append(d)
                continue
            src = blocks[d ^ bit]
            if out is None:
                recv[d] = src.to(dev, copy=True,
                                 memory_format=torch.contiguous_format)
            else:
                recv[d] = out[d].copy_(src)
        if cross:
            self._p2p(blocks, cross, bit, recv, out)
        return recv

    def all_to_all(self, blocks: Sequence[Sequence]):
        """blocks[d][k] is the block shard d sends to shard k; returns
        recv with recv[k][d] a new buffer on shard k's device holding
        blocks[d][k] (None on a dry mesh; rows of other processes' shards
        None, as are their entries of `blocks`). Records one 'a2a' whose
        elements are a shard's whole operand (D blocks); (D-1)/D of them
        leave the shard."""
        D = self.size
        mine = self.local_ids
        row = blocks[mine[0]]
        elems = sum(b.numel() for b in row)
        self.recorder.record("a2a", elems,
                             elems * row[0].element_size() * (D - 1) // D,
                             None)
        if self.dry:
            return None
        recv = [None] * D
        for k in mine:
            recv[k] = [None] * D
            for d in mine:
                recv[k][d] = blocks[d][k].to(
                    self.devices[k], copy=True,
                    memory_format=torch.contiguous_format)
        if self.world > 1:
            self._all_to_all_processes(blocks, recv)
        return recv

    def _all_to_all_processes(self, blocks, recv) -> None:
        """The all-to-all's blocks between processes: one gloo
        all_to_all_single over host buffers. Process r's send buffer
        holds, for every other process q in rank order, blocks[d][k] for
        its shards d and q's shards k (d-major); it sends nothing to
        itself."""
        import torch.distributed as dist
        mine = self.local_ids
        L = len(mine)
        like = blocks[mine[0]][0]
        e = like.numel()
        shape = tuple(like.shape)
        per = L * L * e
        others = [q for q in range(self.world) if q != self.rank]
        t0 = time.perf_counter()
        send = self._host_buffer(like, (per * len(others),))
        at = 0
        for q in others:
            for d in mine:
                for k in range(q * L, (q + 1) * L):
                    send[at:at + e].view(shape).copy_(blocks[d][k])
                    at += e
        rbuf = self._host_buffer(like, (per * len(others),))
        splits = [0 if q == self.rank else per for q in range(self.world)]
        t1 = time.perf_counter()
        self._call("all_to_all", lambda: dist.all_to_all_single(
            rbuf, send, splits, splits, group=self.group))
        t2 = time.perf_counter()
        at = 0
        for q in others:
            for d in range(q * L, (q + 1) * L):
                for k in mine:
                    recv[k][d] = rbuf[at:at + e].view(shape).to(
                        self.devices[k], copy=True)
                    at += e
        t3 = time.perf_counter()
        nb = send.numel() * send.element_size()
        self._tally(t1 - t0, t2 - t1, t3 - t2, nb, nb)

    def reduce(self, parts: Sequence[torch.Tensor]):
        """Sum per-shard partial values (the reference's psum): the local
        shards' parts on the first local shard's device, then, on a
        process mesh, one all_reduce over the processes, so every process
        holds the same total; None on a dry mesh. Records one 'reduce'.
        The total of a process mesh carries no gradient: a part that
        requires one is refused (ROADMAP A10d)."""
        self.recorder.record("reduce", 1, 0, None)
        if self.dry:
            return None
        mine = self.local_ids
        dev = self.devices[mine[0]]
        total = parts[mine[0]].to(dev)
        for d in mine[1:]:
            total = total + parts[d].to(dev)
        if self.world == 1:
            return total
        if total.requires_grad:
            from quest_tpu_torch import validation as val
            raise val.QuESTError(
                "Invalid operation: a gradient through the reduction of a "
                "process mesh is not ported (ROADMAP A10d); run the "
                "differentiable path on a one-process mesh")
        return self.host_all_reduce(total).to(dev)


def _device_name(d: torch.device) -> str:
    """'cuda' names the current card, so a mesh over torch.device('cuda')
    and one over 'cuda:<current>' are the same mesh."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return f"cuda:{torch.cuda.current_device()}"
    return str(d)


def make_amp_mesh(num_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> AmpMesh:
    """A mesh of `num_devices` shards (a power of two) over the first
    entries of `devices` (torch devices or names; entries may repeat:
    `make_amp_mesh(4, devices=[torch.device("cuda")] * 4)` puts four
    shards on one card). Without `devices` it uses every visible card
    and raises when there is none (the port never drops to the CPU on
    its own). num_devices None: the largest power of two of them (ref
    quest_tpu/parallel/mesh.py make_amp_mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_amp_mesh: no CUDA device is visible; pass devices= "
                "(e.g. ['cpu'] * 8) to build a mesh on the CPU explicitly")
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is None:
        num_devices = 1 << (len(devices).bit_length() - 1)
    if num_devices < 1 or num_devices & (num_devices - 1):
        raise ValueError(
            f"Invalid number of devices {num_devices}: must be a power of 2 "
            "(ref QuEST_validation.c:81)")
    if num_devices > len(devices):
        raise ValueError(f"requested {num_devices} devices, have "
                         f"{len(devices)}")
    return AmpMesh(devices[:num_devices])


def refuse_process_mesh(mesh, what: str) -> None:
    """Raise a typed QuESTError when `mesh` spans processes: `what` does
    not run on such a mesh yet (ROADMAP A10d), and it never computes on
    one process's shards alone."""
    if mesh is not None and getattr(mesh, "world", 1) > 1:
        from quest_tpu_torch import validation as val
        raise val.QuESTError(
            f"Invalid operation: {what} does not run on a mesh that spans "
            f"processes yet (ROADMAP A10d); use a one-process mesh")


def make_process_mesh(devices: Optional[Sequence] = None) -> AmpMesh:
    """The mesh over every process of the default torch.distributed gloo
    group, which must be initialised (QuESTEnv(distributed=True) or
    torch.distributed.init_process_group).
    This process holds the largest power of two of `devices` (default:
    the card, 'cuda:0'; the port never drops to the CPU on its own) as
    its run of shards; every process must pass the same count. The comm
    planner prices the mesh with one host per process (comm.topology)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ProcessGroupError(
            "make_process_mesh: no torch.distributed process group is "
            "initialised; build one with QuESTEnv(distributed=True) or "
            "torch.distributed.init_process_group('gloo', ...)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_process_mesh: no CUDA device is visible; pass "
                "devices= (e.g. ['cpu'] * 2) to hold shards on the CPU "
                "explicitly")
        devices = [torch.device("cuda", 0)]
    devices = list(devices)
    if not devices:
        raise ValueError("devices must name at least one device")
    count = 1 << (len(devices).bit_length() - 1)
    return AmpMesh(devices[:count], group=dist.group.WORLD)


@dataclasses.dataclass
class ShardedAmps:
    """A register's planes split over `mesh`: shards[d] holds amplitudes
    [d 2^local_n, (d+1) 2^local_n) of every state, (2, 2^local_n) or, for
    a batch, (B, 2, 2^local_n), contiguous, on mesh.devices[d]; None for
    a shard another process of the mesh holds."""
    shards: List[Optional[torch.Tensor]]
    mesh: AmpMesh
    n: int

    # the accessors a register's eager functions read; no reshape: a
    # whole-state view would gather (`gather` is the explicit one)
    @property
    def dtype(self) -> torch.dtype:
        return self.shards[self.mesh.local_ids[0]].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[self.mesh.local_ids[0]].device

    @property
    def local_n(self) -> int:
        return self.n - self.mesh.global_qubits

    def local(self) -> List[tuple]:
        """(d, shard) of the shards this process holds, in order."""
        return [(d, self.shards[d]) for d in self.mesh.local_ids]

    def views(self) -> List[Optional[torch.Tensor]]:
        """Each shard as its flat (2, 2^local_n) planes (a view; None for
        another process's shard)."""
        m = 1 << self.local_n
        return [None if s is None else s.view(2, m) for s in self.shards]

    def clone(self) -> "ShardedAmps":
        return ShardedAmps([None if s is None else s.clone()
                            for s in self.shards], self.mesh, self.n)

    def gather(self, device=None) -> torch.Tensor:
        """The full planes ((2, 2^n), or (B, 2, 2^n) for a batch) on
        `device` (default: the first local shard's device), a new tensor
        the shards are copied into one by one; on a process mesh every
        process all-gathers them through the host."""
        dev = torch.device(device) if device is not None else self.device
        if self.mesh.world == 1:
            first = self.shards[0]
            m = first.shape[-1]
            out = torch.empty(first.shape[:-1] + (m * len(self.shards),),
                              dtype=first.dtype, device=dev)
            for d, s in enumerate(self.shards):
                out[..., d * m:(d + 1) * m] = s
            return out
        mine = torch.cat([s.to("cpu") for _, s in self.local()], dim=-1)
        return torch.cat(self.mesh.host_all_gather(mine), dim=-1).to(dev)


def shard_planes(amps: torch.Tensor, mesh: AmpMesh, n: int) -> ShardedAmps:
    """Split planes of an n-qubit state ((2, 2^n) or any view of them) or
    of a batch ((B, 2, ...)) into the mesh's D contiguous chunks, each a
    new tensor on its shard's device (on a process mesh only this
    process's chunks). Requires 2^n >= D (ref QuEST_validation.c:129)."""
    D = mesh.size
    if (1 << n) < D:
        raise ValueError(f"register of {1 << n} amps cannot shard over {D} "
                         f"devices (ref QuEST_validation.c:129)")
    batched = amps.numel() != 2 << n
    flat = amps.reshape(-1, 2, 1 << n) if batched else amps.reshape(2, 1 << n)
    m = (1 << n) // D
    shards = [None] * D
    for d in mesh.local_ids:
        shards[d] = flat[..., d * m:(d + 1) * m].to(
            mesh.devices[d], copy=True, memory_format=torch.contiguous_format)
    return ShardedAmps(shards, mesh, n)


def shard_qureg(q, mesh: AmpMesh):
    """The register with its planes laid out over the mesh, one contiguous
    chunk per shard (ref shard_qureg): q.replace_amps(ShardedAmps)."""
    return q.replace_amps(shard_planes(q.amps, mesh, q.num_state_qubits))
