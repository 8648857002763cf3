"""The amplitude mesh: an explicit list of torch devices, the register
split over it, and the recorder of every exchange it issues.

The reference shards the (2, 2^n) planes over a 1-D jax Mesh
(quest_tpu/parallel/mesh.py): shard d of D holds amplitudes
[d 2^n/D, (d+1) 2^n/D), so the top log2(D) qubits select the shard
(QuEST_cpu.c:1280-1312), and D must be a power of two
(QuEST_validation.c:81). Here the mesh is one process's list of torch
devices whose entries may repeat: 8 shards on 'cpu' in the tests, 4 on
one card, or distinct 'cuda:i' entries on a box with several cards. A
sharded register is a `ShardedAmps`: one contiguous (2, 2^(n - g)) (or
(B, 2, 2^(n - g)) for a batch) tensor per shard on that shard's device.

The mesh carries the exchanges the engines issue (parallel/sharded.py):

  permute     shard d receives its partner d ^ 2^gbit's block into a new
              buffer on its own device — a device-local copy when the two
              shards share a device, a peer copy between cards; every
              shard receives before any shard writes, so no exchange reads
              a block another shard has already overwritten;
  all_to_all  shard d's k-th block goes to shard k (the relabel event);
  reduce      per-shard partial sums added on the first shard's device.

and records each one in its `recorder` (`CollectiveRecorder`): the kind,
the device bit it crosses and the elements one shard sends, in the comm
planner's accounting (parallel/comm.py comm_stats). A mesh built with
`dry=True` records and copies nothing (its exchanges return None): the
engines walk their program on it to price a schedule without a state
(parallel/introspect.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch


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
    repeat) over the amplitude axis, with its collective recorder."""

    def __init__(self, devices: Sequence, dry: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        size = len(self.devices)
        if size < 1 or size & (size - 1):
            raise ValueError(
                f"Invalid number of devices {size}: must be a power of 2 "
                "(ref QuEST_validation.c:81)")
        self.dry = bool(dry)
        self.recorder = CollectiveRecorder()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def global_qubits(self) -> int:
        return self.size.bit_length() - 1

    @property
    def key(self) -> tuple:
        """The mesh's identity in a program cache key: its device tuple
        (a rebuilt mesh over the same devices finds the same programs; a
        mesh over other devices never does)."""
        return tuple(_device_name(d) for d in self.devices) + (
            ("dry",) if self.dry else ())

    def dry_copy(self) -> "AmpMesh":
        """A mesh of the same size on 'meta' that records and copies
        nothing (the dry walk of introspect)."""
        return AmpMesh(["meta"] * self.size, dry=True)

    # -- exchanges ----------------------------------------------------------

    def permute(self, blocks: Sequence, gbit: int, out: Sequence = None,
                mask: int = None):
        """Pair exchange over device bit `gbit`: shard d receives
        blocks[d ^ 2^gbit] (a tensor or a view on that shard's device)
        into a new contiguous buffer on its own device, or into out[d]
        when given; returns the received list (None on a dry mesh). Every
        shard receives before the caller writes anything, so the copies
        never read an overwritten block. `mask` (gbit None) pairs d with
        d ^ mask over several device bits at once, the Pauli flip
        exchange of the expectation engines (ref ops/expec.py:515).
        Records one 'cp' (its bit the mask's tuple of bits when
        `mask` is given)."""
        elems = blocks[0].numel()
        if mask is not None:
            bit = int(mask)
            tag = tuple(b for b in range(bit.bit_length()) if bit >> b & 1)
        else:
            bit, tag = 1 << gbit, gbit
        self.recorder.record("cp", elems, elems * blocks[0].element_size(),
                             tag)
        if self.dry:
            return None
        recv = []
        for d, dev in enumerate(self.devices):
            src = blocks[d ^ bit]
            if out is None:
                recv.append(src.to(dev, copy=True,
                                   memory_format=torch.contiguous_format))
            else:
                recv.append(out[d].copy_(src))
        return recv

    def all_to_all(self, blocks: Sequence[Sequence]):
        """blocks[d][k] is the block shard d sends to shard k; returns
        recv with recv[k][d] a new buffer on shard k's device holding
        blocks[d][k] (None on a dry mesh). Records one 'a2a' whose
        elements are a shard's whole operand (D blocks); (D-1)/D of them
        leave the shard."""
        D = self.size
        elems = sum(b.numel() for b in blocks[0])
        self.recorder.record("a2a", elems,
                             elems * blocks[0][0].element_size()
                             * (D - 1) // D, None)
        if self.dry:
            return None
        return [[blocks[d][k].to(self.devices[k], copy=True,
                                 memory_format=torch.contiguous_format)
                 for d in range(D)] for k in range(D)]

    def reduce(self, parts: Sequence[torch.Tensor]):
        """Sum per-shard partial values on the first shard's device (the
        reference's psum); None on a dry mesh. Records one 'reduce'."""
        self.recorder.record("reduce", 1, 0, None)
        if self.dry:
            return None
        dev = self.devices[0]
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        return total


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


@dataclasses.dataclass
class ShardedAmps:
    """A register's planes split over `mesh`: shards[d] holds amplitudes
    [d 2^local_n, (d+1) 2^local_n) of every state, (2, 2^local_n) or, for
    a batch, (B, 2, 2^local_n), contiguous, on mesh.devices[d]."""
    shards: List[torch.Tensor]
    mesh: AmpMesh
    n: int

    # the accessors a register's eager functions read; no reshape: a
    # whole-state view would gather (`gather` is the explicit one)
    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def local_n(self) -> int:
        return self.n - self.mesh.global_qubits

    def views(self) -> List[torch.Tensor]:
        """Each shard as its flat (2, 2^local_n) planes (a view)."""
        m = 1 << self.local_n
        return [s.view(2, m) for s in self.shards]

    def clone(self) -> "ShardedAmps":
        return ShardedAmps([s.clone() for s in self.shards], self.mesh,
                           self.n)

    def gather(self, device=None) -> torch.Tensor:
        """The full planes ((2, 2^n), or (B, 2, 2^n) for a batch) on
        `device` (default: the first shard's device), a new tensor."""
        dev = torch.device(device) if device is not None else \
            self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards], dim=-1)


def shard_planes(amps: torch.Tensor, mesh: AmpMesh, n: int) -> ShardedAmps:
    """Split planes of an n-qubit state ((2, 2^n) or any view of them) or
    of a batch ((B, 2, ...)) into the mesh's D contiguous chunks, each a
    new tensor on its shard's device. Requires 2^n >= D (ref
    QuEST_validation.c:129)."""
    D = mesh.size
    if (1 << n) < D:
        raise ValueError(f"register of {1 << n} amps cannot shard over {D} "
                         f"devices (ref QuEST_validation.c:129)")
    batched = amps.numel() != 2 << n
    flat = amps.reshape(-1, 2, 1 << n) if batched else amps.reshape(2, 1 << n)
    m = (1 << n) // D
    shards = [flat[..., d * m:(d + 1) * m].to(
        mesh.devices[d], copy=True, memory_format=torch.contiguous_format)
        for d in range(D)]
    return ShardedAmps(shards, mesh, n)


def shard_qureg(q, mesh: AmpMesh):
    """The register with its planes laid out over the mesh, one contiguous
    chunk per shard (ref shard_qureg): q.replace_amps(ShardedAmps)."""
    return q.replace_amps(shard_planes(q.amps, mesh, q.num_state_qubits))
