"""State checkpoints: atomic, digested, versioned, and readable by both
packages.

A port of quest_tpu/checkpoint.py (ROADMAP A11). The on-disk format is
the reference's format 3, byte for byte in its fields, so a checkpoint
written by either package loads in the other:

  * `save` / `load`: `amps.npz` holding the (2, 2^n) float planes under
    the key 'planes', and `qureg_meta.json` (magic, num_qubits,
    is_density, real_dtype, format_version, the per-plane SHA-256
    `plane_digests` and the canonical-JSON `meta_digest` of the meta
    itself). Writes are ATOMIC: a sibling temp dir, then one rename, so
    a crash mid-save never leaves a half-written checkpoint where a
    complete one stood. Every digest is verified at load; v1/v2
    checkpoints (before the digests) load with one stderr warning.
  * `save_arrays` / `load_arrays` / `read_extra`: raw named arrays (the
    durable trajectory executor's payload) and the `extra` dict (the
    durable cursor) in the same format.
  * `save_step` / `step_dirs` / `prune_steps` / `sweep_stale`: the
    `ckpt-<step>` chain under one root with keep-last-K retention
    (QUEST_CHECKPOINT_KEEP), the durable executor's resume chain;
    `load_step_elastic` reads one step in canonical logical order
    whatever wrote it.
  * `save_sharded` / `load_sharded`: a sharded register
    (parallel.ShardedAmps) as one `shard-<d>.npz` per shard, each with
    its own plane digests in the meta: each shard writes its own slice,
    nothing gathers. `block=False` returns a PendingCheckpoint once the
    snapshot is taken (a device-to-host copy of every shard into pinned
    host buffers, ordered on the device's stream before any later work
    on the register); only the hashing and the file writes run on a
    background thread, so the register may keep evolving in place.

  * `save_step_gang` / `load_step_gang`: the reference's two-phase gang
    checkpoint of a register sharded over a process mesh
    (parallel.make_process_mesh): `shard-<p>.npz`, `meta-<p>.json` and
    `prepared-<p>` per process in a shared tmp dir, committed by one
    rename when the last stamp lands; `load_step_elastic` reassembles a
    gang step like any other.

Fault sites: `checkpoint.save` fires at the commit point (temp files
written, rename pending; in a gang save after the payload and before the
stamp, with `process=p`), `checkpoint.load` at the top of the read path
(and `checkpoint.load_gang` beside it on a gang read).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import threading
import uuid

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation
from quest_tpu_torch.resilience import faults
from quest_tpu_torch.state import Qureg, create_density_qureg, create_qureg

_META_NAME = "qureg_meta.json"
_AMPS_NAME = "amps.npz"
# magic + version (the reference's): format 2 added the magic, format 3
# the per-plane digests
_MAGIC = "quest-checkpoint"
_FORMAT_VERSION = 3
# {:08d} zero-pads small steps; a step past 10^8 widens the field
_STEP_RE = re.compile(r"^ckpt-(\d{8,})$")
_SHARD_RE = "shard-{}.npz"

_legacy_warned = False


class CheckpointError(validation.QuESTError):
    """A checkpoint could not be read: missing, corrupt or truncated
    files, a failed per-plane digest, metadata that does not match the
    register being restored, or a format this build cannot take. The
    message names the offending file (and for a digest, the plane with
    the expected and found digests)."""


def _warn_legacy_once(directory: str, version: int) -> None:
    global _legacy_warned
    if _legacy_warned:
        return
    _legacy_warned = True
    print(f"[quest_tpu_torch.checkpoint] loading format_version {version} "
          f"checkpoint from {directory!r}: no per-plane checksums (added "
          f"in format 3), so corruption on disk cannot be detected; "
          f"re-save to upgrade", file=sys.stderr, flush=True)


def _digest(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    # feed the array's buffer directly — .tobytes() would copy the
    # whole plane per checkpoint (checkpoint cadence is a hot path for
    # the durable executor's overhead budget)
    h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return h.hexdigest()


def _meta_digest(meta: dict) -> str:
    """Self-digest of the metadata (canonical JSON, the digest field
    itself excluded): the meta carries the durable RESUME CURSOR, and a
    corrupted-but-parseable cursor (one flipped digit in 'step') would
    otherwise resume silently to wrong amplitudes — the per-plane
    digests only cover the array bytes."""
    clean = {k: v for k, v in meta.items() if k != "meta_digest"}
    return hashlib.sha256(
        json.dumps(clean, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


def _plane_digests(arrays: dict) -> dict:
    """Per-plane SHA-256 digests of a checkpoint payload: the 'planes'
    array's leading re/im planes digest separately (so the error can
    name WHICH plane rotted), every other array digests whole."""
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if name == "planes" and arr.ndim >= 1 and arr.shape[0] == 2:
            out["planes[re]"] = _digest(arr[0])
            out["planes[im]"] = _digest(arr[1])
        else:
            out[name] = _digest(arr)
    return out


def _digest_target(name: str, arrays: dict):
    """The array (or plane slice) a digest entry names, or None when its
    base array is absent from the payload."""
    m = re.match(r"^(.*)\[(re|im)\]$", name)
    if m:
        base = arrays.get(m.group(1))
        if base is None or base.ndim < 1 or base.shape[0] < 2:
            # a corrupt rewrite can shrink the stored array below the
            # plane index: treat it as the plane being missing (one
            # documented CheckpointError, never a leaked IndexError —
            # the durable resume chain must SKIP this, not crash)
            return None
        return base[0 if m.group(2) == "re" else 1]
    return arrays.get(name)


def _meta(qureg: Qureg) -> dict:
    return {
        "magic": _MAGIC,
        "num_qubits": qureg.num_qubits,
        "is_density": qureg.is_density,
        "real_dtype": str(np.dtype(qureg.real_dtype)),
        "format_version": _FORMAT_VERSION,
    }


def _read_meta(directory: str) -> dict:
    """Read + validate the checkpoint metadata, raising ONE clear
    CheckpointError (naming the file and the problem) for every way the
    file can be missing, truncated, non-JSON, not-a-checkpoint, from a
    future format, or incomplete. Pre-magic (format 1) checkpoints load
    tolerantly."""
    path = os.path.join(directory, _META_NAME)
    try:
        with open(path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"Invalid checkpoint: metadata file {path!r} is missing — "
            f"{directory!r} is not a checkpoint directory") from None
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"Invalid checkpoint: metadata file {path!r} is corrupt or "
            f"truncated (not parseable JSON: {e})") from e
    if not isinstance(meta, dict):
        raise CheckpointError(
            f"Invalid checkpoint: metadata file {path!r} does not hold "
            f"a JSON object (got {type(meta).__name__})")
    magic = meta.get("magic")
    if magic is not None and magic != _MAGIC:
        raise CheckpointError(
            f"Invalid checkpoint: {path!r} carries magic {magic!r}, "
            f"expected {_MAGIC!r} — not a quest checkpoint")
    version = meta.get("format_version", 1)
    if not isinstance(version, int) or version > _FORMAT_VERSION:
        raise CheckpointError(
            f"Invalid checkpoint: {path!r} is format_version "
            f"{version!r}, newer than this build supports "
            f"(<= {_FORMAT_VERSION}) — upgrade to load it")
    if meta.get("payload", "qureg") == "qureg":
        missing = [k for k in ("num_qubits", "is_density", "real_dtype")
                   if k not in meta]
        if missing:
            raise CheckpointError(
                f"Invalid checkpoint: {path!r} is missing required "
                f"field(s) {missing}")
    return meta


def _write_atomic(directory: str, meta: dict, arrays: dict) -> None:
    """Write a complete checkpoint into a sibling temp dir, then commit
    with one directory rename: a crash at ANY point before the commit
    leaves the target untouched (either absent or the previous complete
    checkpoint); a crash after it leaves the new complete checkpoint.
    The `checkpoint.save` fault site fires at the commit point so
    tests/soaks can emulate the mid-save crash deterministically. The
    overwrite path (target already a directory) swaps via a second
    sibling rename — never half-written, but a hard kill inside its
    two-syscall window leaves the target absent with the previous
    payload stranded under a `.old-<tag>` sibling (recoverable by
    hand); the versioned save_step path therefore ALWAYS commits to a
    fresh name (same-step leftovers are deleted first) and is fully
    atomic."""
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    if os.path.isdir(directory) and os.listdir(directory) \
            and not os.path.exists(os.path.join(directory, _META_NAME)):
        # the swap below REPLACES the whole target directory; silently
        # rmtree'ing a non-checkpoint directory a caller pointed at by
        # mistake would destroy unrelated files (the old merge-write
        # behavior tolerated that call; refusing loudly is safer)
        raise ValueError(
            f"refusing to overwrite {directory!r}: it exists, is not "
            f"empty, and holds no {_META_NAME} — not a checkpoint "
            f"directory; pick a new/empty path")
    meta = dict(meta)
    meta["plane_digests"] = _plane_digests(arrays)
    meta["meta_digest"] = _meta_digest(meta)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = f"{directory}.tmp-{tag}"
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, _AMPS_NAME), **arrays)
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump(meta, f)
        # the commit point: an injected error here aborts BEFORE the
        # rename, so the previous checkpoint (if any) stays loadable —
        # the mid-save-crash contract (a python-level abort also cleans
        # its temp dir below; only a hard kill leaves one behind, and
        # sweep_stale/prune_steps reclaims those)
        if faults.ACTIVE:
            faults.check("checkpoint.save", directory=directory, tmp=tmp)
        if os.path.isdir(directory):
            if not os.listdir(directory):
                os.rmdir(directory)          # empty dir: plain commit
                os.rename(tmp, directory)
            else:
                old = f"{directory}.old-{tag}"
                os.rename(directory, old)
                try:
                    os.rename(tmp, directory)
                except BaseException:
                    # best-effort rollback so a python-level rename
                    # failure doesn't leave the target absent
                    os.rename(old, directory)
                    raise
                shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, directory)
    except BaseException:
        # a FAILED (python-level) save must not leak a payload-sized
        # temp dir per attempt — long durable runs on flaky disks would
        # otherwise grow the checkpoint root unboundedly. (A hard kill
        # still leaves the tmp; step_dirs ignores it and sweep_stale
        # reclaims it.)
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_arrays(directory: str, require=()):
    """(meta, arrays) of a checkpoint written by `save` / `save_arrays`
    / `save_step`, with every per-plane digest VERIFIED against the
    stored bytes (format 3; pre-digest checkpoints warn once on stderr
    and load unverified). `require` names arrays that must be present
    (the qureg loader requires 'planes'). Every failure mode raises
    CheckpointError naming the file and the mismatch."""
    if faults.ACTIVE:
        faults.check("checkpoint.load", directory=directory)
    meta = _read_meta(directory)
    amps_path = os.path.join(directory, _AMPS_NAME)
    try:
        with np.load(amps_path) as data:
            arrays = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise CheckpointError(
            f"Invalid checkpoint: amplitude file {amps_path!r} is "
            f"missing") from None
    except Exception as e:
        # np.load surfaces truncation/corruption as BadZipFile, OSError,
        # ValueError or EOFError depending on WHERE the bytes stop —
        # collapse them into the one documented error
        raise CheckpointError(
            f"Invalid checkpoint: amplitude file {amps_path!r} is "
            f"corrupt or truncated ({type(e).__name__}: {e})") from e
    for name in require:
        if name not in arrays:
            raise CheckpointError(
                f"Invalid checkpoint: {amps_path!r} holds no "
                f"{name!r} array (found {sorted(arrays)})")
    version = meta.get("format_version", 1)
    md = meta.get("meta_digest")
    if md is not None and _meta_digest(meta) != md:
        raise CheckpointError(
            f"Invalid checkpoint: metadata in {directory!r} fails its "
            f"self-digest — the cursor/fields were altered after the "
            f"save (corrupt meta resumes to WRONG amplitudes; refusing "
            f"to load)")
    if md is None and version >= 3:
        raise CheckpointError(
            f"Invalid checkpoint: metadata in {directory!r} claims "
            f"format_version {version} but carries no meta_digest — "
            f"the integrity metadata was stripped or the file is "
            f"corrupt")
    digests = meta.get("plane_digests")
    if digests:
        for name, expect in sorted(digests.items()):
            target = _digest_target(name, arrays)
            if target is None:
                raise CheckpointError(
                    f"Invalid checkpoint: {amps_path!r} is missing the "
                    f"digested array behind plane {name!r} "
                    f"(found {sorted(arrays)})")
            got = _digest(np.asarray(target))
            if got != expect:
                raise CheckpointError(
                    f"Invalid checkpoint: plane {name!r} in "
                    f"{amps_path!r} fails its integrity digest "
                    f"(expected sha256 {expect[:16]}…, got {got[:16]}…)"
                    f" — the stored bytes are corrupt; refusing to "
                    f"restore from them")
    elif version >= 3:
        # a v3 meta with the digest table stripped is not "old and
        # tolerable", it is tampered/corrupt: loading it unverified
        # would silently void the format-3 integrity guarantee
        raise CheckpointError(
            f"Invalid checkpoint: metadata in {directory!r} claims "
            f"format_version {version} but carries no plane_digests "
            f"table — the integrity metadata was stripped or the file "
            f"is corrupt; refusing to load unverified planes")
    else:
        _warn_legacy_once(directory, version)
    return meta, arrays


def read_extra(directory: str):
    """The `extra` payload stored by save(..., extra=) — the durable
    executor's cursor — without touching the amplitude arrays. Returns
    None when the checkpoint carries no extra payload."""
    return _read_meta(directory).get("extra")


def _host_planes(amps) -> np.ndarray:
    """The (2, 2^n) planes on the host: a tensor's, or a sharded
    register's shards copied one by one into their slices."""
    if torch.is_tensor(amps):
        return amps.detach().reshape(2, -1).cpu().numpy()
    if isinstance(amps, np.ndarray):
        return amps.reshape(2, -1)
    if amps.mesh.world > 1:
        raise CheckpointError(
            "Invalid checkpoint: a register sharded over a process mesh is "
            "checkpointed by every process at once with save_step_gang "
            "(each writes its own slice)")
    views = amps.views()
    m = views[0].shape[1]
    out = np.empty((2, m * len(views)), dtype=precision.numpy_dtype(
        amps.dtype))
    for d, v in enumerate(views):
        out[:, d * m:(d + 1) * m] = v.detach().cpu().numpy()
    return out


def save(qureg: Qureg, directory: str, extra=None) -> None:
    """Write the whole state to `directory` as host .npz planes,
    ATOMICALLY, with per-plane digests (format 3); `extra` (a
    JSON-serializable dict, the durable cursor) rides in the metadata.
    A sharded register's shards are copied to the host one by one into
    the file's planes (for one file a shard, save_sharded)."""
    meta = _meta(qureg)
    if extra is not None:
        meta["extra"] = extra
    _write_atomic(directory, meta, {"planes": _host_planes(qureg.amps)})


def save_arrays(directory: str, arrays: dict, extra=None) -> None:
    """Atomic checkpoint of raw named arrays (payload 'arrays'): the
    durable trajectory executor's accumulated planes and draws, digested
    and verified like a register. `load` refuses it (use load_arrays)."""
    for name in arrays:
        if re.search(r"\[(re|im)\]$", name):
            raise ValueError(
                f"array name {name!r} must not end with '[re]'/'[im]' "
                f"(reserved for per-plane digest entries)")
    meta = {"magic": _MAGIC, "format_version": _FORMAT_VERSION,
            "payload": "arrays"}
    if extra is not None:
        meta["extra"] = extra
    _write_atomic(directory, meta,
                  {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v)) for k, v in arrays.items()})


def _register_for(meta: dict, directory: str, env, dtype, device):
    try:
        rdt = np.dtype(meta["real_dtype"])
    except TypeError as e:
        raise CheckpointError(
            f"Invalid checkpoint: metadata in {directory!r} names "
            f"unknown real_dtype {meta['real_dtype']!r}") from e
    cdt = dtype if dtype is not None else precision.complex_dtype_of(rdt)
    make = create_density_qureg if meta["is_density"] else create_qureg
    return make(meta["num_qubits"], dtype=cdt, device=device, env=env)


def _fill(q: Qureg, planes: np.ndarray) -> Qureg:
    """Copy host planes into the register's own (sharded or not)."""
    from quest_tpu_torch.state import _write
    return _write(q, 0, torch.from_numpy(np.ascontiguousarray(
        planes.astype(q.real_dtype, copy=False))))


def load(directory: str, env=None, dtype=None, device=None) -> Qureg:
    """Recreate a register from a checkpoint written by `save` (by either
    package), on `device` (default: the CUDA card) or sharded over
    `env`'s mesh. Every failure mode raises CheckpointError naming the
    file and the mismatch."""
    meta, arrays = load_arrays(directory, require=("planes",))
    if meta.get("payload", "qureg") != "qureg":
        raise CheckpointError(
            f"Invalid checkpoint: {directory!r} holds a "
            f"{meta['payload']!r} payload, not a register snapshot; use "
            f"checkpoint.load_arrays")
    planes = arrays["planes"]
    amps_path = os.path.join(directory, _AMPS_NAME)
    q = _register_for(meta, directory, env, dtype, device)
    want = (2, q.num_amps)
    if tuple(planes.shape) != want:
        raise CheckpointError(
            f"Invalid checkpoint: {amps_path!r} holds planes of shape "
            f"{tuple(planes.shape)}, which does not match the "
            f"{meta['num_qubits']}-qubit register its metadata declares "
            f"(expected {want})")
    return _fill(q, planes)


def step_path(root: str, step: int) -> str:
    return os.path.join(root, f"ckpt-{int(step):08d}")


def step_dirs(root: str):
    """[(step, path)] of the versioned checkpoints under `root`,
    ascending by step. Temp/old dirs from interrupted saves and foreign
    entries are ignored — only committed `ckpt-<step>` names count."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


_STALE_RE = re.compile(r"^ckpt-\d{8,}\.(tmp|old)-")


def sweep_stale(root: str) -> int:
    """Reclaim payload-sized `.tmp-*`/`.old-*` leftovers that hard
    kills strand under a step-checkpoint root (the preemptible-pod
    headline scenario kills mid-save REPEATEDLY — without a sweep the
    root grows by a full-state payload per kill). Safe under the
    chain's single-writer contract: a live save's temp dir belongs to
    THIS process and is never mid-flight while prune_steps runs.
    Returns the number of entries removed."""
    if not os.path.isdir(root):
        return 0
    removed = 0
    for name in os.listdir(root):
        if _STALE_RE.match(name):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            removed += 1
    return removed


def prune_steps(root: str, keep: int = None) -> None:
    """Keep-last-K retention over the versioned checkpoints under
    `root` (default: the QUEST_CHECKPOINT_KEEP knob, 2): at least two
    survivors means a checkpoint that turns out corrupt on resume
    always leaves an older valid one to fall back to. Also sweeps
    stale `.tmp-*`/`.old-*` leftovers from killed saves."""
    if keep is None:
        from quest_tpu_torch.env import knob_value
        keep = knob_value("QUEST_CHECKPOINT_KEEP")
    keep = int(keep)
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    for _, path in step_dirs(root)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)
    sweep_stale(root)


def save_step(root: str, step: int, *, qureg: Qureg = None, arrays=None,
              extra=None, keep: int = None) -> str:
    """Atomic versioned checkpoint `root/ckpt-<step>` of either a
    register (`qureg=`) or raw arrays (`arrays=`), then keep-last-K
    retention (prune_steps). Step numbers must be distinct per root —
    the durable executor's monotone cut index. Returns the committed
    path."""
    if (qureg is None) == (arrays is None):
        raise ValueError("save_step takes exactly one of qureg=/arrays=")
    path = step_path(root, step)
    if os.path.isdir(path):
        # a same-step leftover is either corrupt (the durable resume
        # skipped it and is now replaying past its cut) or identical by
        # deterministic replay; removing it first keeps the commit on
        # the fully-atomic fresh-name rename — the two-rename overwrite
        # swap has a crash window that strands the old payload under an
        # undiscoverable .old- name, and an older valid checkpoint
        # survives either way (keep-last-K), so deleting loses nothing
        shutil.rmtree(path, ignore_errors=True)
    if qureg is not None:
        save(qureg, path, extra=extra)
    else:
        save_arrays(path, arrays, extra=extra)
    prune_steps(root, keep)
    return path


def is_gang_step(path: str) -> bool:
    """True when `path` is a COMMITTED gang-format step checkpoint
    (save_step_gang's per-host shard layout) rather than a plain
    single-process one — the elastic loader's format dispatch."""
    return os.path.exists(os.path.join(path, "meta-0.json"))


# ---------------------------------------------------------------------------
# gang checkpoints: one step across the processes of a process mesh
# ---------------------------------------------------------------------------
#
# Two phases, no collective (ref checkpoint.py:553-818, file for file):
#   PREPARE  each process atomically writes its contiguous slice
#            (shard-<p>.npz) and its own digested meta (meta-<p>.json,
#            carrying the cursor) into the shared tmp dir
#            ckpt-<step>.tmp-gang, then stamps prepared-<p>. The
#            checkpoint.save fault fires between the payload and the
#            stamp: a process killed mid-save never stamps.
#   COMMIT   the process that completes the stamp set renames the tmp
#            dir to ckpt-<step>: one atomic rename; a race between two
#            completers is benign (one wins, the other finds the
#            committed target). A missing stamp means no process ever
#            commits: all stamp or none do.
# Validity is a property of the shared directory computed the same way
# on every process: load_step_gang verifies every shard's digests, so
# every process resumes the same cut.


def _gang_shard_meta(qureg: Qureg, process_index: int, process_count: int,
                     extra) -> tuple:
    """(meta, arrays) of this process's contiguous slice of a register
    sharded over a process mesh (its shards [lo, hi) of the mesh, on
    the host); the slice bounds ride the meta so a load reassembles
    without the mesh that wrote it (ref _gang_shard_meta)."""
    amps = qureg.amps
    mine = amps.local()
    ids = [d for d, _ in mine]
    if ids != list(range(ids[0], ids[0] + len(ids))):
        raise CheckpointError(
            f"gang checkpointing requires a contiguous slice a process; "
            f"this one holds shards {ids}")
    m = 1 << amps.local_n
    block = np.concatenate(
        [s.detach().reshape(2, m).cpu().numpy() for _, s in mine], axis=-1)
    lo = ids[0] * m
    meta = dict(_meta(qureg))
    meta.update({
        "payload": "gang-shard",
        "process_index": int(process_index),
        "process_count": int(process_count),
        "slice_lo": int(lo),
        "slice_hi": int(lo + block.shape[-1]),
    })
    if extra is not None:
        meta["extra"] = extra
    return meta, {"planes": block}


def save_step_gang(root: str, step: int, *, qureg: Qureg, extra=None,
                   keep: int = None):
    """Gang-consistent versioned checkpoint `root/ckpt-<step>` of a
    register sharded over a process mesh (ref save_step_gang): every
    process calls it with the same arguments; each writes only its slice
    into the shared tmp dir, stamps prepared-<p>, and the process that
    completes the stamp set commits with one rename. Returns the
    committed path when this process committed, None otherwise (the
    commit lands on one process; it is all or nothing either way). A
    retry of the same step (a resumed run replaying to the same cut)
    reuses the tmp dir: execution is deterministic from the shared
    resume point, so a surviving stale slice is bit-identical to its
    rewrite. A register on one process (or a one-process mesh) takes the
    plain atomic save_step."""
    from quest_tpu_torch.parallel.mesh import ShardedAmps
    amps = qureg.amps
    if not isinstance(amps, ShardedAmps) or amps.mesh.world == 1:
        return save_step(root, step, qureg=qureg, extra=extra, keep=keep)
    p, nproc = amps.mesh.rank, amps.mesh.world
    path = step_path(root, step)
    tmp = f"{path}.tmp-gang"
    meta, arrays = _gang_shard_meta(qureg, p, nproc, extra)
    meta["plane_digests"] = _plane_digests(arrays)
    meta["meta_digest"] = _meta_digest(meta)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"

    def put(name, write) -> bool:
        """Publish tmp/<name> atomically (a dotfile sibling, then a
        rename). A committed target with no tmp beside it means a peer
        already took this very step; the tmp vanishing mid-write means
        a peer committed (or finished the run and cleared the chain):
        this process's part is moot either way."""
        try:
            if not os.path.isdir(tmp) and os.path.isdir(path):
                return False
            os.makedirs(tmp, exist_ok=True)
            scratch = os.path.join(tmp, f".{name}-{tag}")
            write(scratch)
            os.rename(scratch, os.path.join(tmp, name))
            return True
        except FileNotFoundError:
            return False

    def write_npz(dst):
        with open(dst, "wb") as f:
            np.savez(f, **arrays)

    def write_meta(dst):
        with open(dst, "w") as f:
            json.dump(meta, f)

    def write_stamp(dst):
        with open(dst, "w") as f:
            f.write("ok")

    if not put(f"shard-{p}.npz", write_npz) \
            or not put(f"meta-{p}.json", write_meta):
        return None
    # the mid-save crash point: after the payload, before the stamp
    if faults.ACTIVE:
        faults.check("checkpoint.save", directory=path, tmp=tmp, process=p)
    if not put(f"prepared-{p}", write_stamp):
        return None
    committed = None
    if all(os.path.exists(os.path.join(tmp, f"prepared-{q}"))
           for q in range(nproc)):
        for attempt in range(2):
            try:
                os.rename(tmp, path)
                committed = path
                break
            except OSError:
                if not os.path.isdir(tmp):
                    break                # a peer took the commit
                if os.path.isdir(path) and attempt == 0:
                    # a same-step leftover of an earlier chain generation
                    shutil.rmtree(path, ignore_errors=True)
                    continue
                raise
    if committed:
        # keep-last-K over committed steps only: a live gang tmp belongs
        # to every process at once, so no stale sweep here (the durable
        # executor sweeps at completion, when no save is in flight)
        if keep is None:
            from quest_tpu_torch.env import knob_value
            keep = knob_value("QUEST_CHECKPOINT_KEEP")
        for _, old in step_dirs(root)[:-max(int(keep), 1)]:
            shutil.rmtree(old, ignore_errors=True)
    return committed


def load_step_gang(path: str, *, kind_extra: str = None):
    """(metas, planes) of a gang checkpoint committed by save_step_gang
    (ref load_step_gang): `metas` the per-process metas (cursors
    verified equal), `planes` the reassembled (2, 2^n) host array. Every
    shard's digests verify on every process, so gang validity is a
    function of the shared directory alone and every process lands on
    the same cut. Raises CheckpointError on any missing, corrupt or
    mismatched piece."""
    if faults.ACTIVE:
        faults.check("checkpoint.load", directory=path)
        faults.check("checkpoint.load_gang", directory=path)
    meta0_path = os.path.join(path, "meta-0.json")
    if not os.path.exists(meta0_path):
        raise CheckpointError(
            f"Invalid checkpoint: {path!r} holds no gang meta (meta-0.json) "
            f"and is not a gang checkpoint directory")
    try:
        with open(meta0_path) as f:
            meta0 = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"Invalid checkpoint: {meta0_path!r} is corrupt or truncated "
            f"({e})") from e
    if not isinstance(meta0, dict) \
            or _meta_digest(meta0) != meta0.get("meta_digest"):
        raise CheckpointError(
            f"Invalid checkpoint: {meta0_path!r} fails its meta "
            f"self-digest (altered after save); refusing to load")
    nproc = meta0.get("process_count")
    if not isinstance(nproc, int) or nproc < 1:
        raise CheckpointError(
            f"Invalid checkpoint: {meta0_path!r} carries no valid "
            f"process_count")
    nq, dens = meta0.get("num_qubits"), meta0.get("is_density")
    if not isinstance(nq, int) or not isinstance(dens, bool) \
            or not 0 < nq < 64:
        raise CheckpointError(
            f"Invalid checkpoint: {meta0_path!r} carries no valid "
            f"num_qubits/is_density")
    total = 1 << (2 * nq if dens else nq)
    planes, extra0, metas = None, None, []
    for q in range(nproc):
        mpath = os.path.join(path, f"meta-{q}.json")
        spath = os.path.join(path, f"shard-{q}.npz")
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"Invalid checkpoint: {mpath!r} is missing or corrupt "
                f"({e})") from e
        md = meta.get("meta_digest") if isinstance(meta, dict) else None
        if md is None or _meta_digest(meta) != md:
            raise CheckpointError(
                f"Invalid checkpoint: {mpath!r} fails its meta self-digest "
                f"(cursor altered after save); refusing to load")
        try:
            with np.load(spath) as data:
                block = data["planes"]
        except Exception as e:
            raise CheckpointError(
                f"Invalid checkpoint: shard file {spath!r} is missing, "
                f"corrupt or truncated ({type(e).__name__}: {e})") from e
        for name, expect in sorted(meta.get("plane_digests", {}).items()):
            target = _digest_target(name, {"planes": block})
            if target is None or _digest(np.asarray(target)) != expect:
                raise CheckpointError(
                    f"Invalid checkpoint: plane {name!r} of {spath!r} fails "
                    f"its integrity digest; refusing to restore")
        lo, hi = meta.get("slice_lo"), meta.get("slice_hi")
        if not isinstance(lo, int) or not isinstance(hi, int) \
                or block.shape[-1] != hi - lo or lo < 0 or hi > total:
            raise CheckpointError(
                f"Invalid checkpoint: shard {q} of {path!r} declares slice "
                f"[{lo}, {hi}) but holds {block.shape[-1]} columns of a "
                f"{total}-amp register")
        if planes is None:
            planes = np.zeros(block.shape[:-1] + (total,), dtype=block.dtype)
        planes[..., lo:hi] = block
        ex = meta.get("extra")
        if q == 0:
            extra0 = ex
        elif ex != extra0:
            raise CheckpointError(
                f"Invalid checkpoint: gang cursors disagree between process "
                f"0 and {q} under {path!r} (a torn save); refusing to load")
        metas.append(meta)
    if kind_extra is not None:
        cur = extra0 if isinstance(extra0, dict) else {}
        if cur.get("kind") != kind_extra:
            raise CheckpointError(
                f"Invalid checkpoint: {path!r} carries no {kind_extra!r} "
                f"durable cursor")
    return metas, planes


def load_step_elastic(path: str, *, mesh=None, perm=None):
    """(cursor, planes) of ONE committed step checkpoint in CANONICAL
    LOGICAL ORDER, whatever wrote it (ref :826): a gang checkpoint (any
    process count) reassembles through load_step_gang, every shard's
    digests verified, and its cursor's relabel perm normalizes the
    physical layout; a plain checkpoint with cursor layout 'canonical'
    loads as it is; a physical-layout one (older chains) normalizes
    through its recorded perm. The cursor must be a durable state
    cursor. `mesh` re-enters the planes onto that mesh (a ShardedAmps,
    each of this process's shards copied to its device) after applying
    `perm` (the target cut's logical -> physical permutation); without
    it the planes come back as a host numpy array."""
    from quest_tpu_torch.parallel import relabel as R
    from quest_tpu_torch.parallel.mesh import shard_planes

    if is_gang_step(path):
        metas, planes = load_step_gang(path, kind_extra="state")
        cursor = metas[0].get("extra")
        layout = "physical"
    else:
        meta, arrays = load_arrays(path, require=("planes",))
        cursor = meta.get("extra")
        if not isinstance(cursor, dict) or cursor.get("kind") != "state":
            raise CheckpointError(
                f"Invalid checkpoint: {path!r} carries no durable state "
                f"cursor and is not an elastically loadable step")
        planes = np.asarray(arrays["planes"])
        layout = cursor.get("layout", "physical")
    if not isinstance(cursor, dict):
        raise CheckpointError(
            f"Invalid checkpoint: {path!r} carries no durable cursor")
    if layout != "canonical":
        src_perm = cursor.get("perm")
        if src_perm is not None:
            if (not isinstance(src_perm, (list, tuple))
                    or (1 << len(src_perm)) != planes.shape[-1]):
                raise CheckpointError(
                    f"Invalid checkpoint: {path!r} carries a relabel perm "
                    f"of {src_perm!r} that does not match its "
                    f"{planes.shape[-1]}-amp planes; refusing to normalize "
                    f"(a wrong layout resumes to wrong amplitudes)")
            planes = R.canonicalize_planes(planes, list(src_perm))
    if mesh is not None:
        if perm:
            planes = R.physicalize_planes(np.asarray(planes), perm)
        n = int(planes.shape[-1]).bit_length() - 1
        planes = shard_planes(torch.from_numpy(np.ascontiguousarray(planes)),
                              mesh, n)
    return cursor, planes


# ---------------------------------------------------------------------------
# sharded checkpoints: one npz a shard, no gather
# ---------------------------------------------------------------------------


class PendingCheckpoint:
    """An in-flight sharded checkpoint: the snapshot was taken when
    save_sharded returned; `wait()` blocks until the files are committed
    and re-raises any error of the background write."""

    def __init__(self, thread: threading.Thread = None):
        self._thread = thread
        self.error = None

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error


def _snapshot(amps) -> tuple:
    """(host buffers, event): each shard's planes copied to the host —
    into pinned buffers with a non-blocking copy on a card, ordered on
    its stream before any later kernel that writes the register — and a
    CUDA event after the copies (None off the card)."""
    bufs, event = [], None
    for v in amps.views():
        if v.device.type == "cuda":
            b = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            b.copy_(v, non_blocking=True)
            event = torch.cuda.Event()
        else:
            b = v.detach().clone()
        bufs.append(b)
    if event is not None:
        event.record()
    return bufs, event


def _write_sharded(directory: str, meta: dict, bufs, event) -> None:
    """Atomic commit of one npz a shard plus the meta carrying every
    shard's plane digests, computed from the bytes written."""
    if event is not None:
        event.synchronize()
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    if os.path.isdir(directory) and os.listdir(directory) \
            and not os.path.exists(os.path.join(directory, _META_NAME)):
        raise ValueError(
            f"refusing to overwrite {directory!r}: it exists, is not empty, "
            f"and holds no {_META_NAME}; pick a new or empty path")
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = f"{directory}.tmp-{tag}"
    os.makedirs(tmp)
    try:
        digests = {}
        for d, b in enumerate(bufs):
            arr = b.numpy()
            name = _SHARD_RE.format(d)
            np.savez(os.path.join(tmp, name), planes=arr)
            digests[name] = _plane_digests({"planes": arr})
        meta = dict(meta)
        meta["shard_digests"] = digests
        meta["meta_digest"] = _meta_digest(meta)
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump(meta, f)
        if faults.ACTIVE:
            faults.check("checkpoint.save", directory=directory, tmp=tmp)
        old = None
        if os.path.isdir(directory):
            old = f"{directory}.old-{tag}"
            os.rename(directory, old)
        os.rename(tmp, directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_sharded(qureg: Qureg, directory: str,
                 block: bool = True) -> PendingCheckpoint:
    """Checkpoint a sharded register (its planes a parallel.ShardedAmps)
    WITHOUT gathering it: every shard's (2, 2^local_n) planes go to their
    own `shard-<d>.npz`, each with its plane digests in the meta, the
    whole committed atomically. With block=False the call returns as soon
    as the snapshot is taken (see the module docstring) and the hashing
    and writing run on a background thread: the register may keep
    evolving in place meanwhile; `wait()` on the returned handle."""
    amps = qureg.amps
    if torch.is_tensor(amps):
        raise CheckpointError(
            "Invalid checkpoint: save_sharded takes a sharded register "
            "(parallel.shard_qureg); use checkpoint.save for one tensor")
    if amps.mesh.world > 1:
        raise CheckpointError(
            "Invalid checkpoint: save_sharded writes one process's shards; "
            "a register sharded over a process mesh checkpoints with "
            "save_step_gang (every process its own slice)")
    meta = _meta(qureg)
    meta.update({"payload": "sharded", "shards": amps.mesh.size})
    bufs, event = _snapshot(amps)
    if block:
        _write_sharded(directory, meta, bufs, event)
        return PendingCheckpoint()
    pending = PendingCheckpoint()

    def run():
        try:
            _write_sharded(directory, meta, bufs, event)
        except BaseException as e:      # surfaced by wait()
            pending.error = e
    pending._thread = threading.Thread(target=run, daemon=True,
                                       name="quest-save-sharded")
    pending._thread.start()
    return pending


def load_sharded(directory: str, mesh=None, env=None, dtype=None,
                 device=None) -> Qureg:
    """Restore a checkpoint written by save_sharded, every shard file's
    digests and the meta's self-digest verified: onto `mesh` (or `env`'s
    mesh) each shard reads the files that hold its slice, so with the
    writer's shard count shard d reads shard-<d>.npz alone (on a process
    mesh each process reads only its own shards'); without a mesh, one
    register on `device`."""
    if faults.ACTIVE:
        faults.check("checkpoint.load", directory=directory)
    meta = _read_meta(directory)
    if meta.get("payload") != "sharded":
        raise CheckpointError(
            f"Invalid checkpoint: {directory!r} holds a "
            f"{meta.get('payload', 'qureg')!r} payload, not a sharded one; "
            f"use checkpoint.load")
    md = meta.get("meta_digest")
    if md is None or _meta_digest(meta) != md:
        raise CheckpointError(
            f"Invalid checkpoint: metadata in {directory!r} fails its "
            f"self-digest; refusing to load")
    D = int(meta["shards"])
    digests = meta.get("shard_digests") or {}
    cache = {}

    def shard(d):
        if d not in cache:
            name = _SHARD_RE.format(d)
            path = os.path.join(directory, name)
            try:
                with np.load(path) as data:
                    arr = data["planes"]
            except FileNotFoundError:
                raise CheckpointError(
                    f"Invalid checkpoint: shard file {path!r} is missing"
                ) from None
            except Exception as e:
                raise CheckpointError(
                    f"Invalid checkpoint: shard file {path!r} is corrupt or "
                    f"truncated ({type(e).__name__}: {e})") from e
            want = digests.get(name)
            if want is None or _plane_digests({"planes": arr}) != want:
                raise CheckpointError(
                    f"Invalid checkpoint: shard file {path!r} fails its "
                    f"integrity digest; refusing to restore from it")
            cache[d] = arr
        return cache[d]

    n = 2 * meta["num_qubits"] if meta["is_density"] else meta["num_qubits"]
    if mesh is None and env is not None:
        mesh = env.sharding_for(n)
    if mesh is None:
        q = _register_for(meta, directory, None, dtype, device)
        return _fill(q, np.concatenate([shard(d) for d in range(D)],
                                       axis=-1))
    from quest_tpu_torch.parallel.mesh import ShardedAmps
    rdt = (precision.real_dtype_of(np.dtype(dtype)) if dtype is not None
           else np.dtype(meta["real_dtype"]))
    total = 1 << n
    per = total // D
    m = total // mesh.size
    shards = [None] * mesh.size
    for k in mesh.local_ids:
        dev = mesh.devices[k]
        lo, hi = k * m, (k + 1) * m
        parts = [shard(d)[:, max(lo, d * per) - d * per:
                          min(hi, (d + 1) * per) - d * per]
                 for d in range(lo // per, (hi - 1) // per + 1)]
        block = np.concatenate(parts, axis=-1).astype(rdt, copy=False)
        shards[k] = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
        cache.clear()
    q = Qureg(amps=None, num_qubits=meta["num_qubits"],
              is_density=bool(meta["is_density"]))
    return q.replace_amps(ShardedAmps(shards, mesh, n))
