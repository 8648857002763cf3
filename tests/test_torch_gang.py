"""Gang checkpoints and gang durable runs on a two-process mesh
(quest_tpu_torch/checkpoint.py save_step_gang / load_step_gang,
quest_tpu_torch/resilience/durable.py run_durable on a process mesh),
mirroring tests/test_gang.py, tests/_gang_worker.py and the elastic soak of
tests/test_elastic.py on the CPU.

Two processes of a gloo group, 2 CPU shards each (tests/_torch_mp_worker.py):

  * gang: the planner's hierarchical schedule issued as predicted on each
    rank; an uninterrupted run_durable; a preempted and resumed run bit
    for bit equal to it; the mid-save kill (rank 1 dies between its slice
    and its stamp in the second save, rank 0 is preempted after it): the
    step never commits, both ranks resume the same earlier cut, and the
    finish is bit for bit; the final planes agree with the JAX package's
    banded result;
  * one gang step left on disk reads to the same planes and cursor through
    the JAX package's load_step_gang / load_step_elastic and the port's;
  * the elastic soak: a gang chain killed mid-save, resumed on one process
    over a 2-shard mesh (elastic) and preempted again, then resumed back
    onto the two ranks, bit for bit equal to an uninterrupted gang run.

In this process, with the ranks' views of one register built by hand: a
gang step commits only when every rank has stamped, round-trips through
both packages, and a torn one is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from quest_tpu import checkpoint as JCK
from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch import state as TS
from quest_tpu_torch.parallel import sharded as S
from quest_tpu_torch.parallel.mesh import (AmpMesh, ShardedAmps,
                                           make_amp_mesh, shard_planes)
from quest_tpu_torch.resilience import FaultPlan, faults

from . import _torch_mp_worker as W
from .test_torch_comm import _one_thread_per_worker, to_reference  # noqa: F401
from .test_torch_multiprocess import (assert_ranks_ok, base, both,
                                      run_ranks, run_solo)

pytestmark = pytest.mark.dtype_agnostic

MARKERS = ("gang parity ok", "gang uninterrupted ok", "gang resume ok",
           "gang midsave ok", "gang kept ok")


@pytest.fixture(scope="module")
def gang_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gang"))
    rcs, outs = run_ranks("gang", root)
    assert_ranks_ok(rcs, outs, "gang kept ok")
    return root, outs


@pytest.mark.parametrize("marker", MARKERS)
def test_gang_scenarios_pass_on_both_ranks(gang_run, marker):
    _, outs = gang_run
    for out in outs:
        assert f": {marker}" in out, out[-2000:]


def test_both_ranks_choose_the_same_hierarchical_strategy(gang_run):
    import re
    _, outs = gang_run
    strategies = {re.search(r"strategy=(\w+)", o).group(1) for o in outs}
    assert strategies == {"hier"}


def test_gang_run_holds_the_jax_result(gang_run):
    root, _ = gang_run
    c = W.gang_circuit(8)
    want = np.asarray(to_reference(c).compiled_banded(8, False,
                                                      donate=False)(
        base(8).numpy()))
    assert float(np.max(np.abs(both(root, "gang-a") - want))) < 5e-6


def test_kept_gang_step_reads_the_same_in_both_packages(gang_run):
    root, _ = gang_run
    path = ckpt.step_path(os.path.join(root, "kept"), 3)
    assert ckpt.is_gang_step(path)
    assert sorted(os.listdir(path)) == [
        "meta-0.json", "meta-1.json", "prepared-0", "prepared-1",
        "shard-0.npz", "shard-1.npz"]
    metas, planes = ckpt.load_step_gang(path, kind_extra="state")
    jmetas, jplanes = JCK.load_step_gang(path, kind_extra="state")
    np.testing.assert_array_equal(planes, np.asarray(jplanes))
    np.testing.assert_array_equal(planes, both(root, "kept"))
    assert metas == jmetas
    assert [m["process_index"] for m in metas] == [0, 1]
    cursor, canon = ckpt.load_step_elastic(path)
    jcursor, jcanon = JCK.load_step_elastic(path)
    assert cursor == jcursor and cursor["note"] == "kept"
    np.testing.assert_array_equal(canon, np.asarray(jcanon))


def test_kept_gang_step_reenters_a_one_process_mesh(gang_run):
    root, _ = gang_run
    path = ckpt.step_path(os.path.join(root, "kept"), 3)
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    _, amps = ckpt.load_step_elastic(path, mesh=mesh)
    assert isinstance(amps, ShardedAmps)
    np.testing.assert_array_equal(amps.gather("cpu").numpy(),
                                  both(root, "kept"))


def test_elastic_gang_soak_two_process(tmp_path, monkeypatch):
    """2 ranks -> one process (D' = 2) -> 2 ranks, every generation
    killed or preempted, the finish bit for bit equal to an uninterrupted
    gang run (tests/test_elastic.py:617)."""
    monkeypatch.setenv("QUEST_SCHEDULE", "0")   # the portable circuit
    root = str(tmp_path)
    rcs, outs = run_ranks("elastic-1", root)
    assert_ranks_ok(rcs, outs, "elastic midsave-kill ok")
    assert all("elastic baseline ok" in o for o in outs)
    rc, out = run_solo("elastic-solo", root)
    assert rc == 0, out[-4000:]
    assert "elastic solo-resume ok" in out
    rcs, outs = run_ranks("elastic-3", root)
    assert_ranks_ok(rcs, outs, "elastic final ok")
    hashes = {}
    for r in (0, 1):
        with open(os.path.join(root, f"ref-hashes-{r}.json")) as f:
            hashes.update(json.load(f))
    assert sorted(hashes) == ["0", "1"]


# -- in this process: the ranks' views of one register ----------------------


def rank_view(planes: torch.Tensor, n: int, rank: int, world: int = 2,
              per: int = 2) -> TS.Qureg:
    """Process `rank`'s view of an n-qubit register over a world x per
    shard process mesh, without a group: the mesh holds this rank's
    shards and None for its peers', as make_process_mesh lays them out."""
    mesh = AmpMesh(["cpu"] * per)
    mesh.world, mesh.rank = world, rank
    mesh.lo = rank * per
    mesh.local_ids = range(mesh.lo, mesh.lo + per)
    mesh.devices = ((None,) * mesh.lo + mesh.local_devices
                    + (None,) * ((world - rank - 1) * per))
    q = TS.create_qureg(n, device="cpu")
    return q.replace_amps(shard_planes(planes, mesh, n))


def _planes(n: int, seed: int = 3) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 1 << n, generator=g)
    return x / x.pow(2).sum().sqrt()


def test_gang_step_commits_when_every_rank_stamps(tmp_path):
    n, root = 6, str(tmp_path)
    planes = _planes(n)
    cursor = {"kind": "state", "step": 5, "perm": None}
    first = ckpt.save_step_gang(root, 5, qureg=rank_view(planes, n, 0),
                                extra=cursor)
    assert first is None and ckpt.step_dirs(root) == []
    tmp = ckpt.step_path(root, 5) + ".tmp-gang"
    assert sorted(os.listdir(tmp)) == ["meta-0.json", "prepared-0",
                                       "shard-0.npz"]
    second = ckpt.save_step_gang(root, 5, qureg=rank_view(planes, n, 1),
                                 extra=cursor)
    assert second == ckpt.step_path(root, 5) and not os.path.isdir(tmp)
    for load in (ckpt.load_step_gang, JCK.load_step_gang):
        metas, got = load(second, kind_extra="state")
        np.testing.assert_array_equal(np.asarray(got), planes.numpy())
        assert [m["slice_lo"] for m in metas] == [0, 32]
        assert all(m["extra"] == cursor for m in metas)


def test_a_mid_save_fault_leaves_the_step_uncommitted(tmp_path):
    n, root = 6, str(tmp_path)
    planes = _planes(n)
    ckpt.save_step_gang(root, 2, qureg=rank_view(planes, n, 0),
                        extra={"kind": "state", "step": 2})
    plan = FaultPlan().inject("checkpoint.save", times=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            ckpt.save_step_gang(root, 2, qureg=rank_view(planes, n, 1),
                                extra={"kind": "state", "step": 2})
    assert plan.fired() == 1
    assert ckpt.step_dirs(root) == []
    tmp = ckpt.step_path(root, 2) + ".tmp-gang"
    assert "shard-1.npz" in os.listdir(tmp)
    assert "prepared-1" not in os.listdir(tmp)
    # the replay's retry reuses the tmp and commits
    assert ckpt.save_step_gang(root, 2, qureg=rank_view(planes, n, 1),
                               extra={"kind": "state", "step": 2})
    assert [s for s, _ in ckpt.step_dirs(root)] == [2]
    assert ckpt.sweep_stale(root) == 0


def test_a_gang_step_of_a_one_process_register_is_a_plain_step(tmp_path):
    n = 6
    planes = _planes(n)
    mesh = make_amp_mesh(2, devices=["cpu"] * 2)
    q = TS.create_qureg(n, device="cpu").replace_amps(
        shard_planes(planes, mesh, n))
    path = ckpt.save_step_gang(str(tmp_path), 1, qureg=q,
                               extra={"kind": "state", "step": 1,
                                      "layout": "canonical"})
    assert not ckpt.is_gang_step(path)
    cursor, got = ckpt.load_step_elastic(path)
    np.testing.assert_array_equal(got, planes.numpy())


def test_gang_fingerprint_is_the_same_for_any_holding(tmp_path):
    """The gang cursor's state fingerprint: one tensor, or a one-process
    mesh's shards, hash alike (a process mesh all-reduces the same
    per-shard rows)."""
    from quest_tpu_torch.resilience import durable as D
    n = 6
    planes = _planes(n)
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    flat = TS.create_qureg(n, device="cpu").replace_amps(planes.clone())
    sharded = flat.replace_amps(shard_planes(planes, mesh, n))
    assert D._state_fingerprint_gang(flat, mesh) == \
        D._state_fingerprint_gang(sharded, mesh)
    other = flat.replace_amps(_planes(n, seed=4))
    assert D._state_fingerprint_gang(other, mesh) != \
        D._state_fingerprint_gang(flat, mesh)


def test_a_gang_program_runs_on_a_rank_view_locally():
    """A rank's view walks only its shards: the diagonal and local-target
    items of a program run with no exchange and touch no peer shard."""
    from quest_tpu_torch.circuit import Circuit
    n = 6
    planes = _planes(n)
    c = Circuit(n).rz(0, 0.3).h(1).cz(0, 5)
    q = rank_view(planes, n, 1)
    S.compile_circuit_sharded(c.ops, n, False, q.amps.mesh)(q.amps)
    one = make_amp_mesh(4, devices=["cpu"] * 4)
    x = shard_planes(planes, one, n)
    S.compile_circuit_sharded(c.ops, n, False, one)(x)
    assert q.amps.shards[0] is None and q.amps.shards[1] is None
    for d in (2, 3):
        np.testing.assert_array_equal(q.amps.shards[d].numpy(),
                                      x.shards[d].numpy())
    assert q.amps.mesh.recorder.events == []


@pytest.mark.parametrize("save", ["save", "save_sharded"])
def test_a_process_register_refuses_a_one_process_checkpoint(tmp_path, save):
    """Every process of a process mesh holds only its slice: a whole-
    register checkpoint written by one of them is refused typed, naming
    the reference's reason (its save gathers with jax.device_get), and a
    per-shard checkpoint written by one of them alone writes that
    process's shards and stamp, commits nothing and fails typed at its
    timeout: the commit waits for every process's stamp."""
    q = rank_view(_planes(6), 6, 1)
    target = tmp_path / "one"
    if save == "save":
        with pytest.raises(ckpt.CheckpointError, match="process mesh"):
            ckpt.save(q, str(target))
        assert not target.exists()
        return
    with pytest.raises(ckpt.CheckpointError, match="not committed"):
        ckpt.save_sharded(q, str(target), timeout=0.2)
    assert not target.exists()
    tmp, = [p for p in tmp_path.iterdir() if p.name.startswith("one.tmp-mesh")]
    assert sorted(f.name for f in tmp.iterdir()) == [
        "prepared-1.json", "shard-2.npz", "shard-3.npz"]
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load_sharded(str(target), device="cpu")
