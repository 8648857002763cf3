"""Elastic durable resume in the port (quest_tpu_torch/resilience/durable.py
with elastic=True or QUEST_DURABLE_ELASTIC=1), mirroring
tests/test_elastic.py:115-409 (its gang soak across processes is in
tests/test_torch_gang.py, its watchdog and fleet cases in the serving
tests).

A checkpoint chain is a property of the logical state: written canonical,
it re-enters any mesh that holds the amplitudes. On the mesh-portable
circuit (bench._build_elastic_circuit rebuilt on the port's Circuit,
under QUEST_SCHEDULE=0) elastic resumes 2 and 4 CPU shards -> one
register and one register -> 2 and 4 shards are pinned BIT-identical to
the uninterrupted native run on the target; fused -> sharded (the fused
chain runs the segment kernel's plain version, whose sums the banded
appliers do not reproduce bit for bit) within 2e-5 x max|amp|; a general
relabel-heavy circuit 4 -> 2 shards eps-close. Elastic relaxes where a run
executes, never what it computes: another circuit or initial state is
refused typed, a mesh change without elastic=True too; pre-elastic
cursors resume on their own mesh and are refused on another; a corrupt
newest checkpoint is skipped loudly."""

import numpy as np
import pytest
import torch

from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh, shard_qureg
from quest_tpu_torch.parallel import relabel as R
from quest_tpu_torch.resilience import (DurableError, FaultPlan, faults,
                                        run_durable)
from quest_tpu_torch.serve import metrics

from .test_torch_comm import _one_thread_per_worker  # noqa: F401

pytestmark = pytest.mark.dtype_agnostic

N = 10


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


@pytest.fixture()
def portable_env(monkeypatch):
    """The bit-identity pins run with the scheduler off: its diagonal
    pooling re-merges the circuit's isolated rotations into band
    operators whose sums reassociate per shard shape."""
    monkeypatch.setenv("QUEST_SCHEDULE", "0")


def elastic_circuit(n=N, layers=3, seed=7):
    """bench._build_elastic_circuit on the port's Circuit, draw for draw:
    rotations on qubits < 7 each isolated by a cz blocker, amplitude
    reaching qubits >= 7 only through CNOTs, phases only through czs."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for layer in range(layers):
        for q in range(7):
            c.cz(q, n - 1)
            ang = float(rng.uniform(0, 2 * np.pi))
            (c.rx if (layer + q) % 2 == 0 else c.ry)(q, ang)
        if layer == 0:
            for h in range(7, n):
                c.cnot(h - 7, h)
        for h in range(7, n):
            c.cz(h, (h + layer) % 7)
    return c


def _sv(n=N):
    return TS.create_qureg(n, device="cpu")


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


def _amps(q):
    amps = q.amps
    if isinstance(amps, ShardedAmps):
        return np.concatenate([s.numpy() for s in amps.shards], axis=-1)
    return amps.numpy().reshape(2, -1)


def _preempt(runner, after, times=1):
    plan = FaultPlan().inject("durable.preempt", after_n=after, times=times)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            runner()
    assert plan.fired() == times


# ---------------------------------------------------------------------------
# elastic bit-identity pins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
def test_elastic_sharded_to_one_register_bit_identical(tmp_path,
                                                       portable_env, shards):
    mesh = _mesh(shards)
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3,
                      engine="banded")
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, mesh=mesh), after=5)
    assert ckpt.step_dirs(d), "no checkpoint before the kill"
    reg = metrics.Registry()
    out = run_durable(c, _sv(), d, every=3, engine="banded", elastic=True,
                      registry=reg)
    np.testing.assert_array_equal(_amps(out), _amps(ref))
    assert reg.counter("durable_resumes").value == 1
    assert reg.counter("durable_elastic_resumes").value == 1
    assert ckpt.step_dirs(d) == []


@pytest.mark.parametrize("shards", [2, 4])
def test_elastic_one_register_to_sharded_bit_identical(tmp_path,
                                                       portable_env, shards):
    mesh = _mesh(shards)
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3, mesh=mesh)
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, engine="banded"),
             after=5)
    out = run_durable(c, _sv(), d, every=3, mesh=mesh, elastic=True)
    assert isinstance(out.amps, ShardedAmps)
    np.testing.assert_array_equal(_amps(out), _amps(ref))
    assert ckpt.step_dirs(d) == []


def test_elastic_between_shard_counts_bit_identical(tmp_path, portable_env):
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3,
                      mesh=_mesh(4))
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, mesh=_mesh(2)),
             after=5)
    out = run_durable(c, _sv(), d, every=3, mesh=_mesh(4), elastic=True)
    np.testing.assert_array_equal(_amps(out), _amps(ref))


def test_elastic_fused_to_sharded(tmp_path, portable_env, monkeypatch):
    """Sweep fusion off: the fused plan then has several launches to cut
    between. The fused chain's prefix ran through the segment kernel's
    plain version, so the sharded suffix lands within tolerance of the
    native sharded run (and resumes from a real cut)."""
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    mesh = _mesh(2)
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3, mesh=mesh)
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=1, engine="fused"),
             after=1)
    assert ckpt.step_dirs(d)
    reg = metrics.Registry()
    out = run_durable(c, _sv(), d, every=3, mesh=mesh, elastic=True,
                      registry=reg)
    assert reg.counter("durable_elastic_resumes").value == 1
    want = _amps(ref)
    assert np.abs(_amps(out) - want).max() <= 2e-5 * np.abs(want).max()


def test_elastic_general_circuit_resumes_eps_close(tmp_path):
    """General circuits (default knobs, relabel-heavy) have no
    mesh-portable arithmetic: the elastic resume walks past non-portable
    cuts loudly and lands eps-close to the native run."""
    n = 8
    rng = np.random.default_rng(11)
    c = Circuit(n)
    for _ in range(6):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
            c.ry(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(0, n - 1, 2):
            c.cz(q, q + 1)
    mesh4, mesh2 = _mesh(4), _mesh(2)
    ref = run_durable(c, _sv(n), str(tmp_path / "ref"), every=2, mesh=mesh2)
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(n), d, every=2, mesh=mesh4),
             after=9)
    out = run_durable(c, _sv(n), d, every=2, mesh=mesh2, elastic=True)
    np.testing.assert_allclose(_amps(out), _amps(ref), atol=1e-5)
    assert ckpt.step_dirs(d) == []


# ---------------------------------------------------------------------------
# typed rejects: elastic relaxes WHERE, never WHAT
# ---------------------------------------------------------------------------


def test_mesh_mismatch_without_elastic_still_rejects_typed(tmp_path):
    mesh = _mesh(2)
    c = elastic_circuit()
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, mesh=mesh), after=5)
    with pytest.raises(DurableError, match="devices|num_steps|engine"):
        run_durable(c, _sv(), d, every=3, engine="banded")


def test_elastic_rejects_a_different_circuit_typed(tmp_path, portable_env):
    mesh = _mesh(2)
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(elastic_circuit(seed=7), _sv(), d, every=3,
                                 mesh=mesh), after=5)
    with pytest.raises(DurableError, match="sched_sha|plan_sha"):
        run_durable(elastic_circuit(seed=8), _sv(), d, every=3,
                    engine="banded", elastic=True)


def test_elastic_rejects_a_different_initial_state_typed(tmp_path,
                                                         portable_env):
    mesh = _mesh(2)
    c = elastic_circuit()
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, mesh=mesh), after=5)
    other = TS.init_classical_state(_sv(), 1)
    with pytest.raises(DurableError, match="state_efp"):
        run_durable(c, other, d, every=3, engine="banded", elastic=True)


def _strip_to_old_format(d):
    step, path = ckpt.step_dirs(d)[-1]
    meta, arrays = ckpt.load_arrays(path, require=("planes",))
    cursor = dict(meta["extra"])
    for k in ("sched_sha", "ops_total", "ops_done", "state_efp", "dtype",
              "density", "layout"):
        cursor.pop(k, None)
    ckpt.save_step(d, step, qureg=TS.Qureg(
        amps=torch.from_numpy(np.asarray(arrays["planes"])), num_qubits=N,
        is_density=False), extra=cursor)


def test_old_format_checkpoint_tolerant_same_mesh_loud_cross_mesh(
        tmp_path, portable_env):
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3,
                      engine="banded")
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, engine="banded"),
             after=5)
    _strip_to_old_format(d)
    out = run_durable(c, _sv(), d, every=3, engine="banded", elastic=True)
    np.testing.assert_array_equal(_amps(out), _amps(ref))
    d2 = str(tmp_path / "pre2")
    _preempt(lambda: run_durable(c, _sv(), d2, every=3, engine="banded"),
             after=5)
    _strip_to_old_format(d2)
    with pytest.raises(DurableError):
        run_durable(c, _sv(), d2, every=3, mesh=_mesh(2), elastic=True)


def test_elastic_skips_corrupt_newest_to_older_and_stays_exact(
        tmp_path, portable_env, capsys):
    mesh = _mesh(2)
    c = elastic_circuit(layers=4)
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=2,
                      engine="banded")
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=2, mesh=mesh, keep=3),
             after=9)
    dirs = ckpt.step_dirs(d)
    assert len(dirs) >= 2
    import os
    amps_path = os.path.join(dirs[-1][1], "amps.npz")
    blob = bytearray(open(amps_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(amps_path, "wb").write(bytes(blob))
    reg = metrics.Registry()
    out = run_durable(c, _sv(), d, every=2, engine="banded", elastic=True,
                      registry=reg)
    np.testing.assert_array_equal(_amps(out), _amps(ref))
    assert reg.counter("durable_corrupt_checkpoints_skipped").value >= 1
    assert "SKIPPING corrupt checkpoint" in capsys.readouterr().err


def test_load_step_elastic_mesh_reentry_matches_manual_path(tmp_path):
    c = elastic_circuit()
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, engine="banded"),
             after=5)
    step, path = ckpt.step_dirs(d)[-1]
    cursor, canon = ckpt.load_step_elastic(path)
    assert cursor["step"] == step
    perm = [int(p) for p in np.random.default_rng(0).permutation(N)]
    cursor2, placed = ckpt.load_step_elastic(path, mesh=_mesh(2), perm=perm)
    assert cursor2 == cursor
    got = np.concatenate([s.numpy() for s in placed.shards], axis=-1)
    np.testing.assert_array_equal(got, R.physicalize_planes(canon, perm))
    _, placed0 = ckpt.load_step_elastic(path, mesh=_mesh(2))
    np.testing.assert_array_equal(
        np.concatenate([s.numpy() for s in placed0.shards], -1), canon)


def test_elastic_cursor_fields_ride_every_state_checkpoint(tmp_path):
    c = elastic_circuit()
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, engine="banded"),
             after=5)
    cursor = ckpt.read_extra(ckpt.step_dirs(d)[-1][1])
    assert cursor["layout"] == "canonical"
    assert isinstance(cursor["sched_sha"], str)
    assert isinstance(cursor["ops_total"], int)
    assert isinstance(cursor["state_efp"], str)
    assert cursor["ops_done"] is None or isinstance(cursor["ops_done"], int)
    assert cursor["interpret"] is False and cursor["devices"] == 1


def test_quest_durable_elastic_knob_defaults_the_parameter(
        tmp_path, portable_env, monkeypatch):
    mesh = _mesh(2)
    c = elastic_circuit()
    ref = run_durable(c, _sv(), str(tmp_path / "ref"), every=3,
                      engine="banded")
    d = str(tmp_path / "pre")
    _preempt(lambda: run_durable(c, _sv(), d, every=3, mesh=mesh), after=5)
    monkeypatch.setenv("QUEST_DURABLE_ELASTIC", "1")
    out = run_durable(c, _sv(), d, every=3, engine="banded")
    np.testing.assert_array_equal(_amps(out), _amps(ref))


def test_sharded_register_enters_a_one_register_engine(tmp_path):
    """A sharded initial register with engine='banded' (no mesh) runs on
    one register: its shards copied, one by one, into the engine's
    buffer."""
    c = elastic_circuit()
    q = shard_qureg(TS.init_debug_state(_sv()), _mesh(4))
    out = run_durable(c, q, str(tmp_path / "x"), every=3, engine="banded")
    ref = run_durable(c, TS.init_debug_state(_sv()), str(tmp_path / "y"),
                      every=3, engine="banded")
    assert torch.is_tensor(out.amps)
    np.testing.assert_array_equal(_amps(out), _amps(ref))
