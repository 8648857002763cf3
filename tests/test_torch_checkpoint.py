"""The port's checkpoints (quest_tpu_torch/checkpoint.py) against the
reference's format 3 and its tests (mirrors tests/test_checkpoint.py).

Round trips are bit for bit; every way a file can be missing, truncated,
rotted, tampered with or from another format raises the one
CheckpointError naming the file and the mismatch; saves are atomic under
a crash at the commit point; the `ckpt-<step>` chain keeps the last K.
The reference's orbax cases become the port's per-shard npz files
(`save_sharded` / `load_sharded`: one file a shard, no gather, an
asynchronous save whose snapshot is taken before it returns). Across the
packages: a checkpoint the reference writes loads in the port, and one
the port writes loads in the reference, with bit-equal planes and equal
digests."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jqt
from quest_tpu import checkpoint as jckpt

from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch import env as TE
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import random_circuit
from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh, shard_qureg
from quest_tpu_torch.resilience import FaultPlan, faults
from quest_tpu_torch.validation import QuESTError

from . import oracle

pytestmark = pytest.mark.dtype_agnostic

N = 5


@pytest.fixture
def rng():
    return np.random.default_rng(20260729)


def _sv(v, dtype=np.complex128):
    return TS.init_state_from_amps(
        TS.create_qureg(int(np.log2(v.size)), dtype=dtype, device="cpu"),
        v.real, v.imag)


def _dense(q):
    amps = q.amps
    if isinstance(amps, ShardedAmps):
        planes = np.concatenate([s.numpy() for s in amps.shards], axis=-1)
    else:
        planes = np.asarray(amps).reshape(2, -1)
    return planes


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


def _saved(tmp_path, rng, n=3):
    q = _sv(oracle.random_statevector(n, rng))
    d = str(tmp_path / "ck")
    ckpt.save(q, d)
    return d


def test_save_load_statevector_roundtrip(tmp_path, rng):
    q = _sv(oracle.random_statevector(N, rng))
    ckpt.save(q, str(tmp_path / "ck"))
    q2 = ckpt.load(str(tmp_path / "ck"), device="cpu")
    assert q2.num_qubits == N and not q2.is_density
    np.testing.assert_array_equal(_dense(q2), _dense(q))


def test_save_load_density_roundtrip(tmp_path, rng):
    rho = oracle.random_density(3, rng)
    flat = rho.reshape(-1, order="F")
    q = TS.init_state_from_amps(TS.create_density_qureg(
        3, dtype=np.complex128, device="cpu"), flat.real, flat.imag)
    ckpt.save(q, str(tmp_path / "ck"))
    q2 = ckpt.load(str(tmp_path / "ck"), device="cpu")
    assert q2.is_density
    np.testing.assert_array_equal(TS.to_dense(q2), rho)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_load_into_sharded_env(tmp_path, rng, shards):
    """A checkpoint of one register restores onto a sharded one (a change
    of shard count between runs), and a sharded register saves through
    `save` into the same single-file format."""
    q = _sv(oracle.random_statevector(N, rng), np.complex64)
    ckpt.save(q, str(tmp_path / "ck"))
    env = TE.QuESTEnv(devices=["cpu"] * shards)
    q2 = ckpt.load(str(tmp_path / "ck"), env=env)
    assert isinstance(q2.amps, ShardedAmps) and q2.amps.mesh.size == shards
    np.testing.assert_array_equal(_dense(q2), _dense(q))
    ckpt.save(q2, str(tmp_path / "ck2"))
    np.testing.assert_array_equal(
        _dense(ckpt.load(str(tmp_path / "ck2"), device="cpu")), _dense(q))


def test_checkpoint_dtype_override(tmp_path, rng):
    v = oracle.random_statevector(3, rng)
    ckpt.save(_sv(v), str(tmp_path / "ck"))
    q2 = ckpt.load(str(tmp_path / "ck"), dtype=np.complex64, device="cpu")
    assert q2.real_dtype == np.dtype(np.float32)
    np.testing.assert_allclose(TS.to_dense(q2), v, atol=1e-6)


# -- the per-shard files: save_sharded / load_sharded -------------------------


@pytest.mark.parametrize("shards,target", [(2, 2), (4, 4), (8, 8), (4, 2),
                                           (2, 8), (4, None)])
def test_sharded_checkpoint_roundtrip(tmp_path, rng, shards, target):
    q = shard_qureg(_sv(oracle.random_statevector(N, rng)), _mesh(shards))
    d = str(tmp_path / "sck")
    ckpt.save_sharded(q, d)
    names = sorted(os.listdir(d))
    assert names == ["qureg_meta.json"] + [f"shard-{i}.npz"
                                           for i in range(shards)]
    with open(os.path.join(d, "qureg_meta.json")) as f:
        meta = json.load(f)
    assert meta["payload"] == "sharded" and meta["shards"] == shards
    assert meta["format_version"] == 3
    q2 = ckpt.load_sharded(d, mesh=None if target is None else _mesh(target),
                           device="cpu")
    if target is None:
        assert torch.is_tensor(q2.amps)
    else:
        assert q2.amps.mesh.size == target
    np.testing.assert_array_equal(_dense(q2), _dense(q))


def test_sharded_save_never_gathers(tmp_path, rng, monkeypatch):
    q = shard_qureg(_sv(oracle.random_statevector(N, rng)), _mesh(4))

    def refuse(self, device=None):
        raise AssertionError("save_sharded gathered the register")
    monkeypatch.setattr(ShardedAmps, "gather", refuse)
    ckpt.save_sharded(q, str(tmp_path / "s"))
    q2 = ckpt.load_sharded(str(tmp_path / "s"), mesh=_mesh(4))
    np.testing.assert_array_equal(_dense(q2), _dense(q))


def test_async_sharded_checkpoint(tmp_path):
    """save_sharded(block=False): the snapshot is taken before the call
    returns, the write runs on a thread while the register keeps
    evolving IN PLACE; wait() commits; the loaded state is the
    snapshot."""
    n = 6
    mesh = _mesh(4)
    q = TS.init_debug_state(shard_qureg(TS.create_qureg(n, device="cpu"),
                                        mesh))
    q = random_circuit(n, depth=2, seed=4).apply_sharded(q, mesh)
    snapshot = _dense(q).copy()
    pending = ckpt.save_sharded(q, str(tmp_path / "async"), block=False)
    random_circuit(n, depth=2, seed=5).apply_sharded(q, mesh)   # in place
    assert not np.array_equal(_dense(q), snapshot)
    pending.wait()
    assert pending.done
    restored = ckpt.load_sharded(str(tmp_path / "async"), mesh=mesh)
    np.testing.assert_array_equal(_dense(restored), snapshot)


def test_sharded_checkpoint_corruption_raises_checkpoint_error(tmp_path,
                                                               rng):
    q = shard_qureg(_sv(oracle.random_statevector(N, rng)), _mesh(4))
    d = str(tmp_path / "sck")
    ckpt.save_sharded(q, d)
    f = os.path.join(d, "shard-2.npz")
    with np.load(f) as z:
        planes = z["planes"].copy()
    planes[0, 0] += 1.0
    np.savez(f, planes=planes)
    with pytest.raises(ckpt.CheckpointError, match="shard-2.npz"):
        ckpt.load_sharded(d, mesh=_mesh(4))
    os.remove(f)
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.load_sharded(d, mesh=_mesh(4))
    # a one-file checkpoint is not a sharded payload, and the reverse
    d1 = _saved(tmp_path, rng)
    with pytest.raises(ckpt.CheckpointError, match="not a sharded"):
        ckpt.load_sharded(d1)
    ckpt.save_sharded(q, str(tmp_path / "s2"))
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load(str(tmp_path / "s2"))
    with pytest.raises(ckpt.CheckpointError, match="sharded register"):
        ckpt.save_sharded(_sv(oracle.random_statevector(3, rng)),
                          str(tmp_path / "s3"))


def test_async_save_error_surfaces_at_wait(tmp_path, rng):
    q = shard_qureg(_sv(oracle.random_statevector(N, rng)), _mesh(2))
    plan = FaultPlan().inject("checkpoint.save", times=1)
    with faults.active(plan):
        pending = ckpt.save_sharded(q, str(tmp_path / "a"), block=False)
        with pytest.raises(faults.InjectedFault):
            pending.wait()
    assert not os.path.exists(str(tmp_path / "a"))


# -- robustness: one clear CheckpointError, never a leaked internal -----------


def test_checkpoint_save_stamps_magic_and_version(tmp_path, rng):
    d = _saved(tmp_path, rng)
    with open(os.path.join(d, "qureg_meta.json")) as f:
        meta = json.load(f)
    assert meta["magic"] == "quest-checkpoint"
    assert meta["format_version"] == 3
    assert sorted(meta["plane_digests"]) == ["planes[im]", "planes[re]"]
    for v in meta["plane_digests"].values():
        assert len(v) == 64 and int(v, 16) >= 0


def test_checkpoint_truncated_npz_raises_checkpoint_error(tmp_path, rng):
    d = _saved(tmp_path, rng)
    amps = os.path.join(d, "amps.npz")
    raw = open(amps, "rb").read()
    with open(amps, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(ckpt.CheckpointError, match="corrupt or truncated"):
        ckpt.load(d, device="cpu")
    with open(amps, "wb") as f:
        f.write(b"not a zip archive at all")
    with pytest.raises(ckpt.CheckpointError, match="amps.npz"):
        ckpt.load(d, device="cpu")


def test_checkpoint_missing_planes_key_raises(tmp_path, rng):
    d = _saved(tmp_path, rng)
    np.savez(os.path.join(d, "amps.npz"), wrong_name=np.zeros(4))
    with pytest.raises(ckpt.CheckpointError, match="no 'planes' array"):
        ckpt.load(d, device="cpu")


def test_checkpoint_wrong_register_size_names_the_mismatch(tmp_path, rng):
    d = _saved(tmp_path, rng, n=3)
    meta_path = os.path.join(d, "qureg_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["num_qubits"] = 4
    meta["meta_digest"] = ckpt._meta_digest(meta)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.load(d, device="cpu")
    msg = str(ei.value)
    assert "amps.npz" in msg and "4-qubit" in msg
    assert "(2, 8)" in msg and "(2, 16)" in msg


def test_checkpoint_meta_corruption_modes(tmp_path, rng):
    d = _saved(tmp_path, rng)
    meta_path = os.path.join(d, "qureg_meta.json")
    good = open(meta_path).read()
    cases = [(good[:10], "not parseable JSON")]
    for key, val, match in (("magic", "somebody-else", "magic"),
                            ("format_version", 99, "newer than")):
        meta = json.loads(good)
        meta[key] = val
        cases.append((json.dumps(meta), match))
    meta = json.loads(good)
    del meta["num_qubits"]
    cases.append((json.dumps(meta), "num_qubits"))
    for text, match in cases:
        with open(meta_path, "w") as f:
            f.write(text)
        with pytest.raises(ckpt.CheckpointError, match=match):
            ckpt.load(d, device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="not a checkpoint"):
        ckpt.load(str(tmp_path / "nowhere"), device="cpu")


def test_checkpoint_pre_field_meta_loads_tolerantly(tmp_path, rng):
    q = _sv(oracle.random_statevector(3, rng))
    d = str(tmp_path / "old")
    ckpt.save(q, d)
    meta_path = os.path.join(d, "qureg_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["magic"]
    meta["format_version"] = 1
    for k in ("plane_digests", "meta_digest"):
        meta.pop(k, None)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    ckpt._legacy_warned = False
    np.testing.assert_array_equal(_dense(ckpt.load(d, device="cpu")),
                                  _dense(q))


def test_checkpoint_error_is_a_quest_error():
    assert issubclass(ckpt.CheckpointError, QuESTError)


def test_checkpoint_digest_failure_names_the_plane(tmp_path, rng):
    d = _saved(tmp_path, rng)
    f = os.path.join(d, "amps.npz")
    with np.load(f) as z:
        pristine = {k: z[k].copy() for k in z.files}
    for plane, name in ((1, r"planes\[im\]"), (0, r"planes\[re\]")):
        rotted = {k: v.copy() for k, v in pristine.items()}
        rotted["planes"][plane, 2] += 1.0
        np.savez(f, **rotted)
        with pytest.raises(ckpt.CheckpointError, match=name) as ei:
            ckpt.load(d, device="cpu")
        assert "expected sha256" in str(ei.value)


def test_checkpoint_v2_loads_tolerantly_with_one_warning(tmp_path, rng,
                                                         capsys):
    q = _sv(oracle.random_statevector(3, rng))
    d = str(tmp_path / "v2")
    ckpt.save(q, d)
    meta_path = os.path.join(d, "qureg_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["plane_digests"]
    del meta["meta_digest"]
    meta["format_version"] = 2
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    ckpt._legacy_warned = False
    np.testing.assert_array_equal(_dense(ckpt.load(d, device="cpu")),
                                  _dense(q))
    first = capsys.readouterr().err
    assert "format_version 2" in first and "no per-plane checksums" in first
    ckpt.load(d, device="cpu")
    assert "format_version" not in capsys.readouterr().err


def test_v3_meta_with_stripped_digests_refuses_to_load(tmp_path, rng):
    d = _saved(tmp_path, rng)
    meta_path = os.path.join(d, "qureg_meta.json")
    good = open(meta_path).read()
    meta = json.loads(good)
    del meta["plane_digests"]
    variants = [(dict(meta), "self-digest")]
    m2 = dict(meta)
    del m2["meta_digest"]
    variants.append((m2, "meta_digest"))
    m3 = dict(m2)
    m3["meta_digest"] = ckpt._meta_digest(m3)
    variants.append((m3, "plane_digests"))
    for m, match in variants:
        with open(meta_path, "w") as f:
            json.dump(m, f)
        with pytest.raises(ckpt.CheckpointError, match=match):
            ckpt.load(d, device="cpu")


def test_tampered_cursor_fails_the_meta_self_digest(tmp_path, rng):
    q = _sv(oracle.random_statevector(3, rng))
    root = str(tmp_path / "chain")
    ckpt.save_step(root, 8, qureg=q, extra={"kind": "state", "step": 8})
    path = ckpt.step_path(root, 8)
    meta_path = os.path.join(path, "qureg_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["extra"]["step"] = 7
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ckpt.CheckpointError, match="self-digest"):
        ckpt.load_arrays(path)


def test_checkpoint_save_is_atomic_under_midsave_crash(tmp_path, rng):
    v = oracle.random_statevector(3, rng)
    d = str(tmp_path / "ck")
    ckpt.save(_sv(v), d)
    before = _dense(ckpt.load(d, device="cpu"))
    q2 = _sv(-v)
    plan = FaultPlan().inject("checkpoint.save", times=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            ckpt.save(q2, d)
    assert plan.fired() == 1
    np.testing.assert_array_equal(_dense(ckpt.load(d, device="cpu")), before)
    assert sorted(os.listdir(tmp_path)) == ["ck"]      # no temp left
    ckpt.save(q2, d)
    np.testing.assert_array_equal(_dense(ckpt.load(d, device="cpu")),
                                  -before)


def test_checkpoint_load_fault_site_fires(tmp_path, rng):
    d = _saved(tmp_path, rng)
    plan = FaultPlan().inject("checkpoint.load", times=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            ckpt.load(d, device="cpu")
        ckpt.load(d, device="cpu")
    assert plan.fired("checkpoint.load") == 1


def test_save_step_keeps_last_k(tmp_path, rng, monkeypatch):
    q = _sv(oracle.random_statevector(3, rng))
    root = str(tmp_path / "chain")
    for step in (2, 4, 6):
        ckpt.save_step(root, step, qureg=q, extra={"step": step})
    assert [s for s, _ in ckpt.step_dirs(root)] == [4, 6]
    ckpt.save_step(root, 8, qureg=q, keep=1)
    assert [s for s, _ in ckpt.step_dirs(root)] == [8]
    assert ckpt.read_extra(ckpt.step_path(root, 8)) is None
    with pytest.raises(ValueError):
        ckpt.prune_steps(root, keep=0)
    monkeypatch.setenv("QUEST_CHECKPOINT_KEEP", "3")
    for step in (10, 12, 14):
        ckpt.save_step(root, step, qureg=q)
    assert [s for s, _ in ckpt.step_dirs(root)] == [10, 12, 14]
    assert ckpt.step_path(root, 123456789).endswith("ckpt-123456789")


def test_step_dirs_ignores_uncommitted_temp_dirs(tmp_path, rng):
    q = _sv(oracle.random_statevector(3, rng))
    root = str(tmp_path / "chain")
    ckpt.save_step(root, 3, qureg=q)
    os.makedirs(os.path.join(root, "ckpt-00000009.tmp-123-abc"))
    os.makedirs(os.path.join(root, "ckpt-00000002.old-99-dead"))
    os.makedirs(os.path.join(root, "unrelated"))
    assert [s for s, _ in ckpt.step_dirs(root)] == [3]
    ckpt.save_step(root, 5, qureg=q)
    assert sorted(os.listdir(root)) == ["ckpt-00000003", "ckpt-00000005",
                                        "unrelated"]


def test_save_refuses_to_replace_a_non_checkpoint_directory(tmp_path,
                                                            rng):
    q = _sv(oracle.random_statevector(3, rng))
    d = str(tmp_path / "work")
    os.makedirs(d)
    with open(os.path.join(d, "precious.txt"), "w") as f:
        f.write("user data")
    with pytest.raises(ValueError, match="not a checkpoint"):
        ckpt.save(q, d)
    assert os.path.exists(os.path.join(d, "precious.txt"))
    d2 = str(tmp_path / "empty")
    os.makedirs(d2)
    ckpt.save(q, d2)
    np.testing.assert_array_equal(_dense(ckpt.load(d2, device="cpu")),
                                  _dense(q))


def test_save_arrays_roundtrip_and_load_rejects(tmp_path):
    root = str(tmp_path / "arr")
    planes = np.arange(24, dtype=np.float32).reshape(2, 12)
    draws = torch.arange(6, dtype=torch.int32)
    ckpt.save_arrays(root, {"planes": planes, "draws": draws},
                     extra={"kind": "traj"})
    meta, arrays = ckpt.load_arrays(root)
    assert meta["extra"] == {"kind": "traj"}
    np.testing.assert_array_equal(arrays["planes"], planes)
    np.testing.assert_array_equal(arrays["draws"], draws.numpy())
    with pytest.raises(ckpt.CheckpointError, match="arrays"):
        ckpt.load(root)
    with pytest.raises(ValueError, match="re"):
        ckpt.save_arrays(str(tmp_path / "bad"), {"x[re]": np.arange(4.0)})


def test_gang_steps_are_recognised_and_refused_typed(tmp_path):
    path = str(tmp_path / "ckpt-00000004")
    os.makedirs(path)
    open(os.path.join(path, "meta-0.json"), "w").write("{}")
    assert ckpt.is_gang_step(path)
    with pytest.raises(ckpt.CheckpointError, match="A10c"):
        ckpt.load_step_elastic(path)
    with pytest.raises(ckpt.CheckpointError, match="A10c"):
        ckpt.save_step_gang(str(tmp_path), 4)


# -- across the packages ------------------------------------------------------


@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_reference_checkpoints_load_in_the_port(tmp_path, rng, density,
                                                cdt):
    if density:
        flat = oracle.random_density(3, rng).reshape(-1, order="F")
        jq = jqt.create_density_qureg(3, dtype=cdt)
    else:
        flat = oracle.random_statevector(N, rng)
        jq = jqt.create_qureg(N, dtype=cdt)
    rdt = np.float32 if cdt == np.complex64 else np.float64
    planes = np.stack([flat.real, flat.imag]).astype(rdt)
    jq = jq.replace_amps(jnp.asarray(planes))
    d = str(tmp_path / "ref")
    jckpt.save(jq, d, extra={"kind": "x", "step": 3})
    q = ckpt.load(d, device="cpu")
    assert q.is_density == density and q.real_dtype == np.dtype(rdt)
    np.testing.assert_array_equal(_dense(q), planes)
    assert ckpt.read_extra(d) == {"kind": "x", "step": 3}
    # the port's save of the same register: the same digests, both ways
    d2 = str(tmp_path / "port")
    ckpt.save(q, d2, extra={"kind": "x", "step": 3})
    m1 = json.load(open(os.path.join(d, "qureg_meta.json")))
    m2 = json.load(open(os.path.join(d2, "qureg_meta.json")))
    assert m1["plane_digests"] == m2["plane_digests"]
    assert m1 == m2                          # meta_digest included
    back = jckpt.load(d2)
    np.testing.assert_array_equal(np.asarray(back.amps), planes)


def test_step_chains_interchange(tmp_path, rng):
    q = _sv(oracle.random_statevector(N, rng))
    root = str(tmp_path / "chain")
    ckpt.save_step(root, 4, qureg=q, extra={"kind": "state", "step": 4,
                                            "layout": "canonical"})
    assert [s for s, _ in jckpt.step_dirs(root)] == [4]
    meta, arrays = jckpt.load_arrays(ckpt.step_path(root, 4))
    np.testing.assert_array_equal(arrays["planes"], _dense(q))
    cursor, planes = ckpt.load_step_elastic(ckpt.step_path(root, 4))
    assert cursor["step"] == 4
    np.testing.assert_array_equal(planes, _dense(q))
    jcur, jplanes = jckpt.load_step_elastic(ckpt.step_path(root, 4))
    assert jcur == cursor
    np.testing.assert_array_equal(np.asarray(jplanes), planes)


def test_load_step_elastic_mesh_reentry(tmp_path, rng):
    from quest_tpu_torch.parallel import relabel as R
    q = _sv(oracle.random_statevector(N, rng))
    root = str(tmp_path / "chain")
    ckpt.save_step(root, 2, qureg=q, extra={"kind": "state", "step": 2,
                                            "layout": "canonical"})
    path = ckpt.step_path(root, 2)
    _, canon = ckpt.load_step_elastic(path)
    perm = [int(p) for p in np.random.default_rng(0).permutation(N)]
    _, placed = ckpt.load_step_elastic(path, mesh=_mesh(2), perm=perm)
    assert isinstance(placed, ShardedAmps) and placed.mesh.size == 2
    got = np.concatenate([s.numpy() for s in placed.shards], axis=-1)
    np.testing.assert_array_equal(got, R.physicalize_planes(canon, perm))
    # a physical-layout cursor normalizes through its perm
    ckpt.save_step(root, 3, qureg=q.replace_amps(torch.from_numpy(
        R.physicalize_planes(canon, perm).copy())),
        extra={"kind": "state", "step": 3, "perm": perm})
    _, back = ckpt.load_step_elastic(ckpt.step_path(root, 3))
    np.testing.assert_array_equal(back, canon)
    ckpt.save_step(root, 5, qureg=q, extra={"kind": "traj", "step": 5})
    with pytest.raises(ckpt.CheckpointError, match="state cursor"):
        ckpt.load_step_elastic(ckpt.step_path(root, 5))
