"""The port's durable executor (quest_tpu_torch/resilience/durable.py),
mirroring tests/test_durable.py (its two slow cases aside).

A preempted run (a `durable.preempt` or `durable.step` FaultPlan) resumes
from its newest valid checkpoint and ends BIT-IDENTICAL to the
uninterrupted run on every engine: banded (fusion-plan items), fused
(the sweep plan's parts: kernel launches through the segment kernel's
plain version here, so also bit for bit the port's own `compiled_fused`)
and sharded (the sharded fused program's parts on 2 and 4 CPU shards,
the relabel permutation in the cursor); the trajectory executor resumes
bit-identical to trajectories.run_batched from the same generator state.
Corrupt, tampered or unreadable checkpoints are skipped loudly, never
consumed; the sentinels refuse to stamp a NaN'd, drifted or
non-Hermitian state (per shard on a mesh); knob flips, edited circuits
and other initial states are refused typed; a warm resume builds
nothing. The fused durable runs are also held against the reference's
`compiled_banded` within 2e-5 x max|amp| at 10-12 qubits; a checkpoint
chain the reference wrote is refused typed by a strict resume and read
by checkpoint.load_step_elastic."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jqt
from quest_tpu.circuit import Circuit as JCircuit
from quest_tpu.resilience import durable as jdurable

from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch import state as TS
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit, qft_circuit, random_circuit
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import segment as SEG
from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh, shard_qureg
from quest_tpu_torch.resilience import (DurableError, FaultPlan,
                                        IntegrityError, faults, run_durable,
                                        run_durable_trajectories)
from quest_tpu_torch.resilience import durable as D
from quest_tpu_torch.serve import metrics
from quest_tpu_torch.validation import QuESTError

from .test_torch_comm import _one_thread_per_worker  # noqa: F401

pytestmark = pytest.mark.dtype_agnostic


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


def scattered_circuit(C, n, layers, seed=11):
    """bench._build_durable_circuit on either package's Circuit: rotation
    layers split by random 2q unitaries on far-apart qubits, so every
    engine's plan has genuine cut points."""
    rng = np.random.default_rng(seed)
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
            c.ry(q, float(rng.uniform(0, 2 * np.pi)))
        m = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
        u, _ = np.linalg.qr(m)
        c.gate(u, (layer % (n // 2), n - 1 - (layer % (n // 2))))
    return c


def preempt(runner, after, times=1, site="durable.preempt"):
    plan = FaultPlan().inject(site, after_n=after, times=times)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            runner()
    assert plan.fired() == times
    return plan


def amps_of(q):
    amps = q.amps
    if isinstance(amps, ShardedAmps):
        return np.concatenate([s.numpy() for s in amps.shards], axis=-1)
    return amps.numpy().reshape(2, -1)


def debug(n):
    return TS.init_debug_state(TS.create_qureg(n, device="cpu"))


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


# ---------------------------------------------------------------------------
# resume bit-identity, per engine
# ---------------------------------------------------------------------------


def test_resume_bit_identity_banded(tmp_path):
    c = qft_circuit(9)
    q0 = debug(9)
    before = amps_of(q0).copy()
    ref = run_durable(c, q0, str(tmp_path / "ref"), every=2, engine="banded")
    np.testing.assert_array_equal(amps_of(q0), before)   # input untouched
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, q0, d, every=2, engine="banded"), after=7)
    assert ckpt.step_dirs(d)
    out = run_durable(c, q0, d, every=2, engine="banded")
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))
    # the whole banded program runs the same items in the same order
    prog = c.compiled_banded(9, device="cpu")
    np.testing.assert_array_equal(
        amps_of(out), prog(torch.from_numpy(before.copy())).numpy())
    assert ckpt.step_dirs(d) == []


def test_step_fault_mid_run_resumes_bit_identical(tmp_path):
    c = qft_circuit(9)
    q0 = debug(9)
    ref = run_durable(c, q0, str(tmp_path / "ref"), every=2, engine="banded")
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, q0, d, every=2, engine="banded"),
            after=5, site="durable.step")
    assert ckpt.step_dirs(d)
    out = run_durable(c, q0, d, every=2, engine="banded")
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


@pytest.mark.parametrize("n,sweep", [(10, "1"), (12, "0")])
def test_resume_bit_identity_fused(tmp_path, monkeypatch, n, sweep):
    """Each fused step is one part of the port's own sweep plan under
    HOPPER_GEOMETRY (one segment launch or one passthrough); a resume
    ends bit for bit the uninterrupted durable run AND the port's
    `compiled_fused` program, and within tolerance of the reference's
    compiled_banded."""
    monkeypatch.setenv("QUEST_SWEEP_FUSION", sweep)
    c = scattered_circuit(Circuit, n, 12, seed=2)
    q0 = debug(n)
    before = amps_of(q0).copy()
    steps, info = D._build_steps(c, n, False, "fused", None,
                                 torch.device("cpu"), True)
    assert len(steps) >= (2 if sweep == "1" else 3)
    assert info["layout"] == "fused"
    ref = run_durable(c, q0, str(tmp_path / "ref"), every=1, engine="fused")
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, q0, d, every=1, engine="fused"),
            after=len(steps) - 1)
    out = run_durable(c, q0, d, every=1, engine="fused")
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))
    prog = c.compiled_fused(n, device="cpu")
    np.testing.assert_array_equal(
        amps_of(out), prog(torch.from_numpy(before.copy())).numpy())
    jc = scattered_circuit(JCircuit, n, 12, seed=2)
    want = np.asarray(jc.compiled_banded(n, False, donate=False)(
        jnp.asarray(before)))
    assert np.abs(amps_of(out) - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("shards", [2, 4])
def test_resume_bit_identity_sharded(tmp_path, shards):
    mesh = _mesh(shards)
    n = 11
    c = scattered_circuit(Circuit, n, 6)
    q0 = debug(n)
    ref = run_durable(c, q0, str(tmp_path / "ref"), every=2, mesh=mesh)
    assert isinstance(ref.amps, ShardedAmps)
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, q0, d, every=2, mesh=mesh), after=5)
    dirs = ckpt.step_dirs(d)
    assert dirs
    cursor = ckpt.read_extra(dirs[-1][1])
    assert cursor["engine"] == "sharded" and cursor["devices"] == shards
    assert isinstance(cursor["perm"], list) and len(cursor["perm"]) == n
    assert cursor["layout"] == "canonical"
    out = run_durable(c, q0, d, every=2, mesh=mesh)
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))
    # the steps are the sharded fused program's parts (kernel-tier shards
    # on f32 planes) or its banded items: the whole program, bit for bit
    prog = (c.compiled_sharded_fused(n, False, mesh)
            if n - (shards.bit_length() - 1) >= 10
            else c.compiled_sharded_banded(n, False, mesh))
    whole = prog(shard_qureg(debug(n), mesh).amps)
    np.testing.assert_array_equal(
        amps_of(out), np.concatenate([s.numpy() for s in whole.shards], -1))
    # a sharded initial register runs on its own mesh
    out2 = run_durable(c, shard_qureg(debug(n), mesh), str(tmp_path / "s"),
                       every=2)
    np.testing.assert_array_equal(amps_of(out2), amps_of(ref))


def test_sharded_strict_resume_keeps_a_nontrivial_perm(tmp_path):
    """Canonical-order saves of a relabel-heavy circuit: the cut's perm is
    not the identity and the strict resume still lands bit for bit."""
    mesh = _mesh(4)
    n = 8
    rng = np.random.default_rng(11)
    c = Circuit(n)
    for _ in range(6):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
            c.ry(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(0, n - 1, 2):
            c.cz(q, q + 1)
    ref = run_durable(c, debug(n), str(tmp_path / "ref"), every=2,
                      mesh=mesh)
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, debug(n), d, every=2, mesh=mesh),
            after=9)
    cursor = ckpt.read_extra(ckpt.step_dirs(d)[-1][1])
    assert cursor["layout"] == "canonical"
    assert cursor["perm"] != list(range(n))
    out = run_durable(c, debug(n), d, every=2, mesh=mesh)
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))
    assert ckpt.step_dirs(d) == []


def _noisy(n):
    c = Circuit(n)
    for q in range(n):
        c.h(q)
        c.depolarising(q, 0.1)
    c.damping(0, 0.3)
    return c


@pytest.mark.parametrize("engine", ["banded", "fused"])
def test_resume_bit_identity_trajectories(tmp_path, engine):
    n = 4 if engine == "banded" else 10
    c = _noisy(n)
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable_trajectories(
        c, torch.Generator().manual_seed(7), 10, d, every=1, chunk=4,
        engine=engine, device="cpu"), after=2)
    assert ckpt.step_dirs(d)
    planes, draws = run_durable_trajectories(
        c, torch.Generator().manual_seed(7), 10, d, every=1, chunk=4,
        engine=engine, device="cpu")
    rp, rd = T.run_batched(c, 10, generator=torch.Generator().manual_seed(7),
                           chunk=4, engine=engine, device="cpu")
    np.testing.assert_array_equal(planes.numpy(), rp.numpy())
    np.testing.assert_array_equal(draws.numpy(), rd.numpy())
    assert ckpt.step_dirs(d) == []


def test_trajectory_resume_rejects_a_different_generator(tmp_path):
    c = Circuit(3)
    for q in range(3):
        c.h(q)
        c.dephasing(q, 0.2)
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable_trajectories(
        c, torch.Generator().manual_seed(1), 8, d, every=1, chunk=2,
        device="cpu"), after=1)
    with pytest.raises(DurableError, match="key_fp"):
        run_durable_trajectories(c, torch.Generator().manual_seed(2), 8, d,
                                 every=1, chunk=2, device="cpu")


@pytest.mark.parametrize("shards", [None, 2])
def test_density_durable_matches_engine(tmp_path, shards):
    c = random_circuit(3, 3, seed=1)
    c.damping(1, 0.2)
    q0 = TS.create_density_qureg(3, device="cpu")
    mesh = _mesh(shards) if shards else None
    out = run_durable(c, q0, str(tmp_path / "dm"), every=2,
                      engine=None if shards else "banded", mesh=mesh)
    want = amps_of(c.apply(TS.create_density_qureg(3, device="cpu")))
    np.testing.assert_allclose(amps_of(out), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# corruption: on disk and in flight
# ---------------------------------------------------------------------------


def _preempted_banded(tmp_path, after=7):
    c = qft_circuit(9)
    q0 = debug(9)
    ref = run_durable(c, q0, str(tmp_path / "ref"), every=2, engine="banded")
    d = str(tmp_path / "pre")
    preempt(lambda: run_durable(c, q0, d, every=2, engine="banded"),
            after=after)
    return c, q0, ref, d


def test_corrupt_checkpoint_skipped_loudly_never_consumed(tmp_path, capsys):
    c, q0, ref, d = _preempted_banded(tmp_path)
    dirs = ckpt.step_dirs(d)
    assert len(dirs) == 2, dirs
    f = os.path.join(dirs[-1][1], "amps.npz")
    with np.load(f) as z:
        arrs = {k: z[k].copy() for k in z.files}
    arrs["planes"][0, 5] += 0.5
    np.savez(f, **arrs)
    reg = metrics.Registry()
    out = run_durable(c, q0, d, every=2, engine="banded", registry=reg)
    err = capsys.readouterr().err
    assert "SKIPPING corrupt checkpoint" in err
    assert "fails its integrity digest" in err
    assert reg.counter("durable_corrupt_checkpoints_skipped").value == 1
    assert reg.counter("durable_resumes").value == 1
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_tampered_cursor_is_skipped_never_resumed(tmp_path, capsys):
    c, q0, ref, d = _preempted_banded(tmp_path, after=9)
    meta_path = os.path.join(ckpt.step_dirs(d)[-1][1], "qureg_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["extra"]["step"] -= 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    out = run_durable(c, q0, d, every=2, engine="banded")
    assert "SKIPPING corrupt checkpoint" in capsys.readouterr().err
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_every_checkpoint_corrupt_restarts_from_op0(tmp_path, capsys):
    c, q0, ref, d = _preempted_banded(tmp_path)
    for _, path in ckpt.step_dirs(d):
        with open(os.path.join(path, "amps.npz"), "wb") as f:
            f.write(b"rotten")
    out = run_durable(c, q0, d, every=2, engine="banded")
    assert capsys.readouterr().err.count("SKIPPING corrupt") == 2
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_injected_load_fault_skips_to_older_checkpoint(tmp_path, capsys):
    c, q0, ref, d = _preempted_banded(tmp_path)
    plan = FaultPlan().inject("checkpoint.load", times=1)
    with faults.active(plan):
        out = run_durable(c, q0, d, every=2, engine="banded")
    assert plan.fired() == 1
    assert "SKIPPING corrupt checkpoint" in capsys.readouterr().err
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_midsave_crash_leaves_the_chain_resumable(tmp_path):
    c, q0, ref, d = _preempted_banded(tmp_path)
    preempt(lambda: run_durable(c, q0, d, every=2, engine="banded"),
            after=0, site="checkpoint.save")
    out = run_durable(c, q0, d, every=2, engine="banded")
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_sentinel_trips_on_nan_and_refuses_to_stamp(tmp_path):
    c = qft_circuit(9)
    c.ops.insert(2, c.ops[0].__class__(
        "matrix", (1,), operand=np.array([[np.nan, 0], [0, 1]])))
    c._compiled.clear()
    d = str(tmp_path / "nan")
    reg = metrics.Registry()
    with pytest.raises(IntegrityError, match="norm"):
        run_durable(c, debug(9), d, every=1, engine="banded", registry=reg)
    assert reg.counter("durable_sentinel_trips").value == 1
    for _, path in ckpt.step_dirs(d):
        assert np.isfinite(amps_of(ckpt.load(path, device="cpu"))).all()


@pytest.mark.parametrize("mesh", [None, 2])
def test_sentinel_trips_on_norm_drift(tmp_path, mesh):
    c = Circuit(5).h(0)
    c.gate(2.0 * np.eye(2), (1,))
    with pytest.raises(IntegrityError, match="drift"):
        run_durable(c, debug(5), str(tmp_path / "drift"),
                    mesh=_mesh(mesh) if mesh else None)


def test_integrity_off_knob_disables_sentinels(tmp_path, monkeypatch):
    monkeypatch.setenv("QUEST_INTEGRITY", "0")
    c = Circuit(5).h(0)
    c.gate(2.0 * np.eye(2), (1,))
    run_durable(c, debug(5), str(tmp_path / "off"))


@pytest.mark.parametrize("shards", [None, 2, 4])
def test_density_sentinel_trips_on_hermiticity_break(shards):
    q = random_circuit(3, 2, seed=3).apply(
        TS.create_density_qureg(3, device="cpu"))
    info = {"density": True, "n": 6}
    amps = q.amps if shards is None else shard_qureg(q, _mesh(shards)).amps
    base = D._sentinel_values(amps, info)
    assert base["herm_residual"] <= 1e-5
    assert base["trace_re"] == pytest.approx(1.0, abs=1e-5)
    bad = amps_of(q).copy()
    bad[1, 9] += 1.0                     # rho[1, 1] gains an imaginary part
    t = torch.from_numpy(bad)
    bad_amps = t if shards is None else shard_qureg(
        q.replace_amps(t), _mesh(shards)).amps
    vals = D._sentinel_values(bad_amps, info)
    with pytest.raises(IntegrityError, match="herm_residual|trace_im"):
        D._check_integrity(vals, base, 1e-3, step=1)


# ---------------------------------------------------------------------------
# resume-chain contracts
# ---------------------------------------------------------------------------


def test_resume_under_flipped_knob_raises_typed(tmp_path, monkeypatch):
    c, q0, ref, d = _preempted_banded(tmp_path)
    monkeypatch.setenv("QUEST_SCHEDULE", "0")
    with pytest.raises(DurableError, match="mode_key|num_steps"):
        run_durable(c, q0, d, every=2, engine="banded")
    monkeypatch.delenv("QUEST_SCHEDULE")
    out = run_durable(c, q0, d, every=2, engine="banded")
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


def test_resume_rejects_an_edited_circuit(tmp_path):
    import dataclasses
    c, q0, ref, d = _preempted_banded(tmp_path)
    c2 = qft_circuit(9)
    for i, op in enumerate(c2.ops):
        if op.kind == "allones":
            c2.ops[i] = dataclasses.replace(
                op, operand=op.operand * np.exp(0.001j))
            break
    c2._compiled.clear()
    with pytest.raises(DurableError, match="plan_sha"):
        run_durable(c2, q0, d, every=2, engine="banded")


def test_resume_rejects_a_different_initial_state(tmp_path):
    c, q0, ref, d = _preempted_banded(tmp_path)
    with pytest.raises(DurableError, match="state_fp"):
        run_durable(c, TS.create_qureg(9, device="cpu"), d, every=2,
                    engine="banded")


def test_resume_rejects_another_mesh_or_engine_typed(tmp_path):
    c, q0, ref, d = _preempted_banded(tmp_path)
    with pytest.raises(DurableError, match="engine|devices|num_steps"):
        run_durable(c, q0, d, every=2, mesh=_mesh(2))


def test_corrupt_checkpoint_with_shrunken_planes_is_skipped(tmp_path,
                                                            capsys):
    c, q0, ref, d = _preempted_banded(tmp_path)
    f = os.path.join(ckpt.step_dirs(d)[-1][1], "amps.npz")
    np.savez(f, planes=np.zeros((1,), dtype=np.float32))
    out = run_durable(c, q0, d, every=2, engine="banded")
    assert "SKIPPING corrupt checkpoint" in capsys.readouterr().err
    np.testing.assert_array_equal(amps_of(out), amps_of(ref))


@pytest.mark.parametrize("engine", ["banded", "fused", "sharded"])
def test_warm_resume_builds_nothing(tmp_path, monkeypatch, engine):
    """One preempt+resume cycle builds the step programs (cached on the
    circuit); a second cycle prepares no segment and plans nothing."""
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    n = 11
    c = scattered_circuit(Circuit, n, 4)
    mesh = _mesh(2) if engine == "sharded" else None
    kw = dict(every=1, mesh=mesh,
              engine=None if engine == "sharded" else engine)
    steps, _ = D._build_steps(c, n, False, engine, mesh,
                              torch.device("cpu"), True)
    after = len(steps) - 1
    assert after >= 1
    d = str(tmp_path / "warm")
    preempt(lambda: run_durable(c, debug(n), d, **kw), after=after)
    run_durable(c, debug(n), d, **kw)
    calls = []
    real_prepare, real_plan = SEG.prepare_segment, F.plan

    def count(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(SEG, "prepare_segment", count(real_prepare))
    monkeypatch.setattr(F, "plan", count(real_plan))
    d2 = str(tmp_path / "again")
    preempt(lambda: run_durable(c, debug(n), d2, **kw), after=after)
    run_durable(c, debug(n), d2, **kw)
    assert calls == []


def test_durable_rejects_dynamic_circuits(tmp_path):
    c = Circuit(3).h(0)
    c.measure(0)
    with pytest.raises(QuESTError, match="run_durable"):
        run_durable(c, debug(3), str(tmp_path / "dyn"))


def test_durable_validates_arguments(tmp_path):
    c = Circuit(3).h(0)
    q0 = debug(3)
    with pytest.raises(ValueError, match="every"):
        run_durable(c, q0, str(tmp_path / "x"), every=0)
    with pytest.raises(ValueError, match="mesh"):
        run_durable(c, q0, str(tmp_path / "x"), engine="sharded")
    with pytest.raises(ValueError, match="engine"):
        run_durable(c, q0, str(tmp_path / "x"), engine="warp")
    with pytest.raises(ValueError, match="mesh"):
        run_durable(c, q0, str(tmp_path / "x"), engine="banded",
                    mesh=_mesh(2))
    with pytest.raises(ValueError, match="shadow"):
        run_durable(c, q0, str(tmp_path / "x"), cursor_extra={"step": 1})


def test_knob_cadence_and_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv("QUEST_DURABLE_EVERY", "3")
    c, q0 = qft_circuit(9), debug(9)
    steps, _ = D._build_steps(c, 9, False, "banded", None,
                              torch.device("cpu"), True)
    reg = metrics.Registry()
    d = str(tmp_path / "k")
    preempt(lambda: run_durable(c, q0, d, engine="banded", registry=reg),
            after=len(steps) - 1)
    saved = reg.counter("durable_checkpoints_saved").value
    assert saved == (len(steps) - 1) // 3
    assert [s for s, _ in ckpt.step_dirs(d)][-1] == 3 * saved
    snap = reg.snapshot()
    assert snap["gauges"]["durable_last_checkpoint_step"] == 3 * saved
    assert snap["histograms"]["durable_checkpoint_s"]["count"] == saved


def test_state_fingerprints_are_layout_independent():
    for n in (6, 11):
        q = debug(n)
        for d in (2, 4):
            s = shard_qureg(q, _mesh(d))
            assert D._state_fingerprint(s) == D._state_fingerprint(q)
            assert (D._state_fingerprint_elastic(s)
                    == D._state_fingerprint_elastic(q))
    # the exact elastic fingerprint equals the reference's bit-sum
    for cdt in (np.complex64, np.complex128):
        q = TS.init_debug_state(TS.create_qureg(7, dtype=cdt, device="cpu"))
        jq = jqt.init_debug_state(jqt.create_qureg(7, dtype=cdt))
        assert (D._state_fingerprint_elastic(q)
                == jdurable._state_fingerprint_elastic(jq))
        assert D._state_fingerprint(q) == jdurable._state_fingerprint(jq)
        assert D._ops_sha(qft_circuit(5).ops) == jdurable._ops_sha(
            __import__("quest_tpu.circuit", fromlist=["qft_circuit"])
            .qft_circuit(5).ops)


def test_reference_chain_is_refused_strictly_and_read_elastically(tmp_path):
    """A chain the reference wrote: its cursor cannot match the port's
    plan (mode key, steps), so a strict resume is refused typed;
    load_step_elastic reads it in canonical order."""
    from quest_tpu.resilience import FaultPlan as JPlan
    from quest_tpu.resilience import faults as jfaults
    from quest_tpu.circuit import qft_circuit as j_qft
    jq = jqt.init_debug_state(jqt.create_qureg(9))
    d = str(tmp_path / "jchain")
    plan = JPlan().inject("durable.preempt", after_n=7, times=1)
    with jfaults.active(plan):
        with pytest.raises(jfaults.InjectedFault):
            jdurable.run_durable(j_qft(9), jq, d, every=2, engine="banded")
    with pytest.raises(DurableError):
        run_durable(qft_circuit(9), debug(9), d, every=2, engine="banded")
    step, path = ckpt.step_dirs(d)[-1]
    cursor, planes = ckpt.load_step_elastic(path)
    assert cursor["step"] == step and planes.shape == (2, 512)
    assert cursor["state_efp"] == D._state_fingerprint_elastic(debug(9))
