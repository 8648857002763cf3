"""The port's sharded engines (quest_tpu_torch/parallel) against the JAX
package's and against the dense oracle, on meshes of 2, 4 and 8 CPU
shards.

The per-gate (`compile_circuit_sharded`) and banded
(`compile_circuit_sharded_banded`) engines run beside the reference's on
its 8-device virtual CPU mesh (tests/conftest.py), within 2e-5 x max|amp|
(f32) or 1e-12 (f64): the reference dryrun's circuit (every qubit class
across the split), random circuits whose gates cross it, the deep-global
testbed with QUEST_COMM_PLAN on and off, density channels. The fused
engine's plain path (its kernel parts through the segment kernel's plain
version, shard by shard) is held against the reference's sharded banded
engine, not its interpret-mode Pallas. The dynamic engine, given the
reference's draws (its key schedule replayed), reproduces its outcomes
and planes under 'xla', 'banded' and 'fused'. The mesh's recorder
issues exactly the exchanges comm_stats predicts for every engine at 1,
2 and 4 slices, at f32 and f64, on a run and on the dry walk; sliced
exchanges are bit for bit the unsliced ones and agree with the oracle; a
shard whose global control fails keeps its planes bit for bit; programs
are cached on the mesh's device tuple."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from quest_tpu.env import AMP_AXIS
from quest_tpu.ops import fusion as JF
from quest_tpu.ops import pallas_band as PB
from quest_tpu.parallel import make_amp_mesh as j_mesh
from quest_tpu.parallel import sharded as JS

from quest_tpu_torch import circuit as TC
from quest_tpu_torch import entry as E
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as TF
from quest_tpu_torch.parallel import (ShardedAmps, introspect as TI,
                                      make_amp_mesh, shard_planes,
                                      shard_qureg)
from quest_tpu_torch.parallel import sharded as TS
from quest_tpu_torch.state import create_qureg

from . import oracle
from .test_torch_band_plan import assert_parts_equal
from .test_torch_comm import (_one_thread_per_worker,  # noqa: F401
                              deep_global_circuit, to_reference)

pytestmark = pytest.mark.dtype_agnostic

TOL = {np.float32: 2e-5, np.float64: 1e-12}
BUILD = {"pergate": (TS.compile_circuit_sharded, JS.compile_circuit_sharded),
         "banded": (TS.compile_circuit_sharded_banded,
                    JS.compile_circuit_sharded_banded)}


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


def _planes(n, rdt, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, 1 << n))
    return (x / np.linalg.norm(x)).astype(rdt)


def port_run(prog, planes, n):
    mesh = prog.mesh
    return prog(shard_planes(torch.from_numpy(planes.copy()), mesh,
                             n)).gather().numpy()


def ref_run(build, jc, n, density, d, planes, **kw):
    mesh = j_mesh(d)
    fn = build(jc.ops, n, density, mesh, donate=False, **kw)
    amps = jax.device_put(jnp.asarray(planes),
                          NamedSharding(mesh, P(None, AMP_AXIS)))
    return np.asarray(fn(amps))


def assert_close(got, want, rdt):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, atol=TOL[rdt] * scale, rtol=0)


def crossing_circuit(n, seed=1):
    """Gates that cross the shard split in every routed form: global
    targets (butterfly), two targets with one global (pair exchange),
    multi-target with global targets (swap-dance), global controls,
    controls moved by the swap-dance, diagonals and phases."""
    rng = np.random.default_rng(seed)
    u2 = oracle.random_unitary(2, rng)
    u3 = oracle.random_unitary(3, rng)
    c = E.dryrun_circuit(n)
    c.gate(u2, (n - 2, n - 1))
    c.cu(u2, (0, n - 2), n - 1)
    c.gate(u3, (0, n - 1, n - 2))
    c.x(n - 1, 1)
    c.x(1, n - 1)
    c.cu(np.diag([1.0, 1j]), 2, n - 1, cstates=(0,))
    c.phase(n - 1, 0.7)
    c.multi_rotate_z((0, n - 2, n - 1), 0.4)
    c.cphase(0.3, 1, n - 1)
    return c


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("engine", ["pergate", "banded"])
def test_dryrun_circuit_equals_reference(d, rdt, engine):
    g = d.bit_length() - 1
    n = g + 4
    tc = E.dryrun_circuit(n)
    planes = _planes(n, rdt)
    mine, theirs = BUILD[engine]
    got = port_run(mine(tc.ops, n, False, _mesh(d)), planes, n)
    want = ref_run(theirs, to_reference(tc), n, False, d, planes)
    assert_close(got, want, rdt)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("engine", ["pergate", "banded"])
def test_crossing_circuits_equal_reference(d, engine, monkeypatch):
    """crossing_circuit with the comm planner off (every routed form on
    its own) and a random circuit with it on."""
    n = (d.bit_length() - 1) + 4
    planes = _planes(n, np.float64, seed=d)
    mine, theirs = BUILD[engine]
    for plan, tc in (("0", crossing_circuit(n)),
                     ("1", TC.random_circuit(n, 4, seed=d))):
        monkeypatch.setenv("QUEST_COMM_PLAN", plan)
        got = port_run(mine(tc.ops, n, False, _mesh(d)), planes, n)
        want = ref_run(theirs, to_reference(tc), n, False, d, planes)
        assert_close(got, want, np.float64)


@pytest.mark.parametrize("plan", ["1", "0"])
def test_deep_global_equals_reference(plan, monkeypatch):
    monkeypatch.setenv("QUEST_COMM_PLAN", plan)
    n = 6
    tc = deep_global_circuit(n, 3)
    planes = _planes(n, np.float64)
    for engine in ("pergate", "banded"):
        mine, theirs = BUILD[engine]
        got = port_run(mine(tc.ops, n, False, _mesh(8)), planes, n)
        want = ref_run(theirs, to_reference(tc), n, False, 8, planes)
        assert_close(got, want, np.float64)


@pytest.mark.parametrize("d", [4, 8])
def test_density_channels_equal_reference(d):
    tc = TC.Circuit(3).h(2).damping(2, 0.2).cnot(0, 2).depolarising(1, 0.1)
    n = 6
    planes = _planes(n, np.float64)
    for engine in ("pergate", "banded"):
        mine, theirs = BUILD[engine]
        got = port_run(mine(tc.ops, n, True, _mesh(d)), planes, n)
        want = ref_run(theirs, to_reference(tc), n, True, d, planes)
        assert_close(got, want, np.float64)


@pytest.mark.parametrize("d", [2, 4])
def test_fused_plain_path_equals_reference_banded(d):
    """At 10 local qubits the fused engine plans kernel segments; its
    plain path (and, on the CPU, the program itself) against the
    reference's sharded banded engine."""
    g = d.bit_length() - 1
    n = g + 10
    tc = TC.random_circuit(n, 3, seed=3)
    planes = _planes(n, np.float32)
    prog = TS.compile_circuit_sharded_fused(tc.ops, n, False, _mesh(d))
    assert prog.kind == "fused" and prog.kernel_parts >= 1
    x = shard_planes(torch.from_numpy(planes.copy()), prog.mesh, n)
    plain = prog.plain(x).gather().numpy()
    want = ref_run(JS.compile_circuit_sharded_banded, to_reference(tc), n,
                   False, d, planes)
    assert_close(plain, want, np.float32)
    got = prog(x).gather().numpy()
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("name,d", [("rcs13", 8), ("deep13", 8),
                                    ("rcs14", 4)])
def test_fused_structure_under_tpu_geometry_equals_reference(name, d):
    """The fused engine's per-shard parts (plan_fused_structural, then
    the sweep fusion) under TPU_GEOMETRY are the reference's, part for
    part, stage for stage, operand for operand."""
    tc = {"rcs13": lambda: TC.random_circuit(13, 3, seed=3),
          "deep13": lambda: deep_global_circuit(13, 3),
          "rcs14": lambda: TC.random_circuit(14, 4, seed=1)}[name]()
    n = tc.num_qubits
    local_n = n - (d.bit_length() - 1)
    bands = TS.fused_shard_bands(n, local_n)
    assert bands == JS.fused_shard_bands(n, local_n)
    jinfo, tinfo = {}, {}
    jflat = JS.engine_flat(to_reference(tc).ops, n, False, local_n,
                           bands=bands, comm_info=jinfo)
    tflat = TS.engine_flat(tc.ops, n, False, local_n, bands=bands,
                           comm_info=tinfo)
    jitems = jinfo.get("items") or JF.plan(jflat, n, bands=bands)
    titems = tinfo.get("items") or TF.plan(tflat, n, bands=bands)
    jparts = JS.plan_fused_structural(jitems, local_n)
    tparts = TS.plan_fused_structural(titems, local_n, BP.TPU_GEOMETRY)
    assert_parts_equal(jparts, tparts)
    assert_parts_equal(PB.maybe_sweep(jparts, local_n),
                       BP.maybe_sweep(tparts, local_n,
                                      budgets=BP.TPU_GEOMETRY))


def test_fused_below_the_kernel_tier_takes_banded(capsys):
    tc = TC.random_circuit(8, 2, seed=1)
    prog = TS.compile_circuit_sharded_fused(tc.ops, 8, False, _mesh(4))
    assert prog.kind == "banded" and prog.fallback == "banded"
    assert "BANDED engine runs instead" in capsys.readouterr().err


def _ref_uniforms(key, count, rdt):
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, dtype=jnp.dtype(rdt))))
    return out


def dynamic_circuit(n):
    c = TC.Circuit(n)
    for q in range(n):
        c.h(q)
    c.cnot(0, n - 1)
    c.measure(n - 1)
    c.x_if(0, (0, 1))
    c.ry(n - 1, 0.3)
    c.measure(0)
    c.rx(1, 0.7).cnot(1, n - 2)
    c.x_if(n - 1, (1, 1))                  # feedback on a global qubit
    c.measure(1)
    return c


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("engine", ["xla", "banded", "fused"])
def test_dynamic_engine_given_reference_draws(d, engine):
    """'fused' runs its kernel parts on f32 shards of 10 local qubits,
    held against the reference's banded engine (not its interpret-mode
    Pallas); the seeds draw outcome 1 at the measurements whose
    feedback flips a local and a global qubit."""
    rdt, ref_engine, n = np.float64, engine, 6
    if engine == "fused":
        rdt, ref_engine, n = np.float32, "banded", 10 + d.bit_length() - 1
    tc = dynamic_circuit(n)
    planes = np.zeros((2, 1 << n), rdt)
    planes[0, 0] = 1.0
    jmesh = j_mesh(d)
    jfn = JS.compile_circuit_sharded_measured(to_reference(tc).ops, n, False,
                                              jmesh, donate=False,
                                              engine=ref_engine)
    prog = TS.compile_circuit_sharded_measured(tc.ops, n, False, _mesh(d),
                                               engine=engine)
    assert prog.engine == engine
    if engine == "fused":
        assert prog.kernel_parts >= 1
    fired = set()
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        jamps, jouts = jfn(jax.device_put(
            jnp.asarray(planes), NamedSharding(jmesh, P(None, AMP_AXIS))),
            key)
        us = _ref_uniforms(key, 3, rdt)
        x = shard_planes(torch.from_numpy(planes.copy()), prog.mesh, n)
        x, outs = prog.given(x, us)
        assert outs.tolist() == np.asarray(jouts).tolist()
        assert_close(x.gather().numpy(), np.asarray(jamps), rdt)
        fired |= {i for i in (0, 1) if outs[i] == 1}
    assert fired == {0, 1}


def test_dynamic_fused_and_density_match_single_register():
    """The fused dynamic engine at 10 local qubits and a density register
    over 4 shards against the port's single-register measured program,
    fed the same uniforms. The first uniform is the largest f32 below 1,
    so the first syndrome reads 1 and its reset flips a global ancilla:
    the recorder's exchanges equal the schedule priced on that run's
    outcomes, which holds more exchanges than the all-zero run's."""
    u = [float(np.nextafter(np.float32(1), np.float32(0))), 0.7, 0.1, 0.9]
    c = E.repetition_code_circuit(10, 1)
    n = c.num_qubits
    x = np.zeros((2, 1 << n), np.float32)
    x[0, 0] = 1.0
    want, wouts = c.compiled_measured(n, engine="banded", device="cpu").given(
        torch.from_numpy(x.copy()), u)
    prog = TS.compile_circuit_sharded_measured(c.ops, n, False, _mesh(4),
                                               engine="fused")
    assert prog.engine == "fused" and prog.kernel_parts >= 1
    got, outs = prog.given(shard_planes(torch.from_numpy(x), prog.mesh, n), u)
    assert torch.equal(outs, wouts)
    assert outs[0] == outs[2] == 1
    assert_close(got.gather().numpy(), want.numpy(), np.float32)
    run = prog.mesh.recorder.stats(4)
    rec = TI.sharded_measured_schedule(c.ops, n, False, 4, engine="fused",
                                       outcomes=outs.tolist())
    quiet = TI.sharded_measured_schedule(c.ops, n, False, 4, engine="fused",
                                         outcomes=[0] * len(outs))
    assert rec["comm_matches_hlo"], rec
    for k in ("collective_permutes", "all_to_alls", "collective_exchanges",
              "ici_bytes_per_device", "all_reduces"):
        assert run[k] == rec[k], (k, run, rec)
    assert rec["collective_exchanges"] > quiet["collective_exchanges"]
    dm = (TC.Circuit(4).h(3).damping(3, 0.2).cnot(3, 0).measure(0)
          .x_if(1, (0, 1)).measure(3))
    x2 = np.zeros((2, 1 << 8), np.float64)
    x2[0, 0] = 1.0
    w2, o2 = dm.compiled_measured(8, density=True, device="cpu").given(
        torch.from_numpy(x2.copy()), [0.6, 0.3])
    for engine in ("xla", "banded"):
        p2 = TS.compile_circuit_sharded_measured(dm.ops, 8, True, _mesh(4),
                                                 engine=engine)
        g2, oo = p2.given(shard_planes(torch.from_numpy(x2), p2.mesh, 8),
                          [0.6, 0.3])
        assert torch.equal(oo, o2)
        assert_close(g2.gather().numpy(), w2.numpy(), np.float64)


# -- the recorder: issued == predicted ---------------------------------------

@pytest.mark.parametrize("slices", ["1", "2", "4"])
@pytest.mark.parametrize("plan", ["1", "0"])
def test_issued_equals_predicted(slices, plan, monkeypatch):
    monkeypatch.setenv("QUEST_EXCHANGE_SLICES", slices)
    monkeypatch.setenv("QUEST_COMM_PLAN", plan)
    cases = [("pergate", crossing_circuit(7), 7, 8),
             ("banded", crossing_circuit(7), 7, 4),
             ("banded", deep_global_circuit(6, 3), 6, 8),
             ("fused", TC.random_circuit(12, 3, seed=5), 12, 4)]
    for engine, tc, n, d in cases:
        for rdt, cdt in ((np.float32, np.complex64),
                         (np.float64, np.complex128)):
            rec = TI.sharded_schedule(tc.ops, n, False, d, engine=engine,
                                      dtype=cdt)
            assert rec["comm_matches_hlo"], rec
            mesh = _mesh(d)
            build = {"pergate": TS.compile_circuit_sharded,
                     "banded": TS.compile_circuit_sharded_banded,
                     "fused": TS.compile_circuit_sharded_fused}[engine]
            prog = build(tc.ops, n, False, mesh)
            prog(shard_planes(torch.from_numpy(_planes(n, rdt)), mesh, n))
            run = mesh.recorder.stats(d)
            for k in ("collective_permutes", "all_to_alls",
                      "collective_exchanges", "ici_bytes_per_device"):
                assert run[k] == rec[k], (engine, k, run, rec)
            assert rec["comm_bytes"] == run["ici_bytes_per_device"]


def test_dynamic_schedule_issued_equals_predicted():
    for engine in ("xla", "banded"):
        rec = TI.sharded_measured_schedule(dynamic_circuit(6).ops, 6, False,
                                           8, engine=engine)
        assert rec["comm_matches_hlo"], rec
        assert rec["comm_all_reduces"] == rec["all_reduces"] == 3


def test_sliced_exchanges_are_bit_identical_and_match_the_oracle(
        monkeypatch):
    n = 7
    tc = crossing_circuit(n)
    planes = _planes(n, np.float64, seed=4)
    vec = planes[0] + 1j * planes[1]
    for op in TC.flatten_ops(tc.ops, n, False):
        vec = _oracle_apply(vec, n, op)
    outs = {}
    for s in ("1", "2", "4"):
        monkeypatch.setenv("QUEST_EXCHANGE_SLICES", s)
        for engine, build in (("pergate", TS.compile_circuit_sharded),
                              ("banded", TS.compile_circuit_sharded_banded)):
            got = port_run(build(tc.ops, n, False, _mesh(8)), planes, n)
            outs.setdefault(engine, got)
            assert np.array_equal(outs[engine], got), (engine, s)
            assert_close(got[0] + 1j * got[1], vec, np.float64)


def _oracle_apply(vec, n, op):
    if op.kind == "matrix":
        return oracle.apply_to_vector(vec, n, op.operand, list(op.targets),
                                      list(op.controls), list(op.cstates))
    k = len(op.targets)
    if op.kind == "diagonal":
        d = np.asarray(op.operand)
    elif op.kind == "parity":
        par = np.array([bin(i).count("1") & 1 for i in range(1 << k)])
        d = np.exp(-0.5j * op.operand * (1 - 2 * par))
    else:                                       # allones
        d = np.ones(1 << k, complex)
        d[-1] = op.operand
    return oracle.apply_to_vector(vec, n, np.diag(d), list(op.targets),
                                  list(op.controls), list(op.cstates))


# -- shards, predicates, cache -----------------------------------------------

def test_failing_global_control_leaves_the_shard_bit_for_bit():
    n, d = 7, 4
    c = TC.Circuit(n).cu(oracle.random_unitary(1, np.random.default_rng(2)),
                         0, n - 1)
    x = shard_planes(torch.from_numpy(_planes(n, np.float32)), _mesh(d), n)
    before = [s.clone() for s in x.shards]
    TS.compile_circuit_sharded(c.ops, n, False, x.mesh)(x)
    for k in range(d):
        changed = not torch.equal(before[k], x.shards[k])
        assert changed == bool((k >> 1) & 1)


def test_matrix_that_cannot_fit_raises():
    c = TC.Circuit(5).gate(oracle.random_unitary(4, np.random.default_rng(1)),
                           (0, 1, 3, 4))
    prog = TS.compile_circuit_sharded(c.ops, 5, False, _mesh(8))
    x = shard_planes(torch.from_numpy(_planes(5, np.float64)), prog.mesh, 5)
    with pytest.raises(TV.QuESTError, match="cannot fit"):
        prog(x)


def test_mesh_validation_and_round_trip():
    with pytest.raises(ValueError, match="must be a power of 2"):
        make_amp_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="requested 8 devices, have 4"):
        make_amp_mesh(8, devices=["cpu"] * 4)
    assert make_amp_mesh(devices=["cpu"] * 6).size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_amp_mesh(2)
    q = create_qureg(6, device="cpu")
    sq = shard_qureg(q, _mesh(4))
    assert isinstance(sq.amps, ShardedAmps) and len(sq.amps.shards) == 4
    assert torch.equal(sq.amps.gather(), q.amps)


def test_programs_are_cached_on_the_device_tuple():
    c = TC.random_circuit(6, 2, seed=1)
    a = c.compiled_sharded(6, False, _mesh(4))
    assert c.compiled_sharded(6, False, _mesh(4)) is a
    assert c.compiled_sharded(6, False, _mesh(2)) is not a
    b = c.compiled_sharded_banded(6, False, _mesh(4))
    assert b is not a and b is c.compiled_sharded_banded(6, False, _mesh(4))
    c.h(0)
    assert c.compiled_sharded(6, False, _mesh(4)) is not a


@pytest.mark.parametrize("engine", ["pergate", "banded", "fused"])
def test_a_rebuilt_mesh_records_its_own_exchanges(engine):
    """A program built through mesh A and found in the cache through a
    rebuilt mesh B over the same devices runs B's shards' exchanges on
    B: B's recorder holds the prediction, A's stays empty; shards over a
    mesh of other devices are refused."""
    n = 12 if engine == "fused" else 7
    c = crossing_circuit(n)
    build = {"pergate": c.compiled_sharded, "banded":
             c.compiled_sharded_banded, "fused": c.compiled_sharded_fused}
    a, b = _mesh(4), _mesh(4)
    prog = build[engine](n, False, a)
    assert build[engine](n, False, b) is prog
    x = shard_planes(torch.from_numpy(_planes(n, np.float32)), b, n)
    prog(x)
    rec = TI.sharded_schedule(c.ops, n, False, 4, engine=engine)
    run = b.recorder.stats(4)
    assert run["collective_exchanges"] > 0
    for k in ("collective_permutes", "all_to_alls", "collective_exchanges",
              "ici_bytes_per_device"):
        assert run[k] == rec[k], (k, run, rec)
    assert a.recorder.events == []
    other = make_amp_mesh(4, devices=["cpu", "cpu", "cpu", "meta"])
    with pytest.raises(ValueError, match="the program is for"):
        prog(ShardedAmps(x.shards, other, n))


def test_apply_methods_and_batched_engine():
    n = 12
    c = TC.random_circuit(n, 2, seed=4)
    mesh = _mesh(4)
    q = create_qureg(n, device="cpu")
    want = c.apply_banded(create_qureg(n, device="cpu")).amps
    for apply in (c.apply_sharded, c.apply_sharded_banded,
                  c.apply_sharded_fused):
        out = apply(create_qureg(n, device="cpu"), mesh).amps.gather()
        assert_close(out.numpy(), want.numpy(), np.float32)
    batch = torch.from_numpy(np.stack([_planes(n, np.float32, s)
                                       for s in range(3)]))
    want_b = c.compiled_batched(3, device="cpu")(batch.clone().reshape(
        3, 2, -1, 128)).reshape(3, 2, -1)
    prog = c.compiled_sharded_batched(3, mesh)
    got = prog(shard_planes(batch, mesh, n)).gather()
    assert got.shape == (3, 2, 1 << n)
    assert_close(got.numpy(), want_b.numpy(), np.float32)
    assert q.amps.device.type == "cpu"


def test_explain_sharded_reports_the_issued_schedule():
    c = deep_global_circuit(6, 3)
    text = c.explain_sharded(_mesh(8))
    assert "comm plan:" in text and "matches the issued exchanges" in text
    assert "shard geometry: 3 local + 3 device qubits" in text
    dyn = dynamic_circuit(6).explain_sharded(8, engine="pergate")
    assert "sharded DYNAMIC (xla)" in dyn and "reductions: 3" in dyn
    fused = TC.random_circuit(12, 2, seed=1).explain_sharded(4,
                                                            engine="fused")
    assert "local kernel sweeps" in fused
