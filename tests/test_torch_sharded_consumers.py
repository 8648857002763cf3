"""The port's sharded consumers (ROADMAP A10b) against the JAX package and
the port's own one-register results, on meshes of 2, 4 and 8 CPU shards.

  * ops/expec.py `expec_sharded` / `apply_pauli_sum_planes_sharded`
    (mirrors tests/test_expec.py:117,140): local flips, global flips (one
    pair exchange per distinct global mask, counted on the mesh's
    recorder), global zy signs, flip masks straddling the evaluator's
    chunk; density traces with no exchange; differentiable in the
    coefficients and the shards.
  * adjoint.value_and_grad(mesh=) (test_adjoint.py:123,248): energy and
    gradient equal the one-register walk and the reference's sharded
    walk; the issued exchanges equal predict_vjp_collectives at 1 and 2
    exchange slices; density and Trotter-ansatz targets refused by both
    engines (the taped engine on a mesh: tests/test_torch_adjoint.py).
  * measurement.sample on a sharded register (test_distributed.py:291):
    given the reference's uniforms its indices are the reference's
    sharded sampler's; drawn from a generator, its frequencies follow
    |amp|^2; the state never gathers.
  * evolution.run_evolution(mesh=) (test_evolution.py:612): the sharded
    banded and fused quenches equal the one-register quench.
  * plan.autotune(devices=, mesh=, topology=) (test_plan.py:137): every
    sharded family priced, the incumbent winning ties, mesh keys
    carrying the device tuple.
  * QuESTEnv over an AmpMesh (ref env.py:743-770).
f32 within 2e-5 x the scale, f64 within 1e-12, unless stated."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import quest_tpu as jqt
from quest_tpu import adjoint as JAD
from quest_tpu import calculations as JC
from quest_tpu import measurement as JM
from quest_tpu.env import batch_bucket
from quest_tpu.ops import expec as JE
from quest_tpu.parallel import make_amp_mesh as j_mesh
from quest_tpu.parallel import shard_qureg as j_shard

from quest_tpu_torch import adjoint as AD
from quest_tpu_torch import calculations as TC
from quest_tpu_torch import env as TE
from quest_tpu_torch import evolution as EV
from quest_tpu_torch import measurement as TM
from quest_tpu_torch import plan as P
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.parallel import (ShardedAmps, make_amp_mesh,
                                      shard_planes, shard_qureg)

from . import oracle
from .test_torch_adjoint import rand_ansatz, tfim
from .test_torch_evolution import dense_h
from .test_torch_expec import random_sum

pytestmark = pytest.mark.dtype_agnostic

TOL = {np.float32: 2e-5, np.float64: 1e-12}
N = 6
MESHES = (2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


def _cdt(rdt):
    return np.complex64 if rdt == np.float32 else np.complex128


def _sv(v, rdt, mesh=None):
    q = TS.create_qureg(int(np.log2(v.size)), dtype=_cdt(rdt), device="cpu")
    q.amps.copy_(torch.from_numpy(np.stack([v.real, v.imag]).astype(rdt)))
    return shard_qureg(q, mesh) if mesh is not None else q


def _dm(rho, rdt, mesh=None):
    nq = int(np.log2(rho.shape[0]))
    flat = rho.reshape(-1, order="F")
    q = TS.create_density_qureg(nq, dtype=_cdt(rdt), device="cpu")
    q.amps.copy_(torch.from_numpy(np.stack([flat.real, flat.imag])
                                  .astype(rdt)))
    return shard_qureg(q, mesh) if mesh is not None else q


def _jsv(v, rdt, devices=None):
    q = jqt.create_qureg(int(np.log2(v.size)), dtype=_cdt(rdt))
    q = q.replace_amps(jnp.asarray(np.stack([v.real, v.imag]).astype(rdt)))
    return j_shard(q, j_mesh(devices)) if devices else q


def _dense(q):
    amps = q.amps
    if isinstance(amps, ShardedAmps):
        planes = np.concatenate([s.numpy() for s in amps.shards], axis=-1)
    else:
        planes = np.asarray(amps)
    planes = planes.reshape(2, -1)
    return planes[0] + 1j * planes[1]


def _forced_sum(rng, n, terms=10):
    """random_sum plus a global-flip group (X on the top qubit), a
    global-sign group (Z on it) and a two-bit global mask."""
    codes, coeffs = random_sum(rng, n, terms)
    codes[4] = 0
    codes[4][n - 1] = 1
    codes[5] = 0
    codes[5][n - 1] = 3
    codes[6] = 0
    codes[6][n - 1] = 2
    codes[6][n - 2] = 1
    return codes, coeffs


# ---------------------------------------------------------------------------
# the grouped expectation engine on shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("chunk_bits", [24, 2])
def test_sharded_expectation_matches_single_and_reference(rdt, chunk_bits,
                                                          monkeypatch):
    monkeypatch.setattr(E, "CHUNK_BITS", chunk_bits)
    rng = np.random.default_rng(3)
    codes, coeffs = _forced_sum(rng, N)
    v = oracle.random_statevector(N, rng)
    want = TC.calc_expec_pauli_sum(_sv(v, rdt), codes, coeffs)
    ref = JC.calc_expec_pauli_sum(_jsv(v, rdt, 2), codes, coeffs)
    exact = float((v.conj() @ dense_h(codes, coeffs) @ v).real)
    for d in MESHES:
        q = _sv(v, rdt, _mesh(d))
        q.amps.mesh.recorder.reset()
        got = TC.calc_expec_pauli_sum(q, codes, coeffs)
        assert got == pytest.approx(want, abs=TOL[rdt])
        assert got == pytest.approx(ref, abs=TOL[rdt])
        assert got == pytest.approx(exact, abs=10 * TOL[rdt])
        # one pair exchange per distinct global flip mask, one reduce
        local_n = N - (d.bit_length() - 1)
        plan = E.plan_expec(E.parse_pauli_sum(codes, N), N, density=False)
        masks = E.global_flip_masks(plan, local_n)
        stats = q.amps.mesh.recorder.stats(d)
        assert stats["collective_permutes"] == len(masks) > 0
        assert stats["all_reduces"] == 1


def test_sharded_density_expectation_needs_no_exchange():
    rng = np.random.default_rng(4)
    nq = 3
    codes, coeffs = random_sum(rng, nq, 6)
    rho = oracle.random_density(nq, rng)
    want = TC.calc_expec_pauli_sum(_dm(rho, np.float64), codes, coeffs)
    jq = jqt.create_density_qureg(nq, dtype=np.complex128)
    flat = rho.reshape(-1, order="F")
    jq = j_shard(jq.replace_amps(jnp.asarray(np.stack([flat.real,
                                                       flat.imag]))),
                 j_mesh(8))
    ref = JC.calc_expec_pauli_sum(jq, codes, coeffs)
    for d in MESHES:
        q = _dm(rho, np.float64, _mesh(d))
        got = TC.calc_expec_pauli_sum(q, codes, coeffs)
        assert got == pytest.approx(want, abs=1e-12)
        assert got == pytest.approx(ref, abs=1e-11)
        assert q.amps.mesh.recorder.stats(d)["collective_permutes"] == 0


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_sharded_apply_pauli_sum_matches_reference(rdt, monkeypatch):
    monkeypatch.setattr(E, "CHUNK_BITS", 2)
    rng = np.random.default_rng(5)
    codes, coeffs = _forced_sum(rng, N)
    v = oracle.random_statevector(N, rng)
    one = TC.apply_pauli_sum(_sv(v, rdt), codes, coeffs)
    ref = JC.apply_pauli_sum(_jsv(v, rdt, 2), codes, coeffs)
    for d in MESHES:
        q = _sv(v, rdt, _mesh(d))
        out = TC.apply_pauli_sum(q, codes, coeffs)
        assert isinstance(out.amps, ShardedAmps)
        scale = np.abs(_dense(one)).max()
        assert np.abs(_dense(out) - _dense(one)).max() <= TOL[rdt] * scale
        assert np.abs(_dense(out) - _dense(ref)).max() <= TOL[rdt] * scale


def test_sharded_expectation_is_differentiable():
    """expec_sharded tapes through the exchanges and the reduce: the
    gradient in the coefficients is each term's expectation, in the
    shards the one-register gradient."""
    rng = np.random.default_rng(6)
    codes, coeffs = _forced_sum(rng, N, 8)
    v = oracle.random_statevector(N, rng)
    plan = E.plan_expec(E.parse_pauli_sum(codes, N), N, density=False)
    planes = torch.from_numpy(np.stack([v.real, v.imag]))
    a1 = planes.clone().requires_grad_(True)
    cf1 = torch.tensor(coeffs, requires_grad=True)
    g1 = torch.autograd.grad(E.expec_traced(a1, cf1, plan), (a1, cf1))
    for d in (2, 8):
        shards = shard_planes(planes, _mesh(d), N)
        for s in shards.shards:
            s.requires_grad_(True)
        cf2 = torch.tensor(coeffs, requires_grad=True)
        val = E.expec_sharded(shards, cf2, plan)
        grads = torch.autograd.grad(val, shards.shards + [cf2])
        np.testing.assert_allclose(grads[-1].numpy(), g1[1].numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(torch.cat(grads[:-1], -1).numpy(),
                                   g1[0].numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# adjoint gradients on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slices", ["1", "2"])
def test_adjoint_sharded_matches_single_and_predicted(slices, monkeypatch):
    monkeypatch.setenv("QUEST_EXCHANGE_SLICES", slices)
    n = 6
    c = rand_ansatz(Circuit, n, layers=2, seed=5)
    ham = tfim(E, n)
    one = AD.value_and_grad(c, ham, engine="adjoint", device="cpu")
    th = torch.tensor(one.initial_params, dtype=torch.float32)
    v1, g1 = one(th)
    for d in MESHES:
        mesh = _mesh(d)
        fn = AD.value_and_grad(c, ham, mesh=mesh, engine="adjoint")
        assert fn.engine == "adjoint"
        mesh.recorder.reset()
        v2, g2 = fn(th)
        assert float(v2) == pytest.approx(float(v1), abs=1e-5)
        np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=1e-5)
        stats = mesh.recorder.stats(d)
        pred = fn.comm_record
        assert stats["collective_permutes"] == pred["collective_permutes"]
        assert stats["all_to_alls"] == pred["all_to_alls"]
        assert stats["all_reduces"] == pred["all_reduces"] == 2
        assert pred == AD.predict_vjp_collectives(
            AD.build_circuit_program(c, False)[0],
            E.plan_expec(E.parse_pauli_sum(np.asarray(ham.codes), n), n,
                         density=False), d)
        # equal specs return the identical callable, keyed on the mesh
        assert AD.value_and_grad(c, ham, mesh=mesh, engine="adjoint") is fn


def test_adjoint_sharded_matches_the_reference():
    from jax.sharding import Mesh
    from quest_tpu.circuit import Circuit as JCircuit
    from quest_tpu.env import AMP_AXIS
    n = 5
    c = rand_ansatz(Circuit, n, layers=2, seed=5)
    jc = rand_ansatz(JCircuit, n, layers=2, seed=5)
    jmesh = Mesh(np.array(jax.devices()[:2]), (AMP_AXIS,))
    two = JAD.value_and_grad(jc, tfim(JE, n), engine="adjoint", mesh=jmesh)
    th = np.asarray(two.initial_params, np.float32)
    vr, gr = two(jnp.asarray(th))
    fn = AD.value_and_grad(c, tfim(E, n), mesh=_mesh(2), engine="adjoint")
    v2, g2 = fn(torch.from_numpy(th))
    assert float(v2) == pytest.approx(float(vr), abs=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(gr), atol=1e-5)


def test_adjoint_rejects_unsupported_shard_targets():
    mesh = _mesh(2)
    spec = tfim(E, 3)
    ansatz = EV.trotter_ansatz(spec, order=2, steps=1)
    with pytest.raises(AD.AdjointError, match="sharded trotter"):
        AD.value_and_grad(ansatz, spec, mesh=mesh)
    c = rand_ansatz(Circuit, 3, layers=1, seed=7)
    for engine in ("adjoint", "taped"):
        with pytest.raises(AD.AdjointError, match="density"):
            AD.value_and_grad(c, spec, density=True, mesh=mesh,
                              engine=engine)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_sharded_sampler_given_the_reference_uniforms(rdt):
    """The drawing-free core fed the reference's sharded sampler's
    uniforms (its key drawn into the f64 accumulator, bucketed like the
    reference) returns the reference's indices."""
    rng = np.random.default_rng(8)
    v = oracle.random_statevector(N, rng)
    shots = 300
    key = jax.random.PRNGKey(4)
    ref = np.asarray(JM.sample(_jsv(v, rdt, 8), shots, key))
    u = np.asarray(jax.random.uniform(key, (batch_bucket(shots),),
                                      dtype=jnp.float64))[:shots]
    q = _sv(v, rdt, _mesh(8))
    got = TM._sample_sharded_given_uniforms(q, torch.from_numpy(u.copy()))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sharded_sampling_frequencies_and_one_register_agreement():
    rng = np.random.default_rng(9)
    v = oracle.random_statevector(N, rng)
    for d in MESHES:
        q = _sv(v, np.float32, _mesh(d))
        s = TM.sample(q, 5000, torch.Generator().manual_seed(4))
        freqs = np.bincount(s.numpy(), minlength=1 << N) / 5000
        np.testing.assert_allclose(freqs, np.abs(v) ** 2, atol=0.03)
        # the same uniforms on one register: (almost) the same indices
        u = torch.rand(4000, generator=torch.Generator().manual_seed(1),
                       dtype=torch.float32)
        a = TM._sample_given_uniforms(_sv(v, np.float32).amps, u, n=N,
                                      density=False)
        b = TM._sample_sharded_given_uniforms(q, u)
        assert (a == b).float().mean() >= 0.999
    # a density register samples its diagonal
    rho = oracle.random_density(3, rng)
    q = _dm(rho, np.float64, _mesh(4))
    s = TM.sample(q, 5000, torch.Generator().manual_seed(2))
    freqs = np.bincount(s.numpy(), minlength=8) / 5000
    np.testing.assert_allclose(freqs, np.diag(rho).real, atol=0.03)


# ---------------------------------------------------------------------------
# sharded quenches
# ---------------------------------------------------------------------------


def test_sharded_quench_eps_equality():
    rng = np.random.default_rng(10)
    from .test_torch_evolution import random_sum as ev_sum
    spec = ev_sum(rng, N)
    q0 = TS.init_debug_state(TS.create_qureg(N, device="cpu"))
    res_1 = EV.run_evolution(spec, 0.05, 6, state=q0, energy_every=3)
    for d in MESHES:
        mesh = _mesh(d)
        res_m = EV.run_evolution(spec, 0.05, 6, state=q0, mesh=mesh,
                                 energy_every=3)
        assert res_m.stats["engine"] == "sharded-banded"
        assert isinstance(res_m.state.amps, ShardedAmps)
        np.testing.assert_allclose(_dense(res_m.state), _dense(res_1.state),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(res_m.energies, res_1.energies,
                                   atol=1e-3, rtol=1e-4)
    # engine='fused' under mesh= is honoured: the kernel parts through the
    # segment kernel's plain version on every shard (local_n >= 10)
    n = 11
    spec = ev_sum(rng, n)
    q0 = TS.init_debug_state(TS.create_qureg(n, device="cpu"))
    res_1 = EV.run_evolution(spec, 0.05, 2, state=q0)
    res_f = EV.run_evolution(spec, 0.05, 2, state=q0, mesh=_mesh(2),
                             engine="fused")
    assert res_f.stats["engine"] == "sharded-fused"
    scale = np.abs(_dense(res_1.state)).max()
    assert np.abs(_dense(res_f.state) - _dense(res_1.state)).max() \
        <= 1e-4 * scale


def test_sharded_quench_refusals():
    spec = tfim(E, 4)
    q0 = TS.create_qureg(4, device="cpu")
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="single-mesh"):
        EV.run_evolution(spec, 0.1, 2, state=q0, mesh=mesh, imag_time=True)


def test_legacy_path_refuses_a_mesh(monkeypatch):
    monkeypatch.setenv("QUEST_TROTTER_FUSION", "0")
    with pytest.raises(ValueError, match="mesh= and engine="):
        EV.run_evolution(tfim(E, 4), 0.1, 2,
                         state=TS.create_qureg(4, device="cpu"),
                         mesh=_mesh(2))


# ---------------------------------------------------------------------------
# the priced sharded search
# ---------------------------------------------------------------------------


def _small(n=6):
    c = Circuit(n)
    for q in range(n):
        c.h(q).rx(q, 0.1 * (q + 1))
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.gate(oracle.random_unitary(2, np.random.default_rng(0)), (0, n - 1))
    return c


@pytest.fixture
def plan_env(monkeypatch, tmp_path):
    monkeypatch.setenv("QUEST_HBM_BYTES", str(16 << 30))
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", str(tmp_path))


@pytest.mark.parametrize("state_kind", ["pure", "density"])
def test_autotune_prices_every_sharded_family(state_kind, plan_env):
    c = _small()
    for d in MESHES:
        plan = P.autotune(c, state_kind=state_kind, devices=d, persist=False)
        assert plan.source == "search" and plan.devices == d
        assert plan.engine.startswith("sharded-")
        assert plan.engine in plan.candidates
        assert plan.candidates[plan.engine]["selectable"]
        assert plan.incumbent == "sharded-banded"
        assert plan.comm is not None and plan.comm["devices"] == d
        assert plan.cost["comm_elem_bytes"] >= 0
        assert (plan.cost["total_ms"]
                <= plan.candidates[plan.incumbent]["total_ms"])
        for name, cand in plan.candidates.items():
            assert {"est_ms_lo", "est_ms_hi", "hbm_passes", "compile_ops",
                    "comm_ms", "selectable"} <= set(cand), name
            if ":comm=" in name:
                assert not cand["selectable"]


def test_autotune_incumbent_wins_ties_and_keys_the_mesh(plan_env):
    from .test_torch_comm import deep_global_circuit
    c = deep_global_circuit(6, 6)
    plan = P.autotune(c, devices=8, persist=False)
    assert plan.cost["total_ms"] <= \
        plan.candidates[plan.incumbent]["total_ms"]
    # a mesh carries its device tuple into the key; devices= alone does
    # not, and another shard count is another plan
    m1 = P.autotune(c, mesh=_mesh(4), persist=True)
    m2 = P.autotune(c, mesh=_mesh(4), persist=True)
    assert m1.source == "search" and m2.source == "cache"
    assert m2.engine == m1.engine and m2.key == m1.key
    k_dev = P.autotune(c, devices=4, persist=False).key
    k_mesh2 = P.autotune(c, mesh=make_amp_mesh(
        4, devices=["cpu", "meta", "cpu", "cpu"]), persist=False).key
    assert len({m1.key, k_dev, k_mesh2}) == 3
    assert P.autotune(c, devices=2, persist=False).key != k_dev
    # a topology is part of the price and of the key
    from quest_tpu_torch.parallel import comm as CM
    topo = CM.topology(4)
    assert P.autotune(c, devices=4, topology=topo, persist=False).devices \
        == 4
    with pytest.raises(ValueError, match="mesh= or devices="):
        P.autotune(c, mesh=_mesh(2), devices=2)
    with pytest.raises(ValueError, match="topology"):
        P.autotune(c, topology=topo)


def test_compiled_for_runs_the_chosen_sharded_engine(plan_env):
    c = _small()
    mesh = _mesh(2)
    plan = P.autotune(c, mesh=mesh, persist=False)
    prog = P.compiled_for(c, plan, mesh=mesh)
    q = TS.init_debug_state(TS.create_qureg(6, device="cpu"))
    want = _dense(c.apply(TS.clone(q)))
    got = _dense(q.replace_amps(prog(shard_planes(q.amps, mesh, 6))))
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# QuESTEnv over a mesh
# ---------------------------------------------------------------------------


def test_quest_env_over_a_mesh():
    env = TE.QuESTEnv(devices=["cpu"] * 4)
    assert env.num_ranks == 4 and env.mesh.size == 4
    assert env.sharding_for(10) is env.mesh
    assert env.sharding_for(2) is None          # < 2 amplitudes a shard
    assert env.sharding_for(3) is env.mesh
    q = TS.create_qureg(6, env=env)
    assert isinstance(q.amps, ShardedAmps) and q.amps.mesh is env.mesh
    assert TC.calc_total_prob(q) == pytest.approx(1.0)
    rho = TS.create_density_qureg(3, env=env)
    assert isinstance(rho.amps, ShardedAmps)
    assert TS.create_qureg(1, env=env).amps.device.type == "cpu"
    assert torch.is_tensor(TS.create_qureg(1, env=env).amps)
    mesh = _mesh(8)
    env8 = TE.QuESTEnv(mesh=mesh)
    assert env8.num_ranks == 8 and env8.sharding_for(6) is mesh
    assert TE.QuESTEnv(devices=["cpu"] * 3).num_ranks == 2
    one = TE.QuESTEnv("cpu")
    assert one.num_ranks == 1 and one.sharding_for(20) is None
    assert torch.is_tensor(TS.create_qureg(4, env=one).amps)
    with pytest.raises(ValueError, match="devices= or mesh="):
        TE.QuESTEnv(devices=["cpu"] * 2, mesh=mesh)
    assert env.get_environment_string(6) == "6qubits_CPU_4ranksx1threads"
