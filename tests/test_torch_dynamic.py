"""Dynamic circuits (Circuit.measure / gate_if / reset, compiled_measured)
of the port against the JAX package.

The non-sharded, non-QASM, non-vmap cases of tests/test_dynamic_circuits.py
replayed on quest_tpu_torch: the physics (Bell correlations, repeat
measurements, collapse and renormalisation, Born statistics, resets,
teleportation with feed-forward on statevector and density registers,
measurement as a barrier to the planner), run from torch.Generators, and
the reference's own trajectories: its key schedule replayed (key, sub =
jax.random.split(key); u = jax.random.uniform(sub) per measurement, as
compiled_measured draws) and the uniforms fed to the port's program
(MeasuredProgram.given). Outcomes must be equal, and planes within 2e-5
x max|amp| (f32) or 1e-12 (f64), on every key none of whose draws lies
within 1e-5 of its threshold (those are counted apart); under the
banded and the per-gate ('xla') engine alike."""

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

from quest_tpu import circuit as JC

from quest_tpu_torch import calculations as TK
from quest_tpu_torch import convert
from quest_tpu_torch import measurement as TM
from quest_tpu_torch import state as TS
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.validation import QuESTError

pytestmark = pytest.mark.dtype_agnostic

ENGINES = ("banded", "xla")
TOL = {np.float32: 2e-5, np.float64: 1e-12}
THRESHOLD_GAP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _register(nq, density=False, dtype=np.complex64):
    make = TS.create_density_qureg if density else TS.create_qureg
    return make(nq, dtype=dtype, device="cpu")


def _reference(tc: Circuit) -> JC.Circuit:
    """The same op list as a quest_tpu Circuit (a classical op's inner
    gates rebuilt as quest_tpu GateOps)."""
    def conv(op):
        operand = op.operand
        if op.kind == "classical":
            operand = (tuple(conv(g) for g in operand[0]), operand[1])
        return JC.GateOp(op.kind, op.targets, op.controls, op.cstates,
                         operand, op.meta)
    jc = JC.Circuit(tc.num_qubits)
    jc.ops.extend(conv(op) for op in tc.ops)
    return jc


def _uniforms(key, count, rdt):
    """The reference's draws of one compiled_measured call: one split and
    one uniform of the plane dtype per measurement."""
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, dtype=jnp.dtype(rdt))))
    return out


def replay(tc: Circuit, seeds, engine, density=False, dtype=np.complex64,
           jc=None):
    """Run `tc` on the port given the reference's uniforms for each key
    PRNGKey(s), s in `seeds`, and the reference itself; compare outcomes
    and planes on every key whose draws are clear of their thresholds.
    Returns the number of keys compared."""
    jc = jc if jc is not None else _reference(tc)
    rdt = np.float32 if dtype == np.complex64 else np.float64
    nq = tc.num_qubits
    n = 2 * nq if density else nq
    jfn = jc.compiled_measured(n, density, donate=False, engine=engine)
    tfn = tc.compiled_measured(n, density, engine=engine, device="cpu")
    planes = np.asarray(TS.basis_planes(0, n=n, rdt=rdt, device="cpu"))
    compared = 0
    for s in seeds:
        key = jax.random.PRNGKey(s)
        jamps, jouts = jfn(jnp.asarray(planes), key)
        us = _uniforms(key, tc._measure_count(), rdt)
        draws = []
        orig = TM._measure_given_uniform

        def recording(amps, u, **kw):
            oc, prob = orig(amps, u, **kw)
            draws.append((u, prob if oc == 0 else 1.0 - prob))
            return oc, prob
        TM._measure_given_uniform = recording
        try:
            amps, outs = tfn.given(torch.from_numpy(planes.copy()), us)
        finally:
            TM._measure_given_uniform = orig
        if any(abs(u - p0) < THRESHOLD_GAP for u, p0 in draws):
            continue
        compared += 1
        assert outs.dtype == torch.int32
        np.testing.assert_array_equal(outs.numpy(), np.asarray(jouts))
        want = np.asarray(jamps)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(amps.numpy() - want).max() <= TOL[rdt] * scale
    return compared


@pytest.mark.parametrize("engine", ENGINES)
def test_bell_outcomes_correlate(engine):
    c = Circuit(2).h(0).cnot(0, 1).measure(0).measure(1)
    seen = set()
    for s in range(40):
        _, outs = c.apply_measured(_register(2), _gen(s), engine=engine)
        assert outs[0] == outs[1]
        seen.add(int(outs[0]))
    assert seen == {0, 1}
    assert replay(c, range(6), engine) >= 5


@pytest.mark.parametrize("engine", ENGINES)
def test_repeat_measurement_is_consistent(engine):
    c = Circuit(1).h(0).measure(0).measure(0)
    for s in range(20):
        _, outs = c.apply_measured(_register(1), _gen(s), engine=engine)
        assert outs[0] == outs[1]
    assert replay(c, range(4), engine) >= 3


@pytest.mark.parametrize("engine", ENGINES)
def test_post_measurement_state_is_collapsed_and_normalized(engine):
    c = Circuit(3).h(0).h(1).h(2).measure(1)
    q, outs = c.apply_measured(_register(3), _gen(4), engine=engine)
    v = TS.to_dense(q)
    assert abs(np.vdot(v, v) - 1.0) < 1e-6
    k = np.arange(8)
    assert np.abs(v[((k >> 1) & 1) != int(outs[0])]).max() < 1e-7
    assert replay(c, (4, 5), engine) >= 1


def _engines_circuit():
    c = random_circuit(5, depth=2, seed=3)
    c.measure(2)
    for op in random_circuit(5, depth=1, seed=4).ops:
        c.ops.append(op)
    return c.measure(0).measure(4)


def test_engines_agree_per_key():
    """banded and xla draw identical trajectories from one generator
    state, and each replays the reference's."""
    c = _engines_circuit()
    q1, o1 = c.apply_measured(_register(5), _gen(11), engine="banded")
    q2, o2 = c.apply_measured(_register(5), _gen(11), engine="xla")
    assert torch.equal(o1, o2)
    np.testing.assert_allclose(TS.to_dense(q1), TS.to_dense(q2), atol=1e-6)
    for engine in ENGINES:
        assert replay(c, range(3), engine) >= 2


@pytest.mark.parametrize("engine", ENGINES)
def test_density_register_measurement(engine):
    c = Circuit(2).h(0).cnot(0, 1).dephasing(0, 0.25).measure(0).measure(1)
    ones = 0
    for s in range(30):
        q, outs = c.apply_measured(_register(2, density=True), _gen(s),
                                   engine=engine)
        assert outs[0] == outs[1]
        ones += int(outs[0])
        assert abs(TK.calc_total_prob(q) - 1.0) < 1e-5
    assert 5 < ones < 25
    assert replay(c, range(4), engine, density=True) >= 3


def test_outcome_statistics_match_born_rule():
    theta = 0.8
    c = Circuit(1).ry(0, theta).measure(0)
    fn = c.compiled_measured(1, False, device="cpu")
    gen = _gen(0)
    outs = np.array([int(fn(_register(1).amps, gen)[1][0])
                     for _ in range(600)])
    assert abs(outs.mean() - np.sin(theta / 2) ** 2) < 0.06


def test_static_entry_points_reject_measurement():
    c = Circuit(2).h(0).measure(0)
    q = _register(2)
    for call in (lambda: c.apply(q),
                 lambda: c.compiled_banded(2, False, device="cpu"),
                 lambda: c.compiled(2, False, device="cpu"),
                 lambda: c.compiled_fused(2, False, device="cpu"),
                 lambda: c.compiled_batched(4, device="cpu"),
                 lambda: c.explain()):
        with pytest.raises(QuESTError, match="apply_measured"):
            call()
    with pytest.raises(QuESTError, match="no inverse"):
        c.inverse()


def test_fusion_does_not_reorder_across_measurement():
    c = Circuit(1).h(0).measure(0).h(0).measure(0)
    outs = [int(c.apply_measured(_register(1), _gen(s),
                                 engine="banded")[1][1]) for s in range(60)]
    assert 0.25 < np.mean(outs) < 0.75
    assert replay(c, range(4), "banded") >= 3


def test_density_dual_does_not_cross_measurement():
    n = 7
    c = Circuit(n).h(0).measure(0).h(0).measure(0)
    seconds = []
    for s in range(40):
        q1, o1 = c.apply_measured(_register(n, density=True), _gen(s),
                                  engine="banded")
        q2, o2 = c.apply_measured(_register(n, density=True), _gen(s),
                                  engine="xla")
        assert torch.equal(o1, o2)
        np.testing.assert_allclose(TS.to_dense(q1), TS.to_dense(q2),
                                   atol=1e-6)
        seconds.append(int(o1[1]))
    assert 0.2 < np.mean(seconds) < 0.8
    for engine in ENGINES:
        assert replay(c, range(2), engine, density=True) >= 1


def test_compiled_measured_requires_measurement():
    with pytest.raises(QuESTError, match="at least one"):
        Circuit(1).h(0).compiled_measured(1, False, device="cpu")
    with pytest.raises(QuESTError, match="at least one"):
        Circuit(1).h(0).apply_measured(_register(1), _gen(0))
    with pytest.raises(ValueError, match="engine"):
        Circuit(1).measure(0).compiled_measured(1, engine="fused",
                                                device="cpu")


def _teleport():
    from examples.teleportation import PHI, THETA, teleport_circuit
    jc = teleport_circuit()
    want = np.array([np.cos(THETA / 2), np.sin(THETA / 2) * np.exp(1j * PHI)])
    return jc, convert.circuit_from_ops(jc.ops, 3), want


@pytest.mark.parametrize("engine", ENGINES)
def test_classical_feedback_teleportation(engine):
    jc, c, want = _teleport()
    branches = set()
    for s in range(16):
        q, outs = c.apply_measured(_register(3, dtype=np.complex128), _gen(s),
                                   engine=engine)
        o = tuple(int(x) for x in outs)
        branches.add(o)
        bob = TS.to_dense(q).reshape(2, 2, 2)[:, o[1], o[0]]
        assert abs(np.vdot(want, bob)) ** 2 > 1 - 1e-12, o
    assert len(branches) >= 3
    assert replay(c, range(6), engine, dtype=np.complex128, jc=jc) >= 5


def test_gate_if_validates_conditions():
    c = Circuit(2).h(0)
    with pytest.raises(ValueError, match="measurement"):
        c.x_if(1, (0, 1))
    c.measure(0)
    with pytest.raises(ValueError, match="0 or 1"):
        c.x_if(1, (0, 2))
    with pytest.raises(ValueError, match="pair"):
        c.x_if(1, ((0, 1, 1),))
    c.x_if(1, (0, 1))
    c.z_if(1, ((0, 1), (0, 1)))
    assert c._measure_count() == 1 and c._dynamic_count() == 3


@pytest.mark.parametrize("engine", ENGINES)
def test_classical_on_density_register(engine):
    jc, c, want = _teleport()
    for s in range(8):
        q, outs = c.apply_measured(
            _register(3, density=True, dtype=np.complex128), _gen(s),
            engine=engine)
        o = tuple(int(x) for x in outs)
        rho = TS.to_dense(q).reshape(2, 2, 2, 2, 2, 2)
        rho_bob = rho[:, o[1], o[0], :, o[1], o[0]]
        assert np.real(want.conj() @ rho_bob @ want) > 1 - 1e-12, o
    assert replay(c, range(3), engine, density=True, dtype=np.complex128,
                  jc=jc) >= 2


@pytest.mark.parametrize("engine", ENGINES)
def test_reset_returns_qubit_to_zero(engine):
    c = Circuit(2).h(0).h(1).reset(0)
    for s in range(12):
        q, _ = c.apply_measured(_register(2), _gen(s), engine=engine)
        v = TS.to_dense(q).reshape(2, 2)
        assert np.sum(np.abs(v[:, 1]) ** 2) < 1e-10
        np.testing.assert_allclose(np.abs(v[:, 0]) ** 2, [0.5, 0.5],
                                   atol=1e-6)
    assert replay(c, range(4), engine) >= 3


def test_small_branch_probability_not_forced_at_f64():
    theta = 2 * np.arcsin(np.sqrt(1e-2))   # p(1) = 1e-2
    c = Circuit(1).ry(0, theta).measure(0)
    fn = c.compiled_measured(1, False, device="cpu")
    gen = _gen(0)
    outs = [int(fn(_register(1, dtype=np.complex128).amps, gen)[1][0])
            for _ in range(2000)]
    assert 0.004 < np.mean(outs) < 0.02
    c2 = Circuit(1).measure(0)             # p(1) = 0 exactly: forced
    _, o = c2.apply_measured(_register(1, dtype=np.complex128), _gen(1))
    assert int(o[0]) == 0


def test_measured_program_is_cached_and_device_bound():
    c = Circuit(2).h(0).measure(0)
    fn = c.compiled_measured(2, device="cpu")
    assert c.compiled_measured(2, device="cpu") is fn
    assert c.compiled_measured(2, engine="xla", device="cpu") is not fn
    c.x_if(1, (0, 1))                       # a new op clears the cache
    assert c.compiled_measured(2, device="cpu") is not fn
    with pytest.raises(ValueError, match="compiled for"):
        fn(torch.zeros((2, 4), device="meta"), _gen(0))


def test_circuit_from_ops_carries_dynamic_ops():
    jc, c, _ = _teleport()
    kinds = [op.kind for op in c.ops]
    assert kinds == [op.kind for op in jc.ops] and "classical" in kinds
    inner = [op for op in c.ops if op.kind == "classical"][0].operand[0][0]
    assert type(inner).__module__ == "quest_tpu_torch.circuit"
