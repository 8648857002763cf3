"""The port's batched trajectory engine (quest_tpu_torch.trajectories)
against the reference's (quest_tpu.trajectories).

The reference draws branches with jax.random.categorical on threefry
keys; the port draws by inverse CDF from one uniform per shot per
channel (a torch.Generator). So the engines are compared GIVEN THE
DRAWS: the reference's run_batched(engine="banded") gives planes and
draws, `_uniforms_for` turns each draw into a uniform strictly inside
that branch's interval (the midpoint for a mixture channel; 0 or
1 - 2^-20 for a two-branch general Kraus channel, whose drawn branch
must have probability > 1e-3), and the port's program on those uniforms
must take the same draws and give the same planes within 2e-5 x
max|amp| (the f32 tolerance of tests/conftest.py `tol`). The
reference's own fused batched path is not used: interpret-mode Pallas
cannot run its BatchSelStage in this environment (ROADMAP C). Physics
is then checked by statistics against the port's density engine, and
the plan against the reference's under TPU_GEOMETRY.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax
import jax.numpy as jnp

import bench

from quest_tpu import circuit as JC
from quest_tpu import trajectories as JT
from quest_tpu.ops import pallas_band as PB

from quest_tpu_torch import convert
from quest_tpu_torch import entry as E
from quest_tpu_torch import trajectories as T
from quest_tpu_torch import validation as TV
from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.state import basis_planes
from quest_tpu_torch.ops import band_plan as BP

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5
LAST_U = 1.0 - 2.0 ** -20      # inside the last branch of two
MIN_PROB = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _correlated_decay(gamma):
    """A two-branch general Kraus map on two qubits: |11> decays to |00>
    with probability gamma."""
    k0 = np.eye(4, dtype=np.complex128)
    k0[3, 3] = np.sqrt(1 - gamma)
    k1 = np.zeros((4, 4), dtype=np.complex128)
    k1[0, 3] = np.sqrt(gamma)
    return [k0, k1]


def _zz_dephasing(p):
    z = np.diag([1.0, -1.0])
    return [np.sqrt(1 - p) * np.eye(4), np.sqrt(p) * np.kron(z, z)]


def _noisy_reference_circuit(n):
    """Depolarising, dephasing and damping on a lane, an inner-row and a
    scattered qubit, a two-qubit general Kraus map (a passthrough) and a
    two-qubit mixture."""
    c = JC.Circuit(n)
    for q in (0, 2, 5, 9, 11, n - 1):
        c.h(q)
    c.ry(2, 1.1).cz(2, 9).ry(9, 0.8).cnot(n - 1, 5).rz(11, 0.3)
    c.damping(2, 0.3)                 # lane qubit, state-dependent
    c.depolarising(9, 0.2)            # inner row qubit, mixture
    c.ry(n - 1, 0.9)
    c.dephasing(n - 1, 0.25)          # scattered qubit at n = 15
    c.ry(9, 1.3).cz(0, 9)
    c.damping(9, 0.4)
    c.depolarising(0, 0.3)
    c.kraus((0, 5), _correlated_decay(0.35))
    c.ry(n - 1, 0.5)
    c.damping(n - 1, 0.3)
    c.kraus((2, 11), _zz_dephasing(0.3))
    c.dephasing(5, 0.1).ry(5, 0.4)
    return c


def _uniforms_for(draws, channels):
    """One uniform per shot per channel inside the interval of the branch
    the reference drew (general channels: two branches, 0 or LAST_U)."""
    u = np.zeros(draws.shape, dtype=np.float64)
    for c, ch in enumerate(channels):
        probs = ch["mixture_probs"]
        k = draws[:, c]
        if probs is None:
            assert len(ch["ops"]) == 2
            u[:, c] = np.where(k == 0, 0.0, LAST_U)
            continue
        assert (probs[k] > MIN_PROB).all()
        cum = np.concatenate([[0.0], np.cumsum(probs)])
        u[:, c] = (cum[k] + cum[k + 1]) / 2 / cum[-1]
    return u


@pytest.fixture
def born_spy(monkeypatch):
    """Record the Born probabilities every state-dependent channel
    computes: {channel index: (B, m) array}."""
    seen = {}
    orig = T._Channel.born_probs

    def spy(self, planes, n):
        ps = orig(self, planes, n)
        seen[self.index] = ps.numpy().copy()
        return ps
    monkeypatch.setattr(T._Channel, "born_probs", spy)
    return seen


@pytest.mark.parametrize("n", [12, 15])
def test_trajectories_match_reference_given_the_draws(n, born_spy):
    jc = _noisy_reference_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    shots = 8
    jplanes, jdraws = JT.run_batched(jc, jax.random.key(n), shots,
                                     engine="banded")
    jplanes, jdraws = np.asarray(jplanes), np.asarray(jdraws)
    prog = T._compiled_traj(tc, n, "cpu")
    u = _uniforms_for(jdraws, prog.channel_info)
    planes, draws = prog(torch.from_numpy(u))
    for idx, ps in born_spy.items():
        drawn = ps[np.arange(shots), jdraws[:, idx]]
        assert (drawn > MIN_PROB).all(), (idx, drawn)
    assert len(born_spy) == 4          # 3 dampings + the correlated decay
    np.testing.assert_array_equal(draws.numpy(), jdraws)
    scale = float(np.abs(jplanes).max())
    np.testing.assert_allclose(planes.numpy(), jplanes, atol=TOL * scale,
                               rtol=0)
    plain, plain_draws = prog.plain(torch.from_numpy(u))
    np.testing.assert_array_equal(plain_draws.numpy(), jdraws)
    np.testing.assert_allclose(plain.numpy(), jplanes, atol=TOL * scale,
                               rtol=0)


def _small_noisy_reference_circuit(n):
    """Every channel kind of _noisy_reference_circuit on a register below
    the kernel's 10 qubits."""
    c = JC.Circuit(n)
    for q in range(n):
        c.h(q)
    c.ry(2, 1.1).cz(2, 4).cnot(n - 1, 1).rz(3, 0.3)
    c.damping(2, 0.3)
    c.depolarising(4, 0.2)
    c.ry(n - 1, 0.9).dephasing(n - 1, 0.25)
    c.kraus((0, n - 1), _correlated_decay(0.35))
    c.ry(1, 0.5).damping(1, 0.3)
    c.kraus((2, 3), _zz_dephasing(0.3))
    return c


def _hold_banded_to_reference(jc, n, shots, born_spy):
    """Run the reference's run_batched(engine='banded') on `jc` and the
    port's banded program on its conversion, given the reference's
    draws; assert equal draws and planes within TOL x max|amp|. Returns
    the port's circuit and program."""
    born_spy.clear()
    tc = convert.circuit_from_ops(jc.ops, n)
    jplanes, jdraws = JT.run_batched(jc, jax.random.key(n), shots,
                                     engine="banded")
    jplanes, jdraws = np.asarray(jplanes), np.asarray(jdraws)
    prog = T._compiled_traj(tc, n, "cpu", "banded")
    assert not prog.segments and not any(
        ch["inline"] for ch in prog.channel_info)
    u = _uniforms_for(jdraws, prog.channel_info)
    planes, draws = prog(torch.from_numpy(u))
    for idx, ps in born_spy.items():
        drawn = ps[np.arange(shots), jdraws[:, idx]]
        assert (drawn > MIN_PROB).all(), (idx, drawn)
    np.testing.assert_array_equal(draws.numpy(), jdraws)
    scale = float(np.abs(jplanes).max())
    np.testing.assert_allclose(planes.numpy(), jplanes, atol=TOL * scale,
                               rtol=0)
    return tc, prog


@pytest.mark.parametrize("n,engine", [(6, None), (12, "banded")])
def test_banded_trajectories_match_reference_given_the_draws(n, engine,
                                                             born_spy):
    """The banded program (engine='banded', and the default below 10
    qubits) against the reference's run_batched(engine='banded'), given
    its draws: every channel, one-qubit ones too, drawn from the
    pre-channel states and applied per state between stretches."""
    jc = (_noisy_reference_circuit(n) if n >= 12
          else _small_noisy_reference_circuit(n))
    assert T._resolve_engine(engine, n) == "banded"
    _hold_banded_to_reference(jc, n, 8, born_spy)


@pytest.mark.parametrize("targets", [(0,), (6,), (8,), (11,), (3, 10),
                                     (10, 3), (1, 2, 9)])
def test_born_probabilities_match_reference(targets):
    n, b = 12, 4
    rng = np.random.default_rng(len(targets) * 31 + targets[0])
    planes = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    planes /= np.sqrt((planes.astype(np.float64) ** 2).sum(axis=(1, 2)))[
        :, None, None].astype(np.float32)
    k = len(targets)
    ops = (_correlated_decay(0.4) if k == 2 else
           [np.sqrt(0.7) * np.eye(1 << k),
            np.sqrt(0.3) * np.diag(rng.choice([1.0, -1.0], 1 << k))]
           if k == 3 else
           [np.array([[1, 0], [0, np.sqrt(0.6)]]),
            np.array([[0, np.sqrt(0.4)], [0, 0]])])
    ch = T._Channel({"index": 0, "targets": targets, "ops": ops,
                     "mixture_probs": None}, torch.device("cpu"))
    got = ch.born_probs(torch.from_numpy(planes), n).numpy()
    rho = JT._reduced_density(jnp.asarray(planes), n, targets)
    mkm = np.stack([K.conj().T @ K for K in ops])
    want = np.real(np.einsum("mij,bji->bm", mkm, np.asarray(rho)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _z_expectations(probs, n):
    """<Z_q> of every qubit from (..., 2^n) probabilities."""
    idx = np.arange(1 << n)
    sign = 1 - 2 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)
    return probs @ sign


def test_estimator_matches_the_density_engine():
    """<Z_q> of 512 trajectories of noisy RCS (10 qubits, depth 2) within
    5 standard errors of the port's density engine, on every qubit."""
    n, shots = 10, 512
    circ = E.noisy_rcs_circuit(n, 2)
    planes, draws = T.run_batched(circ, shots, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    assert planes.shape == (shots, 2, 1 << n)
    assert draws.shape == (shots, 2 * n + 2) and draws.dtype == torch.int32
    rho = T.average_density(planes).numpy()
    assert np.allclose(rho, rho.conj().T) and abs(np.trace(rho) - 1) < 1e-5
    x = planes.double().numpy()
    per_shot = _z_expectations(x[:, 0] ** 2 + x[:, 1] ** 2, n)
    sigma = per_shot.std(axis=0) / np.sqrt(shots)
    z_avg = _z_expectations(np.real(np.diag(rho)), n)
    np.testing.assert_allclose(z_avg, per_shot.mean(axis=0), atol=1e-9)
    fn = circ.compiled_fused(2 * n, density=True, device="cpu")
    dens = fn(basis_planes(0, n=2 * n, device="cpu"))
    diag = dens.reshape(2, -1)[0, ::(1 << n) + 1].double().numpy()
    exact = _z_expectations(diag, n)
    assert (np.abs(z_avg - exact) <= 5 * np.maximum(sigma, 1e-9)).all(), (
        z_avg, exact, sigma)


@pytest.mark.parametrize("chunk", [8, 7])
def test_chunking_leaves_trajectories_unchanged(chunk):
    """One 20-shot call and chunks of 8 or 7 (the last chunk at its own
    size, 4 or 6 shots) give the same draws and planes."""
    circ = E.noisy_rcs_circuit(10, 1)

    def run(chunk):
        return T.run_batched(circ, 20, chunk=chunk, device="cpu",
                             generator=torch.Generator().manual_seed(5))
    p1, d1 = run(None)
    p2, d2 = run(chunk)
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=1e-6, rtol=0)
    assert p1.shape == p2.shape == (20, 2, 1 << 10)


def test_observable_reduces_each_chunk():
    circ = E.noisy_rcs_circuit(10, 1)
    gen = torch.Generator().manual_seed(9)
    planes, d1 = T.run_batched(circ, 12, chunk=8, device="cpu",
                               generator=gen)
    calls = []

    def z_top(p):
        calls.append(p.shape[0])
        return E.z_top(p)
    vals, d2 = T.run_batched(circ, 12, chunk=8, device="cpu",
                             observable=z_top,
                             generator=torch.Generator().manual_seed(9))
    assert calls == [8, 4] and vals.shape == (12,)
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    np.testing.assert_allclose(vals.numpy(), E.z_top(planes).numpy(),
                               atol=1e-6, rtol=0)


def _stage_key(st):
    return (type(st).__name__, dataclasses.astuple(st))


@pytest.mark.parametrize("n,batch", [(12, 8), (15, 3), (20, 64)])
def test_plan_matches_reference_under_tpu_geometry(n, batch):
    jc = _noisy_reference_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    jitems, jch = JT._traj_channels_and_items(jc, n, True)
    items, ch = T._traj_channels_and_items(tc, n)
    assert [(c["targets"], c["inline"], c["mixture_probs"] is None)
            for c in ch] == [(c["targets"], c["inline"],
                              c["mixture_probs"] is None) for c in jch]
    ref = PB.sweep_plan(PB.segment_plan(jitems, n, batch=batch), n)
    port = BP.sweep_plan(BP.segment_plan(items, n, batch=batch,
                                         budgets=BP.TPU_GEOMETRY), n,
                         budgets=BP.TPU_GEOMETRY)
    assert [p[0] for p in ref] == [p[0] for p in port]
    for a, b in zip(ref, port):
        if a[0] != "segment":
            assert (type(a[1]).__name__, a[1].index) == (
                type(b[1]).__name__, b[1].index)
            continue
        assert [_stage_key(s) for s in a[1]] == [_stage_key(s) for s in b[1]]
        for x, y in zip(a[2], b[2]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        for j, st in enumerate(b[1]):
            if isinstance(st, BP.BatchSelStage):
                assert b[2][j].shape == (batch, 8)
                assert not st.barrier or j == 0
    for shots in (1, 8, 256):
        want = JT.plan_stats(jc, shots)
        got = T.plan_stats(tc, shots, budgets=BP.TPU_GEOMETRY)
        assert {k: got[k] for k in want} == want


def test_hopper_launches_do_not_depend_on_the_batch():
    circ = E.noisy_rcs_circuit(20, 2)
    one = T.plan_stats(circ, 1)
    many = T.plan_stats(circ, 256)
    assert many["hbm_sweeps"] == one["hbm_sweeps"] == many["kernel_sweeps"]
    assert many["states_per_sweep"] == 256 and many["batched_stages"] == 42
    prog = T.TrajectoryProgram(circ, 20, "cpu")
    assert prog.launches_per_call == one["kernel_sweeps"]
    for batch in (1, 8, 64):
        assert BP.sweep_steps(prog.segments[0].stages, 20, batch) == (
            prog.segments[0].geometry.blocks * batch)


def test_noisy_circuits_convert_with_their_kraus_ops():
    n = 12
    jc = _noisy_reference_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    for a, b in zip(jc.ops, tc.ops):
        assert a.kind == b.kind and tuple(a.targets) == b.targets
        if a.kind == "superop":
            assert b.meta[0] == "kraus"
            assert all(np.array_equal(x, y)
                       for x, y in zip(a.meta[1], b.meta[1]))
    native = Circuit(n)
    for op in tc.ops:
        if op.kind == "superop":
            native.kraus(op.targets, op.meta[1])
    assert all(np.array_equal(a.operand, b.operand) for a, b in
               zip(native.ops, [o for o in tc.ops if o.kind == "superop"]))


def test_unported_engines_and_bad_circuits_raise(born_spy):
    circ = E.noisy_rcs_circuit(10, 1)
    gen = torch.Generator().manual_seed(0)
    # engine='host' is ported: it runs on the CPU (another device is
    # refused) and draws what the banded program draws from one
    # generator state
    host_planes, host_draws = T.run_batched(
        circ, 4, generator=torch.Generator().manual_seed(0), engine="host")
    banded_planes, banded_draws = T.run_batched(
        circ, 4, generator=torch.Generator().manual_seed(0),
        engine="banded", device="cpu")
    assert torch.equal(host_draws, banded_draws)
    assert (host_planes - banded_planes).abs().max() <= 2e-5
    with pytest.raises(ValueError, match="host"):
        T.run_batched(circ, 4, generator=gen, engine="host", device="meta")
    with pytest.raises(ValueError):
        T.run_batched(circ, 4, generator=gen, engine="xla", device="cpu")
    # engine='banded' at 10 qubits, and the default below the kernel tier
    # at 8: each call runs the banded program on the generator's
    # uniforms, and that program on the bench's noisy RCS layer is held
    # against the reference's run_batched(engine='banded') given its draws
    for n, engine in ((10, "banded"), (8, None)):
        small, prog = _hold_banded_to_reference(
            bench._build_traj_circuit(n, 1), n, 4, born_spy)
        planes, draws = T.run_batched(
            small, 4, generator=torch.Generator().manual_seed(n),
            engine=engine, device="cpu")
        u = torch.rand((4, prog.num_channels), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(n))
        again, again_draws = prog(u)
        assert torch.equal(planes, again) and torch.equal(draws, again_draws)
        assert planes.shape == (4, 2, 1 << n)
    with pytest.raises(ValueError):
        T.run_batched(circ, 0, generator=gen, device="cpu")
    with pytest.raises(TypeError):
        T.run_batched(circ, 4, device="cpu")
    bare = Circuit(10)
    bare.ops.append(GateOp("superop", (3,), operand=np.eye(4)))
    with pytest.raises(TV.QuESTError, match="Kraus metadata"):
        T.run_batched(bare, 4, generator=gen, device="cpu")
    measured = Circuit(10).h(0)
    measured.ops.append(GateOp("measure", (3,)))
    with pytest.raises(TV.QuESTError, match="mid-circuit"):
        T.run_batched(measured, 4, generator=gen, device="cpu")


def test_kraus_validation_runs_once_per_channel(monkeypatch):
    calls = []
    orig = TV.validate_kraus_ops

    def counting(ops, k, *a, **kw):
        calls.append(k)
        return orig(ops, k, *a, **kw)
    monkeypatch.setattr(TV, "validate_kraus_ops", counting)
    monkeypatch.setattr(TV, "_VALIDATED_KRAUS", set())
    circ = Circuit(10)
    for q in range(10):
        circ.depolarising(q, 0.1)
    calls.clear()
    T._traj_channels_and_items(circ, 10)
    T._traj_channels_and_items(circ, 10)
    assert calls == [1]
    bad = [np.eye(2), np.eye(2)]
    with pytest.raises(TV.QuESTError):
        TV._validate_kraus_once(bad, 1)


def test_entry_points_on_the_cpu():
    fn, (amps,) = E.batched_entry(device="cpu", num_qubits=10, batch=3)
    assert amps.shape == (3, 2, 8, 128) and fn.launches_per_call >= 1
    norms = fn(amps).double().pow(2).sum(dim=(1, 2, 3))
    assert torch.allclose(norms, torch.ones(3, dtype=torch.float64),
                          atol=1e-5)
    fn, (gen,) = E.trajectory_entry(device="cpu", num_qubits=10, depth=1,
                                    shots=12, chunk=8)
    vals, draws = fn(gen)
    assert vals.shape == (12,) and draws.shape == (12, 11)
    assert (vals.abs() <= 1 + 1e-5).all()


@pytest.mark.parametrize("targets,controls", [((3, 10), ()), ((9, 1, 4), (6,))])
def test_batched_matrix_apply_matches_each_state(targets, controls,
                                                 monkeypatch):
    """apply_matrix_planes on a batch with one operator per state (the
    multi-qubit channel path) equals applying each state's operator
    alone; a small chunk size makes it cut the batch into many chunks."""
    from quest_tpu_torch.ops import apply as TA
    n, b = 11, 3
    d = 1 << len(targets)
    rng = np.random.default_rng(d + len(controls))
    planes = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    ops = rng.standard_normal((2, b, d, d)).astype(np.float32)
    want = planes.copy()
    for s in range(b):
        TA.apply_matrix_planes(torch.from_numpy(want[s]), n,
                               torch.from_numpy(ops[0, s]),
                               torch.from_numpy(ops[1, s]), targets, controls)
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << 7)
    got = TA.apply_matrix_planes(torch.from_numpy(planes.copy()), n,
                                 torch.from_numpy(ops[0]),
                                 torch.from_numpy(ops[1]), targets, controls)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * scale, rtol=0)
    rho = T._reduced_density(torch.from_numpy(planes), n, targets)
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << 24)
    whole = T._reduced_density(torch.from_numpy(planes), n, targets)
    for x, y in zip(rho, whole):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# the eager per-shot workers (ref quest_tpu/trajectories.py:42-162)
# ---------------------------------------------------------------------------

def _eager_state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 1 << n))
    v /= np.sqrt((v ** 2).sum())
    return v.astype(np.float32)


def _uniform_inside(probs, k):
    """A uniform whose inverse-CDF pick over `probs` is branch k (the
    middle of its interval)."""
    p = np.maximum(np.asarray(probs, dtype=np.float64), 0.0)
    cum = np.cumsum(p)
    lo = cum[k - 1] if k else 0.0
    return float((lo + cum[k]) / 2.0 / cum[-1])


EAGER = [
    ("damping", (2, 0.35), None),
    ("dephasing", (1, 0.3), [0.7, 0.3]),
    ("depolarising", (0, 0.45), [0.55, 0.15, 0.15, 0.15]),
    ("pauli", (3, 0.1, 0.25, 0.2), [0.45, 0.1, 0.25, 0.2]),
]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name,args,probs", EAGER,
                         ids=[e[0] for e in EAGER])
def test_eager_workers_match_reference_given_its_draws(name, args, probs,
                                                       seed):
    n = 4
    v = _eager_state(n, seed)
    ref, _, k = getattr(JT, name)(jnp.asarray(v), jax.random.key(seed), n,
                                  *args)
    k = int(k)
    if probs is None:          # Born probabilities of the damping branches
        t = args[0]
        psi = (v[0] + 1j * v[1]).astype(np.complex128)
        p1 = np.sum(np.abs(psi[(np.arange(1 << n) >> t) & 1 == 1]) ** 2)
        probs = [1.0 - args[1] * p1, args[1] * p1]
    u = _uniform_inside(probs, k)
    amps = torch.from_numpy(v.copy())
    out, got = getattr(T, name + "_given")(amps, u, n, *args)
    assert got == k and out is amps
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 2e-6


@pytest.mark.parametrize("targets", [(1,), (0, 2)])
def test_eager_kraus_matches_reference_given_its_draws(targets):
    n = 4
    rng = np.random.default_rng(9)
    d = 1 << len(targets)
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    u, _ = np.linalg.qr(z)
    ops = [np.sqrt(0.6) * np.eye(d), np.sqrt(0.4) * u]
    for seed in range(4):
        v = _eager_state(n, seed)
        ref, _, k = JT.kraus(jnp.asarray(v), jax.random.key(seed), n,
                             targets, ops)
        k = int(k)
        probs = [0.6, 0.4]      # K^+K proportional to I: state-independent
        out, got = T.kraus_given(torch.from_numpy(v.copy()),
                                 _uniform_inside(probs, k), n, targets, ops)
        assert got == k
        assert np.abs(out.numpy() - np.asarray(ref)).max() <= 2e-6
        mix = np.asarray(JT.unitary_mixture(
            jnp.asarray(v), jax.random.key(seed), n, targets, [0.6, 0.4],
            [np.eye(d), u])[0])
        kk = int(JT.unitary_mixture(jnp.asarray(v), jax.random.key(seed), n,
                                    targets, [0.6, 0.4], [np.eye(d), u])[2])
        out, got = T.unitary_mixture_given(
            torch.from_numpy(v.copy()), _uniform_inside(probs, kk), n,
            targets, [0.6, 0.4], [np.eye(d), u])
        assert got == kk
        assert np.abs(out.numpy() - mix).max() <= 2e-6


def test_eager_workers_draw_from_their_generator():
    """Equal generator states give equal branches; over many shots the
    branch frequencies follow the channel's probabilities, and a branch
    of probability 0 is never drawn."""
    n = 3
    v = torch.from_numpy(_eager_state(n, 1))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(5):
        a, ka = T.depolarising(v.clone(), g1, n, 0, 0.3)
        b, kb = T.depolarising(v.clone(), g2, n, 0, 0.3)
        assert ka == kb and torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    counts = np.bincount([T.pauli(v.clone(), g, n, 1, 0.2, 0.0, 0.3)[1]
                          for _ in range(2000)], minlength=4)
    assert counts[2] == 0
    assert abs(counts[0] / 2000 - 0.5) < 0.05
    assert abs(counts[3] / 2000 - 0.3) < 0.05
    zero = torch.zeros((2, 1 << n))
    zero[0, 0] = 1.0
    for _ in range(20):      # |0> never decays: p(branch 1) = 0
        assert T.damping(zero.clone(), g, n, 0, 0.9)[1] == 0


@pytest.mark.parametrize("call", [
    lambda v, g: T.damping(v, g, 3, 0, 1.5),
    lambda v, g: T.dephasing(v, g, 3, 0, -0.1),
    lambda v, g: T.pauli(v, g, 3, 0, 0.5, 0.4, 0.3),
    lambda v, g: T.kraus(v, g, 3, 0, [np.eye(2) * 0.5])])
def test_eager_workers_validate_like_the_reference(call):
    v = torch.from_numpy(_eager_state(3, 0))
    with pytest.raises(TV.QuESTError):
        call(v, torch.Generator().manual_seed(0))
