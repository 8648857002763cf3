"""The port's fused engine end to end against the JAX package.

Port `compiled_fused(device="cpu")` (every swept segment through the
plain PyTorch version of the segment kernel) against quest_tpu's
`compiled_fused(interpret=True)` and `compiled_banded` on the same
seeded circuits, within 2e-5 x max|amp| and with a norm check; plus the
state initialisers, the conversion helpers, device selection and what
the slice leaves unported."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax.numpy as jnp

from quest_tpu import circuit as JC
from quest_tpu import state as JS
from quest_tpu import validation as JV

import quest_tpu_torch as qtt
from quest_tpu_torch import convert, env, precision, state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.circuit import Circuit, random_circuit

pytestmark = pytest.mark.dtype_agnostic


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """The suite runs several workers side by side. One BLAS thread per
    core per worker (OpenBLAS spins while it waits) oversubscribes the CPU:
    six workers planning at once measured 30x slower each, and starve the
    timing-sensitive tests of the other workers. Pin numpy's BLAS and
    torch to one thread while this module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)

TOL = 2e-5


def _run_port(circ, n, planes):
    prog = circ.compiled_fused(n, device="cpu")
    amps = torch.from_numpy(planes.copy())
    out = prog(amps)
    assert out is amps                   # in place
    return out.numpy()


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


def _norm(planes):
    return float((planes.astype(np.float64) ** 2).sum())


@pytest.mark.parametrize("args", [dict(depth=4, seed=7),
                                  dict(depth=3, seed=3, entangler="cnot")],
                         ids=["cz_d4", "cnot_d3"])
def test_compiled_fused_matches_jax_fused_and_banded(args):
    n = 12
    planes = np.zeros((2, 1 << n), np.float32)
    planes[0, 0] = 1.0
    jc = JC.random_circuit(n, **args)
    tc = random_circuit(n, **args)
    want_banded = np.asarray(jc.compiled_banded(n, False, donate=False)(
        jnp.asarray(planes)))
    want_fused = np.asarray(jc.compiled_fused(
        n, False, donate=False, interpret=True)(jnp.asarray(planes))
    ).reshape(2, -1)
    got = _run_port(tc, n, planes)
    _assert_close(got, want_banded)
    _assert_close(got, want_fused)
    assert abs(_norm(got) - 1.0) < 1e-5


def test_compiled_fused_22_qubits_matches_banded():
    """22q d2: 5 sweeps with b0, b1, scb-128, sc (width-1 top band),
    phase, parity and multiphase stages and no passthrough."""
    n = 22
    jc = JC.random_circuit(n, 2, seed=7)
    tc = random_circuit(n, 2, seed=7)
    parts, _ = tc.fused_parts(n)
    kinds = {getattr(st, "kind", type(st).__name__)
             for p in parts for st in p[1]}
    assert len(parts) == 5 and all(p[0] == "segment" for p in parts)
    assert kinds == {"b0", "b1", "scb", "sc", "PhaseStage", "ParityStage",
                     "MultiPhaseStage"}
    rng = np.random.default_rng(22)
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    planes /= np.sqrt(_norm(planes))
    want = np.asarray(jc.compiled_banded(n, False, donate=False)(
        jnp.asarray(planes)))
    got = _run_port(tc, n, planes)
    _assert_close(got, want)
    assert abs(_norm(got) - 1.0) < 1e-4


def test_iters_unrolls_into_sweeps():
    """iters=3 repeats the plan inside one program (sweep fusion merges
    across applications) and equals three single applications."""
    n = 11
    c = random_circuit(n, 2, seed=5)
    planes = TS.basis_planes(3, n=n, device="cpu").numpy()
    once = planes.copy()
    for _ in range(3):
        once = _run_port(c, n, once)
    prog = c.compiled_fused(n, iters=3, device="cpu")
    assert prog.launches_per_call <= 3 * len(
        c.compiled_fused(n, device="cpu").segments)
    got = prog(torch.from_numpy(planes.copy())).numpy()
    _assert_close(got, once)


def test_state_initialisers_match_reference():
    n = 11
    jq = JS.init_debug_state(JS.create_qureg(n, dtype=np.complex64))
    tq = TS.init_debug_state(TS.create_qureg(n, device="cpu"))
    assert np.array_equal(np.asarray(jq.amps), tq.amps.numpy())
    np.testing.assert_array_equal(JS.to_dense(jq), TS.to_dense(tq))
    z = TS.init_zero_state(tq)
    assert np.array_equal(np.asarray(JS.init_zero_state(jq).amps),
                          z.amps.numpy())
    want = np.asarray(JS.basis_planes(37, n=n, rdt=jnp.float32,
                                      shape=JS.fused_state_shape(n)))
    got = TS.basis_planes(37, n=n, shape=TS.fused_state_shape(n),
                          device="cpu")
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert tq.dtype == np.complex64 and tq.num_amps == 1 << n


def test_convert_round_trips():
    n = 12
    jc = JC.random_circuit(n, 3, seed=9)
    jc.cphase(0.3, 1, 9).swap(2, 3).h(11)
    tc = convert.circuit_from_ops(jc.ops, n)
    assert [(o.kind, o.targets, o.controls, o.cstates) for o in tc.ops] == [
        (o.kind, o.targets, o.controls, o.cstates) for o in jc.ops]
    assert all(np.array_equal(np.asarray(a.operand), np.asarray(b.operand))
               for a, b in zip(tc.ops, jc.ops))
    rng = np.random.default_rng(1)
    planes = rng.standard_normal((2, 1 << (n - 7), 128)).astype(np.float32)
    t = convert.planes_from_numpy(planes, device="cpu")
    assert t.dtype == torch.float32 and t.shape == planes.shape
    assert np.array_equal(t.numpy(), planes)
    parts, _ = tc.fused_parts(n)
    arrays = parts[0][2]
    ops = convert.operands_from_numpy(arrays, device="cpu")
    assert all(np.array_equal(o.numpy(), a) for o, a in zip(ops, arrays))
    flat = (planes.reshape(2, -1) / np.sqrt(_norm(planes))).astype(np.float32)
    want = np.asarray(jc.compiled_banded(n, False, donate=False)(
        jnp.asarray(flat)))
    _assert_close(_run_port(tc, n, flat), want)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from quest_tpu_torch.entry import entry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError):
        random_circuit(10, 1).compiled_fused(10)
    with pytest.raises(RuntimeError):
        TS.create_qureg(10)
    with pytest.raises(RuntimeError):
        convert.planes_from_numpy(np.zeros((2, 1024), np.float32))
    assert env.resolve_device("cpu") == torch.device("cpu")
    fn, (amps,) = entry(device="cpu", num_qubits=12, depth=2)
    assert amps.shape == (2, 32, 128) and amps.device.type == "cpu"
    out = fn(amps)
    assert abs(_norm(out.numpy()) - 1.0) < 1e-5


def test_unported_paths_raise(monkeypatch):
    c = random_circuit(12, 1)
    with pytest.raises(ValueError, match="holds 6 qubits"):
        c.compiled_fused(12, density=True, device="cpu")
    measured = Circuit(12).h(0)
    measured.ops.append(qtt.GateOp("measure", (3,)))
    # a dynamic circuit runs only through compiled_measured, as in the
    # reference
    with pytest.raises(TV.QuESTError, match="compiled_measured"):
        measured.compiled_fused(12, device="cpu")
    # below the kernel tier: the banded fallback, as the reference's
    small = np.zeros((2, 1 << 8), np.float32)
    small[0, 0] = 1.0
    want = np.asarray(JC.random_circuit(8, 1).compiled_fused(
        8, False, donate=False, interpret=True)(jnp.asarray(small)))
    _assert_close(_run_port(random_circuit(8, 1), 8, small), want)
    # a 5-target gate: a passthrough of the fused program
    u = np.linalg.qr(np.random.default_rng(2).normal(size=(32, 32)))[0]
    wide = np.random.default_rng(4).standard_normal(
        (2, 1 << 12)).astype(np.float32)
    jwide = JC.Circuit(12).gate(u, (0, 3, 8, 9, 11))
    want = np.asarray(jwide.compiled_fused(12, False, donate=False,
                                           interpret=True)(
        jnp.asarray(wide.reshape(2, -1, 128)))).reshape(2, -1)
    _assert_close(_run_port(Circuit(12).gate(u, (0, 3, 8, 9, 11)), 12,
                            wide), want)
    # an f64 register
    q64 = TS.create_qureg(10, dtype=np.complex128, device="cpu")
    assert q64.amps.dtype == torch.float64 and q64.dtype == np.complex128
    np.testing.assert_array_equal(q64.amps.numpy(), np.asarray(
        JS.create_qureg(10, dtype=np.complex128).amps))
    # QUEST_FUSED_SCAN=1 builds and runs (tests/test_torch_scan.py)
    monkeypatch.setenv("QUEST_FUSED_SCAN", "1")
    assert c.compiled_fused(12, device="cpu").launches_per_call >= 1
    monkeypatch.setenv("QUEST_FUSED_SCAN", "0")
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "high")
    prog = c.compiled_fused(12, device="cpu")    # the tiers run (S11)
    assert prog.tier == "high" and {s.tier for s in prog.segments} == {"high"}
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "bogus")
    with pytest.raises(ValueError):
        precision.matmul_precision()
    monkeypatch.delenv("QUEST_MATMUL_PRECISION")
    # the batched engine and trajectories run; their other engines raise
    assert c.compiled_batched(3, device="cpu").launches_per_call >= 1
    batch = np.random.default_rng(5).standard_normal(
        (3, 2, 1 << 12)).astype(np.float32)
    want = np.asarray(JC.random_circuit(12, 1).compiled_batched(
        3, donate=False, interpret=True, engine="banded")(jnp.asarray(batch)))
    prog = c.compiled_batched(3, engine="banded", device="cpu")
    _assert_close(prog(torch.from_numpy(batch.copy())).numpy(), want)
    from quest_tpu_torch import trajectories as T
    noisy = Circuit(12).h(0).damping(0, 0.2)
    gen = torch.Generator().manual_seed(0)
    assert T.run_batched(noisy, 2, generator=gen, device="cpu")[1].shape == (
        2, 1)
    # the host engine is ported: it draws what the fused engine draws
    host = T.run_batched(noisy, 2, generator=torch.Generator().manual_seed(1),
                         engine="host", device="cpu")
    fused = T.run_batched(noisy, 2, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    assert torch.equal(host[1], fused[1])
    assert (host[0] - fused[0]).abs().max().item() <= 2e-5


def test_builder_raises_reference_codes():
    for code in TV.ErrorCode:
        assert JV.ErrorCode[code.name].value == code.value
        assert (JV.MESSAGES.get(JV.ErrorCode[code.name])
                == TV.MESSAGES.get(code))
    c = Circuit(4)
    with pytest.raises(qtt.QuESTError) as e:
        c.h(4)
    assert e.value.code is TV.ErrorCode.E_INVALID_TARGET_QUBIT
    with pytest.raises(qtt.QuESTError) as e:
        c.cnot(1, 1)
    assert e.value.code is TV.ErrorCode.E_CONTROL_TARGET_COLLISION
    with pytest.raises(qtt.QuESTError):
        TS.create_qureg(0, device="cpu")


def test_sweep_fusion_knob(monkeypatch):
    n = 12
    c = random_circuit(n, 4, seed=7)
    swept, _ = c.fused_parts(n)
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    raw, _ = c.fused_parts(n)
    assert len(raw) >= len(swept)
    planes = np.zeros((2, 1 << n), np.float32)
    planes[0, 5] = 1.0
    a = _run_port(c, n, planes)
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "1")
    _assert_close(_run_port(c, n, planes), a)


def test_matrix_passthrough_matches_reference():
    """A cross-band 3-qubit gate no kernel stage reaches runs between
    segments through apply_matrix_rows, as the reference runs it
    outside its kernel."""
    n = 12
    u = np.linalg.qr(np.random.default_rng(2).normal(size=(8, 8))
                     + 1j * np.random.default_rng(3).normal(size=(8, 8)))[0]
    jc = JC.Circuit(n).h(0).gate(u, (0, 8, 11)).ry(9, 0.3).x(1, 10)
    tc = convert.circuit_from_ops(jc.ops, n)
    prog = tc.compiled_fused(n, device="cpu")
    assert len(prog.steps) > len(prog.segments)         # a passthrough
    rng = np.random.default_rng(12)
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    planes /= np.sqrt(_norm(planes))
    want = np.asarray(jc.compiled_fused(n, False, donate=False,
                                        interpret=True)(jnp.asarray(planes)))
    _assert_close(_run_port(tc, n, planes), want.reshape(2, -1))
    _assert_close(prog.plain(torch.from_numpy(planes)).numpy(),
                  want.reshape(2, -1))
