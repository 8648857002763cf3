"""The port's serving engine (quest_tpu_torch.serve) on the CPU, mirroring
tests/test_serve.py and the serving cases of tests/test_resilience.py.

Every engine here runs on device="cpu", where the batched programs run
the plain PyTorch versions of the segment kernel (10 qubits and up) or
the banded program (below). Requests coalesce into one batched launch
per program key with no padding: an apply batch of k requests runs
exactly k states, and its outputs equal the same states through
Circuit.compiled_batched. A trajectory request draws its uniforms at
submit from its own generator, so its draws equal run_batched's from the
same generator state whether it rides alone or coalesced. The resilience
paths (supervised restart, the breaker ladder fused -> banded -> host and
back, the poisoned-batch split, per-request demux, the watchdog, durable
requests) are driven through the fault sites of resilience.faults. The
same circuits and numpy-seeded states also go through the reference's
quest_tpu.serve.ServeEngine: apply, observable and ladder requests agree
within 2e-5, and trajectory requests given the reference's draws (mapped
to uniforms) draw the same branches and agree within 2e-5. The scrape
format is round-tripped through the reference's parse_scrape.

Every future and join has an explicit timeout (the suite runs under
several workers with no per-test timeout).
"""

import contextlib
import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax

from quest_tpu import env as jenv
from quest_tpu.circuit import Circuit as JCircuit
from quest_tpu.ops import expec as JX
from quest_tpu.serve import ServeEngine as JServeEngine
from quest_tpu.serve import metrics as jmetrics

from quest_tpu_torch import calculations as K
from quest_tpu_torch import convert
from quest_tpu_torch import env as TE
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.ops.expec import PauliSum
from quest_tpu_torch.resilience import Breaker, FaultPlan, Supervisor
from quest_tpu_torch.resilience import faults
from quest_tpu_torch.serve import (DeadlineExceeded, DispatchTimeout,
                                   RejectedError, ServeEngine, admission,
                                   default_buckets, metrics, warmup)
from quest_tpu_torch.serve import engine as SE
from quest_tpu_torch.serve.engine import DEFAULT_LADDER, traj_dispatch_bucket
from quest_tpu_torch.state import Qureg

from .test_torch_trajectories import _uniforms_for

pytestmark = pytest.mark.dtype_agnostic

N = 6
WIDE = 10          # the segment kernel's tier: the fused program
T_OUT = 120        # seconds any one future may take


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    before = faults.current()
    yield
    faults.install(before)


def _circuit_a(n: int = N) -> Circuit:
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    return c.cnot(0, 1).rz(2, 0.25).cz(1, 3).rx(0, 0.5)


def _circuit_b(n: int = N) -> Circuit:
    c = Circuit(n).h(0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c.t(1).ry(3, 0.7)


def _noisy_circuit(n: int = 4) -> Circuit:
    c = Circuit(n).h(0).cnot(0, 1)
    c.depolarising(0, 0.1).damping(1, 0.2)
    return c.ry(2, 0.3).dephasing(2, 0.15)


def _random_states(b: int, n: int = N, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    return s / np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))


def _alone(c, states, density=False, engine=None):
    """Each state alone through the batched program (the reference the
    served outputs are held to)."""
    fn = c.compiled_batched(1, density=density, device="cpu", engine=engine)
    return [fn(torch.from_numpy(np.array(s))[None])[0] for s in states]


def _close(got, want, tol=2e-5):
    """Planes within tol x max|amp| (the suite's f32 tolerance): a batch
    of B states through the banded program contracts in other shapes
    than one state alone, so the two may differ in the last bits."""
    want = want.reshape(got.shape)
    return (got - want).abs().max().item() <= tol * want.abs().max().item()


def _engine(**kw):
    kw.setdefault("registry", metrics.Registry())
    kw.setdefault("device", "cpu")
    kw.setdefault("backoff_base_s", 0.0)
    return ServeEngine(**kw)


def _z0(planes_b):
    v = (planes_b[:, 0] ** 2 + planes_b[:, 1] ** 2).reshape(
        planes_b.shape[0], 2, -1)
    return v[:, 0].sum(dim=1) - v[:, 1].sum(dim=1)


# ---------------------------------------------------------------------------
# against the reference's ServeEngine
# ---------------------------------------------------------------------------


def _ref_circuit(n: int) -> JCircuit:
    c = JCircuit(n)
    for q in range(n):
        c.h(q)
    c.cnot(0, 1).rz(2, 0.25).cz(1, 3).rx(0, 0.5).t(n - 1)
    return c.cphase(0.3, n - 2, 1).ry(3, 0.7)


def _ref_noisy(n: int) -> JCircuit:
    c = JCircuit(n).h(0).cnot(0, 1)
    c.depolarising(0, 0.1).damping(1, 0.2)
    c.ry(2, 0.3).dephasing(2, 0.15).dephasing(3, 0.05)
    return c.h(3).cz(2, 3).rx(n - 1, 0.4).damping(n - 1, 0.3)


def _ref_served(jc, submits, max_batch):
    """The reference engine's results of submit(jc, **kw) for each kw in
    `submits`, all queued at once (its Pallas programs in interpret
    mode, as its own tests run them on the CPU)."""
    with JServeEngine(max_wait_ms=10_000, max_batch=max_batch,
                      interpret=True, registry=jmetrics.Registry()) as je:
        futs = [je.submit(jc, **kw) for kw in submits]
        je.drain(timeout_s=T_OUT)
        return [f.result(timeout=T_OUT) for f in futs]


def _pauli_pair(n: int, seed: int):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(5, n))
    coeffs = rng.standard_normal(5)
    return (JX.PauliSum.of(codes, coeffs, n),
            PauliSum.of(codes, coeffs, n))


@pytest.mark.parametrize("n", [N, WIDE])
def test_apply_and_observable_requests_match_the_reference_engine(n):
    """One coalesced batch of raw-planes and PauliSum requests through
    both engines: planes within 2e-5 x max|amp|, values within 2e-5."""
    jc = _ref_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    states = _random_states(6, n, seed=53)
    jspec, tspec = _pauli_pair(n, 3)
    kws = [{"state": s} for s in states[:4]]
    jout = _ref_served(jc, kws + [{"state": s, "observable": jspec}
                                  for s in states[4:]], 6)
    with _engine(max_wait_ms=10_000, max_batch=6) as eng:
        futs = [eng.submit(tc, **kw) for kw in kws]
        futs += [eng.submit(tc, state=s, observable=tspec)
                 for s in states[4:]]
        tout = [f.result(timeout=T_OUT) for f in futs]
    for got, want in zip(tout[:4], jout[:4]):
        assert _close(got, torch.from_numpy(np.array(want)))
    for got, want in zip(tout[4:], jout[4:]):
        assert abs(float(got) - float(want)) <= 2e-5 * max(1.0,
                                                          abs(float(want)))


@pytest.mark.parametrize("rung", ["banded", "host"])
def test_ladder_rungs_match_the_reference_engine(rung):
    """With the fused build failing and the breaker open, requests
    served on each lower rung agree with the reference engine's outputs
    on the same states within 2e-5 x max|amp|."""
    n = WIDE
    jc = _ref_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    states = _random_states(4, n, seed=59)
    jout = _ref_served(jc, [{"state": s} for s in states], 4)
    plan = FaultPlan().inject("serve.compile", error=RuntimeError("broken"),
                              times=100,
                              match=lambda ctx: ctx["rung"] == "fused")
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=0, max_batch=4, breaker_threshold=1,
                     breaker_cooldown_s=600.0, ladder=("fused", rung),
                     registry=reg) as eng:
            with pytest.raises(RuntimeError, match="broken"):
                eng.submit(tc, state=states[0]).result(timeout=T_OUT)
            tout = [eng.submit(tc, state=s).result(timeout=T_OUT)
                    for s in states]
    assert reg.counter("serve_degraded_dispatches").value == len(states)
    for got, want in zip(tout, jout):
        assert _close(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("traj_engine", [None, "host"])
def test_traj_requests_match_the_reference_engine_given_its_draws(
        traj_engine, monkeypatch):
    """Two coalesced trajectory requests through the reference engine;
    the same requests through the port's engine given the reference's
    draws (each mapped to a uniform inside its branch) draw the same
    branches and give planes within 2e-5."""
    n = N
    jc = _ref_noisy(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    keys = (3, 4)
    jout = _ref_served(jc, [{"shots": 5, "key": jax.random.key(k)}
                            for k in keys], 8)
    info = T._compiled_traj(tc, n, "cpu", traj_engine or "banded") \
        .channel_info
    mapped = [torch.from_numpy(_uniforms_for(np.asarray(d), info))
              for _, d in jout]
    handed = iter(mapped)
    monkeypatch.setattr(SE, "_draw_uniforms", lambda shots, c, g:
                        next(handed))
    with _engine(max_wait_ms=10_000, max_batch=8,
                 traj_engine=traj_engine) as eng:
        futs = [eng.submit(tc, shots=5, seed=k) for k in keys]
        eng.drain(timeout_s=T_OUT)
        tout = [f.result(timeout=T_OUT) for f in futs]
    for (tp, td), (jp, jd) in zip(tout, jout):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# demux and coalescing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [N, WIDE])
def test_apply_demux_matches_each_state_alone(n):
    """Coalesced submits resolve to what each state gives alone through
    the batched program (nothing pads the batch)."""
    c = _circuit_a(n)
    states = _random_states(8, n)
    want = _alone(c, states)
    reg = metrics.Registry()
    with _engine(max_wait_ms=10_000, max_batch=8, registry=reg) as eng:
        futs = [eng.submit(c, state=s) for s in states]
        outs = [f.result(timeout=T_OUT) for f in futs]
    for got, w in zip(outs, want):
        assert got.device.type == "cpu"
        assert _close(got, w)
    snap = reg.snapshot()
    assert snap["counters"]["serve_batches_dispatched"] == 1
    assert snap["histograms"]["serve_batch_occupancy"]["mean"] == 1.0


def test_apply_demux_from_many_client_threads():
    c = _circuit_a()
    states = _random_states(16, seed=3)
    want = _alone(c, states)
    results: dict = {}
    with _engine(max_wait_ms=10_000, max_batch=8) as eng:
        def client(i):
            results[i] = eng.submit(c, state=states[i]).result(timeout=T_OUT)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(states))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T_OUT)
    for i, w in enumerate(want):
        assert _close(results[i], w)


def test_partial_batch_launches_exactly_its_states(monkeypatch):
    """No padding: 3 coalesced requests launch a batch of 3 states."""
    c = _circuit_a(WIDE)
    seen = []
    prog = c.compiled_batched(1, device="cpu")
    orig = type(prog).__call__

    def spy(self, amps):
        seen.append(tuple(amps.shape))
        return orig(self, amps)
    monkeypatch.setattr(type(prog), "__call__", spy)
    reg = metrics.Registry()
    with _engine(max_wait_ms=600_000, max_batch=8, registry=reg) as eng:
        futs = [eng.submit(c, state=s) for s in _random_states(3, WIDE)]
        eng.drain(timeout_s=T_OUT)
        for f in futs:
            f.result(timeout=T_OUT)
    assert seen == [(3, 2, 1 << WIDE)]
    occ = reg.snapshot()["histograms"]["serve_batch_occupancy"]
    assert occ["mean"] == pytest.approx(3 / 8)
    assert traj_dispatch_bucket(3, 8) == 3
    assert traj_dispatch_bucket(100, 64) == 64


def test_f64_and_density_requests_queue_apart():
    """The plane dtype and register kind are part of the program key:
    f64 planes run the banded items, density requests their own
    program."""
    c = _circuit_a(4)
    s32 = _random_states(2, 4, seed=4)
    s64 = s32.astype(np.float64)
    rho = np.zeros((2, 1 << 8), dtype=np.float32)
    rho[0, 0] = 1.0
    reg = metrics.Registry()
    with _engine(max_wait_ms=10_000, max_batch=8, registry=reg) as eng:
        futs = [eng.submit(c, state=s) for s in (*s32, *s64)]
        fd = eng.submit(c, state=rho, density=True)
        eng.drain(timeout_s=T_OUT)
        outs = [f.result(timeout=T_OUT) for f in futs]
        out_rho = fd.result(timeout=T_OUT)
    assert reg.counter("serve_batches_dispatched").value == 3
    assert outs[2].dtype == torch.float64
    for got, w in zip(outs[2:], _alone(c, s64)):
        assert _close(got, w)
    want_rho = _alone(c, [rho], density=True)[0]
    assert _close(out_rho, want_rho)


def test_traj_coalesced_draws_equal_run_batched():
    """A coalesced trajectory request reproduces its standalone
    run_batched result: the uniforms are drawn at submit from its own
    generator, shot-major."""
    c = _noisy_circuit()
    want1 = T.run_batched(c, 5, generator=torch.Generator().manual_seed(7),
                          device="cpu")
    want2 = T.run_batched(c, 3, generator=torch.Generator().manual_seed(11),
                          device="cpu")
    reg = metrics.Registry()
    with _engine(max_wait_ms=10_000, max_batch=8, registry=reg) as eng:
        f1 = eng.submit(c, shots=5, generator=torch.Generator().manual_seed(7))
        f2 = eng.submit(c, shots=3, seed=11)
        eng.drain(timeout_s=T_OUT)
        p1, d1 = f1.result(timeout=T_OUT)
        p2, d2 = f2.result(timeout=T_OUT)
    assert reg.counter("serve_batches_dispatched").value == 1
    assert torch.equal(d1, want1[1]) and torch.equal(d2, want2[1])
    assert torch.equal(p1, want1[0]) and torch.equal(p2, want2[0])


def test_traj_request_larger_than_max_batch_chunks_and_matches():
    c = _noisy_circuit(WIDE)
    want_p, want_d = T.run_batched(
        c, 10, generator=torch.Generator().manual_seed(13), device="cpu")
    reg = metrics.Registry()
    with _engine(max_wait_ms=0, max_batch=4, registry=reg) as eng:
        p, d = eng.submit(c, shots=10, seed=13).result(timeout=T_OUT)
    assert torch.equal(d, want_d)
    assert (p - want_p).abs().max().item() <= 2e-5
    # 10 slots in chunks of 4: 3 launches, the last of 2 states
    assert reg.snapshot()["counters"]["serve_batches_dispatched"] == 3


def test_traj_observable_matches_run_batched():
    c = _noisy_circuit()
    want_v, want_d = T.run_batched(
        c, 5, generator=torch.Generator().manual_seed(9), observable=_z0,
        device="cpu")
    with _engine(max_wait_ms=5, max_batch=8) as eng:
        got_v, got_d = eng.submit(c, shots=5, seed=9,
                                  observable=_z0).result(timeout=T_OUT)
    assert torch.equal(got_d, want_d)
    assert torch.allclose(got_v, want_v, rtol=0, atol=1e-6)


def test_observable_reduction_applies_per_request():
    c = _circuit_a()
    s = _random_states(1)[0]
    want = _z0(_alone(c, [s])[0][None])[0]
    with _engine(max_wait_ms=5) as eng:
        got = eng.submit(c, state=s, observable=_z0).result(timeout=T_OUT)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_pauli_sum_observable_resolves_at_admission():
    """A PauliSum observable resolves at submit (a width mismatch
    rejects the submit) and its values equal expec on each state."""
    n = 5
    c = _circuit_b(n)
    codes = [[3, 3, 0, 0, 0], [1, 0, 0, 0, 0], [0, 0, 2, 2, 0]]
    coeffs = [0.5, -0.25, 0.75]
    spec = PauliSum.of(codes, coeffs, n)
    states = _random_states(4, n, seed=31)
    outs = _alone(c, states)
    with _engine(max_wait_ms=10_000, max_batch=4) as eng:
        with pytest.raises(ValueError, match="qubits"):
            eng.submit(c, state=states[0], observable=PauliSum.of(
                [row + [0] for row in codes], coeffs, n + 1))
        futs = [eng.submit(c, state=s, observable=spec) for s in states]
        futs.append(eng.submit(c, shots=2, observable=(codes, coeffs)))
        eng.drain(timeout_s=T_OUT)
        vals = [f.result(timeout=T_OUT) for f in futs[:4]]
        tv, td = futs[4].result(timeout=T_OUT)
    for v, o in zip(vals, outs):
        q = Qureg(amps=o.reshape(2, -1).clone(), num_qubits=n)
        want = K.calc_expec_pauli_sum(q, codes, coeffs)
        assert float(v) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    assert tv.shape == (2,) and td.shape == (2, 0)


# ---------------------------------------------------------------------------
# batching policy and admission
# ---------------------------------------------------------------------------


def test_no_coalescing_mode_launches_alone():
    c = _circuit_a()
    reg = metrics.Registry()
    with _engine(max_wait_ms=0, max_batch=8, registry=reg) as eng:
        futs = [eng.submit(c, state=s) for s in _random_states(4, seed=13)]
        for f in futs:
            f.result(timeout=T_OUT)
    assert reg.snapshot()["counters"]["serve_batches_dispatched"] == 4


def test_overflow_rejects_loudly():
    c = _circuit_a()
    reg = metrics.Registry()
    s = _random_states(1)[0]
    with _engine(max_wait_ms=60_000, max_queue=2, max_batch=64,
                 registry=reg) as eng:
        f1 = eng.submit(c, state=s)
        f2 = eng.submit(c, state=s)
        with pytest.raises(RejectedError, match="queue is full"):
            eng.submit(c, state=s)
        assert reg.counter("serve_requests_rejected").value == 1
        eng.drain(timeout_s=T_OUT)
        assert f1.done() and f2.done()


def test_deadline_expires_before_dispatch():
    c = _circuit_a()
    reg = metrics.Registry()
    with _engine(max_wait_ms=60_000, registry=reg) as eng:
        f = eng.submit(c, state=_random_states(1)[0], deadline_s=0.0)
        with pytest.raises(DeadlineExceeded, match="deadline"):
            f.result(timeout=T_OUT)
        eng.drain(timeout_s=T_OUT)
        assert reg.counter("serve_requests_expired").value == 1
        assert reg.counter("serve_batches_dispatched").value == 0


def test_drain_returns_only_after_expired_futures_complete():
    c = _circuit_a()
    with _engine(max_wait_ms=60_000) as eng:
        f = eng.submit(c, state=_random_states(1)[0], deadline_s=0.0)
        eng.drain(timeout_s=T_OUT)
        assert f.done()
        assert isinstance(f.exception(timeout=0), DeadlineExceeded)


def test_live_requests_survive_a_neighbours_deadline():
    c = _circuit_a()
    states = _random_states(2, seed=21)
    want = _alone(c, states[1:])[0]
    with _engine(max_wait_ms=150, max_batch=8) as eng:
        dead = eng.submit(c, state=states[0], deadline_s=0.0)
        live = eng.submit(c, state=states[1])
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=T_OUT)
        assert _close(live.result(timeout=T_OUT), want)


def test_cancel_before_dispatch():
    c = _circuit_a()
    reg = metrics.Registry()
    with _engine(max_wait_ms=60_000, registry=reg) as eng:
        f = eng.submit(c, state=_random_states(1)[0])
        assert f.cancel()
        eng.drain(timeout_s=T_OUT)
        assert f.cancelled()
        assert reg.counter("serve_requests_cancelled").value == 1
        assert reg.counter("serve_batches_dispatched").value == 0
        g = eng.submit(c, state=_random_states(1)[0])
        assert g.cancel() and eng.reap_cancelled() == 1
    assert reg.counter("serve_requests_cancelled").value == 2


def test_drain_flushes_partial_batch_and_close_rejects():
    c = _circuit_a()
    reg = metrics.Registry()
    states = _random_states(3, seed=17)
    eng = _engine(max_wait_ms=600_000, max_batch=8, registry=reg)
    try:
        futs = [eng.submit(c, state=s) for s in states]
        t0 = time.monotonic()
        eng.drain(timeout_s=T_OUT)
        assert time.monotonic() - t0 < 590
        assert all(f.done() for f in futs)
        assert reg.snapshot()["counters"]["serve_batches_dispatched"] == 1
    finally:
        eng.close(timeout_s=T_OUT)
    with pytest.raises(RejectedError, match="engine closed"):
        eng.submit(c, state=states[0])
    with pytest.raises(RejectedError, match="engine closed"):
        eng.drain(timeout_s=5)
    eng.close(timeout_s=T_OUT)
    assert eng.state == "closed"


def test_concurrent_drains_both_flush():
    c = _circuit_a()
    with _engine(max_wait_ms=600_000, max_batch=8) as eng:
        futs = [eng.submit(c, state=s) for s in _random_states(3, seed=27)]
        errs: list = []

        def do_drain():
            try:
                eng.drain(timeout_s=T_OUT)
            except Exception as e:      # noqa: BLE001 - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=do_drain) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T_OUT)
        assert not errs
        assert all(f.done() for f in futs)


def test_submit_validates_inputs():
    c = _circuit_a()
    s = _random_states(1)[0]
    with _engine(max_wait_ms=0) as eng:
        with pytest.raises(ValueError, match="exactly one"):
            eng.submit(c)
        with pytest.raises(ValueError, match="exactly one"):
            eng.submit(c, state=s, shots=4)
        with pytest.raises(ValueError, match="planes"):
            eng.submit(c, state=s[:, :4])
        with pytest.raises(ValueError, match="shots"):
            eng.submit(c, shots=0)
        with pytest.raises(ValueError, match="density"):
            eng.submit(c, shots=2, density=True)
        with pytest.raises(ValueError, match="generator"):
            eng.submit(c, state=s, seed=3)
        with pytest.raises(ValueError, match="not both"):
            eng.submit(c, shots=2, seed=1,
                       generator=torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="durable_dir"):
            eng.submit(c, state=s, durable_every=2)
    with pytest.raises(ValueError, match="ladder"):
        _engine(ladder=("fused", "xla"))


# ---------------------------------------------------------------------------
# metrics and the scrape
# ---------------------------------------------------------------------------


def test_metrics_snapshot_schema():
    c = _circuit_a()
    reg = metrics.Registry()
    with _engine(max_wait_ms=5, registry=reg) as eng:
        eng.submit(c, state=_random_states(1)[0]).result(timeout=T_OUT)
    snap = reg.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    for name, v in snap["counters"].items():
        assert isinstance(name, str) and isinstance(v, int), (name, v)
    for name in ("serve_requests_submitted", "serve_requests_served",
                 "serve_batches_dispatched"):
        assert snap["counters"][name] >= 1, snap
    for name, h in snap["histograms"].items():
        assert set(h) == {"count", "mean", "p50", "p95", "p99"}, (name, h)
    for name in ("serve_batch_occupancy", "serve_queue_wait_s",
                 "serve_e2e_latency_s"):
        assert snap["histograms"][name]["count"] >= 1, snap
    json.dumps(snap)


def test_histogram_percentiles():
    h = metrics.Histogram("t")
    for x in range(1, 101):
        h.observe(float(x))
    s = h.summary()
    assert s["count"] == 100 and s["mean"] == pytest.approx(50.5)
    assert s["p50"] == pytest.approx(50.0, abs=1.5)
    assert s["p99"] == pytest.approx(99.0, abs=1.5)


def _filled_registry():
    reg = metrics.Registry()
    reg.counter("serve_requests_served").inc(7)
    reg.gauge("serve_breakers_open").set(1.0)
    reg.gauge("tenant weird-name!").set(2.5)
    h = reg.histogram("serve_e2e_latency_s")
    for x in (0.001, 0.002, 0.004, 0.5):
        h.observe(x)
    return reg


def test_scrape_round_trips_through_both_parsers():
    """The port's scrape parses identically with the reference's
    parse_scrape and the port's, and render_snapshot of the parsed
    snapshot parses back to the same dict."""
    reg = _filled_registry()
    text = reg.scrape()
    ours, theirs = metrics.parse_scrape(text), jmetrics.parse_scrape(text)
    assert ours == theirs
    assert ours["counters"]["serve_requests_served"] == 7
    assert ours["gauges"]["tenant_weird_name_"] == 2.5
    h = ours["histograms"]["serve_e2e_latency_s"]
    assert h["count"] == 4 and h["mean"] == pytest.approx(0.12675)
    assert metrics.parse_scrape(metrics.render_snapshot(ours)) == ours
    assert metrics.render_snapshot(ours) == jmetrics.render_snapshot(ours)
    snap = reg.snapshot()
    assert metrics.merge_snapshots([snap, snap]) == \
        jmetrics.merge_snapshots([snap, snap])
    assert metrics._prom_name("9a b") == jmetrics._prom_name("9a b")
    assert metrics._prom_value(3.0) == "3" and metrics._prom_value(0.5) \
        == jmetrics._prom_value(0.5)
    with pytest.raises(ValueError):
        metrics.parse_scrape("not a metric line")


def test_serve_scrape_answers_a_real_get():
    reg = _filled_registry()
    srv = metrics.serve_scrape(reg, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert metrics.parse_scrape(body) == metrics.parse_scrape(reg.scrape())


# ---------------------------------------------------------------------------
# warmup and knobs
# ---------------------------------------------------------------------------


def test_default_buckets():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(6) == (1, 2, 4, 6)
    assert default_buckets(1) == (1,)


def test_warmup_builds_programs_once(monkeypatch):
    """warmup builds each circuit's program once and runs one launch per
    distinct batch it would see; the first request then builds nothing."""
    monkeypatch.setenv("QUEST_HBM_BYTES", str(1 << 34))
    c, cn = _circuit_a(WIDE), _noisy_circuit()
    with _engine(max_wait_ms=0, max_batch=4) as eng:
        rep = warmup(eng, [c, cn], buckets=[1, 3, 8])
        assert set(rep) == {"programs", "plans", "plan_cache", "total_s"}
        assert set(rep["programs"]) == {"c0:b1", "c0:b3", "c0:b8",
                                        "c1:b1", "c1:b3", "c1:b4"}
        assert rep["plans"]["c1"]["source"] == "unpriced:traj"
        built = (dict(c._compiled), dict(cn._compiled))
        eng.submit(c, state=_random_states(1, WIDE)[0]).result(timeout=T_OUT)
        eng.submit(cn, shots=3).result(timeout=T_OUT)
        assert (dict(c._compiled), dict(cn._compiled)) == built
        with pytest.raises(ValueError, match="kind"):
            warmup(eng, [c], kind="bogus")
    with pytest.raises(RejectedError, match="closed"):
        warmup(eng, [c])


def test_serve_knobs_registered_and_parse_loudly(monkeypatch):
    names = {n for n in TE.KNOBS if n.startswith("QUEST_SERVE_")}
    assert names == {"QUEST_SERVE_MAX_WAIT_MS", "QUEST_SERVE_MAX_QUEUE",
                     "QUEST_SERVE_MAX_BATCH", "QUEST_SERVE_RESTART_MAX",
                     "QUEST_SERVE_BREAKER_THRESHOLD",
                     "QUEST_SERVE_TENANT_QUOTA",
                     "QUEST_SERVE_SHED_THRESHOLD", "QUEST_SERVE_REPLICAS",
                     "QUEST_SERVE_PRIORITIES"}
    for name in (*names, "QUEST_DISPATCH_TIMEOUT_S", "QUEST_HOST_BLOCK",
                 "QUEST_FLEET_PROC", "QUEST_FLEET_MIN_REPLICAS",
                 "QUEST_FLEET_MAX_REPLICAS", "QUEST_HEARTBEAT_S"):
        ref = jenv.KNOBS[name].default
        assert TE.KNOBS[name].default == (ref() if callable(ref) else ref)
        bad = jenv.KNOBS[name].malformed
        with pytest.raises(ValueError):
            TE.KNOBS[name].parse(bad)
    assert TE.KNOBS["QUEST_SERVE_TENANT_QUOTA"].default == {
        "default": admission.DEFAULT_TENANT_QUOTA}
    assert TE.KNOBS["QUEST_HOST_BLOCK"].scope == "keyed"
    monkeypatch.setenv("QUEST_SERVE_MAX_WAIT_MS", "0")
    monkeypatch.setenv("QUEST_SERVE_MAX_QUEUE", "1")
    monkeypatch.setenv("QUEST_SERVE_MAX_BATCH", "2")
    eng = _engine()
    try:
        assert eng.max_wait_s == 0.0 and eng.max_batch == 2
        assert eng._admission.max_queue == 1
    finally:
        eng.close(timeout_s=T_OUT)


def test_engine_mode_key_reads_the_environment_on_every_call(monkeypatch):
    """The mode key every serve submit computes (program_key) follows
    each knob flip, set or unset, loud on a malformed value, and equals
    the knob-by-knob reading."""
    def by_knob():
        return tuple((n, TE.knob_current(n)) for n in TE._KEYED)
    assert TE.engine_mode_key() == by_knob()
    monkeypatch.setenv("QUEST_FUSED_NBUF", "4")
    monkeypatch.setenv("QUEST_SCHEDULE", "0")
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "high")
    key = TE.engine_mode_key()
    assert key == by_knob()
    assert dict(key)["QUEST_FUSED_NBUF"] == 4
    assert dict(key)["QUEST_MATMUL_PRECISION"] == "high"
    monkeypatch.setenv("QUEST_FUSED_NBUF", "99")
    with pytest.raises(ValueError, match="QUEST_FUSED_NBUF"):
        TE.engine_mode_key()
    monkeypatch.delenv("QUEST_FUSED_NBUF")
    assert dict(TE.engine_mode_key())["QUEST_FUSED_NBUF"] == 3
    assert TE.engine_mode_key() == by_knob()


def test_tenant_quota_and_errors():
    q = admission.TenantQuota(admission.parse_tenant_quota(
        "alice=1,default=3"))
    q.admit("alice", 0)
    with pytest.raises(admission.TenantQuotaExceeded, match="alice"):
        q.admit("alice", 1)
    q.admit("bob", 2)
    assert issubclass(admission.ShedError, RejectedError)
    with pytest.raises(ValueError):
        admission.parse_tenant_quota("default=0")


# ---------------------------------------------------------------------------
# supervisor and breaker units
# ---------------------------------------------------------------------------


def test_supervisor_backoff_and_budget():
    sup = Supervisor(3, base_s=0.1, cap_s=0.5, jitter_frac=0.0)
    assert [sup.next_backoff() for _ in range(3)] == pytest.approx(
        [0.1, 0.2, 0.4])
    assert sup.next_backoff() is None
    sup.record_success()
    assert sup.next_backoff() == pytest.approx(0.1)
    assert 0.1 <= Supervisor(1, base_s=0.1, jitter_frac=0.5,
                             seed=1).next_backoff() <= 0.15


def test_breaker_state_machine():
    now = [0.0]
    seen = []
    br = Breaker(2, cooldown_s=1.0, on_transition=lambda o, n: seen.append(
        (o, n)), clock=lambda: now[0])
    br.record_failure()
    assert br.state == "closed" and br.allow_primary()
    br.record_failure()
    assert br.state == "open" and not br.allow_primary()
    now[0] = 1.5
    assert br.allow_primary() and br.state == "half_open"
    br.record_failure()
    assert br.state == "open"
    now[0] = 3.0
    assert br.allow_primary()
    br.record_success()
    assert br.state == "closed" and br.failures == 0
    assert seen == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


# ---------------------------------------------------------------------------
# supervised restart, the ladder, isolation
# ---------------------------------------------------------------------------


def test_worker_crash_restarts_and_queued_futures_complete_bit_identical():
    c = _circuit_a()
    states = _random_states(4, seed=11)
    want = _alone(c, states)
    plan = FaultPlan().inject("serve.worker_loop", times=1,
                              match=lambda ctx: ctx["phase"] == "popped")
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=600_000, max_batch=8, registry=reg) as eng:
            futs = [eng.submit(c, state=s) for s in states]
            eng.drain(timeout_s=T_OUT)
            got = [f.result(timeout=T_OUT) for f in futs]
    assert plan.fired("serve.worker_loop") == 1
    snap = reg.snapshot()["counters"]
    assert snap["serve_worker_restarts"] == 1
    assert snap["serve_faults_injected"] == 1
    assert snap["serve_requests_served"] == 4
    for g, w in zip(got, want):
        assert _close(g, w)


def test_worker_crash_at_idle_is_transparent():
    c = _circuit_a()
    s = _random_states(1, seed=13)[0]
    plan = FaultPlan().inject("serve.worker_loop", times=1,
                              match=lambda ctx: ctx["phase"] == "idle")
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=5, registry=reg) as eng:
            out = eng.submit(c, state=s).result(timeout=T_OUT)
    assert _close(out, _alone(c, [s])[0])
    assert reg.counter("serve_worker_restarts").value == 1


def test_restart_budget_exhausted_fails_loudly():
    c = _circuit_a()
    states = _random_states(2, seed=17)
    plan = FaultPlan().inject("serve.worker_loop",
                              error=RuntimeError("hardware gone"),
                              match=lambda ctx: ctx["phase"] == "popped")
    reg = metrics.Registry()
    with faults.active(plan):
        eng = _engine(max_wait_ms=600_000, max_batch=8, restart_max=2,
                      registry=reg)
        try:
            futs = [eng.submit(c, state=s) for s in states]
            eng.drain(timeout_s=T_OUT)
            for f in futs:
                with pytest.raises(RejectedError, match="FAILED"):
                    f.result(timeout=T_OUT)
            assert eng.state == "failed" and eng.health()["state"] == "failed"
            assert reg.counter("serve_worker_restarts").value == 2
            with pytest.raises(RejectedError, match="hardware gone"):
                eng.submit(c, state=states[0])
            with pytest.raises(RejectedError):
                warmup(eng, [c], buckets=[1])
        finally:
            eng.close(timeout_s=T_OUT)


def test_compile_failure_opens_breaker_then_half_open_probe_recovers():
    """Primary build failures fail their own requests while the breaker
    is closed and open it at the threshold; then requests complete on
    banded; after the cooldown the half-open probe restores fused
    service. Degraded dispatches are counted exactly."""
    c = _circuit_a(WIDE)
    states = _random_states(6, WIDE, seed=19)
    want = _alone(c, states)
    plan = FaultPlan().inject("serve.compile", error=RuntimeError("broken"),
                              times=2,
                              match=lambda ctx: ctx["rung"] == "fused")
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=0, max_batch=8, breaker_threshold=2,
                     breaker_cooldown_s=1.0, registry=reg) as eng:
            for s in states[:2]:
                with pytest.raises(RuntimeError, match="broken"):
                    eng.submit(c, state=s).result(timeout=T_OUT)
            assert reg.counter("serve_degraded_dispatches").value == 0
            outs = [eng.submit(c, state=states[2]).result(timeout=T_OUT)]
            snap = reg.snapshot()
            assert snap["counters"]["serve_breaker_opens"] == 1
            assert snap["counters"]["serve_degraded_dispatches"] == 1
            assert snap["counters"]["serve_faults_injected"] == 2
            assert snap["gauges"]["serve_breakers_open"] == 1.0
            assert eng.health()["open_breakers"] == 1
            assert eng.health()["degraded_dispatches"] == 1
            time.sleep(1.1)
            outs += [eng.submit(c, state=s).result(timeout=T_OUT)
                     for s in states[3:]]
            snap = reg.snapshot()
            assert snap["counters"]["serve_breaker_probes"] == 1
            assert snap["counters"]["serve_breaker_closes"] == 1
            assert snap["counters"]["serve_degraded_dispatches"] == 1
            assert snap["gauges"]["serve_breakers_open"] == 0.0
    for got, w in zip(outs, want[2:]):
        assert _close(got, w)


def test_first_primary_failure_fails_its_batch_and_never_runs_banded():
    """A closed breaker never steps down the ladder: the first fused
    build failure fails every request of its coalesced dispatch with the
    build's error (no split, no banded build), and the next dispatch is
    fused again."""
    c = _circuit_a(WIDE)
    states = _random_states(8, WIDE, seed=37)
    want = _alone(c, states)
    plan = FaultPlan().inject("serve.compile", error=RuntimeError("broken"),
                              times=1)
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=10_000, max_batch=4, breaker_threshold=3,
                     registry=reg) as eng:
            futs = [eng.submit(c, state=s) for s in states[:4]]
            for f in futs:
                with pytest.raises(RuntimeError, match="broken"):
                    f.result(timeout=T_OUT)
            outs = [eng.submit(c, state=s) for s in states[4:]]
            outs = [f.result(timeout=T_OUT) for f in outs]
    snap = reg.snapshot()["counters"]
    assert plan.fired("serve.compile") == 1      # no rung below was tried
    assert snap.get("serve_degraded_dispatches", 0) == 0
    assert snap.get("serve_batches_split", 0) == 0
    assert snap.get("serve_breaker_opens", 0) == 0
    assert snap["serve_launch_failures"] == 1
    for got, w in zip(outs, want[4:]):
        assert _close(got, w)


def test_card_build_failure_never_steps_down_the_ladder():
    """A failure of the kernel's build (nvcc) fails its dispatch, counts
    on no breaker, and never runs the requests on banded or host, even
    with a threshold of one."""
    from quest_tpu_torch.ops._build import BuildError
    c = _circuit_a(WIDE)
    states = _random_states(3, WIDE, seed=41)
    plan = FaultPlan().inject("serve.compile",
                              error=BuildError("nvcc exited 1"), times=2)
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=0, max_batch=8, breaker_threshold=1,
                     registry=reg) as eng:
            for s in states[:2]:
                with pytest.raises(BuildError, match="nvcc"):
                    eng.submit(c, state=s).result(timeout=T_OUT)
            assert eng.health()["open_breakers"] == 0
            got = eng.submit(c, state=states[2]).result(timeout=T_OUT)
    snap = reg.snapshot()["counters"]
    assert plan.fired("serve.compile") == 2
    assert snap.get("serve_degraded_dispatches", 0) == 0
    assert snap.get("serve_breaker_opens", 0) == 0
    assert _close(got, _alone(c, states[2:])[0])


@pytest.mark.parametrize("kind", ["apply", "traj"])
def test_ladder_reaches_the_host_floor_and_back(kind):
    """The fused failure that opens the breaker fails its own request;
    with the breaker open and banded failing to build too, requests
    complete on the native host engine; a probe whose fused build fails
    runs on banded; once the faults stop, the half-open probe restores
    fused. Trajectory draws are the same on every rung."""
    c = _circuit_a(WIDE) if kind == "apply" else _noisy_circuit(WIDE)
    plan = FaultPlan().inject(
        "serve.compile", error=RuntimeError("broken"), times=4,
        match=lambda ctx: ctx["rung"] in ("fused", "banded"))
    reg = metrics.Registry()
    states = _random_states(3, WIDE, seed=5)
    with faults.active(plan):
        with _engine(max_wait_ms=0, max_batch=8, breaker_threshold=1,
                     breaker_cooldown_s=1.0, registry=reg) as eng:
            def one(i):
                if kind == "apply":
                    return eng.submit(c, state=states[i]).result(
                        timeout=T_OUT)
                return eng.submit(c, shots=3, seed=i).result(timeout=T_OUT)
            # r0: closed: fused fails (fire 1), the request fails and the
            # breaker opens
            with pytest.raises(RuntimeError, match="broken"):
                one(0)
            assert reg.counter("serve_degraded_dispatches").value == 0
            # r1, r2: open: banded fails (fires 2, 3) -> host
            outs = [one(1), one(2)]
            assert plan.fired("serve.compile") == 3
            assert reg.counter("serve_degraded_dispatches").value == 2
            time.sleep(1.1)
            # r3: the probe: fused fails once more (fire 4) -> banded
            outs.append(one(0))
            assert reg.counter("serve_degraded_dispatches").value == 3
            time.sleep(1.1)
            outs.append(one(1))          # the probe finds fused healthy
            snap = reg.snapshot()["counters"]
            assert snap["serve_degraded_dispatches"] == 3
            assert snap["serve_breaker_closes"] == 1
            assert eng.health()["open_breakers"] == 0
    order = (1, 2, 0, 1)
    if kind == "apply":
        want = _alone(c, states)
        for got, i in zip(outs, order):
            assert _close(got, want[i])
    else:
        for i, (p, d) in zip(order, outs):
            wp, wd = T.run_batched(c, 3, device="cpu",
                                   generator=torch.Generator().manual_seed(i))
            assert torch.equal(d, wd)
            assert (p - wp).abs().max().item() <= 2e-5


def test_breaker_is_per_program_key():
    ca, cb = _circuit_a(), _circuit_b()
    sa, sb = _random_states(2, seed=23)
    plan = FaultPlan().inject(
        "serve.compile", error=RuntimeError("m"), times=5,
        match=lambda ctx: ctx["program"][1] is ca and ctx["rung"] == "fused")
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=0, max_batch=8, breaker_threshold=1,
                     registry=reg) as eng:
            with pytest.raises(RuntimeError, match="m"):
                eng.submit(ca, state=sa).result(timeout=T_OUT)
            eng.submit(ca, state=sa).result(timeout=T_OUT)   # open: banded
            eng.submit(cb, state=sb).result(timeout=T_OUT)
            assert eng.health()["open_breakers"] == 1
    snap = reg.snapshot()["counters"]
    assert snap["serve_breaker_opens"] == 1
    assert snap["serve_degraded_dispatches"] == 1
    assert snap["serve_requests_served"] == 2


def test_one_poisoned_rider_in_eight_is_isolated():
    c = _circuit_a()
    states = _random_states(8, seed=29)
    want = _alone(c, states)
    bad = {}
    plan = FaultPlan().inject(
        "serve.dispatch", error=ValueError("poisoned request"),
        match=lambda ctx: any(r.future is bad.get("f") for r in ctx["reqs"]))
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=600_000, max_batch=8, registry=reg) as eng:
            futs = [eng.submit(c, state=s) for s in states]
            bad["f"] = futs[5]
            eng.drain(timeout_s=T_OUT)
    with pytest.raises(ValueError, match="poisoned request"):
        futs[5].result(timeout=T_OUT)
    for i, f in enumerate(futs):
        if i != 5:
            assert _close(f.result(timeout=T_OUT), want[i])
    snap = reg.snapshot()["counters"]
    assert snap["serve_launch_failures"] <= math.ceil(math.log2(8)) + 1
    assert snap["serve_batches_split"] >= 1
    assert snap["serve_requests_served"] == 7
    assert snap["serve_requests_failed"] == 1


def test_uniform_launch_failure_fails_every_rider_with_the_error():
    c = _circuit_a()
    plan = FaultPlan().inject("serve.dispatch",
                              error=RuntimeError("device lost"))
    reg = metrics.Registry()
    with faults.active(plan):
        with _engine(max_wait_ms=600_000, max_batch=4, registry=reg) as eng:
            futs = [eng.submit(c, state=s)
                    for s in _random_states(4, seed=31)]
            eng.drain(timeout_s=T_OUT)
    for f in futs:
        with pytest.raises(RuntimeError, match="device lost"):
            f.result(timeout=T_OUT)
    assert reg.counter("serve_requests_failed").value == 4
    assert reg.counter("serve_requests_served").value == 0


def test_demux_error_fails_only_its_own_request():
    c = _circuit_a()
    states = _random_states(4, seed=37)
    want = _alone(c, states)

    def bad_observable(planes_b):
        raise ValueError("observable shape mismatch")

    reg = metrics.Registry()
    with _engine(max_wait_ms=600_000, max_batch=4, registry=reg) as eng:
        futs = [eng.submit(c, state=states[0], observable=bad_observable)]
        futs += [eng.submit(c, state=s) for s in states[1:]]
        eng.drain(timeout_s=T_OUT)
    with pytest.raises(ValueError, match="observable shape"):
        futs[0].result(timeout=T_OUT)
    for f, w in zip(futs[1:], want[1:]):
        assert _close(f.result(timeout=T_OUT), w)
    snap = reg.snapshot()["counters"]
    assert snap["serve_batches_dispatched"] == 1
    assert snap["serve_demux_failures"] == 1
    assert snap["serve_requests_served"] == 3


def test_traj_demux_error_is_isolated_too():
    c = _noisy_circuit()
    want = T.run_batched(c, 3, generator=torch.Generator().manual_seed(5),
                         device="cpu")

    def bad_observable(planes_b):
        raise ValueError("bad traj observable")

    with _engine(max_wait_ms=10_000, max_batch=8) as eng:
        fbad = eng.submit(c, shots=3, seed=3, observable=bad_observable)
        fgood = eng.submit(c, shots=3, seed=5)
        eng.drain(timeout_s=T_OUT)
    with pytest.raises(ValueError, match="bad traj observable"):
        fbad.result(timeout=T_OUT)
    p, d = fgood.result(timeout=T_OUT)
    assert torch.equal(p, want[0]) and torch.equal(d, want[1])


def test_watchdog_replaces_a_wedged_worker():
    """A launch outliving QUEST_DISPATCH_TIMEOUT_S fails its batch typed
    DispatchTimeout and a new worker serves the next request."""
    c = _circuit_a()
    release = threading.Event()

    def stuck(planes_b):
        release.wait(timeout=30)
        return _z0(planes_b)

    reg = metrics.Registry()
    s = _random_states(1, seed=41)[0]
    with _engine(max_wait_ms=0, dispatch_timeout_s=1.0, registry=reg) as eng:
        f = eng.submit(c, state=s, observable=stuck)
        with pytest.raises(DispatchTimeout, match="watchdog"):
            f.result(timeout=T_OUT)
        out = eng.submit(c, state=s).result(timeout=T_OUT)
        release.set()
    assert _close(out, _alone(c, [s])[0])
    snap = reg.snapshot()["counters"]
    assert snap["serve_dispatch_timeouts"] == 1
    assert snap["serve_worker_restarts"] == 1


def test_durable_request_resumes_after_preemption(tmp_path):
    """A durable_dir= request runs through run_durable (f64 planes: the
    banded engine's plan items are its steps): a preemption mid-job
    retries in place from the checkpoint chain and the result equals the
    banded program's."""
    c = random_circuit(WIDE, 8, seed=3)
    s = _random_states(1, WIDE, seed=43)[0].astype(np.float64)
    reg = metrics.Registry()
    plan = FaultPlan().inject("durable.preempt", after_n=4, times=1)
    with faults.active(plan):
        with _engine(max_wait_ms=0, registry=reg) as eng:
            out = eng.submit(c, state=s, durable_dir=str(tmp_path / "job"),
                             durable_every=2).result(timeout=T_OUT)
    want = c.compiled_banded(WIDE, device="cpu")(torch.from_numpy(s.copy()))
    assert torch.equal(out, want)
    snap = reg.snapshot()["counters"]
    assert plan.fired("durable.preempt") == 1
    assert snap["serve_durable_jobs"] == 1
    assert snap["serve_durable_inplace_resumes"] == 1
    assert snap["durable_resumes"] == 1


def test_submits_racing_a_restart_all_complete():
    c = _circuit_a()
    states = _random_states(12, seed=47)
    want = _alone(c, states)
    plan = FaultPlan().inject("serve.worker_loop", times=2,
                              match=lambda ctx: ctx["phase"] == "popped")
    results: dict = {}
    with faults.active(plan):
        with _engine(max_wait_ms=1, max_batch=4) as eng:
            def client(i):
                results[i] = eng.submit(c, state=states[i]).result(
                    timeout=T_OUT)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(states))]
            for t in threads:
                t.start()
                time.sleep(0.002)
            for t in threads:
                t.join(timeout=T_OUT)
    for i, w in enumerate(want):
        assert _close(results[i], w)


def test_chaos_every_future_resolves_and_engine_never_hangs():
    """A seeded plan over every serving site and a mixed stream: every
    future resolves (a result or a typed error) and drain() returns."""
    ca, cb, cn = _circuit_a(), _circuit_b(), _noisy_circuit()
    states = _random_states(60, seed=43)
    plan = FaultPlan()
    plan.inject("serve.worker_loop", every_n=20, times=2)
    plan.inject("serve.compile", error=RuntimeError("broken"), every_n=5,
                times=6)
    plan.inject("serve.dispatch", every_n=7, times=4)
    plan.inject("serve.device_put", every_n=11, times=2)
    plan.inject("serve.demux", p=0.03, seed=5)
    reg = metrics.Registry()
    with faults.active(plan):
        eng = _engine(max_wait_ms=2, max_batch=8, restart_max=10,
                      breaker_threshold=3, breaker_cooldown_s=0.05,
                      registry=reg)
        try:
            futs = []
            for i in range(60):
                try:
                    if i % 5 == 4:
                        futs.append(eng.submit(cn, shots=1 + i % 4, seed=i))
                    else:
                        futs.append(eng.submit(ca if i % 2 == 0 else cb,
                                               state=states[i]))
                except RejectedError:
                    pass
            eng.drain(timeout_s=T_OUT)
            assert all(f.done() for f in futs)
            assert eng.state in ("running", "failed")
        finally:
            eng.close(timeout_s=T_OUT)
    assert reg.snapshot()["counters"].get("serve_faults_injected", 0) > 0


def test_default_ladder_and_lazy_exports():
    assert DEFAULT_LADDER == ("fused", "banded", "host")
    import quest_tpu_torch.serve as serve
    for name in serve._LAZY:
        assert getattr(serve, name) is not None


def test_serve_workload_is_the_bench_workload():
    """entry.serve_circuit / serve_states are the repo bench's serving
    workload (bench.py _build_circuit, _measure_serve), draw for draw."""
    import bench
    from quest_tpu_torch import entry as E
    n = 9
    ref, got = bench._build_circuit(n), E.serve_circuit(n)
    assert [(o.kind, o.targets) for o in got.ops] == \
        [(o.kind, tuple(o.targets)) for o in ref.ops]
    for a, b in zip(got.ops, ref.ops):
        np.testing.assert_array_equal(np.asarray(a.operand),
                                      np.asarray(b.operand))
    rng = np.random.default_rng(E.SERVE_STATE_SEED)
    want = rng.standard_normal((70, 2, 1 << n)).astype(np.float32)
    want /= np.sqrt((want ** 2).sum(axis=(1, 2), keepdims=True))
    np.testing.assert_array_equal(E.serve_states(n, 70), want)
