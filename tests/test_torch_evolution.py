"""The port's Trotter evolution (quest_tpu_torch.evolution) against the
reference's (quest_tpu.evolution): the reference's tests/test_evolution.py
cases that are neither sharded nor durable, each held against the
reference's own function on the same seeded inputs — the product-formula
oracle at order 1 and 2 (f32 and f64), convergence to expm, the pooled
emission against the legacy per-term path, imaginary time, energy
tracking, the TFIM-30 plan record under TPU_GEOMETRY (and the port's
own under HOPPER_GEOMETRY), compose_diag_runs pooling, density
evolution, inverse unwinding, the sweep tuple rules, memoised circuits
sharing one program, gradients through the torch core, and noisy
trajectories given the reference's draws.
"""

import contextlib

import numpy as np
import pytest
import scipy.linalg as sla
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

import jax
import jax.numpy as jnp

import bench
import quest_tpu as qt
from quest_tpu import evolution as JEV
from quest_tpu import trajectories as JT
from quest_tpu.ops import expec as JE
from quest_tpu.ops import fusion as JF
from quest_tpu.circuit import GateOp as JGateOp
from quest_tpu.state import to_dense

from quest_tpu_torch import evolution as EV
from quest_tpu_torch import state as TS
from quest_tpu_torch import trajectories as T
from quest_tpu_torch import variational as V
from quest_tpu_torch.circuit import GateOp
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.ops import fusion as F

pytestmark = pytest.mark.dtype_agnostic

N = 5
ENGINE_EPS = {np.float32: 2e-5, np.float64: 1e-12}
_PAULI = (np.eye(2), np.array([[0, 1], [1, 0]]),
          np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]]))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def dense_term(row):
    M = np.array([[1.0]])
    for code in row:
        M = np.kron(_PAULI[code], M)
    return M


def dense_h(codes, coeffs):
    dim = 1 << len(codes[0])
    H = np.zeros((dim, dim), complex)
    for row, c in zip(codes, coeffs):
        H += c * dense_term(row)
    return H


def tfim(n, J=-1.0, h=-0.7):
    """Open-chain TFIM: n-1 ZZ couplings + n transverse X fields."""
    rows, cs = [], []
    for q in range(n - 1):
        r = [0] * n
        r[q] = r[q + 1] = 3
        rows.append(r)
        cs.append(J)
    for q in range(n):
        r = [0] * n
        r[q] = 1
        rows.append(r)
        cs.append(h)
    return np.asarray(rows), np.asarray(cs)


def random_sum(rng, n, terms=6):
    """X/Y/Z content everywhere (a diagonal block and several frames),
    one all-identity and one pure-Z term."""
    rows = rng.integers(0, 4, size=(terms, n))
    rows[0] = 0
    rows[1, :] = np.where(rows[1] == 0, 0, 3)
    return rows, rng.standard_normal(terms)


def random_state(rng, n, rdt):
    """(port register, reference register, complex vector)."""
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    planes = np.stack([v.real, v.imag]).astype(rdt)
    q = TS.Qureg(amps=torch.from_numpy(planes.copy()), num_qubits=n)
    jq = qt.create_qureg(n, dtype=(np.complex64 if rdt == np.float32
                                   else np.complex128))
    jq = qt.init_state_from_amps(jq, planes[0], planes[1])
    return q, jq, v


def dense(q):
    a = q.amps.reshape(2, -1).double().numpy()
    return a[0] + 1j * a[1]


def product_formula_oracle(plan, codes, coeffs, dt, order, steps):
    """The exact unitary of the emitted product formula."""
    seq = plan.group_seq()
    dim = 1 << len(codes[0])

    def group_u(g, scale):
        kind, payload = g
        idx = payload if kind == "diag" else payload.terms
        Hg = sum(float(coeffs[i]) * dense_term(codes[i]) for i in idx)
        return sla.expm(-1j * float(dt) * scale * Hg)

    step = np.eye(dim, dtype=complex)
    if order == 1 or len(seq) <= 1:
        for g in seq:
            step = group_u(g, 1.0) @ step
    else:
        for g in seq[:-1]:
            step = group_u(g, 0.5) @ step
        step = group_u(seq[-1], 1.0) @ step
        for g in reversed(seq[:-1]):
            step = group_u(g, 0.5) @ step
    theta = float(dt) * sum(float(coeffs[i]) for i in plan.identity)
    return np.linalg.matrix_power(step, steps) * np.exp(-1j * theta * steps)


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("order", [1, 2])
def test_trotter_matches_product_formula_oracle(order, rdt):
    rng = np.random.default_rng(100 + order)
    codes, cf = random_sum(rng, N)
    q0, jq0, v0 = random_state(rng, N, rdt)
    res = EV.run_evolution((codes, cf), 0.07, 4, state=q0, order=order)
    assert res.stats["engine"] == "banded"
    plan = EV._plan_trotter(E.parse_pauli_sum(codes, N))
    U = product_formula_oracle(plan, codes, cf, 0.07, order, 4)
    tol = ENGINE_EPS[rdt]
    np.testing.assert_allclose(dense(res.state), U @ v0, atol=30 * tol,
                               rtol=0)
    ref = JEV.run_evolution((codes, cf), 0.07, 4, state=jq0, order=order)
    np.testing.assert_allclose(dense(res.state), to_dense(ref.state),
                               atol=30 * tol, rtol=0)
    np.testing.assert_allclose(res.energies, ref.energies, atol=30 * tol)
    # the caller's register is left as it was
    np.testing.assert_array_equal(dense(q0), np.asarray(
        np.stack([v0.real, v0.imag]).astype(rdt)[0]
        + 1j * np.stack([v0.real, v0.imag]).astype(rdt)[1]))


@pytest.mark.parametrize("order", [1, 2])
def test_trotter_converges_to_expm(order):
    rng = np.random.default_rng(7 + order)
    codes, cf = random_sum(rng, N)
    H = dense_h(codes, cf)
    t = 0.4
    _, _, v0 = random_state(rng, N, np.float64)
    want = sla.expm(-1j * H * t) @ v0

    def err(steps):
        q0 = TS.Qureg(amps=torch.from_numpy(np.stack([v0.real, v0.imag])),
                      num_qubits=N)
        res = EV.run_evolution((codes, cf), t / steps, steps, state=q0,
                               order=order)
        return np.linalg.norm(dense(res.state) - want)

    e1, e2 = err(8), err(16)
    assert e1 < (0.3 if order == 1 else 0.05)
    assert e2 < e1 / (1.5 if order == 1 else 2.5), (e1, e2)


def test_fused_matches_legacy_per_term_emission(monkeypatch):
    rng = np.random.default_rng(3)
    codes, cf = random_sum(rng, N)
    q0, jq0, _ = random_state(rng, N, np.float32)
    res_f = EV.run_evolution((codes, cf), 0.05, 6, state=q0, order=2)
    assert res_f.stats["engine"] == "banded"
    assert res_f.stats["dispatches"] == 1
    monkeypatch.setenv("QUEST_TROTTER_FUSION", "0")
    res_l = EV.run_evolution((codes, cf), 0.05, 6, state=q0, order=2)
    assert res_l.stats["engine"] == "legacy-per-term"
    ref_l = JEV.run_evolution((codes, cf), 0.05, 6, state=jq0, order=2)
    np.testing.assert_allclose(dense(res_l.state), to_dense(ref_l.state),
                               atol=2e-5, rtol=0)
    plan = EV._plan_trotter(E.parse_pauli_sum(codes, N))
    theta = 0.05 * 6 * sum(float(cf[i]) for i in plan.identity)
    np.testing.assert_allclose(dense(res_f.state),
                               np.exp(-1j * theta) * dense(res_l.state),
                               atol=2e-5, rtol=0)
    spec = EV.as_pauli_sum((codes, cf))
    st = EV.trotter_plan_stats(spec, 0.05, order=2)
    assert st["fusion"] is False
    assert st["hbm_sweeps_per_step"] == st["baseline_hbm_sweeps_per_step"]
    assert EV.trotter_circuit(spec, 0.05, steps=6).trotter["pooled"] is False
    with pytest.raises(ValueError, match="legacy per-term"):
        EV.run_evolution(spec, 0.05, 2, state=q0, engine="banded")


def test_imag_time_converges_to_ground_state():
    codes, cf = tfim(N)
    w, v = np.linalg.eigh(dense_h(codes, cf))
    q0 = TS.init_plus_state(TS.create_qureg(N, dtype=np.complex128,
                                            device="cpu"))
    res = EV.run_evolution((codes, cf), 0.1, 300, state=q0, imag_time=True,
                           energy_every=100)
    assert res.stats["engine"] == "traced-imag"
    track = res.energies[:, 0]
    assert all(np.diff(track) < 1e-9)
    assert abs(track[-1] - w[0]) < 1e-3, (track[-1], w[0])
    assert abs(np.vdot(v[:, 0], dense(res.state))) > 1 - 1e-4
    jq = qt.init_plus_state(qt.create_qureg(N, dtype=np.complex128))
    ref = JEV.run_evolution((codes, cf), 0.1, 10, state=jq, imag_time=True)
    got = EV.run_evolution((codes, cf), 0.1, 10, state=q0, imag_time=True)
    np.testing.assert_allclose(dense(got.state), to_dense(ref.state),
                               atol=1e-12, rtol=0)


def test_imag_time_rejects_engine_pin_and_density():
    codes, cf = tfim(N)
    q0 = TS.init_plus_state(TS.create_qureg(N, device="cpu"))
    with pytest.raises(ValueError, match="no engine"):
        EV.run_evolution((codes, cf), 0.1, 2, state=q0, imag_time=True,
                         engine="fused")
    rho = TS.create_density_qureg(N, device="cpu")
    with pytest.raises(ValueError, match="statevector"):
        EV.run_evolution((codes, cf), 0.1, 2, state=rho, imag_time=True)


def test_unported_modes_raise_naming_the_roadmap_item(tmp_path):
    """Every mode is ported since A10b / A11: mesh= and durable_dir= run
    (tests/test_torch_sharded_consumers.py, the durable quench below)
    and keep the reference's refusals."""
    from quest_tpu_torch.parallel import make_amp_mesh
    codes, cf = tfim(N)
    q0 = TS.init_plus_state(TS.create_qureg(N, device="cpu"))
    res = EV.run_evolution((codes, cf), 0.1, 2, state=q0,
                           mesh=make_amp_mesh(2, devices=["cpu"] * 2))
    assert res.stats["engine"] == "sharded-banded"
    res = EV.run_evolution((codes, cf), 0.1, 2, state=q0,
                           durable_dir=str(tmp_path / "d"))
    assert res.stats["engine"] == "durable"
    with pytest.raises(ValueError, match="energy_every"):
        EV.run_evolution((codes, cf), 0.1, 2, state=q0, energy_every=1,
                         durable_dir=str(tmp_path / "e"))
    with pytest.raises(ValueError, match="imaginary"):
        EV.run_evolution((codes, cf), 0.1, 2, state=q0, imag_time=True,
                         durable_dir=str(tmp_path / "f"))
    # TrotterCircuit.plan_stats answers since the plan IR is ported (A9)
    rec = EV.trotter_circuit((codes, cf), 0.1).plan_stats()
    assert rec["trotter"] == EV.trotter_plan_stats((codes, cf), 0.1)


@pytest.mark.parametrize("engine", ["banded", "fused"])
def test_durable_quench_resume_bit_identity(tmp_path, engine, monkeypatch):
    """A preempted quench resumes bit-identical to the uninterrupted
    durable run (ref test_evolution.py:505): the cursor carries the
    validated Trotter descriptor; a resume under another one fails
    typed; the energies are the initial and final rows."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.resilience import (DurableError, FaultPlan,
                                            faults, run_durable)
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    # the fused plan packs many Trotter steps into one segment: a deeper
    # quench gives it launches to cut between
    n, depth = (8, 8) if engine == "banded" else (10, 32)
    spec = tfim(n)
    q0 = TS.init_debug_state(TS.create_qureg(n, device="cpu"))
    from quest_tpu_torch.resilience import durable as D
    steps, _ = D._build_steps(EV.trotter_circuit(spec, 0.05, order=2,
                                                 steps=depth),
                              n, False, engine, None, torch.device("cpu"),
                              True)
    every = 2 if len(steps) > 6 else 1
    ref = EV.run_evolution(spec, 0.05, depth, state=q0, engine=engine,
                           durable_dir=str(tmp_path / "ref"),
                           durable_every=every)
    assert ref.energy_steps.tolist() == [0, depth]
    assert ref.energies.shape == (2, 1)
    d = str(tmp_path / "pre")
    plan = FaultPlan().inject("durable.preempt",
                              after_n=min(4, len(steps) - 1), times=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            EV.run_evolution(spec, 0.05, depth, state=q0, engine=engine,
                             durable_dir=d, durable_every=every)
    assert plan.fired() == 1
    dirs = ckpt.step_dirs(d)
    assert dirs
    cursor = ckpt.read_extra(dirs[-1][1])
    assert cursor["workload"] == "trotter"
    assert cursor["trotter_steps"] == depth and cursor["trotter_order"] == 2
    circ21 = EV.trotter_circuit(spec, 0.05, order=2, steps=21)
    with pytest.raises(DurableError):
        run_durable(circ21, q0, d, every=every, engine=engine,
                    cursor_extra={"workload": "trotter",
                                  "trotter_steps": 21, "trotter_order": 2,
                                  "trotter_dt": repr(0.05),
                                  "trotter_terms": len(spec[0])})
    out = EV.run_evolution(spec, 0.05, depth, state=q0, engine=engine,
                           durable_dir=d, durable_every=every)
    np.testing.assert_array_equal(out.state.amps.numpy(),
                                  ref.state.amps.numpy())
    assert ckpt.step_dirs(d) == []
    # and the ordinary quench within the engines' tolerance
    plain = EV.run_evolution(spec, 0.05, depth, state=q0, engine="banded")
    a, b = out.state.amps.numpy(), plain.state.amps.numpy()
    assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max()


def test_durable_trajectory_quench_resumes(tmp_path):
    from quest_tpu_torch.resilience import FaultPlan, faults
    spec = tfim(4)
    noise = ("depolarising", 0.02)
    kw = dict(noise=noise, chunk=2, device="cpu", durable_every=1)
    ref_p, ref_d = EV.run_evolution_trajectories(
        spec, 0.05, 2, 6, generator=torch.Generator().manual_seed(3), **kw)
    d = str(tmp_path / "t")
    plan = FaultPlan().inject("durable.preempt", after_n=1, times=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            EV.run_evolution_trajectories(
                spec, 0.05, 2, 6, generator=torch.Generator().manual_seed(3),
                durable_dir=d, **kw)
    p, dr = EV.run_evolution_trajectories(
        spec, 0.05, 2, 6, generator=torch.Generator().manual_seed(3),
        durable_dir=d, **kw)
    np.testing.assert_array_equal(p.numpy(), ref_p.numpy())
    np.testing.assert_array_equal(dr.numpy(), ref_d.numpy())


def test_energy_tracking_matches_the_reference():
    rng = np.random.default_rng(5)
    codes, cf = tfim(N)
    obs = random_sum(rng, N)
    q0, jq0, _ = random_state(rng, N, np.float32)
    res = EV.run_evolution((codes, cf), 0.05, 6, state=q0,
                           observables=[(codes, cf), obs], energy_every=2)
    assert res.energy_steps.tolist() == [0, 2, 4, 6]
    assert res.energies.shape == (4, 2)
    ref = JEV.run_evolution((codes, cf), 0.05, 6, state=jq0,
                            observables=[(codes, cf), obs], energy_every=2)
    np.testing.assert_allclose(res.energies, ref.energies, atol=1e-4)


@pytest.mark.parametrize("order", [1, 2])
def test_tfim30_plan_record(order):
    """Under TPU_GEOMETRY the record is the reference's (the TFIM-30 golden:
    <= 3 sweeps a step, >= 15 per-term passes, one frame, 30 diagonal
    terms); under HOPPER_GEOMETRY the port's planner gives its own count,
    recorded here (4 at order 2), not gated against the TPU's."""
    codes, coeffs = bench._build_tfim_sum(30)
    spec = EV.as_pauli_sum((codes, coeffs))
    want = JEV.trotter_plan_stats(JE.PauliSum.of(codes, coeffs, 30), 0.05,
                                  order=order, steps=50)
    got = EV.trotter_plan_stats(spec, 0.05, order=order, steps=50,
                                budgets=BP.TPU_GEOMETRY)
    assert got == want
    if order == 2:
        assert got["hbm_sweeps_per_step"] <= 3
        assert got["baseline_hbm_sweeps_per_step"] >= 15
        assert got["frames"] == 1 and got["diag_terms"] == 30
        hopper = EV.trotter_plan_stats(spec, 0.05, order=2, steps=50)
        assert hopper["hbm_sweeps_per_step"] == 4.0
        assert {k: v for k, v in hopper.items()
                if k != "hbm_sweeps_per_step"} == {
            k: v for k, v in want.items() if k != "hbm_sweeps_per_step"}


def test_plan_records_match_the_reference_on_random_sums():
    for seed in range(3):
        codes, cf = random_sum(np.random.default_rng(seed), 12, terms=9)
        want = JEV.trotter_plan_stats(JE.PauliSum.of(codes, cf, 12), 0.1)
        got = EV.trotter_plan_stats(EV.as_pauli_sum((codes, cf)), 0.1,
                                    budgets=BP.TPU_GEOMETRY)
        assert got == want


def test_compose_diag_runs_pools_like_the_reference():
    ops = [GateOp("parity", (q, q + 1), (), (), 0.1 * (q + 1))
           for q in range(6)]
    jops = [JGateOp("parity", (q, q + 1), (), (), 0.1 * (q + 1))
            for q in range(6)]
    out, jout = F.compose_diag_runs(ops), JF.compose_diag_runs(jops)
    assert len(out) == len(jout) < len(ops)
    for a, b in zip(out, jout):
        assert a.targets == b.targets and a.kind == b.kind
        np.testing.assert_allclose(np.asarray(a.operand),
                                   np.asarray(b.operand), atol=1e-15)
    traced = GateOp("parity", (0, 1), (), (), object())
    assert F.compose_diag_runs([traced] + ops)[0] is traced
    ctrl = GateOp("allones", (0,), (2,), (1,), np.exp(0.7j))
    kept = [o for o in F.compose_diag_runs([ctrl] + ops)
            if getattr(o, "kind", "") == "allones"]
    assert len(kept) == 1 and kept[0] is ctrl


def test_density_evolution_matches_the_reference():
    rng = np.random.default_rng(9)
    n = 3
    codes, cf = random_sum(rng, n, terms=5)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    rho = np.outer(v, v.conj())
    flat = rho.T.reshape(-1)            # rho[r, c] at r + c 2^N
    q = TS.Qureg(amps=torch.from_numpy(np.stack([flat.real, flat.imag])),
                 num_qubits=n, is_density=True)
    c = EV.trotter_circuit((codes, cf), 0.09, order=2, steps=2)
    out = c.apply_banded(q).amps.numpy()
    plan = EV._plan_trotter(E.parse_pauli_sum(codes, n))
    U = product_formula_oracle(plan, codes, cf, 0.09, 2, 2)
    want = (U @ rho @ U.conj().T).T.reshape(-1)
    np.testing.assert_allclose(out[0] + 1j * out[1], want, atol=1e-10,
                               rtol=0)
    jq = qt.init_pure_state(
        qt.create_density_qureg(n, dtype=np.complex128),
        qt.init_state_from_amps(qt.create_qureg(n, dtype=np.complex128),
                                v.real, v.imag))
    jout = JEV.trotter_circuit((codes, cf), 0.09, order=2,
                               steps=2).apply_banded(jq)
    np.testing.assert_allclose(out.reshape(-1), np.asarray(
        jout.amps).reshape(-1), atol=1e-10, rtol=0)


def test_inverse_unwinds_evolution():
    rng = np.random.default_rng(10)
    codes, cf = random_sum(rng, N)
    c = EV.trotter_circuit((codes, cf), 0.11, order=2, steps=2)
    q0, _, v0 = random_state(rng, N, np.float64)
    out = c.inverse().apply_banded(c.apply_banded(TS.clone(q0)))
    np.testing.assert_allclose(dense(out), v0, atol=1e-10, rtol=0)


def test_fused_engine_matches_the_reference_banded_at_ten_qubits():
    """engine='fused' (the segment program; its plain version on the CPU)
    at the kernel's 10 qubits against the reference's banded quench."""
    codes, cf = bench._build_tfim_sum(10)
    rng = np.random.default_rng(4)
    q0, jq0, _ = random_state(rng, 10, np.float32)
    got = EV.run_evolution((codes, cf), 0.05, 3, state=q0, engine="fused",
                           energy_every=1)
    assert got.stats["engine"] == "fused" and got.stats["launches"] > 0
    ref = JEV.run_evolution((codes, cf), 0.05, 3, state=jq0,
                            engine="banded", energy_every=1)
    np.testing.assert_allclose(dense(got.state), to_dense(ref.state),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.energies, ref.energies, atol=2e-4)


def test_sweep_tuple_rules(monkeypatch):
    codes, cf = tfim(3)
    ansatz = EV.trotter_ansatz(codes, order=2, steps=1)
    energy = V.expectation(ansatz, 3, codes, cf, device="cpu")
    cfs = torch.from_numpy(np.stack([cf, 0.9 * cf]).astype(np.float32))
    dts = torch.tensor([0.1, 0.11])
    vals = V.sweep(energy, (cfs, dts))
    loop = torch.stack([energy((cfs[i], dts[i])) for i in range(2)])
    torch.testing.assert_close(vals, loop, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="ambiguous tuple"):
        V.sweep(energy, (torch.zeros(2), torch.zeros(2)))
    # chunk='auto' prices against the device memory: none on the CPU
    # unless QUEST_HBM_BYTES gives it
    monkeypatch.delenv("QUEST_HBM_BYTES", raising=False)
    with pytest.raises(ValueError, match="QUEST_HBM_BYTES"):
        V.sweep(energy, (cfs, dts), chunk="auto")
    monkeypatch.setenv("QUEST_HBM_BYTES", str(1 << 30))
    torch.testing.assert_close(V.sweep(energy, (cfs, dts), chunk="auto"),
                               loop, rtol=0, atol=1e-6)

    def plain(params):
        return params.sum()
    out = V.sweep(plain, [np.array([1.0, 2.0]), np.array([3.0, 4.0])])
    assert out.tolist() == [3.0, 7.0]


def test_rebuilt_trotter_circuits_share_one_program():
    codes, cf = tfim(N)
    c1 = EV.trotter_circuit((codes, cf), 0.05, order=2, steps=3)
    c2 = EV.trotter_circuit(E.PauliSum.of(codes, cf, N), 0.05, order=2,
                            steps=3)
    assert c1 is c2
    assert (c1.compiled_banded(N, device="cpu")
            is c2.compiled_banded(N, device="cpu"))
    a1 = EV.trotter_ansatz(codes, steps=2)
    a2 = EV.trotter_ansatz(E.PauliSum.of(codes, cf, N), steps=2)
    assert a1.program_key == a2.program_key
    e1 = V.expectation(a1, N, codes, cf, device="cpu")
    e2 = V.expectation(a2, N, codes, cf, device="cpu")
    assert e1.sweep_key == e2.sweep_key


def test_grad_matches_finite_differences_and_the_reference():
    codes, cf = tfim(4)
    ansatz = EV.trotter_ansatz(codes, order=2, steps=2)
    energy = V.expectation(ansatz, 4, codes, cf, dtype=np.float64,
                           device="cpu")
    c = torch.from_numpy(cf.copy()).requires_grad_(True)
    dt = torch.tensor(0.13, dtype=torch.float64, requires_grad=True)
    g_cf, g_dt = torch.autograd.grad(energy((c, dt)), (c, dt))
    eps = 1e-6

    def at(cv, d):
        return float(energy((torch.from_numpy(cv),
                             torch.tensor(d, dtype=torch.float64))))
    fd_dt = (at(cf, 0.13 + eps) - at(cf, 0.13 - eps)) / (2 * eps)
    assert abs(float(g_dt) - fd_dt) < 1e-6
    jen = JEV.trotter_ansatz(codes, order=2, steps=2)
    import quest_tpu.variational as JV
    jenergy = JV.expectation(jen, 4, codes, cf, dtype=np.float64)
    jg_cf, jg_dt = jax.grad(jenergy)((jnp.asarray(cf), jnp.float64(0.13)))
    np.testing.assert_allclose(g_cf.numpy(), np.asarray(jg_cf), atol=1e-12)
    assert abs(float(g_dt) - float(jg_dt)) < 1e-12
    imag = V.expectation(EV.trotter_ansatz(codes, order=1, steps=2,
                                           imag_time=True),
                         4, codes, cf, dtype=np.float64, device="cpu")
    dt2 = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    g_i = torch.autograd.grad(imag((torch.from_numpy(cf), dt2)), dt2)[0]
    assert torch.isfinite(g_i) and float(g_i) < 0


def test_noisy_trajectories_given_the_reference_draws():
    """trotter_circuit(noise=) through the port's trajectory program on
    the uniforms that reproduce the reference's draws (run_batched,
    engine='banded'): equal draws and planes; run_evolution_trajectories
    keeps every shot normalised and reduces a PauliSum per shot."""
    from tests.test_torch_trajectories import _uniforms_for
    codes, cf = tfim(3)
    noise = ("dephasing", 0.05)
    jc = JEV.trotter_circuit((codes, cf), 0.05, steps=3, noise=noise)
    jplanes, jdraws = JT.run_batched(jc, jax.random.key(3), 8,
                                     engine="banded")
    jplanes, jdraws = np.asarray(jplanes), np.asarray(jdraws)
    tc = EV.trotter_circuit((codes, cf), 0.05, steps=3, noise=noise)
    prog = T._compiled_traj(tc, 3, "cpu", "banded")
    planes, draws = prog(torch.from_numpy(
        _uniforms_for(jdraws, prog.channel_info)))
    np.testing.assert_array_equal(draws.numpy(), jdraws)
    np.testing.assert_allclose(planes.numpy(), jplanes, atol=2e-5, rtol=0)
    planes, draws = EV.run_evolution_trajectories(
        (codes, cf), 0.05, 3, 4, noise=noise, device="cpu",
        generator=torch.Generator().manual_seed(3))
    assert tuple(planes.shape) == (4, 2, 8) and tuple(draws.shape) == (4, 9)
    norms = planes.double().pow(2).sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    vals, _ = EV.run_evolution_trajectories(
        (codes, cf), 0.05, 3, 4, noise=noise, device="cpu",
        generator=torch.Generator().manual_seed(3),
        observable=E.PauliSum.of(codes, cf, 3))
    plan = E.plan_expec(E.parse_pauli_sum(codes, 3), 3, density=False)
    for b in range(4):
        want = float(E.expec_traced(planes[b], torch.from_numpy(cf), plan))
        assert abs(float(vals[b]) - want) < 1e-5
