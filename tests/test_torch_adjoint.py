"""The port's gradient engines (quest_tpu_torch.adjoint) against the
reference's (quest_tpu.adjoint): the reference's tests/test_adjoint.py
cases that are neither sharded nor of the plan IR — adjoint against
taped (seeds 0-2, 2e-6 at f32), against finite differences at f64
(1e-9), density against statevector, a non-zero basis state, the
as_rotation round trip of every parametric emitter, rejections naming
the op, grad_record, the identical callable for equal specs, Trotter
gradients, imaginary time rejected, the knob resolving the engine and
the depth-independent capacity model — and both engines' values and
gradients against quest_tpu.adjoint.value_and_grad at 4 qubits on the
same circuits; the taped engine on one-process meshes of 2 and 4 CPU
shards against the reference's taped engine on a mesh of as many
devices (f32 within 2e-5, f64 within 1e-12) and against the port's
adjoint walk on the same mesh. The CPU has no device-memory figure: tests that price
the engines set QUEST_HBM_BYTES.
"""

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

from quest_tpu import adjoint as JAD
from quest_tpu import circuit as JC
from quest_tpu.ops import expec as JE

from quest_tpu_torch import adjoint as AD
from quest_tpu_torch import entry as EN
from quest_tpu_torch import evolution as EV
from quest_tpu_torch import variational as V
from quest_tpu_torch.circuit import Circuit, GateOp, as_rotation
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.ops import matrices as M

pytestmark = pytest.mark.dtype_agnostic

HBM = str(16 << 30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def tfim(mod, n, h=0.6):
    codes, cf = [], []
    for i in range(n - 1):
        row = [0] * n
        row[i] = row[i + 1] = 3
        codes.append(row)
        cf.append(-1.0)
    for i in range(n):
        row = [0] * n
        row[i] = 1
        codes.append(row)
        cf.append(-h)
    return mod.PauliSum.of(np.array(codes), np.array(cf), n)


def rand_ansatz(Circ, n, layers=2, seed=0):
    """Every parametric family the walk differentiates, mixed with
    constant entanglers (the reference test's ansatz)."""
    rng = np.random.default_rng(seed)
    a = lambda: float(rng.uniform(-np.pi, np.pi))  # noqa: E731
    c = Circ(n)
    for _ in range(layers):
        for q in range(n):
            c.ry(q, a())
        for q in range(0, n - 1, 2):
            c.cnot(q, q + 1)
        c.rx(0, a()).rz(1, a()).phase(2 % n, a())
        c.multi_rotate_z((0, n - 1), a())
        c.cphase(a(), 0, 1)
        c.multi_rotate_pauli((0, 1), (1, 2), a())
        c.h(n - 1)
    return c


def vg(c, engine, **kw):
    return AD.value_and_grad(c, tfim(E, c.num_qubits), engine=engine,
                             device="cpu", **kw)


def fd(fn, theta, eps=1e-5):
    th = np.asarray(theta, np.float64)
    g = np.zeros_like(th)
    for i in range(th.size):
        up, dn = th.copy(), th.copy()
        up[i] += eps
        dn[i] -= eps
        g[i] = (float(fn.value(up)) - float(fn.value(dn))) / (2 * eps)
    return g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjoint_matches_taped_and_the_reference(seed):
    n = 4
    c = rand_ansatz(Circuit, n, seed=seed)
    adj, tap = vg(c, "adjoint"), vg(c, "taped")
    th = torch.tensor(adj.initial_params, dtype=torch.float32)
    va, ga = adj(th)
    vt, gt = tap(th)
    assert adj.num_params == tap.num_params > 0
    assert abs(float(va) - float(vt)) <= 1e-6
    np.testing.assert_allclose(ga.numpy(), gt.numpy(), atol=2e-6, rtol=0)
    ref = JAD.value_and_grad(rand_ansatz(JC.Circuit, n, seed=seed),
                             tfim(JE, n), engine="adjoint")
    np.testing.assert_allclose(adj.initial_params, ref.initial_params,
                               atol=0)
    vr, gr = ref(jnp.asarray(ref.initial_params, jnp.float32))
    assert abs(float(va) - float(vr)) <= 2e-6
    np.testing.assert_allclose(ga.numpy(), np.asarray(gr), atol=2e-6,
                               rtol=0)


def test_adjoint_matches_fd_f64_and_the_reference():
    n = 4
    c = rand_ansatz(Circuit, n, layers=1, seed=3)
    adj = vg(c, "adjoint", dtype=np.float64)
    th = np.asarray(adj.initial_params, np.float64)
    _, g = adj(th)
    np.testing.assert_allclose(g.numpy(), fd(adj, th), atol=1e-9, rtol=0)
    ref = JAD.value_and_grad(rand_ansatz(JC.Circuit, n, layers=1, seed=3),
                             tfim(JE, n), engine="adjoint", dtype=np.float64)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref(jnp.asarray(th))[1]),
                               atol=1e-12, rtol=0)


def test_adjoint_density_matches_statevector():
    n = 3
    c = rand_ansatz(Circuit, n, layers=1, seed=4)
    sv = vg(c, "adjoint")
    dm, dm_t = vg(c, "adjoint", density=True), vg(c, "taped", density=True)
    th = torch.tensor(sv.initial_params, dtype=torch.float32)
    v_sv, g_sv = sv(th)
    v_dm, g_dm = dm(th)
    _, g_dt = dm_t(th)
    assert abs(float(v_dm) - float(v_sv)) <= 1e-5
    np.testing.assert_allclose(g_dm.numpy(), g_sv.numpy(), atol=1e-5)
    np.testing.assert_allclose(g_dm.numpy(), g_dt.numpy(), atol=1e-5)


def test_adjoint_from_nonzero_basis_state():
    c = rand_ansatz(Circuit, 4, layers=1, seed=6)
    adj = vg(c, "adjoint", initial_index=5)
    tap = vg(c, "taped", initial_index=5)
    th = torch.tensor(adj.initial_params, dtype=torch.float32)
    np.testing.assert_allclose(adj(th)[1].numpy(), tap(th)[1].numpy(),
                               atol=2e-6)


EMITTERS = [
    ("rx", lambda c, a: c.rx(1, a), "rx"),
    ("ry", lambda c, a: c.ry(1, a), "ry"),
    ("rz", lambda c, a: c.rz(1, a), "parity"),
    ("phase", lambda c, a: c.phase(1, a), "phase"),
    ("multi_rotate_z", lambda c, a: c.multi_rotate_z((0, 2), a), "parity"),
    ("cphase", lambda c, a: c.cphase(a, 0, 2), "allones"),
    ("controlled-rx", lambda c, a: c.cu(
        np.asarray(M.rotation(a, (1.0, 0.0, 0.0))), 1, 0), "rx"),
    ("controlled-ry", lambda c, a: c.cu(
        np.asarray(M.rotation(a, (0.0, 1.0, 0.0))), 2, 0, cstates=(0,)),
     "ry"),
]


@pytest.mark.parametrize("name,emit,family", EMITTERS,
                         ids=[e[0] for e in EMITTERS])
def test_as_rotation_roundtrip(name, emit, family):
    angle = 0.37
    c = emit(Circuit(3), angle)
    params = [as_rotation(op) for op in c.ops if as_rotation(op) is not None]
    assert len(params) == 1
    fam, theta = params[0]
    assert fam == family
    assert np.isclose(theta % (2 * np.pi), angle % (2 * np.pi), atol=1e-12)
    jc = emit(JC.Circuit(3), angle)
    assert [JC.as_rotation(op) for op in jc.ops] == [as_rotation(op)
                                                     for op in c.ops]
    adj, tap = vg(c, "adjoint"), vg(c, "taped")
    th = torch.tensor(adj.initial_params, dtype=torch.float32)
    np.testing.assert_allclose(adj(th)[1].numpy(), tap(th)[1].numpy(),
                               atol=1e-6)


def test_constants_and_multi_rotate_pauli():
    c = Circuit(3).h(0).x(1).y(2).z(0).s(1).t(2).cz(0, 1)
    assert all(as_rotation(op) is None for op in c.ops)
    c = Circuit(3).multi_rotate_pauli((0, 1, 2), (1, 2, 3), 0.81)
    params = [as_rotation(op) for op in c.ops if as_rotation(op) is not None]
    assert [f for f, _ in params] == ["ry", "rx", "parity", "ry", "rx"]
    assert np.isclose(params[2][1], 0.81)
    assert np.isclose(params[0][1], -params[3][1])
    assert np.isclose(params[1][1], -params[4][1])


def test_rejections_name_the_op():
    c = Circuit(3).h(0).measure(1).rx(0, 0.5)
    with pytest.raises(AD.AdjointError, match=r"op 1.*measure"):
        AD.build_circuit_program(c, density=False)
    c = Circuit(3).rx(2, 0.3)
    inner = GateOp("matrix", (1,), (), (), np.asarray(M.PAULI_X))
    c.ops.append(GateOp("classical", (1,), (), (), ((inner,), ((0, 1),))))
    with pytest.raises(AD.AdjointError, match=r"op 1.*classically"):
        AD.build_circuit_program(c, density=False)
    c = Circuit(3).rx(0, 0.4).damping(1, 0.1)
    with pytest.raises(AD.AdjointError, match=r"op 1.*noise"):
        AD.build_circuit_program(c, density=True)
    c = Circuit(2).rx(0, 0.4)
    c.ops.append(GateOp("matrix", (1,), (), (),
                        np.empty((2, 2), dtype=object)))
    with pytest.raises(AD.AdjointError, match="op 1"):
        AD.build_circuit_program(c, density=False)
    with pytest.raises(AD.AdjointError, match="expected a Circuit"):
        AD.value_and_grad(lambda a, p: a, tfim(E, 2), device="cpu")


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("shards", [2, 4])
def test_taped_engine_on_a_mesh_matches_the_reference(shards, rdt):
    """value_and_grad(mesh=, engine='taped') on a one-process CPU mesh:
    autograd through the out-of-place sharded appliers (global rx/ry
    targets a differentiable pair exchange, global controls and mask
    bits shard predicates), the reference's sharded `taped` engine on a
    mesh of as many devices, and the port's adjoint walk on the mesh."""
    import jax
    from jax.sharding import Mesh
    from quest_tpu.env import AMP_AXIS
    from quest_tpu_torch.parallel import make_amp_mesh
    def rot(family, a):
        c, s = np.cos(a / 2), np.sin(a / 2)
        if family == "rx":
            return np.array([[c, -1j * s], [-1j * s, c]])
        return np.array([[c, -s], [s, c]], dtype=np.complex128)

    n = 5
    c = rand_ansatz(Circuit, n, layers=2, seed=5)
    jc = rand_ansatz(JC.Circuit, n, layers=2, seed=5)
    for circ in (c, jc):
        # a controlled rotation on a global target under a local
        # control, and on a local target under a global control
        circ.cu(rot("rx", 0.37), n - 1, 0).cu(rot("ry", -0.52), 0, n - 1)
        circ.rx(n - 1, 0.81).ry(n - 2, 0.29)
    jmesh = Mesh(np.array(jax.devices()[:shards]), (AMP_AXIS,))
    ref = JAD.value_and_grad(jc, tfim(JE, n), engine="taped", mesh=jmesh,
                             dtype=rdt)
    th = np.asarray(ref.initial_params, rdt)
    vr, gr = ref(jnp.asarray(th))
    mesh = make_amp_mesh(shards, devices=["cpu"] * shards)
    fn = AD.value_and_grad(c, tfim(E, n), mesh=mesh, engine="taped",
                           dtype=rdt)
    assert fn.engine == "taped" and fn.comm_record is None
    v, g = fn(torch.from_numpy(th))
    tol = 2e-5 if rdt == np.float32 else 1e-12
    assert g.dtype == torch.from_numpy(th).dtype
    assert abs(float(v) - float(vr)) <= tol
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=0, atol=tol)
    va, ga = AD.value_and_grad(c, tfim(E, n), mesh=mesh, engine="adjoint",
                               dtype=rdt)(torch.from_numpy(th))
    assert abs(float(va) - float(v)) <= tol
    np.testing.assert_allclose(ga.numpy(), g.numpy(), rtol=0, atol=tol)


def test_grad_record_matches_the_reference(monkeypatch):
    monkeypatch.setenv("QUEST_HBM_BYTES", HBM)
    c = Circuit(3).rx(0, 0.5).measure(1)
    rec = AD.grad_record(c)
    assert rec["supported"] is False and rec["engine"] == "taped"
    assert "measure" in rec["reason"]
    assert AD.grad_record(Circuit(3).h(0).cz(0, 1)) is None
    for seed in (0, 1):
        got = AD.grad_record(rand_ansatz(Circuit, 8, seed=seed))
        want = JAD.grad_record(rand_ansatz(JC.Circuit, 8, seed=seed))
        assert got == want


def test_equal_specs_return_the_identical_callable():
    f1 = vg(rand_ansatz(Circuit, 4, seed=8), "adjoint")
    f2 = vg(rand_ansatz(Circuit, 4, seed=8), "adjoint")
    assert f1 is f2
    assert vg(rand_ansatz(Circuit, 4, seed=9), "adjoint") is not f1


def test_trotter_grads_match_taped_the_reference_and_expectation():
    n = 4
    spec = tfim(E, n)
    ansatz = EV.trotter_ansatz(spec, order=2, steps=2)
    adj = AD.value_and_grad(ansatz, spec, engine="adjoint", device="cpu")
    tap = AD.value_and_grad(ansatz, spec, engine="taped", device="cpu")
    cf = torch.tensor(spec.coeffs, dtype=torch.float32)
    params = (cf, torch.tensor(0.08))
    va, ga = adj(params)
    vt, gt = tap(params)
    assert abs(float(va) - float(vt)) <= 1e-6
    np.testing.assert_allclose(ga[0].numpy(), gt[0].numpy(), atol=5e-6)
    assert abs(float(ga[1]) - float(gt[1])) <= 5e-5
    e = V.expectation(ansatz, n, spec, device="cpu")
    assert abs(float(va) - float(e(params))) <= 1e-6
    jspec = tfim(JE, n)
    import quest_tpu.evolution as JEV
    ref = JAD.value_and_grad(JEV.trotter_ansatz(jspec, order=2, steps=2),
                             jspec, engine="adjoint")
    vr, gr = ref((jnp.asarray(spec.coeffs, jnp.float32),
                  jnp.asarray(0.08, jnp.float32)))
    assert abs(float(va) - float(vr)) <= 2e-6
    np.testing.assert_allclose(ga[0].numpy(), np.asarray(gr[0]), atol=5e-6)
    assert abs(float(ga[1]) - float(gr[1])) <= 5e-5


def test_trotter_imag_time_rejected():
    spec = tfim(E, 3)
    ansatz = EV.trotter_ansatz(spec, order=1, steps=1, imag_time=True)
    with pytest.raises(AD.AdjointError, match="imag"):
        AD.value_and_grad(ansatz, spec, engine="adjoint", device="cpu")


def test_knob_resolves_the_engine(monkeypatch):
    c = rand_ansatz(Circuit, 4, seed=13)
    ham = tfim(E, 4)
    monkeypatch.setenv("QUEST_ADJOINT", "1")
    assert AD.value_and_grad(c, ham, device="cpu").engine == "adjoint"
    monkeypatch.setenv("QUEST_ADJOINT", "0")
    assert AD.value_and_grad(c, ham, device="cpu").engine == "taped"
    monkeypatch.delenv("QUEST_ADJOINT")
    with pytest.raises(ValueError, match="QUEST_HBM_BYTES"):
        AD.value_and_grad(c, ham, device="cpu")
    monkeypatch.setenv("QUEST_HBM_BYTES", HBM)
    assert AD.value_and_grad(c, ham, device="cpu").engine == "taped"
    # at 8 qubits, a budget between three registers and the taped
    # residuals flips auto to the adjoint walk
    c8, ham8 = rand_ansatz(Circuit, 8, seed=12), tfim(E, 8)
    params = AD.value_and_grad(c8, ham8, device="cpu").num_params
    cap = AD.capacity_stats(8, params, 0)
    assert cap["adjoint_peak_bytes"] < cap["taped_residual_bytes"]
    monkeypatch.setenv("QUEST_HBM_BYTES", str(
        (cap["adjoint_peak_bytes"] + cap["taped_residual_bytes"]) // 2))
    # (engine='auto': another cache key than the call above; the memory
    # figure is not keyed, as in the reference)
    assert AD.value_and_grad(c8, ham8, engine="auto",
                             device="cpu").engine == "adjoint"


def test_capacity_model_is_depth_independent(monkeypatch):
    monkeypatch.setenv("QUEST_HBM_BYTES", HBM)
    a = AD.capacity_stats(18, 10, 50)
    b = AD.capacity_stats(18, 1000, 5000)
    assert a["adjoint_peak_bytes"] == b["adjoint_peak_bytes"]
    assert b["taped_residual_bytes"] > 50 * a["state_bytes"]
    monkeypatch.setenv("QUEST_HBM_BYTES", str(80 * 10 ** 9))
    # 30 qubits, 120 parameters on an 80 GB card: only adjoint fits
    cap = AD.capacity_stats(30, 120, 240)
    assert cap["adjoint_fits"] and not cap["taped_fits"]
    assert AD._engine_choice(cap, "auto") == "adjoint"


def test_vqe_entry_on_the_cpu():
    fn, (theta,) = EN.vqe_entry(device="cpu", num_qubits=6, layers=2)
    assert fn.engine == "adjoint" and fn.num_params == 24
    v, g = fn(theta)
    tap = EN.vqe_entry(device="cpu", num_qubits=6, layers=2,
                       engine="taped")[0]
    vt, gt = tap(theta)
    assert abs(float(v) - float(vt)) <= 1e-6
    np.testing.assert_allclose(g.numpy(), gt.numpy(), atol=2e-6)


def test_density_lambda_matches_the_reference():
    """The density bra seed (the gradient of the grouped trace, taken at
    zeros) equals the reference's jax.grad seed on the same planes."""
    n = 3
    spec_t, spec_j = tfim(E, n), tfim(JE, n)
    rng = np.random.default_rng(51)
    a = rng.standard_normal((2, 1 << (2 * n)))
    cf = np.asarray(spec_t.coeffs)
    plan_t = E.plan_expec(spec_t.codes, n, density=True)
    plan_j = JE.plan_expec(spec_j.codes, n, density=True)
    got = AD._density_lambda(torch.from_numpy(a), torch.from_numpy(cf),
                             plan_t)
    want = JAD._density_lambda(jnp.asarray(a), jnp.asarray(cf), plan_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("chunk_bits", [24, 3])
def test_im_overlap_matches_the_reference(chunk_bits, monkeypatch):
    """Im <lambda| G |psi> of every entry of a circuit with controlled
    rotations, phases and parities, against the reference's, with the
    chunk cut to 3 bits so flips, signs and controls straddle it."""
    monkeypatch.setattr(E, "CHUNK_BITS", chunk_bits)
    n = 6
    c = (Circuit(n).rx(5, 0.3).ry(0, 0.2).multi_rotate_z((1, 4, 5), 0.4)
         .phase(4, 0.5).cphase(0.6, 1, 5)
         .cu(np.asarray(M.rotation(0.7, (1.0, 0.0, 0.0))), 4, 0)
         .cu(np.asarray(M.rotation(0.8, (0.0, 1.0, 0.0))), 1, 5,
             cstates=(0,)))
    jc = JC.Circuit(n)
    jc.ops = list(c.ops)
    prog_t, _ = AD.build_circuit_program(c, density=False)
    prog_j, _ = JAD.build_circuit_program(jc, density=False)
    rng = np.random.default_rng(52)
    lam, psi = (rng.standard_normal((2, 1 << n)) for _ in range(2))
    params = [(e, f) for e, f in zip(prog_t.entries, prog_j.entries)
              if isinstance(e, AD._Param)]
    assert len(params) == 7
    for e, f in params:
        got = float(AD._im_overlap(torch.from_numpy(lam),
                                   torch.from_numpy(psi), n, e))
        want = float(JAD._im_overlap(jnp.asarray(lam), jnp.asarray(psi), n,
                                     f))
        assert abs(got - want) <= 1e-12, (e.family, got, want)
