"""The port's transpiler against the JAX package.

quest_tpu_torch.transpile beside quest_tpu.transpile on the same op
streams: the repo bench's gallery (imported untranspiled) at 8-10 qubits
and 30 seeded random circuits with pass fixtures mixed in, in both modes
(exact_only and the default): transpile_ops's output stream (kinds,
qubits, operands within 1e-12) and its report are equal. Then the
equivalence contract on the port's engines: an exact_only stream runs
bit for bit like the raw stream on the per-gate engine; a default-mode
stream is eps-close (f32 1e-5 x max|amp|, f64 1e-12) on `compiled`,
`compiled_banded` and `compiled_fused(...).plain`, on statevectors and
density registers; measurements stay barriers (equal outcomes given the
same uniforms); and a folded angle's gradient equals the raw angles',
by autograd through a tensor operand and by the adjoint engine."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import transpile as JT
from quest_tpu.circuit import Circuit as JCircuit

from quest_tpu_torch import adjoint as AD
from quest_tpu_torch import transpile as T
from quest_tpu_torch import variational as V
from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.entry import GALLERY_CLASSES, gallery_qasm
from quest_tpu_torch.ops import expec as E

from .test_torch_qasm import _same_ops

pytestmark = pytest.mark.dtype_agnostic

EPS = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# streams built the same way on both packages
# ---------------------------------------------------------------------------

def _random_static(cls, n, depth, seed):
    """Random circuit of the static gate set with pass fixtures mixed in
    (inverse pairs, Rz chains, cp in its rz/cx form, a toffoli pair in
    its Clifford+T form)."""
    rng = np.random.default_rng(seed)
    c = cls(n)
    kinds = ["h", "x", "y", "z", "s", "t", "rx", "ry", "rz", "phase",
             "cnot", "cz", "swap", "cphase", "mrz", "pair", "cp", "ccx"]
    for _ in range(depth):
        k = kinds[rng.integers(len(kinds))]
        q = int(rng.integers(n))
        q2 = int((q + 1 + rng.integers(n - 1)) % n)
        q3 = int((q2 + 1 + rng.integers(n - 2)) % n)
        if q3 == q:
            q3 = (q3 + 1) % n if (q3 + 1) % n != q2 else (q3 + 2) % n
        a = float(rng.uniform(-np.pi, np.pi))
        if k in ("h", "x", "y", "z", "s", "t"):
            getattr(c, k)(q)
        elif k in ("rx", "ry", "rz", "phase"):
            getattr(c, k)(q, a)
        elif k == "cnot":
            c.cnot(q, q2)
        elif k == "cz":
            c.cz(q, q2)
        elif k == "swap":
            c.swap(q, q2)
        elif k == "cphase":
            c.cphase(a, q, q2)
        elif k == "mrz":
            c.multi_rotate_z((q, q2), a)
        elif k == "pair":
            c.h(q).h(q).rz(q2, a).rz(q2, -a).x(q).x(q)
        elif k == "cp":
            c.rz(q, a / 2).cnot(q, q2).rz(q2, -a / 2).cnot(q, q2)
            c.rz(q2, a / 2)
        else:
            for _ in range(2):
                _ccx(c, q, q2, q3)
    return c


def _ccx(c, a, b, t):
    sdg = np.diag([1.0, np.exp(-0.25j * np.pi)])
    c.h(t).cnot(b, t).gate(sdg, (t,)).cnot(a, t).t(t).cnot(b, t)
    c.gate(sdg, (t,)).cnot(a, t).t(b).t(t).h(t).cnot(a, b).t(a)
    c.gate(sdg, (b,)).cnot(a, b)


def _gallery(cls, n, name):
    return cls.from_qasm(gallery_qasm(n)[name], transpile=False)


def _check_same_rewrite(mine, ref, exact_only):
    tops, trep = T.transpile_ops(mine.ops, mine.num_qubits,
                                 exact_only=exact_only)
    jops, jrep = JT.transpile_ops(ref.ops, ref.num_qubits,
                                  exact_only=exact_only)
    assert trep == jrep
    _same_ops(tops, jops, tol=1e-12)
    return tops, trep


@pytest.mark.parametrize("exact_only", [False, True])
@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("name", GALLERY_CLASSES)
def test_gallery_rewrite_equals_reference(name, n, exact_only):
    _check_same_rewrite(_gallery(Circuit, n, name),
                        _gallery(JCircuit, n, name), exact_only)


@pytest.mark.parametrize("exact_only", [False, True])
@pytest.mark.parametrize("seed", range(30))
def test_random_rewrite_equals_reference(seed, exact_only):
    n = 3 + seed % 4
    _check_same_rewrite(_random_static(Circuit, n, 40, seed),
                        _random_static(JCircuit, n, 40, seed), exact_only)


def test_stream_cost_and_routing_equal_reference(monkeypatch):
    for name in GALLERY_CLASSES:
        mine, ref = _gallery(Circuit, 9, name), _gallery(JCircuit, 9, name)
        assert T.stream_cost(mine) == JT.stream_cost(ref)
        for knob in ("auto", "0", "1"):
            monkeypatch.setenv("QUEST_TRANSPILE", knob)
            tc, trep = T.maybe_transpile(mine)
            jc, jrep = JT.maybe_transpile(ref)
            assert trep == jrep
            assert (tc is mine) == (jc is ref)
            _same_ops(tc.ops, jc.ops)


def test_dense_unitary_equals_reference():
    mine, ref = (_random_static(c, 3, 30, 5) for c in (Circuit, JCircuit))
    np.testing.assert_array_equal(T.dense_unitary(mine.ops, (0, 1, 2)),
                                  JT.dense_unitary(ref.ops, (0, 1, 2)))


# ---------------------------------------------------------------------------
# the equivalence contract on the port's engines
# ---------------------------------------------------------------------------

def _state(n, rdt, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 1 << n))
    v /= np.sqrt((v ** 2).sum())
    return torch.from_numpy(v.astype(rdt))


def _with_ops(n, ops):
    c = Circuit(n)
    c.ops = list(ops)
    return c


@pytest.mark.parametrize("seed", range(6))
def test_exact_only_is_bit_identical(seed):
    n = 4 + seed % 3
    c = _random_static(Circuit, n, 40, seed)
    ops, rep = T.transpile_ops(c.ops, n, exact_only=True)
    assert rep["passes"]["merge1q"] == rep["passes"]["resynth2q"] == 0
    v = _state(n, np.float32, seed)
    want = c.compiled(n, device="cpu")(v.clone())
    got = _with_ops(n, ops).compiled(n, device="cpu")(v.clone())
    assert torch.equal(got, want)


ENGINES = ("compiled", "compiled_banded", "fused_plain")


def _run(c, n, engine, v, density=False):
    if engine == "fused_plain":
        return c.compiled_fused(n, density, device="cpu").plain(v.clone())
    return getattr(c, engine)(n, density, device="cpu")(v.clone())


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", range(2))
def test_default_mode_statevector_is_eps_close(seed, engine, rdt):
    n = 10
    c = _random_static(Circuit, n, 60, 100 + seed)
    tc, rep = T.transpile(c)
    assert rep["changed"] and rep["ops_out"] < rep["ops_in"]
    v = _state(n, rdt, seed)
    want = _run(c, n, engine, v).numpy()
    got = _run(tc, n, engine, v).numpy()
    assert np.abs(got - want).max() <= EPS[rdt] * np.abs(want).max()


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
@pytest.mark.parametrize("engine", ENGINES)
def test_default_mode_density_is_eps_close(engine, rdt):
    N = 5
    c = _random_static(Circuit, N, 30, 7)
    c.damping(1, 0.1).depolarising(3, 0.05)
    c.ops += _random_static(Circuit, N, 20, 8).ops
    tc, rep = T.transpile(c)
    assert rep["changed"] and rep["stretches"] == 2
    kinds = [op.kind for op in tc.ops]
    assert kinds.count("superop") == 2
    rho = _state(2 * N, rdt, 3)
    want = _run(c, 2 * N, engine, rho, density=True).numpy()
    got = _run(tc, 2 * N, engine, rho, density=True).numpy()
    assert np.abs(got - want).max() <= EPS[rdt] * np.abs(want).max()


@pytest.mark.parametrize("engine", ["banded", "xla"])
def test_measurements_stay_barriers(engine):
    n = 6
    for seed in range(3):
        c = _random_static(Circuit, n, 20, 40 + seed)
        c.measure(2)
        c.ops += _random_static(Circuit, n, 20, 50 + seed).ops
        c.measure(0).x_if(1, (1, 1))
        c.ops += _random_static(Circuit, n, 10, 60 + seed).ops
        tc, rep = T.transpile(c)
        assert rep["changed"] and rep["stretches"] == 3
        assert [op.kind for op in tc.ops if op.kind in
                ("measure", "classical")] == ["measure", "measure",
                                              "classical"]
        for uniforms in ([0.2, 0.7], [0.9, 0.1], [0.5, 0.5]):
            v = _state(n, np.float64, seed)
            a, oa = c.compiled_measured(n, engine=engine,
                                        device="cpu").given(v.clone(),
                                                            uniforms)
            b, ob = tc.compiled_measured(n, engine=engine,
                                         device="cpu").given(v.clone(),
                                                             uniforms)
            assert torch.equal(oa, ob)
            assert np.abs(a.numpy() - b.numpy()).max() <= 1e-12


# ---------------------------------------------------------------------------
# gradients through fold
# ---------------------------------------------------------------------------

def _fold_fixture(cls):
    n = 3
    c = cls(n)
    for q in range(n):
        c.h(q)
    c.cnot(1, 0)
    c.rz(0, 0.3)
    c.cz(1, 2)
    c.rz(0, 0.5)
    c.ry(1, 0.7)
    return c


def _ham(n):
    codes = np.zeros((2, n), dtype=int)
    codes[0, 0] = 1
    codes[1, 1] = 3
    return E.PauliSum.of(codes, np.array([1.0, 0.6]), n)


def test_tensor_angles_fold_with_their_graph():
    """Two parity ops on tensor angles that need grad fold into ONE
    parity op whose operand is their sum, a tensor of the same graph:
    the energy through the folded stream has the raw stream's value and
    gradient (dE/da == dE/db, since E depends on a + b only)."""
    n = 3
    ham = _ham(n)
    plan = E.plan_expec(ham.codes, n, density=False)
    cf = torch.tensor(ham.coeffs, dtype=torch.float64)

    def energy(ops, theta):
        amps = torch.zeros((2, 1 << n), dtype=torch.float64)
        amps[0, 0] = 1.0
        for op in ops:
            if op.kind == "parity":
                amps = V.parity(amps, n, op.targets, op.operand)
            elif op.kind == "allones":
                amps = V.cz(amps, n, *op.targets)
            else:
                amps = V.gate(amps, n, op.operand, op.targets, op.controls)
        return E.expec_traced(amps, cf, plan)

    theta = torch.tensor([0.3, 0.5], dtype=torch.float64, requires_grad=True)
    raw = Circuit(n)
    for q in range(n):
        raw.h(q)
    raw.cnot(1, 0)
    raw.ops.append(GateOp("parity", (0,), operand=theta[0]))
    raw.cz(1, 2)
    raw.ops.append(GateOp("parity", (0,), operand=theta[1]))
    raw.ry(1, 0.7)
    ops, rep = T.transpile_ops(raw.ops, n)
    assert rep["passes"]["fold"] == 1
    folded = [op for op in ops if op.kind == "parity"]
    assert len(folded) == 1 and torch.is_tensor(folded[0].operand)
    assert folded[0].operand.requires_grad
    e_raw = energy(raw.ops, theta)
    g_raw, = torch.autograd.grad(e_raw, theta)
    e_fold = energy(ops, theta)
    g_fold, = torch.autograd.grad(e_fold, theta)
    assert abs(float(e_fold.detach()) - float(e_raw.detach())) <= 1e-12
    torch.testing.assert_close(g_fold, g_raw, atol=1e-12, rtol=0)
    assert abs(float(g_raw[0]) - float(g_raw[1])) <= 1e-12


def test_adjoint_gradient_at_the_folded_angle():
    """The adjoint engine on the transpiled ansatz: one parameter less,
    the same energy, and the folded angle's gradient equal to each raw
    angle's (ref tests/test_transpile.py::test_rotation_fold_grad_parity)."""
    c = _fold_fixture(Circuit)
    ct, rep = T.transpile(c)
    assert rep["passes"]["fold"] >= 1
    ham = _ham(3)
    raw = AD.value_and_grad(c, ham, engine="adjoint", device="cpu")
    fus = AD.value_and_grad(ct, ham, engine="adjoint", device="cpu")
    assert fus.num_params == raw.num_params - 1
    th_r = torch.as_tensor(np.asarray(raw.initial_params, np.float32))
    th_f = torch.as_tensor(np.asarray(fus.initial_params, np.float32))
    v_r, g_r = raw(th_r)
    v_f, g_f = fus(th_f)
    assert abs(float(v_f) - float(v_r)) <= 1e-6
    g_r, g_f = g_r.numpy(), g_f.numpy()
    ir = [i for i, th in enumerate(th_r.numpy())
          if np.isclose(th, 0.3) or np.isclose(th, 0.5)]
    im = [i for i, th in enumerate(th_f.numpy()) if np.isclose(th, 0.8)]
    assert len(ir) == 2 and len(im) == 1
    assert abs(g_r[ir[0]] - g_r[ir[1]]) <= 2e-6
    assert abs(g_f[im[0]] - g_r[ir[0]]) <= 2e-6


# ---------------------------------------------------------------------------
# the Circuit surface
# ---------------------------------------------------------------------------

def test_transpiled_is_memoised_until_the_circuit_changes():
    c = _random_static(Circuit, 4, 30, 3)
    t1 = c.transpiled()
    assert c.transpiled() is t1
    assert t1._transpile_report["ops_out"] == len(t1.ops)
    assert c.transpiled(exact_only=True) is not t1
    c.h(0)
    assert c.transpiled() is not t1
    plain = Circuit(2).h(0).cnot(0, 1)
    assert plain.transpiled() is plain


def test_from_qasm_transpile_routing(monkeypatch):
    text = gallery_qasm(8)["qaoa"]
    raw = Circuit.from_qasm(text, transpile=False)
    forced = Circuit.from_qasm(text, transpile=True)
    assert forced._transpile_report["changed"]
    assert len(forced.ops) < len(raw.ops)
    monkeypatch.setenv("QUEST_TRANSPILE", "0")
    assert len(Circuit.from_qasm(text).ops) == len(raw.ops)
    monkeypatch.setenv("QUEST_TRANSPILE", "auto")
    ref = JCircuit.from_qasm(text)
    _same_ops(Circuit.from_qasm(text).ops, ref.ops)
