"""The port's differentiable gates and energies (quest_tpu_torch.variational)
against the reference's (quest_tpu.variational): the reference's four
cases (energy against the eager gate path, gradient against finite
differences, value-and-grad and batched evaluation, gradient descent),
torch.autograd.gradcheck of every gate at f64 in the planes and the
angle, and energies and gradients against jax.value_and_grad of the
reference's expectation on the same ansatz (f32: 2e-5, f64: 1e-12).
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

import jax
import jax.numpy as jnp

from quest_tpu import variational as JV

from quest_tpu_torch import calculations as K
from quest_tpu_torch import state as TS
from quest_tpu_torch import variational as V
from quest_tpu_torch.ops import gates as G

pytestmark = pytest.mark.dtype_agnostic

N = 4
# H = 1.0 Z0 Z1 + 0.5 X2 + 0.25 Y0 Z3 (codes: I=0 X=1 Y=2 Z=3)
CODES = [[3, 3, 0, 0], [0, 0, 1, 0], [2, 0, 0, 3]]
COEFFS = [1.0, 0.5, 0.25]
PARAMS = np.array([0.3, -0.7, 1.1, 0.4, -0.2, 0.9, 0.55])


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def make_ansatz(Vm):
    """The reference test's ansatz over either package's gate set."""
    def ansatz(amps, params):
        n = N
        amps = Vm.ry(amps, n, 0, params[0])
        amps = Vm.ry(amps, n, 1, params[1])
        amps = Vm.cnot(amps, n, 0, 1)
        amps = Vm.rx(amps, n, 2, params[2])
        amps = Vm.rz(amps, n, 1, params[3])
        amps = Vm.cz(amps, n, 1, 2)
        amps = Vm.parity(amps, n, (0, 3), params[4])
        amps = Vm.phase(amps, n, 3, params[5], controls=(0,))
        amps = Vm.crz(amps, n, 2, 3, params[6])
        amps = Vm.h(amps, n, 3)
        return amps
    return ansatz


def eager_energy(params):
    """The same circuit through the port's eager gates, at f64."""
    q = TS.create_qureg(N, dtype=np.complex128, device="cpu")
    G.rotate_y(q, 0, float(params[0]))
    G.rotate_y(q, 1, float(params[1]))
    G.controlled_not(q, 0, 1)
    G.rotate_x(q, 2, float(params[2]))
    G.rotate_z(q, 1, float(params[3]))
    G.controlled_phase_flip(q, 1, 2)
    G.multi_rotate_z(q, (0, 3), float(params[4]))
    G.controlled_phase_shift(q, 0, 3, float(params[5]))
    G.controlled_rotate_z(q, 2, 3, float(params[6]))
    G.hadamard(q, 3)
    return K.calc_expec_pauli_sum(q, CODES, COEFFS)


def energy64():
    return V.expectation(make_ansatz(V), N, CODES, COEFFS, dtype=np.float64,
                         device="cpu")


def test_energy_matches_eager_path():
    got = float(energy64()(torch.from_numpy(PARAMS)))
    assert abs(got - eager_energy(PARAMS)) < 1e-10


def test_gradient_matches_finite_differences():
    energy = energy64()
    th = torch.from_numpy(PARAMS.copy()).requires_grad_(True)
    g = torch.autograd.grad(energy(th), th)[0].numpy()
    eps = 1e-6
    for j in range(len(PARAMS)):
        p1, p0 = PARAMS.copy(), PARAMS.copy()
        p1[j] += eps
        p0[j] -= eps
        fd = (float(energy(torch.from_numpy(p1)))
              - float(energy(torch.from_numpy(p0)))) / (2 * eps)
        assert abs(g[j] - fd) < 1e-6, (j, g[j], fd)


def test_value_and_grad_and_sweep():
    energy = V.expectation(make_ansatz(V), N, CODES, COEFFS, device="cpu")
    th = torch.tensor(PARAMS, dtype=torch.float32, requires_grad=True)
    v = energy(th)
    g = torch.autograd.grad(v, th)[0]
    assert torch.isfinite(v) and tuple(g.shape) == (7,)
    batch = torch.stack([torch.tensor(PARAMS, dtype=torch.float32),
                         torch.tensor(PARAMS * 0.5, dtype=torch.float32)])
    vs = V.sweep(energy, batch)
    assert tuple(vs.shape) == (2,)
    assert abs(float(vs[0]) - float(v.detach())) < 1e-5
    assert float(vs[1]) == float(energy(batch[1]))


def test_gradient_descent_converges():
    def a(amps, p):
        return V.ry(amps, N, 0, p[0])
    energy = V.expectation(a, N, [[3, 0, 0, 0]], [1.0], dtype=np.float64,
                           device="cpu")
    p = torch.tensor([0.3], dtype=torch.float64)
    for _ in range(200):
        p = p.detach().requires_grad_(True)
        p = p - 0.1 * torch.autograd.grad(energy(p), p)[0]
    assert abs(float(energy(p.detach())) - (-1.0)) < 1e-6


GATES = {
    "rx": lambda a, t: V.rx(a, 3, 1, t),
    "rx_ctrl": lambda a, t: V.rx(a, 3, 1, t, controls=(0,), cstates=(0,)),
    "ry": lambda a, t: V.ry(a, 3, 2, t),
    "ry_ctrl": lambda a, t: V.ry(a, 3, 0, t, controls=(2, 1)),
    "rz": lambda a, t: V.rz(a, 3, 0, t),
    "parity": lambda a, t: V.parity(a, 3, (0, 2), t),
    "phase": lambda a, t: V.phase(a, 3, 1, t),
    "phase_ctrl": lambda a, t: V.phase(a, 3, 2, t, controls=(0,),
                                       cstates=(0,)),
    "crz": lambda a, t: V.crz(a, 3, 2, 0, t),
    "gate": lambda a, t: V.gate(a, 3, np.array([[0, 1j], [1j, 0]]), (1,),
                                (2,)) * torch.cos(t),
    "h": lambda a, t: V.h(a, 3, 2) * torch.cos(t),
    "x": lambda a, t: V.x(a, 3, 0) * torch.cos(t),
    "cnot": lambda a, t: V.cnot(a, 3, 2, 1) * torch.cos(t),
    "cz": lambda a, t: V.cz(a, 3, 0, 2) * torch.cos(t),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_gradcheck_of_every_gate(name):
    """gradcheck at f64 of each gate, in the planes and the angle (the
    fixed gates are scaled by cos(theta) so the check reaches theta)."""
    rng = np.random.default_rng(sorted(GATES).index(name))
    a = torch.from_numpy(rng.standard_normal((2, 8))).requires_grad_(True)
    t = torch.tensor(0.37, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(GATES[name], (a, t))


def test_gates_match_the_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 8))
    jgates = {
        "rx_ctrl": lambda a, t: JV.rx(a, 3, 1, t, controls=(0,),
                                      cstates=(0,)),
        "ry_ctrl": lambda a, t: JV.ry(a, 3, 0, t, controls=(2, 1),
                                      cstates=(1, 1)),
        "phase_ctrl": lambda a, t: JV.phase(a, 3, 2, t, controls=(0,),
                                            cstates=(0,)),
        "crz": lambda a, t: JV.crz(a, 3, 2, 0, t),
        "cz": lambda a, t: JV.cz(a, 3, 0, 2),
        "cnot": lambda a, t: JV.cnot(a, 3, 2, 1),
    }
    for name, jg in jgates.items():
        want = np.asarray(jg(jnp.asarray(a), 0.37))
        if name in ("cz", "cnot"):
            want = want * np.cos(0.37)
        got = GATES[name](torch.from_numpy(a),
                          torch.tensor(0.37, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_energy_and_gradient_match_the_reference(rdt):
    tol = 2e-5 if rdt == np.float32 else 1e-12
    energy = V.expectation(make_ansatz(V), N, CODES, COEFFS, dtype=rdt,
                           device="cpu")
    jenergy = JV.expectation(make_ansatz(JV), N, CODES, COEFFS, dtype=rdt)
    jv, jg = jax.value_and_grad(jenergy)(jnp.asarray(PARAMS, rdt))
    th = torch.tensor(PARAMS.astype(rdt), requires_grad=True)
    v = energy(th)
    g = torch.autograd.grad(v, th)[0]
    assert abs(float(v) - float(jv)) <= tol
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=tol, rtol=0)


def test_expectation_rejects_bad_sums():
    from quest_tpu_torch.ops import expec as E
    spec = E.PauliSum.of(CODES, COEFFS, N)
    with pytest.raises(ValueError, match="inside the PauliSum"):
        V.expectation(make_ansatz(V), N, spec, COEFFS, device="cpu")
    with pytest.raises(ValueError, match="qubits"):
        V.expectation(make_ansatz(V), N + 1, spec, device="cpu")
    with pytest.raises(ValueError, match="one coefficient per term"):
        V.expectation(make_ansatz(V), N, CODES, COEFFS[:2], device="cpu")
    e = V.expectation(make_ansatz(V), N, spec, dtype=np.float64,
                      device="cpu")
    assert abs(float(e(torch.from_numpy(PARAMS)))
               - eager_energy(PARAMS)) < 1e-10
