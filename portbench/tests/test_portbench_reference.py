"""The plain reference against dense matrices at a few qubits, on the CPU:
`python -m pytest portbench/tests -q`."""

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import CONTROL, TRUTH
from portbench.reference import circuits as R
from portbench.reference import core as C

I2 = np.eye(2)


def full(n, q, m):
    """The 2^n operator of a one-qubit `m` on qubit q (bit q of the index)."""
    out = np.eye(1)
    for k in reversed(range(n)):
        out = np.kron(out, m if k == q else I2)
    return out


def cz_diag(n, a, b):
    x = np.arange(1 << n)
    return np.where(((x >> a) & 1) & ((x >> b) & 1), -1.0, 1.0)


def dense_state(n, gates):
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for g in gates:
        if g[0] == "cz":
            psi = cz_diag(n, g[1], g[2]) * psi
        else:
            psi = full(n, g[1], R.rotation(g[0], g[2])) @ psi
    return psi


def dense_density(n, gates):
    rho = np.zeros((1 << n, 1 << n), complex)
    rho[0, 0] = 1
    for g in gates:
        if g[0] == "cz":
            d = cz_diag(n, g[1], g[2])
            rho = d[:, None] * rho * d[None, :]
        elif g[0] in R.ROTATIONS:
            u = full(n, g[1], R.rotation(g[0], g[2]))
            rho = u @ rho @ u.conj().T
        else:
            ks = [full(n, g[1], k) for k in R.kraus(g[0], g[2])]
            rho = sum(k @ rho @ k.conj().T for k in ks)
    return rho


def as_np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n,depth,seed", [(5, 3, 1), (7, 4, 2 ** 33 + 5),
                                          (8, 2, 9)])
def test_statevector_gate_list_equals_dense_product(n, depth, seed):
    gates = traffic.generate(n, {"generator": "rcs", "depth": depth,
                                "structure_seed": 7}, seed)
    psi = R.run_statevector(R.zero_state(n, TRUTH, "cpu"), n, gates, TRUTH)
    assert np.abs(as_np(psi) - dense_state(n, gates)).max() < 1e-12


@pytest.mark.parametrize("n,seed", [(3, 4), (4, 2 ** 40)])
def test_density_gate_list_equals_dense_kraus_sums(n, seed):
    mix = {"generator": "noisy_rcs", "depth": 2, "structure_seed": 11,
           "depolarising": 0.02, "damping": 0.05}
    gates = traffic.generate(n, mix, seed)
    rho = R.run_density(R.zero_state(2 * n, TRUTH, "cpu"), n, gates, TRUTH)
    want = dense_density(n, gates)
    assert np.abs(as_np(rho) - want.T.reshape(-1)).max() < 1e-12
    assert abs(R.density_trace(rho, n) - np.trace(want).real) < 1e-12
    assert abs(R.density_purity(rho) - np.trace(want @ want).real) < 1e-12


@pytest.mark.parametrize("lo,k,n", [(0, 1, 5), (0, 3, 6), (2, 2, 6),
                                    (3, 3, 6), (5, 1, 6)])
def test_dense_block_on_any_bits(lo, k, n, monkeypatch):
    monkeypatch.setattr(C, "CHUNK", 4)          # several chunks each way
    rng = np.random.default_rng(lo * 10 + k)
    u = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal(
        (1 << k, 1 << k))
    x = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    got = C.apply_dense(torch.tensor(x), n, lo, u, TRUTH)
    op = np.kron(np.kron(np.eye(1 << (n - lo - k)), u), np.eye(1 << lo))
    assert np.abs(as_np(got) - op @ x).max() < 1e-12


def test_diagonal_terms_straddling_the_split(monkeypatch):
    monkeypatch.setattr(C, "CHUNK", 8)
    n = 7
    terms = [("z", 1, 0.3), ("zz", 0, 6, -0.7), ("zz", 2, 3, 0.2),
             ("and", 3, 4, np.pi), ("and", 5, 6, 1.1)]
    x = np.arange(1 << n)
    bit = lambda q: (x >> q) & 1
    s = lambda q: 1 - 2 * bit(q)
    f = (0.3 * s(1) - 0.7 * s(0) * s(6) + 0.2 * s(2) * s(3)
         + np.pi * bit(3) * bit(4) + 1.1 * bit(5) * bit(6))
    psi = torch.ones(1 << n, dtype=torch.complex128)
    C.Diagonal(n, terms).apply_phase(psi, TRUTH)
    assert np.abs(as_np(psi) - np.exp(1j * f)).max() < 1e-12
    amp = torch.tensor(np.linspace(0.1, 1, 1 << n) + 0j)
    want = float((np.abs(as_np(amp)) ** 2 * f).sum())
    assert abs(C.Diagonal(n, terms).expectation(amp) - want) < 1e-12


def _dense_h(n, ham):
    x = np.arange(1 << n)
    s = lambda q: 1 - 2 * ((x >> q) & 1)
    hzz = sum(j * s(a) * s(b) for a, b, j in ham["couplings"])
    hx = sum(h * full(n, q, np.array([[0, 1], [1, 0]]))
             for q, h in ham["fields"])
    return hzz, hx


def _expm_h(h, t):
    w, v = np.linalg.eigh(h)
    return (v * np.exp(-1j * t * w)) @ v.conj().T


def test_strang_steps_and_energies_equal_dense_exponentials():
    n, dt = 6, 0.05
    ham = traffic.generate(n, {"generator": "zz_x_ring",
                               "coupling": -1.0, "field": -0.7,
                               "disorder": 0.1}, 77)
    hzz, hx = _dense_h(n, ham)
    step = (np.diag(np.exp(-0.5j * dt * hzz)) @ _expm_h(hx, dt)
            @ np.diag(np.exp(-0.5j * dt * hzz)))
    want = np.zeros(1 << n, complex)
    want[0] = 1
    psi = R.zero_state(n, TRUTH, "cpu")
    for _ in range(3):
        R.zz_x_strang_step(psi, n, ham["couplings"], ham["fields"], dt, TRUTH)
        want = step @ want
    assert np.abs(as_np(psi) - want).max() < 1e-12
    h = np.diag(hzz) + hx
    e = R.zz_x_energy(psi, n, ham["couplings"], ham["fields"])
    assert abs(e - (want.conj() @ h @ want).real) < 1e-11


def test_sampler_gap_and_xeb():
    p = np.array([0.1, 0.0, 0.4, 0.2, 0.3])
    psi = torch.tensor(np.sqrt(p) + 0j)
    cdf = R.probabilities_cdf(psi)
    u = torch.tensor([0.0, 0.05, 0.1, 0.35, 0.55, 0.75, 0.999],
                     dtype=torch.float32)
    s = R.sample(cdf, u)
    assert as_np(s).tolist() == [0, 0, 2, 2, 3, 4, 4]
    assert R.sample_gap(cdf, s, u) < 1e-7
    wrong = s.clone()
    wrong[3] = 4                             # 0.35 drawn as index 4
    assert abs(R.sample_gap(cdf, wrong, u) - (0.7 - 0.35)) < 1e-6
    assert abs(R.linear_xeb(psi, s) - (5 * p[as_np(s)].mean() - 1)) < 1e-12


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12,
                      -(1 + 3 * 2 ** -11), 3.0e-5])
    got = C.round_tf32(x)
    assert got[:3].tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -10]
    assert got[3].item() == 1.0
    assert got[4].item() == -(1 + 2 ** -9)
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0
    a = torch.tensor([[1 + 2 ** -12 + 0j]], dtype=torch.complex64)
    assert C.cmm(a, a, CONTROL).real.item() == 1.0
    assert C.cmm(a, a, TRUTH).real.item() != 1.0
