"""The port's calculations against the JAX package.

Every function of quest_tpu_torch.calculations on the CPU beside
quest_tpu.calculations, on seeded random statevectors (6 qubits) and
density matrices (3 qubits), f32 within 2e-5 (relative to the value's
scale) and f64 within 1e-12: inner products, density inner product,
fidelity (statevector and density), Hilbert-Schmidt distance, Pauli
product and Pauli-sum expectations (every term mix: identity, diagonal,
X/Y flips), linear XEB, the Pauli-sum image, total probability and
purity; plus ops/apply's Pauli string pass against the reference's, and
the chunked paths cut small enough to run several chunks."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import calculations as JK
from quest_tpu import state as JS
from quest_tpu.ops import apply as JA

from quest_tpu_torch import calculations as TK
from quest_tpu_torch import measurement as TM
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import apply as TA

pytestmark = pytest.mark.dtype_agnostic

DTYPES = [np.float32, np.float64]
TOL = {np.float32: 2e-5, np.float64: 1e-12}
SV, DM = 6, 3          # statevector qubits, density-matrix qubits


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _cdt(rdt):
    return np.complex64 if rdt == np.float32 else np.complex128


def _pair(rdt, density, seed):
    """(port register, reference register) holding the same random
    state: normalised vector, or a random mixed state."""
    rng = np.random.default_rng(seed)
    if density:
        dim = 1 << DM
        g = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
        rho = g @ g.conj().T
        v = (rho / np.trace(rho).real).reshape(-1, order="F")
        tq = TS.create_density_qureg(DM, dtype=_cdt(rdt), device="cpu")
        jq = JS.create_density_qureg(DM, dtype=_cdt(rdt))
    else:
        v = rng.standard_normal(1 << SV) + 1j * rng.standard_normal(1 << SV)
        v /= np.linalg.norm(v)
        tq = TS.create_qureg(SV, dtype=_cdt(rdt), device="cpu")
        jq = JS.create_qureg(SV, dtype=_cdt(rdt))
    planes = np.stack([v.real, v.imag]).astype(rdt)
    tq.amps.copy_(torch.from_numpy(planes))
    return tq, jq.replace_amps(jnp.asarray(planes))


def _near(got, want, rdt, scale=1.0):
    assert abs(complex(got) - complex(want)) <= TOL[rdt] * max(scale, 1.0)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Chunk every reduction several times over, so the chunk seams run."""
    monkeypatch.setattr(TK, "CHUNK_AMPS", 16)
    monkeypatch.setattr(TA, "CHUNK_AMPS", 8)


@pytest.mark.parametrize("rdt", DTYPES)
def test_inner_product_and_fidelity(rdt):
    a, ja = _pair(rdt, False, 1)
    b, jb = _pair(rdt, False, 2)
    _near(TK.calc_inner_product(a, b), JK.calc_inner_product(ja, jb), rdt)
    _near(TK.calc_inner_product(a, a), 1.0, rdt)
    _near(TK.calc_fidelity(a, b), JK.calc_fidelity(ja, jb), rdt)
    _near(TK.calc_total_prob(a), JK.calc_total_prob(ja), rdt)


@pytest.mark.parametrize("rdt", DTYPES)
def test_density_calculations(rdt):
    r1, j1 = _pair(rdt, True, 3)
    r2, j2 = _pair(rdt, True, 4)
    psi = TS.create_qureg(DM, dtype=_cdt(rdt), device="cpu")
    v = np.random.default_rng(5).standard_normal((2, 1 << DM))
    v /= np.sqrt((v ** 2).sum())
    psi.amps.copy_(torch.from_numpy(v.astype(rdt)))
    jpsi = JS.create_qureg(DM, dtype=_cdt(rdt)).replace_amps(
        jnp.asarray(v.astype(rdt)))
    _near(TK.calc_density_inner_product(r1, r2),
          JK.calc_density_inner_product(j1, j2), rdt)
    _near(TK.calc_purity(r1), JK.calc_purity(j1), rdt)
    _near(TK.calc_total_prob(r1), JK.calc_total_prob(j1), rdt)
    _near(TK.calc_hilbert_schmidt_distance(r1, r2),
          JK.calc_hilbert_schmidt_distance(j1, j2), rdt)
    _near(TK.calc_fidelity(r1, psi), JK.calc_fidelity(j1, jpsi), rdt)


def _codes(rng, terms, nq):
    codes = rng.integers(0, 4, size=(terms, nq))
    codes[0] = 0                     # the identity
    codes[1] = np.where(codes[1] % 2, 3, 0)     # diagonal only
    return codes


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density", [False, True])
def test_pauli_expectations(rdt, density):
    q, jq = _pair(rdt, density, 6)
    nq = DM if density else SV
    rng = np.random.default_rng(7)
    codes = _codes(rng, 9, nq)
    coeffs = rng.standard_normal(9)
    want = JK.calc_expec_pauli_sum(jq, codes, coeffs)
    _near(TK.calc_expec_pauli_sum(q, codes, coeffs), want, rdt,
          np.abs(coeffs).sum())
    for targets, paulis in (((0,), (1,)), ((1, nq - 1), (2, 3)),
                            (tuple(range(nq)), tuple(codes[4]))):
        _near(TK.calc_expec_pauli_prod(q, targets, paulis),
              JK.calc_expec_pauli_prod(jq, targets, paulis), rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density", [False, True])
def test_apply_pauli_sum(rdt, density):
    q, jq = _pair(rdt, density, 8)
    nq = DM if density else SV
    rng = np.random.default_rng(9)
    codes = _codes(rng, 5, nq)
    coeffs = rng.standard_normal(5)
    want = np.asarray(JK.apply_pauli_sum(jq, codes, coeffs).amps)
    before = q.amps.clone()
    out = TK.apply_pauli_sum(q, codes, coeffs)
    assert out is not q and torch.equal(q.amps, before)
    assert np.abs(out.amps.numpy() - want).max() <= TOL[rdt] * np.abs(want).max()


@pytest.mark.parametrize("rdt", DTYPES)
def test_apply_pauli_string_matches_reference(rdt):
    q, _ = _pair(rdt, False, 10)
    planes = q.amps.numpy().copy()
    rng = np.random.default_rng(11)
    for _ in range(6):
        term = tuple(int(c) for c in rng.integers(0, 4, SV))
        want = np.asarray(JA.apply_pauli_string(jnp.asarray(planes), SV, term))
        amps = torch.from_numpy(planes.copy())
        assert TA.apply_pauli_string(amps, SV, term) is amps
        np.testing.assert_array_equal(amps.numpy(), want)


@pytest.mark.parametrize("rdt", DTYPES)
def test_linear_xeb(rdt):
    q, jq = _pair(rdt, False, 12)
    samples = TM.sample(q, 512, torch.Generator().manual_seed(3))
    want = JK.calc_linear_xeb(jq, samples.numpy())
    _near(TK.calc_linear_xeb(q, samples), want, rdt, 1 << SV)
    _near(TK.calc_linear_xeb(q, samples.numpy().tolist()), want, rdt, 1 << SV)


def test_validation_messages():
    q, _ = _pair(np.float32, False, 1)
    r, _ = _pair(np.float32, True, 1)
    small = TS.create_qureg(2, device="cpu")
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_inner_product(q, r)
    assert e.value.code is TV.E.E_DEFINED_ONLY_FOR_STATEVECS
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_inner_product(q, small)
    assert e.value.code is TV.E.E_MISMATCHING_QUREG_DIMENSIONS
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_fidelity(q, r)
    assert e.value.code is TV.E.E_SECOND_ARG_MUST_BE_STATEVEC
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_expec_pauli_sum(q, [[4] * SV], [1.0])
    assert e.value.code is TV.E.E_INVALID_PAULI_CODE
    with pytest.raises(TV.QuESTError, match="one coefficient per term"):
        TK.calc_expec_pauli_sum(q, [[0] * SV], [1.0, 2.0])
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_expec_pauli_prod(q, (0, 1), (1,))
    assert e.value.code is TV.E.E_INVALID_PAULI_CODE
    with pytest.raises(TV.QuESTError) as e:
        TK.calc_linear_xeb(r, [0])
    assert e.value.code is TV.E.E_DEFINED_ONLY_FOR_STATEVECS
