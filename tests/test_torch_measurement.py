"""The port's measurement layer against the JAX package.

quest_tpu_torch.measurement and random_ on the CPU beside
quest_tpu.measurement and quest_tpu.random_, from seeded numpy states
(f32 within 2e-5 x max|amp|, f64 within 1e-12): P(qubit = 0) and
collapse on statevector and density registers; the traced measurement
given the reference's own uniforms (jax.random.uniform of the key the
reference draws from), outcomes equal wherever the uniform lies more
than 1e-5 from its threshold; sampling given the reference's uniforms,
the same index for every shot more than 1e-6 from both neighbouring
reference CDF entries and at most one apart otherwise; the blocked CDF at
2^16 and 2^20 (monotone, within a few ulps of an f64 scan); the seeded
host stream bit for bit, and measure_with_stats's outcome stream under
equal seeds."""

import contextlib
import re

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

from quest_tpu import measurement as JM
from quest_tpu import native as JN
from quest_tpu import random_ as JR
from quest_tpu import state as JS
from quest_tpu import validation as JV
from quest_tpu.validation import MESSAGES as JMESSAGES

from quest_tpu_torch import convert
from quest_tpu_torch import measurement as TM
from quest_tpu_torch import random_ as TR
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV

pytestmark = pytest.mark.dtype_agnostic

DTYPES = [np.float32, np.float64]
TOL = {np.float32: 2e-5, np.float64: 1e-12}
THRESHOLD_GAP = 1e-5      # a draw this close to its threshold is not compared


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _state(n, rdt, seed):
    """(2, 2^n) planes of a random normalised state."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    return np.stack([v.real, v.imag]).astype(rdt)


def _density(nq, rdt, seed):
    """(2, 4^nq) planes of a random mixed state (column-major flat)."""
    rng = np.random.default_rng(seed)
    dim = 1 << nq
    g = rng.standard_normal((dim, dim)) + 1j * rng.standard_normal((dim, dim))
    rho = g @ g.conj().T
    rho /= np.trace(rho).real
    flat = rho.reshape(-1, order="F")
    return np.stack([flat.real, flat.imag]).astype(rdt)


def _close(got, want, rdt):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(np.asarray(got) - want).max() <= TOL[rdt] * scale


CASES = [(False, 6), (True, 3)]      # (density, qubits)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density,nq", CASES)
def test_prob_of_zero_and_collapse(rdt, density, nq):
    n = 2 * nq if density else nq
    planes = (_density if density else _state)(nq, rdt, 11)
    for qubit in range(nq):
        want = float(JM._prob_of_zero(jnp.asarray(planes), n=n, qubit=qubit,
                                      density=density))
        got = TM._prob_of_zero(torch.from_numpy(planes.copy()), n=n,
                               qubit=qubit, density=density)
        assert abs(got - want) <= TOL[rdt]
        for outcome in (0, 1):
            prob = want if outcome == 0 else 1 - want
            ref = JM._collapse(jnp.asarray(planes), jnp.asarray(outcome),
                               jnp.asarray(prob, dtype=rdt), n=n, qubit=qubit,
                               density=density)
            amps = torch.from_numpy(planes.copy())
            out = TM._collapse(amps, outcome, prob, n=n, qubit=qubit,
                               density=density)
            assert out is amps
            _close(out.numpy(), ref, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density,nq", CASES)
def test_calc_prob_and_collapse_to_outcome(rdt, density, nq):
    planes = (_density if density else _state)(nq, rdt, 5)
    cdt = np.complex64 if rdt == np.float32 else np.complex128
    jq = (JS.create_density_qureg if density else JS.create_qureg)(nq, dtype=cdt)
    jq = jq.replace_amps(jnp.asarray(planes))
    tq = (TS.create_density_qureg if density else TS.create_qureg)(
        nq, dtype=cdt, device="cpu")
    tq.amps.copy_(torch.from_numpy(planes))
    for qubit in (0, nq - 1):
        for outcome in (0, 1):
            assert abs(TM.calc_prob_of_outcome(tq, qubit, outcome)
                       - JM.calc_prob_of_outcome(jq, qubit, outcome)) <= TOL[rdt]
    jq2, jp = JM.collapse_to_outcome(jq, 1, 1)
    tq2, tp = TM.collapse_to_outcome(tq, 1, 1)
    assert tq2 is tq and abs(tp - jp) <= TOL[rdt]
    _close(tq.amps.numpy(), jq2.amps, rdt)


def _raises_reference(code_name):
    """pytest.raises for the port's QuESTError carrying `code_name` and
    the reference's message for it, verbatim."""
    return pytest.raises(TV.QuESTError, match="^" + re.escape(
        JMESSAGES[JV.ErrorCode[code_name]]) + "$")


def test_validation_messages():
    q = TS.create_qureg(2, device="cpu")
    with _raises_reference("E_INVALID_QUBIT_OUTCOME"):
        TM.calc_prob_of_outcome(q, 0, 2)
    with _raises_reference("E_COLLAPSE_STATE_ZERO_PROB"):
        TM.collapse_to_outcome(q, 0, 1)          # |00>: P(q0 = 1) = 0
    with _raises_reference("E_INVALID_TARGET_QUBIT"):
        TM.calc_prob_of_outcome(q, 2, 0)
    with pytest.raises(TV.QuESTError, match="shots"):
        TM.sample(q, 0)


def _reference_uniform(key, rdt):
    return float(jax.random.uniform(key, dtype=jnp.dtype(rdt)))


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density,nq", CASES)
def test_measure_given_reference_uniforms(rdt, density, nq):
    n = 2 * nq if density else nq
    planes = (_density if density else _state)(nq, rdt, 23)
    compared = 0
    for s in range(12):
        key = jax.random.PRNGKey(s)
        qubit = s % nq
        new, oc, prob = JM._measure_traced(jnp.asarray(planes), key, n=n,
                                           qubit=qubit, density=density)
        u = _reference_uniform(key, rdt)
        amps = torch.from_numpy(planes.copy())
        p0 = TM._prob_of_zero(amps, n=n, qubit=qubit, density=density)
        outcome, tp = TM._measure_given_uniform(amps, u, n=n, qubit=qubit,
                                                density=density)
        if abs(u - p0) < THRESHOLD_GAP:
            continue
        compared += 1
        assert outcome == int(oc)
        assert abs(tp - float(prob)) <= TOL[rdt]
        _close(amps.numpy(), new, rdt)
    assert compared >= 10


def test_forced_outcomes_below_eps():
    """A branch below REAL_EPS is never drawn, whatever the uniform."""
    for rdt in DTYPES:
        planes = np.zeros((2, 4), rdt)
        planes[0, 0] = 1.0                    # |00>: P(q0 = 0) = 1
        for u in (0.0, 0.5, 0.999999):
            amps = torch.from_numpy(planes.copy())
            assert TM._measure_given_uniform(amps, u, n=2, qubit=0,
                                             density=False)[0] == 0
        planes = np.zeros((2, 4), rdt)
        planes[0, 1] = 1.0                    # |01>: P(q0 = 0) = 0
        amps = torch.from_numpy(planes.copy())
        assert TM._measure_given_uniform(amps, 0.0, n=2, qubit=0,
                                         density=False)[0] == 1


def _check_samples(got, want, cdf, scaled):
    """Equal indices where the scaled uniform is more than 1e-6 from both
    neighbouring reference CDF entries; at most one apart elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    cdf = np.asarray(cdf, dtype=np.float64)
    scaled = np.asarray(scaled, dtype=np.float64)
    lo = cdf[np.clip(want - 1, 0, len(cdf) - 1)]
    hi = cdf[np.clip(want, 0, len(cdf) - 1)]
    clear = (np.abs(scaled - lo) > 1e-6) & (np.abs(scaled - hi) > 1e-6)
    assert np.array_equal(got[clear], want[clear])
    assert np.abs(got - want).max() <= 1
    return int(clear.sum())


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density,nq", [(False, 12), (False, 16), (True, 6)])
def test_sample_given_reference_uniforms(rdt, density, nq):
    n = 2 * nq if density else nq
    planes = (_density if density else _state)(nq, rdt, 31)
    shots = 4096
    key = jax.random.PRNGKey(9)
    want = JM._sample_traced(jnp.asarray(planes), key, n=n, density=density,
                             num_shots=shots)
    u = jax.random.uniform(key, (shots,), dtype=jnp.dtype(rdt))
    if density:
        dim = 1 << nq
        probs = jnp.diagonal(jnp.asarray(planes[0]).reshape(dim, dim))
    else:
        probs = jnp.asarray(planes[0] ** 2 + planes[1] ** 2)
    cdf = JM._stable_cdf(probs)
    got = TM._sample_given_uniforms(torch.from_numpy(planes.copy()),
                                    torch.from_numpy(np.array(u)), n=n,
                                    density=density)
    assert got.dtype == torch.int64 and got.shape == (shots,)
    # most shots are clear of the 1e-6 windows: the check is not vacuous
    assert _check_samples(got.numpy(), want, cdf, u * cdf[-1]) > shots // 2


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("k", [16, 20])
def test_stable_cdf(rdt, k):
    rng = np.random.default_rng(k)
    p = rng.exponential(size=1 << k)
    p = (p / p.sum()).astype(rdt)
    exact = np.cumsum(p.astype(np.float64))
    got = TM._stable_cdf(torch.from_numpy(p.copy())).numpy()
    ref = np.asarray(JM._stable_cdf(jnp.asarray(p)))
    assert got.dtype == rdt
    assert np.all(np.diff(got) >= 0)
    # f32 planes carry the blocks in f64: a few ulps of the plane dtype;
    # f64 planes have no wider accumulator, so the within-block drift of
    # ~sqrt(N) additions stays
    ulp = np.finfo(rdt).eps
    bound = 4 * ulp * (1 if rdt == np.float32 else np.sqrt(len(p)))
    assert np.abs(got - exact).max() <= bound
    assert np.abs(ref - exact).max() <= bound
    inplace = torch.from_numpy(p.copy())
    assert TM._stable_cdf(inplace, inplace=True) is inplace
    assert np.array_equal(inplace.numpy(), got)


def test_sample_draws_from_generator_and_host_stream():
    q = convert.qureg_from_numpy(_state(10, np.float32, 2), device="cpu")
    a = TM.sample(q, 1000, torch.Generator().manual_seed(4))
    b = TM.sample(q, 1000, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (1000,)
    TR.seed_quest([7, 8])
    c = TM.sample(q, 1000)
    TR.seed_quest([7, 8])
    assert torch.equal(c, TM.sample(q, 1000))
    # the register is not collapsed
    assert abs(float((q.amps.double() ** 2).sum()) - 1.0) < 1e-6


def _reference_library(monkeypatch) -> bool:
    """Whether the JAX package's native mt19937ar loads in this process,
    its load retried once. The package builds its library with `make -C
    native` at first use and, when that build fails, draws numpy's
    MT19937 (another stream) for the rest of the process. Test workers
    that build it at once can fail: each `make` links the same temporary
    file and renames it, and a worker whose rename finds the file gone
    fails its build although the library is there a moment later. The
    retry loads the library a peer built."""
    if not JN.available():
        monkeypatch.setattr(JN, "_lib_tried", False)
    return JN.available()


def _python_mt19937ar(key):
    """uniform() of mt19937ar's stream for init_by_array(key), drawn in
    Python: the port's own Python generator state (random_._init_by_array)
    in a RandomState of its own, genrand_real1 of each 32-bit word."""
    rs = np.random.RandomState()
    rs.set_state(("MT19937", TR._init_by_array(key), 624, 0, 0.0))
    return lambda: int(rs.randint(0, 1 << 32, dtype=np.uint64)) * (
        1.0 / 4294967295.0)


def test_random_stream_bit_equal_to_reference(monkeypatch):
    assert _reference_library(monkeypatch), \
        "the JAX package's native library does not load"
    # one-word keys too (numpy would seed those through init_genrand),
    # and a key longer than the 624-word state
    for seeds in ([12345, 6789], [0], [7], [2**32 - 1, 3, 5],
                  list(range(700))):
        JR.seed_quest(seeds)
        TR.seed_quest(seeds)
        for _ in range(5):
            assert TR.uniform() == JR.uniform()
            assert TR.uint32() == JR.uint32()


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("density,nq", CASES)
def test_measure_with_stats_stream_matches_reference(rdt, density, nq,
                                                    monkeypatch):
    """Outcomes and probabilities of the port's measure_with_stats equal
    the JAX package's under equal seeds, both on mt19937ar's stream. Where
    the package's native library does not load it draws numpy's MT19937,
    another stream; its `uniform` then reads the same mt19937ar words from
    Python, so the two packages still draw alike."""
    native_ok = _reference_library(monkeypatch)
    planes = (_density if density else _state)(nq, rdt, 41)
    cdt = np.complex64 if rdt == np.float32 else np.complex128
    jq = (JS.create_density_qureg if density else JS.create_qureg)(
        nq, dtype=cdt).replace_amps(jnp.asarray(planes))
    tq = (TS.create_density_qureg if density else TS.create_qureg)(
        nq, dtype=cdt, device="cpu")
    tq.amps.copy_(torch.from_numpy(planes))
    JR.seed_quest([2026, 11])
    TR.seed_quest([2026, 11])
    assert JR._use_native == native_ok
    if not native_ok:
        monkeypatch.setattr(JR, "uniform", _python_mt19937ar([2026, 11]))
    for qubit in list(range(nq)) * 2:
        jq, jo, jp = JM.measure_with_stats(jq, qubit)
        tq, to, tp = TM.measure_with_stats(tq, qubit)
        assert to == jo and abs(tp - jp) <= TOL[rdt]
    _close(tq.amps.numpy(), jq.amps, rdt)
    tq, to = TM.measure(tq, 0)
    assert to in (0, 1)


def test_measure_functional_uses_generator():
    planes = _state(5, np.float32, 3)
    outs = []
    for _ in range(2):
        q = convert.qureg_from_numpy(planes, device="cpu")
        q, oc, prob = TM.measure_functional(q, 2, torch.Generator().manual_seed(1))
        outs.append((oc, prob, q.amps.clone()))
    assert outs[0][:2] == outs[1][:2]
    assert torch.equal(outs[0][2], outs[1][2])
    assert abs(float((outs[0][2].double() ** 2).sum()) - 1.0) < 1e-5
