"""The port's ops/apply primitives against quest_tpu.ops.apply.

Each primitive of quest_tpu_torch/ops/apply.py — norm_control_states,
control_mask, parity_sign, apply_matrix (any number of targets),
apply_matrix_rows, apply_band, apply_diagonal, apply_parity_phase and
apply_phase_on_all_ones — is run on seeded numpy inputs (f32 and f64
planes, n from 3 to 12, one state or a batch) beside the JAX function
on the same inputs, within 2e-5 x max|amp| at f32 and 1e-12 x max|amp|
at f64. The port's primitives update the planes in place; each case
checks that too. CHUNK_AMPS is lowered where a case needs several
chunks. Also: float64 operands bypass the matmul tiers."""

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

from quest_tpu.ops import apply as JA

from quest_tpu_torch import precision as P
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import apply as TA

from . import oracle

pytestmark = pytest.mark.dtype_agnostic

DTYPES = [np.float32, np.float64]
TOL = {np.float32: 2e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _planes(n, rdt, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (2, 1 << n) if batch is None else (batch, 2, 1 << n)
    return rng.standard_normal(shape).astype(rdt)


def _matrix(k, seed, real=False, unitary=True):
    rng = np.random.default_rng(seed)
    if unitary:
        m = oracle.random_unitary(k, rng)
        return m.real.astype(np.complex128) if real else m
    m = rng.standard_normal((1 << k, 1 << k))
    return m if real else m + 1j * rng.standard_normal((1 << k, 1 << k))


def _assert_close(got, want, rdt):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL[rdt] * scale, rtol=0)


def _port(fn, planes, *args, **kwargs):
    amps = torch.from_numpy(planes.copy())
    out = fn(amps, *args, **kwargs)
    assert out is amps                      # in place
    return out.numpy()


def _pair(m, rdt):
    return (np.ascontiguousarray(m.real, dtype=rdt),
            np.ascontiguousarray(m.imag, dtype=rdt))


# ---------------------------------------------------------------------------
# control states, masks, parity signs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("controls,states", [((), ()), ((2,), ()),
                                             ((0, 3), (1, 0)),
                                             ((4, 1, 2), (0, 1, 0))])
def test_control_helpers_match_reference(controls, states):
    assert (TA.norm_control_states(controls, states)
            == JA.norm_control_states(controls, states))
    n = 6
    dims, axis_of = TA.bit_view(n, controls)
    jdims, jaxis_of = JA.seg_view(n, tuple(sorted(controls, reverse=True)))
    assert tuple(dims) == jdims and axis_of == jaxis_of
    mask = TA.control_mask(len(dims), axis_of, controls, states)
    want = JA.control_mask(len(dims), axis_of, controls, states)
    if want is None:
        assert mask is None
    else:
        np.testing.assert_array_equal(
            np.broadcast_to(mask.numpy(), dims),
            np.broadcast_to(np.asarray(want), dims))
    sign = TA.parity_sign(len(dims), axis_of, controls, torch.float64)
    jsign = JA.parity_sign(len(dims), axis_of, controls, jnp.float64)
    if jsign is None:
        assert sign is None
    else:
        np.testing.assert_array_equal(np.broadcast_to(sign.numpy(), dims),
                                      np.broadcast_to(np.asarray(jsign), dims))


def test_control_states_of_the_wrong_length_raise():
    with pytest.raises(TV.QuESTError, match="one bit per control"):
        TA.norm_control_states((1, 2), (1,))
    with pytest.raises(TV.QuESTError):
        TA.apply_matrix(torch.zeros(2, 16), 4, np.eye(2), (0,), (1, 2), (1,))


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------

# (n, targets, controls, control states, real operator): k = 1..6 targets,
# adjacent and scattered, 0-3 controls of mixed states
MATRIX_CASES = [
    (3, (1,), (), (), False),
    (3, (0, 2), (1,), (0,), False),
    (5, (4,), (0, 2), (1, 0), True),
    (6, (3, 1), (), (), True),
    (7, (0, 1, 2), (5,), (1,), False),
    (8, (6, 2, 4), (0, 7, 3), (0, 1, 1), False),
    (9, (1, 2, 3, 4), (), (), False),
    (10, (8, 0, 5, 3), (9, 1), (1, 0), True),
    (7, (0, 1, 2, 3, 4), (), (), False),
    (8, (0, 2, 4, 6, 7), (1, 5), (1, 0), False),
    (9, (8, 1, 5, 3, 0), (2, 4, 7), (0, 1, 1), True),
    (6, (0, 1, 2, 3, 4, 5), (), (), False),
    (12, (11, 0, 6, 3, 9, 7), (1, 10), (1, 1), False),
]


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("case", MATRIX_CASES)
def test_apply_matrix_matches_reference(case, rdt, monkeypatch):
    n, targets, controls, states, real = case
    m = _matrix(len(targets), seed=n + 7 * len(targets), real=real)
    planes = _planes(n, rdt, seed=n)
    want = np.asarray(JA.apply_matrix(jnp.asarray(planes), n, _pair(m, rdt),
                                      targets, controls, states))
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << max(1, n - 4))  # 4+ chunks
    got = _port(TA.apply_matrix, planes, n, m, targets, controls, states)
    assert got.dtype == rdt
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("targets,controls", [((2, 0), (4,)),
                                              ((5, 1, 3, 0, 2), ()),
                                              ((0, 1, 2, 3, 4, 6), (5,))])
def test_apply_matrix_on_a_batch_matches_vmapped_reference(targets, controls,
                                                           rdt):
    n, b = 7, 3
    m = _matrix(len(targets), seed=len(targets), unitary=False)
    planes = _planes(n, rdt, seed=11, batch=b)
    want = np.asarray(jax.vmap(lambda a: JA.apply_matrix(
        a, n, _pair(m, rdt), targets, controls))(jnp.asarray(planes)))
    got = _port(TA.apply_matrix, planes, n, m, targets, controls)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("targets,controls,states", [
    ((0, 3, 7, 9, 11), (), ()), ((10, 2, 8, 5, 1, 7), (0, 11), (0, 1))])
def test_wide_apply_matrix_rows_matches_reference(targets, controls, states,
                                                  rdt):
    """k > 4 on the fused view: the same view path as any k, in place on
    the (2, 2^(n-7), 128) planes, dtype following the planes."""
    n = 12
    m = _matrix(len(targets), seed=sum(targets))
    planes = _planes(n, rdt, seed=5).reshape(2, -1, 128)
    want = np.asarray(JA.apply_matrix_rows(jnp.asarray(planes), n,
                                           _pair(m, rdt), targets, controls,
                                           states))
    got = _port(TA.apply_matrix_rows, planes, n, m, targets, controls, states)
    assert got.shape == planes.shape and got.dtype == rdt
    _assert_close(got, want, rdt)


# ---------------------------------------------------------------------------
# bands
# ---------------------------------------------------------------------------

# (n, ql, w, preds, real operator): bands at the bottom, middle and top,
# predicates below and above the band, on both
BAND_CASES = [
    (3, 0, 3, (), False),
    (5, 1, 2, ((0, 1),), False),
    (7, 0, 7, (), True),
    (9, 2, 4, ((0, 0), (8, 1)), False),
    (10, 3, 7, ((1, 1),), True),
    (11, 0, 7, ((9, 0), (7, 1)), False),
    (12, 7, 5, ((2, 1), (3, 0), (6, 1)), False),
    (12, 5, 7, (), False),
]


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("case", BAND_CASES)
def test_apply_band_matches_reference(case, rdt, monkeypatch):
    n, ql, w, preds, real = case
    g = _matrix(w, seed=3 * n + w, real=real, unitary=w < 6)
    planes = _planes(n, rdt, seed=2 * n)
    want = np.asarray(JA.apply_band(jnp.asarray(planes), n, _pair(g, rdt),
                                    ql, w, preds))
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << max(1, n - 3))
    got = _port(TA.apply_band, planes, n, g, ql, w, preds)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
def test_apply_band_on_a_batch_matches_vmapped_reference(rdt):
    n, b, ql, w, preds = 9, 4, 2, 5, ((0, 1), (8, 0))
    g = _matrix(w, seed=9)
    planes = _planes(n, rdt, seed=12, batch=b)
    want = np.asarray(jax.vmap(lambda a: JA.apply_band(
        a, n, _pair(g, rdt), ql, w, preds))(jnp.asarray(planes)))
    got = _port(TA.apply_band, planes, n, (g.real, g.imag), ql, w, preds)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("tier", ["high", "default"])
def test_f64_bands_and_matrices_bypass_the_tiers(tier):
    """At 'high' and 'default' a float64 contraction is the float64
    product, bit for bit the 'highest' one: no bf16 split, no f32."""
    n = 9
    g = _matrix(4, seed=1)
    planes = _planes(n, np.float64, seed=3)
    for fn, args in ((TA.apply_band, (g, 2, 4, ((0, 1),))),
                     (TA.apply_matrix, (g, (1, 8, 3, 5), (0,)))):
        a = _port(fn, planes, n, *args, tier="highest")
        b = _port(fn, planes, n, *args, tier=tier)
        assert b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 5)))
    y = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 7)))
    out = P.tier_matmul(x, y, tier)
    assert out.dtype == torch.float64 and torch.equal(out, torch.matmul(x, y))
    with pytest.raises(TypeError):
        P.split_hi_lo(x)


def test_precision_helpers_follow_the_reference():
    from quest_tpu import precision as JP
    for d in (np.complex64, np.complex128, np.float32, np.float64):
        assert P.real_eps(d) == JP.real_eps(d)
    assert P.accum_dtype(np.float32) == JP.accum_dtype(np.float32)


# ---------------------------------------------------------------------------
# diagonals, parity phases, all-ones phases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n,targets,controls,states,real", [
    (3, (2,), (), (), True),
    (5, (0, 3), (4,), (0,), False),
    (8, (6, 1, 4), (0, 7), (1, 0), False),
    (12, (11, 0, 5, 8), (2, 3, 9), (1, 1, 0), False),
])
def test_apply_diagonal_matches_reference(n, targets, controls, states, real,
                                          rdt, monkeypatch):
    rng = np.random.default_rng(n)
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << len(targets)))
    d = np.sign(d.real) if real else d
    planes = _planes(n, rdt, seed=n + 1)
    want = np.asarray(JA.apply_diagonal(jnp.asarray(planes), n,
                                        _pair(np.asarray(d), rdt), targets,
                                        controls, states))
    monkeypatch.setattr(TA, "CHUNK_AMPS", 1 << max(1, n - 3))
    got = _port(TA.apply_diagonal, planes, n, d, targets, controls, states)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n,targets,angle", [(3, (1,), 0.7),
                                             (6, (5, 0), -1.3),
                                             (10, (2, 9, 4), 2.9),
                                             (12, (0, 7, 11, 3, 6), 0.45)])
def test_apply_parity_phase_matches_reference(n, targets, angle, rdt):
    planes = _planes(n, rdt, seed=3 * n)
    want = np.asarray(JA.apply_parity_phase(jnp.asarray(planes), n, targets,
                                            angle))
    got = _port(TA.apply_parity_phase, planes, n, targets, angle)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
@pytest.mark.parametrize("n,qubits,term", [(3, (0, 2), -1.0 + 0.0j),
                                           (7, (6,), np.exp(0.3j)),
                                           (11, (1, 10, 4), np.exp(-2.1j))])
def test_apply_phase_on_all_ones_matches_reference(n, qubits, term, rdt):
    planes = _planes(n, rdt, seed=n + 5)
    want = np.asarray(JA.apply_phase_on_all_ones(
        jnp.asarray(planes), n, qubits,
        (np.asarray(term.real, rdt), np.asarray(term.imag, rdt))))
    got = _port(TA.apply_phase_on_all_ones, planes, n, qubits, term)
    _assert_close(got, want, rdt)


@pytest.mark.parametrize("rdt", DTYPES)
def test_elementwise_primitives_on_a_batch(rdt):
    n, b = 8, 3
    planes = _planes(n, rdt, seed=21, batch=b)
    d = np.exp(1j * np.arange(4.0))
    want = np.asarray(jax.vmap(lambda a: JA.apply_parity_phase(
        JA.apply_diagonal(a, n, _pair(d, rdt), (1, 6), (3,)), n, (0, 7),
        0.9))(jnp.asarray(planes)))
    amps = torch.from_numpy(planes.copy())
    TA.apply_diagonal(amps, n, d, (1, 6), (3,))
    TA.apply_parity_phase(amps, n, (0, 7), 0.9)
    _assert_close(amps.numpy(), want, rdt)
