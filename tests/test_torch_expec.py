"""The port's grouped Pauli-sum engine (quest_tpu_torch.ops.expec) against
the reference's (quest_tpu.ops.expec).

Plans equal the reference's group for group and pack for pack (and its
plan_stats and explain text), under the default co-ride budget and a
small QUEST_EXPEC_MAX_MASKS. Values and the operator apply equal the
reference's on the same seeded planes, statevector and density, f32
(2e-5 x scale) and f64 (1e-12 x scale), also with the port's chunk
width cut to a few bits so that flip masks straddle the chunk boundary.
calc_expec_pauli_sum takes the grouped engine by default and the
per-term path under QUEST_EXPEC_FUSION=0, with equal values; the
evaluation is differentiable (gradcheck at f64).
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

from quest_tpu import calculations as JC
from quest_tpu import state as JS
from quest_tpu.ops import expec as JE

from quest_tpu_torch import calculations as K
from quest_tpu_torch import state as TS
from quest_tpu_torch import entry as EN
from quest_tpu_torch import env
from quest_tpu_torch.ops import expec as E

pytestmark = pytest.mark.dtype_agnostic

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


def random_sum(rng, n, terms=14):
    """Random codes with repeated flip masks (so groups hold several
    terms), one all-identity and one all-diagonal term."""
    codes = rng.integers(0, 4, size=(terms, n))
    codes[0] = 0
    codes[1] = np.where(codes[1] == 0, 0, 3)
    codes[terms // 2:] = codes[:terms - terms // 2]
    codes[terms // 2:, 0] = (codes[terms // 2:, 0] + 2) % 4   # X<->Z, Y<->I
    return codes, rng.standard_normal(terms)


def random_planes(rng, n, dt):
    a = rng.standard_normal((2, 1 << n))
    return (a / np.sqrt((a ** 2).sum())).astype(dt)


def registers(a, nq, density):
    """The port's and the reference's register on planes `a`."""
    return (TS.Qureg(amps=torch.from_numpy(a), num_qubits=nq,
                     is_density=density),
            JS.Qureg(amps=jnp.asarray(a), num_qubits=nq, is_density=density))


def plan_key(plan):
    return (plan.n, plan.density, plan.num_terms, plan.sweeps,
            tuple((g.x_bits, tuple((t.index, t.x_bits, t.zy_bits, t.ny)
                                   for t in g.terms)) for g in plan.groups))


@pytest.mark.parametrize("seed,n,density,masks", [
    (0, 5, False, None), (1, 6, False, "2"), (2, 4, True, None),
    (3, 7, False, "1"), (4, 3, True, "3")])
def test_plans_match_reference(seed, n, density, masks, monkeypatch):
    if masks is not None:
        monkeypatch.setenv("QUEST_EXPEC_MAX_MASKS", masks)
    rng = np.random.default_rng(seed)
    codes, _ = random_sum(rng, n, terms=20)
    ref = JE.plan_expec(JE.parse_pauli_sum(codes, n), n, density=density)
    got = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=density)
    assert plan_key(got) == plan_key(ref)
    assert (E.plan_stats(codes, n, density=density)
            == JE.plan_stats(codes, n, density=density))
    assert E.explain(codes, n, density=density) == JE.explain(
        codes, n, density=density)


@pytest.mark.parametrize("x_bits,n", [((), 5), ((0,), 5), ((4, 1), 5),
                                      ((9, 3, 2), 12), ((), 20)])
def test_group_view_and_tables_match_reference(x_bits, n):
    ref = JE._group_view(n, x_bits)
    assert E._group_view(n, x_bits) == ref
    zy = tuple(range(0, n, 3))
    for (a, ta), (b, tb) in zip(E._parity_tables(ref[2], zy, np.float32),
                                JE._parity_tables(ref[2], zy, np.float32)):
        assert a == b and np.array_equal(ta, tb)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("density", [False, True])
def test_values_match_reference(dt, density):
    rng = np.random.default_rng(11)
    nq = 4 if density else 7
    ns = 2 * nq if density else nq
    codes, cf = random_sum(rng, nq)
    a = random_planes(rng, ns, dt)
    ref_plan = JE.plan_expec(JE.parse_pauli_sum(codes, nq), nq,
                             density=density)
    want = float(JE.expec_traced(jnp.asarray(a), jnp.asarray(cf, dt),
                                 ref_plan))
    plan = E.plan_expec(E.parse_pauli_sum(codes, nq), nq, density=density)
    got = float(E.expec_traced(torch.from_numpy(a),
                               torch.from_numpy(cf.astype(dt)), plan))
    assert abs(got - want) <= TOL[dt] * max(1.0, abs(want))
    q, jq = registers(a, nq, density)
    want = JE.expec_value(jq, cf, JE.parse_pauli_sum(codes, nq))
    got = E.expec_value(q, cf, E.parse_pauli_sum(codes, nq))
    assert abs(got - want) <= TOL[dt] * max(1.0, abs(want))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_apply_pauli_sum_planes_matches_reference(dt):
    rng = np.random.default_rng(12)
    n = 7
    codes, cf = random_sum(rng, n)
    a = random_planes(rng, n, dt)
    ref_plan = JE.plan_expec(JE.parse_pauli_sum(codes, n), n, density=False)
    want = np.asarray(JE.apply_pauli_sum_planes(
        jnp.asarray(a), jnp.asarray(cf, dt), ref_plan))
    plan = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=False)
    got = E.apply_pauli_sum_planes(torch.from_numpy(a),
                                   torch.from_numpy(cf.astype(dt)), plan)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dt] * scale,
                               rtol=0)


@pytest.mark.parametrize("chunk_bits", [2, 3, 5])
def test_masks_straddling_the_chunk_boundary(chunk_bits, monkeypatch):
    """Flip masks with bits above and below the chunk width (chunk c read
    against chunk c ^ (x >> C), flipped inside), Y terms whose sign bits
    sit on both sides, and controls of neither: equal to the reference at
    f64, values and the operator apply."""
    monkeypatch.setattr(E, "CHUNK_BITS", chunk_bits)
    n = 8
    codes = np.array([
        [1, 0, 0, 0, 0, 0, 0, 1],      # x = {0, 7}
        [2, 0, 3, 0, 0, 0, 0, 1],      # same mask, Y below, Z mid
        [0, 0, 0, 2, 0, 0, 3, 0],      # x = {3}, Z above
        [3, 0, 0, 0, 2, 0, 2, 0],      # x = {4, 6}
        [0, 1, 0, 0, 0, 1, 0, 0],      # x = {1, 5}
        [3, 3, 0, 0, 0, 0, 3, 3],      # diagonal, bits on both sides
        [0, 0, 0, 0, 0, 0, 0, 2],      # x = {7} alone
        [0] * 8])
    cf = np.linspace(-1.0, 1.3, len(codes))
    rng = np.random.default_rng(chunk_bits)
    a = random_planes(rng, n, np.float64)
    ref_plan = JE.plan_expec(JE.parse_pauli_sum(codes, n), n, density=False)
    plan = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=False)
    want = float(JE.expec_traced(jnp.asarray(a), jnp.asarray(cf), ref_plan))
    got = float(E.expec_traced(torch.from_numpy(a), torch.from_numpy(cf),
                               plan))
    assert abs(got - want) <= 1e-12
    want_ap = np.asarray(JE.apply_pauli_sum_planes(
        jnp.asarray(a), jnp.asarray(cf), ref_plan))
    got_ap = E.apply_pauli_sum_planes(torch.from_numpy(a),
                                      torch.from_numpy(cf), plan)
    np.testing.assert_allclose(got_ap.numpy(), want_ap, atol=1e-12, rtol=0)


@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("fusion", ["1", "0"])
def test_grouped_equals_per_term_under_both_knobs(density, fusion,
                                                  monkeypatch):
    """calc_expec_pauli_sum and calc_expec_pauli_prod run the grouped
    engine under QUEST_EXPEC_FUSION=1 (the default) and the per-term
    program under 0, with values equal to the reference's."""
    rng = np.random.default_rng(21)
    nq = 3 if density else 6
    codes, cf = random_sum(rng, nq)
    a = random_planes(rng, 2 * nq if density else nq, np.float64)
    q, jq = registers(a, nq, density)
    want = JC.calc_expec_pauli_sum(jq, codes, cf)
    calls = []
    monkeypatch.setattr(E, "expec_value", lambda *a, _f=E.expec_value:
                        calls.append(1) or _f(*a))
    if fusion == "0":
        monkeypatch.setenv("QUEST_EXPEC_FUSION", "0")
    got = K.calc_expec_pauli_sum(q, codes, cf)
    prod = K.calc_expec_pauli_prod(q, [0, 1], [1, 3])
    assert len(calls) == (2 if fusion == "1" else 0)
    assert abs(got - want) <= 1e-12
    row = [1, 3] + [0] * (nq - 2)
    assert abs(prod - JC.calc_expec_pauli_sum(jq, [row], [1.0])) <= 1e-12


@pytest.mark.parametrize("density", [False, True])
def test_apply_pauli_sum_matches_reference(density):
    rng = np.random.default_rng(22)
    nq = 3 if density else 6
    codes, cf = random_sum(rng, nq)
    a = random_planes(rng, 2 * nq if density else nq, np.float64)
    q, jq = registers(a, nq, density)
    want = np.asarray(JC.apply_pauli_sum(jq, codes, cf).amps)
    got = K.apply_pauli_sum(q, codes, cf).amps.numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("density", [False, True])
def test_expec_traced_gradcheck(density, monkeypatch):
    """torch.autograd.gradcheck of expec_traced at f64 in the planes and
    the coefficients (with a 2-bit chunk: the chunked path)."""
    monkeypatch.setattr(E, "CHUNK_BITS", 2)
    rng = np.random.default_rng(31)
    nq = 2 if density else 4
    codes, cf = random_sum(rng, nq, terms=8)
    plan = E.plan_expec(E.parse_pauli_sum(codes, nq), nq, density=density)
    a = torch.from_numpy(random_planes(rng, 2 * nq if density else nq,
                                       np.float64)).requires_grad_(True)
    c = torch.from_numpy(cf).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, c: E.expec_traced(a, c, plan), (a, c))
    if not density:
        assert torch.autograd.gradcheck(
            lambda a, c: E.apply_pauli_sum_planes(a, c, plan), (a, c))


def test_batched_reducer_matches_per_state():
    rng = np.random.default_rng(41)
    n = 6
    codes, cf = random_sum(rng, n)
    spec = E.PauliSum.of(codes, cf, n)
    planes = np.stack([random_planes(rng, n, np.float32) for _ in range(5)])
    reduce = E.resolve_observable(spec, n)
    assert reduce is E.resolve_observable((codes, cf), n)
    got = reduce(torch.from_numpy(planes)).numpy()
    plan = JE.plan_expec(JE.parse_pauli_sum(codes, n), n, density=False)
    for b in range(5):
        want = float(JE.expec_traced(jnp.asarray(planes[b]),
                                     jnp.asarray(cf, np.float32), plan))
        assert abs(got[b] - want) <= 2e-5
    with pytest.raises(ValueError, match="qubits"):
        E.resolve_observable(spec, n + 1)
    with pytest.raises(TypeError):
        E.resolve_observable([1, 2], n)
    with pytest.raises(ValueError, match="one coefficient per term"):
        E.PauliSum.of(codes, cf[:-1], n)


def test_goldens_all_diagonal_and_tfim30():
    """An all-diagonal sum is one sweep; TFIM-30 (30 ring ZZ, 30 X) is 2
    sweeps against the per-term model's 120 passes (ref scripts/
    check_expec_golden.py)."""
    diag = np.array([[3, 3, 0, 0], [0, 3, 3, 0], [3, 0, 0, 3], [0, 0, 0, 3]])
    st = E.plan_stats(diag, 4)
    assert st["expec_groups"] == 1 and st["expec_hbm_sweeps"] == 1
    codes, coeffs = EN.tfim_sum(30)
    st = E.plan_stats(codes, 30)
    assert st["expec_hbm_sweeps"] == 2
    assert st["baseline_hbm_sweeps"] == 120
    assert st["terms"] == 60 and st["diagonal_terms"] == 30


def test_bench_sums_equal_the_reference_builders():
    import bench
    for got, want in ((EN.tfim_sum(9), bench._build_tfim_sum(9)),
                      (EN.random_support_sum(30),
                       bench._build_random_support_sum(30))):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_knobs_are_keyed_and_parse_loudly(monkeypatch):
    key = dict(env.engine_mode_key())
    assert key["QUEST_EXPEC_FUSION"] is True
    assert key["QUEST_EXPEC_MAX_MASKS"] == 64
    assert key["QUEST_TROTTER_FUSION"] is True
    assert key["QUEST_ADJOINT"] == "auto"
    for name, bad in (("QUEST_EXPEC_FUSION", "2"),
                      ("QUEST_EXPEC_MAX_MASKS", "0"),
                      ("QUEST_TROTTER_FUSION", "on"),
                      ("QUEST_ADJOINT", "2"), ("QUEST_HBM_BYTES", "16G")):
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError):
            env.knob_value(name)
        monkeypatch.delenv(name)
    monkeypatch.setenv("QUEST_HBM_BYTES", str(1 << 30))
    assert env.hbm_bytes("cpu") == 1 << 30
    monkeypatch.delenv("QUEST_HBM_BYTES")
    with pytest.raises(ValueError, match="QUEST_HBM_BYTES"):
        env.hbm_bytes("cpu")
