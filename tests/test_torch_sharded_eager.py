"""The port's eager QuEST surface on a sharded register
(quest_tpu_torch/parallel/eager.py) against the same calls on one
register and against the JAX package's GSPMD-sharded registers.

Mirrors tests/test_distributed.py:200-303 and widens it to the whole
eager surface: every gate of ops/gates.py (39) and channel of
ops/channels.py (10), the initialisers, setters and getters of state.py,
the calculations and the measurement functions, on meshes of 2, 4 and 8
CPU shards (statevectors of 6 qubits with targets on global qubits,
density registers of 3 qubits whose column-space copies are global).
f32 within 2e-5 x max|amp|, f64 within 1e-12. Every sharded call runs
with ShardedAmps.gather disabled and its mesh's recorder checked: the
state never gathers, and no exchange moves more than one shard. The
reference's sharded calls run on the conftest's 8-device virtual mesh."""

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

import quest_tpu as jqt
from quest_tpu import calculations as JC
from quest_tpu import measurement as JM
from quest_tpu import random_ as JR
from quest_tpu.ops import channels as JCH
from quest_tpu.ops import gates as JG
from quest_tpu.parallel import make_amp_mesh as j_mesh
from quest_tpu.parallel import shard_qureg as j_shard

from quest_tpu_torch import calculations as TC
from quest_tpu_torch import measurement as TM
from quest_tpu_torch import random_ as TR
from quest_tpu_torch import state as TS
from quest_tpu_torch import validation as TV
from quest_tpu_torch.ops import channels as TCH
from quest_tpu_torch.ops import gates as TG
from quest_tpu_torch.parallel import ShardedAmps, make_amp_mesh, shard_qureg

from . import oracle
from .test_torch_gates import CHANNELS, GATES

pytestmark = pytest.mark.dtype_agnostic

TOL = {np.float32: 2e-5, np.float64: 1e-12}
N, ND = 6, 3
MESHES = (2, 4, 8)
# the gate table's qubits (all below 3) moved onto the high qubits of a
# 6-qubit register, so every mesh puts some of them on global qubits
SV_QUBIT = {0: 5, 1: 0, 2: 4}
# arguments that are not qubits: (gate, argument index)
NOT_QUBITS = {("multi_state_controlled_unitary", 1),
              ("multi_rotate_pauli", 1), ("apply_pauli_prod", 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_gather(monkeypatch):
    """A sharded eager call must never gather its register."""
    def refuse(self, device=None):
        raise AssertionError("an eager function gathered a sharded register")
    monkeypatch.setattr(ShardedAmps, "gather", refuse)


def _dense(q):
    """The register's state for comparison: a sharded one's shards
    concatenated on the host here (the test's own view, not the port's
    gather)."""
    amps = q.amps
    if isinstance(amps, ShardedAmps):
        planes = np.concatenate([s.numpy() for s in amps.shards], axis=-1)
    elif isinstance(amps, torch.Tensor):
        planes = amps.numpy()
    else:
        planes = np.asarray(amps)
    return planes.reshape(2, -1)


def _mesh(d):
    return make_amp_mesh(d, devices=["cpu"] * d)


def _cdt(rdt):
    return np.complex64 if rdt == np.float32 else np.complex128


def _planes(density, rdt, seed=20):
    rng = np.random.default_rng(seed)
    if density:
        rho = oracle.random_density(ND, rng)
        v = rho.reshape(-1, order="F")
    else:
        v = oracle.random_statevector(N, rng)
    return np.stack([v.real, v.imag]).astype(rdt)


def _port(density, rdt, mesh=None, seed=20):
    make = TS.create_density_qureg if density else TS.create_qureg
    q = make(ND if density else N, dtype=_cdt(rdt), device="cpu")
    q.amps.copy_(torch.from_numpy(_planes(density, rdt, seed)))
    return shard_qureg(q, mesh) if mesh is not None else q


def _ref(density, rdt, sharded=True, seed=20):
    make = jqt.create_density_qureg if density else jqt.create_qureg
    q = make(ND if density else N, dtype=_cdt(rdt))
    q = q.replace_amps(jnp.asarray(_planes(density, rdt, seed)))
    return j_shard(q, j_mesh(8)) if sharded else q


def _close(got, want, rdt):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL[rdt] * scale


def _check_recorder(q):
    m = 1 << q.amps.local_n
    for kind, elems, _b, _g in q.amps.mesh.recorder.events:
        assert kind in ("cp", "reduce"), kind
        assert elems <= 2 * m


def _sv_args(name, args):
    out = []
    for i, a in enumerate(args):
        if (name, i) in NOT_QUBITS:
            out.append(a)
        elif isinstance(a, (int, np.integer)) and not isinstance(a, bool):
            out.append(SV_QUBIT[int(a)])
        elif (isinstance(a, list) and a
              and all(isinstance(x, int) for x in a)):
            out.append([SV_QUBIT[x] for x in a])
        else:
            out.append(a)
    return tuple(out)


def _gate_cases():
    cases = []
    for name, args in GATES:
        for density in (False, True):
            cases.append(pytest.param(name, args, density, np.float32,
                                      id=f"{name}-{'dm' if density else 'sv'}"))
    for name, args in GATES[:6] + GATES[27:29]:
        cases.append(pytest.param(name, args, False, np.float64,
                                  id=f"{name}-sv-f64"))
    return cases


@pytest.mark.parametrize("name,args,density,rdt", _gate_cases())
def test_eager_gate_on_sharded_register(name, args, density, rdt):
    """Every gate on 2, 4 and 8 shards equals the call on one register,
    in place, and the reference's call on its 8-device sharded register;
    no exchange moves more than one shard."""
    if not density:
        args = _sv_args(name, args)
    one = getattr(TG, name)(_port(density, rdt), *args)
    for d in MESHES:
        q = _port(density, rdt, _mesh(d))
        q.amps.mesh.recorder.reset()
        out = getattr(TG, name)(q, *args)
        assert out is q and isinstance(q.amps, ShardedAmps)
        _close(_dense(q), _dense(one), rdt)
        _check_recorder(q)
    if rdt == np.float32:
        ref = getattr(JG, name)(_ref(density, rdt), *args)
        _close(_dense(one), _dense(ref), rdt)


@pytest.mark.parametrize("name,args", CHANNELS + [("mix_density_matrix",
                                                   (0.3,))],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_eager_channel_on_sharded_register(name, args):
    rdt = np.float32
    jargs = args
    if name == "mix_density_matrix":
        args = args + (None,)
        jargs = (0.3, _ref(True, rdt, seed=21))
    one_args = args[:-1] + (_port(True, rdt, seed=21),) \
        if name == "mix_density_matrix" else args
    one = getattr(TCH, name)(_port(True, rdt), *one_args)
    targets = [a for a in args if isinstance(a, int)]
    if name == "mix_multi_qubit_kraus_map":
        targets = args[0]
    for d in MESHES:
        mesh = _mesh(d)
        q = _port(True, rdt, mesh)
        a = (args[:-1] + (_port(True, rdt, mesh, seed=21),)
             if name == "mix_density_matrix" else args)
        if (name not in ("mix_dephasing", "mix_two_qubit_dephasing",
                         "mix_density_matrix")
                and 2 * len(targets) > q.amps.local_n):
            # a superoperator wider than a shard cannot run distributed
            # (the reference QuEST's E_CANNOT_FIT_MULTI_QUBIT_MATRIX)
            with pytest.raises(TV.QuESTError, match="cannot fit"):
                getattr(TCH, name)(q, *a)
            continue
        assert getattr(TCH, name)(q, *a) is q
        _close(_dense(q), _dense(one), rdt)
        _check_recorder(q)
    ref = getattr(JCH, name)(_ref(True, rdt), *jargs)
    _close(_dense(one), _dense(ref), rdt)


# -- the reference's own sharded cases (test_distributed.py:200-303) ---------


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_eager_gspmd_on_sharded_register(rdt):
    for d in MESHES:
        q = TS.init_debug_state(shard_qureg(
            TS.create_qureg(N, dtype=_cdt(rdt), device="cpu"), _mesh(d)))
        q = TG.hadamard(q, 5)
        q = TG.controlled_not(q, 5, 0)
        q = TG.multi_rotate_z(q, (3, 5), 0.5)
        r = jqt.init_debug_state(j_shard(jqt.create_qureg(
            N, dtype=_cdt(rdt)), j_mesh(8)))
        r = JG.hadamard(r, 5)
        r = JG.controlled_not(r, 5, 0)
        r = JG.multi_rotate_z(r, (3, 5), 0.5)
        _close(_dense(q), _dense(r), rdt)


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_distributed_reductions(rdt):
    tol = 1e-12 if rdt == np.float64 else 1e-6
    for d in MESHES:
        mesh = _mesh(d)
        q = TS.init_plus_state(shard_qureg(
            TS.create_qureg(N, dtype=_cdt(rdt), device="cpu"), mesh))
        assert isinstance(q.amps, ShardedAmps)
        assert abs(TC.calc_total_prob(q) - 1.0) < tol
        assert abs(TM.calc_prob_of_outcome(q, 5, 0) - 0.5) < tol
        q2 = TS.init_plus_state(shard_qureg(
            TS.create_qureg(N, dtype=_cdt(rdt), device="cpu"), mesh))
        assert abs(TC.calc_inner_product(q, q2) - 1.0) < tol
        reduces = [e for e in mesh.recorder.events if e[0] == "reduce"]
        assert len(reduces) == 3          # one AmpMesh.reduce a call


def _sharded_density(mesh, rdt, seed):
    return _port(True, rdt, mesh, seed), _ref(True, rdt, seed=seed)


@pytest.mark.parametrize("target", range(ND))
def test_sharded_damping_channel(target):
    for d in MESHES:
        q, r = _sharded_density(_mesh(d), np.float32, 5)
        _close(_dense(TCH.mix_damping(q, target, 0.3)),
               _dense(JCH.mix_damping(r, target, 0.3)), np.float32)


def test_sharded_channels_suite():
    kraus = oracle.random_kraus_map(1, 2, np.random.default_rng(3))
    for d in MESHES:
        q, r = _sharded_density(_mesh(d), np.float64, 6)
        for f, g in ((TCH.mix_dephasing, JCH.mix_dephasing),):
            q, r = f(q, 1, 0.2), g(r, 1, 0.2)
        q, r = (TCH.mix_depolarising(q, 2, 0.3),
                JCH.mix_depolarising(r, 2, 0.3))
        q, r = (TCH.mix_two_qubit_dephasing(q, 0, 2, 0.4),
                JCH.mix_two_qubit_dephasing(r, 0, 2, 0.4))
        q, r = TCH.mix_kraus_map(q, 0, kraus), JCH.mix_kraus_map(r, 0, kraus)
        _close(_dense(q), _dense(r), np.float64)


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_sharded_measurement_and_collapse(rdt):
    for d in MESHES:
        q1, q2 = _port(False, rdt, seed=7), _port(False, rdt, _mesh(d), 7)
        r = _ref(False, rdt, seed=7)
        for qubit in (0, N - 1):            # local and global
            p1 = TM.calc_prob_of_outcome(q1, qubit, 1)
            p2 = TM.calc_prob_of_outcome(q2, qubit, 1)
            pr = JM.calc_prob_of_outcome(r, qubit, 1)
            assert p2 == pytest.approx(p1, abs=TOL[rdt])
            assert p2 == pytest.approx(pr, abs=TOL[rdt])
        c1, prob1 = TM.collapse_to_outcome(q1, N - 1, 0)
        c2, prob2 = TM.collapse_to_outcome(q2, N - 1, 0)
        cr, probr = JM.collapse_to_outcome(r, N - 1, 0)
        assert prob2 == pytest.approx(prob1, abs=TOL[rdt])
        assert prob2 == pytest.approx(probr, abs=TOL[rdt])
        _close(_dense(c2), _dense(c1), rdt)
        _close(_dense(c2), _dense(cr), rdt)
        # a seeded measurement draws the same outcome on both layouts and
        # the reference's (its native stream, seed for seed)
        for qubit in (0, N - 1):
            TR.seed_quest([11])
            _, o1, s1 = TM.measure_with_stats(c1, qubit)
            TR.seed_quest([11])
            _, o2, s2 = TM.measure_with_stats(c2, qubit)
            JR.seed_quest([11])
            cr, o3 = JM.measure(cr, qubit)
            assert o1 == o2 == o3
            assert s2 == pytest.approx(s1, abs=TOL[rdt])
            _close(_dense(c2), _dense(c1), rdt)


def test_measure_functional_and_density_measurement_sharded():
    for d in MESHES:
        mesh = _mesh(d)
        for density in (False, True):
            a = _port(density, np.float64, seed=9)
            b = _port(density, np.float64, mesh, seed=9)
            for qubit in range(ND):
                ga = torch.Generator().manual_seed(qubit)
                gb = torch.Generator().manual_seed(qubit)
                _, oa, pa = TM.measure_functional(a, qubit, ga)
                _, ob, pb = TM.measure_functional(b, qubit, gb)
                assert oa == ob and pa == pytest.approx(pb, abs=1e-12)
                _close(_dense(b), _dense(a), np.float64)


# -- initialisers, setters and getters (state.py) ----------------------------


@pytest.mark.parametrize("density", [False, True])
def test_initialisers_setters_and_getters_sharded(density):
    rdt = np.float64
    nq = ND if density else N
    make = TS.create_density_qureg if density else TS.create_qureg
    jmake = jqt.create_density_qureg if density else jqt.create_qureg
    pure = TS.init_debug_state(TS.create_qureg(ND, dtype=np.complex128,
                                               device="cpu"))
    jpure = jqt.init_debug_state(jqt.create_qureg(ND, dtype=np.complex128))
    calls = [
        (TS.init_zero_state, jqt.init_zero_state, ()),
        (TS.init_plus_state, jqt.init_plus_state, ()),
        (TS.init_classical_state, jqt.init_classical_state, (5,)),
        (TS.init_debug_state, jqt.init_debug_state, ()),
        (TS.init_blank_state, jqt.init_blank_state, ()),
    ]
    if not density:
        calls.append((TS.init_state_of_single_qubit,
                      jqt.state.init_state_of_single_qubit, (5, 1)))
        calls.append((TS.init_state_of_single_qubit,
                      jqt.state.init_state_of_single_qubit, (1, 0)))
    for d in MESHES:
        mesh = _mesh(d)
        for tf, jf, args in calls:
            q = tf(shard_qureg(make(nq, dtype=np.complex128, device="cpu"),
                               mesh), *args)
            assert isinstance(q.amps, ShardedAmps)
            _close(_dense(q), _dense(jf(jmake(nq, dtype=np.complex128),
                                        *args)), rdt)
        if density:
            q = TS.init_pure_state(shard_qureg(make(nq, dtype=np.complex128,
                                                    device="cpu"), mesh),
                                   pure)
            _close(_dense(q), _dense(jqt.init_pure_state(
                jmake(nq, dtype=np.complex128), jpure)), rdt)
        # setters write the owning shards; getters read them
        rng = np.random.default_rng(d)
        vals = rng.standard_normal((2, 13))
        q = shard_qureg(make(nq, dtype=np.complex128, device="cpu"), mesh)
        one = make(nq, dtype=np.complex128, device="cpu")
        if density:
            TS.set_density_amps(q, 3, 2, vals[0], vals[1])
            TS.set_density_amps(one, 3, 2, vals[0], vals[1])
            assert TS.get_density_amp(q, 3, 2) == TS.get_density_amp(one, 3, 2)
            assert (TS.get_density_amp(q, 7, 7)
                    == TS.get_density_amp(one, 7, 7))
        else:
            TS.set_amps(q, 27, vals[0], vals[1])
            TS.set_amps(one, 27, vals[0], vals[1])
            for i in (0, 27, 31, 32, 39, 63):
                assert TS.get_amp(q, i) == TS.get_amp(one, i)
        np.testing.assert_array_equal(_dense(q), _dense(one))
        full = rng.standard_normal((2, one.num_amps))
        TS.init_state_from_amps(q, full[0], full[1])
        TS.init_state_from_amps(one, full[0], full[1])
        np.testing.assert_array_equal(_dense(q), _dense(one))
        c = TS.clone(q)
        assert isinstance(c.amps, ShardedAmps)
        c.amps.shards[0].zero_()
        np.testing.assert_array_equal(_dense(q), _dense(one))


def test_to_dense_is_the_explicit_gather(monkeypatch):
    monkeypatch.undo()                       # gather allowed here
    q = TS.init_debug_state(shard_qureg(TS.create_qureg(N, device="cpu"),
                                        _mesh(4)))
    one = TS.init_debug_state(TS.create_qureg(N, device="cpu"))
    np.testing.assert_array_equal(TS.to_dense(q), TS.to_dense(one))


# -- calculations -------------------------------------------------------------


@pytest.mark.parametrize("rdt", [np.float32, np.float64])
def test_calculations_on_sharded_registers(rdt):
    codes = np.array([[1, 0, 3, 0, 2, 1], [3, 3, 0, 0, 0, 3],
                      [2, 2, 0, 1, 0, 0], [0, 0, 0, 0, 0, 0]])
    cf = np.array([0.4, -1.2, 0.7, 0.3])
    dcodes = codes[:, :ND]
    for d in MESHES:
        mesh = _mesh(d)
        a, b = _port(False, rdt, seed=1), _port(False, rdt, seed=2)
        sa, sb = _port(False, rdt, mesh, 1), _port(False, rdt, mesh, 2)
        ra, rb = _ref(False, rdt, seed=1), _ref(False, rdt, seed=2)
        for tf, jf in ((TC.calc_inner_product, JC.calc_inner_product),
                       (TC.calc_fidelity, JC.calc_fidelity)):
            want = jf(ra, rb)
            assert tf(sa, sb) == pytest.approx(tf(a, b), abs=TOL[rdt])
            assert tf(sa, sb) == pytest.approx(want, abs=TOL[rdt])
        assert TC.calc_total_prob(sa) == pytest.approx(
            JC.calc_total_prob(ra), abs=TOL[rdt])
        assert TC.calc_expec_pauli_sum(sa, codes, cf) == pytest.approx(
            JC.calc_expec_pauli_sum(ra, codes, cf), abs=TOL[rdt])
        assert TC.calc_expec_pauli_prod(sa, [0, 4, 5], [1, 2, 3]) == \
            pytest.approx(JC.calc_expec_pauli_prod(ra, [0, 4, 5], [1, 2, 3]),
                          abs=TOL[rdt])
        out = TC.apply_pauli_sum(sa, codes, cf)
        assert isinstance(out.amps, ShardedAmps)
        _close(_dense(out), _dense(JC.apply_pauli_sum(ra, codes, cf)), rdt)
        samples = [0, 5, 33, 63, 40]
        assert TC.calc_linear_xeb(sa, samples) == pytest.approx(
            TC.calc_linear_xeb(a, samples), abs=1e-6)
        # density
        p, q = _port(True, rdt, seed=3), _port(True, rdt, seed=4)
        sp, sq = _port(True, rdt, mesh, 3), _port(True, rdt, mesh, 4)
        rp, rq = _ref(True, rdt, seed=3), _ref(True, rdt, seed=4)
        pure, rpure = _port(False, rdt, seed=5), _ref(False, rdt, seed=5)
        pure3 = TS.init_debug_state(TS.create_qureg(ND, dtype=_cdt(rdt),
                                                    device="cpu"))
        rpure3 = jqt.init_debug_state(jqt.create_qureg(ND, dtype=_cdt(rdt)))
        del pure, rpure
        checks = [
            (TC.calc_purity(sp), JC.calc_purity(rp)),
            (TC.calc_total_prob(sp), JC.calc_total_prob(rp)),
            (TC.calc_density_inner_product(sp, sq),
             JC.calc_density_inner_product(rp, rq)),
            (TC.calc_hilbert_schmidt_distance(sp, sq),
             JC.calc_hilbert_schmidt_distance(rp, rq)),
            (TC.calc_fidelity(sp, pure3), JC.calc_fidelity(rp, rpure3)),
            (TC.calc_expec_pauli_sum(sp, dcodes, cf),
             JC.calc_expec_pauli_sum(rp, dcodes, cf)),
            (TC.calc_expec_pauli_prod(sp, [0, 2], [2, 1]),
             JC.calc_expec_pauli_prod(rp, [0, 2], [2, 1])),
        ]
        scale = 10.0 if rdt == np.float32 else 1.0
        for got, want in checks:
            assert got == pytest.approx(want, abs=scale * TOL[rdt])
        assert TC.calc_purity(sp) == pytest.approx(TC.calc_purity(p),
                                                   abs=TOL[rdt])
        del q


def test_weighted_sum_and_mixed_layouts():
    for d in MESHES:
        mesh = _mesh(d)
        facs = (0.5 - 0.2j, 1.5j, -0.25 + 0.1j)
        a, b, o = (_port(False, np.float64, seed=s) for s in (1, 2, 3))
        sa, sb, so = (_port(False, np.float64, mesh, s) for s in (1, 2, 3))
        TG.set_weighted_qureg(facs[0], a, facs[1], b, facs[2], o)
        TG.set_weighted_qureg(facs[0], sa, facs[1], sb, facs[2], so)
        _close(_dense(so), _dense(o), np.float64)
        # a register on one device meets a sharded one as its slices
        assert TC.calc_inner_product(sa, b) == pytest.approx(
            TC.calc_inner_product(a, b), abs=1e-12)
        so2 = _port(False, np.float64, mesh, 3)
        TG.set_weighted_qureg(facs[0], a, facs[1], sb, facs[2], so2)
        _close(_dense(so2), _dense(o), np.float64)
        # ... but an output on one device, or two meshes, are refused
        with pytest.raises(TV.QuESTError, match="setWeightedQureg"):
            TG.set_weighted_qureg(1.0, a, 1.0, sb, 0.0,
                                  _port(False, np.float64, seed=3))
        other = make_amp_mesh(d, devices=["cpu"] * (d - 1) + ["meta"])
        with pytest.raises(TV.QuESTError, match="calcInnerProduct"):
            TC.calc_inner_product(sa, shard_qureg(
                _port(False, np.float64, seed=2), _mesh(d)).replace_amps(
                    ShardedAmps(sb.amps.shards, other, N)))


def test_density_split_column_is_refused_typed():
    """A density register whose columns a shard splits (2^N < mesh size)
    raises a typed error naming the function, never AttributeError."""
    q = shard_qureg(TS.init_plus_state(TS.create_density_qureg(
        2, device="cpu")), _mesh(8))
    for call, name in ((lambda: TC.calc_total_prob(q), "calcTotalProb"),
                       (lambda: TM.calc_prob_of_outcome(q, 0, 0),
                        "calcProbOfOutcome"),
                       (lambda: TM.sample(q, 4), "sample")):
        with pytest.raises(TV.QuESTError, match=name):
            call()


@pytest.mark.parametrize("method", ["apply", "apply_banded", "apply_fused"])
def test_circuit_apply_on_a_sharded_register(method):
    """Circuit.apply / apply_banded / apply_fused on a sharded register run
    the sharded engines on its own mesh, never gathering it."""
    from quest_tpu_torch.circuit import random_circuit
    c = random_circuit(N, 3, seed=2)
    one = getattr(c, method)(_port(False, np.float64))
    for d in MESHES:
        q = _port(False, np.float64, _mesh(d))
        out = getattr(c, method)(q)
        assert isinstance(out.amps, ShardedAmps)
        _close(_dense(out), _dense(one), np.float64)
