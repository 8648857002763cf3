"""The port's comm planner (quest_tpu_torch/parallel/comm.py) against the
JAX package's, exactly.

The planner is host math ported line for line, so its outputs must be
the reference's, value for value: `comm_stats` of every predicted
exchange list, `choose_plan`'s chosen op stream and its record (strategy,
every candidate's cost, the topology), `coalesce` / `coalesce_clusters`
op streams, `effective_slices`, the topology resolution and the knobs'
error messages, and the plan IR's comm record (`plan_stats(devices=)`,
`sharded.comm_plan_record`) — on the circuits of tests/test_comm.py and
tests/test_topology.py (the deep-global testbed, random circuits), over
2, 4 and 8 shards, flat and under hosts=2, and the 40-qubit,
256-device record of tests/test_pod_scale.py as pure math. The helpers
here (op keys, circuit pairs) serve the other sharded test modules."""

import contextlib

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from bench import _build_deep_global_circuit
from quest_tpu import circuit as JC
from quest_tpu import env as JE
from quest_tpu.ops import fusion as JF
from quest_tpu.parallel import comm as JCM
from quest_tpu.parallel import sharded as JS

from quest_tpu_torch import circuit as TC
from quest_tpu_torch import env as TE
from quest_tpu_torch.ops import fusion as TF
from quest_tpu_torch.parallel import comm as TCM
from quest_tpu_torch.parallel import sharded as TS

pytestmark = pytest.mark.dtype_agnostic

N = 6
DEPTH = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


# -- helpers shared by the sharded test modules ------------------------------

def deep_global_circuit(n: int, depth: int) -> TC.Circuit:
    """bench._build_deep_global_circuit on the port's Circuit, draw for
    draw: every layer rotates every qubit (rx, ry) and entangles with
    czs."""
    rng = np.random.default_rng(5)
    c = TC.Circuit(n)
    for _ in range(depth):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
            c.ry(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(0, n - 1, 2):
            c.cz(q, q + 1)
    return c


def to_reference(tc) -> JC.Circuit:
    """The same op list as a quest_tpu Circuit."""
    jc = JC.Circuit(tc.num_qubits)
    for op in tc.ops:
        if op.kind == "classical":
            inners, conds = op.operand
            operand = (tuple(JC.GateOp(g.kind, g.targets, g.controls,
                                       g.cstates, g.operand, g.meta)
                             for g in inners), conds)
        else:
            operand = op.operand
        jc.ops.append(JC.GateOp(op.kind, op.targets, op.controls, op.cstates,
                                operand, op.meta))
    return jc


def op_key(op):
    """An op's value, comparable across the two packages."""
    operand = op.operand
    if op.kind == "relabel":
        val = tuple(int(s) for s in operand)
    else:
        arr = np.asarray(operand)
        val = (arr.shape, arr.dtype.str, arr.tobytes())
    parts = getattr(op, "parts", None)
    return (type(op).__name__, op.kind, tuple(op.targets),
            tuple(op.controls), tuple(op.cstates or ()), val,
            op.meta if isinstance(op.meta, tuple) else None,
            tuple(parts) if parts else None)


def assert_ops_equal(ref, port):
    assert [op_key(o) for o in ref] == [op_key(o) for o in port]


def circuit_cases():
    """(name, port circuit, n): the planner's circuits."""
    return [("deep_global", deep_global_circuit(N, DEPTH), N),
            ("deep_global_d3", deep_global_circuit(N, 3), N),
            ("rcs_s3", TC.random_circuit(N, 5, seed=3), N),
            ("rcs_s11", TC.random_circuit(N, 5, seed=11), N),
            ("rcs10", TC.random_circuit(10, 4, seed=3), 10),
            ("cnot8", TC.random_circuit(8, 4, seed=2, entangler="cnot"), 8)]


def flats(tc, n, scheduled=True):
    """(reference flat list, port flat list) of a port circuit."""
    jc = to_reference(tc)
    jf = JC.flatten_ops(jc.ops, n, False)
    tf = TC.flatten_ops(tc.ops, n, False)
    if scheduled:
        jf, tf = JF.maybe_schedule(jf, n), TF.maybe_schedule(tf, n)
    return jf, tf


def test_deep_global_circuit_is_the_bench_circuit():
    assert_ops_equal(_build_deep_global_circuit(N, DEPTH).ops,
                     deep_global_circuit(N, DEPTH).ops)


# -- the planner, record for record ------------------------------------------

def _info(info):
    return {k: v for k, v in info.items() if k != "items"}


@pytest.mark.parametrize("case", circuit_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("engine", ["pergate", "banded"])
def test_choose_plan_equals_reference(case, g, engine):
    _, tc, n = case
    local_n = n - g
    jf, tf = flats(tc, n, scheduled=engine != "pergate")
    kw = {}
    if engine == "banded":
        kw = dict(bands=TS._shard_bands(n, local_n))
        assert kw["bands"] == JS._shard_bands(n, local_n)
    jchosen, jinfo = JCM.choose_plan(jf, n, local_n, engine=engine, **kw)
    tchosen, tinfo = TCM.choose_plan(tf, n, local_n, engine=engine, **kw)
    assert _info(tinfo) == _info(jinfo)
    assert_ops_equal(jchosen, tchosen)
    # comm_stats of the chosen plan's predicted schedule, at f32 and f64
    if engine == "pergate":
        jex = JCM.predict_exchanges_flat(jchosen, local_n)
        tex = TCM.predict_exchanges_flat(tchosen, local_n)
    else:
        jex = JCM.predict_exchanges_items(JF.plan(jchosen, n, **kw), local_n)
        tex = TCM.predict_exchanges_items(TF.plan(tchosen, n, **kw), local_n)
    assert tex == jex
    for bpr in (4, 8):
        assert (TCM.comm_stats(tex, num_devices=1 << g, bytes_per_real=bpr)
                == JCM.comm_stats(jex, num_devices=1 << g,
                                  bytes_per_real=bpr))


@pytest.mark.parametrize("case", circuit_cases()[:3], ids=lambda c: c[0])
@pytest.mark.parametrize("local_n", [3, 4])
def test_coalesce_streams_equal_reference(case, local_n):
    _, tc, n = case
    jf, tf = flats(tc, n)
    assert_ops_equal(JCM.coalesce(jf, n, local_n), TCM.coalesce(tf, n,
                                                                 local_n))
    for hosts in (2, 4):
        jt, tt = JCM.Topology(hosts=hosts), TCM.Topology(hosts=hosts)
        assert_ops_equal(JCM.coalesce(jf, n, local_n, topo=jt),
                         TCM.coalesce(tf, n, local_n, topo=tt))
        assert_ops_equal(JCM.coalesce_clusters(jf, n, local_n, jt),
                         TCM.coalesce_clusters(tf, n, local_n, tt))


def test_coalesce_rejects_dynamic_ops():
    c = TC.Circuit(3).h(0)
    c.measure(0)
    flat = TC.flatten_ops(c.ops, 3, False)
    with pytest.raises(ValueError, match="static circuits only"):
        TCM.coalesce(flat, 3, 2)


def test_hier_plan_pins_the_topology_goldens():
    """tests/test_topology.py's goldens through the port: flat 6
    exchanges / 384 B DCI share under hosts=2, the cluster plan 2 DCI
    exchanges / 192 B, and both candidates' records equal."""
    _, tf = flats(deep_global_circuit(N, DEPTH), N)
    jf, _ = flats(deep_global_circuit(N, DEPTH), N)
    local_n = N - 3
    bands = TS._shard_bands(N, local_n)
    topo = TCM.Topology(hosts=2)

    def stats(lst):
        items = TF.plan(lst, N, bands=bands)
        return TCM.comm_stats(
            TCM.predict_exchanges_items(items, local_n, topo.ici_bits(8)),
            num_devices=8, bytes_per_real=8, topo=topo)
    flat_plan, _ = TCM.choose_plan(tf, N, local_n, engine="banded",
                                   bands=bands, topo=TCM.FLAT)
    hier_plan, info = TCM.choose_plan(tf, N, local_n, engine="banded",
                                      bands=bands, topo=topo)
    _, jinfo = JCM.choose_plan(jf, N, local_n, engine="banded", bands=bands,
                               topo=JCM.Topology(hosts=2))
    assert _info(info) == _info(jinfo) and info["strategy"] == "hier"
    assert (stats(flat_plan)["comm_dci_bytes"],
            stats(flat_plan)["comm_dci_exchanges"]) == (384, 6)
    assert (stats(hier_plan)["comm_dci_bytes"],
            stats(hier_plan)["comm_dci_exchanges"]) == (192, 2)


# -- slicing, topology and the knobs -----------------------------------------

@pytest.mark.parametrize("slices,dci", [("1", None), ("16", None),
                                        ("2", "8"), ("4", "0")])
def test_effective_slices_equal_reference(slices, dci, monkeypatch):
    monkeypatch.setenv("QUEST_EXCHANGE_SLICES", slices)
    if dci is not None:
        monkeypatch.setenv("QUEST_EXCHANGE_SLICES_DCI", dci)
    for x in (1, 4, 8, 64, 1 << 20):
        for link in ("ici", "dci"):
            assert (TCM.effective_slices(x, link)
                    == JCM.effective_slices(x, link))


@pytest.mark.parametrize("raw", ["0", "hosts=2", "hosts=4,ici=1,dci=8",
                                 "hosts=2,dci=2.5"])
def test_topology_resolution_equals_reference(raw, monkeypatch):
    monkeypatch.setenv("QUEST_COMM_TOPOLOGY", raw)
    for d in (2, 4, 8, 256):
        t, j = TCM.topology(d), JCM.topology(d)
        assert (t.hosts, t.ici, t.dci) == (j.hosts, j.ici, j.dci)
        assert t.describe(d) == j.describe(d)
        for bit in (None, 0, 1, 2):
            assert t.link_of(bit, d) == j.link_of(bit, d)


def test_topology_unset_is_flat_for_one_process(monkeypatch):
    monkeypatch.delenv("QUEST_COMM_TOPOLOGY", raising=False)
    assert TCM.topology(8) == TCM.FLAT


@pytest.mark.parametrize("name,raw", [
    ("QUEST_COMM_PLAN", "2"), ("QUEST_EXCHANGE_SLICES", "3"),
    ("QUEST_EXCHANGE_SLICES", "x"), ("QUEST_EXCHANGE_SLICES", "2048"),
    ("QUEST_EXCHANGE_SLICES_DCI", "3"), ("QUEST_EXCHANGE_SLICES_DCI", "-1"),
    ("QUEST_COMM_TOPOLOGY", "hosts=three"), ("QUEST_COMM_TOPOLOGY", "2"),
    ("QUEST_COMM_TOPOLOGY", "hosts=3"), ("QUEST_COMM_TOPOLOGY", "ici=2"),
    ("QUEST_COMM_TOPOLOGY", "hosts=2,foo=1"),
    ("QUEST_COMM_TOPOLOGY", "hosts=2,dci=0")])
def test_knob_errors_are_the_reference_messages(name, raw, monkeypatch):
    monkeypatch.setenv(name, raw)
    with pytest.raises(ValueError) as ref:
        JE.knob_value(name)
    with pytest.raises(ValueError) as port:
        TE.knob_value(name)
    assert str(port.value) == str(ref.value)


def test_knobs_are_keyed_with_the_reference_defaults(monkeypatch):
    for name in ("QUEST_COMM_PLAN", "QUEST_EXCHANGE_SLICES",
                 "QUEST_EXCHANGE_SLICES_DCI", "QUEST_COMM_TOPOLOGY"):
        monkeypatch.delenv(name, raising=False)
        assert TE.knob_value(name) == JE.knob_value(name)
        assert TE.KNOBS[name].scope == "keyed"
    monkeypatch.setenv("QUEST_EXCHANGE_SLICES", "4")
    assert ("QUEST_EXCHANGE_SLICES", 4) in TE.engine_mode_key()


# -- the plan IR's comm record -----------------------------------------------

@pytest.mark.parametrize("case", circuit_cases()[:5], ids=lambda c: c[0])
@pytest.mark.parametrize("devices", [2, 4, 8])
@pytest.mark.parametrize("topology", [None, "hosts=2,ici=1,dci=4"])
def test_comm_plan_record_equals_reference(case, devices, topology,
                                           monkeypatch):
    if topology is not None:
        monkeypatch.setenv("QUEST_COMM_TOPOLOGY", topology)
    _, tc, n = case
    want = JS.comm_plan_record(to_reference(tc).ops, n, False, devices)
    assert TS.comm_plan_record(tc.ops, n, False, devices) == want
    assert tc._comm_plan_stats(n, False, devices) == want


@pytest.mark.parametrize("topology", [None, "hosts=2,ici=1,dci=4"])
def test_plan_stats_comm_record_equals_reference(topology, monkeypatch):
    if topology is not None:
        monkeypatch.setenv("QUEST_COMM_TOPOLOGY", topology)
    tc = deep_global_circuit(N, DEPTH)
    want = to_reference(tc).plan_stats(devices=8)["comm"]
    assert tc.plan_stats(devices=8)["comm"] == want


def test_plan_stats_comm_record_density_and_knob_off(monkeypatch):
    tc = TC.Circuit(3).h(2).damping(2, 0.2).cnot(0, 2).depolarising(1, 0.1)
    assert (TS.comm_plan_record(tc.ops, 6, True, 4)
            == JS.comm_plan_record(to_reference(tc).ops, 6, True, 4))
    monkeypatch.setenv("QUEST_COMM_PLAN", "0")
    c = deep_global_circuit(N, 3)
    assert (TS.comm_plan_record(c.ops, N, False, 8)
            == JS.comm_plan_record(to_reference(c).ops, N, False, 8))
    with pytest.raises(ValueError, match="power of two"):
        c.plan_stats(devices=3)


def test_pod_scale_record_is_pure_math():
    """The 40-qubit, 256-device record (tests/test_pod_scale.py's shape,
    on the host): equal to the reference's, relabel events firing."""
    tc = TC.random_circuit(40, 2, seed=7)
    want = JS.comm_plan_record(to_reference(tc).ops, 40, False, 256)
    got = TS.comm_plan_record(tc.ops, 40, False, 256)
    assert got == want and got["relabel_events"] > 0
