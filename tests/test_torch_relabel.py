"""The port's relabel passes (quest_tpu_torch/parallel/relabel.py) against
the JAX package's, exactly, and the relabel event on the shards.

`plan_full_relabels` (flat and hot-qubit victims under hosts=2) and
`lazy_relabel_ops` rewrite the op streams of tests/test_lazy_relabel.py
and tests/test_comm.py into the reference's streams op for op;
`replay_perm` replays every prefix to the reference's permutation;
`canonicalize_planes` / `physicalize_planes` equal the reference's and
round-trip bit for bit; `reject_dynamic_ops` and `_PermTracker.restore`
keep their invariants. The relabel event itself (sharded._relabel_op,
one all-to-all through the mesh, shards that share the CPU) is bit for
bit the index permutation it claims, against a host oracle, as
tests/test_lazy_relabel.py holds the reference's."""

import numpy as np
import pytest
import torch

from quest_tpu import circuit as JC
from quest_tpu.parallel import comm as JCM
from quest_tpu.parallel import relabel as JR

from quest_tpu_torch import circuit as TC
from quest_tpu_torch.parallel import comm as TCM
from quest_tpu_torch.parallel import relabel as TR
from quest_tpu_torch.parallel import sharded as TS
from quest_tpu_torch.parallel.mesh import make_amp_mesh

from .test_torch_comm import (_one_thread_per_worker, assert_ops_equal,  # noqa: F401
                              deep_global_circuit, flats, to_reference)

pytestmark = pytest.mark.dtype_agnostic


def _cases():
    return [("deep13", deep_global_circuit(13, 4), 13, (10, 11)),
            ("deep6", deep_global_circuit(6, 3), 6, (3, 4)),
            ("rcs6", TC.random_circuit(6, 5, seed=3), 6, (3, 4, 5)),
            ("cnot9", TC.random_circuit(9, 3, seed=1, entangler="cnot"), 9,
             (6, 7))]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_plan_full_relabels_equals_reference(case):
    _, tc, n, locals_ = case
    for scheduled in (False, True):
        jf, tf = flats(tc, n, scheduled)
        for local_n in locals_:
            jo = JR.plan_full_relabels(jf, n, local_n)
            to = TR.plan_full_relabels(tf, n, local_n)
            assert_ops_equal(jo, to)
            jh = JR.plan_full_relabels(jf, n, local_n,
                                       topo=JCM.Topology(hosts=2))
            th = TR.plan_full_relabels(tf, n, local_n,
                                       topo=TCM.Topology(hosts=2))
            assert_ops_equal(jh, th)
            for i in range(0, len(to) + 1, max(1, len(to) // 7)):
                assert (TR.replay_perm(to[:i], n, local_n)
                        == JR.replay_perm(jo[:i], n, local_n))


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_lazy_relabel_ops_equals_reference(case):
    _, tc, n, locals_ = case
    jf, tf = flats(tc, n, scheduled=False)
    for local_n in locals_ + (n,):
        jo = JR.lazy_relabel_ops(jf, n, local_n)
        to = TR.lazy_relabel_ops(tf, n, local_n)
        assert_ops_equal(jo, to)
        assert ([TR.is_inserted_layout_op(op) for op in to]
                == [JR.is_inserted_layout_op(op) for op in jo])


def test_full_relabel_invariants():
    """tests/test_lazy_relabel.py's planner invariants on the port:
    events carry g distinct local slots, the stream ends in standard
    order, local-only circuits and too-small chunks come back as they
    were."""
    n, local_n = 13, 10
    g = n - local_n
    flat = TC.flatten_ops(deep_global_circuit(n, 4).ops, n, False)
    out = TR.plan_full_relabels(flat, n, local_n)
    events = [op for op in out if op.kind == "relabel"]
    assert events
    for ev in events:
        assert len(ev.operand) == g == len(set(ev.operand))
        assert all(0 <= s < local_n for s in ev.operand)
    assert TR.replay_perm(out, n, local_n) == list(range(n))
    local = TC.Circuit(n)
    for q in range(local_n):
        local.rx(q, 0.1 * (q + 1))
    flat2 = TC.flatten_ops(local.ops, n, False)
    assert TR.plan_full_relabels(flat2, n, local_n) == list(flat2)
    assert TR.plan_full_relabels(flat, n, g - 1) == list(flat)


def test_reject_dynamic_ops_message():
    c = TC.Circuit(3).h(0)
    c.measure(0)
    flat = TC.flatten_ops(c.ops, 3, False)
    with pytest.raises(ValueError) as port:
        TR.reject_dynamic_ops(flat, "plan_full_relabels")
    jflat = JC.flatten_ops(to_reference(c).ops, 3, False)
    with pytest.raises(ValueError) as ref:
        JR.reject_dynamic_ops(jflat, "plan_full_relabels")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("perm", [[0, 1, 2, 3, 4, 5], [5, 0, 3, 1, 4, 2],
                                  [2, 1, 0, 5, 4, 3]])
def test_canonical_planes_equal_reference_and_round_trip(perm):
    planes = np.random.default_rng(3).standard_normal(
        (2, 1 << len(perm))).astype(np.float32)
    got = TR.canonicalize_planes(planes, perm)
    assert np.array_equal(got, JR.canonicalize_planes(planes, perm))
    back = TR.physicalize_planes(got, perm)
    assert np.array_equal(back, JR.physicalize_planes(got, perm))
    assert np.array_equal(back, planes)


def test_perm_tracker_restore_returns_home():
    n, local_n = 8, 5
    out = []
    tr = TR._PermTracker(n, local_n, out)
    tr.emit_relabel([4, 0, 2])
    tr.emit_swap(1, 3)
    tr.emit_relabel([1, 3, 4])
    tr.restore()
    assert tr.perm == list(range(n))
    assert TR.replay_perm(out, n, local_n) == list(range(n))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_relabel_event_matches_bit_swap_oracle(shards):
    """One all-to-all over shards sharing the CPU: new device bit j :=
    old local bit slots[j], new slot bit := old device bit, bit for bit
    (unsorted slots, so the device-bit to slot pairing matters)."""
    g = shards.bit_length() - 1
    n = g + 5
    local_n = n - g
    mesh = make_amp_mesh(shards, devices=["cpu"] * shards)
    rng = np.random.default_rng(0)
    full = rng.standard_normal((2, 1 << n)).astype(np.float32)
    slots = tuple(int(s) for s in rng.permutation(local_n)[:g])
    x = torch.from_numpy(full.copy()).view(2, shards, -1)
    xs = [x[:, d].contiguous().view(1, 2, -1) for d in range(shards)]
    TS._relabel_op(xs, mesh, local_n, slots)
    got = torch.cat([s.view(2, -1) for s in xs], dim=1).numpy()
    want = np.empty_like(full)
    for idx in range(1 << n):
        src = idx
        for j, sl in enumerate(slots):
            bg = (idx >> (local_n + j)) & 1
            bl = (idx >> sl) & 1
            src &= ~((1 << (local_n + j)) | (1 << sl))
            src |= (bl << (local_n + j)) | (bg << sl)
        want[:, idx] = full[:, src]
    assert np.array_equal(got, want)
    ev = mesh.recorder.events
    assert [(k, e, b) for k, e, b, _ in ev] == [
        ("a2a", 2 << local_n, 4 * (2 << local_n) * (shards - 1) // shards)]
