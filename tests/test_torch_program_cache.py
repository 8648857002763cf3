"""The port's program cache, the builders A4 adds, and `explain`.

Programs are cached on their circuit, keyed on their arguments, the
device and `_engine_mode_key()` (every keyed knob's effective value):
repeated apply_fused / apply_batched / apply_banded / apply calls plan
once; each keyed-knob flip (and set_matmul_precision) builds a new
program that carries the new setting, and flipping back finds the old
one; adding an op clears the cache; a cached program still refuses a
register on another device. `program_key` follows the reference's
equality rules (quest_tpu/circuit.py:1448). The builders inverse,
multi_rotate_z, multi_rotate_pauli and sqrt_swap emit the reference's
op lists and, run on 5, 11 and 13 qubits, its states (its per-gate
program at 5, its banded program above; f32 within 2e-5 x max|amp|).
`explain` prints the reference's header, scheduler, sweep, segment and
total lines under TPU_GEOMETRY, and an estimate from the H100 cost
model."""

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import circuit as JC

from quest_tpu_torch import circuit as TC
from quest_tpu_torch import env, precision
from quest_tpu_torch import state as TS
from quest_tpu_torch import trajectories as T
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.validation import QuESTError

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture
def plans(monkeypatch):
    """Counts of the planner calls: fused_plan (fused engine) and
    banded_items (banded engine)."""
    counts = {"fused": 0, "banded": 0}
    fused, banded = Circuit.fused_plan, Circuit.banded_items

    def counted_fused(self, *a, **k):
        counts["fused"] += 1
        return fused(self, *a, **k)

    def counted_banded(self, *a, **k):
        counts["banded"] += 1
        return banded(self, *a, **k)
    monkeypatch.setattr(Circuit, "fused_plan", counted_fused)
    monkeypatch.setattr(Circuit, "banded_items", counted_banded)
    return counts


def test_repeated_apply_plans_once(plans):
    n = 12
    c = random_circuit(n, 3, seed=2)
    q = TS.create_qureg(n, device="cpu")
    ref = TS.clone(q)
    once = c.compiled_fused(n, device="cpu")
    for _ in range(5):
        c.apply_fused(q)
        once(ref.amps)
    assert plans["fused"] == 1
    assert torch.equal(q.amps, ref.amps)
    batch = torch.zeros((4, 2, 1 << n))
    batch[:, 0, 0] = 1.0
    for _ in range(3):
        c.apply_batched(batch)
    assert plans["fused"] == 1            # the batched program is the fused one
    banded = plans["banded"]              # fused_plan plans its bands too
    for _ in range(3):
        c.apply_banded(q)
    assert plans["banded"] == banded + 1
    assert c.compiled(n, device="cpu") is c.compiled(n, device="cpu")
    small = random_circuit(6, 2, seed=1)
    q6 = TS.create_qureg(6, device="cpu")
    for _ in range(3):
        small.apply(q6)
        small.apply_fused(q6)             # below the kernel: the banded one
    assert plans["banded"] == banded + 2


KEYED = [("QUEST_MATMUL_PRECISION", "high", "tier", "high"),
         ("QUEST_FUSED_DRIVER", "grid", "driver", "grid"),
         ("QUEST_FUSED_PIPELINE", "0", "driver", "inplace"),
         ("QUEST_FUSED_NBUF", "2", "nbuf", 2),
         ("QUEST_SCHEDULE", "0", None, None),
         ("QUEST_SWEEP_FUSION", "0", None, None),
         ("QUEST_APPLY_AUTOROUTE", "0", None, None)]


@pytest.mark.parametrize("knob,value,attr,want", KEYED,
                         ids=[k[0] for k in KEYED])
def test_keyed_knob_flip_builds_a_new_program(monkeypatch, plans, knob,
                                              value, attr, want):
    n = 12
    c = random_circuit(n, 2, seed=3)
    first = c.compiled_fused(n, device="cpu")
    monkeypatch.setenv(knob, value)
    assert (knob, env.knob_value(knob)) in env.engine_mode_key()
    flipped = c.compiled_fused(n, device="cpu")
    assert flipped is not first and plans["fused"] == 2
    if attr is not None:
        assert getattr(flipped, attr) == want
    assert c.compiled_fused(n, device="cpu") is flipped
    monkeypatch.delenv(knob)
    assert c.compiled_fused(n, device="cpu") is first
    assert plans["fused"] == 2


def test_set_matmul_precision_builds_a_new_program(plans):
    n = 12
    c = random_circuit(n, 2, seed=3)
    first = c.compiled_fused(n, device="cpu")
    banded = c.compiled_banded(n, device="cpu")
    try:
        precision.set_matmul_precision("default")
        assert ("QUEST_MATMUL_PRECISION", "default") in env.engine_mode_key()
        prog = c.compiled_fused(n, device="cpu")
        assert prog is not first and prog.tier == "default"
        assert c.compiled_banded(n, device="cpu").tier == "default"
    finally:
        precision.set_matmul_precision(None)
    assert c.compiled_fused(n, device="cpu") is first
    assert c.compiled_banded(n, device="cpu") is banded


def test_add_clears_the_cache(plans):
    n = 12
    c = random_circuit(n, 2, seed=4)
    prog = c.compiled_fused(n, device="cpu")
    assert c._compiled
    c.h(3)
    assert not c._compiled
    assert c.compiled_fused(n, device="cpu") is not prog
    # a direct append bypasses _add: the op count in the key still misses
    prog = c.compiled_fused(n, device="cpu")
    c.ops.append(TC.GateOp("matrix", (2,), operand=np.eye(2)))
    assert c.compiled_fused(n, device="cpu") is not prog


def test_cached_program_checks_its_device():
    n = 12
    c = random_circuit(n, 1, seed=5)
    prog = c.compiled_fused(n, device="cpu")
    meta = torch.zeros((2, 1 << n), device="meta")
    with pytest.raises(ValueError, match="compiled for"):
        prog.banded(meta)
    for fn in (c.compiled(n, device="cpu"), c.compiled_banded(n, device="cpu")):
        with pytest.raises(ValueError, match="compiled for"):
            fn(meta)


def test_trajectory_programs_share_the_cache(monkeypatch):
    c = Circuit(10).h(0).damping(0, 0.2).cnot(0, 3)
    prog = T._compiled_traj(c, 10, "cpu")
    assert T._compiled_traj(c, 10, "cpu") is prog
    assert T._compiled_traj(c, 10, "cpu", engine="banded") is not prog
    monkeypatch.setenv("QUEST_FUSED_DRIVER", "grid")
    grid = T._compiled_traj(c, 10, "cpu")
    assert grid is not prog and grid.driver == "grid"
    monkeypatch.delenv("QUEST_FUSED_DRIVER")
    assert T._compiled_traj(c, 10, "cpu") is prog
    c.depolarising(1, 0.1)
    assert T._compiled_traj(c, 10, "cpu") is not prog


def test_program_key_equality_rules(monkeypatch):
    c1 = random_circuit(10, 2, seed=6)
    c2 = random_circuit(10, 2, seed=6)
    k = c1.program_key()
    assert c1.program_key() == k and hash(k) == hash(c1.program_key())
    assert c2.program_key() != k                  # another circuit object
    assert c1.program_key(density=True) != k
    assert c1.program_key(dtype=np.float64) != k
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    assert c1.program_key() != k                  # a keyed knob flipped
    monkeypatch.delenv("QUEST_SWEEP_FUSION")
    assert c1.program_key() == k
    c1.h(0)
    assert c1.program_key() != k                  # grown after the submit


def _builders(c):
    """The A4 builders on circuit `c` (either package)."""
    n = c.num_qubits
    c.multi_rotate_z((0, n - 1, n // 2), 0.37)
    c.multi_rotate_pauli((1, n - 2, 2), (1, 2, 3), -0.81)
    c.multi_rotate_pauli((0, 2), (0, 0), 0.5)          # identity: no op
    c.sqrt_swap(0, n - 1)
    return c


def _assert_same_ops(tc, jc):
    assert len(tc.ops) == len(jc.ops)
    for a, b in zip(tc.ops, jc.ops):
        assert (a.kind, a.targets, a.controls, a.cstates) == (
            b.kind, b.targets, b.controls, b.cstates)
        np.testing.assert_array_equal(np.asarray(a.operand),
                                      np.asarray(b.operand))


@pytest.mark.parametrize("n", [5, 11, 13])
def test_builders_and_inverse_match_reference(n):
    tc = _builders(random_circuit(n, 2, seed=n))
    jc = _builders(JC.random_circuit(n, 2, seed=n))
    _assert_same_ops(tc, jc)
    _assert_same_ops(tc.inverse(), jc.inverse())
    rng = np.random.default_rng(n)
    v = rng.standard_normal((2, 1 << n)).astype(np.float32)
    v /= np.sqrt((v.astype(np.float64) ** 2).sum()).astype(np.float32)
    for circ, ref in ((tc, jc), (tc.inverse(), jc.inverse())):
        if n <= 10:
            want = ref.compiled(n, False, donate=False)(jnp.asarray(v))
            got = circ.compiled(n, device="cpu")(torch.from_numpy(v.copy()))
        else:
            want = ref.compiled_banded(n, False, donate=False)(jnp.asarray(v))
            got = circ.compiled_fused(n, device="cpu")(
                torch.from_numpy(v.copy()))
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    # the circuit and its inverse: the identity
    both = Circuit(n)
    both.ops = tc.ops + tc.inverse().ops
    out = both.compiled_banded(n, device="cpu")(torch.from_numpy(v.copy()))
    assert np.abs(out.numpy() - v).max() <= 1e-5


def test_inverse_rejects_channels():
    with pytest.raises(QuESTError, match="noise channels has no inverse"):
        Circuit(2).h(0).damping(1, 0.1).inverse()


def _ref_lines(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(("  estimated", "  transpile", "  plan:",
                                  "  cpu fallback"))]


@pytest.mark.parametrize("n,density,scheduled", [
    (12, False, True), (14, False, False), (6, True, True), (8, False, True)])
def test_explain_matches_reference(monkeypatch, n, density, scheduled):
    if not scheduled:
        monkeypatch.setenv("QUEST_SCHEDULE", "0")
    nq = n
    tc = random_circuit(nq, 3, seed=9)
    jc = JC.random_circuit(nq, 3, seed=9)
    if density:
        tc.damping(1, 0.1).depolarising(3, 0.05)
        jc.damping(1, 0.1).depolarising(3, 0.05)
    # the transpile, plan and host lines come last on both sides; they
    # are held against the reference in tests/test_torch_plan.py and
    # tests/test_torch_native_io.py
    mine = [ln for ln in tc.explain(density=density,
                                    budgets=BP.TPU_GEOMETRY).splitlines()
            if not ln.startswith(("  transpile", "  plan:",
                                  "  cpu fallback"))]
    ref = _ref_lines(jc.explain(density=density))
    assert mine[:2] == ref[:2]                 # header, scheduler
    if n < 10 and not density:
        assert "below the kernel tier" in mine[2] and len(mine) == 3
        return
    same = [ln for ln in mine if "passthrough" not in ln
            and not ln.startswith("  estimated")]
    want = [ln for ln in ref if "passthrough" not in ln]
    assert same == want                        # sweep, segments, totals
    assert mine[-1].startswith("  estimated steady state on one H100: ")
    assert "NVIDIA H100 80GB HBM3, 700 W, PR 10" in mine[-1]
    assert "CAUTION" not in mine[-1]


def test_explain_estimate_and_batch(monkeypatch):
    c = random_circuit(28, 4, seed=7)
    text = c.explain(batch=64)
    assert "batched: B=64 states per launch" in text
    lo, hi = map(float, re.search(r"one H100: ([\d.]+)-([\d.]+) ms",
                                  text).groups())
    assert 0 < lo <= hi
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA A100")
    assert "CAUTION: no cost model for 'NVIDIA A100'" in c.explain()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    assert "CAUTION" not in c.explain()
