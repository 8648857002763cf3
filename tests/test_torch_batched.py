"""The port's batched engine (Circuit.compiled_batched) against the
reference's.

The same seeded numpy states go through quest_tpu's
compiled_batched(B, interpret=True) and the port's compiled_batched on
the CPU (the segment kernel's plain version), within 2e-5 x max|amp|
(the f32 tolerance of tests/conftest.py `tol`); each state of a batch
must equal the port's unbatched compiled_fused on that state; the
program runs any batch at its exact size (the reference pads to a
power-of-two bucket; the port's kernel takes the batch at launch, so
nothing is padded), and its launch count per call is the unbatched
plan's, whatever the batch.
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

from quest_tpu import circuit as JC

from quest_tpu_torch import convert
from quest_tpu_torch.circuit import Circuit, FusedProgram

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


def _reference_circuit(n):
    """Lane and sublane gates, a cross-band cz, a high-band rotation and
    a parity phase: b0, b1 and scattered stages in one plan."""
    c = JC.Circuit(n)
    for q in range(7):
        c.h(q)
    c.cz(0, 8).rz(9, 0.4).cnot(2, 9).ry(8, 0.3)
    c.ry(n - 1, 0.7).cnot(n - 1, 3)
    return c


def _states(b, n, seed):
    rng = np.random.default_rng(seed)
    amps = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    norms = np.sqrt((amps.astype(np.float64) ** 2).sum(axis=(1, 2)))
    return (amps / norms[:, None, None]).astype(np.float32)


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("n,batch", [(10, 3), (11, 8)])
def test_compiled_batched_matches_reference(n, batch):
    jc = _reference_circuit(n)
    tc = convert.circuit_from_ops(jc.ops, n)
    amps = _states(batch, n, seed=batch)
    want = np.asarray(jc.compiled_batched(batch, interpret=True,
                                          donate=False)(jnp.asarray(amps)))
    fn = tc.compiled_batched(batch, device="cpu")
    assert isinstance(fn, FusedProgram)
    x = torch.from_numpy(amps.copy())
    out = fn(x)
    assert out is x                          # in place
    _assert_close(out.numpy(), want)
    _assert_close(fn.plain(torch.from_numpy(amps)).numpy(), want)


def test_each_state_equals_the_unbatched_program():
    n = 12
    tc = convert.circuit_from_ops(_reference_circuit(n).ops, n)
    amps = _states(5, n, seed=4)
    batched = tc.compiled_batched(5, device="cpu")(
        torch.from_numpy(amps.copy()))
    single = tc.compiled_fused(n, device="cpu")
    for i in range(5):
        one = single(torch.from_numpy(amps[i].copy()))
        np.testing.assert_array_equal(batched[i].numpy(), one.numpy())


def test_fused_view_batches_and_sub_batches_are_exact():
    """(B, 2, rows, 128) batches run like flat ones, and the first 3
    states run alone give the whole batch's first 3 states exactly."""
    n = 10
    tc = convert.circuit_from_ops(_reference_circuit(n).ops, n)
    amps = _states(8, n, seed=5)
    fn = tc.compiled_batched(8, device="cpu")
    full = fn(torch.from_numpy(amps.copy()).reshape(8, 2, -1, 128))
    assert full.shape == (8, 2, 8, 128)
    part = fn(torch.from_numpy(amps[:3].copy()))
    np.testing.assert_array_equal(part.numpy(), full.reshape(8, 2, -1)[:3])


@pytest.mark.parametrize("b", [1, 3, 9])
def test_any_batch_runs_at_its_exact_size(b):
    """A program compiled for a batch of 4 runs a batch of any size, with
    no padding: each state as the unbatched program gives it."""
    n = 10
    tc = convert.circuit_from_ops(_reference_circuit(n).ops, n)
    fn = tc.compiled_batched(4, device="cpu")
    amps = _states(b, n, seed=10 + b)
    out = fn(torch.from_numpy(amps.copy()))
    assert out.shape == (b, 2, 1 << n)
    single = tc.compiled_fused(n, device="cpu")
    for i in range(b):
        one = single(torch.from_numpy(amps[i].copy()))
        np.testing.assert_array_equal(out[i].numpy(), one.numpy())
    with pytest.raises(ValueError):
        tc.compiled_batched(0, device="cpu")


def test_launches_per_call_do_not_depend_on_the_batch():
    n = 12
    tc = convert.circuit_from_ops(_reference_circuit(n).ops, n)
    single = tc.compiled_fused(n, device="cpu").launches_per_call
    for b in (1, 8, 64):
        fn = tc.compiled_batched(b, device="cpu")
        assert fn.launches_per_call == single


def test_apply_batched_and_passthroughs():
    """apply_batched on a plan with a matrix passthrough between
    segments (a cross-band 3-qubit gate) matches the reference."""
    n = 10
    u = np.linalg.qr(np.random.default_rng(2).normal(size=(8, 8))
                     + 1j * np.random.default_rng(3).normal(size=(8, 8)))[0]
    jc = JC.Circuit(n).h(0).gate(u, (0, 2, 9)).ry(8, 0.3)
    tc = convert.circuit_from_ops(jc.ops, n)
    prog = tc.compiled_batched(4, device="cpu")
    assert len(prog.steps) > len(prog.segments)
    amps = _states(4, n, seed=6)
    want = np.asarray(jc.compiled_batched(4, interpret=True, donate=False)(
        jnp.asarray(amps)))
    _assert_close(tc.apply_batched(torch.from_numpy(amps.copy())).numpy(),
                  want)


def test_unported_batched_paths_raise():
    tc = Circuit(10).h(0)
    jc = JC.Circuit(10).h(0)
    amps = _states(2, 10, seed=9)

    def reference(circ, planes):
        return np.asarray(circ.compiled_batched(
            2, donate=False, interpret=True, engine="banded")(
            jnp.asarray(planes)))
    banded = tc.compiled_batched(2, engine="banded", device="cpu")
    _assert_close(banded(torch.from_numpy(amps.copy())).numpy(),
                  reference(jc, amps))
    with pytest.raises(ValueError):
        tc.compiled_batched(2, engine="xla", device="cpu")
    small = _states(2, 8, seed=10)
    _assert_close(Circuit(8).h(0).compiled_batched(2, device="cpu")(
        torch.from_numpy(small.copy())).numpy(),
        reference(JC.Circuit(8).h(0), small))
    fn = tc.compiled_batched(2, device="cpu")
    amps64 = amps.astype(np.float64)
    got = fn(torch.from_numpy(amps64.copy()))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), reference(jc, amps64),
                               atol=1e-12 * float(np.abs(amps64).max()),
                               rtol=0)


def test_batched_planes_from_numpy():
    amps = _states(3, 10, seed=8)
    x = convert.planes_from_numpy(amps, device="cpu")
    assert x.shape == (3, 2, 1 << 10) and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), amps)
    x += 1.0                                   # a copy: the source stays
    assert np.array_equal(amps, _states(3, 10, seed=8))
