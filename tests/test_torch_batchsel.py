"""S9, the BatchSelStage: each state of a batch applies its own 2x2 (its
row of the selection table) on one qubit.

The plain version (segment_sweep_reference, what the wrapper runs on a
CPU tensor) is held against a numpy oracle that applies each state's
2x2 on its qubit, for a lane qubit, inner row qubits, a scattered qubit
and a barrier stage leading a segment with other stage kinds, within
2e-5 x max|amp|. The CUDA kernel's packing of the stage (descriptor
kind, tile position, table slot) and its state offsets are checked
through `emulate_kernel` (tests/test_torch_segment.py), the numpy model
of csrc/segment.cu. The kernel itself runs in tests/test_torch_cuda.py
on a card.
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

from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import segment as S

from tests.test_torch_segment import emulate_kernel

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


def _table(rng, slots, batch):
    return (rng.standard_normal((slots, batch, 8)) / 2).astype(np.float32)


def _oracle(planes, qubit, rows):
    """numpy: state b's 2x2 rows[b] ([g00re, g00im, g01re, ...]) on
    `qubit` of (B, 2, 2^n) planes, in complex128."""
    x = planes[:, 0].astype(np.complex128) + 1j * planes[:, 1]
    b = x.shape[0]
    g = (rows[:, 0::2] + 1j * rows[:, 1::2]).reshape(b, 2, 2)
    v = x.reshape(b, -1, 2, 1 << qubit)
    out = np.einsum("bij,bpjr->bpir", g, v).reshape(b, -1)
    return np.stack([out.real, out.imag], axis=1)


def _segment(stages, n, batch):
    return S.prepare_segment(
        stages, [np.zeros((batch, 8), np.float32)] * len(stages), n, "cpu")


@pytest.mark.parametrize("qubit,n", [(0, 10), (5, 12), (7, 12), (9, 12),
                                     (13, 15), (14, 15), (16, 17)],
                         ids=["lane0", "lane5", "row0", "row2", "row6",
                              "scat14", "scat16"])
def test_plain_version_matches_oracle(qubit, n):
    batch = 3
    rng = np.random.default_rng(qubit)
    planes = rng.standard_normal((batch, 2, 1 << n)).astype(np.float32)
    table = _table(rng, 2, batch)
    st = BP.BatchSelStage(qubit, 1)
    seg = _segment([st], n, batch)
    amps = torch.from_numpy(planes.copy())
    out = S.segment_sweep(amps, seg, torch.from_numpy(table))
    assert out is amps
    want = _oracle(planes, qubit, table[1])
    np.testing.assert_allclose(out.numpy(), want,
                               atol=TOL * np.abs(want).max(), rtol=0)
    got = emulate_kernel(planes, seg, table)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


def test_descriptor_holds_tile_position_and_slot():
    """F_POS is the qubit's tile bit (lane bit, inner row, or the
    scattered axis's place in the tile), F_SLOT the channel index; the
    placeholder operand takes no room in the operand buffer."""
    n = 17
    cases = [(BP.BatchSelStage(3, 4), 3), (BP.BatchSelStage(10, 0), 10)]
    for st, pos in cases:
        seg = _segment([st], n, 2)
        row = seg.desc[0].tolist()
        assert (row[S.F_KIND], row[S.F_POS], row[S.F_SLOT]) == (
            S.K_BATCHSEL, pos, st.index)
        assert seg.ops.numel() == 0
    seg = _segment([BP.BatchSelStage(16, 2)], n, 2)
    geo = seg.geometry
    assert geo.scat == (9,)
    assert int(seg.desc[0, S.F_POS]) == 7 + geo.tile_row_bit(9)


def test_barrier_stage_leads_a_chain():
    """A barrier S9 first, then a matrix stage, a Kraus pair, a phase, a
    second (mixture) S9 and a scattered butterfly: the plain version
    equals the oracle's S9 steps around the plain version of the rest,
    and the kernel model equals the plain version."""
    n, batch = 17, 3
    rng = np.random.default_rng(11)
    g = (rng.standard_normal((2, 128, 128)) / np.sqrt(128)).astype(np.float32)
    cores = (rng.standard_normal((2, 4, 2, 2)) / 2).astype(np.float32)
    t = np.exp(0.3j)
    phase = np.array([[t.real, t.imag, 0b10, 0b10, 0b100, 0, 0b100, 0]],
                     np.float32)
    rest = [(BP.MatStage("b0", 128, False, (), (), -1), g),
            (BP.PairStage("sub", 2, 2, "scat", 9, False, (), ()), cores),
            (BP.PhaseStage(), phase)]
    sc = (BP.MatStage("sc", 2, False, (), (), 9),
          (rng.standard_normal((2, 2, 2)) / 2).astype(np.float32))
    stages = ([BP.BatchSelStage(12, 1)] + [s for s, _ in rest]
              + [BP.BatchSelStage(4, 0, barrier=False), sc[0]])
    arrays = ([np.zeros((batch, 8), np.float32)] + [a for _, a in rest]
              + [np.zeros((batch, 8), np.float32), sc[1]])
    seg = S.prepare_segment(stages, arrays, n, "cpu")
    assert seg.slots == (1, 0) and seg.geometry.tile_bits == 14
    planes = rng.standard_normal((batch, 2, 1 << n)).astype(np.float32)
    table = _table(rng, 2, batch)
    got = S.segment_sweep(torch.from_numpy(planes.copy()), seg,
                          torch.from_numpy(table)).numpy()

    def plain(x, sts, arrs):
        return S.segment_sweep_reference(torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.float32)), sts, arrs,
            n).numpy().reshape(batch, 2, -1)
    want = _oracle(planes, 12, table[1])
    want = plain(want, [s for s, _ in rest], [a for _, a in rest])
    want = _oracle(want, 4, table[0])
    want = plain(want, [sc[0]], [sc[1]])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(emulate_kernel(planes, seg, table), got,
                               atol=TOL * scale, rtol=0)


def test_batched_segments_offset_each_state():
    """A batched launch of a segment without S9 applies it to every state
    (the kernel model walks state * 2 * 2^n offsets), for a batch whose
    size is not a power of two."""
    n, batch = 12, 3
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((2, 8, 8)) / np.sqrt(8)).astype(np.float32)
    st = BP.MatStage("b1", 8, False, (), ((4, 1),), -1)
    seg = S.prepare_segment([st], [g], n, "cpu")
    planes = rng.standard_normal((batch, 2, 1 << n)).astype(np.float32)
    got = S.segment_sweep(torch.from_numpy(planes.copy()), seg).numpy()
    for b in range(batch):
        one = S.segment_sweep(torch.from_numpy(planes[b].copy()), seg)
        np.testing.assert_array_equal(got[b], one.numpy())
    np.testing.assert_allclose(emulate_kernel(planes, seg), got,
                               atol=TOL * np.abs(got).max(), rtol=0)


def test_selection_table_is_checked():
    n = 10
    seg = _segment([BP.BatchSelStage(8, 1)], n, 2)
    amps = torch.zeros((2, 2, 1 << n))
    with pytest.raises(ValueError, match="selection table"):
        S.segment_sweep(amps, seg)
    for bad in (torch.zeros((1, 2, 8)), torch.zeros((2, 3, 8)),
                torch.zeros((2, 2, 8), dtype=torch.float64)):
        with pytest.raises(ValueError, match="selection table"):
            S.segment_sweep(amps, seg, bad)
    with pytest.raises(ValueError):
        S.segment_sweep(torch.zeros((2, 3, 1 << n)), seg,
                        torch.zeros((2, 2, 8)))
