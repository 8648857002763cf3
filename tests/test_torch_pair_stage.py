"""Kraus pairs (PairStage) and general diagonals (DiagVecStage): the
port's plain versions against the reference, and the kernel's packing.

Plain versions: segment_sweep on CPU tensors against
quest_tpu.ops.pallas_band.compile_segment in the Pallas interpreter, on
single-stage segments at n = 16-17 (and row bits >= 15 at n = 23), the
same seeded numpy state and operands, within 2e-5 x max|amp| (the f32
`tol` of tests/conftest.py). The Hopper-only 'sub' pair form has no
reference stage; it is held against the reference's b1 form of the same
4x4 operator.

Packing: `emulate_kernel` (tests/test_torch_segment.py, the numpy model
of csrc/segment.cu) on every pair form the Hopper planner emits and on
diagonals, including the reduction of embedded 128x128 lane blocks to
their 2x2 cores; and on every segment of the density circuits' Hopper
plans.
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

from quest_tpu.ops import pallas_band as PB

from quest_tpu_torch import entry as TE
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as TF
from quest_tpu_torch.ops import segment as S

from tests.test_torch_segment import emulate_kernel

pytestmark = pytest.mark.dtype_agnostic

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs:
    the suite runs several workers side by side (see
    tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _cores(rng, real=False):
    g = (rng.standard_normal((2, 4, 2, 2)) / 2).astype(np.float32)
    if real:
        g[1] = 0.0
    return g


def _embed(cores, q):
    """The planner's packing of 'lane'/'b1' pair blocks: each 2x2 core
    embedded at bit q of a 7-bit space, stored transposed."""
    out = np.zeros((2, 4, 128, 128), np.float32)
    for b in range(4):
        e = TF.embed_operator(cores[0, b] + 1j * cores[1, b], [q], [], [], 7).T
        out[0, b], out[1, b] = e.real, e.imag
    return out


def _pair(rng, name, op_kind, sliced_kind, sliced_bit, op_bit=-1, q=0,
          real=False, lane_preds=(), row_preds=()):
    """(name, reference stage or None, port stage, operand)."""
    cores = _cores(rng, real)
    arr = _embed(cores, q) if op_kind in ("lane", "b1") else cores
    dim = 128 if op_kind in ("lane", "b1") else 2
    args = (op_kind, dim, op_bit, sliced_kind, sliced_bit, real,
            tuple(lane_preds), tuple(row_preds))
    ref = PB.PairStage(*args) if op_kind != "sub" else None
    return name, ref, BP.PairStage(*args), arr


def _diag(rng, name, targets, lane_preds=(), row_preds=()):
    k = len(targets)
    t = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << k)) * rng.uniform(
        0.5, 1.5, 1 << k)
    arr = np.stack([t.real, t.imag]).astype(np.float32)
    args = (tuple(targets), tuple(lane_preds), tuple(row_preds))
    return name, PB.DiagVecStage(*args), BP.DiagVecStage(*args), arr


def reference_cases():
    """(n, case) single-stage segments with a reference stage."""
    rng = np.random.default_rng(20261016)
    return [
        (16, _pair(rng, "lane_scat", "lane", "scat", 8, q=3)),
        (17, _pair(rng, "lane_scat_real", "lane", "scat", 9, q=6, real=True)),
        (16, _pair(rng, "lane_sub", "lane", "sub", 4, q=5)),
        (16, _pair(rng, "b1_scat", "b1", "scat", 8, q=2)),
        (16, _pair(rng, "sc_scat", "sc", "scat", 8, op_bit=6)),
        (17, _pair(rng, "sc_scat_real", "sc", "scat", 7, op_bit=9, real=True)),
        (16, _diag(rng, "diag_k1", (3,))),
        (16, _diag(rng, "diag_k3_preds", (0, 9, 12), ((2, 1),), ((1, 0),))),
        (16, _diag(rng, "diag_k7", (1, 5, 8, 9, 12, 14, 15))),
        (23, _diag(rng, "diag_row_bit_15", (22, 3, 8), ((0, 0),),
                   ((15, 1),))),
    ]


def _state(n, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (2, 1 << n)).astype(np.float32)


def _scale_close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL * float(np.abs(want).max()),
                               rtol=0)


def _reference(n, stages, arrays, planes):
    fn = PB.compile_segment(stages, n, interpret=True)
    return np.asarray(fn(jnp.asarray(planes).reshape(2, -1, PB.LANES),
                         list(arrays))).reshape(2, -1)


@pytest.mark.parametrize("case", reference_cases(), ids=lambda c: c[1][0])
def test_plain_version_matches_interpreted_reference(case):
    n, (_, ref, port, arr) = case
    planes = _state(n)
    want = _reference(n, [ref], [arr], planes)
    got = S.segment_sweep_reference(torch.from_numpy(planes), [port], [arr],
                                    n).numpy().reshape(2, -1)
    _scale_close(got, want)


@pytest.mark.parametrize("j", [0, 3, 5])
def test_sub_form_matches_reference_b1_form(j):
    """Hopper's 'sub' pair (row bit j an inner row) applies the same
    operator as the reference's b1 pair embedding it at sublane bit j."""
    n = 16
    rng = np.random.default_rng(j)
    cores = _cores(rng)
    ref = PB.PairStage("b1", 128, -1, "scat", 8, False, (), ())
    port = BP.PairStage("sub", 2, j, "scat", 8, False, (), ())
    planes = _state(n, seed=j)
    want = _reference(n, [ref], [_embed(cores, j)], planes)
    got = S.segment_sweep_reference(torch.from_numpy(planes), [port], [cores],
                                    n).numpy().reshape(2, -1)
    _scale_close(got, want)


def kernel_cases():
    """(n, stages, arrays): every pair form the Hopper planner emits, with
    and without predicates, diagonals, and a chain mixing them with the
    statevector stage kinds."""
    rng = np.random.default_rng(7)

    def mat(kind, dim, bit=-1):
        g = (rng.standard_normal((2, dim, dim)) / np.sqrt(dim)).astype(
            np.float32)
        return "mat", None, BP.MatStage(kind, dim, False, (), (), bit), g
    singles = [
        (16, [_pair(rng, "", "lane", "scat", 8, q=0)]),
        (16, [_pair(rng, "", "lane", "scat", 8, q=6, real=True)]),
        (16, [_pair(rng, "", "lane", "sub", 3, q=4)]),
        (16, [_pair(rng, "", "lane", "sub", 6, q=1)]),
        (16, [_pair(rng, "", "sub", "scat", 8, op_bit=0)]),
        (16, [_pair(rng, "", "sub", "scat", 8, op_bit=5)]),
        (16, [_pair(rng, "", "sc", "scat", 8, op_bit=6)]),
        (16, [_pair(rng, "", "sc", "scat", 6, op_bit=8)]),
        (16, [_pair(rng, "", "sub", "scat", 7, op_bit=2, lane_preds=((1, 1),),
                    row_preds=((4, 0),))]),
        (16, [_diag(rng, "", (3,))]),
        (16, [_diag(rng, "", (0, 9, 12), ((2, 1),), ((1, 0),))]),
        (16, [_diag(rng, "", (1, 5, 8, 9, 12, 14, 15))]),
        (23, [_diag(rng, "", (22, 3, 8), ((0, 0),), ((15, 1),))]),
        (16, [mat("b0", 128), _pair(rng, "", "lane", "scat", 8, q=2),
              _diag(rng, "", (7, 2)), _pair(rng, "", "sub", "scat", 8,
                                             op_bit=1),
              mat("sc", 2, bit=8)]),
    ]
    return [(n, [c[2] for c in st], [c[3] for c in st]) for n, st in singles]


@pytest.mark.parametrize("case", kernel_cases(),
                         ids=lambda c: "+".join(S.stage_label(s)
                                                for s in c[1]) + f"_{c[0]}")
def test_kernel_packing_matches_plain_version(case):
    n, stages, arrays = case
    seg = S.prepare_segment(stages, arrays, n, "cpu")
    planes = _state(n, seed=11)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n).numpy().reshape(2, -1)
    _scale_close(emulate_kernel(planes, seg), want)


def test_lane_blocks_reduce_to_their_cores():
    rng = np.random.default_rng(3)
    cores = _cores(rng)
    st = BP.PairStage("lane", 128, -1, "scat", 8, False, (), ())
    for q in (0, 4, 6):
        got_q, got = S.pair_core(st, _embed(cores, q))
        assert got_q == q and np.array_equal(got, cores)
    bad = _embed(cores, 2)
    bad[0, 1, 5, 100] = 0.25                 # off the embedding's pattern
    with pytest.raises(ValueError, match="embedded"):
        S.pair_core(st, bad)
    seg = S.prepare_segment([st], [_embed(cores, 4)], 16, "cpu")
    assert int(seg.desc[0, S.F_POS]) == 4
    assert int(seg.desc[0, S.F_POS2]) == 7 + seg.geometry.tile_row_bit(8)
    assert seg.ops.numel() == 32             # the kernel gets the cores only


def test_b1_form_does_not_fit_a_hopper_tile():
    """The reference's b1/scat pair needs 8 row bits: plain version only,
    the Hopper planner never emits it and the packer refuses it."""
    rng = np.random.default_rng(1)
    _, _, st, arr = _pair(rng, "", "b1", "scat", 8, q=2)
    with pytest.raises(ValueError, match="exceeds"):
        S.prepare_segment([st], [arr], 16, "cpu")


@pytest.mark.parametrize("build,nd", [(TE.noisy_rcs_circuit, 8),
                                      (TE.clifford_t_density_circuit, 8),
                                      (TE.bench_density_circuit, 8)],
                         ids=["noisy_rcs", "clifford_t", "bench_density"])
def test_kernel_packing_on_density_plans(build, nd):
    """Every swept segment of the density circuits' Hopper plans through
    the kernel model and the plain version; passthroughs run as the
    engine runs them."""
    n = 2 * nd
    prog = build(nd).compiled_fused(n, density=True, device="cpu")
    labels = set().union(*(seg.labels for seg in prog.segments))
    assert "pair" in labels
    planes = _state(n, seed=3)
    for step in prog.steps:
        if not isinstance(step, S.Segment):
            out = torch.from_numpy(planes.copy())
            planes = step(out).numpy().reshape(2, -1)
            continue
        want = S.segment_sweep_reference(torch.from_numpy(planes), step.stages,
                                         step.operands, n).numpy()
        _scale_close(emulate_kernel(planes, step), want.reshape(2, -1))
        planes = want.reshape(2, -1)
