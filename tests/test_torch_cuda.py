"""The segment kernel on a CUDA card, against its plain PyTorch version:
every stage kind, Kraus pairs and diagonals included, and the fused and
density paths.

Needs a card: every test here is marked `cuda` and skips without one
(the kernel has no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import segment as S

pytestmark = [pytest.mark.cuda, pytest.mark.dtype_agnostic]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment kernel has no CPU mode")
    return torch.device("cuda")


def _mat(rng, kind, dim, bit=-1, real=False, lane_preds=(), row_preds=()):
    g = rng.standard_normal((2, dim, dim)) / np.sqrt(dim)
    if real:
        g[1] = 0.0
    return (BP.MatStage(kind, dim, real, tuple(lane_preds), tuple(row_preds),
                        bit), g.astype(np.float32))


def _phase_rows(rng):
    t = np.exp(1j * rng.uniform(0, 2 * np.pi))
    h = rng.uniform(0, np.pi)
    return [
        (BP.PhaseStage(), np.array([[t.real, t.imag, 0b11, 0b01, 0b101, 0,
                                     0b100, 0]], np.float32)),
        (BP.ParityStage(), np.array([[np.cos(h), np.sin(h), 0b110, 0b1001,
                                      0, 0, 0, 0]], np.float32)),
        (BP.MultiPhaseStage(("a", "p")), np.array(
            [[0.3, 0b1, 0b10, 0, 0, 0, 0, 0], [-0.7, 0b100, 0b1, 0, 0, 0, 0, 0]],
            np.float32)),
    ]


def _cases():
    rng = np.random.default_rng(20261016)
    n = 16
    single = [_mat(rng, "b0", 128), _mat(rng, "b1", 128), _mat(rng, "b1", 32),
              _mat(rng, "scb", 128, bit=2), _mat(rng, "scb", 64, bit=3, real=True),
              _mat(rng, "scb", 4, bit=7), _mat(rng, "sc", 2, bit=8),
              _mat(rng, "b0", 128, lane_preds=((3, 1),), row_preds=((2, 1),))]
    cases = [(f"{st.kind}{st.dim}{'_preds' if st.lane_preds else ''}", n,
              [(st, g)]) for st, g in single]
    cases += [(type(st).__name__, n, [(st, g)]) for st, g in _phase_rows(rng)]
    chain = [_mat(rng, "b0", 128), *_phase_rows(rng), _mat(rng, "sc", 2, bit=8),
             _mat(rng, "scb", 4, bit=6, row_preds=((0, 1),))]
    cases.append(("chain", n, chain))
    return cases


def _cores(rng, real=False):
    g = rng.standard_normal((2, 4, 2, 2)) / 2
    if real:
        g[1] = 0.0
    return g.astype(np.float32)


def _lane_pair(rng, q, sliced_kind, sliced_bit):
    """A 'lane' pair as the planner packs it: 2x2 cores embedded at lane
    bit q of 128x128 blocks, stored transposed."""
    from quest_tpu_torch.ops.fusion import embed_operator
    cores = _cores(rng)
    emb = np.stack([embed_operator(cores[0, b] + 1j * cores[1, b], [q], [],
                                   [], 7).T for b in range(4)])
    return (BP.PairStage("lane", 128, -1, sliced_kind, sliced_bit, False,
                         (), ()),
            np.stack([emb.real, emb.imag]).astype(np.float32))


def _density_cases():
    rng = np.random.default_rng(20261017)
    n = 16

    def pair(op_kind, op_bit, sliced_bit, real=False, preds=((), ())):
        return (BP.PairStage(op_kind, 2, op_bit, "scat", sliced_bit, real,
                             *preds), _cores(rng, real))

    def diag(targets, lane_preds=(), row_preds=()):
        k = len(targets)
        t = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << k))
        return (BP.DiagVecStage(tuple(targets), tuple(lane_preds),
                                tuple(row_preds)),
                np.stack([t.real, t.imag]).astype(np.float32))
    cases = [("lane_scat", n, [_lane_pair(rng, 3, "scat", 8)]),
             ("lane_sub", n, [_lane_pair(rng, 6, "sub", 5)]),
             ("sub_scat", n, [pair("sub", 4, 8)]),
             ("sc_scat", n, [pair("sc", 6, 8)]),
             ("sc_scat_real", n, [pair("sc", 8, 7, real=True)]),
             ("pair_preds", n, [pair("sub", 1, 8, preds=(((2, 1),), ((5, 0),)))]),
             ("diag_k1", n, [diag((3,))]),
             ("diag_k3_preds", n, [diag((0, 9, 12), ((2, 1),), ((1, 0),))]),
             ("diag_k7", n, [diag((1, 5, 8, 9, 12, 14, 15))]),
             ("diag_row_bit_15", 23, [diag((22, 3, 8), (), ((15, 1),))])]
    chain = [_mat(rng, "b0", 128), _lane_pair(rng, 1, "scat", 8),
             diag((7, 2)), pair("sub", 2, 8), _mat(rng, "sc", 2, bit=8)]
    cases.append(("density_chain", n, chain))
    return cases


@pytest.mark.parametrize("case", _cases() + _density_cases(),
                         ids=lambda c: c[0])
def test_kernel_matches_plain_version(card, case):
    _, n, stages = case
    seg = S.prepare_segment([s for s, _ in stages], [g for _, g in stages],
                            n, card)
    rng = np.random.default_rng(3)
    amps = torch.from_numpy(
        rng.standard_normal((2, 1 << n)).astype(np.float32)).to(card)
    want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n)
    before = S.segment_sweep.launches
    S.segment_sweep(amps, seg)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches == before + 1
    err = (amps.reshape(2, -1) - want.reshape(2, -1)).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


def test_fused_path_matches_plain_version(card):
    from quest_tpu_torch.entry import entry
    fn, (amps,) = entry(num_qubits=20)
    want = fn.plain(amps.clone())
    before = S.segment_sweep.launches
    S.segment_sweep.stage_launches = {}
    fn(amps)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches - before == fn.launches_per_call
    planned = {}
    for seg in fn.segments:
        for label in seg.labels:
            planned[label] = planned.get(label, 0) + 1
    assert S.segment_sweep.stage_launches == planned
    err = (amps - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()
    norm = (amps.double() ** 2).sum().item()
    assert abs(1.0 - norm) <= 1e-4


@pytest.mark.parametrize("build", ["noisy_rcs_circuit",
                                   "clifford_t_density_circuit",
                                   "bench_density_circuit"])
def test_density_path_matches_plain_version(card, build):
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch import entry as E
    from quest_tpu_torch.state import Qureg, basis_planes, fused_state_shape
    nd = 10
    n = 2 * nd
    fn = getattr(E, build)(nd).compiled_fused(n, density=True, device=card)
    amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=card)
    want = fn.plain(amps.clone())
    before = S.segment_sweep.launches
    fn(amps)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches - before == fn.launches_per_call
    err = (amps - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()
    q = Qureg(amps, nd, is_density=True)
    assert abs(1.0 - K.calc_total_prob(q)) <= 1e-4
    assert K.calc_purity(q) <= 1.0 + 1e-4


def _sel_rows(rng, slots, batch):
    g = (rng.standard_normal((slots, batch, 8)) / 2).astype(np.float32)
    return torch.from_numpy(g)


@pytest.mark.parametrize("qubit", [3, 7, 12, 13, 16],
                         ids=["lane", "row0", "row5", "row6", "scat"])
def test_batchsel_stage_matches_plain_version(card, qubit):
    """S9 on each tile position, a batch of 5 states, each with its own
    selection row, against the plain version within 1e-6 x max|amp|."""
    n, batch = 17, 5
    rng = np.random.default_rng(qubit)
    st = BP.BatchSelStage(qubit, 1)
    seg = S.prepare_segment([st], [np.zeros((batch, 8), np.float32)], n, card)
    amps = torch.from_numpy(rng.standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    sel = _sel_rows(rng, 2, batch).to(card)
    want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n, sel)
    before = S.segment_sweep.launches
    S.segment_sweep(amps, seg, sel)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches == before + 1
    err = (amps.reshape(-1) - want.reshape(-1)).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()


def test_batched_program_matches_plain_and_unbatched(card):
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.entry import random_states
    n = 16
    c = random_circuit(n, 3, seed=7)
    fn = c.compiled_batched(5, device=card)
    single = c.compiled_fused(n, device=card)
    amps = random_states(5, n, device=card)
    first = amps[0].clone()
    want = fn.plain(amps)
    before = S.segment_sweep.launches
    fn(amps)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches - before == single.launches_per_call
    err = (amps - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()
    assert (single(first) - amps[0]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_trajectory_launches_independent_of_batch(card, batch):
    """One chunk launches the segment kernel once per swept segment,
    whatever its size, and the kernel path takes the plain path's
    branches."""
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.entry import noisy_rcs_circuit
    circ = noisy_rcs_circuit(16, 2)
    prog = T._compiled_traj(circ, 16, card)
    u = torch.rand((batch, prog.num_channels), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(batch))
    before = S.segment_sweep.launches
    planes, draws = prog(u)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches - before == prog.launches_per_call
    assert prog.launches_per_call == T.plan_stats(circ, batch)[
        "kernel_sweeps"]
    want, want_draws = prog.plain(u)
    assert torch.equal(draws, want_draws)
    assert (planes - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _tier_cases():
    """The matrix-stage cases of _cases (b0, b1, scb; predicated,
    real-only, chained) with a b1 and an scb of d = 16 besides."""
    rng = np.random.default_rng(20261018)
    cases = [c for c in _cases() if any(S.rounds(st) for st, _ in c[2])]
    cases += [("b1_16", 16, [_mat(rng, "b1", 16)]),
              ("scb16_preds", 16, [_mat(rng, "scb", 16, bit=3,
                                        lane_preds=((1, 0),),
                                        row_preds=((0, 1),))])]
    return cases


@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("case", _tier_cases(), ids=lambda c: c[0])
def test_tier_kernel_matches_plain_version(card, case, tier):
    """S11: the tier's tensor-core (d >= 16) or rounded-FMA (d < 16)
    body against the tier's plain version within 1e-5 x max|amp|, and
    against the HIGHEST kernel: different bits, within 1e-4 (HIGH) or
    1e-2 (DEFAULT) x max|amp|. Where a rounding stage follows other
    stages, kernel and plain version may round an input that their fp32
    sums left one ulp apart to neighbouring bf16 values: there the gate
    is one bf16 step of max|amp| (2^-14 HIGH, 2^-7 DEFAULT) and an L2
    distance within the tier's tolerance."""
    _, n, stages = case
    sts, gs = [s for s, _ in stages], [g for _, g in stages]
    seg = S.prepare_segment(sts, gs, n, card, tier=tier)
    top = S.prepare_segment(sts, gs, n, card, tier="highest")
    rng = np.random.default_rng(5)
    amps = torch.from_numpy(
        rng.standard_normal((2, 1 << n)).astype(np.float32)).to(card)
    ref = amps.clone()
    want = S.segment_sweep_reference(amps, seg.stages, seg.operands, n,
                                     tier=tier)
    before = dict(S.segment_sweep.stage_launches)
    S.segment_sweep(amps, seg)
    S.segment_sweep(ref, top)
    torch.cuda.synchronize()
    for label in seg.labels:
        twice = label in top.labels          # sc: exact in both segments
        assert (S.segment_sweep.stage_launches[label]
                == before.get(label, 0) + (2 if twice else 1))
    assert any(label.endswith("@" + tier) for label in seg.labels)
    scale = want.abs().max().item()
    tier_tol = {"high": 1e-4, "default": 1e-2}[tier]
    diff = amps.reshape(2, -1) - want.reshape(2, -1)
    err = diff.abs().max().item()
    if any(S.rounds(st) for st in sts[1:]):
        rel_l2 = (diff.double().pow(2).sum()
                  / want.double().pow(2).sum()).sqrt().item()
        assert err <= 1e-5 * scale or (
            err <= {"high": 2.0 ** -14, "default": 2.0 ** -7}[tier] * scale
            and rel_l2 <= tier_tol)
    else:
        assert err <= 1e-5 * scale
    dist = (amps - ref).abs().max().item()
    assert 0.0 < dist <= tier_tol * scale


def test_fused_path_at_high_matches_plain_version(card):
    """The 20-qubit flagship compiled at HIGH: the plan's launches under
    '@high' labels, the plain path at HIGH within 1e-4 x max|amp| and its
    norm within 1e-5, the HIGHEST program within 1e-4 x max|amp|."""
    from quest_tpu_torch import precision as P
    from quest_tpu_torch.entry import entry
    top, (ref,) = entry(num_qubits=20)
    P.set_matmul_precision("high")
    try:
        fn, (amps,) = entry(num_qubits=20)
    finally:
        P.set_matmul_precision(None)
    assert fn.tier == "high" and top.tier == "highest"
    want = fn.plain(amps.clone())
    S.segment_sweep.stage_launches = {}
    before = S.segment_sweep.launches
    fn(amps)
    top(ref)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches - before == 2 * fn.launches_per_call
    assert any(k.endswith("@high") for k in S.segment_sweep.stage_launches)
    scale = want.abs().max().item()
    assert (amps - want).abs().max().item() <= 1e-4 * scale
    assert abs((amps.double() ** 2).sum().item()
               - (want.double() ** 2).sum().item()) <= 1e-5
    assert 0.0 < (amps - ref).abs().max().item() <= 1e-4 * scale


# ---- the segment drivers: K1 (decoupled ring), K2 (in-place slots), K3 ----

import chip_smoke  # noqa: E402  (the smoke test's stage cases)

RING_DRIVERS = [("decoupled", 3), ("inplace", 2), ("inplace", 3),
                ("inplace", 8)]
_SEED = 20261017


def _smoke_case(name):
    cases = chip_smoke.stage_cases(np.random.default_rng(_SEED))
    return next(c for c in cases if c[0] == name)


def _batch_case(name):
    cases = chip_smoke.batch_stage_cases(np.random.default_rng(_SEED))
    return next(c for c in cases if c[0] == name)


def _run(card, stages, arrays, n, planes, driver, nbuf, sel=None):
    seg = S.prepare_segment(stages, arrays, n, card, driver=driver, nbuf=nbuf)
    amps = planes.clone()
    before = S.segment_sweep.driver_launches.get(driver, 0)
    S.segment_sweep(amps, seg, sel)
    torch.cuda.synchronize()
    assert S.segment_sweep.driver_launches[driver] == before + 1
    return amps


@pytest.mark.parametrize("driver,nbuf", RING_DRIVERS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize(
    "name", [c[0] for c in chip_smoke.stage_cases(np.random.default_rng(0))])
def test_ring_driver_matches_grid_bit_for_bit(card, name, driver, nbuf):
    """Every stage case of chip_smoke.py at 20 (and 23) qubits: the
    persistent ring drivers give K3's planes bit for bit."""
    _, n, stages, arrays = _smoke_case(name)
    planes = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1 << n)).astype(np.float32)).to(card)
    got = _run(card, stages, arrays, n, planes, driver, nbuf)
    want = _run(card, stages, arrays, n, planes, "grid", 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("driver,nbuf", RING_DRIVERS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize(
    "name", [c[0] for c in
             chip_smoke.batch_stage_cases(np.random.default_rng(0))])
def test_ring_driver_batched_matches_grid_bit_for_bit(card, name, driver,
                                                      nbuf):
    """The batched S9 segments (5 states x 17 qubits, each state its own
    selection rows): the state of a step is step / tiles, K3's
    blockIdx.y; bit for bit."""
    _, n, batch, stages, arrays, _ = _batch_case(name)
    rng = np.random.default_rng(2)
    planes = torch.from_numpy(rng.standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    sel = torch.from_numpy(chip_smoke.sel_table(rng, 2, batch)).to(card)
    got = _run(card, stages, arrays, n, planes, driver, nbuf, sel)
    want = _run(card, stages, arrays, n, planes, "grid", 3, sel)
    assert torch.equal(got, want)


@pytest.mark.parametrize("driver,nbuf", RING_DRIVERS + [("grid", 3)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("n", [14, 20, 24])
def test_stage_free_segment_leaves_state_unchanged(card, n, driver, nbuf):
    """The stage-free segment (the copy floor) moves every tile in and out
    and changes no bit; at 14 qubits one tile, so a ring of 2 slots."""
    planes = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2, 1 << n)).astype(np.float32)).to(card)
    got = _run(card, [], [], n, planes, driver, nbuf)
    assert torch.equal(got, planes)


def test_refused_launch_raises(card, monkeypatch):
    """A launch that asks for more shared memory than a block may have is
    refused by the runtime, and the wrapper raises: no driver falls back
    to another or to the plain version."""
    n = 17
    seg = S.prepare_segment([], [], n, card)
    real = S.smem_layout

    def too_big(*args, **kwargs):
        lay = dict(real(*args, **kwargs))
        lay["total_bytes"] = BP.BLOCK_SMEM_BYTES + 4096
        return lay
    monkeypatch.setattr(S, "smem_layout", too_big)
    amps = torch.zeros((2, 1 << n), device=card)
    before = S.segment_sweep.launches
    with pytest.raises(RuntimeError, match="launch"):
        S.segment_sweep(amps, seg)
    assert S.segment_sweep.launches == before


def test_default_program_runs_the_decoupled_driver(card, monkeypatch):
    """A program compiled with the knobs unset runs K1; one compiled
    under QUEST_FUSED_DRIVER=grid keeps K3 after the knob is unset, and
    both give the same planes bit for bit."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.state import basis_planes, fused_state_shape
    for k in ("QUEST_FUSED_DRIVER", "QUEST_FUSED_PIPELINE",
              "QUEST_FUSED_NBUF"):
        monkeypatch.delenv(k, raising=False)
    n = 18
    c = random_circuit(n, 3, seed=5)
    k1 = c.compiled_fused(n, device=card)
    monkeypatch.setenv("QUEST_FUSED_DRIVER", "grid")
    k3 = c.compiled_fused(n, device=card)
    monkeypatch.delenv("QUEST_FUSED_DRIVER")
    outs = []
    for fn, driver in ((k1, "decoupled"), (k3, "grid")):
        assert fn.driver == driver
        amps = basis_planes(0, n=n, shape=fused_state_shape(n), device=card)
        S.segment_sweep.driver_launches = {}
        fn(amps)
        torch.cuda.synchronize()
        assert S.segment_sweep.driver_launches == {
            driver: fn.launches_per_call}
        outs.append(amps)
    assert torch.equal(outs[0], outs[1])


# ---- batches above the grid's 65535 states; diagonal targets above 31 ----

BIG_BATCH = 65536 + 3


@pytest.mark.parametrize("driver,nbuf", RING_DRIVERS[:3] + [("grid", 3)],
                         ids=lambda v: str(v))
def test_batch_above_grid_limit(card, driver, nbuf):
    """65,539 states of 10 qubits (0.5 GiB) through one segment — each
    state's own channel row (S9 reads row slot * B + state), a b0 and a
    phase — under every driver: against the plain version, and bit for
    bit against the batch split by hand at 65,535 (the grid driver's
    slices; its two launches counted)."""
    n, batch = 10, BIG_BATCH
    rng = np.random.default_rng(31)
    stages = [(BP.BatchSelStage(3, 0, True), np.zeros((1, 8), np.float32)),
              _mat(rng, "b0", 128), _phase_rows(rng)[0]]
    seg = S.prepare_segment([s for s, _ in stages], [g for _, g in stages],
                            n, card, driver=driver, nbuf=nbuf)
    planes = torch.from_numpy(rng.standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    sel = torch.from_numpy(chip_smoke.sel_table(rng, 1, batch)).to(card)
    want = S.segment_sweep_reference(planes, seg.stages, seg.operands, n, sel)
    got = planes.clone()
    before = S.segment_sweep.driver_launches.get(driver, 0)
    S.segment_sweep(got, seg, sel)
    torch.cuda.synchronize()
    launches = 2 if driver == "grid" else 1
    assert S.segment_sweep.driver_launches[driver] == before + launches
    scale = want.abs().max().item()
    assert (got - want.reshape(got.shape)).abs().max().item() <= 1e-5 * scale
    cut = S.MAX_GRID_BATCH
    halves = []
    for lo, hi in ((0, cut), (cut, batch)):
        part = planes[lo:hi].clone()
        S.segment_sweep(part, seg, sel[:, lo:hi].contiguous())
        halves.append(part)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.cat(halves))


def test_diagonal_target_above_bit_31(card):
    """A diagonal on qubits (32, 3) of a 33-qubit state (64 GiB): a
    sparse state (basis amplitudes with qubit 32 and qubit 3 set and
    clear) gets each amplitude times the table entry its bits select, on
    K1; the rest stays 0 (a norm summed in chunks)."""
    n = 33
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    assert free >= (2 << n) * 4 + (1 << 30), "needs 65 GiB free on the card"
    rng = np.random.default_rng(33)
    table = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
    arr = np.stack([table.real, table.imag]).astype(np.float32)
    seg = S.prepare_segment([BP.DiagVecStage((32, 3), (), ())], [arr], n,
                            card)
    idx = [0, 8, (1 << 32) + 5, (1 << 32) + 8 + 130, (1 << 31) + 9,
           (1 << 33) - 1]
    vals = rng.standard_normal((len(idx), 2)).astype(np.float32)
    amps = torch.zeros((2, 1 << n), device=card)
    for k, i in enumerate(idx):
        amps[0, i], amps[1, i] = float(vals[k, 0]), float(vals[k, 1])
    S.segment_sweep(amps, seg)
    torch.cuda.synchronize()
    norm = sum(amps[:, a:a + (1 << 26)].double().pow(2).sum().item()
               for a in range(0, 1 << n, 1 << 26))
    want_norm = 0.0
    for k, i in enumerate(idx):
        e = ((i >> 32) & 1) | (((i >> 3) & 1) << 1)
        w = complex(vals[k, 0], vals[k, 1]) * complex(arr[0, e], arr[1, e])
        got = complex(amps[0, i].item(), amps[1, i].item())
        assert abs(got - w) <= 1e-6, (i, got, w)
        want_norm += abs(w) ** 2
    assert abs(norm - want_norm) <= 1e-6
    del amps
    torch.cuda.empty_cache()


# ---- the ring drivers' tensor-map copies on scattered-row tiles ----------


def _tma_case(name):
    cases = chip_smoke.tma_cases(np.random.default_rng(_SEED))
    return next(c for c in cases if c[0] == name)


@pytest.mark.parametrize("driver,nbuf", RING_DRIVERS[:3],
                         ids=lambda v: str(v))
@pytest.mark.parametrize(
    "name", [c[0] for c in chip_smoke.tma_cases(np.random.default_rng(0))])
def test_scattered_geometries_match_grid_and_plain(card, name, driver, nbuf):
    """The scattered-row geometries of the paths' plans ((0,(7,)),
    (4,(1,1,1)), (0,(6,1)), (5,(1,1))) over 5 states of 20 qubits, ending
    in a diagonal with a lane and a row control: K1 and K2 (2 and 3
    slots), which move the tiles as tensor-map boxes part by part, give
    K3's planes bit for bit, and K3 is within STAGE_TOL of the plain
    version."""
    _, n, batch, stages, arrays, groups = _tma_case(name)
    seg = S.prepare_segment(stages, arrays, n, "cpu")
    assert chip_smoke.geometry_groups(seg.geometry) == groups
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    got = _run(card, stages, arrays, n, planes, driver, nbuf)
    want = _run(card, stages, arrays, n, planes, "grid", 3)
    assert torch.equal(got, want)
    plain = S.segment_sweep_reference(planes, stages, [
        torch.from_numpy(a).to(card) for a in arrays], n)
    scale = plain.abs().max().item()
    err = (want - plain.reshape(want.shape)).abs().max().item()
    assert err <= chip_smoke.STAGE_TOL * scale


@pytest.mark.parametrize(
    "name", [c[0] for c in chip_smoke.tma_cases(np.random.default_rng(0))])
def test_copy_units_give_the_same_planes(card, name):
    """Every copy unit a geometry takes under K1 — 512-byte rows, one box
    per plane, 2 or 4 parts — moves the same bytes: the planes are
    identical to the default unit's."""
    _, n, batch, stages, arrays, _ = _tma_case(name)
    seg = S.prepare_segment(stages, arrays, n, card, driver="decoupled")
    planes = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    want = S.segment_sweep(planes.clone(), seg)
    for unit in ((4, 1), (1, None), (2, None), (4, 2), (4, None)):
        got = S.segment_sweep(planes.clone(), seg, copy_unit=unit)
        torch.cuda.synchronize()
        assert torch.equal(got, want), unit


@pytest.mark.parametrize("seed", range(4))
def test_tensor_map_model_matches_the_kernel(card, seed):
    """band_plan.tma_boxes against the kernel's own tma_geometry
    (quest_segment_tma_geometry, through ops.segment.tma_unit) on seeded
    random geometries of 12 to 33 qubits and batches up to 65,539, under
    every copy unit; and the map encodes for each (no device memory is
    touched: the address is only recorded)."""
    rng = np.random.default_rng(seed)
    lib = S._lib()
    amps = torch.zeros(4, device=card)
    for _ in range(8):
        n = int(rng.integers(12, 34))
        k = int(rng.integers(0, 8))
        scat = rng.choice(n - 7, size=min(k, n - 7), replace=False)
        stages = [BP.MatStage("sc", 2, False, (), (), int(b)) for b in scat]
        seg = S.prepare_segment(stages, [np.stack(
            [np.eye(2), np.zeros((2, 2))]).astype(np.float32)] * len(stages),
            n, "cpu")
        geo = seg.geometry
        if not 10 <= geo.tile_bits <= 14:
            continue
        batch = int(rng.choice([1, 3, 65539]))
        for parts in (1, 2, 4):
            boxes = S.tma_unit(seg, batch, (parts, None))
            assert boxes["parts"] == parts
            rc = lib.quest_segment_tma_encode(
                amps.data_ptr(), n, geo.tile_bits, geo.inner_bits,
                seg.scat_mask, batch, parts, boxes["box_rows"], 1)
            assert rc == 0, (geo, batch, parts, rc)


def test_refused_tensor_map_raises(card, monkeypatch):
    """A copy unit the kernel's side refuses makes the launch fail and the
    wrapper raise, with no launch counted; a map the driver cannot encode
    (a misaligned address) returns the encoder's error rather than
    falling back to another copy."""
    n = 16
    seg = S.prepare_segment([], [], n, card, driver="decoupled")
    amps = torch.zeros((2, 1 << n), device=card)
    monkeypatch.setattr(S, "tma_unit", lambda *a, **k: {"parts": 3,
                                                        "box_rows": 1})
    before = S.segment_sweep.launches
    with pytest.raises(RuntimeError, match="launch"):
        S.segment_sweep(amps, seg)
    assert S.segment_sweep.launches == before
    lib = S._lib()
    geo = seg.geometry
    rc = lib.quest_segment_tma_encode(
        amps.data_ptr() + 4, n, geo.tile_bits, geo.inner_bits, seg.scat_mask,
        1, 1, 128, 1)
    assert rc >= 10000
    assert b"cuTensorMapEncodeTiled" in lib.quest_cuda_error_string(rc)


# ---- K3's tensor-map copies; S7's factored angles ---------------------------


@pytest.mark.parametrize(
    "name", [c[0] for c in chip_smoke.tma_cases(np.random.default_rng(0))])
def test_grid_driver_matches_decoupled_under_every_copy_unit(card, name):
    """K3 moves its tiles through the launch's tensor map: on every
    scattered-row geometry of tma_cases (5 states of 20 qubits), under
    every copy unit the geometry takes (512-byte rows, one box a plane, 2
    and 4 parts), its planes equal K1's bit for bit."""
    _, n, batch, stages, arrays, _ = _tma_case(name)
    planes = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (batch, 2, 1 << n)).astype(np.float32)).to(card)
    want = _run(card, stages, arrays, n, planes, "decoupled", 3)
    seg = S.prepare_segment(stages, arrays, n, card, driver="grid")
    for unit in (None, (4, 1), (1, None), (2, None), (4, None)):
        got = S.segment_sweep(planes.clone(), seg, copy_unit=unit)
        torch.cuda.synchronize()
        assert torch.equal(got, want), unit


def _multiphase_case(name):
    cases = chip_smoke.multiphase_cases(np.random.default_rng(_SEED))
    return next(c for c in cases if c[0] == name)


@pytest.mark.parametrize(
    "name",
    [c[0] for c in chip_smoke.multiphase_cases(np.random.default_rng(0))])
def test_multiphase_on_every_driver(card, name):
    """S7 at 1, 2 (the main paths' two all-ones terms), 8 and 64 terms,
    after an scb-4 stage on row bit 9, at 20 qubits: K1, K2 at 2 and 3
    slots and K3 give the same planes bit for bit, within STAGE_TOL of
    the plain version."""
    _, n, stages, arrays = _multiphase_case(name)
    planes = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 1 << n)).astype(np.float32)).to(card)
    outs = [_run(card, stages, arrays, n, planes, driver, nbuf)
            for driver, nbuf in RING_DRIVERS[:3] + [("grid", 3)]]
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    plain = S.segment_sweep_reference(planes, stages, [
        torch.from_numpy(a).to(card) for a in arrays], n)
    scale = plain.abs().max().item()
    err = (outs[0] - plain.reshape(outs[0].shape)).abs().max().item()
    assert err <= chip_smoke.STAGE_TOL * scale


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("engine", ["compiled", "compiled_banded",
                                    "compiled_fused"])
def test_xla_engines_on_the_card_match_the_cpu(card, engine, dtype):
    """The per-gate and banded engines, and the fused engine's passthroughs
    (f32) or f64 route, on the card against the same program on the CPU;
    an f64 or sub-tier program launches no segment kernel."""
    from quest_tpu_torch import precision as P
    from quest_tpu_torch.entry import wide_gates_circuit
    from quest_tpu_torch.state import basis_planes
    n = 14
    c = wide_gates_circuit(n)
    rdt = P.real_dtype_of(dtype)
    out = {}
    for dev in ("cpu", "cuda"):
        fn = getattr(c, engine)(n, device=dev)
        amps = basis_planes(0, n=n, rdt=rdt, device=dev)
        if engine == "compiled_fused" and rdt == np.float32:
            amps = amps.reshape(2, -1, 128)
        before = S.segment_sweep.launches
        out[dev] = fn(amps).reshape(2, -1).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            kernel = engine == "compiled_fused" and rdt == np.float32
            assert (S.segment_sweep.launches > before) == kernel
    tol = 1e-4 if rdt == np.float32 else 1e-12
    scale = out["cpu"].abs().max().item()
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= tol * scale


# ---- S5/S6 runs and the tile skip of phase-only launches ----

ALL_DRIVERS = [("decoupled", 3), ("inplace", 3), ("grid", 3)]


def _diag_ops(rng, k, row_bits, unit=True):
    """k random phase and parity stages (masks over the lanes and
    `row_bits` row bits; every third stage has no lane mask and every
    third no row mask, so at most a third have both); with `unit` False
    one factor has modulus 1.5, so every run keeps the exact form."""
    ops = []
    for s in range(k):
        lm = int(rng.integers(0, 128)) * (s % 3 != 0)
        rm = int(rng.integers(0, 1 << row_bits)) * (s % 3 != 1)
        if s % 2:
            h = rng.uniform(0, np.pi)
            ops.append((BP.ParityStage(), np.array(
                [[np.cos(h), np.sin(h), lm, rm & 0x7FFF, rm >> 15, 0, 0, 0]],
                np.float32)))
        else:
            t = np.exp(1j * rng.uniform(0, 2 * np.pi)) * (1 if unit or s
                                                          else 1.5)
            lw, rw = lm & int(rng.integers(0, 128)), rm & int(
                rng.integers(0, 1 << row_bits))
            ops.append((BP.PhaseStage(), np.array(
                [[t.real, t.imag, lm, lw, rm & 0x7FFF, rm >> 15, rw & 0x7FFF,
                  rw >> 15]], np.float32)))
    return [s for s, _ in ops], [a for _, a in ops]


@pytest.mark.parametrize("driver,nbuf", ALL_DRIVERS, ids=lambda v: str(v))
@pytest.mark.parametrize("k", [2, 7, 20, 64])
def test_exact_run_equals_its_stages_one_per_segment(card, k, driver, nbuf):
    """A run of k S5/S6 stages that keeps the exact form (a factor of
    modulus 1.5 in it) gives, under each driver, the planes of the same k
    stages launched as k one-stage segments, bit for bit."""
    n = 20
    rng = np.random.default_rng(k)
    stages, arrays = _diag_ops(rng, k, n - 7, unit=False)
    planes = torch.from_numpy(rng.standard_normal((2, 1 << n)).astype(
        np.float32)).to(card)
    seg = S.prepare_segment(stages, arrays, n, card, driver=driver, nbuf=nbuf)
    assert not seg.desc[0, S.F_FORMS].item() & 1
    got = planes.clone()
    S.segment_sweep(got, seg)
    want = planes.clone()
    for st, arr in zip(stages, arrays):
        S.segment_sweep(want, S.prepare_segment([st], [arr], n, card,
                                                driver=driver, nbuf=nbuf))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [8, 30, 64])
def test_angle_form_run_matches_plain_on_every_driver(card, k):
    """A unit-modulus run of k >= 8 stages takes the angle form: within
    1e-5 x max|amp| of the plain version and of its stages one per
    segment, and bit for bit the same under K1, K2 and K3."""
    n = 20
    rng = np.random.default_rng(100 + k)
    stages, arrays = _diag_ops(rng, k, n - 7)
    planes = torch.from_numpy(rng.standard_normal((2, 1 << n)).astype(
        np.float32)).to(card)
    want = S.segment_sweep_reference(planes, stages, arrays, n).reshape(
        planes.shape)
    scale = want.abs().max().item()
    outs = []
    for driver, nbuf in ALL_DRIVERS:
        seg = S.prepare_segment(stages, arrays, n, card, driver=driver,
                                nbuf=nbuf)
        assert seg.desc[0, S.F_FORMS].item() & 1
        got = planes.clone()
        S.segment_sweep(got, seg)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5 * scale
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("driver,nbuf", ALL_DRIVERS, ids=lambda v: str(v))
@pytest.mark.parametrize("batch", [0, 5])
def test_skipped_tiles_stay_as_they_were(card, batch, driver, nbuf):
    """Phase stages only, every one fixing row bits 12 and 9: the launch
    runs a quarter of the tiles; against the plain version, and every row
    outside them byte-equal to the input."""
    n = 21
    rng = np.random.default_rng(7 + batch)
    stages, arrays = [], []
    for lm, lw, extra in ((1, 1, 1 << 3), (0, 0, 1 << 5), (6, 2, 0)):
        rm, rw = (1 << 12) | (1 << 9) | extra, 1 << 12
        t = np.exp(1j * rng.uniform(0, 2 * np.pi))
        stages.append(BP.PhaseStage())
        arrays.append(np.array([[t.real, t.imag, lm, lw, rm & 0x7FFF,
                                 rm >> 15, rw & 0x7FFF, rw >> 15]],
                               np.float32))
    seg = S.prepare_segment(stages, arrays, n, card, driver=driver, nbuf=nbuf)
    assert seg.fixed_mask == (1 << 12) | (1 << 9)
    assert seg.tiles == seg.geometry.blocks // 4
    shape = (batch, 2, 1 << n) if batch else (2, 1 << n)
    planes = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card)
    want = S.segment_sweep_reference(planes, stages, arrays, n).reshape(shape)
    got = planes.clone()
    S.segment_sweep(got, seg)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    rows = torch.arange(1 << (n - 7), device=card)
    out = (rows & seg.fixed_mask) != seg.fixed_rows
    view = (-1, 2, 1 << (n - 7), 128)
    assert torch.equal(got.reshape(view)[:, :, out],
                       planes.reshape(view)[:, :, out])


def test_skipped_tiles_above_the_grid_limit(card):
    """65,539 states of 10 qubits under K3 (slices of 65,535) through a
    phase-only segment on row bit 2 (10 qubits: inner rows only, no skip)
    and a 17-qubit batch of 600 states whose free row bit 8 is fixed: the
    plain version's planes, the rows outside the launched tiles byte-equal
    to the input."""
    for n, batch, rb in ((10, BIG_BATCH, 1 << 2), (17, 600, 1 << 8)):
        rng = np.random.default_rng(n)
        t = np.exp(1j * rng.uniform(0, 2 * np.pi))
        arr = np.array([[t.real, t.imag, 1, 1, rb, 0, rb, 0]], np.float32)
        seg = S.prepare_segment([BP.PhaseStage()], [arr], n, card,
                                driver="grid")
        planes = torch.from_numpy(rng.standard_normal(
            (batch, 2, 1 << n)).astype(np.float32)).to(card)
        want = S.segment_sweep_reference(planes, seg.stages, seg.operands, n)
        got = planes.clone()
        S.segment_sweep(got, seg)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        assert (got - want.reshape(got.shape)).abs().max().item() <= (
            1e-5 * scale)
        rows = torch.arange(1 << (n - 7), device=card)
        out = (rows & rb) == 0
        view = (batch, 2, 1 << (n - 7), 128)
        assert torch.equal(got.reshape(view)[:, :, out],
                           planes.reshape(view)[:, :, out])


# -- the QuEST user surface on the card (no kernel: plain tensor code on
# the card's tensors, held against the same functions on the CPU) --------


def _random_qureg(n, seed, device):
    from quest_tpu_torch.state import Qureg
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 1 << n))
    v /= np.sqrt((v ** 2).sum())
    return Qureg(amps=torch.from_numpy(v.astype(np.float32)).to(device),
                 num_qubits=n)


def test_measurement_on_the_card_matches_the_cpu(card):
    """calc_prob_of_outcome, collapse_to_outcome and the drawing-free
    measurement at 22 qubits: the card against the CPU within 1e-6."""
    from quest_tpu_torch import measurement as TM
    n = 22
    on, off = _random_qureg(n, 1, card), _random_qureg(n, 1, "cpu")
    for qubit in (0, 7, 21):
        assert abs(TM.calc_prob_of_outcome(on, qubit, 1)
                   - TM.calc_prob_of_outcome(off, qubit, 1)) <= 1e-6
    _, p_on = TM.collapse_to_outcome(on, 7, 1)
    _, p_off = TM.collapse_to_outcome(off, 7, 1)
    assert abs(p_on - p_off) <= 1e-6
    scale = off.amps.abs().max().item()
    assert (on.amps.cpu() - off.amps).abs().max().item() <= 1e-6 * scale
    for u in (0.1, 0.7):
        o_on = TM._measure_given_uniform(on.amps, u, n=n, qubit=3,
                                         density=False)
        o_off = TM._measure_given_uniform(off.amps, u, n=n, qubit=3,
                                          density=False)
        assert o_on[0] == o_off[0] and abs(o_on[1] - o_off[1]) <= 1e-6


def test_sampling_on_the_card_matches_the_cpu(card):
    """Inverse-CDF sampling at 22 qubits from the same uniforms: equal
    indices wherever the scaled uniform is more than 1e-6 from both
    neighbouring CPU CDF entries; elsewhere (a run of entries whose
    probabilities sit below the CDF's ulp may be cut at another place by
    the card's scan) the card's index is one the CPU CDF allows within
    1e-6: cdf[i - 1] - 1e-6 <= u < cdf[i] + 1e-6."""
    from quest_tpu_torch import measurement as TM
    n = 22
    on, off = _random_qureg(n, 2, card), _random_qureg(n, 2, "cpu")
    u = torch.rand(1 << 16, generator=torch.Generator().manual_seed(4))
    got = TM._sample_given_uniforms(on.amps, u.to(card), n=n,
                                    density=False).cpu()
    want = TM._sample_given_uniforms(off.amps, u, n=n, density=False)
    cdf = TM._stable_cdf(TM._probabilities(off.amps, n, False)).double()
    scaled = (u * cdf[-1].float()).double()
    lo = cdf[(want - 1).clamp(min=0)]
    hi = cdf[want]
    clear = ((scaled - lo).abs() > 1e-6) & ((scaled - hi).abs() > 1e-6)
    assert torch.equal(got[clear], want[clear])
    below = torch.where(got > 0, cdf[(got - 1).clamp(min=0)],
                        torch.zeros_like(scaled))
    assert bool(((below - 1e-6 <= scaled) & (scaled < cdf[got] + 1e-6)).all())
    samples = TM.sample(on, 1 << 16, torch.Generator(device=card).manual_seed(1))
    assert samples.device.type == "cuda" and samples.shape == (1 << 16,)


def test_dynamic_circuit_on_the_card_matches_the_cpu(card):
    """entry.measured_entry at 20 data qubits + 2 ancillas under both
    engines: the card's outcomes equal the CPU's from one seed, planes
    within 1e-5 x max|amp|."""
    from quest_tpu_torch.entry import measured_entry
    for engine in ("banded", "xla"):
        fn, (amps, gen) = measured_entry(card, n_data=20, engine=engine)
        fc, (amps_c, gen_c) = measured_entry("cpu", n_data=20, engine=engine)
        got, outs = fn(amps, gen)
        want, outs_c = fc(amps_c, gen_c)
        assert torch.equal(outs, outs_c)
        scale = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale


def test_eager_gates_and_calculations_on_the_card(card):
    """A sequence of eager gates, a channel and the calculations at 20
    qubits (a 10-qubit density register): the card against the CPU."""
    from quest_tpu_torch import calculations as TK
    from quest_tpu_torch.ops import channels as TCH
    from quest_tpu_torch.ops import gates as TG
    from quest_tpu_torch.state import create_density_qureg
    n = 20
    regs = [_random_qureg(n, 3, d) for d in (card, "cpu")]
    for q in regs:
        TG.hadamard(q, 19)
        TG.controlled_rotate_x(q, 3, 12, 0.4)
        TG.multi_rotate_pauli(q, [0, 9, 18], [1, 2, 3], 0.3)
        TG.multi_qubit_unitary(q, [2, 15], np.kron(
            np.array([[0, 1], [1, 0]]), np.eye(2)))
    on, off = regs
    scale = off.amps.abs().max().item()
    assert (on.amps.cpu() - off.amps).abs().max().item() <= 1e-5 * scale
    codes = [[3] * n, [1 if i % 3 == 0 else 0 for i in range(n)]]
    assert abs(TK.calc_expec_pauli_sum(on, codes, [0.5, -1.0])
               - TK.calc_expec_pauli_sum(off, codes, [0.5, -1.0])) <= 1e-5
    assert abs(TK.calc_inner_product(on, on) - 1.0) <= 1e-5
    rhos = [create_density_qureg(10, device=d) for d in (card, "cpu")]
    for r in rhos:
        TG.hadamard(r, 4)
        TCH.mix_depolarising(r, 4, 0.2)
        TCH.mix_dephasing(r, 1, 0.1)
    assert abs(TK.calc_purity(rhos[0]) - TK.calc_purity(rhos[1])) <= 1e-6


def test_fused_trotter_quench_matches_banded(card):
    """The TFIM quench at 20 qubits through the fused engine (K1 launches
    of the pooled Trotter step) against the banded engine on the card:
    planes within 1e-4 x max|amp|, energies within 1e-5 relative."""
    from quest_tpu_torch.entry import evolution_entry
    fused_fn, (q,) = evolution_entry(card, num_qubits=20, steps=3)
    banded_fn, (qb,) = evolution_entry(card, num_qubits=20, steps=3,
                                       engine="banded")
    fused, banded = fused_fn(q), banded_fn(qb)
    assert fused.stats["engine"] == "fused" and fused.stats["launches"] > 0
    scale = banded.state.amps.abs().max().item()
    assert ((fused.state.amps.reshape(2, -1)
             - banded.state.amps.reshape(2, -1)).abs().max().item()
            <= 1e-4 * scale)
    np.testing.assert_allclose(fused.energies, banded.energies, rtol=1e-5)


def test_adjoint_matches_taped_on_the_card(card):
    """The hardware-efficient ansatz at 16 qubits: the adjoint walk
    against taped autograd on the card, values within 1e-5 and
    gradients within 1e-4."""
    from quest_tpu_torch.entry import vqe_entry
    adj, (theta,) = vqe_entry(card, num_qubits=16, layers=2)
    tap = vqe_entry(card, num_qubits=16, layers=2, engine="taped")[0]
    va, ga = adj(theta)
    vt, gt = tap(theta)
    assert abs(float(va) - float(vt)) <= 1e-5
    assert (ga - gt).abs().max().item() <= 1e-4


@pytest.mark.parametrize("cls", ["qft", "qaoa", "adder"])
def test_frontend_entry_matches_its_plain_path(card, cls, tmp_path,
                                               monkeypatch):
    """A gallery class at 20 qubits through the front ends on the card
    (QASM -> from_qasm -> autotune -> the chosen engine's program), held
    against the same (maybe transpiled) stream through the fused engine's
    plain PyTorch version on the card and against the raw stream's banded
    program: planes within 1e-4 x max|amp|."""
    from quest_tpu_torch import plan as P
    from quest_tpu_torch.entry import frontend_entry
    monkeypatch.setenv("QUEST_PLAN_CACHE_DIR", str(tmp_path))
    fn, (amps,) = frontend_entry(card, num_qubits=20, cls=cls)
    start = amps.clone()
    out = fn(amps).reshape(2, -1)
    ran = P.planned_circuit(fn.circuit, fn.plan)
    plain = ran.compiled_fused(20, device=card).plain(start.clone())
    raw = fn.circuit.compiled_banded(20, device=card)(start.clone())
    scale = plain.abs().max().item()
    assert (out - plain.reshape(2, -1)).abs().max().item() <= 1e-4 * scale
    assert (out - raw.reshape(2, -1)).abs().max().item() <= 1e-4 * scale


def test_tutorial_through_the_api_on_the_card(card):
    """The reference tutorial through quest_tpu_torch.api on the card:
    the reference binary's numbers, and the recorded QASM equal to the
    same script's on the CPU."""
    from quest_tpu_torch import api as Q

    def tutorial(env):
        q = Q.createQureg(3, env)
        Q.startRecordingQASM(q)
        Q.hadamard(q, 0)
        Q.controlledNot(q, 0, 1)
        Q.rotateY(q, 2, 0.1)
        Q.multiControlledPhaseFlip(q, [0, 1, 2])
        u = np.array([[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]])
        Q.unitary(q, 0, u)
        a, b = 0.5 + 0.5j, 0.5 - 0.5j
        Q.compactUnitary(q, 1, a, b)
        Q.rotateAroundAxis(q, 2, 3.14 / 2, (1.0, 0.0, 0.0))
        Q.controlledCompactUnitary(q, 0, 1, a, b)
        Q.multiControlledUnitary(q, [0, 1], 2, u)
        toff = Q.createComplexMatrixN(3)
        toff[6, 7] = toff[7, 6] = 1
        for i in range(6):
            toff[i, i] = 1
        Q.multiQubitUnitary(q, [0, 1, 2], toff)
        return (Q.getProbAmp(q, 7), Q.calcProbOfOutcome(q, 2, 1),
                q.qasm.recorded())
    p7, p2, text = tutorial(Q.createQuESTEnv())
    assert abs(p7 - 0.112422) <= 1e-6 and abs(p2 - 0.749178) <= 1e-6
    assert text == tutorial(Q.createQuESTEnv(devices="cpu"))[2]


# -- the sharded engines and the scan (ROADMAP A10, A4.4) --------------------

def _shards_of(planes, mesh, n):
    from quest_tpu_torch.parallel import shard_planes
    return shard_planes(planes, mesh, n)


def test_sharded_fused_engine_on_one_card(card):
    """Four shards of one card (the repeated-device mesh): the fused
    engine launches the segment kernel on every shard, is bit for bit a
    hand replay of its parts shard by shard, and agrees with its plain
    version and with the single-register fused program."""
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.parallel import make_amp_mesh
    from quest_tpu_torch.parallel import sharded as SH
    n, d = 16, 4
    mesh = make_amp_mesh(d, devices=[card] * d)
    c = random_circuit(n, 4, seed=3)
    prog = c.compiled_sharded_fused(n, False, mesh)
    assert prog.kind == "fused" and prog.kernel_parts >= 1
    planes = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1 << n)).astype(np.float32)).to(card)
    planes /= planes.double().pow(2).sum().sqrt().float()
    x = _shards_of(planes, mesh, n)
    S.segment_sweep.launches = 0
    mesh.recorder.reset()
    prog(x)
    torch.cuda.synchronize()
    assert S.segment_sweep.launches == prog.launches_per_call
    assert S.segment_sweep.launches == prog.kernel_parts * d
    # the hand replay: each kernel part launched shard by shard
    y = _shards_of(planes, mesh, n)
    xs = [s.view(1, 2, -1) for s in y.shards]
    for i, part in enumerate(prog.parts):
        if part[0] == "segment":
            for k in range(d):
                S.segment_sweep(y.shards[k], prog.segments[(i, str(card))])
        else:
            SH._apply_plan_item(xs, mesh, prog.local_n, n, part[1], prog.tier)
    for a, b in zip(x.shards, y.shards):
        assert torch.equal(a, b)
    want = prog.plain(_shards_of(planes, mesh, n)).gather()
    got = x.gather()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    single = c.compiled_fused(n, device=card)(planes.clone().reshape(
        2, -1, 128)).reshape(2, -1)
    assert (got - single).abs().max().item() <= 1e-5 * scale


def test_exchanges_on_repeated_devices_read_no_overwritten_chunk(card):
    """Every routed exchange on shards that share the card, against the
    same program on CPU shards (no aliasing: each shard receives before
    any writes)."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.parallel import make_amp_mesh
    from quest_tpu_torch.parallel import sharded as SH
    n, d = 9, 8
    rng = np.random.default_rng(4)
    u2 = np.linalg.qr(rng.standard_normal((4, 4))
                      + 1j * rng.standard_normal((4, 4)))[0]
    c = Circuit(n)
    for q in range(n):
        c.h(q)
    c.cnot(0, n - 1).swap(1, n - 2).gate(u2, (2, n - 1)).gate(u2, (n - 2,
                                                                  n - 1))
    c.rx(n - 1, 0.4).cz(0, n - 1)
    planes = torch.from_numpy(rng.standard_normal((2, 1 << n)))
    for build in (SH.compile_circuit_sharded,
                  SH.compile_circuit_sharded_banded):
        outs = []
        for dev in ("cpu", card):
            mesh = make_amp_mesh(d, devices=[dev] * d)
            outs.append(build(c.ops, n, False, mesh)(
                _shards_of(planes.to(dev), mesh, n)).gather().cpu())
        assert (outs[0] - outs[1]).abs().max().item() <= 1e-12


def test_scan_on_the_card_is_bit_for_bit(card, monkeypatch):
    from quest_tpu_torch import circuit as TC
    from quest_tpu_torch import entry as E
    n = 14
    c = E.diag_layer_circuit(n)
    planes = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 1 << n)).astype(np.float32)).to(card)
    outs, progs = {}, {}
    for flag in ("0", "1"):
        monkeypatch.setenv("QUEST_FUSED_SCAN", flag)
        progs[flag] = prog = c.compiled_fused(n, iters=8, device=card)
        outs[flag] = prog(planes.clone().reshape(2, -1, 128))
    parts, _ = c.fused_parts(n, 8)
    assert any(g[0] == "scan" for g in TC._scan_partition(parts, TC.SCAN_MIN))
    assert progs["0"] is not progs["1"]
    assert progs["0"].launches_per_call == progs["1"].launches_per_call
    assert torch.equal(outs["0"], outs["1"])


def test_sharded_eager_surface_on_the_card(card):
    """The eager surface on four shards of the card equals the same calls
    on one register of the card: gates on global qubits, reductions,
    measurement given the same stream, the sampler given the same
    uniforms, the grouped expectation (one exchange a global mask)."""
    from quest_tpu_torch import calculations as K
    from quest_tpu_torch import measurement as MS
    from quest_tpu_torch import random_ as RNG
    from quest_tpu_torch import state as TS
    from quest_tpu_torch.ops import gates as G
    from quest_tpu_torch.parallel import make_amp_mesh, shard_qureg
    n, d = 14, 4
    mesh = make_amp_mesh(d, devices=[card] * d)
    one = TS.init_plus_state(TS.create_qureg(n, device=card))
    sq = shard_qureg(TS.clone(one), mesh)
    for q in (one, sq):
        G.hadamard(q, n - 1)
        G.controlled_not(q, n - 1, 0)
        G.rotate_y(q, n - 2, 0.7)
        G.multi_rotate_pauli(q, (0, n - 1), (1, 2), 0.3)
        G.controlled_phase_shift(q, 3, n - 1, 0.9)
    got = torch.cat([s.reshape(2, -1) for s in sq.amps.shards], -1)
    assert (got - one.amps).abs().max().item() <= 2e-5
    assert abs(K.calc_total_prob(sq) - K.calc_total_prob(one)) <= 1e-6
    for qubit in (1, n - 1):
        assert abs(MS.calc_prob_of_outcome(sq, qubit, 1)
                   - MS.calc_prob_of_outcome(one, qubit, 1)) <= 1e-6
    u = torch.rand(1 << 12, generator=torch.Generator(device=card)
                   .manual_seed(1), dtype=torch.float32, device=card)
    a = MS._sample_given_uniforms(one.amps, u, n=n, density=False)
    b = MS._sample_sharded_given_uniforms(sq, u)
    assert (a == b).double().mean().item() >= 0.999
    codes = np.zeros((3, n), int)
    codes[0, n - 1] = 1
    codes[1, 0], codes[1, n - 2] = 3, 2
    codes[2, 5] = 1
    mesh.recorder.reset()
    e1 = K.calc_expec_pauli_sum(sq, codes, [0.5, -1.0, 0.25])
    assert abs(e1 - K.calc_expec_pauli_sum(one, codes, [0.5, -1.0, 0.25])) \
        <= 1e-5
    assert mesh.recorder.stats(d)["collective_permutes"] == 2
    RNG.seed_quest([7])
    _, o1 = MS.measure(one, n - 1)
    RNG.seed_quest([7])
    _, o2 = MS.measure(sq, n - 1)
    assert o1 == o2


def test_durable_resume_through_k1_on_the_card(card, monkeypatch, tmp_path):
    """run_durable on one register of the card (one K1 launch a step) and
    on four of its shards, preempted and resumed: bit for bit the
    uninterrupted run and the whole compiled_fused /
    compiled_sharded_fused program, with K1 launched."""
    from quest_tpu_torch import state as TS
    from quest_tpu_torch.parallel import make_amp_mesh, shard_planes
    from quest_tpu_torch.resilience import FaultPlan, faults, run_durable
    from quest_tpu_torch.circuit import Circuit
    monkeypatch.setenv("QUEST_SWEEP_FUSION", "0")
    n = 14
    # rotation layers split by random 2q unitaries on far-apart qubits:
    # passthroughs and segments to cut between
    rng = np.random.default_rng(9)
    c = Circuit(n)
    for layer in range(12):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
        u = np.linalg.qr(rng.normal(size=(4, 4))
                         + 1j * rng.normal(size=(4, 4)))[0]
        c.gate(u, (layer % (n // 2), n - 1 - (layer % (n // 2))))
    for mesh in (None, make_amp_mesh(4, devices=[card] * 4)):
        q0 = TS.init_plus_state(TS.create_qureg(n, device=card))
        S.segment_sweep.launches = 0
        ref = run_durable(c, q0, str(tmp_path / "ref"), every=1000,
                          mesh=mesh)
        torch.cuda.synchronize()
        assert S.segment_sweep.launches > 0
        d = str(tmp_path / ("pre" if mesh is None else "pre4"))
        plan = FaultPlan().inject("durable.preempt", after_n=2, times=1)
        with faults.active(plan):
            with pytest.raises(faults.InjectedFault):
                run_durable(c, q0, d, every=1, mesh=mesh)
        out = run_durable(c, q0, d, every=1, mesh=mesh)
        if mesh is None:
            whole = TS.init_plus_state(TS.create_qureg(n, device=card)).amps
            c.compiled_fused(n, device=card)(whole)
            assert torch.equal(out.amps, ref.amps)
            assert torch.equal(out.amps.reshape(2, -1), whole.reshape(2, -1))
        else:
            x = shard_planes(TS.init_plus_state(TS.create_qureg(
                n, device=card)).amps, mesh, n)
            c.compiled_sharded_fused(n, False, mesh)(x)
            for a, b, w in zip(out.amps.shards, ref.amps.shards, x.shards):
                assert torch.equal(a, b) and torch.equal(a, w)


@pytest.fixture
def serving_card(card):
    """The card with the segment kernel and the native host library
    built, so that the serving tests' future timeouts never include a
    compiler's minutes; prints how long each build took."""
    import time
    from quest_tpu_torch import native
    from quest_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    S._lib()
    t1 = time.perf_counter()
    native.build()
    print(f"serving_card: segment kernel {t1 - t0:.1f} s, native host "
          f"library {time.perf_counter() - t1:.1f} s")
    return card


def _served(eng, fut, timeout=120):
    """fut's result; on a timeout, the engine's health and every serving
    thread's stack, so a stall shows where the worker waits."""
    import concurrent.futures
    import sys
    import threading
    import traceback
    try:
        return fut.result(timeout=timeout)
    except concurrent.futures.TimeoutError:
        frames = sys._current_frames()
        stacks = {t.name: "".join(traceback.format_stack(frames[t.ident]))
                  for t in threading.enumerate()
                  if t.name.startswith("quest-serve") and t.ident in frames}
        raise AssertionError(f"no result in {timeout} s; health "
                             f"{eng.health()}; threads {stacks}") from None


def _serve_states(n, b, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, 2, 1 << n)).astype(np.float32)
    return s / np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))


def test_serve_apply_stream_through_batched_k1(serving_card):
    """Coalesced apply requests on the card: one batched K1 sweep a
    segment for the whole batch, outputs within 1e-4 x max|amp| of each
    state alone through compiled_fused, no degraded dispatch."""
    card = serving_card
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.serve import ServeEngine, metrics
    n, b = 14, 16
    c = random_circuit(n, 3, seed=5)
    states = _serve_states(n, b, 7)
    fn = c.compiled_fused(n, device=card)
    reg = metrics.Registry()
    S.segment_sweep.launches = 0
    with ServeEngine(device=card, max_wait_ms=10_000, max_batch=b,
                     registry=reg) as eng:
        futs = [eng.submit(c, state=s) for s in states]
        outs = [_served(eng, f) for f in futs]
    assert S.segment_sweep.launches == fn.launches_per_call
    for s, got in zip(states, outs):
        want = torch.from_numpy(s).to(card)
        fn(want.view(2, -1))
        want = want.reshape(2, -1).cpu()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    snap = reg.snapshot()["counters"]
    assert snap["serve_batches_dispatched"] == 1
    assert snap.get("serve_degraded_dispatches", 0) == 0


def test_serve_trajectories_on_the_card_draw_like_run_batched(serving_card):
    """Two coalesced trajectory requests on the card (K1 with S9): their
    draws equal run_batched's from the same generator states, and their
    planes agree within 1e-4."""
    card = serving_card
    from quest_tpu_torch import entry as E
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.serve import ServeEngine
    n = 12
    c = E.noisy_rcs_circuit(n, 2)
    with ServeEngine(device=card, max_wait_ms=10_000, max_batch=8) as eng:
        futs = [eng.submit(c, shots=6, seed=s) for s in (0, 1)]
        got = [_served(eng, f) for f in futs]
    for s, (p, d) in zip((0, 1), got):
        wp, wd = T.run_batched(c, 6, generator=torch.Generator().manual_seed(s),
                               device=card)
        assert torch.equal(d, wd.cpu())
        assert (p - wp.cpu()).abs().max() <= 1e-4


def test_serve_ladder_on_the_card_down_to_host_and_back(serving_card):
    """Injected build failures on the card's engine: the fused failure
    that opens the breaker fails its own request; then, with banded
    failing too, requests complete on host, within 1e-4 of K1, the
    degraded dispatches counted exactly; the half-open probe restores
    fused."""
    card = serving_card
    import time
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.resilience import FaultPlan, faults
    from quest_tpu_torch.serve import ServeEngine, metrics
    n = 12
    c = random_circuit(n, 2, seed=9)
    states = _serve_states(n, 4, 3)
    fn = c.compiled_fused(n, device=card)
    plan = FaultPlan().inject(
        "serve.compile", error=RuntimeError("injected"), times=3,
        match=lambda ctx: ctx["rung"] in ("fused", "banded"))
    reg = metrics.Registry()
    with faults.active(plan):
        with ServeEngine(device=card, max_wait_ms=0, breaker_threshold=1,
                         breaker_cooldown_s=1.0, registry=reg) as eng:
            with pytest.raises(RuntimeError, match="injected"):
                _served(eng, eng.submit(c, state=states[0]))
            outs = [_served(eng, eng.submit(c, state=s))
                    for s in states[1:3]]         # host, then host
            time.sleep(1.1)
            outs.append(_served(eng, eng.submit(c, state=states[3])))
            snap = reg.snapshot()["counters"]     # the probe: fused
    assert snap["serve_degraded_dispatches"] == 2
    assert snap["serve_breaker_closes"] == 1
    for s, got in zip(states[1:], outs):
        want = torch.from_numpy(s).to(card)
        fn(want.view(2, -1))
        want = want.reshape(2, -1).cpu()
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()

def test_process_fleet_on_the_card_matches_one_engine(serving_card):
    """Two worker processes, each with its own CUDA context on the card,
    serve coalesced streams of two program families (equal circuits, two
    objects, pinned to one replica each): every output equals one
    in-process engine's bit for bit, no worker compiled anything, and
    each worker served requests and counted K1 launches."""
    card = serving_card
    import time
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.serve import ServeEngine, ServeFleet, metrics
    n, b = 14, 16
    fams = (random_circuit(n, 3, seed=5), random_circuit(n, 3, seed=5))
    states = _serve_states(n, b, 11)
    kw = dict(device=card, max_wait_ms=600_000, max_batch=b)
    with ServeEngine(registry=metrics.Registry(), **kw) as eng:
        futs = [eng.submit(fams[i % 2], state=s)
                for i, s in enumerate(states)]
        eng.drain(timeout_s=300)
        want = [_served(eng, f) for f in futs]
    with ServeFleet(replicas=2, process=True, heartbeat_s=1.0,
                    registry=metrics.Registry(), **kw) as fleet:
        futs = [fleet.submit(fams[i % 2], state=s)
                for i, s in enumerate(states)]
        fleet.drain(timeout_s=300)
        got = [f.result(timeout=300) for f in futs]
        assert all(e.hello()["cuda"]["total"] > 0 for e in fleet._engines)
        t = time.monotonic()
        deadline = t + 30
        while any(e.heartbeat().get("rx_t", 0.0) <= t
                  for e in fleet._engines):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        beats = [e.heartbeat() for e in fleet._engines]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    served = [hb["snapshot"]["counters"].get("serve_requests_served", 0)
              for hb in beats]
    launches = [hb["kernels"].get("launches", 0) for hb in beats]
    assert all(r > 0 for r in served), served
    assert all(k > 0 for k in launches), launches


def test_sigkill_of_a_card_worker_loses_no_request(serving_card):
    """A card worker SIGKILLed with 16 requests in flight: a fresh worker
    (a new CUDA context, the libraries loaded, nothing compiled) takes
    the resubmitted ledger and every output equals one engine's."""
    card = serving_card
    import os
    import signal
    from quest_tpu_torch.circuit import random_circuit
    from quest_tpu_torch.serve import ServeEngine, ServeFleet, metrics
    n, b = 14, 16
    c = random_circuit(n, 3, seed=6)
    states = _serve_states(n, b, 13)
    kw = dict(device=card, max_wait_ms=600_000, max_batch=b)
    with ServeEngine(registry=metrics.Registry(), **kw) as eng:
        futs = [eng.submit(c, state=s) for s in states]
        eng.drain(timeout_s=300)
        want = [_served(eng, f) for f in futs]
    reg = metrics.Registry()
    with ServeFleet(replicas=1, process=True, heartbeat_s=1.0,
                    registry=reg, **kw) as fleet:
        futs = [fleet.submit(c, state=s) for s in states]
        proxy = fleet._engines[0]
        assert proxy._pending == b
        old = proxy.worker_pid()
        os.kill(old, signal.SIGKILL)
        fleet.drain(timeout_s=300)
        got = [f.result(timeout=300) for f in futs]
        assert proxy.worker_pid() != old
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    snap = reg.snapshot()["counters"]
    assert snap["ipc_worker_losses"] == 1
    assert snap["ipc_worker_respawns"] == 1
    assert snap["ipc_resubmits"] == b


def test_process_fleet_trajectories_on_the_card_draw_like_run_batched(
        serving_card):
    """Two trajectory requests drawn from one generator state through a
    card worker: their draws equal run_batched's from the same state,
    the generator ends where run_batched leaves it, planes within
    1e-4."""
    card = serving_card
    from quest_tpu_torch import entry as E
    from quest_tpu_torch import trajectories as T
    from quest_tpu_torch.serve import ServeFleet, metrics
    n = 12
    c = E.noisy_rcs_circuit(n, 2)
    g = torch.Generator().manual_seed(3)
    want = [T.run_batched(c, 6, generator=g, device=card) for _ in (0, 1)]
    gen = torch.Generator().manual_seed(3)
    with ServeFleet(replicas=1, process=True, device=card, max_wait_ms=50,
                    max_batch=8, registry=metrics.Registry()) as fleet:
        futs = [fleet.submit(c, shots=6, generator=gen) for _ in (0, 1)]
        got = [f.result(timeout=300) for f in futs]
    assert torch.equal(gen.get_state(), g.get_state())
    for (p, d), (wp, wd) in zip(got, want):
        assert torch.equal(d, wd.cpu())
        assert (p - wp.cpu()).abs().max() <= 1e-4


# ---------------------------------------------------------------------------
# profiling and the runtime audits on the card
# ---------------------------------------------------------------------------


def test_trace_holds_the_planned_k1_launches(card, tmp_path):
    """The flagship step (28 qubits) inside profiling.trace and
    annotate: the kernels the region launched (read from the trace) are
    the program's planned K1 launches, and their device time is within
    10 % of the same call's CUDA-event time (at 20 qubits the ~30 us
    host gaps between launches are a third of the step)."""
    from quest_tpu_torch import profiling as P
    from quest_tpu_torch.entry import entry
    fn, (amps,) = entry(card)
    fn(amps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with P.trace(str(tmp_path)) as tr:
        with P.annotate("flagship"):
            start.record()
            fn(amps)
            end.record()
            torch.cuda.synchronize()
    kernels = P.annotated_kernels(tr.path, "flagship")
    assert len(kernels) == fn.launches_per_call
    assert all("ring_kernel<" in k["name"] and ", true>" in k["name"]
               for k in kernels)
    step_ms = start.elapsed_time(end)
    kernel_ms = sum(k["dur"] for k in kernels) / 1e3
    assert abs(kernel_ms - step_ms) <= 0.1 * step_ms, (kernel_ms, step_ms)
    m = P.op_metrics(fn, amps)
    assert (m["bound_ms"], m["bound_by"]) == P.program_bound(fn)
    assert m["segment_launches"] == fn.launches_per_call


def test_stage_report_on_the_card(card):
    """Every probe segment of the stage report at 20 qubits through the
    kernel, held against its plain version; a verdict on each."""
    import io

    from quest_tpu_torch import profiling as P
    out = io.StringIO()
    rec = P.stage_report(n=20, reps=3, out=out, check=True)
    assert list(rec) == ["phase (DMA floor)", "b0", "b1", "scb"]
    for label, r in rec.items():
        assert r["verdict"] in ("OK", "DRIFT"), label
        assert r["max_abs_err"] <= 1e-5 * r["max_amp"], label
        assert abs(1.0 - r["norm"]) <= 1e-5, label
        assert r["measured_ms"] > 0
    assert "CAUTION" not in out.getvalue()


def test_audits_on_the_card(card):
    """The golden set rebuilds nothing, and every keyed knob's flip
    misses every program cache, with the card's programs under the
    flipped driver."""
    from quest_tpu_torch.analysis import audit
    assert audit.golden_retrace_check(device=card).traces == 0
    report = audit.audit_knob_flips(device=card)
    by = {r["knob"]: r for r in report}
    assert by["QUEST_FUSED_DRIVER"]["fused_driver"] == "grid"
    assert by["QUEST_FUSED_PIPELINE"]["fused_driver"] == "inplace"
    assert by["QUEST_MATMUL_PRECISION"]["fused_tier"] == "high"
