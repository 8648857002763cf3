"""The matmul precision tiers (QUEST_MATMUL_PRECISION: default, high,
highest) of the port against numpy models and the JAX package.

  * the knob and set_matmul_precision accept what the reference's parser
    accepts and reject the rest;
  * split_hi_lo / round_bf16 equal a numpy model built from int32 bit
    masks and round-to-nearest-even;
  * the plain tier contraction of every matrix stage kind (b0; b1 and scb
    at d = 4, 16, 128; real-only and predicated) equals a numpy model
    that sums the exact bf16 products in f64, within 1e-6 x max|amp|, and
    so does the numpy model of the kernel (emulate_kernel, which reads the
    tensor-core operand fragments the packer writes);
  * each tier engages (HIGH != HIGHEST, DEFAULT != HIGH, bitwise);
  * the fused engine at 'high' agrees with quest_tpu's apply_fused
    (interpret=True) at 'high' within 5e-5 x max|amp| (JAX's CPU dots
    keep the lo part unrounded, where the port rounds it to bf16 as the
    TPU does), both within 1e-4 of HIGHEST; at 'default' the port stays
    within 1e-2 of the JAX output (JAX's CPU dots do not round DEFAULT
    to bf16) and equals the numpy kernel model within 1e-6;
  * a compiled program keeps its tier; density and batched programs and
    trajectories run at the tier.

The CUDA kernel's tier bodies run on the card (tests/test_torch_cuda.py,
chip_smoke.py); here everything runs through the plain versions.

    QUEST_MATMUL_PRECISION=high python -m pytest tests/test_torch_precision.py
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
from quest_tpu import env as JE
from quest_tpu import precision as JP

from quest_tpu_torch import calculations as TK
from quest_tpu_torch import circuit as TC
from quest_tpu_torch import precision as P
from quest_tpu_torch import state as TS
from quest_tpu_torch import trajectories as TT
from quest_tpu_torch.ops import apply as TA
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import segment as S

from tests.test_torch_density_plan import CIRCUITS
from tests.test_torch_segment import (bf16_rne, emulate_kernel,
                                      np_tier_parts)

pytestmark = pytest.mark.dtype_agnostic

MODEL_TOL = 1e-6         # exact bf16 products: only the sum order differs
JAX_HIGH_TOL = 5e-5      # JAX's CPU HIGH keeps lo unrounded
ENVELOPE = {"high": 1e-4, "default": 1e-2}   # vs HIGHEST, x max|amp|


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (several test workers share the CPU; see tests/test_torch_segment.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _session_tier(monkeypatch):
    """Each test starts from the knob's default and leaves no tier set."""
    monkeypatch.delenv("QUEST_MATMUL_PRECISION", raising=False)
    P.set_matmul_precision(None)
    yield
    P.set_matmul_precision(None)


@contextlib.contextmanager
def reference_tier(tier):
    """The JAX package at `tier`, restored afterwards (as its own
    TestMatmulPrecisionTiers does)."""
    old = JP.matmul_precision()
    JP.set_matmul_precision(tier)
    try:
        yield
    finally:
        JP.set_matmul_precision(old)


def _max(a):
    return float(np.abs(np.asarray(a)).max())


# ---------------------------------------------------------------------------
# (a) the knob and set_matmul_precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["default", "high", "highest", "HIGH",
                                 "Highest", "DeFault", "", "bogus", "fp32",
                                 " high", "highest ", "bf16"])
def test_tier_names_parse_as_the_reference_parses_them(raw, monkeypatch):
    ref = JE.KNOBS["QUEST_MATMUL_PRECISION"].parse
    try:
        want = ref(raw)              # a jax.lax.Precision
        want = want.name.lower()
    except ValueError:
        want = ValueError
    if want is ValueError:
        with pytest.raises(ValueError):
            P.set_matmul_precision(raw)
        monkeypatch.setenv("QUEST_MATMUL_PRECISION", raw)
        with pytest.raises(ValueError):
            P.matmul_precision()
        return
    P.set_matmul_precision(raw)
    assert P.matmul_precision() == want
    P.set_matmul_precision(None)
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", raw)
    assert P.matmul_precision() == want


def test_set_matmul_precision_overrides_the_knob(monkeypatch):
    assert P.matmul_precision() == "highest"
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "default")
    assert P.matmul_precision() == "default"
    P.set_matmul_precision("high")
    assert P.matmul_precision() == "high"
    P.set_matmul_precision(None)
    assert P.matmul_precision() == "default"
    with pytest.raises(TypeError):
        P.set_matmul_precision(3)
    with pytest.raises(ValueError):
        P.check_tier("HIGH")


# ---------------------------------------------------------------------------
# (b) the tier's roundings against a numpy bit model
# ---------------------------------------------------------------------------


def _values(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        v = rng.standard_normal(4096)
    elif kind == "wide":
        v = rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))
    elif kind == "ties":
        # exact halfway cases of bf16 rounding, odd and even below them
        m = rng.integers(0, 1 << 7, 4096)
        v = ((1.0 + m / 128.0 + 1.0 / 256.0)
             * np.exp2(rng.integers(-8, 8, 4096)))
    elif kind == "unit":
        v = rng.uniform(-1, 1, 4096)
    elif kind == "negative":
        v = -np.abs(rng.standard_normal(4096))
    else:
        v = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 3.0e38, -3.0e38,
                      1.00390625, 1.01171875])
    return v.astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties", "unit",
                                  "negative", "special"])
def test_split_and_round_match_the_bit_model(kind):
    v = _values(kind)
    t = torch.from_numpy(v)
    hi, lo = P.split_hi_lo(t)
    want_hi, want_lo = np_tier_parts(v, "high")
    assert np.array_equal(hi.numpy().astype(np.float64), want_hi)
    assert np.array_equal(lo.numpy().astype(np.float64), want_lo)
    assert not (hi.numpy().view(np.uint32) & 0xFFFF).any()   # exactly bf16
    assert not (lo.numpy().view(np.uint32) & 0xFFFF).any()
    # lo < ulp(hi) = 2^-7 |x| carries 8 significant bits: its rounding
    # leaves less than 2^-9 of that, 2^-16 |x|
    x = v.astype(np.float64)
    assert (np.abs(x - want_hi - want_lo) <= 2.0 ** -16 * np.abs(x)).all()
    assert np.array_equal(P.round_bf16(t).numpy(), bf16_rne(v))


def test_tier_products_pair_the_parts():
    a = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    b = torch.randn(16, 3, generator=torch.Generator().manual_seed(2))
    assert len(P.tier_products(a, b, "highest")) == 1
    assert len(P.tier_products(a, b, "default")) == 1
    (ah, bh), (ah2, bl), (al, bh2) = P.tier_products(a, b, "high")
    assert torch.equal(ah, ah2) and torch.equal(bh, bh2)
    assert torch.equal(ah + al, P.split_hi_lo(a)[0] + P.split_hi_lo(a)[1])
    with pytest.raises(ValueError):
        P.tier_products(a, b, "fast")


# ---------------------------------------------------------------------------
# (c) the plain tier contraction and the kernel model against numpy
# ---------------------------------------------------------------------------


def _stage(rng, kind, dim, bit=-1, real=False, lane_preds=(), row_preds=()):
    g = (rng.standard_normal((2, dim, dim)) / np.sqrt(dim)).astype(np.float32)
    if real:
        g[1] = 0.0
    return (BP.MatStage(kind, dim, real, tuple(lane_preds), tuple(row_preds),
                        bit), g)


def _stage_specs():
    """(name, n, kind, dim, bit, real, lane_preds, row_preds)."""
    return [
        ("b0", 12, "b0", 128, -1, False, (), ()),
        ("b0_real_preds", 12, "b0", 128, -1, True, ((3, 1),),
         ((1, 1), (4, 0))),
        ("b1_4", 10, "b1", 4, -1, False, (), ()),
        ("b1_16", 12, "b1", 16, -1, False, (), ()),
        ("b1_128", 14, "b1", 128, -1, False, (), ()),
        ("b1_16_preds", 12, "b1", 16, -1, False, ((2, 1),), ((4, 0),)),
        ("scb_4", 12, "scb", 4, 3, False, (), ()),
        ("scb_16", 13, "scb", 16, 2, False, (), ()),
        ("scb_128", 14, "scb", 128, 0, False, (), ()),
        ("scb_16_real_preds", 13, "scb", 16, 1, True, ((0, 0),), ((0, 1),)),
    ]


def _numpy_stage(planes, st, g, tier):
    """Independent model of one matrix stage at a tier: the contracted
    bits viewed as one axis of the flat index, the real-block products
    of the tier's exact bf16 parts summed in f64, predicates as masks of
    the lane and row bits."""
    n = planes.shape[1].bit_length() - 1
    d = st.dim
    q0 = {"b0": 0, "b1": 7}.get(st.kind, 7 + st.bit)
    G = g.transpose(0, 2, 1) if (st.kind in ("b0", "b1") or d == 128) else g
    x = planes.reshape(2, -1, d, 1 << q0)
    xr, xi = np_tier_parts(x[0], tier), np_tier_parts(x[1], tier)
    gr, gi = np_tier_parts(G[0], tier), np_tier_parts(G[1], tier)

    def dot(gp, xp):
        out = np.einsum("ij,ajb->aib", gp[0], xp[0])
        if tier == "high":
            out = (out + np.einsum("ij,ajb->aib", gp[0], xp[1])
                   + np.einsum("ij,ajb->aib", gp[1], xp[0]))
        return out
    if st.real_only:
        nre, nim = dot(gr, xr), dot(gr, xi)
    else:
        nre, nim = dot(gr, xr) - dot(gi, xi), dot(gr, xi) + dot(gi, xr)
    out = np.stack([nre.reshape(-1), nim.reshape(-1)])
    k = np.arange(1 << n)
    ok = np.ones(1 << n, bool)
    for b, w in st.lane_preds:
        ok &= ((k >> b) & 1) == w
    for b, w in st.row_preds:
        ok &= ((k >> (7 + b)) & 1) == w
    return np.where(ok, out, planes.astype(np.float64))


def _stage_case(spec, tier):
    name, n, kind, dim, bit, real, lp, rp = spec
    rng = np.random.default_rng(len(name) * 7 + dim)
    st, g = _stage(rng, kind, dim, bit, real, lp, rp)
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    seg = S.prepare_segment([st], [g], n, "cpu", tier=tier)
    return st, g, planes, seg


@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("spec", _stage_specs(), ids=lambda s: s[0])
def test_plain_tier_contraction_matches_numpy_model(spec, tier):
    st, g, planes, seg = _stage_case(spec, tier)
    assert seg.tier == tier and seg.labels == {S.stage_label(st, tier)}
    got = S.segment_sweep(torch.from_numpy(planes.copy()), seg).numpy()
    want = _numpy_stage(planes, st, g, tier)
    np.testing.assert_allclose(got.reshape(2, -1), want,
                               atol=MODEL_TOL * _max(want), rtol=0)


@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("spec", _stage_specs(), ids=lambda s: s[0])
def test_kernel_model_at_tier_matches_numpy_model(spec, tier):
    """The packing: descriptor tier, tensor-core operand fragments (d >=
    16) or f32 operands rounded as read (d < 16), through emulate_kernel."""
    st, g, planes, seg = _stage_case(spec, tier)
    desc = seg.desc.numpy()[0]
    assert desc[S.F_TIER] == S.TIER_CODE[tier]
    if st.dim >= S.SLICED_MIN_DIM:
        assert desc[S.F_OP_OFF] % 4 == 0             # 16-byte loads
        assert seg.ops.numel() == st.dim * st.dim * (4 if tier == "high"
                                                     else 2) // 2
    got = emulate_kernel(planes, seg)
    want = _numpy_stage(planes, st, g, tier)
    np.testing.assert_allclose(got.reshape(2, -1), want,
                               atol=MODEL_TOL * _max(want), rtol=0)


@pytest.mark.parametrize("n,depth", [(14, 2), (21, 1), (22, 1)])
def test_kernel_model_on_hopper_plans_at_high(n, depth):
    """Every swept segment of the engine's RCS plans (b1 and scb at d =
    128 with their transposed operands, sc on the width-1 top band) at
    HIGH, through the kernel model and the plain version, segment by
    segment on the plain version's own states."""
    P.set_matmul_precision("high")
    prog = TC.random_circuit(n, depth, seed=7).compiled_fused(n, device="cpu")
    planes = _planes(n, seed=3)
    for seg in prog.segments:
        assert seg.tier == "high"
        want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                         seg.operands, n, tier="high").numpy()
        np.testing.assert_allclose(emulate_kernel(planes, seg),
                                   want.reshape(2, -1),
                                   atol=2e-5 * _max(want), rtol=0)
        planes = want.reshape(2, -1)


def test_sc_stage_stays_exact_at_every_tier():
    """`sc` is an elementwise complex multiply in the reference: no tier
    rounds it; a chain packs its b0 at the tier and its sc exact."""
    rng = np.random.default_rng(4)
    sc, gs = _stage(rng, "sc", 2, bit=3)
    b0, g0 = _stage(rng, "b0", 128)
    planes = rng.standard_normal((2, 1 << 12)).astype(np.float32)
    outs = {}
    for tier in ("highest", "high", "default"):
        seg = S.prepare_segment([sc], [gs], 12, "cpu", tier=tier)
        assert seg.desc.numpy()[0, S.F_TIER] == 0
        assert seg.labels == {"sc"}
        outs[tier] = S.segment_sweep(torch.from_numpy(planes.copy()), seg)
        chain = S.prepare_segment([b0, sc], [g0, gs], 12, "cpu", tier=tier)
        assert list(chain.desc.numpy()[:, S.F_TIER]) == [S.TIER_CODE[tier], 0]
        np.testing.assert_allclose(
            emulate_kernel(planes, chain),
            S.segment_sweep(torch.from_numpy(planes.copy()), chain).numpy(),
            atol=MODEL_TOL * _max(planes) * 4, rtol=0)
    assert torch.equal(outs["high"], outs["highest"])
    assert torch.equal(outs["default"], outs["highest"])


@pytest.mark.parametrize("tier", ["high", "default"])
def test_chained_rounding_stays_within_one_bf16_step(tier):
    """A rounding stage behind other stages reads values that two correct
    versions summed in different fp32 orders (here the f64 kernel model
    and the f32 plain version); where they sit one ulp apart across a
    bf16 rounding boundary they round to neighbouring bf16 values. The
    card's gate for chained segments (chip_smoke.tier_agreement): at most
    one bf16 step of max|amp| (2^-14 at HIGH, 2^-7 at DEFAULT) and an L2
    distance within the tier's envelope."""
    rng = np.random.default_rng(11)
    n = 16
    parts = [_stage(rng, "b0", 128), _stage(rng, "scb", 4, bit=5,
                                            row_preds=((2, 1),)),
             _stage(rng, "b1", 16)]
    seg = S.prepare_segment([p[0] for p in parts], [p[1] for p in parts], n,
                            "cpu", tier=tier)
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    want = S.segment_sweep_reference(torch.from_numpy(planes), seg.stages,
                                     seg.operands, n, tier=tier).numpy()
    got = emulate_kernel(planes, seg)
    diff = got.reshape(2, -1) - want.reshape(2, -1)
    scale = _max(want)
    step = {"high": 2.0 ** -14, "default": 2.0 ** -7}[tier]
    assert np.abs(diff).max() <= step * scale
    assert np.sqrt((diff ** 2).sum() / (want.astype(np.float64) ** 2).sum()
                   ) <= ENVELOPE[tier]


# ---------------------------------------------------------------------------
# (d) each tier engages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [s for s in _stage_specs()
                                  if s[0] in ("b0", "b1_128", "scb_16",
                                              "b1_4")], ids=lambda s: s[0])
def test_each_tier_engages(spec):
    outs = {}
    for tier in ("highest", "high", "default"):
        st, g, planes, seg = _stage_case(spec, tier)
        outs[tier] = S.segment_sweep(torch.from_numpy(planes.copy()),
                                     seg).numpy()
    scale = _max(outs["highest"])
    for tier in ("high", "default"):
        diff = np.abs(outs[tier] - outs["highest"]).max()
        assert 0.0 < diff <= ENVELOPE[tier] * scale, (tier, diff)
    assert not np.array_equal(outs["high"], outs["default"])


def test_high_split_shrinks_every_stage():
    """HIGH's hi is x truncated toward zero, so lo has x's sign and the
    dropped lo*lo term has the product's: every HIGH stage shrinks the
    state a little (the TPU's HIGH tier does the same). One random
    unitary b0 stage on a random normalised 16-qubit state loses 1e-5 to
    2.5e-5 of its norm (1.57e-5 here); the flagship circuit at 16 qubits
    (7 rounding stages) 7e-5 to 1.4e-4 (1.02e-4). DEFAULT rounds to
    nearest: no such drift on the random stage."""
    rng = np.random.default_rng(0)
    n = 16
    u = np.linalg.qr(rng.standard_normal((128, 128))
                     + 1j * rng.standard_normal((128, 128)))[0]
    g = np.stack([u.T.real, u.T.imag]).astype(np.float32)
    x = rng.standard_normal((2, 1 << n)).astype(np.float32)
    x /= np.sqrt((x.astype(np.float64) ** 2).sum()).astype(np.float32)
    loss = {}
    for tier in ("highest", "high", "default"):
        seg = S.prepare_segment([BP.MatStage("b0", 128, False, (), (), -1)],
                                [g], n, "cpu", tier=tier)
        out = S.segment_sweep(torch.from_numpy(x.copy()), seg)
        loss[tier] = 1.0 - (out.double() ** 2).sum().item()
    assert abs(loss["highest"]) < 1e-6
    assert 1e-5 < loss["high"] < 2.5e-5
    assert abs(loss["default"]) < 1e-4
    from quest_tpu_torch.entry import entry
    P.set_matmul_precision("high")
    fn, (amps,) = entry(device="cpu", num_qubits=16)
    out = fn(amps)
    assert 7e-5 < 1.0 - (out.double() ** 2).sum().item() < 1.4e-4


# ---------------------------------------------------------------------------
# (e) the fused engine against the JAX package
# ---------------------------------------------------------------------------


def _rx_cz(mod, n=12, depth=3):
    """The circuit of tests/test_pallas.py TestMatmulPrecisionTiers._run:
    rx on every qubit and a cz brick per layer (seed 3)."""
    rng = np.random.default_rng(3)
    c = mod.Circuit(n)
    for d in range(depth):
        for q in range(n):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(d % 2, n - 1, 2):
            c.cz(q, q + 1)
    return c


CIRCUIT_CASES = {
    "rx_cz_12": (12, lambda: _rx_cz(JC), lambda: _rx_cz(TC)),
    "rcs_14": (14, lambda: JC.random_circuit(14, 3, seed=5),
               lambda: TC.random_circuit(14, 3, seed=5)),
}


def _debug_planes(n):
    """The reference test's input: init_debug_state's amplitudes,
    (2k + i(2k + 1)) / 10, large on purpose."""
    k = np.arange(1 << n, dtype=np.float64)
    return np.stack([2 * k / 10, (2 * k + 1) / 10]).astype(np.float32)


def _jax_fused(jc, n, planes, tier):
    with reference_tier(tier):
        return np.asarray(jc.compiled_fused(n, False, donate=False,
                                            interpret=True)(
            jnp.asarray(planes))).reshape(2, -1)


def _port_fused(tc, n, planes, tier):
    P.set_matmul_precision(tier)
    prog = tc.compiled_fused(n, device="cpu")
    assert prog.tier == tier
    return prog, prog(torch.from_numpy(planes.copy())).numpy().reshape(2, -1)


def _norm(x):
    return float((np.asarray(x, np.float64) ** 2).sum())


@pytest.mark.parametrize("name", sorted(CIRCUIT_CASES))
def test_high_tier_matches_the_jax_package(name):
    n, jbuild, tbuild = CIRCUIT_CASES[name]
    planes = _debug_planes(n)
    jc, tc = jbuild(), tbuild()
    want_high = _jax_fused(jc, n, planes, "high")
    want_highest = _jax_fused(jc, n, planes, "highest")
    _, got = _port_fused(tc, n, planes, "high")
    scale = _max(want_highest)
    assert np.abs(got - want_high).max() <= JAX_HIGH_TOL * scale
    for x in (got, want_high):
        assert np.abs(x - want_highest).max() <= ENVELOPE["high"] * scale
        assert abs(_norm(x) / _norm(want_highest) - 1.0) < 1e-4
    assert not np.array_equal(got, want_highest)


@pytest.mark.parametrize("name", sorted(CIRCUIT_CASES))
def test_default_tier_against_the_jax_package_and_the_kernel_model(name):
    n, jbuild, tbuild = CIRCUIT_CASES[name]
    planes = _debug_planes(n)
    want = _jax_fused(jbuild(), n, planes, "default")   # = HIGHEST on a CPU
    prog, got = _port_fused(tbuild(), n, planes, "default")
    scale = _max(want)
    diff = np.abs(got - want).max()
    assert 0.0 < diff <= ENVELOPE["default"] * scale
    # stage by stage on the port's own intermediate states: two correct
    # versions of a chain that sum in different orders can round an input
    # of a later DEFAULT stage to neighbouring bf16 values, so each stage
    # is held against the model on the same f32 input
    x = torch.from_numpy(planes.copy())
    for seg in prog.segments:
        for st, arr in zip(seg.stages, seg.arrays):
            one = S.prepare_segment([st], [arr], n, "cpu", tier="default")
            model = emulate_kernel(x.numpy().reshape(2, -1), one)
            x = S.segment_sweep_reference(x, one.stages, one.operands, n,
                                          tier="default")
            np.testing.assert_allclose(x.numpy().reshape(2, -1), model,
                                       atol=MODEL_TOL * _max(model), rtol=0)
    assert np.array_equal(x.numpy().reshape(2, -1), got)


# ---------------------------------------------------------------------------
# (f) a compiled program keeps its tier
# ---------------------------------------------------------------------------


def _planes(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1 << n)).astype(np.float32)
    return x / np.float32(np.sqrt(_norm(x)))


@pytest.mark.parametrize("engine", ["fused", "batched"])
def test_a_program_keeps_the_tier_it_was_compiled_at(engine, monkeypatch):
    n = 12
    c = TC.random_circuit(n, 2, seed=9)
    planes = _planes(n)

    def compile_now():
        if engine == "fused":
            return c.compiled_fused(n, device="cpu")
        return c.compiled_batched(2, device="cpu")

    def run(prog):
        x = torch.from_numpy(np.stack([planes, planes]) if engine == "batched"
                             else planes.copy())
        return prog(x.clone())
    monkeypatch.setenv("QUEST_MATMUL_PRECISION", "high")
    prog = compile_now()
    first = run(prog)
    P.set_matmul_precision("highest")
    assert torch.equal(run(prog), first)          # the same bits
    assert prog.tier == "high"
    fresh = compile_now()
    assert fresh.tier == "highest"
    assert not torch.equal(run(fresh), first)
    assert {s.tier for s in fresh.segments} == {"highest"}


def test_trajectory_programs_are_cached_per_tier():
    c = TC.Circuit(12).h(0).ry(9, 0.3).damping(0, 0.2).cz(0, 9)
    P.set_matmul_precision("high")
    prog = TT._compiled_traj(c, 12, "cpu")
    assert prog.tier == "high" and TT._compiled_traj(c, 12, "cpu") is prog
    P.set_matmul_precision("default")
    other = TT._compiled_traj(c, 12, "cpu")
    assert other is not prog and other.tier == "default"
    assert {s.tier for s in other.segments} == {"default"}


# ---------------------------------------------------------------------------
# (g) density registers at HIGH against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_density_high_tier_matches_the_jax_package(name):
    """The density path at HIGH. The reference also runs its Kraus-pair
    contractions at the tier; the port's pairs are fp32 butterflies at
    every tier. So the port must stay within the HIGH envelope of the
    reference's HIGHEST result, and differ from the reference's HIGH
    result by no more than the reference's own HIGH error (its rounded
    pairs) plus the lo-rounding allowance."""
    from tests.test_torch_density import pure_density_planes
    nd = 6
    n = 2 * nd
    build_ref, build_port = CIRCUITS[name]
    planes = pure_density_planes(nd, seed=3)
    want = {}
    for tier in ("high", "highest"):
        with reference_tier(tier):
            want[tier] = np.asarray(build_ref(nd).compiled_fused(
                n, True, donate=False, interpret=True)(jnp.asarray(planes))
            ).reshape(2, -1)
    P.set_matmul_precision("high")
    prog = build_port(nd).compiled_fused(n, density=True, device="cpu")
    assert prog.tier == "high"
    got = prog(torch.from_numpy(planes.copy()))
    g = got.numpy().reshape(2, -1)
    scale = _max(want["highest"])
    ref_err = np.abs(want["high"] - want["highest"]).max()
    assert 0.0 < np.abs(g - want["highest"]).max() <= ENVELOPE["high"] * scale
    assert np.abs(g - want["high"]).max() <= ref_err + JAX_HIGH_TOL * scale
    q = TS.Qureg(got.reshape(2, -1), nd, is_density=True)
    assert abs(TK.calc_total_prob(q) - 1.0) < 1e-4
    assert TK.calc_purity(q) <= 1.0 + 1e-4


def test_matrix_passthrough_rounds_at_the_tier():
    """apply_matrix_rows (the XLA-side passthrough) at each tier against
    the numpy model of exact bf16 products."""
    n, targets = 12, (1, 8, 10)
    rng = np.random.default_rng(6)
    m = (rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))) / 4
    planes = rng.standard_normal((2, 1 << n)).astype(np.float32)
    outs = {}
    for tier in ("highest", "high", "default"):
        out = TA.apply_matrix_rows(torch.from_numpy(planes.copy()), n, m,
                                   targets, tier=tier).numpy()
        outs[tier] = out
        if tier == "highest":
            continue
        x = planes.reshape(2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)
        # axes: qubit 11 .. 0; gather targets as index bits 0, 1, 2
        ax = [12 - 1 - t for t in targets]
        xr = np.moveaxis(x[0], ax[::-1], [0, 1, 2]).reshape(8, -1)
        xi = np.moveaxis(x[1], ax[::-1], [0, 1, 2]).reshape(8, -1)
        mr = m.real.astype(np.float32)
        mi = m.imag.astype(np.float32)

        def dot(a, b):
            ah, al = np_tier_parts(a, tier)
            bh, bl = np_tier_parts(b, tier)
            o = ah @ bh
            return o + ah @ bl + al @ bh if tier == "high" else o
        nre = dot(mr, xr) - dot(mi, xi)
        nim = dot(mr, xi) + dot(mi, xr)
        want = np.stack([
            np.moveaxis(v.reshape((2,) * 12), [0, 1, 2], ax[::-1]).reshape(-1)
            for v in (nre, nim)])
        np.testing.assert_allclose(out, want, atol=MODEL_TOL * _max(want),
                                   rtol=0)
    assert not np.array_equal(outs["high"], outs["highest"])


# ---------------------------------------------------------------------------
# (h) batched programs and trajectories at HIGH
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["high", "default"])
def test_batched_program_at_tier_equals_the_unbatched(tier):
    n, b = 12, 3
    c = TC.random_circuit(n, 3, seed=2)
    P.set_matmul_precision(tier)
    batched = c.compiled_batched(b, device="cpu")
    single = c.compiled_fused(n, device="cpu")
    assert batched.tier == single.tier == tier
    states = np.stack([_planes(n, seed=s) for s in range(b)])
    got = batched(torch.from_numpy(states.copy()))
    for s in range(b):
        one = single(torch.from_numpy(states[s].copy()))
        assert torch.equal(got[s].reshape(one.shape), one)


@pytest.mark.parametrize("tier", ["high", "default"])
def test_trajectories_run_at_tier(tier):
    from quest_tpu_torch.entry import noisy_rcs_circuit
    c = noisy_rcs_circuit(10, 2)
    P.set_matmul_precision(tier)
    planes, draws = TT.run_batched(c, 6, generator=torch.Generator()
                                   .manual_seed(4), chunk=4, device="cpu")
    norms = planes.double().pow(2).sum(dim=(1, 2))
    assert (norms - 1.0).abs().max().item() <= ENVELOPE[tier]
    assert draws.shape == (6, TT._compiled_traj(c, 10, "cpu").num_channels)
    P.set_matmul_precision("highest")
    ref, ref_draws = TT.run_batched(c, 6, generator=torch.Generator()
                                    .manual_seed(4), chunk=4, device="cpu")
    if torch.equal(draws, ref_draws):
        diff = (planes - ref).abs().max().item()
        assert 0.0 < diff <= ENVELOPE[tier] * ref.abs().max().item()
