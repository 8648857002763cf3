"""Scalar calculations on registers: norms, overlaps, expectations.

Ports of quest_tpu/calculations.py:45-287, plain reductions (the
reference has them in XLA, outside Pallas). Like the reference they
accumulate in f64 (its stand-in for the reference QuEST's Kahan sums);
the f64 copy is taken a chunk at a time, so an 8 GiB f32 state never
needs a 16 GiB f64 twin, and a result the reference rounds to the plane
dtype is rounded here the same way.

The Pauli expectations run the grouped engine (ops/expec.py, ROADMAP
A6) by default and, under QUEST_EXPEC_FUSION=0, the reference's per-term
program (`_expec_pauli_sum` :172 and `_pauli_term_trace` :190): each
statevector term one flip-form pass whose image is reduced chunk by
chunk against the state (no copy of the state), each density term one
gather of the 2^N entries rho[k, k ^ x] its trace touches. The two give
the same values. `apply_pauli_sum` runs the grouped operator apply.

On a sharded register (parallel.ShardedAmps) every calculation is one
partial per shard in the f64 accumulator plus one AmpMesh.reduce
(parallel/eager.py; ref QuEST_cpu_distributed.c:1263-1299), and the
Pauli expectations run the grouped engine's sharded evaluators
(ops/expec.py expec_sharded) whatever QUEST_EXPEC_FUSION says; the state
never gathers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.ops.expec import flipped_trace_diag, parse_pauli_sum
from quest_tpu_torch.parallel import eager as SE
from quest_tpu_torch.profiling import annotate, device_of

CHUNK_AMPS = 1 << 26


def _chunks(*planes: torch.Tensor):
    """Matching f64 chunks of flattened tensors of equal size."""
    flats = [p.reshape(-1) for p in planes]
    for start in range(0, flats[0].numel(), CHUNK_AMPS):
        yield [f[start:start + CHUNK_AMPS].to(torch.float64) for f in flats]


def _sum_sq(planes: torch.Tensor) -> float:
    """sum of squares of every element of `planes`, in f64."""
    total = torch.zeros((), dtype=torch.float64, device=planes.device)
    for (chunk,) in _chunks(planes):
        total += torch.dot(chunk, chunk)
    return float(total)


def calc_total_prob(q) -> float:
    """Total probability: sum |a|^2 of a statevector, Re Tr(rho) of a
    density matrix."""
    with annotate("readout.total_prob", device=device_of(q)):
        if SE.is_sharded(q):
            return SE.total_prob(q)
        if q.is_density:
            dim = 1 << q.num_qubits
            # rho[r, r] at r (1 + dim)
            diag = q.amps.reshape(2, -1)[0][::dim + 1]
            return float(diag.to(torch.float64).sum())
        return _sum_sq(q.amps)


def calc_purity(q) -> float:
    """Tr(rho^2) = sum |rho_ij|^2 (ref densmatr_calcPurityLocal)."""
    val.validate_density_matr(q)
    with annotate("readout.purity", device=device_of(q)):
        if SE.is_sharded(q):
            return SE.purity(q)
        return _sum_sq(q.amps)


def _inner(bra: torch.Tensor, ket: torch.Tensor) -> Tuple[float, float]:
    """(Re, Im) of sum conj(b) k over two states' planes, in f64, then
    rounded to the bra's plane dtype (ref calculations.py:53)."""
    b2, k2 = bra.reshape(2, -1), ket.reshape(2, -1)
    re = torch.zeros((), dtype=torch.float64, device=bra.device)
    im = torch.zeros((), dtype=torch.float64, device=bra.device)
    for br, bi, kr, ki in _chunks(b2[0], b2[1], k2[0].to(bra.dtype),
                                  k2[1].to(bra.dtype)):
        re += torch.dot(br, kr) + torch.dot(bi, ki)
        im += torch.dot(br, ki) - torch.dot(bi, kr)
    rdt = precision.numpy_dtype(bra.dtype)
    return rdt.type(re.item()), rdt.type(im.item())


def calc_inner_product(bra, ket) -> complex:
    """<bra|ket> (ref statevec_calcInnerProduct,
    QuEST_cpu_distributed.c:35-51)."""
    val.validate_state_vector(bra)
    val.validate_state_vector(ket)
    val.validate_match(bra, ket)
    if SE.is_sharded(bra) or SE.is_sharded(ket):
        return complex(*SE.inner(bra, ket, "calcInnerProduct"))
    re, im = _inner(bra.amps, ket.amps)
    return complex(re, im)


def calc_density_inner_product(rho1, rho2) -> float:
    """Tr(rho1 rho2) = Re sum conj(a) b for Hermitian arguments (ref
    densmatr_calcInnerProduct)."""
    val.validate_density_matr(rho1)
    val.validate_density_matr(rho2)
    val.validate_match(rho1, rho2)
    if SE.is_sharded(rho1) or SE.is_sharded(rho2):
        return float(SE.inner(rho1, rho2,
                                    "calcDensityInnerProduct")[0])
    return float(_inner(rho1.amps, rho2.amps)[0])


def _fidelity_density(rho: torch.Tensor, psi: torch.Tensor, dim: int) -> float:
    """<psi| rho |psi> in the plane dtype, the products IEEE fp32 (TF32
    off) on f32 planes (ref calculations.py:101): the planes' row-major
    (dim, dim) view is rho^T, so its transpose multiplies psi."""
    precision.ieee_fp32()
    flat = rho.reshape(2, -1)
    rre, rim = flat[0].view(dim, dim).T, flat[1].view(dim, dim).T
    pre, pim = psi[0], psi[1]
    vr = torch.mv(rre, pre) - torch.mv(rim, pim)
    vi = torch.mv(rre, pim) + torch.mv(rim, pre)
    return float(torch.sum(pre * vr + pim * vi))


def calc_fidelity(q, pure) -> float:
    """|<psi|phi>|^2 for statevectors; <psi|rho|psi> for a density q (ref
    QuEST_common.c:376-381, densmatr_calcFidelity)."""
    val.validate_pure_state_args(q, pure)
    if SE.is_sharded(q) or SE.is_sharded(pure):
        if q.is_density:
            if not SE.is_sharded(q):
                SE.refuse("calcFidelity", "the density register is "
                                "on one device and the pure state sharded")
            return SE.fidelity_density(q, pure)
        re, im = SE.inner(q, pure, "calcFidelity")
        return float(re * re + im * im)
    psi = pure.amps.reshape(2, -1).to(q.amps.dtype)
    if q.is_density:
        return _fidelity_density(q.amps, psi, 1 << q.num_qubits)
    re, im = _inner(q.amps, psi)
    return float(re * re + im * im)


def calc_hilbert_schmidt_distance(a, b) -> float:
    """sqrt(sum |a_ij - b_ij|^2) (ref densmatr_calcHilbertSchmidtDistance);
    the differences in the plane dtype, their squares summed in f64."""
    val.validate_density_matr(a)
    val.validate_density_matr(b)
    val.validate_match(a, b)
    if SE.is_sharded(a) or SE.is_sharded(b):
        return SE.hs_distance(a, b)
    fa, fb = a.amps.reshape(-1), b.amps.reshape(-1).to(a.amps.dtype)
    total = torch.zeros((), dtype=torch.float64, device=fa.device)
    for s in range(0, fa.numel(), CHUNK_AMPS):
        d = (fa[s:s + CHUNK_AMPS] - fb[s:s + CHUNK_AMPS]).to(torch.float64)
        total += torch.dot(d, d)
    return float(np.sqrt(total.item()))


# ---------------------------------------------------------------------------
# Pauli expectation values (ref QuEST_common.c:464-514)
# ---------------------------------------------------------------------------

def _pauli_term_trace(amps: torch.Tensor, N: int, term) -> float:
    """Re Tr(P rho) = Re sum_k i^ny (-1)^parity(k & zy) rho[k, k ^ x]
    (ref calculations.py:190), summed in f64."""
    x_bits, zy_bits, ny = A.pauli_masks(term)
    rdiag, idiag = flipped_trace_diag(amps, N, x_bits)
    if zy_bits:
        dims, axis_of = A.bit_view(N, zy_bits)
        sign = A.parity_sign(len(dims), axis_of, zy_bits, amps.dtype,
                             amps.device).expand(dims).reshape(-1)
        rdiag, idiag = rdiag * sign, idiag * sign
    part = (rdiag, -idiag, -rdiag, idiag)[ny % 4]
    return float(part.to(torch.float64).sum())


def _pauli_term_overlap(amps: torch.Tensor, n: int, term) -> float:
    """Re <psi| P |psi> of a statevector, the image of each chunk reduced
    against it in f64 (ref calculations.py:172's term)."""
    total = torch.zeros((), dtype=torch.float64, device=amps.device)
    for xr, xi, wr, wi in A.pauli_chunks(amps, n, term):
        total += (xr * wr + xi * wi).to(torch.float64).sum()
    return float(total)


def _expec_pauli_sum(q, coeffs: np.ndarray, codes) -> float:
    """sum_t c_t <P_t>, term by term; each coefficient rounded to the
    plane dtype first, as the reference passes it."""
    cf = np.asarray(coeffs, dtype=q.real_dtype).astype(np.float64)
    total = 0.0
    for c, term in zip(cf, codes):
        if q.is_density:
            tv = _pauli_term_trace(q.amps, q.num_qubits, term)
        else:
            tv = _pauli_term_overlap(q.amps, q.num_state_qubits, term)
        total += float(c) * tv
    return total


def _term(q, targets, paulis) -> Tuple[int, ...]:
    term = [0] * q.num_qubits
    for t, p in zip(targets, paulis):
        term[int(t)] = int(p)
    return tuple(term)


def _expec(q, coeffs: np.ndarray, codes) -> float:
    """The grouped engine (ops/expec.py) under QUEST_EXPEC_FUSION=1, the
    per-term program under 0 (ref calculations.py:235-241); a sharded
    register always takes the grouped engine's sharded evaluators."""
    if E.fusion_enabled() or SE.is_sharded(q):
        return E.expec_value(q, coeffs, codes)
    return _expec_pauli_sum(q, coeffs, codes)


def calc_expec_pauli_prod(q, targets: Sequence[int],
                          paulis: Sequence[int]) -> float:
    """<q| P |q> (statevector) or Re Tr(P rho) (density) of one Pauli
    product: the one-term calc_expec_pauli_sum."""
    val.validate_multi_targets(q, targets)
    val.validate_pauli_targets(targets, paulis)
    val.validate_pauli_codes(paulis)
    return _expec(q, np.ones(1), (_term(q, targets, paulis),))


def _coeffs(q, all_codes, coeffs):
    codes = parse_pauli_sum(all_codes, q.num_qubits)
    coeffs = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    if len(coeffs) != len(codes):
        val.err("Invalid Pauli sum: must give exactly one coefficient "
                "per term.")
    return codes, coeffs


def calc_expec_pauli_sum(q, all_codes, coeffs) -> float:
    """sum_t c_t <P_t>; `all_codes` is (numTerms, numQubits) Pauli codes
    (ref calcExpecPauliSum): the grouped engine by default, term by term
    under QUEST_EXPEC_FUSION=0, with equal values."""
    codes, coeffs = _coeffs(q, all_codes, coeffs)
    return _expec(q, coeffs, codes)


def calc_linear_xeb(q, samples) -> float:
    """Linear cross-entropy fidelity of basis-state `samples` against the
    state: 2^n <p(s)> - 1, the mean in f64 (statevectors only)."""
    val.validate_state_vector(q)
    with annotate("readout.linear_xeb", device=device_of(q)):
        if SE.is_sharded(q):
            return SE.linear_xeb(q, samples)
        flat = q.amps.reshape(2, -1)
        s = torch.as_tensor(samples, device=flat.device).reshape(-1).long()
        re, im = flat[0][s], flat[1][s]
        p = (re * re + im * im).to(torch.float64)
        return float((1 << q.num_state_qubits) * p.mean() - 1.0)


def apply_pauli_sum(q, all_codes, coeffs):
    """A new register holding sum_t c_t P_t |q> (or sum_t c_t P_t rho on
    the row space) (ref statevec_applyPauliSum, QuEST_common.c:493-514),
    through the grouped operator apply (ops/expec.py
    apply_pauli_sum_planes): one flipped read per mask group, the new
    planes filled chunk by chunk."""
    codes, coeffs = _coeffs(q, all_codes, coeffs)
    n = q.num_state_qubits
    rows = tuple(tuple(t) + (0,) * (n - len(t)) for t in codes)
    plan = E._plan_cached(rows, n, False, E.max_masks_per_sweep())
    cf = torch.as_tensor(np.asarray(coeffs, dtype=q.real_dtype),
                         device=q.amps.device)
    with torch.no_grad():
        if SE.is_sharded(q):
            return q.replace_amps(
                E.apply_pauli_sum_planes_sharded(q.amps, cf, plan))
        out = E.apply_pauli_sum_planes(q.amps, cf, plan)
    return q.replace_amps(out.reshape(q.amps.shape))
