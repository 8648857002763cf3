"""Measurement: outcome probabilities, collapse and sampling.

A port of quest_tpu/measurement.py:31-287. The semantics are the reference QuEST's
(QuEST_common.c:154-169, 360-374; QuEST_cpu.c:3111-3495):

  * the probability of outcome 0 sums |a|^2 over the amplitudes whose
    bit is 0 (a density register: the diagonal entries), in the f64
    accumulator, chunk by chunk, then rounds to the plane dtype;
  * an outcome whose probability is below REAL_EPS (1e-5 f32, 1e-13 f64)
    is never drawn: the other one is forced;
  * collapse zeroes the other branch and renormalises the kept one by
    1/sqrt(p) (statevector) or 1/p (density register, both copies of the
    qubit), in place on the planes, p clamped at REAL_EPS;
  * sampling draws full-register basis states by inverse CDF over the
    probabilities (`_stable_cdf`: block cumulative sums with an f64
    carry), searchsorted(side="right"), without collapsing the state.

The outcome of a measurement is read on the host (one synchronisation
per measurement, as the reference's C API has), so a dynamic circuit can
apply or skip a classically controlled gate in place
(circuit.MeasuredProgram). Uniforms come from the seeded host stream
(random_.uniform, `measure_with_stats`) or from a torch.Generator
(`measure_functional`, `sample`). The drawing-free cores,
`_measure_given_uniform` and `_sample_given_uniforms`, take the uniforms
themselves, so a caller can replay another generator's draws.

On a sharded register (parallel.ShardedAmps) the probability is one
partial per shard and one AmpMesh.reduce, the collapse runs per shard (a
global qubit keeps or zeroes whole shards), and `sample` builds one CDF
per shard whose totals alone cross shards (parallel/eager.py,
`_sample_sharded_given_uniforms`); the state never gathers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import random_ as rng
from quest_tpu_torch import validation as val
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.parallel import eager as SE

CHUNK_AMPS = 1 << 24          # amplitudes per f64 reduction chunk
DIRECT_CDF_MAX = 1 << 14      # below this (or off powers of two): one scan


def _density_diag(amps: torch.Tensor, n: int) -> torch.Tensor:
    """The real parts of rho[k, k] of a density register's planes (n = 2N
    state qubits), a strided view of 2^N entries."""
    dim = 1 << (n // 2)
    return amps.reshape(2, -1)[0][::dim + 1]


def _prob_of_zero(amps: torch.Tensor, *, n: int, qubit: int,
                  density: bool) -> float:
    """P(qubit = 0) in the f64 accumulator, rounded to the plane dtype
    (ref measurement.py:31)."""
    rdt = precision.numpy_dtype(amps.dtype)
    if density:
        d = _density_diag(amps, n).reshape(-1, 2, 1 << qubit)[:, 0]
        return float(rdt.type(d.to(torch.float64).sum().item()))
    total = torch.zeros((), dtype=torch.float64, device=amps.device)
    for xr, xi, _ in A.target_chunks(amps, n, (), (qubit,), (0,)):
        total += (xr * xr + xi * xi).to(torch.float64).sum()
    return float(rdt.type(total.item()))


def _collapse(amps: torch.Tensor, outcome: int, prob: float, *, n: int,
              qubit: int, density: bool) -> torch.Tensor:
    """Keep the amplitudes of `outcome` on `qubit` (both of its copies on
    a density register), renormalised by 1/sqrt(prob) or 1/prob in the
    plane dtype, and zero the rest; in place, returns `amps` (ref
    measurement.py:49)."""
    rdt = precision.numpy_dtype(amps.dtype)
    p = rdt.type(prob)
    if density:
        qubits = (qubit, qubit + n // 2)
        renorm = rdt.type(1.0) / p
        keep = (outcome, outcome)
        states = [(r, c) for r in (0, 1) for c in (0, 1)]
    else:
        qubits = (qubit,)
        renorm = rdt.type(1.0) / np.sqrt(p)     # in the plane dtype
        keep = (outcome,)
        states = [(0,), (1,)]
    for cs in states:
        for xr, xi, _ in A.target_chunks(amps, n, (), qubits, cs):
            if cs == keep:
                xr.mul_(float(renorm))
                xi.mul_(float(renorm))
            else:
                xr.zero_()
                xi.zero_()
    return amps


def calc_prob_of_outcome(q, qubit: int, outcome: int) -> float:
    """P(qubit = outcome) (ref calcProbOfOutcome)."""
    val.validate_target(q, qubit)
    val.validate_outcome(outcome)
    if SE.is_sharded(q):
        p0 = SE.prob_of_zero(q, qubit)
    else:
        p0 = _prob_of_zero(q.amps, n=q.num_state_qubits, qubit=qubit,
                           density=q.is_density)
    if outcome == 0:
        return p0
    return float(q.real_dtype.type(1.0) - q.real_dtype.type(p0))


def collapse_to_outcome(q, qubit: int, outcome: int) -> Tuple[object, float]:
    """Project onto `outcome` and renormalise, in place; returns
    (register, prob). Raises the reference's error when prob is below
    REAL_EPS."""
    val.validate_target(q, qubit)
    val.validate_outcome(outcome)
    prob = calc_prob_of_outcome(q, qubit, outcome)
    val.validate_measurement_prob(prob, precision.real_eps(q.dtype))
    _collapse_register(q, outcome, prob, qubit)
    return q, prob


def _collapse_register(q, outcome: int, prob: float, qubit: int) -> None:
    if SE.is_sharded(q):
        SE.collapse(q, qubit, outcome, prob)
    else:
        _collapse(q.amps, outcome, prob, n=q.num_state_qubits, qubit=qubit,
                  density=q.is_density)


def measure_with_stats(q, qubit: int) -> Tuple[object, int, float]:
    """Draw an outcome from the seeded host stream (random_.uniform),
    collapse in place, return (register, outcome, outcome probability)
    (ref statevec_measureWithStats, QuEST_common.c:360-366)."""
    val.validate_target(q, qubit)
    eps = precision.real_eps(q.dtype)
    zero_prob = calc_prob_of_outcome(q, qubit, 0)
    if zero_prob < eps:
        outcome = 1
    elif 1 - zero_prob < eps:
        outcome = 0
    else:
        u = rng.uniform()
        if SE.is_sharded(q):
            u = SE.shared(q, u)          # process 0's draw, on every process
        outcome = int(u > zero_prob)
    prob = zero_prob if outcome == 0 else 1 - zero_prob
    _collapse_register(q, outcome, prob, qubit)
    return q, outcome, prob


def measure(q, qubit: int) -> Tuple[object, int]:
    q, outcome, _ = measure_with_stats(q, qubit)
    return q, outcome


def _measure_given_uniform(amps: torch.Tensor, u: float, *, n: int,
                           qubit: int, density: bool) -> Tuple[int, float]:
    """The traced measurement of the reference (measurement.py:114) with
    its uniform `u` given: an outcome forced where a branch's probability
    is below REAL_EPS, else int(u > p0), every scalar in the plane dtype;
    the kept branch's probability clamped at REAL_EPS; the planes
    collapsed in place. Returns (outcome, prob)."""
    rdt = precision.numpy_dtype(amps.dtype)
    p0 = rdt.type(_prob_of_zero(amps, n=n, qubit=qubit, density=density))
    eps = rdt.type(precision.real_eps(rdt))
    one = rdt.type(1.0)
    if p0 < eps:
        outcome = 1
    elif one - p0 < eps:
        outcome = 0
    else:
        outcome = int(rdt.type(u) > p0)
    prob = max(p0 if outcome == 0 else one - p0, eps)
    _collapse(amps, outcome, float(prob), n=n, qubit=qubit, density=density)
    return outcome, float(prob)


def draw_uniform(generator: torch.Generator, dtype) -> float:
    """One uniform in [0, 1) of the plane dtype from `generator`, on its
    device, read on the host."""
    return torch.rand((), generator=generator, dtype=dtype,
                      device=generator.device).item()


def measure_functional(q, qubit: int,
                       generator: torch.Generator) -> Tuple[object, int, float]:
    """Measurement with its uniform drawn from an explicit
    torch.Generator (the port of the reference's jax.random-keyed
    measure_functional): (register collapsed in place, outcome, prob)."""
    val.validate_target(q, qubit)
    u = draw_uniform(generator, q.amps.dtype)
    if SE.is_sharded(q):
        u = SE.shared(q, u)
        rdt = precision.numpy_dtype(q.amps.dtype)
        p0 = rdt.type(SE.prob_of_zero(q, qubit))
        eps = rdt.type(precision.real_eps(rdt))
        one = rdt.type(1.0)
        outcome = (1 if p0 < eps else 0 if one - p0 < eps
                   else int(rdt.type(u) > p0))
        prob = float(max(p0 if outcome == 0 else one - p0, eps))
        SE.collapse(q, qubit, outcome, prob)
        return q, outcome, prob
    outcome, prob = _measure_given_uniform(
        q.amps, u, n=q.num_state_qubits, qubit=qubit, density=q.is_density)
    return q, outcome, prob


def _stable_cdf(probs: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """Cumulative sum of `probs` with the reference's bounded rounding
    error (measurement.py:134): ~sqrt(N) blocks, each summed in the
    plane dtype, the block totals carried in an f64 exclusive scan and
    added in f64 before rounding back, so the result is monotone. With
    no wider accumulator (f64 planes) a running max repairs a one-ulp
    boundary inversion. Below 2^14 entries, or off powers of two, one
    f64 scan. The block pass runs a group of rows at a time, so nothing
    f64 of N entries exists; `inplace` writes the result into `probs`."""
    N = probs.shape[0]
    k = (N - 1).bit_length()
    acc = precision.torch_dtype(precision.accum_dtype(precision.numpy_dtype(probs.dtype)))
    if N <= DIRECT_CDF_MAX or (1 << k) != N:
        out = torch.cumsum(probs.to(acc), 0).to(probs.dtype)
        if inplace:
            probs.copy_(out)
            return probs
        return out
    B = 1 << (k // 2)
    out = probs if inplace else probs.clone()
    within = out.view(B, N // B)
    within.cumsum_(dim=1)
    carry = torch.cumsum(within[:, -1].to(acc), 0)
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    rows = max(1, CHUNK_AMPS // (N // B))
    for r in range(0, B, rows):
        blk = within[r:r + rows]
        blk.copy_(blk.to(acc) + carry[r:r + rows, None])
    if acc == probs.dtype:          # running max, a chunk at a time
        top = None
        for s in range(0, N, CHUNK_AMPS):
            blk = out[s:s + CHUNK_AMPS]
            m = torch.cummax(blk, 0).values
            if top is not None:
                m = torch.maximum(m, top)
            blk.copy_(m)
            top = m[-1]
    return out


def _probabilities(amps: torch.Tensor, n: int, density: bool) -> torch.Tensor:
    """The 2^n Born probabilities (a density register's diagonal) as a
    new tensor in the plane dtype, computed a chunk at a time."""
    if density:
        return _density_diag(amps, n).clone()
    flat = amps.reshape(2, -1)
    out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
    for s in range(0, flat.shape[1], CHUNK_AMPS):
        re, im = flat[0, s:s + CHUNK_AMPS], flat[1, s:s + CHUNK_AMPS]
        torch.add(re * re, im * im, out=out[s:s + CHUNK_AMPS])
    return out


def _sample_given_uniforms(amps: torch.Tensor, u: torch.Tensor, *, n: int,
                           density: bool) -> torch.Tensor:
    """Basis-state indices (int64) of the shots whose uniforms in [0, 1)
    are `u` (plane dtype, the planes' device): inverse CDF,
    searchsorted(cdf, u * cdf[-1], side="right") (ref measurement.py:
    174), clamped to the last index."""
    cdf = _stable_cdf(_probabilities(amps, n, density), inplace=True)
    scaled = u.to(device=cdf.device, dtype=cdf.dtype) * cdf[-1]
    idx = torch.searchsorted(cdf, scaled, right=True)
    return idx.clamp_(max=cdf.shape[0] - 1)


def _sample_sharded_given_uniforms(q, u: torch.Tensor) -> torch.Tensor:
    """The sharded sampler's drawing-free core (ref measurement.py:196):
    per-shard CDFs, the shard totals as an f64 carry, each shot resolved
    by the shard owning its scaled uniform; int64 indices on the first
    shard's device."""
    return SE.sample_given_uniforms(q, u)


def sample(q, num_shots: int,
           generator: torch.Generator = None) -> torch.Tensor:
    """`num_shots` full-register basis-state samples (int64 indices, on
    the register's device), drawn without collapsing the state: exactly
    `num_shots` uniforms of the plane dtype from `generator`, or, when
    it is None, from a CPU generator seeded with one word of the seeded
    host stream (random_.uint32, as the reference derives its key). The
    probabilities and their CDF share one tensor of 2^n plane-dtype
    entries: a 30-qubit f32 state adds 4 GiB."""
    if num_shots < 1:
        raise val.QuESTError("Invalid number of shots: must be positive.")
    if generator is None:
        generator = torch.Generator().manual_seed(rng.uint32())
    u = torch.rand(int(num_shots), generator=generator, dtype=q.amps.dtype,
                   device=generator.device)
    if SE.is_sharded(q):
        # one draw for every shard: per-shard generators would diverge
        # (and on a process mesh, process 0's draw for every process)
        return _sample_sharded_given_uniforms(q, SE.shared(q, u))
    return _sample_given_uniforms(q.amps, u, n=q.num_state_qubits,
                                  density=q.is_density)
