"""The eager QuEST surface on a sharded register.

A register whose `amps` is a `ShardedAmps` (parallel/mesh.py) runs the
same eager functions as one on a single tensor: state.py's initialisers,
setters and getters, calculations.py's reductions, measurement.py's
probabilities, collapse and sampling, and every gate and channel of
ops/gates.py and ops/channels.py. The reference gets these from GSPMD
over its sharded jax array; here each one is written over the shards:

  * an initialiser or setter writes each shard's own slice of the flat
    index range, a getter reads the owning shard;
  * a reduction is one partial per shard in the f64 accumulator plus one
    `AmpMesh.reduce` (the reference's psum, QuEST_cpu_distributed.c:
    1263-1299);
  * a gate or channel is one GateOp through the sharded per-gate engine's
    applier (`sharded._apply_gateop`), its exchanges issued on the
    register's mesh and recorded there; nothing is compiled or cached, so
    a repeated eager call builds nothing;
  * measurement reduces the outcome probability over the shards, draws
    once for the register, and collapses each shard locally (a global
    qubit keeps or zeroes whole shards).

On a mesh that spans processes each process walks only the shards it
holds; a reduction's total, a read amplitude and a drawn uniform are the
same on every process (one gloo all_reduce each; a uniform is process
0's), so every process reads the same value, outcome and samples.

The state is never gathered: `ShardedAmps.gather` and `state.to_dense`
stay the only explicit gathers. A function that cannot run on the shards
raises a typed QuESTError naming itself. Density registers need at least
one density-matrix column per shard (2^N >= the mesh size), as the
reference's sharded measured engine does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.parallel import sharded as S
from quest_tpu_torch.parallel.mesh import ShardedAmps

CHUNK_AMPS = 1 << 24


def is_sharded(q) -> bool:
    return isinstance(getattr(q, "amps", q), ShardedAmps)


def _xs(amps: ShardedAmps) -> List[torch.Tensor]:
    """The shards as (1, 2, 2^local_n) views, the appliers' layout (None
    for another process's shard)."""
    m = 1 << amps.local_n
    return [None if s is None else s.view(1, 2, m) for s in amps.shards]


def _mine(amps: ShardedAmps, xs=None) -> List[Tuple[int, torch.Tensor]]:
    """(d, view) of the shards this process holds, from `xs` (default
    the flat (2, 2^local_n) views)."""
    xs = amps.views() if xs is None else xs
    return [(d, xs[d]) for d in amps.mesh.local_ids]


def shared(q, value):
    """`value` (a float or a tensor) as process 0 of the register's mesh
    drew it, on every process (one all_reduce through the host; a copy on
    one process). Draws that decide an outcome or a sample go through
    it, so every process of a mesh reads the same."""
    mesh = q.amps.mesh
    t = (value.detach().cpu() if torch.is_tensor(value)
         else torch.tensor([float(value)], dtype=torch.float64))
    out = mesh.host_all_reduce(t if mesh.rank == 0 else torch.zeros_like(t))
    if torch.is_tensor(value):
        return out.to(value.device)
    return float(out[0])


def _flat(amps: ShardedAmps) -> List[torch.Tensor]:
    return amps.views()


def aligned(what: str, mesh, reg) -> List[torch.Tensor]:
    """`reg`'s planes cut as `mesh`'s shards hold theirs: its own shards
    when it is sharded over a mesh of the same devices, else slices of
    its one tensor, each copied to its shard's device (a register on
    one device meeting a sharded one, as GSPMD reshards in the
    reference). A register sharded over another mesh is refused."""
    amps = reg.amps
    if isinstance(amps, ShardedAmps):
        if amps.mesh.key != mesh.key:
            refuse(what, "its registers are sharded over different meshes "
                         "(shard them over the same devices)")
        return amps.views()
    flat = amps.reshape(2, -1)
    m = flat.shape[1] // mesh.size
    return [None if dev is None else flat[:, d * m:(d + 1) * m].to(dev)
            for d, dev in enumerate(mesh.devices)]


def _rdt(amps: ShardedAmps):
    return precision.numpy_dtype(amps.dtype)


def _new(q, shards) -> object:
    return q.replace_amps(ShardedAmps(list(shards), q.amps.mesh, q.amps.n))


def refuse(what: str, why: str):
    raise val.QuESTError(
        f"Invalid operation: {what} cannot run on a sharded register: "
        f"{why}")


def _mesh_of(*regs):
    return next(r.amps.mesh for r in regs if is_sharded(r))


def _cols(q, what: str) -> int:
    """Density-matrix columns a shard holds (>= 1 required)."""
    dim = 1 << q.num_qubits
    m = 1 << q.amps.local_n
    if m < dim:
        refuse(what, f"a density register of {q.num_qubits} qubits over "
                     f"{q.amps.mesh.size} shards splits a column; it needs "
                     f"2^numQubits >= the mesh size")
    return m // dim


# ---------------------------------------------------------------------------
# initialisers, setters and getters (state.py)
# ---------------------------------------------------------------------------

def _zeros(q) -> list:
    return [None if s is None else torch.zeros_like(s)
            for s in q.amps.shards]


def init_zero_state(q):
    shards = _zeros(q)
    if shards[0] is not None:
        shards[0].view(2, -1)[0, 0] = 1.0
    return _new(q, shards)


def init_plus_state(q):
    n = q.num_qubits
    v = 1.0 / (1 << n) if q.is_density else 1.0 / np.sqrt(1 << n)
    shards = _zeros(q)
    for t in shards:
        if t is not None:
            t.view(2, -1)[0].fill_(v)
    return _new(q, shards)


def init_classical_state(q, flat: int):
    shards = _zeros(q)
    m = 1 << q.amps.local_n
    if shards[flat // m] is not None:
        shards[flat // m].view(2, -1)[0, flat % m] = 1.0
    return _new(q, shards)


def init_debug_state(q):
    m = 1 << q.amps.local_n
    shards = [None] * len(q.amps.shards)
    for d, s in q.amps.local():
        k = torch.arange(d * m, (d + 1) * m, dtype=s.dtype, device=s.device)
        shards[d] = torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0])
    return _new(q, shards)


def init_blank_state(q):
    for _, s in q.amps.local():
        s.zero_()
    return q


def init_state_of_single_qubit(q, qubit: int, outcome: int):
    local_n = q.amps.local_n
    v = 1.0 / np.sqrt(1 << (q.num_state_qubits - 1))
    for d, x in _mine(q.amps):
        x.zero_()
        if qubit >= local_n:
            if ((d >> (qubit - local_n)) & 1) == outcome:
                x[0].fill_(v)
            continue
        x[0].view(1 << (local_n - 1 - qubit), 2, 1 << qubit)[
            :, outcome].fill_(v)
    return q


def _psi_planes(pure, dtype) -> torch.Tensor:
    """The pure state's (2, 2^N) planes: a density register's columns all
    read the whole of it (a register of 2^N amplitudes, not the 4^N of
    the one being initialised)."""
    amps = pure.amps
    if isinstance(amps, ShardedAmps):
        amps = amps.gather()
    return amps.reshape(2, -1).to(dtype)


def init_pure_state(q, pure):
    if not q.is_density:
        src = aligned("initPureState", q.amps.mesh, pure)
        for d, s in _mine(q.amps):
            s.copy_(src[d].to(s.dtype))
        return q
    cols = _cols(q, "initPureState")
    dim = 1 << q.num_qubits
    psi = _psi_planes(pure, q.amps.dtype)
    for d, x in _mine(q.amps):
        p = psi.to(x.device)
        re, im = p[0], p[1]
        c0 = d * cols
        mre, mim = x[0].view(cols, dim), x[1].view(cols, dim)
        step = max(1, (1 << 24) // dim)
        for a in range(0, cols, step):
            b = min(cols, a + step)
            cr, ci = re[c0 + a:c0 + b, None], im[c0 + a:c0 + b, None]
            mre[a:b] = cr * re + ci * im
            mim[a:b] = cr * im - ci * re
    return q


def write_range(q, start: int, pair) -> object:
    """Write the (2, L) planes `pair` (a tensor) at flat amplitudes
    [start, start + L), each shard its own part."""
    m = 1 << q.amps.local_n
    L = pair.shape[1]
    for d, x in _mine(q.amps):
        lo, hi = max(start, d * m), min(start + L, (d + 1) * m)
        if lo >= hi:
            continue
        x[:, lo - d * m:hi - d * m] = pair[:, lo - start:hi - start].to(
            device=x.device, dtype=x.dtype)
    return q


def read_amp(q, flat: int) -> complex:
    """The amplitude at `flat`, read by the shard that holds it (on a
    process mesh the holder's value reaches every process)."""
    m = 1 << q.amps.local_n
    owner = _flat(q.amps)[flat // m]
    val = (owner[:, flat % m].to(torch.float64) if owner is not None
           else torch.zeros(2, dtype=torch.float64))
    re, im = q.amps.mesh.host_all_reduce(val).tolist()
    return complex(re, im)


def clone(q):
    return q.replace_amps(q.amps.clone())


# ---------------------------------------------------------------------------
# reductions (calculations.py)
# ---------------------------------------------------------------------------

def _f64_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float64, device=x.device)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    total = _f64_zero(x)
    for s in range(0, flat.numel(), CHUNK_AMPS):
        c = flat[s:s + CHUNK_AMPS].to(torch.float64)
        total = total + torch.dot(c, c)
    return total


def _reduce(amps: ShardedAmps, parts) -> torch.Tensor:
    return amps.mesh.reduce(parts)


def _diag_parts(q, what: str) -> List[torch.Tensor]:
    """Each shard's real diagonal entries rho[c, c] of the columns it
    holds (a strided view)."""
    cols = _cols(q, what)
    dim = 1 << q.num_qubits
    out = [None] * q.amps.mesh.size
    for d, x in _mine(q.amps):
        c0 = d * cols
        out[d] = x[0].view(cols, dim)[:, c0:c0 + cols].diagonal()
    return out


def total_prob(q) -> float:
    if q.is_density:
        parts = [None if p is None else p.to(torch.float64).sum()
                 for p in _diag_parts(q, "calcTotalProb")]
    else:
        parts = [None if x is None else _sum_sq(x) for x in q.amps.shards]
    return float(_reduce(q.amps, parts))


def purity(q) -> float:
    return float(_reduce(q.amps, [None if x is None else _sum_sq(x)
                                  for x in q.amps.shards]))


def inner(bra, ket, what: str) -> Tuple[float, float]:
    """(Re, Im) of sum conj(b) k over two registers, one of them or both
    sharded: partials in f64, one reduce, rounded to the bra's plane
    dtype."""
    mesh = _mesh_of(bra, ket)
    parts = [None] * mesh.size
    bras, kets = aligned(what, mesh, bra), aligned(what, mesh, ket)
    for d in mesh.local_ids:
        b, k = bras[d], kets[d].to(bras[d].dtype)
        re, im = _f64_zero(b), _f64_zero(b)
        for s in range(0, b.shape[1], CHUNK_AMPS):
            br, bi = (b[p, s:s + CHUNK_AMPS].to(torch.float64)
                      for p in (0, 1))
            kr, ki = (k[p, s:s + CHUNK_AMPS].to(torch.float64)
                      for p in (0, 1))
            re = re + torch.dot(br, kr) + torch.dot(bi, ki)
            im = im + torch.dot(br, ki) - torch.dot(bi, kr)
        parts[d] = torch.stack([re, im])
    tot = mesh.reduce(parts)
    rdt = precision.numpy_dtype(bra.amps.dtype)
    return rdt.type(tot[0].item()), rdt.type(tot[1].item())


def fidelity_density(q, pure) -> float:
    """<psi| rho |psi>: shard d's columns c contribute
    sum_c psi_c (sum_r conj(psi_r) rho[r, c]), the products in the plane
    dtype (IEEE fp32 on f32 planes), the per-shard partials in f64."""
    precision.ieee_fp32()
    cols = _cols(q, "calcFidelity")
    dim = 1 << q.num_qubits
    psi = _psi_planes(pure, q.amps.dtype)
    parts = [None] * q.amps.mesh.size
    for d, x in _mine(q.amps):
        p = psi.to(x.device)
        pre, pim = p[0], p[1]
        # row c' of the (cols, dim) view is column c0 + c' of rho
        mre, mim = x[0].view(cols, dim), x[1].view(cols, dim)
        vr = torch.mv(mre, pre) + torch.mv(mim, pim)      # Re sum conj(psi_r) rho[r,c]
        vi = torch.mv(mim, pre) - torch.mv(mre, pim)
        c0 = d * cols
        cr, ci = pre[c0:c0 + cols], pim[c0:c0 + cols]
        parts[d] = torch.sum(vr * cr - vi * ci).to(torch.float64)
    return float(_reduce(q.amps, parts))


def hs_distance(a, b) -> float:
    mesh = _mesh_of(a, b)
    parts = [None] * mesh.size
    xs = aligned("calcHilbertSchmidtDistance", mesh, a)
    ys = aligned("calcHilbertSchmidtDistance", mesh, b)
    for d in mesh.local_ids:
        x, y = xs[d], ys[d]
        fx, fy = x.reshape(-1), y.reshape(-1).to(x.dtype)
        t = _f64_zero(x)
        for s in range(0, fx.numel(), CHUNK_AMPS):
            dd = (fx[s:s + CHUNK_AMPS] - fy[s:s + CHUNK_AMPS]).to(
                torch.float64)
            t = t + torch.dot(dd, dd)
        parts[d] = t
    return float(np.sqrt(mesh.reduce(parts).item()))


def linear_xeb(q, samples) -> float:
    s = torch.as_tensor(samples).reshape(-1).long().cpu()
    m = 1 << q.amps.local_n
    owner = s // m
    total = 0.0
    for d, x in _mine(q.amps):
        idx = (s[owner == d] % m).to(x.device)
        if idx.numel():
            re, im = x[0][idx], x[1][idx]
            total += float((re * re + im * im).to(torch.float64).sum())
    total = float(q.amps.mesh.host_all_reduce(
        torch.tensor(total, dtype=torch.float64)))
    return float((1 << q.num_state_qubits) * total / s.numel() - 1.0)


def weighted(fac, qs, out):
    """out = fac1 q1 + fac2 q2 + fac_out out on a sharded `out`, the
    other registers aligned to its shards."""
    if not is_sharded(out):
        refuse("setWeightedQureg", "its output register is on one device "
                                   "while an input is sharded")
    mesh = out.amps.mesh
    rdt = out.real_dtype
    f = [float(rdt.type(x)) for c in fac for x in (complex(c).real,
                                                   complex(c).imag)]

    def scale(re, im, fr, fi):
        return fr * re - fi * im, fr * im + fi * re
    q1 = aligned("setWeightedQureg", mesh, qs[0])
    q2 = aligned("setWeightedQureg", mesh, qs[1])
    for d, o in _mine(out.amps):
        a, b = q1[d].to(o.dtype), q2[d].to(o.dtype)
        for s in range(0, o.shape[1], CHUNK_AMPS):
            sl = slice(s, s + CHUNK_AMPS)
            ar, ai = scale(a[0, sl], a[1, sl], f[0], f[1])
            br, bi = scale(b[0, sl], b[1, sl], f[2], f[3])
            orr, oi = scale(o[0, sl], o[1, sl], f[4], f[5])
            o[0, sl] = ar + br + orr
            o[1, sl] = ai + bi + oi
    return out


def mix_density(q, p: float, other):
    if not is_sharded(q):
        refuse("mixDensityMatrix", "the register is on one device while "
                                   "the mixed-in one is sharded")
    ys = aligned("mixDensityMatrix", q.amps.mesh, other)
    for d, x in _mine(q.amps):
        a, b = x.reshape(-1), ys[d].reshape(-1).to(x.dtype)
        for s in range(0, a.numel(), CHUNK_AMPS):
            sl = slice(s, s + CHUNK_AMPS)
            a[sl] += p * (b[sl] - a[sl])
    return q


# ---------------------------------------------------------------------------
# gates and channels (ops/gates.py, ops/channels.py)
# ---------------------------------------------------------------------------

def _tier() -> str:
    tier = precision.matmul_precision()
    precision.ieee_fp32()
    return tier


def apply_ops(q, ops: Sequence, dual: bool):
    """GateOps on the shards in place through the sharded per-gate
    applier, each (when `dual`) with its column-space conjugate on a
    density register; the exchanges run on the register's mesh."""
    amps = q.amps
    xs = _xs(amps)
    tier = _tier()
    for op in ops:
        S._apply_gateop(xs, amps.mesh, amps.local_n, amps.n, dual, op, tier)
    return q


def dephase(q, targets, fac: float):
    """Dephasing as the diagonal it is on [targets, targets + N]: the
    entries whose row and column bits differ scaled by `fac`."""
    from quest_tpu_torch.circuit import GateOp
    k = len(targets)
    nq = q.num_qubits
    f = float(q.real_dtype.type(fac))
    diag = np.ones(1 << (2 * k), dtype=np.complex128)
    for i in range(1 << (2 * k)):
        if (i & ((1 << k) - 1)) != (i >> k):
            diag[i] = f
    qubits = tuple(targets) + tuple(t + nq for t in targets)
    return apply_ops(q, [GateOp("diagonal", qubits, operand=diag)], False)


# ---------------------------------------------------------------------------
# measurement (measurement.py)
# ---------------------------------------------------------------------------

def prob_of_zero(q, qubit: int) -> float:
    """P(qubit = 0): each shard's part (sharded._partial_prob0), one
    reduce, rounded to the plane dtype."""
    if q.is_density:
        _cols(q, "calcProbOfOutcome")
    amps = q.amps
    parts = [None] * amps.mesh.size
    for d, x in _mine(amps, _xs(amps)):
        parts[d] = S._partial_prob0(x, d, amps.local_n, amps.n, qubit,
                                    q.is_density)
    return float(_rdt(amps).type(_reduce(amps, parts).item()))


def collapse(q, qubit: int, outcome: int, prob: float):
    """Keep `outcome` on `qubit` (both copies on a density register),
    renormalised in the plane dtype, zero the rest; a global qubit keeps
    or zeroes whole shards. In place."""
    rdt = _rdt(q.amps)
    p = rdt.type(prob)
    if q.is_density:
        qubits = (qubit, qubit + q.num_qubits)
        renorm = rdt.type(1.0) / p
    else:
        qubits = (qubit,)
        renorm = rdt.type(1.0) / np.sqrt(p)
    for d, x in _mine(q.amps, _xs(q.amps)):
        S._collapse_shard(x, d, q.amps.local_n, qubits, outcome, renorm)
    return q


def probabilities(q, x: torch.Tensor, d: int) -> torch.Tensor:
    """Shard d's Born probabilities (a new plane-dtype tensor): |a|^2 of
    its amplitudes, or the diagonal entries of its columns."""
    if q.is_density:
        cols = _cols(q, "sample")
        dim = 1 << q.num_qubits
        c0 = d * cols
        return x[0].view(cols, dim)[:, c0:c0 + cols].diagonal().clone()
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[1], CHUNK_AMPS):
        re, im = x[0, s:s + CHUNK_AMPS], x[1, s:s + CHUNK_AMPS]
        torch.add(re * re, im * im, out=out[s:s + CHUNK_AMPS])
    return out


def sample_given_uniforms(q, u: torch.Tensor) -> torch.Tensor:
    """Basis-state indices (int64, on the first shard's device) of the
    shots whose uniforms are `u` (ref measurement.py:196-287): each shard
    builds its own CDF (_stable_cdf) of its probabilities; only the D
    shard totals cross shards, summed into an f64 ownership partition
    (shard d owns [lo_d, hi_d) of the grand total); every shard resolves
    the shots it owns with a local searchsorted. The uniforms are the
    same for every shard; the state never gathers. On a process mesh
    every shard's total reaches every process (one all_reduce of the D
    totals), each process resolves the shots its shards own, and one
    more all_reduce hands every process every shot's index."""
    from quest_tpu_torch.measurement import _stable_cdf
    amps = q.amps
    mesh = amps.mesh
    cdfs = [None] * mesh.size
    totals = torch.zeros(mesh.size, dtype=torch.float64)
    for d, x in _mine(amps):
        cdf = _stable_cdf(probabilities(q, x, d), inplace=True)
        cdfs[d] = cdf
        totals[d] = cdf[-1].to(torch.float64).cpu()
    totals = mesh.host_all_reduce(totals)
    cuml = torch.cumsum(totals, 0)
    grand = cuml[-1]
    uu = u.detach().to(torch.float64).cpu()
    scaled = uu * grand
    # shard of each shot: the first whose cumulative total exceeds it
    owner = torch.searchsorted(cuml, scaled, right=True).clamp_(
        max=mesh.size - 1)
    out = torch.zeros(uu.shape[0], dtype=torch.int64)
    per = cdfs[mesh.local_ids[0]].shape[0]
    for d in mesh.local_ids:
        cdf = cdfs[d]
        mine = (owner == d).nonzero().reshape(-1)
        if not mine.numel():
            continue
        lo = cuml[d - 1] if d else torch.zeros((), dtype=torch.float64)
        local = (scaled[mine] - lo).to(cdf.dtype).to(cdf.device)
        loc = torch.searchsorted(cdf, local, right=True).clamp_(
            max=per - 1)
        out[mine] = d * per + loc.cpu()
    out = mesh.host_all_reduce(out)
    return out.to(amps.device)
