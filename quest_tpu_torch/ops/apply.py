"""Gate application on split re/im planes: the reference's XLA primitives.

Ports of quest_tpu/ops/apply.py: `norm_control_states`, `control_mask`
and `parity_sign` (:128-166), `apply_matrix` (:182) for any number of
targets, `apply_matrix_rows` (:226), `apply_band` (:578),
`apply_diagonal` (:936), `apply_parity_phase` (:971),
`apply_phase_on_all_ones` (:997) and `apply_pauli_string` (:87). The reference runs all of them in XLA,
outside Pallas; here they are plain tensor code and no kernel of the
port. They serve the per-gate and banded engines (circuit.py `compiled`,
`compiled_banded`), the f64 route of the fused engine, and its
passthroughs between kernel segments (a cross-band matrix, a channel's
superoperator, a band above the block top, a diagonal).

Unlike the reference's functions, which return new planes, every
primitive here updates the planes in place and returns them. The planes
are f32 or f64 (the operands follow their dtype), one state ((2, 2^n),
or the fused view (2, 2^(n-7), 128), which shares its storage) or a
batch (B, 2, ...) of states, contiguous. The flat index is viewed with
one axis per target and control bit and one per gap between them
(`bit_view`); a control or band predicate narrows its axis to the wanted
half (a view, never a mask over the whole state), and the largest gap
axis is cut into chunks of at most CHUNK_AMPS amplitudes a plane
(`target_chunks`). Each chunk is read, computed and written back before
the next, so a 16 GiB f64 state needs a few hundred MiB of temporaries
and never a second copy.

  * apply_matrix: the targets are permuted to the front of the chunk
    and the operator multiplies the (2^k, rest) view from the left, for
    every k. The reference's target-minor matmul for wide operators
    (`_apply_matrix_matmul` :867) is a TPU layout choice and computes the
    same map. Four real products (two for a real operator).
  * apply_band: the band [ql, ql+w) of the index is one axis of the
    chunk viewed (pre, 2^w, post): one contraction a product, in the
    reference's Gauss three-product form and its real-only short cut,
    so HIGH and DEFAULT round (gre + gim) and (re + im) as it does.
  * the diagonal, parity and all-ones functions: in-place multiplies of
    views by broadcast factors.

Contractions run at the matmul tier the caller names
(precision.tier_matmul; IEEE fp32 at 'highest', TF32 off; float64 at
every tier). The reference's `_apply_matrix_laneblock` / `_laneblock_core`
(:679-866) avoid the TPU's (8, 128) tile padding of a narrow minor axis
and compute the same map as the view path; `_limb_band_contract` (:352)
and the QUEST_F64_MXU / QUEST_F64_CHUNK knobs emulate f64 products on
the TPU's bf16 matrix unit. The card multiplies f64 natively, so none of
them is ported as a scheme.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val

CHUNK_AMPS = 1 << 24          # amplitudes per plane per chunk


def bit_view(n: int, qubits: Sequence[int]):
    """(dims, axis_of): the flat 2^n index viewed with one size-2 axis per
    qubit in `qubits` (highest first) and one axis per gap around them;
    axis_of[q] is qubit q's axis."""
    dims, axis_of = [], {}
    hi = n
    for q in sorted(set(qubits), reverse=True):
        dims.append(1 << (hi - q - 1))
        axis_of[q] = len(dims)
        dims.append(2)
        hi = q
    dims.append(1 << hi)
    return dims, axis_of


def norm_control_states(controls, control_states):
    """Control states with an empty list meaning all ones; raises when
    there is not exactly one state per control (ref apply.py:140)."""
    controls, control_states = tuple(controls), tuple(control_states)
    if controls and not control_states:
        return (1,) * len(controls)
    if len(controls) != len(control_states):
        raise val.QuESTError("Invalid control state: must give exactly one "
                             "bit per control qubit.")
    return control_states


def control_mask(ndims: int, axis_of, controls, control_states,
                 device=None):
    """Boolean tensor broadcastable against a bit_view of the planes, True
    where every control holds its state; None without controls (ref
    apply.py:155). The primitives narrow views instead; this is the
    mask form for a caller that needs one."""
    control_states = norm_control_states(controls, control_states)
    mask = None
    for c, s in zip(controls, control_states):
        shape = [1] * ndims
        shape[axis_of[c]] = 2
        vec = (torch.arange(2, device=device) == s).reshape(shape)
        mask = vec if mask is None else mask & vec
    return mask


def parity_sign(ndims: int, axis_of, qubits, dtype=torch.float32,
                device=None):
    """(-1)^(parity of the listed qubits' bits) as a broadcast product of
    per-axis (+1, -1) vectors; None for no qubits (ref apply.py:114)."""
    sign = None
    for q in qubits:
        shape = [1] * ndims
        shape[axis_of[q]] = 2
        vec = torch.tensor([1.0, -1.0], dtype=dtype,
                           device=device).reshape(shape)
        sign = vec if sign is None else sign * vec
    return sign


def _pair(operand, amps: torch.Tensor):
    """(re, im) tensors of an operand in the planes' dtype on their
    device: a complex array, or an (re, im) pair of arrays or tensors.
    im is None where the operand is real (the reference's real-only
    short cut; an (re, im) pair of tensors keeps its im)."""
    if isinstance(operand, tuple):
        re, im = operand
        if isinstance(im, np.ndarray) and not np.any(im):
            im = None
    else:
        m = np.asarray(operand, dtype=np.complex128)
        re, im = m.real, (m.imag if np.any(m.imag) else None)

    def put(x):
        return torch.as_tensor(x, dtype=amps.dtype, device=amps.device)
    return put(re), (None if im is None else put(im))


def target_chunks(amps: torch.Tensor, n: int, targets,
                  controls: Sequence[int] = (), cstates: Sequence[int] = ()):
    """Yield (xr, xi, order) for each chunk of the planes of one state or
    of a batch (B, 2, ...) of them (contiguous): xr, xi are views
    with a leading state axis, then one axis per bit_view axis of
    targets + controls, each control narrowed to its wanted state
    (default 1); `order` permutes them to (state, targets[k-1], ...,
    targets[0], the rest), so that bit j of the target index is
    targets[j]. The largest gap axis is cut so that a chunk holds at most
    CHUNK_AMPS amplitudes per plane, whatever the batch."""
    targets = tuple(targets)
    controls = tuple(controls)
    cstates = norm_control_states(controls, cstates)
    if amps.numel() % (2 << n) or not amps.is_contiguous():
        raise ValueError(f"state of shape {tuple(amps.shape)} is not "
                         f"contiguous (2, 2^{n}) planes or a batch of them")
    b = amps.numel() // (2 << n)
    dims, axis_of = bit_view(n, targets + controls)
    x = amps.reshape(b, 2, -1)
    planes = [x[:, p].view([b] + dims) for p in range(2)]
    for c, s in zip(controls, cstates):
        planes = [p.narrow(axis_of[c] + 1, s, 1) for p in planes]
    taxes = [axis_of[t] + 1 for t in reversed(targets)]
    rest = [a for a in range(1, len(dims) + 1) if a not in taxes]
    order = [0] + taxes + rest
    bits = {a + 1 for a in axis_of.values()}
    gaps = [a for a in rest if a not in bits]
    cut = max(gaps, key=lambda a: planes[0].shape[a])
    per_slice = planes[0].numel() // planes[0].shape[cut]
    step = max(1, CHUNK_AMPS // max(per_slice, 1))
    for start in range(0, planes[0].shape[cut], step):
        w = min(step, planes[0].shape[cut] - start)
        xr, xi = (p.narrow(cut, start, w) for p in planes)
        yield xr, xi, order


def _factor(vec: torch.Tensor, order, k: int, ndim: int) -> torch.Tensor:
    """A (2^k,) table (bit j of its index is targets[j]) shaped to
    broadcast against a chunk of target_chunks whose target axes are
    order[1:k+1]."""
    taxes = order[1:k + 1]
    f = vec.reshape((2,) * k)
    if k > 1:
        f = f.permute(sorted(range(k), key=lambda i: taxes[i]))
    shape = [1] * ndim
    for a in taxes:
        shape[a] = 2
    return f.reshape(shape)


def apply_matrix(amps: torch.Tensor, n: int, matrix, targets,
                 controls: Sequence[int] = (), cstates: Sequence[int] = (),
                 tier: str = "highest") -> torch.Tensor:
    """Apply `matrix` ((2^k, 2^k) complex, or an (re, im) pair; bit j of
    its index is targets[j]) to `targets` of the n-qubit planes `amps`,
    where every control c holds its state (default 1), at matmul `tier`,
    in the planes' dtype. Any k. In place; returns `amps`."""
    mre, mim = _pair(matrix, amps)
    return apply_matrix_planes(amps, n, mre, mim, targets, controls, cstates,
                               tier)


# the fused view (2, 2^(n-7), 128) shares the flat planes' storage, so the
# reference's kernel-layout variant is the same function here
apply_matrix_rows = apply_matrix


def apply_matrix_planes(amps: torch.Tensor, n: int, mre: torch.Tensor,
                        mim, targets, controls: Sequence[int] = (),
                        cstates: Sequence[int] = (),
                        tier: str = "highest") -> torch.Tensor:
    """apply_matrix with the matrix as (re, im) tensors on the state's
    device (im None: a real operator) — the form a matrix computed on the
    device (a drawn Kraus branch) takes, read without a trip to the host.
    `amps` may be a batch (B, 2, ...) of states; the matrix is then
    (2^k, 2^k) for all of them or (B, 2^k, 2^k), one per state, applied
    in one batched contraction per chunk."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    k = len(targets)
    if not k:
        raise ValueError("a matrix needs at least one target")
    if (tuple(mre.shape[-2:]) != (1 << k, 1 << k) or mre.dim() > 3
            or (mim is not None and mre.shape != mim.shape)):
        raise ValueError(f"matrix of shape {tuple(mre.shape)} for {k} targets")
    precision.check_tier(tier)

    def mm(m, x):
        return precision.tier_matmul(m, x, tier)
    for xr, xi, order in target_chunks(amps, n, targets, controls, cstates):
        b = xr.shape[0]
        if mre.dim() == 3 and mre.shape[0] != b:
            raise ValueError(f"{mre.shape[0]} matrices for {b} states")
        shape = [xr.shape[a] for a in order]
        inverse = [order.index(a) for a in range(len(order))]
        pr = xr.permute(order).reshape(b, 1 << k, -1)
        pi = xi.permute(order).reshape(b, 1 << k, -1)
        if mim is None:
            nre, nim = mm(mre, pr), mm(mre, pi)
        else:
            nre = mm(mre, pr) - mm(mim, pi)
            nim = mm(mre, pi) + mm(mim, pr)
        xr.copy_(nre.reshape(shape).permute(inverse))
        xi.copy_(nim.reshape(shape).permute(inverse))
    return amps


def apply_band(amps: torch.Tensor, n: int, op, ql: int, w: int,
               preds: Sequence = (), tier: str = "highest") -> torch.Tensor:
    """Apply a composed (2^w, 2^w) band operator `op` (complex, or an
    (re, im) pair) to qubits [ql, ql+w) of the planes, where every
    out-of-band predicate (qubit, want) holds, at matmul `tier` (ref
    apply.py:578): out[p, a, q] = sum_b G[a, b] x[p, b, q], in the
    reference's Gauss form t1 = Gre x_re, t2 = Gim x_im, t3 = (Gre + Gim)
    (x_re + x_im), re = t1 - t2, im = t3 - t1 - t2, or two products for a
    real operator. In place; returns `amps`."""
    gre, gim = _pair(op, amps)
    band = 1 << w
    if tuple(gre.shape) != (band, band):
        raise ValueError(f"band operator of shape {tuple(gre.shape)} "
                         f"for width {w}")
    precision.check_tier(tier)
    gsum = None if gim is None else gre + gim

    def mm(g, x):
        if x.shape[2] == 1:         # band at the bottom: (pre, band) @ G^T
            return precision.tier_matmul(x.squeeze(2), g.mT,
                                         tier).unsqueeze(2)
        return precision.tier_matmul(g, x, tier)
    pq = tuple(int(q) for q, _ in preds)
    ps = tuple(int(s) for _, s in preds)
    for xr, xi, order in target_chunks(amps, n, range(ql, ql + w), pq, ps):
        # the band's axes are order[1:w+1], adjacent bits with size-1 gap
        # axes between them: one axis of 2^w once reshaped
        view = (int(np.prod(xr.shape[:order[1]])), band, -1)
        re, im = xr.reshape(view), xi.reshape(view)
        if gim is None:
            nre, nim = mm(gre, re), mm(gre, im)
        else:
            t1, t2 = mm(gre, re), mm(gim, im)
            nim = mm(gsum, re + im).sub_(t1).sub_(t2)
            nre = t1.sub_(t2)
        xr.copy_(nre.reshape(xr.shape))
        xi.copy_(nim.reshape(xi.shape))
    return amps


def _complex_mul_(xr, xi, fre, fim):
    """(xr + i xi) *= (fre + i fim), in place on the views, with the
    reference's roundings re*fre - im*fim and re*fim + im*fre (fim None:
    a real factor)."""
    if fim is None:
        xr.mul_(fre)
        xi.mul_(fre)
        return
    old = xr.clone()
    xr.mul_(fre).addcmul_(xi, fim, value=-1)
    xi.mul_(fre).addcmul_(old, fim)


def apply_diagonal(amps: torch.Tensor, n: int, diag, targets,
                   controls: Sequence[int] = (),
                   cstates: Sequence[int] = ()) -> torch.Tensor:
    """Multiply by the diagonal operator `diag` ((2^k,) complex, or an
    (re, im) pair; bit j of its index is targets[j]) where every control
    holds its state (ref apply.py:936). In place; returns `amps`."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    k = len(targets)
    dre, dim = _pair(diag, amps)
    if dre.numel() != 1 << k:
        raise ValueError(f"diagonal of {dre.numel()} entries for {k} targets")
    for xr, xi, order in target_chunks(amps, n, targets, controls, cstates):
        fre = _factor(dre.reshape(-1), order, k, xr.dim())
        fim = None if dim is None else _factor(dim.reshape(-1), order, k,
                                               xr.dim())
        _complex_mul_(xr, xi, fre, fim)
    return amps


def apply_parity_phase(amps: torch.Tensor, n: int, targets,
                       angle) -> torch.Tensor:
    """exp(-i angle/2 Z x ... x Z) on `targets` (ref apply.py:971): each
    amplitude times cos(angle/2) - i sin(angle/2) (-1)^parity, the sign a
    broadcast product of per-axis (+1, -1) vectors. In place; returns
    `amps`."""
    targets = tuple(int(t) for t in targets)
    half = torch.as_tensor(angle, dtype=amps.dtype) / 2.0
    cosf = half.cos().to(amps.device)
    sinf = half.sin().to(amps.device)
    for xr, xi, order in target_chunks(amps, n, targets):
        axis_of = {t: a for t, a in zip(reversed(targets), order[1:])}
        sign = parity_sign(xr.dim(), axis_of, targets, amps.dtype,
                           amps.device)
        _complex_mul_(xr, xi, cosf, -sinf * sign)
    return amps


def apply_phase_on_all_ones(amps: torch.Tensor, n: int, qubits,
                            term) -> torch.Tensor:
    """Multiply the amplitudes whose `qubits` bits are all 1 by the
    complex scalar `term` (ref apply.py:997): the symmetric
    multi-controlled phase family. In place; returns `amps`."""
    qubits = tuple(int(q) for q in qubits)
    tre, tim = _pair(np.asarray(term, dtype=np.complex128).reshape(()), amps)
    for xr, xi, _ in target_chunks(amps, n, (), qubits):
        _complex_mul_(xr, xi, tre, tim)
    return amps


def pauli_masks(term):
    """(x_bits, zy_bits, ny) of a Pauli string, one code (0..3) per
    qubit: the X/Y support (the flip), the Z/Y support (the sign) and
    the Y count (the (-i)^ny quarter-turn)."""
    x_bits = tuple(q for q, p in enumerate(term) if p in (1, 2))
    zy_bits = tuple(q for q, p in enumerate(term) if p in (2, 3))
    return x_bits, zy_bits, sum(1 for p in term if p == 2)


def pauli_support(term) -> tuple:
    """The qubits a Pauli string acts on (not identity), ascending: the
    axes pauli_chunks keeps whole in every chunk."""
    return tuple(q for q, p in enumerate(term) if p)


def pauli_chunks(amps: torch.Tensor, n: int, term):
    """Yield (xr, xi, wr, wi) for each chunk of the planes (one state or
    a batch, cut as target_chunks cuts them, every qubit of the string
    an axis of the chunk): xr, xi the chunk's views, wr, wi the string's
    image (P psi) on them as new tensors:

        (P psi)[j] = (-i)^ny (-1)^parity(j & zy) psi[j ^ x]

    (ref apply.py:87). P maps each chunk onto itself, so a caller may
    write the image back into the views. An all-identity string yields
    the views themselves as its image."""
    x_bits, zy_bits, ny = pauli_masks(term)
    involved = pauli_support(term)
    _, axis_of = bit_view(n, involved)
    ax = {q: a + 1 for q, a in axis_of.items()}
    flips = [ax[q] for q in x_bits]
    for xr, xi, _ in target_chunks(amps, n, involved):
        wr = xr.flip(flips) if flips else xr
        wi = xi.flip(flips) if flips else xi
        sign = parity_sign(xr.dim(), ax, zy_bits, xr.dtype, xr.device)
        if sign is not None:
            wr, wi = wr * sign, wi * sign
        k = ny % 4
        if k == 1:                  # * -i
            wr, wi = wi, -wr
        elif k == 2:                # * -1
            wr, wi = -wr, -wi
        elif k == 3:                # * i
            wr, wi = -wi, wr
        yield xr, xi, wr, wi


def apply_pauli_string(amps: torch.Tensor, n: int, term) -> torch.Tensor:
    """P|psi> for a whole Pauli string (one code 0..3 per qubit) in one
    flip, sign and quarter-turn pass (ref apply.py:87), in place chunk by
    chunk, so a 30-qubit state needs no second copy; returns `amps`."""
    if not any(term):
        return amps
    for xr, xi, wr, wi in pauli_chunks(amps, n, term):
        xr.copy_(wr)
        xi.copy_(wi)
    return amps
