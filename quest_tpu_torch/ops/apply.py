"""General matrix application on the fused-engine layout.

`apply_matrix_rows` is the port of quest_tpu/ops/apply.py:226: a
(2^k, 2^k) operator (k <= 4 targets, controls allowed) applied to the
(2, 2^(n-7), 128) planes the segment kernel works on. In the reference
it is XLA, outside Pallas: the fused engine's passthrough for multi-
target matrices that no kernel stage reaches (a 2-qubit channel's
4-target superoperator, a cross-band 3-qubit gate). Here it is plain
tensor code — views, one permute copy and torch.matmul per chunk — and
no kernel of the port. Its contraction runs at the program's matmul tier
(quest_tpu_torch/precision.py), as the reference's XLA dots read the
session tier (quest_tpu/ops/apply.py:604/768/898): at 'high' or
'default' the products are IEEE fp32 matmuls of the tier's bf16 parts,
so a density step rounds the same way on both sides of a segment
boundary.

The state (or a batch of states, one contraction for all of them) is
updated in place, chunk by chunk: the flat index is viewed with one
axis per target and control bit and one per gap between them;
the controls select their wanted half (a view), and the largest gap axis
is cut into chunks of at most CHUNK_AMPS amplitudes. Each chunk is read,
contracted and written back before the next, so an 8 GiB state needs a
few hundred MiB of temporaries and never a second copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from quest_tpu_torch import precision

MAX_TARGETS = 4
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


def apply_matrix_rows(amps: torch.Tensor, n: int, matrix, targets,
                      controls: Sequence[int] = (),
                      cstates: Sequence[int] = (),
                      tier: str = "highest") -> torch.Tensor:
    """Apply `matrix` ((2^k, 2^k) complex; bit j of its index is
    targets[j]) to `targets` of the n-qubit planes `amps` ((2, 2^n) or
    (2, rows, 128), f32, contiguous, or a batch (B, 2, ...) of them),
    where every control c holds its state (default 1), at matmul `tier`.
    In place; returns `amps`."""
    m = np.asarray(matrix, dtype=np.complex128)
    k = len(tuple(targets))
    if m.shape != (1 << k, 1 << k):
        raise ValueError(f"matrix of shape {m.shape} for {k} targets")
    mre = torch.as_tensor(m.real, dtype=torch.float32, device=amps.device)
    mim = torch.as_tensor(m.imag, dtype=torch.float32, device=amps.device)
    return apply_matrix_planes(amps, n, mre, mim, targets, controls, cstates,
                               tier)


def apply_matrix_planes(amps: torch.Tensor, n: int, mre: torch.Tensor,
                        mim: torch.Tensor, targets, controls: Sequence[int] = (),
                        cstates: Sequence[int] = (),
                        tier: str = "highest") -> torch.Tensor:
    """apply_matrix_rows with the matrix as f32 (re, im) tensors on the
    state's device — the form a matrix computed on the device (a drawn
    Kraus branch) takes, read without a trip to the host. `amps` may be
    a batch (B, 2, ...) of states; the matrix is then (2^k, 2^k) for all
    of them or (B, 2^k, 2^k), one per state, applied in one batched
    contraction per chunk."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    cstates = tuple(int(s) for s in cstates) or (1,) * len(controls)
    k = len(targets)
    if not 1 <= k <= MAX_TARGETS:
        raise NotImplementedError(
            f"apply_matrix_rows takes 1..{MAX_TARGETS} targets, got {k} "
            f"(the reference's flat path for wider operators is ROADMAP A3)")
    if (tuple(mre.shape[-2:]) != (1 << k, 1 << k) or mre.dim() > 3
            or mre.shape != mim.shape):
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
        nre = mm(mre, pr) - mm(mim, pi)
        nim = mm(mre, pi) + mm(mim, pr)
        xr.copy_(nre.reshape(shape).permute(inverse))
        xi.copy_(nim.reshape(shape).permute(inverse))
    return amps


def target_chunks(amps: torch.Tensor, n: int, targets,
                  controls: Sequence[int] = (), cstates: Sequence[int] = ()):
    """Yield (xr, xi, order) for each chunk of the planes of one state or
    of a batch (B, 2, ...) of them (contiguous f32): xr, xi are views
    with a leading state axis, then one axis per bit_view axis of
    targets + controls, each control narrowed to its wanted state
    (default 1); `order` permutes them to (state, targets[k-1], ...,
    targets[0], the rest), so that bit j of the target index is
    targets[j]. The largest gap axis is cut so that a chunk holds at most
    CHUNK_AMPS amplitudes per plane, whatever the batch."""
    targets = tuple(targets)
    controls = tuple(controls)
    cstates = tuple(cstates) or (1,) * len(controls)
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
