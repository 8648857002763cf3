"""General matrix application on the fused-engine layout.

`apply_matrix_rows` is the port of quest_tpu/ops/apply.py:226: a
(2^k, 2^k) operator (k <= 4 targets, controls allowed) applied to the
(2, 2^(n-7), 128) planes the segment kernel works on. In the reference
it is XLA, outside Pallas: the fused engine's passthrough for multi-
target matrices that no kernel stage reaches (a 2-qubit channel's
4-target superoperator, a cross-band 3-qubit gate). Here it is plain
tensor code — views, one permute copy and torch.matmul per chunk — and
no kernel of the port.

The state is updated in place, chunk by chunk: the flat index is viewed
with one axis per target and control bit and one per gap between them;
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
                      cstates: Sequence[int] = ()) -> torch.Tensor:
    """Apply `matrix` ((2^k, 2^k) complex; bit j of its index is
    targets[j]) to `targets` of the n-qubit planes `amps` ((2, 2^n) or
    (2, rows, 128), f32, contiguous), where every control c holds its
    state (default 1). In place; returns `amps`."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    cstates = tuple(int(s) for s in cstates) or (1,) * len(controls)
    k = len(targets)
    m = np.asarray(matrix, dtype=np.complex128)
    if not 1 <= k <= MAX_TARGETS:
        raise NotImplementedError(
            f"apply_matrix_rows takes 1..{MAX_TARGETS} targets, got {k} "
            f"(the reference's flat path for wider operators is ROADMAP A3)")
    if m.shape != (1 << k, 1 << k):
        raise ValueError(f"matrix of shape {m.shape} for {k} targets")
    if amps.numel() != 2 << n or not amps.is_contiguous():
        raise ValueError(f"state of shape {tuple(amps.shape)} is not "
                         f"contiguous (2, 2^{n}) planes")
    precision.ieee_fp32()
    dims, axis_of = bit_view(n, targets + controls)
    planes = [amps.reshape(2, -1)[p].view(dims) for p in range(2)]
    for c, s in zip(controls, cstates):
        planes = [x.narrow(axis_of[c], s, 1) for x in planes]
    # matrix row index = target bits, targets[k-1] most significant
    taxes = [axis_of[t] for t in reversed(targets)]
    rest = [a for a in range(len(dims)) if a not in taxes]
    order = taxes + rest
    inverse = [order.index(a) for a in range(len(dims))]
    gaps = [a for a in rest if a not in axis_of.values()]
    cut = max(gaps, key=lambda a: planes[0].shape[a])
    per_slice = planes[0].numel() // planes[0].shape[cut]
    step = max(1, CHUNK_AMPS // max(per_slice, 1))
    dev = amps.device
    mre = torch.as_tensor(m.real, dtype=torch.float32, device=dev)
    mim = torch.as_tensor(m.imag, dtype=torch.float32, device=dev)
    for start in range(0, planes[0].shape[cut], step):
        w = min(step, planes[0].shape[cut] - start)
        xr, xi = (x.narrow(cut, start, w) for x in planes)
        shape = [xr.shape[a] for a in order]
        pr = xr.permute(order).reshape(1 << k, -1)
        pi = xi.permute(order).reshape(1 << k, -1)
        nre = torch.matmul(mre, pr) - torch.matmul(mim, pi)
        nim = torch.matmul(mre, pi) + torch.matmul(mim, pr)
        xr.copy_(nre.reshape(shape).permute(inverse))
        xi.copy_(nim.reshape(shape).permute(inverse))
    return amps
