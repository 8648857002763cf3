"""The segment kernel's wrapper, its plain PyTorch version, and operand
packing.

`prepare_segment` turns one swept segment of the planner (stages plus
numpy operand arrays, quest_tpu_torch/ops/band_plan.py) into a `Segment`:
the block geometry under HOPPER_GEOMETRY, a device table of stage
descriptors and one device buffer with every operand in the reference's
packing and orientation. It runs once per segment when a program is
compiled, never per call.

`segment_sweep(amps, seg)` applies the segment in place. On a CUDA
tensor it launches the hand-written kernel (csrc/segment.cu) and counts
the launch in `segment_sweep.launches`, and once for each stage kind the
segment holds in `segment_sweep.stage_launches` (keyed by
`stage_label`); on a CPU tensor it runs the
plain version, `segment_sweep_reference`, which applies each stage to
the whole state with reshapes that expose the band bits and torch.matmul
for the contractions. It does not share the kernel's tiling.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import FrozenSet, Sequence, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.band_plan import (
    HOPPER_GEOMETRY, LANE_QUBITS, LANES, Budgets, Geometry, MatStage,
    MultiPhaseStage, ParityStage, PhaseStage, segment_geometry)

DESC_WORDS = 16
# descriptor columns (csrc/segment.cu enum F_*)
(F_KIND, F_DIM, F_POS, F_REAL, F_SI, F_SJ, F_LANE_MASK, F_LANE_WANT,
 F_ROW_MASK, F_ROW_WANT, F_OP_OFF, F_FORMS, F_MASKED) = range(13)
K_MAT, K_PHASE, K_PARITY, K_MULTIPHASE = range(4)
MAT_DIMS = (2, 4, 8, 16, 32, 64, 128)
MAX_MULTIPHASE_ROWS = 64
MAX_TILE_BITS = 14

_UNPORTED = {
    "PairStage": "ROADMAP B9 (density registers)",
    "DiagVecStage": "ROADMAP B8 (general diagonals, QFT class)",
    "BatchSelStage": "ROADMAP B10 (batched trajectories)",
}


def check_supported(stages) -> None:
    """Raise NotImplementedError naming the ROADMAP item of the first
    stage kind the port's kernel does not run."""
    for st in stages:
        if not isinstance(st, (MatStage, PhaseStage, ParityStage,
                               MultiPhaseStage)):
            name = type(st).__name__
            raise NotImplementedError(
                f"{name} is not ported yet: {_UNPORTED.get(name, 'ROADMAP B')}")


def stage_label(st) -> str:
    """Stage kind as the launch counts name it: b0, b1, scb<d>, sc, phase,
    parity or multiphase."""
    if isinstance(st, MatStage):
        return f"scb{st.dim}" if st.kind == "scb" else st.kind
    return {PhaseStage: "phase", ParityStage: "parity",
            MultiPhaseStage: "multiphase"}[type(st)]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One swept segment, packed for the kernel."""
    n: int
    stages: Tuple
    arrays: Tuple[np.ndarray, ...]       # host operands, planner layout
    geometry: Geometry
    desc: torch.Tensor                   # (stages, DESC_WORDS) int64
    ops: torch.Tensor                    # all operands, flat f32
    operands: Tuple[torch.Tensor, ...]   # per-stage views into `ops`
    scat_mask: int                       # scattered global row bits
    free_mask: int                       # row bits taken by the block index
    labels: FrozenSet[str]               # stage_label of each stage

    @property
    def device(self) -> torch.device:
        return self.ops.device


def _preds_masks(preds):
    mask = want = 0
    for bit, s in preds:
        mask |= 1 << bit
        want |= int(s) << bit
    return mask, want


def _mat_row(st: MatStage, geo: Geometry) -> list:
    """Descriptor of a matrix stage: contraction position inside the
    tile, operand strides (G[i, j] = op[i*si + j*sj]) and predicates."""
    d = st.dim
    w = d.bit_length() - 1
    if d not in MAT_DIMS:
        raise ValueError(f"matrix stage of dimension {d} not supported")
    if st.kind == "b0":
        pos = 0
    elif st.kind == "b1":
        pos = LANE_QUBITS
        if w > geo.inner_bits:
            raise ValueError(f"b1 d={d} needs {w} inner row bits, "
                             f"geometry holds {geo.inner_bits}")
    elif st.kind in ("scb", "sc"):
        pos = LANE_QUBITS + geo.tile_row_bit(st.bit)
        for k in range(w):
            if LANE_QUBITS + geo.tile_row_bit(st.bit + k) != pos + k:
                raise ValueError(f"{st.kind} bits {st.bit}+{w} are not "
                                 f"adjacent tile axes in {geo}")
    else:
        raise ValueError(f"unknown matrix stage kind {st.kind!r}")
    # the planner stores G^T (X @ G^T form) for b0, b1 and 128-wide scb,
    # G for narrow scb and sc (quest_tpu/ops/pallas_band.py:462-468)
    transposed = st.kind in ("b0", "b1") or (st.kind == "scb" and d == LANES)
    si, sj = (1, d) if transposed else (d, 1)
    lm, lw = _preds_masks(st.lane_preds)
    rm, rw = _preds_masks(st.row_preds)
    masked = int(bool(st.lane_preds or st.row_preds))
    row = [0] * DESC_WORDS
    row[F_KIND], row[F_DIM], row[F_POS], row[F_REAL] = (
        K_MAT, d, pos, int(st.real_only))
    row[F_SI], row[F_SJ] = si, sj
    row[F_LANE_MASK], row[F_LANE_WANT] = lm, lw
    row[F_ROW_MASK], row[F_ROW_WANT] = rm, rw
    row[F_MASKED] = masked
    return row


def prepare_segment(stages: Sequence, arrays: Sequence[np.ndarray], n: int,
                    device, budgets: Budgets = HOPPER_GEOMETRY) -> Segment:
    """Pack one segment — its geometry, a descriptor table (one int64 row
    of DESC_WORDS per stage) and one flat f32 buffer of every operand —
    and move the table and buffer to `device` (once, at compile time)."""
    check_supported(stages)
    if not stages or len(stages) != len(arrays):
        raise ValueError("a segment needs one operand array per stage")
    geo = segment_geometry(stages, n, budgets=budgets)
    if geo.tile_bits > MAX_TILE_BITS:
        raise ValueError(f"tile of {geo.tile_bits} bits exceeds the "
                         f"kernel's {MAX_TILE_BITS}")
    arrays = tuple(np.asarray(a, dtype=np.float32) for a in arrays)
    rows, offs = [], []
    off = 0
    for st, arr in zip(stages, arrays):
        if isinstance(st, MatStage):
            if arr.shape != (2, st.dim, st.dim):
                raise ValueError(f"{st.kind} operand shape {arr.shape}")
            row = _mat_row(st, geo)
        elif isinstance(st, MultiPhaseStage):
            m = len(st.forms)
            if arr.shape != (m, 8) or m > MAX_MULTIPHASE_ROWS:
                raise ValueError(f"multiphase operand shape {arr.shape} "
                                 f"(at most {MAX_MULTIPHASE_ROWS} rows)")
            row = [0] * DESC_WORDS
            row[F_KIND], row[F_DIM] = K_MULTIPHASE, m
            row[F_FORMS] = sum(1 << r for r, f in enumerate(st.forms)
                               if f == "p")
        else:
            if arr.shape != (1, 8):
                raise ValueError(f"phase operand shape {arr.shape}")
            row = [0] * DESC_WORDS
            row[F_KIND] = K_PHASE if isinstance(st, PhaseStage) else K_PARITY
        row[F_OP_OFF] = off
        rows.append(row)
        offs.append(off)
        off += arr.size
    flat = np.concatenate([a.reshape(-1) for a in arrays])
    desc = np.array(rows, dtype=np.int64).reshape(-1, DESC_WORDS)
    dev = torch.device(device)
    ops = torch.from_numpy(flat).to(dev)
    operands = tuple(ops[o:o + a.size].view(a.shape)
                     for o, a in zip(offs, arrays))
    row_bits = n - LANE_QUBITS
    scat_mask = sum(1 << s for s in geo.scat)
    free_mask = (((1 << row_bits) - 1) & ~scat_mask
                 & ~((1 << geo.inner_bits) - 1))
    return Segment(n=n, stages=tuple(stages), arrays=arrays, geometry=geo,
                   desc=torch.from_numpy(desc).to(dev), ops=ops,
                   operands=operands, scat_mask=scat_mask,
                   free_mask=free_mask,
                   labels=frozenset(stage_label(st) for st in stages))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    if not getattr(lib, "_quest_declared", False):
        vp, ci, cu, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                           ctypes.c_longlong)
        lib.quest_segment_sweep.argtypes = [vp, ci, ci, ci, cu, cu, vp, ci,
                                            vp, cll, vp]
        lib.quest_segment_sweep.restype = ci
        lib.quest_segment_desc_words.restype = ci
        lib.quest_segment_max_tile_bits.restype = ci
        lib.quest_segment_max_multiphase_rows.restype = ci
        lib.quest_cuda_error_string.argtypes = [ci]
        lib.quest_cuda_error_string.restype = ctypes.c_char_p
        layout = (lib.quest_segment_desc_words(),
                  lib.quest_segment_max_tile_bits(),
                  lib.quest_segment_max_multiphase_rows())
        if layout != (DESC_WORDS, MAX_TILE_BITS, MAX_MULTIPHASE_ROWS):
            raise RuntimeError(f"segment kernel layout {layout} does not "
                               f"match the packer's")
        lib._quest_declared = True
    return lib


def _check_state(amps: torch.Tensor, seg: Segment) -> None:
    if amps.dtype != torch.float32:
        raise TypeError(f"segment_sweep takes float32 planes, got {amps.dtype}")
    if amps.numel() != 2 << seg.n or amps.shape[0] != 2 or amps.dim() not in (2, 3):
        raise ValueError(f"state of shape {tuple(amps.shape)} is not "
                         f"(2, 2^{seg.n}) or (2, rows, 128)")
    if amps.dim() == 3 and amps.shape[2] != LANES:
        raise ValueError(f"state view {tuple(amps.shape)} must end in 128 lanes")
    if not amps.is_contiguous():
        raise ValueError("segment_sweep needs a contiguous state")
    if amps.device != seg.device:
        raise ValueError(f"state on {amps.device}, segment on {seg.device}")


def segment_sweep(amps: torch.Tensor, seg: Segment) -> torch.Tensor:
    """Apply segment `seg` to `amps` ((2, 2^n) or (2, rows, 128) f32) in
    place and return it: one kernel launch on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check_state(amps, seg)
    if amps.device.type == "cpu":
        out = segment_sweep_reference(amps, seg.stages, seg.operands, seg.n)
        return amps.copy_(out.reshape(amps.shape))
    if amps.device.type != "cuda":
        raise ValueError(f"segment_sweep runs on cuda or cpu, not {amps.device}")
    lib = _lib()
    geo = seg.geometry
    with torch.cuda.device(amps.device):
        stream = torch.cuda.current_stream(amps.device).cuda_stream
        rc = lib.quest_segment_sweep(
            amps.data_ptr(), seg.n, geo.tile_bits, geo.inner_bits,
            seg.scat_mask, seg.free_mask, seg.desc.data_ptr(),
            len(seg.stages), seg.ops.data_ptr(), geo.blocks, stream)
    if rc != 0:
        raise RuntimeError(
            f"segment kernel launch failed: CUDA error {rc} "
            f"({lib.quest_cuda_error_string(rc).decode()})")
    segment_sweep.launches += 1
    for label in seg.labels:
        segment_sweep.stage_launches[label] = (
            segment_sweep.stage_launches.get(label, 0) + 1)
    return amps


segment_sweep.launches = 0
segment_sweep.stage_launches = {}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _pred_mask(lane, row, lane_preds, row_preds):
    mask = None
    for bit, want in lane_preds:
        m = ((lane >> bit) & 1) == want
        mask = m if mask is None else mask & m
    for bit, want in row_preds:
        m = ((row >> bit) & 1) == want
        mask = m if mask is None else mask & m
    return mask


def _parity(x, mask: int):
    """Parity of the bits of `x` selected by `mask` (int tensor)."""
    par = torch.zeros_like(x)
    b = 0
    while mask >> b:
        if (mask >> b) & 1:
            par = par ^ ((x >> b) & 1)
        b += 1
    return par


def _sign(x, mask: int):
    """(-1)^parity of the bits of `x` selected by `mask`, as f32. Taken
    per axis (lane or row ids) and multiplied in by broadcasting, since
    (-1)^(a^b) = (-1)^a (-1)^b: no full-state integer temporaries."""
    return 1.0 - 2.0 * _parity(x, mask).to(torch.float32)


def _row_mask(lo, hi) -> int:
    return int(lo) | (int(hi) << 15)


def _contract(re, im, g, st: MatStage, n: int):
    """Apply the stage's operator to the planes (each (2^n,) flat):
    out[.., i, ..] = sum_j G[i, j] x[.., j, ..] over the stage's bits."""
    d = st.dim
    w = d.bit_length() - 1
    if st.kind == "b0":
        q0 = 0
    elif st.kind == "b1":
        q0 = LANE_QUBITS
    else:
        q0 = LANE_QUBITS + st.bit
    transposed = st.kind in ("b0", "b1") or (st.kind == "scb" and d == LANES)
    gre, gim = (g[0].T, g[1].T) if transposed else (g[0], g[1])
    shape = (1 << (n - q0 - w), d, 1 << q0)
    xr, xi = re.reshape(shape), im.reshape(shape)
    if st.real_only:
        return torch.matmul(gre, xr), torch.matmul(gre, xi)
    nre = torch.matmul(gre, xr) - torch.matmul(gim, xi)
    nim = torch.matmul(gre, xi) + torch.matmul(gim, xr)
    return nre, nim


def segment_sweep_reference(amps: torch.Tensor, stages: Sequence,
                            arrays: Sequence, n: int) -> torch.Tensor:
    """Plain PyTorch version of one segment: every stage applied to the
    whole state in turn. `arrays` are the planner's operands (numpy or
    torch). Returns new (2, 2^(n-7), 128) planes; `amps` is not
    changed."""
    check_supported(stages)
    precision.ieee_fp32()
    dev = amps.device
    x = amps.reshape(2, -1, LANES)
    re, im = x[0], x[1]
    rows = re.shape[0]
    lane = torch.arange(LANES, device=dev).reshape(1, LANES)
    row = torch.arange(rows, device=dev).reshape(rows, 1)
    for st, arr in zip(stages, arrays):
        g = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        if isinstance(st, MatStage):
            nre, nim = _contract(re, im, g, st, n)
            nre, nim = nre.reshape(rows, LANES), nim.reshape(rows, LANES)
            mask = _pred_mask(lane, row, st.lane_preds, st.row_preds)
            if mask is not None:
                nre = torch.where(mask, nre, re)
                nim = torch.where(mask, nim, im)
            re, im = nre, nim
            continue
        v = g.cpu().tolist()
        if isinstance(st, PhaseStage):
            tre, tim, lm, lw = v[0][0], v[0][1], int(v[0][2]), int(v[0][3])
            rm, rw = _row_mask(v[0][4], v[0][5]), _row_mask(v[0][6], v[0][7])
            mask = ((lane & lm) == lw) & ((row & rm) == rw)
            nre = re * tre - im * tim
            nim = re * tim + im * tre
            re, im = torch.where(mask, nre, re), torch.where(mask, nim, im)
        elif isinstance(st, ParityStage):
            c, s, lm = v[0][0], v[0][1], int(v[0][2])
            rm = _row_mask(v[0][3], v[0][4])
            sn = (s * _sign(lane, lm)) * _sign(row, rm)
            re, im = re * c + im * sn, im * c - re * sn
        else:
            tot = torch.zeros_like(re)
            for form, (ang, lm, lo, hi, *_) in zip(st.forms, v):
                lm, rm = int(lm), _row_mask(lo, hi)
                if form == "a":
                    match = ((lane & lm) == lm) & ((row & rm) == rm)
                    tot = tot + torch.where(match, ang, 0.0)
                else:
                    tot = tot + (ang * _sign(lane, lm)) * _sign(row, rm)
            cs, sn = torch.cos(tot), torch.sin(tot)
            re, im = re * cs - im * sn, re * sn + im * cs
    return torch.stack([re, im])
