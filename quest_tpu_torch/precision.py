"""Precision policy.

The reference (quest_tpu/precision.py) pairs complex64 amplitudes with
f32 planes and complex128 with f64, and picks a matmul tier for every
state-amplitude contraction through QUEST_MATMUL_PRECISION or
set_matmul_precision. The port runs f32 planes and all three tiers of the
reference's `_mxu_dot_general` (quest_tpu/ops/pallas_band.py:1039):

  highest  IEEE fp32 products and sums (TF32 switched off for cuBLAS and
           cuDNN before any contraction);
  high     each f32 input x split as hi = x with its low 16 bits cleared
           (exactly a bf16) and lo = bf16(x - hi); the contraction sums
           hi_a hi_b + hi_a lo_b + lo_a hi_b in fp32 (three bf16 products);
  default  both inputs rounded to bf16, one product, fp32 sums.

Every bf16 rounding here is round-to-nearest-even (`tensor.to(bfloat16)`
in PyTorch, `__float2bfloat16_rn` in csrc/segment.cu). A product of two
bf16 values is exact in fp32, so a tier's plain version is torch.matmul
in IEEE fp32 over the rounded parts (`tier_products`): it differs from
the kernel only in the order of the fp32 sums.

The tier applies where the reference's dots take it: the b0, b1 and scb
matrix stages of the segment kernel, and the matrix passthrough between
segments (ops/apply.py). The `sc` stage is an elementwise complex multiply
in the reference and stays exact fp32 at every tier. So do the port's
Kraus-pair and channel-selection stages (S10, S9): the reference
contracts them through `_mxu_dot_general` too, but here they are 4x4 and
2x2 butterflies in fp32, more exact than the TPU at HIGH and DEFAULT and
inside those tiers' error envelopes; no rounding is added to them.

A program reads the tier once, when it is compiled (Circuit.
compiled_fused, compiled, compiled_banded, compiled_batched, the
trajectory program), as the reference reads it at trace time, and keeps
it: a later change of the knob or of set_matmul_precision affects
programs compiled after it.

f64 planes bypass the tiers: the reference's tier acts on f32 dots only
(on its CPU an f64 dot is exact f64 at every tier), so tier_matmul hands
float64 operands straight to torch.matmul, and split_hi_lo refuses them
rather than round them to f32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from quest_tpu_torch.env import KNOBS, knob_value

DEFAULT_DTYPE = np.dtype(np.complex64)
TIERS = ("highest", "high", "default")
_HI_MASK = -65536                  # 0xFFFF0000 as an int32

_REAL_EPS = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-13}

_tier_override: Optional[str] = None
_default_dtype = DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Set the amplitude dtype of registers created without one (ref
    quest_tpu/precision.py:31): complex64 (f32 planes) or complex128
    (f64 planes); anything else raises ValueError."""
    global _default_dtype
    d = np.dtype(dtype)
    if d not in (np.dtype(np.complex64), np.dtype(np.complex128)):
        raise ValueError(
            f"amplitude dtype must be complex64 or complex128, got {d}")
    _default_dtype = d


def get_default_dtype() -> np.dtype:
    """The amplitude dtype of registers created without one."""
    return _default_dtype


def real_dtype_of(dtype) -> np.dtype:
    """The real plane dtype paired with a complex amplitude dtype."""
    d = np.dtype(dtype)
    if d == np.dtype(np.complex64):
        return np.dtype(np.float32)
    if d == np.dtype(np.complex128):
        return np.dtype(np.float64)
    if d in (np.dtype(np.float32), np.dtype(np.float64)):
        return d
    from quest_tpu_torch.validation import QuESTError
    raise QuESTError(
        f"unsupported amplitude dtype {d}: the precision tiers are "
        f"complex64 (f32 planes) and complex128 (f64 planes)")


def complex_dtype_of(dtype) -> np.dtype:
    """The logical complex dtype for a real plane dtype."""
    d = np.dtype(dtype)
    if d == np.dtype(np.float32):
        return np.dtype(np.complex64)
    if d == np.dtype(np.float64):
        return np.dtype(np.complex128)
    return d


def accum_dtype(plane_dtype=None) -> np.dtype:
    """Accumulator dtype of full-register reductions (norms, traces,
    Born probabilities): f64 whatever the planes (ref quest_tpu/
    precision.py:187, which falls to the plane dtype only when JAX's x64
    mode is off; torch always has f64)."""
    del plane_dtype
    return np.dtype(np.float64)


def real_eps(dtype) -> float:
    """Numerical tolerance of an amplitude or plane dtype (ref
    quest_tpu/precision.py:200): 1e-5 for complex64/f32, 1e-13 for
    complex128/f64."""
    return _REAL_EPS[real_dtype_of(dtype)]


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy real plane dtype."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of a torch plane dtype."""
    return np.dtype(str(dtype).replace("torch.", ""))


def set_matmul_precision(tier: Optional[str]) -> None:
    """Set the contraction tier for programs compiled from now on:
    'default', 'high' or 'highest', validated by the QUEST_MATMUL_PRECISION
    knob's own parser (ref quest_tpu/precision.py:49). None drops the
    setting, so the knob decides again."""
    global _tier_override
    if tier is None:
        _tier_override = None
        return
    if not isinstance(tier, str):
        raise TypeError(f"matmul precision is a tier name, got {tier!r}")
    _tier_override = KNOBS["QUEST_MATMUL_PRECISION"].parse(tier)


def matmul_precision() -> str:
    """The session's contraction tier: the last set_matmul_precision,
    else QUEST_MATMUL_PRECISION (default 'highest'). 'high' keeps ~1e-5
    relative error per 128-term dot at three bf16 tensor-core products
    (the reference recommends it for compute-bound circuits); 'default'
    is one bf16 product, ~1e-3 (ref quest_tpu/precision.py:67)."""
    if _tier_override is not None:
        return _tier_override
    return knob_value("QUEST_MATMUL_PRECISION")


def check_tier(tier: str) -> str:
    """`tier` if it is one of TIERS; raises ValueError otherwise."""
    if tier not in TIERS:
        raise ValueError(f"matmul tier must be one of {TIERS}, got {tier!r}")
    return tier


def ieee_fp32() -> None:
    """Pin float32 contractions to IEEE fp32: TF32 off for matrix
    products and for cuDNN, so the plain PyTorch versions compute, at
    every tier, exactly the products they are given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round-to-nearest-even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 `x`: hi = x with the low 16 bits of its encoding
    cleared (exactly a bf16), lo = x - hi rounded to bf16; both f32.
    Raises on float64 input, which bypasses the tiers."""
    if x.dtype == torch.float64:
        raise TypeError("f64 planes bypass the matmul tiers: no bf16 split")
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, round_bf16(x - hi)


def tier_products(a: torch.Tensor, b: torch.Tensor,
                  tier: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The operand pairs whose fp32 products the tier sums for a @ b:
    [(a, b)] at 'highest', [(bf16(a), bf16(b))] at 'default', and
    [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)] at 'high'. float64
    operands bypass the tier: [(a, b)] at every tier."""
    check_tier(tier)
    if tier == "highest" or torch.float64 in (a.dtype, b.dtype):
        return [(a, b)]
    if tier == "default":
        return [(round_bf16(a), round_bf16(b))]
    ah, al = split_hi_lo(a)
    bh, bl = split_hi_lo(b)
    return [(ah, bh), (ah, bl), (al, bh)]


def tier_matmul(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """torch.matmul(a, b) at `tier`: IEEE fp32 matmuls of the tier's
    rounded parts, summed; for float64 operands, the float64 product at
    every tier."""
    ieee_fp32()
    out = None
    for x, y in tier_products(a, b, tier):
        p = torch.matmul(x, y)
        out = p if out is None else out + p
    return out
