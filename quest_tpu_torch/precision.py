"""Precision policy.

The reference (quest_tpu/precision.py) pairs complex64 amplitudes with
f32 planes and complex128 with f64, and picks a matmul tier through
QUEST_MATMUL_PRECISION. This slice of the port runs f32 planes only and
implements one tier, HIGHEST, as IEEE fp32 arithmetic: TF32 is switched
off for both cuBLAS and cuDNN before any contraction. HIGH (the 3-pass
split) and DEFAULT (one reduced-precision pass) raise
NotImplementedError until ROADMAP item B6 ports them.
"""

from __future__ import annotations

import numpy as np
import torch

from quest_tpu_torch.env import knob_value

DEFAULT_DTYPE = np.dtype(np.complex64)


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


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy real plane dtype."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def matmul_precision() -> str:
    """The contraction tier from QUEST_MATMUL_PRECISION. Only 'highest'
    (IEEE fp32) is implemented in the port."""
    tier = knob_value("QUEST_MATMUL_PRECISION")
    if tier != "highest":
        raise NotImplementedError(
            f"QUEST_MATMUL_PRECISION={tier!r} is not ported yet "
            f"(ROADMAP B6); the port runs the 'highest' tier (IEEE fp32)")
    return tier


def ieee_fp32() -> None:
    """Pin float32 contractions to IEEE fp32: TF32 off for matrix
    products and for cuDNN, so the plain PyTorch path computes what the
    kernel computes."""
    matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
