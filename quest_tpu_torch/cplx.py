"""Host-side complex packing.

Amplitudes live as split (re, im) float planes throughout (see
quest_tpu_torch/state.py), the layout of the reference package
(quest_tpu/cplx.py) and of QuEST's own ComplexArray. Complex data enters
the engines as (re, im) float pairs produced by `pack`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pack(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: complex ndarray -> contiguous (re, im) float64 pair."""
    x = np.asarray(x)
    # np.array (not ascontiguousarray — that promotes 0-d to (1,))
    return (np.array(x.real, dtype=np.float64, order="C"),
            np.array(x.imag, dtype=np.float64, order="C"))
