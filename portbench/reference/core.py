"""Precisions and the two plain primitives every reference state goes
through: a dense operator on a run of adjacent qubits (a matrix
product over a view of the state) and a diagonal phase (a real function
of the index bits, tabulated on the two halves of the index)."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

CHUNK = 1 << 26      # complex entries one step of a chunked pass touches
BLOCK = 6            # adjacent qubits composed into one dense operator


@dataclasses.dataclass(frozen=True)
class Precision:
    """What a reference run computes in: `real` is the plane dtype, and
    `tf32` rounds both operands of every matrix product to TF32 (a 10-bit
    mantissa) and lets the card's matmuls run in TF32."""
    name: str
    real: torch.dtype
    tf32: bool

    @property
    def complex(self) -> torch.dtype:
        return (torch.complex128 if self.real == torch.float64
                else torch.complex64)


TRUTH = Precision("float64", torch.float64, False)
CONTROL = Precision("tf32", torch.float32, True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (to nearest, ties away from zero), the
    rounding the tensor cores apply to their operands; float32 again."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


@contextlib.contextmanager
def matmul_mode(tf32: bool):
    """TF32 on or off for float32 matrix products within the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def cmm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """a @ b of complex tensors at `prec`: IEEE products in the planes'
    dtype, or four real products of TF32-rounded operands."""
    if not prec.tf32:
        with matmul_mode(False):
            return torch.matmul(a, b)
    ar, ai = round_tf32(a.real), round_tf32(a.imag)
    br, bi = round_tf32(b.real), round_tf32(b.imag)
    with matmul_mode(True):
        re = torch.matmul(ar, br) - torch.matmul(ai, bi)
        im = torch.matmul(ar, bi) + torch.matmul(ai, br)
    return torch.complex(re, im)


def apply_dense(psi: torch.Tensor, nbits: int, lo: int, u,
                prec: Precision) -> torch.Tensor:
    """psi <- U psi in place, U (2^k x 2^k) acting on index bits lo ..
    lo + k - 1 (U's index bit t is state bit lo + t), a chunk at a time."""
    u = torch.as_tensor(u).to(device=psi.device, dtype=psi.dtype)
    d = u.shape[0]
    k = d.bit_length() - 1
    b = 1 << lo
    a = 1 << (nbits - lo - k)
    v = psi.view(a, d, b)
    if b == 1:
        m, ut = v.view(a, d), u.transpose(0, 1)
        rows = max(1, CHUNK // d)
        for r in range(0, a, rows):
            m[r:r + rows] = cmm(m[r:r + rows], ut, prec)
        return psi
    rows = max(1, CHUNK // (d * b))
    cols = min(b, max(1, CHUNK // d))
    for r in range(0, a, rows):
        for c in range(0, b, cols):
            v[r:r + rows, :, c:c + cols] = cmm(u, v[r:r + rows, :, c:c + cols],
                                               prec)
    return psi


def apply_layer(psi: torch.Tensor, nbits: int, mats: dict, prec: Precision,
                offset: int = 0, width: int = None) -> torch.Tensor:
    """One-qubit operators `mats` {qubit: 2x2} on distinct qubits, applied
    at state bit qubit + offset, composed BLOCK adjacent qubits at a time
    into one Kronecker product each; `width` qubits in all (default
    nbits)."""
    width = nbits if width is None else width
    for lo in range(0, width, BLOCK):
        qs = range(lo, min(lo + BLOCK, width))
        if not any(q in mats for q in qs):
            continue
        m = np.eye(1, dtype=np.complex128)
        for q in qs:                       # the higher qubit on the left
            m = np.kron(np.asarray(mats.get(q, np.eye(2)), np.complex128), m)
        apply_dense(psi, nbits, lo + offset, m, prec)
    return psi


class Diagonal:
    """A real function of the index bits of an `nbits`-bit state, a sum
    of terms:

        ("z", a, c)        c * s_a           (s = +1 on bit 0, -1 on bit 1)
        ("zz", a, b, c)    c * s_a * s_b
        ("and", a, b, c)   c * x_a * x_b     (x the bit itself)

    tabulated on the low `split` bits and on the high rest of the index,
    a term that straddles the two kept as an outer product."""

    def __init__(self, nbits: int, terms, split: int = None):
        self.nbits = nbits
        self.split = nbits // 2 if split is None else split
        self.terms = [tuple(t) for t in terms]

    def tables(self, device, dtype):
        h = self.split
        idx = (torch.arange(1 << h, device=device),
               torch.arange(1 << (self.nbits - h), device=device))
        t = [torch.zeros(1 << h, dtype=dtype, device=device),
             torch.zeros(1 << (self.nbits - h), dtype=dtype, device=device)]
        cross = []

        def factor(kind, q):
            side = int(q >= h)
            x = ((idx[side] >> (q - h * side)) & 1).to(dtype)
            return side, (x if kind == "and" else 1.0 - 2.0 * x)

        for term in self.terms:
            if term[0] == "z":
                _, a, c = term
                side, f = factor("zz", a)
                t[side] += float(c) * f
                continue
            kind, a, b, c = term
            (sa, fa), (sb, fb) = factor(kind, a), factor(kind, b)
            if sa == sb:
                t[sa] += float(c) * fa * fb
            else:
                lo_f, hi_f = (fa, fb) if sa == 0 else (fb, fa)
                cross.append((float(c) * hi_f, lo_f))
        return t[0], t[1], cross

    @staticmethod
    def rows(tables, r0: int, r1: int) -> torch.Tensor:
        """The function on rows r0 .. r1 of the (2^(nbits-split),
        2^split) view of the index."""
        t_lo, t_hi, cross = tables
        out = t_hi[r0:r1, None] + t_lo[None, :]
        for f, g in cross:
            out = out + f[r0:r1, None] * g[None, :]
        return out

    def _chunks(self, psi: torch.Tensor):
        cols = 1 << self.split
        v = psi.view(-1, cols)
        step = max(1, CHUNK // cols)
        for r in range(0, v.shape[0], step):
            yield v, r, min(r + step, v.shape[0])

    def apply_phase(self, psi: torch.Tensor, prec: Precision) -> torch.Tensor:
        """psi <- exp(i f(x)) psi in place, the angles in prec.real."""
        tab = self.tables(psi.device, prec.real)
        for v, r0, r1 in self._chunks(psi):
            ang = self.rows(tab, r0, r1)
            v[r0:r1] *= torch.polar(torch.ones_like(ang), ang).to(psi.dtype)
        return psi

    def expectation(self, psi: torch.Tensor) -> float:
        """sum_x |psi_x|^2 f(x), in float64."""
        tab = self.tables(psi.device, torch.float64)
        total = torch.zeros((), dtype=torch.float64, device=psi.device)
        for v, r0, r1 in self._chunks(psi):
            p = v[r0:r1].abs().to(torch.float64) ** 2
            total += (p * self.rows(tab, r0, r1)).sum()
        return float(total)


def density_diagonal(n: int, terms) -> Diagonal:
    """U rho U^dagger of a diagonal U = exp(i f) on an n-qubit density
    matrix: f on the row bits less f on the column bits."""
    dual = []
    for t in terms:
        if t[0] == "z":
            dual += [t, ("z", t[1] + n, -t[2])]
        else:
            dual += [t, (t[0], t[1] + n, t[2] + n, -t[3])]
    return Diagonal(2 * n, dual, split=n)
