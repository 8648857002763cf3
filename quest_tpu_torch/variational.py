"""Differentiable parameterised circuits: variational energies.

A port of quest_tpu/variational.py (ROADMAP A8). Gate angles are tensors
that torch.autograd differentiates through: an energy function built by
`expectation` returns <psi(params)| H |psi(params)> as a 0-dim tensor,
and `torch.autograd.grad` (or `.backward()`) gives its exact gradient,
reverse mode through the simulation.

    from quest_tpu_torch import variational as V

    def ansatz(amps, params):
        amps = V.ry(amps, n, 0, params[0])
        amps = V.cnot(amps, n, 0, 1)
        return V.rz(amps, n, 1, params[1])

    energy = V.expectation(ansatz, n, codes, coeffs)   # on the card
    theta = torch.tensor([0.1, 0.2], device="cuda", requires_grad=True)
    value = energy(theta)
    grad, = torch.autograd.grad(value, theta)
    values = V.sweep(energy, theta_batch)              # per-set values

The gates work OUT OF PLACE on (2, 2^n) planes and return new planes:
the engines' primitives (ops/apply.py) update the state in place, which
autograd cannot tape through. Each gate here is a few broadcast tensor
expressions of the planes and the angle — a matrix on the target axes of
the bit view, a parity sign, a control mask through torch.where — so no
.item(), numpy value or Python float stands between theta and the
planes. They hold whole temporaries, so they serve the differentiable
path at the widths a taped gradient fits; the adjoint engine
(adjoint.py) runs its forward and backward walks through the in-place
primitives instead.

The energy evaluates through the grouped expectation engine
(ops/expec.expec_traced), differentiable in the planes. Statevector
registers; f32 planes by default (f64 with dtype=np.float64).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import matrices as M


def _angle(amps: torch.Tensor, theta) -> torch.Tensor:
    """theta as a 0-dim tensor in the planes' dtype on their device (a
    tensor keeps its graph)."""
    return torch.as_tensor(theta, dtype=amps.dtype, device=amps.device)


def _mat2(amps, m00, m01, m10, m11):
    """(re, im) (2, 2) tensors from complex entries given as (re, im)
    pairs of scalars (None for 0), in the planes' dtype."""
    z = torch.zeros((), dtype=amps.dtype, device=amps.device)

    def part(x):
        return _angle(amps, x) if x is not None else z
    re = torch.stack([torch.stack([part(m00[0]), part(m01[0])]),
                      torch.stack([part(m10[0]), part(m11[0])])])
    im = torch.stack([torch.stack([part(m00[1]), part(m01[1])]),
                      torch.stack([part(m10[1]), part(m11[1])])])
    return re, im


def _view(amps: torch.Tensor, n: int, qubits):
    """(x, dims, axis_of): the planes viewed (2, *bit_view dims)."""
    dims, axis_of = A.bit_view(n, qubits)
    return amps.reshape([2] + dims), dims, axis_of


def _where_controls(new, x, dims, axis_of, controls, cstates):
    """`new` where every control holds its state, else `x`."""
    if not controls:
        return new
    mask = A.control_mask(len(dims), axis_of, controls, cstates, x.device)
    return torch.where(mask.unsqueeze(0), new, x)


def apply_matrix(amps: torch.Tensor, n: int, mre, mim, targets,
                 controls: Sequence[int] = (),
                 cstates: Sequence[int] = ()) -> torch.Tensor:
    """New planes: the (2^k, 2^k) operator (re, im tensors; mim None for a
    real one; bit j of its index is targets[j]) on `targets` where every
    control holds its state (default 1). Differentiable in the planes
    and the operator."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    cstates = A.norm_control_states(controls, cstates)
    k = len(targets)
    precision.ieee_fp32()
    x, dims, axis_of = _view(amps, n, targets + controls)
    taxes = [axis_of[t] + 1 for t in reversed(targets)]
    rest = [a for a in range(1, len(dims) + 1) if a not in taxes]
    order = [0] + taxes + rest
    inverse = [order.index(a) for a in range(len(order))]
    shape = [x.shape[a] for a in order]
    xp = x.permute(order).reshape(2, 1 << k, -1)
    re, im = xp[0], xp[1]
    if mim is None:
        nre, nim = mre @ re, mre @ im
    else:
        nre = mre @ re - mim @ im
        nim = mre @ im + mim @ re
    new = torch.stack([nre, nim]).reshape(shape).permute(inverse)
    new = _where_controls(new, x, dims, axis_of, controls, cstates)
    return new.reshape(amps.shape)


def apply_parity_phase(amps: torch.Tensor, n: int, targets,
                       theta) -> torch.Tensor:
    """New planes: exp(-i theta/2 Z x ... x Z) on `targets`."""
    targets = tuple(int(t) for t in targets)
    half = _angle(amps, theta) / 2.0
    c, s = torch.cos(half), torch.sin(half)
    x, dims, axis_of = _view(amps, n, targets)
    sign = A.parity_sign(len(dims), axis_of, targets, amps.dtype,
                         amps.device)
    ss = s * sign if sign is not None else s
    new = torch.stack([c * x[0] + ss * x[1], c * x[1] - ss * x[0]])
    return new.reshape(amps.shape)


def apply_phase_where(amps: torch.Tensor, n: int, qubits, states,
                      tre, tim) -> torch.Tensor:
    """New planes: the amplitudes whose `qubits` hold `states` times
    (tre + i tim) (0-dim tensors), the rest unchanged."""
    qubits = tuple(int(q) for q in qubits)
    x, dims, axis_of = _view(amps, n, qubits)
    new = torch.stack([x[0] * tre - x[1] * tim, x[0] * tim + x[1] * tre])
    return _where_controls(new, x, dims, axis_of, qubits,
                           tuple(states)).reshape(amps.shape)


def rx(amps, n, target, theta, controls=(), cstates=()):
    """exp(-i theta/2 X) on `target` (ref rotateX, QuEST_common.c:292)."""
    hh = _angle(amps, theta) / 2.0
    c, s = torch.cos(hh), torch.sin(hh)
    mre, mim = _mat2(amps, (c, None), (None, -s), (None, -s), (c, None))
    return apply_matrix(amps, n, mre, mim, (target,), controls, cstates)


def ry(amps, n, target, theta, controls=(), cstates=()):
    """exp(-i theta/2 Y) on `target` (ref rotateY)."""
    hh = _angle(amps, theta) / 2.0
    c, s = torch.cos(hh), torch.sin(hh)
    mre, _ = _mat2(amps, (c, None), (-s, None), (s, None), (c, None))
    return apply_matrix(amps, n, mre, None, (target,), controls, cstates)


def rz(amps, n, target, theta):
    """exp(-i theta/2 Z) on `target` (ref rotateZ): a parity phase."""
    return apply_parity_phase(amps, n, (target,), theta)


def parity(amps, n, targets: Sequence[int], theta):
    """exp(-i theta/2 Z...Z) over `targets` (ref multiRotateZ)."""
    return apply_parity_phase(amps, n, tuple(targets), theta)


def phase(amps, n, target, theta, controls=(), cstates=None):
    """diag(1, e^{i theta}) on `target` (ref [controlled]phaseShift),
    conditioned on `controls` holding `cstates` (default all ones)."""
    t = _angle(amps, theta)
    controls = tuple(controls)
    states = (1,) * len(controls) if cstates is None else tuple(cstates)
    return apply_phase_where(amps, n, (target,) + controls, (1,) + states,
                             torch.cos(t), torch.sin(t))


def crz(amps, n, control, target, theta):
    """Controlled rotateZ (ref controlledRotateZ): diag(e^{-it/2},
    e^{it/2}) on `target` where `control` is 1."""
    hh = _angle(amps, theta) / 2.0
    mre, mim = _mat2(amps, (torch.cos(hh), -torch.sin(hh)), (None, None),
                     (None, None), (torch.cos(hh), torch.sin(hh)))
    return apply_matrix(amps, n, mre, mim, (target,), (control,))


def gate(amps, n, matrix, targets, controls=()):
    """A fixed (concrete) k-qubit unitary."""
    m = np.asarray(matrix, dtype=np.complex128)
    mre = torch.as_tensor(m.real, dtype=amps.dtype, device=amps.device)
    mim = (torch.as_tensor(m.imag, dtype=amps.dtype, device=amps.device)
           if np.any(m.imag) else None)
    return apply_matrix(amps, n, mre, mim, tuple(targets), tuple(controls))


def h(amps, n, target):
    return gate(amps, n, M.HADAMARD, (target,))


def x(amps, n, target):
    return gate(amps, n, M.PAULI_X, (target,))


def cnot(amps, n, control, target):
    return gate(amps, n, M.PAULI_X, (target,), (control,))


def cz(amps, n, q1, q2):
    one = torch.ones((), dtype=amps.dtype, device=amps.device)
    return apply_phase_where(amps, n, (q1, q2), (1, 1), -one, 0.0 * one)


def expectation(ansatz: Callable, n: int, all_codes, coeffs=None,
                initial_index: int = 0, dtype=np.float32,
                device=None) -> Callable:
    """`energy(params)` -> <psi(params)| H |psi(params)> as a 0-dim tensor
    in the plane dtype, for the Pauli sum H = sum_t coeffs[t] P_t (codes
    as in calc_expec_pauli_sum) or an `expec.PauliSum` passed as
    `all_codes` (coeffs omitted). The ansatz takes ((2, 2^n) planes,
    params) and returns new planes; psi starts from basis state
    `initial_index` on `device` (default: the CUDA card). The energy is
    the grouped engine's (ops/expec.expec_traced) and differentiable in
    params through torch.autograd."""
    from quest_tpu_torch.env import engine_mode_key
    from quest_tpu_torch.ops import expec as E
    from quest_tpu_torch.state import basis_planes

    dev = resolve_device(device)
    if isinstance(all_codes, E.PauliSum):
        if coeffs is not None:
            raise ValueError("pass coefficients inside the PauliSum, "
                             "not as a separate coeffs= argument")
        if all_codes.num_qubits != n:
            raise ValueError(
                f"PauliSum is over {all_codes.num_qubits} qubits but "
                f"the ansatz register has {n}")
        codes_key = E.parse_pauli_sum(np.asarray(all_codes.codes), n)
        coeffs = np.asarray(all_codes.coeffs, dtype=np.float64)
    else:
        codes_key = E.parse_pauli_sum(all_codes, n)
        coeffs = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    if len(coeffs) != len(codes_key):
        val.err("Invalid Pauli sum: must give exactly one coefficient "
                "per term.")
    plan = E.plan_expec(codes_key, n, density=False)
    rdt = np.dtype(dtype)
    cf = torch.as_tensor(coeffs, dtype=precision.torch_dtype(rdt),
                         device=dev)

    def energy(params):
        amps = basis_planes(initial_index, n=n, rdt=rdt, device=dev)
        amps = ansatz(amps, params)
        return E.expec_traced(amps, cf, plan).to(amps.dtype)

    energy.num_qubits = n
    energy.real_dtype = rdt.str
    ansatz_key = getattr(ansatz, "program_key", None)
    if ansatz_key is not None:
        # the value identity of the energy program (ref :189-208)
        energy.sweep_key = ("variational.expectation", ansatz_key,
                            codes_key, coeffs.tobytes(),
                            int(initial_index), rdt.str, n,
                            str(dev), engine_mode_key())
    return energy


# ---------------------------------------------------------------------------
# parameter sweeps (ref :252)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _shape(v) -> tuple:
    return tuple(getattr(v, "shape", np.shape(v)))


def _stack(outs):
    """Per-set outputs stacked along a new leading axis (tuples per
    position, as a vmapped function returns them)."""
    if isinstance(outs[0], tuple):
        return tuple(_stack([o[i] for o in outs])
                     for i in range(len(outs[0])))
    return torch.stack([torch.as_tensor(o) for o in outs])


def sweep(fn: Callable, param_batch, chunk: int = None):
    """`fn` (an energy or ansatz function of one parameter set) over a
    batch of parameter sets, stacked along the leading axis: equal to the
    per-set loop, which it is (eager PyTorch has no vmapped program to
    share; no bucket padding). `param_batch` is a stacked tensor or
    array, a LIST of parameter sets (stacked), or a tuple/dict pytree
    whose leaves share the leading batch axis (the evolved ansatz's
    (coeffs, dt)). A tuple whose leaves all have ONE shape is rejected:
    it could mean either stack or pytree. `chunk` bounds the sets per
    call of the reference's vmap; here every set runs alone, so any
    positive chunk gives the same result. chunk='auto' prices the chunk
    from the capacity model (plan.sweep_chunk: the largest power of two
    of sets whose planes fit env.hbm_bytes), which needs fn.num_qubits
    (set by `expectation`)."""
    if isinstance(param_batch, list):
        param_batch = torch.as_tensor(np.asarray(
            [np.asarray(p.detach().cpu() if torch.is_tensor(p) else p)
             for p in param_batch]))
    elif isinstance(param_batch, tuple):
        shapes = {_shape(v) for v in _leaves(param_batch)}
        if len(shapes) <= 1:
            raise ValueError(
                "ambiguous tuple param_batch (every leaf has shape "
                f"{shapes or {()}}): pass a LIST to stack parameter "
                "sets into the batch axis, a pre-stacked array, or a "
                "dict / shape-heterogeneous pytree whose leaves share "
                "the leading batch axis")
    params = _map(lambda v: v if torch.is_tensor(v) else torch.as_tensor(v),
                  param_batch)
    leaves = _leaves(params)
    if not leaves:
        raise ValueError("param_batch has no array leaves to sweep over")
    total = int(leaves[0].shape[0]) if leaves[0].dim() else 0
    for leaf in leaves:
        if leaf.dim() == 0 or int(leaf.shape[0]) != total:
            raise ValueError(
                "every param_batch leaf must share the leading batch "
                f"axis: got shapes {[tuple(l.shape) for l in leaves]}")
    if chunk == "auto":
        nq = getattr(fn, "num_qubits", None)
        if nq is None:
            raise ValueError(
                "chunk='auto' needs fn.num_qubits (set by "
                "variational.expectation); pass an explicit chunk for "
                "a bare ansatz function")
        from quest_tpu_torch import plan as P
        chunk = P.sweep_chunk(total, int(nq),
                              dtype=getattr(fn, "real_dtype", "f4"))
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    outs = [fn(_map(lambda a, i=i: a[i], params)) for i in range(total)]
    return _stack(outs)
