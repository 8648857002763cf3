"""The native host engine: cache-blocked C++ gate programs on CPU planes.

A port of quest_tpu/host.py over the same C++ runner
(native/host_kernels.cpp, loaded by native.py). Consecutive gates whose
targets all sit below a block boundary 2^B (QUEST_HOST_BLOCK, default
17: 1 MiB of f32 planes, inside an L2) are grouped, and the runner
applies the whole group to one block while it is resident before it
moves to the next: a layer of gates on low qubits costs one read and
write of the state instead of one per gate. Gates with a target at or
above the boundary run as full sweeps of their own; parity phases are
elementwise on absolute indices and block anywhere.

It runs on the host, one state at a time, over (2, 2^n) planes: a CPU
torch tensor or a numpy array, f32 or f64, updated in place when the
input is contiguous and writable (otherwise one copy is made and
returned). It is the floor of the serving engine's degradation ladder
(serve/engine.py) and the `host` trajectory engine
(trajectories.run_batched(engine="host")). A tensor on the card is not
accepted here: Circuit.apply_host copies a card register to the host and
back, explicitly.

Op kinds after circuit.flatten_ops: matrix (superoperators arrive as
matrix ops on the doubled targets), diagonal, parity and all-ones
phases, up to 6 targets; mid-circuit measurements and classically
controlled gates run through compile_circuit_host_measured. Anything
else — more targets, an operand that needs a gradient, or no native
library — raises HostEngineUnsupported naming the reason; the engine
never hands a circuit to another engine on its own.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from quest_tpu_torch import native
from quest_tpu_torch import precision
from quest_tpu_torch.env import knob_value

_MAX_TARGETS = 6


class HostEngineUnsupported(RuntimeError):
    """A circuit cannot run on the native host engine: an operand that
    needs a gradient, too many targets, a dynamic op on the static entry
    point, or no native library (the message says which)."""


def _lib():
    try:
        return native.load()
    except RuntimeError as e:
        raise HostEngineUnsupported(
            f"native host library unavailable: {e}") from None


def _as_concrete(operand) -> np.ndarray:
    if torch.is_tensor(operand):
        if operand.requires_grad:
            raise HostEngineUnsupported(
                "operand requires grad (the host engine runs constants)")
        operand = operand.detach().cpu().numpy()
    arr = np.asarray(operand)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        raise HostEngineUnsupported(f"non-numeric operand ({arr.dtype})")
    return arr.astype(np.complex128)


def _encode(flat_ops, n: int):
    """(prog int32[], coef float64[], groups int32[], block_log) for the
    native runner (the record layout of native/host_kernels.cpp). Raises
    HostEngineUnsupported on anything the runner does not implement."""
    block_log = min(knob_value("QUEST_HOST_BLOCK"), n)
    prog: List[int] = []
    coef: List[float] = []
    records = []        # (max target, record) per gate

    def emit(kind, targets, controls, cstates, values):
        coff = len(coef)
        coef.extend(values)
        records.append((max(targets), [kind, len(targets), len(controls),
                                       *targets, *controls, *cstates,
                                       coff]))

    def pairs(z: np.ndarray) -> list:
        vals = np.empty(2 * z.size)
        vals[0::2] = z.real.ravel()
        vals[1::2] = z.imag.ravel()
        return vals.tolist()

    for op in flat_ops:
        if op.kind in ("measure", "measure_dm", "classical"):
            raise HostEngineUnsupported(f"dynamic op {op.kind!r}")
        controls = tuple(int(c) for c in op.controls)
        cstates = tuple(int(s) for s in (op.cstates or (1,) * len(controls)))
        targets = tuple(int(t) for t in op.targets)
        if op.kind in ("matrix", "diagonal") and len(targets) > _MAX_TARGETS:
            raise HostEngineUnsupported(
                f"{len(targets)}-target {op.kind} (max {_MAX_TARGETS})")
        if op.kind == "matrix":
            d = 1 << len(targets)
            emit(0, targets, controls, cstates,
                 pairs(_as_concrete(op.operand).reshape(d, d)))
        elif op.kind == "diagonal":
            diag = _as_concrete(op.operand).reshape(-1)
            if diag.size != 1 << len(targets):
                raise HostEngineUnsupported("diagonal size mismatch")
            emit(1, targets, controls, cstates, pairs(diag))
        elif op.kind == "allones":
            # the phase where every listed qubit is 1: [1, term] on the
            # first, controlled on the rest (apply_phase_on_all_ones;
            # op.controls are not read for this kind)
            term = complex(_as_concrete(op.operand).reshape(()))
            emit(1, targets[:1], targets[1:], (1,) * (len(targets) - 1),
                 [1.0, 0.0, term.real, term.imag])
        elif op.kind == "parity":
            # exp(-i a/2 Z..Z): exp(-i a/2) on even parity, exp(+i a/2)
            # on odd (ops/apply.apply_parity_phase)
            a = float(_as_concrete(op.operand).real.reshape(()))
            c, s = np.cos(a / 2), np.sin(a / 2)
            emit(2, targets, (), (), [c, -s, c, s])
        else:
            raise HostEngineUnsupported(f"op kind {op.kind!r}")

    # greedy blocked grouping: gates whose targets sit below the block
    # boundary share one L2-resident sweep; others run as full sweeps
    groups: List[int] = []
    cur = 0
    for max_t, rec in records:
        if rec[0] == 2 or max_t < block_log:
            cur += 1
        else:
            if cur:
                groups += [cur, 1]
                cur = 0
            groups += [1, 0]
        prog.extend(rec)
    if cur:
        groups += [cur, 1]
    return (np.asarray(prog, dtype=np.int32),
            np.asarray(coef, dtype=np.float64),
            np.asarray(groups, dtype=np.int32), block_log)


def plan_summary(flat_ops, n: int) -> str:
    """The blocked schedule in one line: gates, full state sweeps, block
    size."""
    _, _, groups, block_log = _encode(flat_ops, n)
    it = iter(groups.tolist())
    ngates = sweeps = 0
    for count, blocked in zip(it, it):
        ngates += count
        sweeps += 1 if blocked else count
    return (f"host engine: {ngates} gates in {sweeps} state sweep(s) "
            f"(block=2^{block_log} amps)")


def _as_planes(state, n: int):
    """`state` as contiguous writable (2, 2^n) f32/f64 planes: the same
    object (a view of it) when it already is one, else one copy."""
    if torch.is_tensor(state):
        if state.device.type != "cpu":
            raise ValueError(
                f"the host engine runs on CPU planes, got a tensor on "
                f"{state.device}; copy it to the host first "
                f"(Circuit.apply_host does)")
        if state.numel() != 2 << n:
            raise ValueError(f"state of {state.numel()} values, the host "
                             f"engine takes (2, {1 << n}) planes")
        if state.dtype not in (torch.float32, torch.float64):
            state = state.to(torch.float32)
        if not state.is_contiguous():
            state = state.contiguous()
        return state
    arr = np.asarray(state)
    if arr.shape != (2, 1 << n):
        raise ValueError(f"state shape {arr.shape} != (2, {1 << n})")
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr)
    return arr


def _plane_ptrs(arr):
    """(re pointer, im pointer, fp type, 'f32'|'f64') of planes that
    _as_planes returned."""
    if torch.is_tensor(arr):
        f32 = arr.dtype == torch.float32
        base, step = arr.data_ptr(), arr.element_size() * (arr.numel() // 2)
        addrs = (base, base + step)
    else:
        f32 = arr.dtype == np.float32
        addrs = (arr.ctypes.data, arr.ctypes.data + arr.nbytes // 2)
    fp = ctypes.c_float if f32 else ctypes.c_double
    return (ctypes.cast(addrs[0], ctypes.POINTER(fp)),
            ctypes.cast(addrs[1], ctypes.POINTER(fp)), fp,
            "f32" if f32 else "f64")


def _run_native(lib, arr, n, enc, iters):
    prog, coef, groups, block_log = enc
    re_p, im_p, _, bits = _plane_ptrs(arr)
    rc = getattr(lib, f"qh_run_program_{bits}")(
        re_p, im_p, n, prog.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(prog), coef.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        groups.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(groups) // 2, block_log, iters)
    if rc != 0:
        raise RuntimeError(f"native host runner failed (rc={rc})")


def compile_circuit_host(ops, n: int, density: bool, iters: int = 1):
    """step(state) -> state running the flattened circuit through the
    native blocked runner, `iters` times a call, on (2, 2^n) CPU planes
    (a torch tensor or a numpy array, f32 or f64), in place when they
    are contiguous and writable."""
    from quest_tpu_torch.circuit import flatten_ops

    lib = _lib()
    flat = flatten_ops(ops, n, density)
    if not flat:
        return lambda state: _as_planes(state, n)
    enc = _encode(flat, n)

    def step(state):
        arr = _as_planes(state, n)
        _run_native(lib, arr, n, enc, iters)
        return arr

    return step


def _measure_native(lib, arr, n: int, qubit: int, draw,
                    density: bool = False) -> int:
    """One measurement in C, following measurement.measure_with_stats:
    the native probability of 0, then `draw()` only when the outcome is
    not forced within the dtype's eps (so a host run and an eager run
    seeded alike consume one stream), then the native collapse (1/sqrt
    of the probability on a statevector, 1/prob in both spaces on a
    density register). Returns the outcome."""
    re_p, im_p, fp, bits = _plane_ptrs(arr)
    eps = precision.real_eps(np.float32 if fp is ctypes.c_float
                             else np.float64)
    kind = "dm" if density else "sv"
    p_fn = getattr(lib, f"qh_prob0_{kind}_{bits}")
    p0 = float(p_fn(re_p, n, qubit) if density else p_fn(re_p, im_p, n,
                                                          qubit))
    if p0 < eps:
        outcome = 1
    elif 1.0 - p0 < eps:
        outcome = 0
    else:
        outcome = int(float(draw()) > p0)
    prob = max(p0 if outcome == 0 else 1.0 - p0, eps)
    getattr(lib, f"qh_collapse_{kind}_{bits}")(re_p, im_p, n, qubit,
                                               outcome, prob)
    return outcome


def compile_circuit_host_measured(ops, n: int, density: bool = False):
    """A dynamic circuit on the native host engine: step(state,
    draws=None) -> (planes, outcomes int32 array). Measurement-free
    stretches run through the blocked runner, measurements collapse in C,
    and a classically controlled gate runs as its own native program
    when its conditions hold. `draws` supplies the uniforms of the
    measurements whose outcome is not forced; by default they come from
    random_.uniform(), the stream the eager measurement API draws from,
    so a host run and an eager run seeded alike (random_.seed_quest)
    take the same outcomes."""
    from quest_tpu_torch import validation as val
    from quest_tpu_torch.circuit import flatten_ops

    lib = _lib()
    flat = flatten_ops(ops, n, density)

    def encode(piece):
        return _encode(piece, n) if piece else None

    program = []        # ("run", enc) | ("measure", qubit) |
    cur = []            # ("classical", conds, enc)
    n_meas = 0
    for op in flat:
        if op.kind in ("measure", "measure_dm"):
            program += [("run", encode(cur)), ("measure", int(op.targets[0]))]
            cur = []
            n_meas += 1
        elif op.kind == "classical":
            inners, conds = op.operand
            program += [("run", encode(cur)),
                        ("classical", tuple(conds), encode(list(inners)))]
            cur = []
        else:
            cur.append(op)
    program.append(("run", encode(cur)))
    if not n_meas:
        raise val.QuESTError(
            "Invalid operation: compile_circuit_host_measured requires "
            "at least one mid-circuit measurement; use "
            "compile_circuit_host instead.")

    def step(state, draws=None):
        from quest_tpu_torch import random_ as R
        arr = _as_planes(state, n)
        it = iter(draws) if draws is not None else None

        def draw():
            if it is None:
                return R.uniform()
            try:
                return next(it)
            except StopIteration:
                raise ValueError(
                    f"draws exhausted: this circuit has {n_meas} "
                    f"measurements (forced outcomes consume none)") from None

        outcomes = []
        for el in program:
            if el[0] == "run":
                if el[1] is not None:
                    _run_native(lib, arr, n, el[1], 1)
            elif el[0] == "measure":
                outcomes.append(_measure_native(lib, arr, n, el[1], draw,
                                                density=density))
            elif el[2] is not None and all(outcomes[i] == want
                                           for i, want in el[1]):
                _run_native(lib, arr, n, el[2], 1)
        return arr, np.asarray(outcomes, dtype=np.int32)

    return step
