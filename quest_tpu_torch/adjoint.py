"""Adjoint differentiation: gradients with three live registers.

A port of quest_tpu/adjoint.py (ROADMAP A8), single device. Reverse mode
through a simulation (the taped engine) holds one residual state per
parametric gate; the adjoint method holds three registers whatever the
depth and the parameter count (ref :1-34):

    E(theta) = <psi0| U(theta)+ H U(theta) |psi0>

    forward:   psi_L = U_L ... U_1 |psi0>            (in place)
    seed:      lambda = H |psi_L>                    (expec.apply_pauli_sum_planes)
    backward, k = L..1 (gradient before un-apply):
        rotation  U_k = exp(-i s theta/2 P):  dE/dtheta += w s Im <lambda| P |psi>
        projector U_k = exp(+i s theta Proj): dE/dtheta += w s Im <lambda| Proj |psi>
        psi <- U_k+ psi,  lambda <- U_k+ lambda

with w = 1 (rotations) / -2 (projectors) on statevectors and 1/2 / -1 per
copy on the doubled density register, where a gate and its column dual
share one parameter and the dual flips the angle sign per family
(`_DUAL_S`). Each overlap Im<lambda|G|psi> is one chunked sweep over the
expectation engine's group view (`_im_overlap`): the generator's flip
form and control projector as factored tables, never a matrix. Constant
gate runs between parameters band-fuse through fusion.fixed_run_plan and
run through the banded primitives, in place.

The adjoint engine is a torch.autograd.Function (`_AdjointEnergy`): its
forward runs the gates in place under no_grad on a fresh register and
saves only the final psi and theta; its backward makes the three-register
walk above, un-applying the gates in place on psi (so one forward serves
one backward). The taped engine is plain autograd through the
out-of-place variational gates (variational.py), its constant runs a
`_FixedApply` Function whose backward applies the run's inverse to the
cotangent (the VJP of a unitary is its adjoint).

`value_and_grad(target, hamiltonian)` returns `fn(theta) -> (E, dE/dtheta)`
as tensors, the engine chosen by `engine=` or QUEST_ADJOINT (auto prices
both against the device memory, env.hbm_bytes: the card's, or
QUEST_HBM_BYTES), cached by value (equal specs return the same fn).

`grad_record` is the plan IR's grad axis (plan.build_plan).

On a mesh (`value_and_grad(mesh=)`, ref :593-700) the same walk runs over
the shards of a parallel.ShardedAmps: constant runs through the sharded
per-gate applier (their raw GateOp streams), parametric gates through
`_apply_param_sharded` (a global rx/ry target is the butterfly's pair
exchange), the energy and lambda through the grouped engine's sharded
evaluators (one exchange per distinct global flip mask), each overlap
reading the partner shard for a global flip bit; the per-parameter
partials reduce ONCE. `predict_vjp_collectives` (ref :703) prices the
same walk on the host; the mesh's recorder holds the issued exchanges
equal to it. Statevector meshes only, as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from quest_tpu_torch import circuit as CC
from quest_tpu_torch import precision
from quest_tpu_torch import variational as V
from quest_tpu_torch.env import resolve_device
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.validation import QuESTError


class AdjointError(QuESTError):
    """A target the adjoint engine cannot differentiate; names the op or
    mode at fault."""


# ---------------------------------------------------------------------------
# the program: parametric entries + fused constant runs (ref :83-313)
# ---------------------------------------------------------------------------


#: generator flip form per rotation family: targets -> (x_bits, zy_bits,
#: ny) of the signed Pauli G in U = exp(-i s theta/2 G)
_ROT_FORMS = {
    "parity": lambda targets: ((), tuple(targets), 0),
    "rx": lambda targets: ((targets[0],), (), 0),
    "ry": lambda targets: ((targets[0],), (targets[0],), 1),
}

#: density column-dual angle sign per family: conj(U(theta)) = U(s*theta)
_DUAL_S = {"parity": -1.0, "rx": -1.0, "ry": 1.0,
           "phase": -1.0, "allones": -1.0}

_REJECT_KINDS = {"superop": "noise channels",
                 "measure": "measurements",
                 "measure_dm": "measurements",
                 "classical": "classically-controlled gates"}


@dataclasses.dataclass(frozen=True)
class _Param:
    """One parametric gate occurrence: 'rot' is U = exp(-i s theta/2
    P_mask G), 'proj' U = exp(+i s theta Proj(mask)); the overlap reads
    the flip form (x/zy/ny) under the (mask_bits, mask_states)
    projector."""
    pidx: int
    family: str
    kind: str                    # 'rot' | 'proj'
    targets: Tuple[int, ...]
    controls: Tuple[int, ...]
    cstates: Tuple[int, ...]
    s: float                     # angle sign (column duals flip it)
    w: float                     # overlap weight (register-kind factor)
    x_bits: Tuple[int, ...]
    zy_bits: Tuple[int, ...]
    ny: int
    mask_bits: Tuple[int, ...]
    mask_states: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _Fixed:
    """A constant gate run between parameters: `fwd` / `inv` apply it
    and its exact inverse to (2, 2^n) planes IN PLACE; `ops` / `inv_ops`
    keep the raw GateOp streams (None for Trotter frame rotations)."""
    fwd: Callable
    inv: Callable
    ops: Optional[Tuple] = None
    inv_ops: Optional[Tuple] = None

    def __hash__(self):
        return id(self)


@dataclasses.dataclass(frozen=True)
class _Program:
    n: int                       # register qubits (2N for density)
    density: bool
    entries: Tuple
    num_params: int

    def __hash__(self):
        return id(self)


def _rot_param(pidx, family, targets, controls, cstates, s, w):
    x, zy, ny = _ROT_FORMS[family](targets)
    return _Param(pidx, family, "rot", targets, controls, cstates,
                  s, w, x, zy, ny, controls, cstates)


def _proj_param(pidx, family, targets, controls, cstates, s, w):
    mask_bits = targets + controls
    mask_states = (1,) * len(targets) + cstates
    return _Param(pidx, family, "proj", targets, controls, cstates,
                  s, w, (), (), 0, mask_bits, mask_states)


def _param_entry(op, family, pidx, density, col, N):
    shift = N if col else 0
    targets = tuple(t + shift for t in op.targets)
    controls = tuple(c + shift for c in op.controls)
    cstates = tuple(op.cstates) if op.cstates else (1,) * len(controls)
    s = _DUAL_S[family] if col else 1.0
    if family in _ROT_FORMS:
        w = 0.5 if density else 1.0
        return _rot_param(pidx, family, targets, controls, cstates, s, w)
    w = -1.0 if density else -2.0
    return _proj_param(pidx, family, targets, controls, cstates, s, w)


def _make_fixed(ops, n):
    from quest_tpu_torch.ops import fusion as F
    ops = tuple(ops)
    inv_ops = tuple(CC.inverse_op(op) for op in reversed(ops))
    fwd_items = tuple(F.fixed_run_plan(ops, n))
    inv_items = tuple(F.fixed_run_plan(inv_ops, n))

    def fwd(amps, _items=fwd_items, _n=n):
        return CC._apply_banded_items(amps, _n, _items, "highest")

    def inv(amps, _items=inv_items, _n=n):
        return CC._apply_banded_items(amps, _n, _items, "highest")

    return _Fixed(fwd=fwd, inv=inv, ops=ops, inv_ops=inv_ops)


def build_circuit_program(circuit, density: bool):
    """(program, theta0) of a Circuit: every op `circuit.as_rotation`
    recovers becomes a `_Param` (sharing its theta index with its density
    dual); constant runs band-fuse into `_Fixed` blocks. Raises
    AdjointError, naming the op, on anything it cannot differentiate."""
    from quest_tpu_torch.ops import fusion as F
    N = circuit.num_qubits
    n = 2 * N if density else N
    entries = []
    theta0 = []
    run = []

    def flush():
        if run:
            entries.append(_make_fixed(run, n))
            run.clear()

    for idx, op in enumerate(circuit.ops):
        if op.kind in _REJECT_KINDS:
            raise AdjointError(
                f"Invalid adjoint target: op {idx} ({_REJECT_KINDS[op.kind]}"
                f") is not differentiable — the backward walk needs an "
                f"exact inverse stream")
        if not F._concrete(op.operand):
            raise AdjointError(
                f"Invalid adjoint target: op {idx} ({op.kind}) carries a "
                f"non-concrete operand; adjoint differentiation recovers "
                f"angles from CONCRETE gates (circuit.as_rotation)")
        rot = CC.as_rotation(op)
        if rot is None:
            run.append(op)
            if density:
                d = CC.dual_of(op, N)
                if d is not None:
                    run.append(d)
            continue
        family, th = rot
        pidx = len(theta0)
        theta0.append(th)
        flush()
        entries.append(_param_entry(op, family, pidx, density, False, N))
        if density:
            entries.append(_param_entry(op, family, pidx, density, True, N))
    flush()
    program = _Program(n=n, density=density, entries=tuple(entries),
                       num_params=len(theta0))
    return program, np.asarray(theta0, dtype=np.float64)


def build_trotter_program(ansatz):
    """(program, (idx, scale)) of an `evolution.trotter_ansatz`: the
    Strang schedule replayed gate by gate — frame rotations as `_Fixed`
    blocks, every parity phase a `_Param` — so the walk differentiates
    the program `evolve_planes` runs. theta_e = 2 dt coeffs[idx_e]
    scale_e; autograd differentiates that map. Identity terms are a
    global phase (zero gradient) and are skipped."""
    from quest_tpu_torch import evolution as EV
    key = getattr(ansatz, "program_key", None)
    if not (isinstance(key, tuple) and key and key[0] == "trotter_ansatz"):
        raise AdjointError(
            "Invalid adjoint target: expected a Circuit or an "
            "evolution.trotter_ansatz callable (program_key contract)")
    _, codes_key, n, order, steps, imag_time = key
    if imag_time:
        raise AdjointError(
            "Invalid adjoint target: imaginary-time evolution is "
            "non-unitary — the backward walk cannot invert the decay")
    plan = EV._plan_trotter(codes_key)
    sched = EV.step_schedule(plan, order)
    entries = []
    idxs, scales = [], []

    def add_parity(i, scale):
        pidx = len(idxs)
        idxs.append(i)
        scales.append(scale)
        entries.append(_rot_param(pidx, "parity", tuple(plan.supports[i]),
                                  (), (), 1.0, 1.0))

    def band_fixed(bands, forward):
        fw, bw = (2, 3) if forward else (3, 2)

        def go(amps, _b=bands, _n=n):
            for band in _b:
                A.apply_band(amps, _n, band[fw], band[0], band[1], ())
            return amps

        def back(amps, _b=bands, _n=n):
            for band in reversed(_b):
                A.apply_band(amps, _n, band[bw], band[0], band[1], ())
            return amps
        return _Fixed(fwd=go, inv=back)

    for _ in range(int(steps)):
        for (kind, payload), scale in sched:
            if kind == "diag":
                for i in payload:
                    add_parity(i, scale)
            else:
                bands = EV._frame_band_ops(payload.axes, n)
                entries.append(band_fixed(bands, True))
                for i in payload.terms:
                    add_parity(i, scale)
                entries.append(band_fixed(bands, False))
    program = _Program(n=n, density=False, entries=tuple(entries),
                       num_params=len(idxs))
    return program, (np.asarray(idxs, np.int64),
                     np.asarray(scales, np.float64))


# ---------------------------------------------------------------------------
# primitives: the masked Im-overlap and the parametric appliers (ref :321-406)
# ---------------------------------------------------------------------------


def _control_tables(ranges, bits, states, rdt):
    """[(axis, 0/1 table)]: table[v] = 1 iff every listed bit inside the
    axis' chunk holds its state (the companion of expec._parity_tables)."""
    req = dict(zip(bits, states))
    out = []
    for ax, (lo, w) in enumerate(ranges):
        hit = [(b, req[b]) for b in range(lo, lo + w) if b in req]
        if not hit:
            continue
        idx = np.arange(1 << w)
        m = np.ones(1 << w, dtype=bool)
        for b, want in hit:
            m &= ((idx >> (b - lo)) & 1) == int(want)
        out.append((ax, m.astype(rdt)))
    return out


def _overlap_plane(lr, li, src_r, src_i, k):
    """The Im((-i)^ny t) integrand of t = sum conj(lam) psi_flip: ny even
    reads t_im, odd t_re; k in (1, 2) negates (applied to the sum)."""
    if k % 2 == 0:
        return lr * src_i - li * src_r
    return lr * src_r + li * src_i


def _im_overlap(lam: torch.Tensor, psi: torch.Tensor, n: int,
                e: _Param) -> torch.Tensor:
    """Im <lambda| G |psi> of entry `e`'s generator (flip form under the
    mask projector) as a 0-dim f64 tensor: one chunked sweep, chunk c of
    lambda against chunk c ^ (x >> C) of psi flipped by x's low bits, the
    low sign and control tables as one weight table, the bits above the
    chunk as a sign and a predicate per chunk. The caller multiplies w s."""
    C, nchunks = E._chunking(n)
    x_lo = tuple(q for q in e.x_bits if q < C)
    x_hi = sum(1 << (q - C) for q in e.x_bits if q >= C)
    dims, axis_of, ranges = E._group_view(C, x_lo)
    nd = len(dims)
    flip = [axis_of[q] for q in x_lo]
    zy_hi = sum(1 << (b - C) for b in e.zy_bits if b >= C)
    ctl = list(zip(e.mask_bits, e.mask_states))
    ctl_hi = [(b - C, s) for b, s in ctl if b >= C]
    tabs = (E._parity_tables(ranges, tuple(b for b in e.zy_bits if b < C),
                             np.float64)
            + _control_tables(ranges, tuple(b for b, _ in ctl if b < C),
                              tuple(s for b, s in ctl if b < C), np.float64))
    W = np.ones([1] * nd)
    for ax, tab in tabs:
        shape = [1] * nd
        shape[ax] = tab.size
        W = W * tab.reshape(shape)
    key = sorted({ax for ax, _ in tabs})
    other = [ax for ax in range(nd) if ax not in key]
    Wt = torch.as_tensor(W, dtype=torch.float64, device=lam.device)
    k = e.ny % 4
    lam_f, psi_f = lam.reshape(2, -1), psi.reshape(2, -1)
    total = torch.zeros((), dtype=torch.float64, device=lam.device)
    for c in range(nchunks):
        if any(((c >> b) & 1) != int(s) for b, s in ctl_hi):
            continue
        lr = E._chunk_view(lam_f[0], c, C, dims)
        li = E._chunk_view(lam_f[1], c, C, dims)
        pr = E._chunk_view(psi_f[0], c ^ x_hi, C, dims)
        pi = E._chunk_view(psi_f[1], c ^ x_hi, C, dims)
        if flip:
            pr, pi = pr.flip(flip), pi.flip(flip)
        plane = _overlap_plane(lr, li, pr, pi, k).to(torch.float64)
        marg = plane.sum(dim=other, keepdim=True) if other else plane
        v = (marg * Wt).sum()
        total = total - v if bin(c & zy_hi).count("1") & 1 else total + v
    return -total if k in (1, 2) else total


def _rotate_(amps: torch.Tensor, n: int, e: _Param,
             ang: float) -> torch.Tensor:
    """rx / ry of entry `e` at host angle `ang`, in place, as elementwise
    updates of the two halves of the target axis, chunk by chunk
    (ops/apply.target_chunks; controls narrow the views): ry(a) =
    [[c, -s], [s, c]] on each plane, rx(a) = [[c, -is], [-is, c]] mixing
    them, c = cos(a/2), s = sin(a/2). Two scalar multiply-adds an
    element instead of apply_matrix's permute copies and a 2 x 2
    product."""
    c, s = float(np.cos(ang / 2.0)), float(np.sin(ang / 2.0))
    for xr, xi, order in A.target_chunks(amps, n, (e.targets[0],),
                                         e.controls, e.cstates):
        ax = order[1]
        r0, r1 = xr.narrow(ax, 0, 1), xr.narrow(ax, 1, 1)
        i0, i1 = xi.narrow(ax, 0, 1), xi.narrow(ax, 1, 1)
        if e.family == "ry":
            for p0, p1 in ((r0, r1), (i0, i1)):
                t = p0.clone()
                p0.mul_(c).add_(p1, alpha=-s)
                p1.mul_(c).add_(t, alpha=s)
        else:
            tr, ti = r0.clone(), i0.clone()
            r0.mul_(c).add_(i1, alpha=s)
            i0.mul_(c).add_(r1, alpha=-s)
            r1.mul_(c).add_(ti, alpha=s)
            i1.mul_(c).add_(tr, alpha=-s)
    return amps


def _apply_param(amps: torch.Tensor, n: int, e: _Param,
                 ang: float) -> torch.Tensor:
    """Entry `e` at the (sign-folded) host angle `ang`, IN PLACE (the
    adjoint walk's applier)."""
    if e.family == "parity":
        return A.apply_parity_phase(amps, n, e.targets, ang)
    if e.family in ("rx", "ry"):
        return _rotate_(amps, n, e, ang)
    # projector families: e^{i ang} on the mask subspace
    q0, s0 = e.mask_bits[0], e.mask_states[0]
    p = np.exp(1j * ang)
    diag = np.array([1.0, p]) if s0 else np.array([p, 1.0])
    return A.apply_diagonal(amps, n, diag, (q0,), tuple(e.mask_bits[1:]),
                            tuple(e.mask_states[1:]))


def _apply_param_taped(amps: torch.Tensor, n: int, e: _Param,
                       ang: torch.Tensor) -> torch.Tensor:
    """Entry `e` at the angle tensor `ang`, out of place and
    differentiable (the taped engine's applier, the variational gates)."""
    if e.family == "parity":
        return V.apply_parity_phase(amps, n, e.targets, ang)
    if e.family == "rx":
        return V.rx(amps, n, e.targets[0], ang, e.controls, e.cstates)
    if e.family == "ry":
        return V.ry(amps, n, e.targets[0], ang, e.controls, e.cstates)
    return V.apply_phase_where(amps, n, e.mask_bits, e.mask_states,
                               torch.cos(ang), torch.sin(ang))


def _density_lambda(amps: torch.Tensor, cf: torch.Tensor, eplan):
    """The density bra seed: E = Re<lambda, a> is linear in the doubled
    register, so lambda is the gradient of the grouped trace, taken at
    zeros (one pass over the 2^N flipped diagonals)."""
    with torch.enable_grad():
        a0 = torch.zeros_like(amps, requires_grad=True)
        val = E.expec_traced(a0, cf, eplan)
        return torch.autograd.grad(val, a0)[0]


# ---------------------------------------------------------------------------
# single-device engines (ref :414-481)
# ---------------------------------------------------------------------------


class _FixedApply(torch.autograd.Function):
    """A constant run on a differentiable path: forward applies it to a
    copy, backward applies its inverse (its adjoint) to the cotangent."""

    @staticmethod
    def forward(ctx, amps, fixed):
        ctx.fixed = fixed
        with torch.no_grad():
            return fixed.fwd(amps.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        with torch.no_grad():
            return ctx.fixed.inv(grad.detach().clone()), None


def _initial(program: _Program, rdt, initial_index: int, device):
    from quest_tpu_torch.state import basis_planes
    return basis_planes(initial_index, n=program.n, rdt=rdt, device=device)


def _forward_taped(theta, program: _Program, rdt, initial_index, device):
    """The differentiable forward: out-of-place gates on the angles of
    `theta` (a tensor), constant runs through _FixedApply."""
    amps = _initial(program, rdt, initial_index, device)
    for e in program.entries:
        if isinstance(e, _Param):
            amps = _apply_param_taped(amps, program.n, e,
                                      e.s * theta[e.pidx])
        else:
            amps = _FixedApply.apply(amps, e)
    return amps


def _forward_inplace(theta_host: np.ndarray, program: _Program, rdt,
                     initial_index, device) -> torch.Tensor:
    """The adjoint forward: every entry in place on a fresh register."""
    amps = _initial(program, rdt, initial_index, device)
    for e in program.entries:
        if isinstance(e, _Param):
            _apply_param(amps, program.n, e,
                         e.s * float(theta_host[e.pidx]))
        else:
            e.fwd(amps)
    return amps


class _AdjointEnergy(torch.autograd.Function):
    """E(theta) whose backward is the three-register adjoint walk. The
    forward saves only the final psi and theta; the backward un-applies
    the gates on psi in place, so each forward serves one backward."""

    @staticmethod
    def forward(ctx, theta, spec):
        program, eplan, cf, rdt, initial_index = spec
        theta_host = theta.detach().cpu().double().numpy()
        with torch.no_grad():
            amps = _forward_inplace(theta_host, program, rdt, initial_index,
                                    theta.device)
            value = E.expec_traced(amps, cf, eplan).to(amps.dtype)
        ctx.spec = spec
        ctx.save_for_backward(theta, amps)
        return value

    @staticmethod
    def backward(ctx, ct):
        program, eplan, cf, _rdt, _ = ctx.spec
        theta, amps = ctx.saved_tensors
        theta_host = theta.detach().cpu().double().numpy()
        n = program.n
        with torch.no_grad():
            if program.density:
                lam = _density_lambda(amps, cf, eplan)
            else:
                lam = E.apply_pauli_sum_planes(amps, cf, eplan)
            grads = torch.zeros(program.num_params, dtype=torch.float64,
                                device=amps.device)
            for e in reversed(program.entries):
                if isinstance(e, _Param):
                    g = _im_overlap(lam, amps, n, e)
                    grads[e.pidx] += g * (e.w * e.s)
                    ia = -e.s * float(theta_host[e.pidx])
                    _apply_param(amps, n, e, ia)
                    _apply_param(lam, n, e, ia)
                else:
                    e.inv(amps)
                    e.inv(lam)
            del lam
        return grads.to(theta.dtype) * ct, None


def _build_adjoint(program, eplan, cf, rdt, initial_index):
    spec = (program, eplan, cf, rdt, initial_index)

    def energy(theta):
        return _AdjointEnergy.apply(theta, spec)
    return energy


# ---------------------------------------------------------------------------
# the sharded walk (ref :484-700)
# ---------------------------------------------------------------------------


def _sharded_initial(program: _Program, rdt, initial_index: int, mesh):
    from quest_tpu_torch.parallel.mesh import ShardedAmps
    local_n = program.n - mesh.global_qubits
    m = 1 << local_n
    tdt = precision.torch_dtype(rdt)
    shards = [torch.zeros((2, m), dtype=tdt, device=dev)
              for dev in mesh.devices]
    shards[initial_index >> local_n][0, initial_index & (m - 1)] = 1.0
    return ShardedAmps(shards, mesh, program.n)


def _walk_ops(amps, ops) -> None:
    from quest_tpu_torch.parallel import sharded as S
    xs = [s.view(1, 2, -1) for s in amps.shards]
    for op in ops:
        S._apply_gateop(xs, amps.mesh, amps.local_n, amps.n, False, op,
                        "highest")


def _apply_param_sharded(amps, e: _Param, ang: float) -> None:
    """Entry `e` at host angle `ang` on the shards, in place: parity
    phases and local-target rotations never communicate (the local
    rotation is `_rotate_` on each shard holding the global controls); a
    global rx/ry target is one butterfly pair exchange; a projector's
    global mask bits select the shards (ref _apply_param_sharded)."""
    from quest_tpu_torch.parallel import sharded as S
    local_n, mesh = amps.local_n, amps.mesh
    xs = [s.view(1, 2, -1) for s in amps.shards]
    if e.family == "parity":
        return S._parity_op(xs, mesh, local_n, e.targets, ang)
    if e.family in ("rx", "ry"):
        loc_c, loc_s, glob_c = S._split_controls(e.controls, e.cstates,
                                                 local_n)
        t = e.targets[0]
        if t >= local_n:
            c, sn = np.cos(ang / 2.0), np.sin(ang / 2.0)
            mat = (np.array([[c, -1j * sn], [-1j * sn, c]])
                   if e.family == "rx"
                   else np.array([[c, -sn], [sn, c]], dtype=np.complex128))
            return S._butterfly_1q(xs, mesh, local_n, mat, t - local_n,
                                   loc_c, loc_s, glob_c)
        el = dataclasses.replace(e, controls=loc_c, cstates=loc_s)
        for d, x in enumerate(xs):
            if S._holds(d, glob_c):
                _rotate_(x, local_n, el, ang)
        return None
    glob = [(b - local_n, st) for b, st in zip(e.mask_bits, e.mask_states)
            if b >= local_n]
    loc = [(b, st) for b, st in zip(e.mask_bits, e.mask_states)
           if b < local_n]
    p = np.exp(1j * ang)
    for d, x in enumerate(xs):
        if not S._holds(d, glob):
            continue
        if loc:
            q0, s0 = loc[0]
            diag = np.array([1.0, p]) if s0 else np.array([p, 1.0])
            A.apply_diagonal(x, local_n, diag, (q0,),
                             tuple(b for b, _ in loc[1:]),
                             tuple(st for _, st in loc[1:]))
        else:
            S._scale(x, local_n, complex(p))
    return None


def _im_overlap_sharded(lam, psi, e: _Param) -> List[torch.Tensor]:
    """Shard d's part of Im <lambda| G |psi> (f64 tensors): the partner
    shard d ^ (global x bits) read through one pair exchange of psi, the
    in-shard overlap on the local bits, the global zy parity a sign and
    the global mask bits a predicate."""
    from quest_tpu_torch.parallel import sharded as S
    local_n, mesh = psi.local_n, psi.mesh
    gxm = sum(1 << (q - local_n) for q in e.x_bits if q >= local_n)
    pv = psi.views()
    src = mesh.permute(pv, None, mask=gxm) if gxm else pv
    el = dataclasses.replace(
        e, x_bits=tuple(q for q in e.x_bits if q < local_n),
        zy_bits=tuple(b for b in e.zy_bits if b < local_n),
        mask_bits=tuple(b for b in e.mask_bits if b < local_n),
        mask_states=tuple(st for b, st in zip(e.mask_bits, e.mask_states)
                          if b < local_n))
    glob = [(b - local_n, st) for b, st in zip(e.mask_bits, e.mask_states)
            if b >= local_n]
    out = []
    for d, lv in enumerate(lam.views()):
        if src is None or not S._holds(d, glob):
            out.append(torch.zeros((), dtype=torch.float64,
                                   device=lv.device))
            continue
        v = _im_overlap(lv, src[d], local_n, el)
        par = 0
        for b in e.zy_bits:
            if b >= local_n:
                par ^= (d >> (b - local_n)) & 1
        out.append(-v if par else v)
    return out


def _sharded_forward(theta_host, program: _Program, rdt, initial_index,
                     mesh):
    amps = _sharded_initial(program, rdt, initial_index, mesh)
    for e in program.entries:
        if isinstance(e, _Param):
            _apply_param_sharded(amps, e, e.s * float(theta_host[e.pidx]))
        else:
            _walk_ops(amps, e.ops)
    return amps


class _ShardedAdjointEnergy(torch.autograd.Function):
    """E(theta) of a sharded walk; backward is the three-register adjoint
    walk over the shards, the per-parameter partials reduced once."""

    @staticmethod
    def forward(ctx, theta, spec):
        program, eplan, cf, rdt, initial_index, mesh = spec
        theta_host = theta.detach().cpu().double().numpy()
        with torch.no_grad():
            amps = _sharded_forward(theta_host, program, rdt, initial_index,
                                    mesh)
            value = E.expec_sharded(amps, cf, eplan)
        ctx.spec = spec
        ctx.amps = amps
        ctx.save_for_backward(theta)
        return value.to(device=theta.device, dtype=theta.dtype)

    @staticmethod
    def backward(ctx, ct):
        program, eplan, cf, _rdt, _, mesh = ctx.spec
        (theta,) = ctx.saved_tensors
        theta_host = theta.detach().cpu().double().numpy()
        amps = ctx.amps
        ctx.amps = None
        with torch.no_grad():
            lam = E.apply_pauli_sum_planes_sharded(amps, cf, eplan)
            parts = [torch.zeros(program.num_params, dtype=torch.float64,
                                 device=dev) for dev in mesh.devices]
            for e in reversed(program.entries):
                if isinstance(e, _Param):
                    for d, g in enumerate(_im_overlap_sharded(lam, amps, e)):
                        parts[d][e.pidx] += g * (e.w * e.s)
                    ia = -e.s * float(theta_host[e.pidx])
                    _apply_param_sharded(amps, e, ia)
                    _apply_param_sharded(lam, e, ia)
                else:
                    _walk_ops(amps, e.inv_ops)
                    _walk_ops(lam, e.inv_ops)
            del lam
            grads = mesh.reduce(parts)
        return grads.to(device=theta.device, dtype=theta.dtype) * ct, None


def _build_sharded(program, eplan, cf, rdt, initial_index, mesh):
    if program.density:
        raise AdjointError(
            "Invalid adjoint target: sharded density registers are not "
            "supported by the adjoint engine (statevector meshes only)")
    spec = (program, eplan, cf, rdt, initial_index, mesh)

    def energy(theta):
        return _ShardedAdjointEnergy.apply(theta, spec)
    return energy


def predict_vjp_collectives(program: _Program, eplan, D: int) -> dict:
    """The exchanges one value-and-grad call issues on D shards, priced on
    the host from the same dispatch the sharded walk makes (ref :703):
    constant runs through comm.gateop_exchanges, a global rx/ry the
    butterfly's comm.effective_slices, the energy and the lambda seed one
    pair exchange per distinct global flip mask each, the backward walk
    un-applying every entry on both registers and reading the partner
    shard once per global-flip overlap; two reductions (the energy and
    the stacked gradient)."""
    from quest_tpu_torch.parallel import comm as C
    gbits = D.bit_length() - 1
    local_n = program.n - gbits
    topo = C.topology(D)
    ici_b = topo.ici_bits(D) if topo.hierarchical else None
    m = 1 << local_n
    cps = a2as = 0

    def op_exchanges(ops):
        c = a = 0
        for op in ops:
            for kind, _elems, _g in C.gateop_exchanges(op, local_n, ici_b):
                if kind == "cp":
                    c += 1
                else:
                    a += 1
        return c, a

    def param_apply_cps(e):
        if e.family in ("rx", "ry") and e.targets[0] >= local_n:
            return C.effective_slices(m, C._link(e.targets[0] - local_n,
                                                 ici_b))
        return 0

    emasks = len(E.global_flip_masks(eplan, local_n))
    for e in program.entries:
        if isinstance(e, _Param):
            cps += param_apply_cps(e)
        else:
            c, a = op_exchanges(e.ops)
            cps += c
            a2as += a
    cps += 2 * emasks
    for e in program.entries:
        if isinstance(e, _Param):
            cps += 2 * param_apply_cps(e)
            if any(q >= local_n for q in e.x_bits):
                cps += 1
        else:
            c, a = op_exchanges(e.inv_ops)
            cps += 2 * c
            a2as += 2 * a
    return {"collective_permutes": cps, "all_to_alls": a2as,
            "all_reduces": 2 if program.num_params else 1,
            "devices": D}


def _build_taped(program, eplan, cf, rdt, initial_index):
    def energy(theta):
        amps = _forward_taped(theta, program, rdt, initial_index,
                              theta.device)
        return E.expec_traced(amps, cf, eplan).to(amps.dtype)
    return energy


# ---------------------------------------------------------------------------
# capacity + pricing (ref :778-886)
# ---------------------------------------------------------------------------


def capacity_stats(n: int, num_params: int, depth: int,
                   dtype=np.float32, device=None) -> dict:
    """The gradient engines' capacity model: the adjoint walk holds THREE
    registers (psi, lambda, the chunked overlap integrand counted as a
    register, ref :781) plus its sign tables; the taped engine one
    residual per parametric gate plus primal and cotangent. Bytes
    against the device memory env.hbm_bytes(device): QUEST_HBM_BYTES, or
    the card's total memory."""
    from quest_tpu_torch.env import hbm_bytes
    rdt = precision.real_dtype_of(np.dtype(dtype))
    state_bytes = 2 * (1 << n) * rdt.itemsize
    seg = 1 << E._SEG_BITS
    mask_bytes = 4 * seg * rdt.itemsize * max(1, -(-n // E._SEG_BITS))
    hbm = hbm_bytes(device)
    adjoint_peak = 3 * state_bytes + mask_bytes
    taped_peak = (num_params + 2) * state_bytes
    return {
        "state_bytes": int(state_bytes),
        "hbm_bytes": int(hbm),
        "adjoint_peak_bytes": int(adjoint_peak),
        "adjoint_fits": bool(adjoint_peak <= hbm),
        "taped_residual_bytes": int(taped_peak),
        "taped_fits": bool(taped_peak <= hbm),
        "params": int(num_params),
        "depth": int(depth),
    }


def _engine_choice(cap: dict, knob: str) -> str:
    """Incumbent-wins-ties: taped wherever its residuals fit, adjoint only
    where taped cannot run and adjoint can (ref :811)."""
    if knob == "0":
        return "taped"
    if knob == "1":
        return "adjoint"
    if cap["taped_fits"]:
        return "taped"
    if cap["adjoint_fits"]:
        return "adjoint"
    return "taped"


def grad_record(circuit, *, density: bool = False, dtype=np.float32,
                devices: Optional[int] = None, device=None) -> Optional[dict]:
    """The grad record of one circuit (ref :829): parameter count, both
    engines' capacity rows and the engine QUEST_ADJOINT (or, under auto,
    the capacity pricing against `device`'s memory) resolves to. None
    when the circuit has no parametric op; a circuit the adjoint walk
    cannot take reports {'supported': False, ...} with the taped
    engine."""
    from quest_tpu_torch.env import knob_value
    knob = str(knob_value("QUEST_ADJOINT"))
    N = circuit.num_qubits
    n = 2 * N if density else N
    depth = len(circuit.ops)
    try:
        program, _theta0 = build_circuit_program(circuit, density)
    except AdjointError as err:
        num_params = 0
        for op in circuit.ops:
            if op.kind in _REJECT_KINDS:
                continue
            try:
                if CC.as_rotation(op) is not None:
                    num_params += 1
            except Exception:
                pass
        if num_params == 0:
            return None
        cap = capacity_stats(n, num_params, depth, dtype, device)
        return {"supported": False, "reason": str(err), "engine": "taped",
                "incumbent": "taped", "knob": knob, "params": num_params,
                "depth": depth, "taped": {
                    "residual_bytes": cap["taped_residual_bytes"],
                    "fits": cap["taped_fits"]}}
    if program.num_params == 0:
        return None
    cap = capacity_stats(n, program.num_params, depth, dtype, device)
    if devices:
        shard = max(1, int(devices))
        for key in ("adjoint_peak_bytes", "taped_residual_bytes",
                    "state_bytes"):
            cap[key] = int(cap[key] // shard)
        cap["taped_fits"] = cap["taped_residual_bytes"] <= cap["hbm_bytes"]
        cap["adjoint_fits"] = cap["adjoint_peak_bytes"] <= cap["hbm_bytes"]
    engine = _engine_choice(cap, knob)
    return {
        "supported": True,
        "params": int(program.num_params),
        "depth": depth,
        "engine": engine,
        "incumbent": "taped",
        "knob": knob,
        "taped": {"residual_bytes": cap["taped_residual_bytes"],
                  "fits": cap["taped_fits"]},
        "adjoint": {"peak_bytes": cap["adjoint_peak_bytes"],
                    "fits": cap["adjoint_fits"]},
    }


# ---------------------------------------------------------------------------
# the public surface (ref :894-1070)
# ---------------------------------------------------------------------------


_FN_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_FN_CACHE_MAX = 32


def _resolve_observable(hamiltonian, coeffs, num_qubits):
    if isinstance(hamiltonian, E.PauliSum):
        if coeffs is not None:
            raise ValueError("pass coefficients inside the PauliSum, not "
                             "as a separate coeffs= argument")
        codes_key = E.parse_pauli_sum(np.asarray(hamiltonian.codes),
                                      num_qubits)
        cf = np.asarray(hamiltonian.coeffs, dtype=np.float64)
    else:
        codes_key = E.parse_pauli_sum(hamiltonian, num_qubits)
        cf = np.asarray(coeffs, dtype=np.float64).reshape(-1)
    if len(cf) != len(codes_key):
        from quest_tpu_torch import validation as val
        val.err("Invalid Pauli sum: must give exactly one coefficient "
                "per term.")
    return codes_key, cf


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(i) for i in x)
    return x


def _circuit_key(circuit):
    fps = []
    for i, op in enumerate(circuit.ops):
        fp = CC._op_fingerprint(op)
        if fp is None:
            raise AdjointError(
                f"Invalid adjoint target: op {i} ({op.kind}) carries a "
                f"non-concrete operand; adjoint differentiation needs "
                f"concrete gates")
        fps.append(_freeze(fp))
    return ("circuit", circuit.num_qubits, tuple(fps))


def value_and_grad(target, hamiltonian, *, coeffs=None,
                   initial_index: int = 0, dtype=np.float32,
                   density: bool = False, mesh=None,
                   engine: Optional[str] = None, device=None) -> Callable:
    """`fn(theta) -> (E, dE/dtheta)` (tensors on `device`, default the
    CUDA card) for `target` — a Circuit, or an evolution.trotter_ansatz
    taking params = (coeffs, dt), whose gradient is then the pair
    (dE/dcoeffs, dE/ddt) — against the Pauli sum `hamiltonian`. `engine`
    'adjoint' | 'taped' | 'auto' (default: the QUEST_ADJOINT knob; auto
    prices both against the device memory). Both engines differentiate
    the same parametrisation. Cached by value: equal specs (ops,
    observable, dtype, device, keyed knobs) return the identical fn,
    which carries `engine`, `num_params`, `initial_params` (a Circuit's
    recovered angles), `num_qubits`, `real_dtype`, `sweep_key` and
    `value(theta)` (the energy alone). `mesh` (a parallel.AmpMesh of two
    or more shards) runs the adjoint walk over the shards of a sharded
    register on the mesh's devices (the tensors come back on its first
    device), its predicted exchanges in `fn.comm_record`; the taped
    engine has no sharded form there and is refused typed."""
    from quest_tpu_torch.circuit import _device_key
    from quest_tpu_torch.env import engine_mode_key, knob_value

    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from quest_tpu_torch.parallel.mesh import refuse_process_mesh
        refuse_process_mesh(mesh, "value_and_grad(mesh=)")
        if engine == "taped":
            raise AdjointError(
                "Invalid adjoint target: the taped engine does not run on "
                "a mesh; value_and_grad(mesh=) takes the adjoint walk "
                "(engine='adjoint' or None)")
        device = mesh.devices[0]
    dev = resolve_device(device)
    is_circuit = isinstance(target, CC.Circuit)
    if is_circuit:
        nq = target.num_qubits
        tkey = _circuit_key(target)
    else:
        pk = getattr(target, "program_key", None)
        if not (isinstance(pk, tuple) and pk
                and pk[0] == "trotter_ansatz"):
            raise AdjointError(
                "Invalid adjoint target: expected a Circuit or an "
                "evolution.trotter_ansatz callable, got "
                f"{type(target).__name__!r}")
        nq = target.num_qubits
        tkey = pk
    codes_key, cf0 = _resolve_observable(hamiltonian, coeffs, nq)
    rdt = precision.real_dtype_of(np.dtype(dtype))
    if engine not in (None, "auto", "adjoint", "taped"):
        raise ValueError(f"engine must be 'adjoint', 'taped' or 'auto', "
                         f"got {engine!r}")
    key = (tkey, codes_key, cf0.tobytes(), int(initial_index), rdt.str,
           bool(density), _device_key(dev), engine, engine_mode_key(),
           mesh.key if sharded else None)
    with _CACHE_LOCK:
        fn = _FN_CACHE.get(key)
        if fn is not None:
            return fn

    if is_circuit:
        program, theta0 = build_circuit_program(target, density)
        angle_meta = None
    else:
        if sharded:
            raise AdjointError(
                "Invalid adjoint target: sharded trotter ansatz gradients "
                "are not supported (single-device registers only)")
        if density:
            raise AdjointError(
                "Invalid adjoint target: trotter ansatz gradients run on "
                "statevector registers only")
        program, angle_meta = build_trotter_program(target)
        theta0 = None

    eplan = E.plan_expec(codes_key, nq, density=density)
    # density layout: flat = row + col 2^N, so |i><i| sits at i (2^N + 1)
    init_flat = (int(initial_index) * ((1 << nq) + 1) if density
                 else int(initial_index))
    tdt = precision.torch_dtype(rdt)
    cf = torch.as_tensor(cf0, dtype=tdt, device=dev)

    resolved = "adjoint" if sharded else engine
    if resolved in (None, "auto"):
        knob = str(knob_value("QUEST_ADJOINT"))
        if knob in ("0", "1"):
            resolved = {"0": "taped", "1": "adjoint"}[knob]
        else:
            cap = capacity_stats(program.n, program.num_params,
                                 len(program.entries), rdt, dev)
            resolved = _engine_choice(cap, "auto")
    comm_record = None
    if sharded:
        energy = _build_sharded(program, eplan, cf, rdt, init_flat, mesh)
        comm_record = predict_vjp_collectives(program, eplan, mesh.size)
    else:
        build = _build_adjoint if resolved == "adjoint" else _build_taped
        energy = build(program, eplan, cf, rdt, init_flat)

    if is_circuit:
        def leaves(params):
            theta = torch.as_tensor(np.asarray(params, dtype=np.float64)
                                    if not torch.is_tensor(params)
                                    else params, device=dev)
            return (theta.detach().to(tdt).requires_grad_(True),)

        def energy_of(lv):
            return energy(lv[0])

        def shape_grad(grads):
            return grads[0]
    else:
        idx_arr, scale_arr = angle_meta
        idx_t = torch.as_tensor(idx_arr, device=dev)
        scale_t = torch.as_tensor(scale_arr, dtype=tdt, device=dev)

        def leaves(params):
            cfv, dt = params
            return tuple(
                torch.as_tensor(np.asarray(v, dtype=np.float64)
                                if not torch.is_tensor(v) else v,
                                device=dev).detach().to(tdt)
                .requires_grad_(True) for v in (cfv, dt))

        def energy_of(lv):
            cfv, dt = lv
            return energy(2.0 * dt * cfv[idx_t] * scale_t)

        def shape_grad(grads):
            return tuple(grads)

    def fn(params):
        lv = leaves(params)
        with torch.enable_grad():
            val = energy_of(lv)
            grads = torch.autograd.grad(val, lv)
        return val.detach(), shape_grad(grads)

    def value(params):
        with torch.no_grad():
            return energy_of(leaves(params)).detach()

    fn.value = value
    fn.num_qubits = nq
    fn.real_dtype = rdt.str
    fn.engine = resolved
    fn.num_params = program.num_params
    fn.initial_params = theta0
    fn.comm_record = comm_record
    fn.sweep_key = ("adjoint.value_and_grad",) + key
    with _CACHE_LOCK:
        _FN_CACHE[key] = fn
        while len(_FN_CACHE) > _FN_CACHE_MAX:
            _FN_CACHE.popitem(last=False)
    return fn
