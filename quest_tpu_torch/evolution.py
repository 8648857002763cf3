"""Trotterised real- and imaginary-time evolution.

A port of quest_tpu/evolution.py (ROADMAP A8). `trotter_circuit`
compiles a Pauli-sum Hamiltonian into a Circuit whose per-step layer is
emitted pooling first (ref :1-62):

  * every I/Z-only term exponentiates exactly to a parity phase; the
    whole diagonal block is one run, pre-composed by
    fusion.compose_diag_runs into ComposedDiag groups of at most
    DIAG_FUSE_MAX qubits, which the planner lowers to S7
    (multiphase_stage) and S8 (diagvec_stage) stages of the segment
    kernel;
  * off-diagonal terms fall into FRAMES, families whose X/Y support can
    share one basis rotation (U P U+ = Z per rotated qubit), so a frame
    pays its rotations (band stages S1-S3) once for every term in it and
    its rotated cores are again a pooled diagonal run;
  * order 2 (Strang) telescopes across steps.

`run_evolution` drives a quench end to end. Real time runs the step
circuit through `compiled_fused(iters=m)` — the K1 segment kernel on the
card — on a fresh buffer, chunk by chunk, with every observable measured
on the device-resident state after each chunk (only scalars reach the
host). Imaginary time runs the torch core (`evolve_planes`) with
renormalisation after every step. QUEST_TROTTER_FUSION=0 runs the legacy
per-term step through the eager workers (ops/gates.multi_rotate_pauli,
one flip-form pass a term). `trotter_ansatz` is the variational surface:
dt and the coefficient vector are tensors the torch core differentiates
through (variational.expectation, adjoint.value_and_grad).

`trotter_plan_stats` reports the Trotter record on the host: term,
frame and group counts and the steady-state `hbm_sweeps_per_step` (the
marginal (sweeps(2m) - sweeps(m)) / m of the fused sweep plan) under
the planner geometry it is given — the reference's TPU record under
band_plan.TPU_GEOMETRY, the port's own launches under HOPPER_GEOMETRY.

A sharded quench (`mesh=`, ref :899-941) runs the step circuit through
the sharded fused engine (compile_circuit_sharded_fused: K1 on every
shard) for an f32 register on a CUDA mesh, through the sharded banded
engine otherwise (engine= pins one); its energies come from the grouped
engine's sharded evaluators. A durable quench (`durable_dir=`) runs the
whole circuit through resilience.durable.run_durable, its Trotter
descriptor validated in the cursor. `TrotterCircuit.plan_stats` is Circuit.plan_stats with the "trotter"
record.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from quest_tpu_torch import calculations as K
from quest_tpu_torch import precision
from quest_tpu_torch import variational as V
from quest_tpu_torch.circuit import Circuit, GateOp
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import expec as E
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.profiling import annotate
from quest_tpu_torch.state import Qureg, clone

_SQ2 = 1.0 / np.sqrt(2.0)
# U P U+ = Z for P in {X, Y}: the multi_rotate_pauli basis convention
# (ref :85), applied U ... parity ... U+
_TO_Z = {
    1: np.array([[_SQ2, _SQ2], [-_SQ2, _SQ2]], dtype=np.complex128),
    2: np.array([[_SQ2, -1j * _SQ2], [-1j * _SQ2, _SQ2]],
                dtype=np.complex128),
}

_NOISE_KINDS = ("depolarising", "damping", "dephasing")


def fusion_enabled() -> bool:
    """QUEST_TROTTER_FUSION (keyed, default 1): pooled emission and the
    fused engine; 0 the legacy per-term emission and eager workers."""
    from quest_tpu_torch.env import knob_value
    return knob_value("QUEST_TROTTER_FUSION")


# ---------------------------------------------------------------------------
# the Trotter plan: diagonal block + basis-rotation frames (ref :109-213)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Frame:
    """One basis-rotation family: `axes` maps each rotated qubit to its
    X(1)/Y(2) axis; every term in `terms` is diagonal in that frame."""
    axes: Tuple[Tuple[int, int], ...]
    terms: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TrotterPlan:
    """Static evolution plan: the diagonal (I/Z-only) terms, one group
    per frame, and the all-identity terms (a global phase).
    `supports[i]` is term i's non-identity qubits."""
    n: int
    diag: Tuple[int, ...]
    identity: Tuple[int, ...]
    frames: Tuple[_Frame, ...]
    supports: Tuple[Tuple[int, ...], ...]

    @property
    def num_groups(self) -> int:
        return (1 if self.diag else 0) + len(self.frames)

    def group_seq(self) -> Tuple:
        """The Strang group sequence: the diagonal block first, then each
        frame."""
        seq: List = []
        if self.diag:
            seq.append(("diag", self.diag))
        for f in self.frames:
            seq.append(("frame", f))
        return tuple(seq)


@functools.lru_cache(maxsize=256)
def _plan_trotter(codes_key) -> TrotterPlan:
    with annotate("plan.trotter"):
        return _trotter_plan(codes_key)


def _trotter_plan(codes_key) -> TrotterPlan:
    n = len(codes_key[0]) if codes_key else 0
    diag: List[int] = []
    identity: List[int] = []
    supports: List[Tuple[int, ...]] = []
    offdiag = []
    for i, row in enumerate(codes_key):
        xy = tuple((q, p) for q, p in enumerate(row) if p in (1, 2))
        z = tuple(q for q, p in enumerate(row) if p == 3)
        supports.append(tuple(q for q, p in enumerate(row) if p))
        if not xy and not z:
            identity.append(i)
        elif not xy:
            diag.append(i)
        else:
            offdiag.append((i, xy, z))
    # greedy first-fit frames: a term joins a frame iff its X/Y axes
    # agree with the frame's on shared qubits, none of its X/Y qubits
    # carries another member's Z dressing, and none of its Z qubits is
    # rotated by the frame (ref :164-185)
    frames: List[List] = []      # [axes dict, z_blocked set, term list]
    for i, xy, z in offdiag:
        placed = False
        for fr in frames:
            axes, zb, terms = fr
            if any(axes.get(q, p) != p or q in zb for q, p in xy):
                continue
            if any(q in axes for q in z):
                continue
            axes.update(xy)
            zb.update(z)
            terms.append(i)
            placed = True
            break
        if not placed:
            frames.append([dict(xy), set(z), [i]])
    return TrotterPlan(
        n=n, diag=tuple(diag), identity=tuple(identity),
        frames=tuple(_Frame(tuple(sorted(a.items())), tuple(t))
                     for a, _, t in frames),
        supports=tuple(supports))


def as_pauli_sum(hamiltonian, coeffs=None, num_qubits: int = None
                 ) -> E.PauliSum:
    """A PauliSum, a (codes, coeffs) pair, or a codes array with
    `coeffs=`, as one validated PauliSum."""
    if isinstance(hamiltonian, E.PauliSum):
        if coeffs is not None:
            raise ValueError("pass coefficients inside the PauliSum, "
                             "not as a separate coeffs= argument")
        return hamiltonian
    if coeffs is None and isinstance(hamiltonian, tuple) \
            and len(hamiltonian) == 2:
        hamiltonian, coeffs = hamiltonian
    codes = np.asarray(hamiltonian)
    if num_qubits is None:
        if codes.ndim != 2:
            raise ValueError(
                "pass num_qubits= (or a 2-D codes array) so the term "
                "width is unambiguous")
        num_qubits = int(codes.shape[1])
    return E.PauliSum.of(codes, coeffs, num_qubits)


# ---------------------------------------------------------------------------
# circuit emission (ref :221-395)
# ---------------------------------------------------------------------------


class TrotterCircuit(Circuit):
    """A Circuit compiled from a Hamiltonian by `trotter_circuit`,
    carrying its Trotter descriptor in `trotter`. Treat it as immutable:
    equal calls return the same instance, whose program cache they
    share."""

    trotter: dict

    def plan_stats(self, density: bool = False, batch: int = None,
                   devices: int = None) -> dict:
        """Circuit.plan_stats plus the "trotter" record of THIS circuit's
        emission (ref :233); a noisy circuit is planned on the density
        register, where it runs."""
        density = density or self.trotter["noise"] is not None
        rec = super().plan_stats(density=density, batch=batch,
                                 devices=devices)
        rec["trotter"] = trotter_plan_stats(
            self.trotter["spec"], self.trotter["dt"],
            order=self.trotter["order"], steps=self.trotter["steps"],
            density=density, pooled=self.trotter["pooled"],
            noise=self.trotter["noise"])
        return rec


def _zy_angle(coef: float, tau: float, scale: float) -> float:
    # exp(-i tau c P) == exp(-i angle/2 P) at angle = 2 tau c
    return 2.0 * float(coef) * float(tau) * float(scale)


def _emit_group(c: Circuit, plan: TrotterPlan, spec: E.PauliSum,
                group, tau: float, scale: float, pooled: bool) -> None:
    kind, payload = group
    if kind == "diag":
        ops = [GateOp("parity", plan.supports[i], (), (),
                      _zy_angle(spec.coeffs[i], tau, scale))
               for i in payload]
        if pooled:
            ops = F.compose_diag_runs(ops)
        c.ops.extend(ops)
        return
    frame: _Frame = payload
    for q, ax in frame.axes:
        c.gate(_TO_Z[ax], (q,))
    ops = [GateOp("parity", plan.supports[i], (), (),
                  _zy_angle(spec.coeffs[i], tau, scale))
           for i in frame.terms]
    if pooled:
        ops = F.compose_diag_runs(ops)
    c.ops.extend(ops)
    for q, ax in frame.axes:
        c.gate(np.asarray(_TO_Z[ax]).conj().T, (q,))


def _emit_identity_phase(c: Circuit, theta: float) -> None:
    """The all-identity terms' global phase exp(-i theta) as a uniform
    one-qubit diagonal (its density dual conjugates it away)."""
    if abs(theta) < 1e-300 or c.num_qubits == 0:
        return
    p = np.exp(-1j * theta)
    c._add("diagonal", (0,), np.array([p, p], dtype=np.complex128))


def _emit_noise(c: Circuit, noise) -> None:
    kind, prob = noise
    for q in range(c.num_qubits):
        getattr(c, kind)(q, prob)


def _emit_trotter(c: Circuit, plan: TrotterPlan, spec: E.PauliSum,
                  dt: float, order: int, steps: int, noise,
                  pooled: bool) -> None:
    seq = plan.group_seq()
    m = len(seq)
    telescope = pooled and noise is None and order == 2 and m > 1
    for s in range(steps):
        if m:
            if order == 1 or m == 1:
                for g in seq:
                    _emit_group(c, plan, spec, g, dt, 1.0, pooled)
            elif telescope:
                # Strang with the leading half-group merged into the
                # previous step's trailing one
                if s == 0:
                    _emit_group(c, plan, spec, seq[0], dt, 0.5, pooled)
                for g in seq[1:-1]:
                    _emit_group(c, plan, spec, g, dt, 0.5, pooled)
                _emit_group(c, plan, spec, seq[-1], dt, 1.0, pooled)
                for g in reversed(seq[1:-1]):
                    _emit_group(c, plan, spec, g, dt, 0.5, pooled)
                _emit_group(c, plan, spec, seq[0], dt,
                            0.5 if s == steps - 1 else 1.0, pooled)
            else:
                _emit_group(c, plan, spec, seq[0], dt, 0.5, pooled)
                for g in seq[1:-1]:
                    _emit_group(c, plan, spec, g, dt, 0.5, pooled)
                _emit_group(c, plan, spec, seq[-1], dt, 1.0, pooled)
                for g in reversed(seq[1:-1]):
                    _emit_group(c, plan, spec, g, dt, 0.5, pooled)
                _emit_group(c, plan, spec, seq[0], dt, 0.5, pooled)
        if noise is not None:
            _emit_noise(c, noise)
    if plan.identity and pooled:
        # the legacy per-term emission drops the global phase, like the
        # reference's all-identity multiRotatePauli no-op
        theta = float(dt) * float(steps) * sum(
            float(spec.coeffs[i]) for i in plan.identity)
        _emit_identity_phase(c, theta)
    c._compiled.clear()


@functools.lru_cache(maxsize=64)
def _trotter_circuit_cached(spec: E.PauliSum, dt: float, order: int,
                            steps: int, noise, pooled: bool
                            ) -> TrotterCircuit:
    plan = _plan_trotter(spec.codes)
    with annotate("plan.trotter"):
        c = TrotterCircuit(spec.num_qubits)
        c.trotter = {"spec": spec, "dt": dt, "order": order, "steps": steps,
                     "noise": noise, "pooled": pooled, "plan": plan}
        _emit_trotter(c, plan, spec, dt, order, steps, noise, pooled)
    return c


def trotter_circuit(hamiltonian, dt, *, coeffs=None, num_qubits=None,
                    order: int = 2, steps: int = 1,
                    noise=None) -> TrotterCircuit:
    """exp(-i dt H)^steps as a Circuit through the order-1 (Lie) or
    order-2 (Strang) product formula over the plan's commuting groups;
    pooled under QUEST_TROTTER_FUSION=1 (default), the per-term stream
    under 0. `noise=(kind, prob)`, kind in {depolarising, damping,
    dephasing}, appends the channel on every qubit after every step (the
    trajectory path: `run_evolution_trajectories`). Memoised by value:
    equal arguments return the SAME TrotterCircuit."""
    spec = as_pauli_sum(hamiltonian, coeffs, num_qubits)
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order!r}")
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if noise is not None:
        kind, prob = noise
        if kind not in _NOISE_KINDS:
            raise ValueError(
                f"noise kind must be one of {_NOISE_KINDS}, got {kind!r}")
        noise = (kind, float(prob))
    return _trotter_circuit_cached(spec, float(dt), order, steps, noise,
                                   fusion_enabled())


# ---------------------------------------------------------------------------
# plan introspection (ref :403-497)
# ---------------------------------------------------------------------------


def _fused_sweeps(circ: Circuit, n: int, density: bool,
                  budgets: BP.Budgets = BP.HOPPER_GEOMETRY) -> int:
    """Passes one application of `circ` costs on the engine that runs it:
    kernel launches plus passthroughs of the fused sweep plan under
    `budgets` at the kernel's widths, banded passes below them."""
    flat = circ._planned_flat(n, density)
    if BP.usable(n):
        items = F.plan(flat, n, bands=BP.plan_bands(n))
        return len(BP.maybe_sweep(BP.segment_plan(items, n, budgets=budgets),
                                  n, budgets=budgets))
    return F.plan_stats(F.plan(flat, n))["full_state_passes"]


def _per_term_passes(plan: TrotterPlan, order: int) -> int:
    """The legacy model: one flip-form pass per term application."""
    applied = len(plan.diag) + sum(len(f.terms) for f in plan.frames)
    if order == 1:
        return applied
    seq = plan.group_seq()
    if len(seq) <= 1:
        return applied
    total = 0
    for gi, g in enumerate(seq):
        cnt = (len(g[1]) if g[0] == "diag" else len(g[1].terms))
        total += cnt if gi == len(seq) - 1 else 2 * cnt
    return total


def _diag_group_count(plan: TrotterPlan) -> int:
    """Composed-diagonal groups one pooled step emits."""
    count = 0
    for kind, payload in plan.group_seq():
        idx = payload if kind == "diag" else payload.terms
        ops = [GateOp("parity", plan.supports[i], (), (), 0.0)
               for i in idx]
        count += len(F.compose_diag_runs(ops))
    return count


def trotter_plan_stats(hamiltonian, dt, *, coeffs=None, num_qubits=None,
                       order: int = 2, steps: int = 1,
                       density: bool = False, pooled: bool = None,
                       noise=None,
                       budgets: BP.Budgets = BP.HOPPER_GEOMETRY) -> dict:
    """The "trotter" plan record on the host (ref :447): term, group and
    frame counts, the pooled emission's steady-state
    `hbm_sweeps_per_step` — the marginal (sweeps(2m) - sweeps(m)) / m of
    the fused sweep plan under `budgets` (TPU_GEOMETRY: the reference's
    record; HOPPER_GEOMETRY, the default: the port's launches and
    passthroughs) — and the per-term model `baseline_hbm_sweeps_per_step`.
    Under QUEST_TROTTER_FUSION=0 (or pooled=False) the per-step figure is
    the baseline, which the legacy dispatch runs. A noisy step is planned
    on the density register."""
    spec = as_pauli_sum(hamiltonian, coeffs, num_qubits)
    plan = _plan_trotter(spec.codes)
    fused = fusion_enabled() if pooled is None else bool(pooled)
    baseline = _per_term_passes(plan, order)
    plan_density = density or noise is not None
    n = 2 * spec.num_qubits if plan_density else spec.num_qubits
    if fused:
        m = 4
        c1 = _trotter_circuit_cached(spec, float(dt), order, m, noise,
                                     True)
        c2 = _trotter_circuit_cached(spec, float(dt), order, 2 * m,
                                     noise, True)
        sweeps_per_step = (_fused_sweeps(c2, n, plan_density, budgets)
                           - _fused_sweeps(c1, n, plan_density, budgets)) / m
    else:
        sweeps_per_step = float(baseline)
    return {
        "steps": int(steps),
        "order": int(order),
        "terms": len(spec.codes),
        "diag_terms": len(plan.diag),
        "identity_terms": len(plan.identity),
        "frames": len(plan.frames),
        "diag_groups": _diag_group_count(plan),
        "fusion": bool(fused),
        "noise": noise,
        "hbm_sweeps_per_step": sweeps_per_step,
        "baseline_hbm_sweeps_per_step": baseline,
    }


# ---------------------------------------------------------------------------
# the torch core: runtime coefficients and dt (ref :505-674)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _frame_band_ops(axes: Tuple[Tuple[int, int], ...], n: int):
    """Per-band composed rotation operators of one frame and their
    inverses, as numpy (re, im) pairs: (ql, w, fwd, inv) per band."""
    by_band: Dict[int, np.ndarray] = {}
    for q, ax in axes:
        b = F._band_of(q)
        ql, w = F.band_range(n, b)
        emb = F.embed_operator(_TO_Z[ax], [q - ql], [], [], w)
        cur = by_band.get(b)
        by_band[b] = emb if cur is None else emb @ cur
    out = []
    for b in sorted(by_band):
        ql, w = F.band_range(n, b)
        op = by_band[b]
        inv = op.conj().T
        out.append((ql, w, (op.real.copy(), op.imag.copy()),
                    (inv.real.copy(), inv.imag.copy())))
    return tuple(out)


def _band(amps: torch.Tensor, n: int, pair, ql: int, w: int) -> torch.Tensor:
    """New planes: the (2^w, 2^w) operator `pair` ((re, im) numpy) on
    qubits [ql, ql + w) (the out-of-place, differentiable apply_band)."""
    precision.ieee_fp32()
    gre = torch.as_tensor(pair[0], dtype=amps.dtype, device=amps.device)
    gim = torch.as_tensor(pair[1], dtype=amps.dtype, device=amps.device)
    x = amps.reshape(2, 1 << (n - ql - w), 1 << w, 1 << ql)
    re, im = x[0], x[1]
    nre = gre @ re - gim @ im
    nim = gre @ im + gim @ re
    return torch.stack([nre, nim]).reshape(amps.shape)


def _parity_decay(amps: torch.Tensor, n: int, targets, w) -> torch.Tensor:
    """Imaginary-time diagonal factor exp(-w s(j)), s the parity sign of
    `targets` (the non-unitary counterpart of a parity phase)."""
    targets = tuple(int(t) for t in targets)
    x, dims, axis_of = V._view(amps, n, targets)
    sign = A.parity_sign(len(dims), axis_of, targets, amps.dtype,
                         amps.device)
    f = torch.exp(-w * sign)
    return (x * f.unsqueeze(0)).reshape(amps.shape)


def _global_phase(amps: torch.Tensor, theta) -> torch.Tensor:
    """exp(-i theta) on the whole register (the identity terms)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([amps[0] * c + amps[1] * s,
                        amps[1] * c - amps[0] * s])


def _apply_group_traced(amps, n, cf, tau, plan: TrotterPlan, group,
                        scale: float, imag: bool):
    kind, payload = group
    if kind == "diag":
        for i in payload:
            w = cf[i] * tau * scale
            if imag:
                amps = _parity_decay(amps, n, plan.supports[i], w)
            else:
                amps = V.apply_parity_phase(amps, n, plan.supports[i],
                                            2.0 * w)
        return amps
    frame: _Frame = payload
    bands = _frame_band_ops(frame.axes, n)
    for ql, w_, fwd, _inv in bands:
        amps = _band(amps, n, fwd, ql, w_)
    for i in frame.terms:
        w = cf[i] * tau * scale
        if imag:
            amps = _parity_decay(amps, n, plan.supports[i], w)
        else:
            amps = V.apply_parity_phase(amps, n, plan.supports[i], 2.0 * w)
    for ql, w_, _fwd, inv in bands:
        amps = _band(amps, n, inv, ql, w_)
    return amps


def step_schedule(plan: TrotterPlan, order: int):
    """The per-step (group, scale) schedule: order 1 applies each group
    once, order 2 the symmetric Strang arrangement with halved ends. The
    one home of the splitting: the torch core and the adjoint engine
    (adjoint.py) replay it."""
    seq = plan.group_seq()
    if order == 1 or len(seq) <= 1:
        return tuple((g, 1.0) for g in seq)
    return tuple([(seq[0], 0.5)] + [(g, 0.5) for g in seq[1:-1]]
                 + [(seq[-1], 1.0)]
                 + [(g, 0.5) for g in reversed(seq[1:-1])]
                 + [(seq[0], 0.5)])


def _norm(amps: torch.Tensor) -> torch.Tensor:
    """sqrt(sum of squares) in f64, chunk by chunk (no full f64 copy)."""
    flat = amps.reshape(-1)
    step = 1 << E.CHUNK_BITS
    total = None
    for s in range(0, flat.numel(), step):
        part = flat[s:s + step].to(torch.float64)
        v = (part * part).sum()
        total = v if total is None else total + v
    return torch.sqrt(total)


def _step_traced(amps, n, cf, tau, plan: TrotterPlan, order: int,
                 imag: bool, renorm: bool):
    for g, scale in step_schedule(plan, order):
        amps = _apply_group_traced(amps, n, cf, tau, plan, g, scale, imag)
    if plan.identity:
        tot = sum(cf[i] for i in plan.identity) * tau
        if imag:
            amps = amps * torch.exp(-tot)
        else:
            amps = _global_phase(amps, tot)
    if renorm:
        norm = _norm(amps)
        amps = amps / torch.clamp(norm, min=1e-300).to(amps.dtype)
    return amps


def _operand(x, amps: torch.Tensor) -> torch.Tensor:
    """A runtime operand (tensor, array or number) in the planes' dtype
    on their device; a tensor keeps its graph."""
    if torch.is_tensor(x):
        return x.to(dtype=amps.dtype, device=amps.device)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           dtype=amps.dtype, device=amps.device)


def evolve_planes(amps: torch.Tensor, n: int, coeffs, dt, plan: TrotterPlan,
                  *, steps: int = 1, order: int = 2,
                  imag_time: bool = False, renorm: bool = None):
    """`steps` Trotter steps of (2, 2^n) statevector planes, out of place,
    with the coefficient vector and dt as runtime operands:
    differentiable in both (and in the planes) through torch.autograd.
    `renorm` defaults to `imag_time`."""
    cf = _operand(coeffs, amps)
    tau = _operand(dt, amps)
    renorm = imag_time if renorm is None else renorm
    for _ in range(int(steps)):
        amps = _step_traced(amps, n, cf, tau, plan, order, imag_time,
                            renorm)
    return amps


def trotter_ansatz(hamiltonian, *, num_qubits: int = None,
                   order: int = 2, steps: int = 1,
                   imag_time: bool = False) -> Callable:
    """`ansatz(amps, params)` over the evolved state for
    variational.expectation, params = (coeffs, dt). `hamiltonian` gives
    the term structure only. The callable carries `program_key`, the
    value identity the gradient engine (adjoint.py) and the sweep keys
    read."""
    if isinstance(hamiltonian, E.PauliSum):
        codes_key = hamiltonian.codes
        n = hamiltonian.num_qubits
    else:
        codes = np.asarray(hamiltonian)
        n = int(codes.shape[1]) if num_qubits is None else int(num_qubits)
        codes_key = E.parse_pauli_sum(codes, n)
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order!r}")
    plan = _plan_trotter(codes_key)

    def ansatz(amps, params):
        coeffs, dt = params
        return evolve_planes(amps, n, coeffs, dt, plan, steps=steps,
                             order=order, imag_time=imag_time)

    ansatz.program_key = ("trotter_ansatz", codes_key, n, order,
                          int(steps), bool(imag_time))
    ansatz.num_qubits = n
    return ansatz


def _chunk_traced(amps, coeffs, dt, *, n, plan, order, chunk, imag,
                  renorm):
    """`chunk` steps of the torch core (the reference's fori_loop)."""
    for _ in range(chunk):
        amps = _step_traced(amps, n, coeffs, dt, plan, order, imag, renorm)
    return amps


# ---------------------------------------------------------------------------
# run_evolution: the workload driver (ref :682-998)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvolutionResult:
    """The final register, the energy track — `energies[k, j]` is
    observable j at step `energy_steps[k]` (row 0 the initial state) —
    and the run's stats record."""
    state: Qureg
    energies: np.ndarray
    energy_steps: np.ndarray
    stats: dict


def _observable_plans(observables, spec, nq: int):
    specs = []
    for obs in observables:
        o = as_pauli_sum(obs, num_qubits=nq)
        if o.num_qubits != nq:
            raise ValueError(
                f"observable is over {o.num_qubits} qubits but the "
                f"evolution register has {nq}")
        specs.append(o)
    return specs


def _measure_energies(q: Qureg, amps, specs) -> List[float]:
    """The observables on the device-resident planes (calculations
    dispatches to the grouped engine): only scalars reach the host."""
    qq = q.replace_amps(amps)
    return [K.calc_expec_pauli_sum(qq, np.asarray(o.codes),
                                   np.asarray(o.coeffs)) for o in specs]


def _legacy_step(q: Qureg, plan: TrotterPlan, spec: E.PauliSum,
                 dt: float, order: int) -> Qureg:
    """One legacy per-term step through the eager workers, in place on
    `q`: one flip-form pass per term application."""
    from quest_tpu_torch.ops import gates as G

    def apply_terms(q, idx, scale):
        for i in idx:
            row = spec.codes[i]
            targets = plan.supports[i]
            paulis = tuple(row[t] for t in targets)
            q = G.multi_rotate_pauli(
                q, targets, paulis, _zy_angle(spec.coeffs[i], dt, scale))
        return q

    seq = plan.group_seq()
    groups = [(g[1] if g[0] == "diag" else g[1].terms) for g in seq]
    if order == 1 or len(groups) <= 1:
        for idx in groups:
            q = apply_terms(q, idx, 1.0)
        return q
    for idx in groups[:-1]:
        q = apply_terms(q, idx, 0.5)
    q = apply_terms(q, groups[-1], 1.0)
    for idx in reversed(groups[:-1]):
        q = apply_terms(q, idx, 0.5)
    return q


def run_evolution(hamiltonian, dt, steps: int, *, state: Qureg,
                  coeffs=None, order: int = 2, observables=None,
                  energy_every: int = None, imag_time: bool = False,
                  engine: str = None, mesh=None, durable_dir: str = None,
                  durable_every: int = None) -> EvolutionResult:
    """A `steps`-step Trotter quench of `state` under `hamiltonian`, on
    the register's device; `state` itself is left as it was.

      * real time (default): the step circuit through the fused engine
        (`compiled_fused(iters=m)`, the K1 segment kernel) in chunks of
        `energy_every` steps, each observable (PauliSum specs; default
        [hamiltonian]) measured after each chunk on the device. engine
        None takes the fused engine for an f32 register of at least the
        kernel's 10 qubits on a CUDA device and the banded engine
        otherwise; 'fused' / 'banded' pin one.
      * imaginary time (`imag_time=True`): exp(-dt H) steps of the torch
        core, renormalised after every step (statevectors, no engine=).
      * QUEST_TROTTER_FUSION=0: the legacy per-term eager baseline.
      * `mesh` (a parallel.AmpMesh): the chunks run over its shards —
        engine None takes the sharded fused engine (K1 on every shard)
        for an f32 register on a CUDA mesh and the sharded banded engine
        otherwise; the returned state is a sharded register.
      * `durable_dir`: the whole quench through
        resilience.durable.run_durable (checkpoints every
        `durable_every` steps of its plan; a rerun resumes), observables
        on the initial and final states only (ref :800-832)."""
    spec = as_pauli_sum(hamiltonian, coeffs, num_qubits=None)
    if state.num_qubits != spec.num_qubits:
        raise ValueError(
            f"Hamiltonian is over {spec.num_qubits} qubits but the "
            f"register has {state.num_qubits}")
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order!r}")
    plan = _plan_trotter(spec.codes)
    nq = spec.num_qubits
    n = state.num_state_qubits
    density = state.is_density
    fused = fusion_enabled()
    if observables is None:
        observables = [spec]
    specs = _observable_plans(observables, spec, nq)

    if durable_dir is not None:
        if energy_every is not None:
            raise ValueError(
                "durable_dir= is incompatible with energy_every=: the "
                "durable executor owns the step loop and the planes are "
                "the resume payload; observables evaluate on the final "
                "state")
        if imag_time:
            raise ValueError(
                "durable imaginary-time evolution is not supported: the "
                "renormalizing step is not a Circuit the durable executor "
                "can cut")
        from quest_tpu_torch.resilience.durable import run_durable
        circ = trotter_circuit(spec, dt, order=order, steps=steps)
        initial = _measure_energies(state, state.amps, specs)
        out = run_durable(
            circ, state, durable_dir, every=durable_every, engine=engine,
            mesh=mesh,
            cursor_extra={
                "workload": "trotter",
                "trotter_steps": steps,
                "trotter_order": order,
                "trotter_dt": repr(float(dt)),
                "trotter_terms": len(spec.codes),
            })
        energies = np.asarray([initial,
                               _measure_energies(out, out.amps, specs)])
        return EvolutionResult(
            state=out, energies=energies,
            energy_steps=np.asarray([0, steps]),
            stats={"engine": "durable", "steps": steps, "order": order})

    chunk = steps if energy_every is None else int(energy_every)
    if chunk < 1:
        raise ValueError(f"energy_every must be >= 1, got {chunk}")
    record: List[List[float]] = [_measure_energies(state, state.amps,
                                                   specs)]
    rec_steps = [0]
    dispatches = 0

    if imag_time:
        if mesh is not None or density:
            raise ValueError(
                "imaginary-time evolution runs on single-mesh statevector "
                "registers")
        if engine is not None:
            raise ValueError(
                "imaginary-time evolution has no engine= choice: the "
                "renormalising step runs the torch core")
        amps = state.amps.reshape(2, -1)
        cf = _operand(spec.coeffs, amps)
        tau = _operand(float(dt), amps)
        done = 0
        with torch.no_grad():
            while done < steps:
                m = min(chunk, steps - done)
                amps = _chunk_traced(amps, cf, tau, n=n, plan=plan,
                                     order=order, chunk=m, imag=True,
                                     renorm=True)
                dispatches += 1
                done += m
                record.append(_measure_energies(state, amps, specs))
                rec_steps.append(done)
        q = state.replace_amps(amps.reshape(state.amps.shape))
        return EvolutionResult(
            state=q, energies=np.asarray(record),
            energy_steps=np.asarray(rec_steps),
            stats={"engine": "traced-imag", "steps": steps,
                   "order": order, "dispatches": dispatches})

    if not fused:
        if mesh is not None or engine is not None:
            raise ValueError(
                "QUEST_TROTTER_FUSION=0 runs the legacy per-term EAGER "
                "baseline on a single device: mesh= and engine= have no "
                "legacy counterpart; unset the knob for sharded or "
                "engine-pinned evolution")
        q = clone(state)
        done = 0
        while done < steps:
            m = min(chunk, steps - done)
            for _ in range(m):
                q = _legacy_step(q, plan, spec, float(dt), order)
            done += m
            dispatches += m
            record.append(_measure_energies(q, q.amps, specs))
            rec_steps.append(done)
        return EvolutionResult(
            state=q, energies=np.asarray(record),
            energy_steps=np.asarray(rec_steps),
            stats={"engine": "legacy-per-term", "steps": steps,
                   "order": order, "dispatches": dispatches})

    circ = trotter_circuit(spec, dt, order=order, steps=1)
    if engine not in (None, "fused", "banded"):
        raise ValueError(
            f"engine must be None, 'fused' or 'banded', got {engine!r}")
    dev = state.amps.device
    if mesh is not None:
        local_n = n - mesh.global_qubits
        kernel_ok = (BP.usable(local_n) and state.amps.dtype == torch.float32
                     and all(d.type == "cuda" for d in mesh.devices))
    else:
        kernel_ok = (BP.usable(n) and state.amps.dtype == torch.float32
                     and dev.type == "cuda")
    if engine is None and not kernel_ok:
        # the segment kernel needs a kernel-tier f32 register on a CUDA
        # device (ref :899-909, where the device is a TPU)
        engine = "banded"

    def compiled_for(m: int):
        if mesh is not None:
            inner = (circ.compiled_sharded_banded(n, density, mesh)
                     if engine == "banded"
                     else circ.compiled_sharded_fused(n, density, mesh))

            def run(a, inner=inner, m=m):
                for _ in range(m):
                    a = inner(a)
                return a
            run.launches_per_call = (
                m * getattr(inner, "launches_per_call", 0))
            return run
        if engine == "banded":
            return circ.compiled_banded(n, density, iters=m, device=dev)
        return circ.compiled_fused(n, density, iters=m, device=dev)

    if mesh is not None:
        from quest_tpu_torch.parallel.mesh import ShardedAmps, shard_planes
        amps = (state.amps.clone() if isinstance(state.amps, ShardedAmps)
                else shard_planes(state.amps, mesh, n))
    else:
        amps = state.amps.clone()     # the programs run in place
    fns: Dict[int, Callable] = {}
    launches = 0
    done = 0
    while done < steps:
        m = min(chunk, steps - done)
        fn = fns.get(m)
        if fn is None:
            fn = fns[m] = compiled_for(m)
        with annotate("evolution.chunk",
                      device=dev if mesh is None else None):
            amps = fn(amps)
        launches += getattr(fn, "launches_per_call", 0)
        dispatches += 1
        done += m
        record.append(_measure_energies(state, amps, specs))
        rec_steps.append(done)
    q = state.replace_amps(amps)
    name = engine or "fused"
    return EvolutionResult(
        state=q, energies=np.asarray(record),
        energy_steps=np.asarray(rec_steps),
        stats={"engine": f"sharded-{name}" if mesh is not None else name,
               "steps": steps, "order": order,
               "dispatches": dispatches, "launches": launches})


def run_evolution_trajectories(hamiltonian, dt, steps: int, shots: int,
                               *, noise, generator: torch.Generator = None,
                               coeffs=None, order: int = 2, observable=None,
                               engine: str = None, chunk: int = None,
                               durable_dir: str = None,
                               durable_every: int = None, device=None):
    """Noisy Trotter evolution through the trajectory engine: the
    per-step-noise circuit (`trotter_circuit(noise=)`) unravelled into
    `shots` trajectories by `trajectories.run_batched` (default
    generator: a CPU generator seeded 0). Returns (planes, draws) like
    run_batched; `observable=` (a PauliSum or (codes, coeffs)) reduces
    each chunk's states on the device (expec.batched_reducer).
    `durable_dir` runs the shots through
    resilience.durable.run_durable_trajectories (checkpointed chunks, a
    rerun resumes bit-identical)."""
    from quest_tpu_torch import trajectories as T
    spec = as_pauli_sum(hamiltonian, coeffs, num_qubits=None)
    circ = trotter_circuit(spec, dt, order=order, steps=steps, noise=noise)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if observable is not None and not callable(observable):
        observable = E.resolve_observable(observable, spec.num_qubits)
    if durable_dir is not None:
        if observable is not None:
            raise ValueError(
                "durable_dir= is incompatible with observable=: the planes "
                "are the resume payload")
        from quest_tpu_torch.resilience.durable import \
            run_durable_trajectories
        return run_durable_trajectories(
            circ, generator, shots, durable_dir, every=durable_every,
            chunk=chunk, engine=engine, device=device)
    return T.run_batched(circ, shots, generator=generator, chunk=chunk,
                         observable=observable, engine=engine,
                         device=device)
