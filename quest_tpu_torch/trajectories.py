"""Quantum-trajectory noise simulation: batched stochastic Kraus unraveling.

A port of the batched engine of quest_tpu/trajectories.py:210-926. Each
trajectory is a statevector (2^n amplitudes) in which every noise
channel applies one Kraus branch, drawn per shot; averaging |psi><psi|
over shots converges to the channel's density matrix at the cost of a
statevector, where a density register would need 2n state qubits.

`run_batched` plans a noisy Circuit once and rides a whole chunk of
shots through the segment kernel (ops/segment.py): every swept segment
is ONE launch over all states of the chunk, so launches per chunk equal
the unbatched plan's, whatever the chunk's size. Each 1-qubit channel is a
BatchSelStage inside a segment: each state applies its own drawn,
renormalised branch, read from a selection table (slots, B, 8) that the
program writes on the device between launches.

  * Mixture channels (every K_k proportional to a unitary: depolarising,
    dephasing, Pauli) have state-independent branch probabilities: all
    their draws and operators for a chunk are computed in one batched
    step before the first launch, and their stages fuse anywhere in a
    sweep.
  * General Kraus channels (damping) need the pre-channel state: the
    Born probabilities p_k = tr(K_k^+ K_k rho) come from the target's
    reduced density on the whole chunk, the renormalisation 1/sqrt(p_k)
    is folded into the selected operator, and the stage leads its sweep
    (a launch barrier before it).
  * Multi-qubit channels apply between launches through
    ops/apply.apply_matrix_planes, one batched contraction of each
    state's drawn operator: plain tensor code (the reference applies
    them in XLA).

engine='banded' (and the default below the kernel's 10 qubits, as the
reference's _resolve_engine has it) is the reference's banded program
(trajectories.py:682-760): the stretches of fusion-plan items between
channels run through the banded primitives (circuit._apply_item) over
the whole batch, and every channel, one-qubit ones too, is drawn from
the pre-channel states and applied as one batched contraction of each
state's drawn operator.

The eager per-shot workers (ref :42-162) are here too: `kraus`,
`unitary_mixture`, `damping`, `dephasing`, `depolarising` and `pauli`
apply one channel to one trajectory's planes in place, each drawing its
branch from a torch.Generator; each `*_given` core takes the uniform
instead.

Randomness is explicit: `run_batched` takes a torch.Generator and draws
one (shots, C) array of uniforms from it, shot-major, before chunking,
so chunking never changes a shot's trajectory. Branch k is
drawn by inverse CDF of the branch probabilities at the shot's uniform
for that channel; a branch of probability 0 is never drawn. (The
reference draws with jax.random.categorical on threefry keys: the same
seed gives other branches. A trajectory program here is a function of
its uniforms, so the two are compared given the draws.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from quest_tpu_torch import precision
from quest_tpu_torch import validation as val
from quest_tpu_torch.circuit import XlaPass, _device_key, flatten_ops
from quest_tpu_torch.env import knob_value, resolve_device
from quest_tpu_torch.ops import apply as A
from quest_tpu_torch.ops import band_plan as BP
from quest_tpu_torch.ops import fusion as F
from quest_tpu_torch.ops import matrices as M
from quest_tpu_torch.ops.segment import (SEL_WORDS, Segment, prepare_segment,
                                         segment_sweep,
                                         segment_sweep_reference)

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class _XlaChannel:
    """Plan marker for a channel the kernel does not inline (a
    multi-qubit Kraus map): applied per state between launches;
    segment_plan passes it through as an ("xla", item) part, which is
    also a sweep barrier."""
    index: int

    def qubits(self):
        return ()


def _mixture_probs(kraus_ops):
    """(p_k,) when every K_k is proportional to a unitary (K^+K = p I:
    the Born probabilities do not depend on the state), else None."""
    probs = []
    for K in kraus_ops:
        d = K.shape[0]
        KK = K.conj().T @ K
        p = float(np.real(np.trace(KK)) / d)
        if not np.allclose(KK, p * np.eye(d), atol=1e-10):
            return None
        probs.append(p)
    return np.asarray(probs, dtype=np.float64)


def _traj_channels_and_items(circuit, n: int, use_kernels: bool = True):
    """Split a noisy Circuit into the batched engine's plan stream:
    fusion-plan items for the unitary stretches, interleaved with
    ChannelItem (1-qubit channels, inlined as BatchSelStages, when
    `use_kernels`) and _XlaChannel markers (every channel of the banded
    program). Returns (items, channels); channels[i] holds channel i's
    targets, Kraus operators and mixture probabilities."""
    bands = BP.plan_bands(n) if use_kernels else None
    items: list = []
    channels: list = []
    stretch: list = []

    def close():
        nonlocal stretch
        if stretch:
            flat = F.maybe_schedule(flatten_ops(tuple(stretch), n, False), n)
            items.extend(F.plan(flat, n, bands=bands))
            stretch = []

    for op in circuit.ops:
        if op.kind == "superop":
            meta = op.meta
            if not (isinstance(meta, tuple) and meta and meta[0] == "kraus"):
                raise val.QuESTError(
                    "Invalid operation: this channel op carries no raw "
                    "Kraus metadata; build channels through the Circuit "
                    "noise builders (kraus/damping/depolarising/"
                    "dephasing) for trajectory unraveling.")
            kraus_ops = [np.asarray(K, dtype=np.complex128) for K in meta[1]]
            val._validate_kraus_once(kraus_ops, len(op.targets))
            probs = _mixture_probs(kraus_ops)
            idx = len(channels)
            inline = use_kernels and len(op.targets) == 1
            channels.append({
                "index": idx,
                "targets": tuple(op.targets),
                "ops": kraus_ops,
                "mixture_probs": probs,
                "inline": inline,
            })
            close()
            if inline:
                items.append(BP.ChannelItem(op.targets[0], idx,
                                            barrier=probs is None))
            else:
                items.append(_XlaChannel(idx))
            continue
        if op.kind in ("measure", "classical"):
            raise val.QuESTError(
                "Invalid operation: run_batched does not thread "
                "mid-circuit measurement outcomes; use "
                "compiled_measured per shot for dynamic circuits.")
        stretch.append(op)
    close()
    return items, channels


def _reduced_density(planes: torch.Tensor, n: int, targets):
    """(rho_re, rho_im), each (B, 2^k, 2^k) f64: the reduced density of
    `targets` for a (B, 2, ...) batch of f32 planes (bit j of the index
    is targets[j]). Sums run in f64: at 24 qubits an f32 dot product of
    2^23 terms is off by ~1e-4 relative, which the 1/sqrt(p_k)
    renormalisation turns into a norm error of the same size. One
    target: transpose-free, products of strided real views summed over
    the whole batch (no complex or full-state temporary). Several: one
    batched f64 contraction per chunk of ops/apply.target_chunks, so the
    temporaries stay at a chunk's size whatever the batch."""
    b = planes.shape[0]
    x = planes.reshape(b, 2, -1)
    if len(targets) == 1:
        q = targets[0]
        r = x[:, 0].reshape(b, -1, 2, 1 << q)
        i = x[:, 1].reshape(b, -1, 2, 1 << q)
        r0, r1, i0, i1 = r[:, :, 0], r[:, :, 1], i[:, :, 0], i[:, :, 1]

        def dot(u, v):
            return (u * v).sum(dim=(1, 2), dtype=torch.float64)
        d00 = dot(r0, r0) + dot(i0, i0)
        d11 = dot(r1, r1) + dot(i1, i1)
        re01 = dot(r0, r1) + dot(i0, i1)
        im01 = dot(i0, r1) - dot(r0, i1)
        zero = torch.zeros_like(d00)
        rho_re = torch.stack([torch.stack([d00, re01], -1),
                              torch.stack([re01, d11], -1)], -2)
        rho_im = torch.stack([torch.stack([zero, im01], -1),
                              torch.stack([-im01, zero], -1)], -2)
        return rho_re, rho_im
    d = 1 << len(targets)
    rho_re = torch.zeros((b, d, d), dtype=torch.float64, device=planes.device)
    rho_im = torch.zeros_like(rho_re)
    for xr, xi, order in A.target_chunks(x, n, targets):
        pr = xr.permute(order).reshape(b, d, -1).double()
        pi = xi.permute(order).reshape(b, d, -1).double()
        rho_re += pr @ pr.mT + pi @ pi.mT
        rho_im += pi @ pr.mT - pr @ pi.mT
    return rho_re, rho_im


def _draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Branch index by inverse CDF: the k whose interval
    [cum_{k-1}, cum_k) of the (unnormalised) branch probabilities `probs`
    (..., m) holds u * total, for uniforms u in [0, 1) broadcast against
    probs' leading axes. Non-positive probabilities are never drawn."""
    p = probs.double().clamp_min(0.0)
    cum = p.cumsum(-1)
    t = u * cum[..., -1]
    k = (cum <= t.unsqueeze(-1)).sum(-1)
    idx = torch.arange(p.shape[-1], device=p.device)
    last = torch.where(p > 0, idx, 0).amax(-1)
    return torch.minimum(k, last)


def _pack_rows(op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) re/im operators -> (..., 8) selection rows [g00re,
    g00im, g01re, g01im, g10re, g10im, g11re, g11im]."""
    return torch.stack([op_re, op_im], -1).reshape(
        op_re.shape[:-2] + (SEL_WORDS,))


class _Channel:
    """A channel's operators on the device: Kraus stacks (m, d, d), and
    K^+K (for Born probabilities) or the mixture probabilities."""

    def __init__(self, ch: dict, dev: torch.device):
        self.index = ch["index"]
        self.targets = ch["targets"]
        ops = np.stack(ch["ops"])
        self.kre = torch.tensor(ops.real, dtype=torch.float32, device=dev)
        self.kim = torch.tensor(ops.imag, dtype=torch.float32, device=dev)
        mkm = np.einsum("mji,mjk->mik", ops.conj(), ops)
        self.mre = torch.tensor(mkm.real, dtype=torch.float64, device=dev)
        self.mim = torch.tensor(mkm.imag, dtype=torch.float64, device=dev)
        probs = ch["mixture_probs"]
        self.probs = (None if probs is None else
                      torch.as_tensor(probs, dtype=torch.float64, device=dev))

    def born_probs(self, planes: torch.Tensor, n: int) -> torch.Tensor:
        """(B, m) f64 branch probabilities tr(K_k^+ K_k rho) of each state
        of a (B, 2, ...) batch, from its reduced density."""
        rho_re, rho_im = _reduced_density(planes, n, self.targets)
        return (torch.einsum("mij,bji->bm", self.mre, rho_re)
                - torch.einsum("mij,bji->bm", self.mim, rho_im))

    def select(self, planes: torch.Tensor, n: int, u: torch.Tensor):
        """Draw each state's branch at uniforms u (B,) and build the
        renormalised operators: (draw (B,) int64, op_re, op_im (B, d, d)
        f32). Reads `planes` only for a state-dependent channel."""
        if self.probs is not None:
            draw = _draw(self.probs, u)
            psel = self.probs[draw]
        else:
            ps = self.born_probs(planes, n)
            draw = _draw(ps, u)
            psel = ps.gather(1, draw[:, None])[:, 0]
        inv = torch.rsqrt(psel.clamp_min(_TINY)).to(torch.float32)[:, None, None]
        return draw, self.kre[draw] * inv, self.kim[draw] * inv


class TrajectoryProgram:
    """A compiled batched-trajectory program: B trajectories of a noisy
    circuit from |0...0>, one kernel launch per swept segment over all B
    of them, for any B (nothing planned depends on it); or, with
    `engine` 'banded', the banded program over all B. Call it with
    uniforms (B, C) (one per shot per channel, in [0, 1)); returns
    (planes (B, 2, 2^n) f32, draws (B, C) int32), both on the program's
    device. `plain(uniforms)` runs the same program through the plain
    PyTorch version (the banded program is plain tensor code). `tier` is the matmul tier of its matrix stages and
    multi-qubit channels, the session's when the program is compiled;
    Born reductions are f64 sums at every tier. `driver` and `nbuf` are
    the segment driver and in-place slots (the knobs' when the program is
    compiled, unless given); every launch runs under them."""

    def __init__(self, circuit, n: int, device, tier: str = None,
                 driver: str = None, nbuf: int = None,
                 engine: str = "fused"):
        dev = resolve_device(device)
        tier = precision.check_tier(tier or precision.matmul_precision())
        driver = BP.check_driver(driver)
        nbuf = knob_value("QUEST_FUSED_NBUF") if nbuf is None else nbuf
        precision.ieee_fp32()
        self.engine = engine
        use_kernels = engine == "fused" and BP.usable(n)
        items, channels = _traj_channels_and_items(circuit, n, use_kernels)
        if use_kernels:
            parts = BP.maybe_sweep(BP.segment_plan(items, n), n,
                                   driver=driver)
        else:
            parts = [("xla", it) for it in items]
        self.n, self.device, self.tier = n, dev, tier
        self.driver, self.nbuf = driver, nbuf
        self.channels = [_Channel(ch, dev) for ch in channels]
        self.channel_info = channels
        self.steps: List = []
        for part in parts:
            if part[0] == "segment":
                # a barrier (state-dependent) stage reads the state at its
                # launch boundary: the planner puts it first in its sweep
                for j, st in enumerate(part[1]):
                    if isinstance(st, BP.BatchSelStage) and st.barrier and j:
                        raise AssertionError(f"barrier stage not first: "
                                             f"{part[1]}")
                self.steps.append(prepare_segment(part[1], part[2], n, dev,
                                                  tier=tier, driver=driver,
                                                  nbuf=nbuf))
            elif isinstance(part[1], _XlaChannel):
                self.steps.append(part[1])
            else:
                self.steps.append(XlaPass(part[1], n, tier))
        self.segments = [s for s in self.steps if isinstance(s, Segment)]
        # 1-qubit mixture channels: selected for the whole chunk at once
        mix = [c for c, info in zip(self.channels, channels)
               if info["inline"] and c.probs is not None]
        self._mix_idx = torch.tensor([c.index for c in mix], dtype=torch.long,
                                     device=dev)
        if mix:
            m = max(c.kre.shape[0] for c in mix)

            def padded(get, width):
                out = torch.zeros((len(mix), m) + width, dtype=get(mix[0]).dtype,
                                  device=dev)
                for j, c in enumerate(mix):
                    out[j, :get(c).shape[0]] = get(c)
                return out
            self._mix_probs = padded(lambda c: c.probs, ())
            self._mix_kre = padded(lambda c: c.kre, (2, 2))
            self._mix_kim = padded(lambda c: c.kim, (2, 2))

    @property
    def num_channels(self) -> int:
        return len(self.channels)

    @property
    def launches_per_call(self) -> int:
        return len(self.segments)

    def __call__(self, uniforms: torch.Tensor):
        return self._run(uniforms, plain=False)

    def plain(self, uniforms: torch.Tensor):
        return self._run(uniforms, plain=True)

    def _select_mixtures(self, u, draws, sel):
        """Draws and selection rows of every 1-qubit mixture channel for
        the chunk, in one batched step (ref host prelude :542-556)."""
        idx = self._mix_idx
        if not idx.numel():
            return
        k = _draw(self._mix_probs, u[:, idx])                  # (B, Cm)
        cm = torch.arange(idx.numel(), device=k.device)
        psel = self._mix_probs[cm, k]
        inv = torch.rsqrt(psel.clamp_min(_TINY)).to(torch.float32)[..., None, None]
        rows = _pack_rows(self._mix_kre[cm, k] * inv,
                          self._mix_kim[cm, k] * inv)          # (B, Cm, 8)
        draws[:, idx] = k.to(torch.int32)
        sel[idx] = rows.transpose(0, 1)

    def _run(self, uniforms: torch.Tensor, plain: bool):
        n, dev = self.n, self.device
        c = self.num_channels
        u = uniforms.to(device=dev, dtype=torch.float64)
        if u.dim() != 2 or u.shape[0] < 1 or u.shape[1] != c:
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, program "
                             f"takes (B, {c})")
        b = u.shape[0]
        planes = torch.zeros((b, 2, 1 << n), dtype=torch.float32, device=dev)
        planes[:, 0, 0] = 1.0
        if self.segments:
            planes = planes.view(b, 2, -1, BP.LANES)
        draws = torch.zeros((b, c), dtype=torch.int32, device=dev)
        sel = torch.zeros((max(c, 1), b, SEL_WORDS), dtype=torch.float32,
                          device=dev)
        self._select_mixtures(u, draws, sel)
        for step in self.steps:
            if isinstance(step, Segment):
                first = step.stages[0]
                if isinstance(first, BP.BatchSelStage) and first.barrier:
                    ch = self.channels[first.index]
                    draw, op_re, op_im = ch.select(planes, n, u[:, ch.index])
                    draws[:, ch.index] = draw.to(torch.int32)
                    sel[ch.index] = _pack_rows(op_re, op_im)
                if plain:
                    planes = segment_sweep_reference(planes, step.stages,
                                                     step.operands, n, sel,
                                                     step.tier)
                else:
                    segment_sweep(planes, step, sel)
            elif isinstance(step, _XlaChannel):
                ch = self.channels[step.index]
                draw, op_re, op_im = ch.select(planes, n, u[:, ch.index])
                draws[:, ch.index] = draw.to(torch.int32)
                A.apply_matrix_planes(planes, n, op_re, op_im, ch.targets,
                                      tier=self.tier)
            else:
                step(planes)
        return planes.reshape(b, 2, -1), draws


class HostTrajectoryProgram:
    """The `host` trajectory engine (ref trajectories.py:484,
    _compiled_traj_host): B trajectories of a noisy circuit from
    |0...0> on the host, one state at a time. Each unitary stretch
    between channels is one native blocked program (host.py); each
    channel draws every state's branch from the (B, C) uniforms through
    the same rule, operators and f64 Born probabilities as the banded
    program (_Channel.select), so equal uniforms give equal draws, and
    applies each state's renormalised operator as a one-gate native
    program. A run of consecutive 1-qubit mixture channels (state-
    independent probabilities) applies as one native program a state.
    Call it with uniforms (B, C); returns (planes (B, 2, 2^n) f32,
    draws (B, C) int32), CPU tensors. Raises host.HostEngineUnsupported
    when the native library is missing."""

    engine = "host"
    launches_per_call = 0

    def __init__(self, circuit, n: int):
        from quest_tpu_torch import host as H
        self.n, self.device = n, torch.device("cpu")
        _, channels = _traj_channels_and_items(circuit, n, False)
        self.channel_info = channels
        self.channels = [_Channel(ch, self.device) for ch in channels]
        # ("run", step) | ("chans", [index, ...]): a "chans" element
        # holds one general channel or a run of 1-qubit mixtures
        self.program: list = []
        stretch: list = []
        idx = 0
        for op in circuit.ops:
            if op.kind != "superop":
                stretch.append(op)
                continue
            if stretch:
                self.program.append(("run", H.compile_circuit_host(
                    tuple(stretch), n, False)))
                stretch = []
            mixture = (channels[idx]["mixture_probs"] is not None
                       and len(channels[idx]["targets"]) == 1)
            prev = self.program[-1] if self.program else None
            if (mixture and prev is not None and prev[0] == "chans"
                    and self._mixture(prev[1][-1])):
                prev[1].append(idx)
            else:
                self.program.append(("chans", [idx]))
            idx += 1
        if stretch:
            self.program.append(("run", H.compile_circuit_host(
                tuple(stretch), n, False)))

    def _mixture(self, idx: int) -> bool:
        ch = self.channel_info[idx]
        return ch["mixture_probs"] is not None and len(ch["targets"]) == 1

    @property
    def num_channels(self) -> int:
        return len(self.channels)

    def __call__(self, uniforms: torch.Tensor):
        from quest_tpu_torch import host as H
        from quest_tpu_torch.circuit import GateOp
        n, c = self.n, self.num_channels
        u = uniforms.to(device="cpu", dtype=torch.float64)
        if u.dim() != 2 or u.shape[0] < 1 or u.shape[1] != c:
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, program "
                             f"takes (B, {c})")
        b = u.shape[0]
        planes = torch.zeros((b, 2, 1 << n), dtype=torch.float32)
        planes[:, 0, 0] = 1.0
        draws = torch.zeros((b, c), dtype=torch.int32)
        for kind, el in self.program:
            if kind == "run":
                for s in range(b):
                    el(planes[s])
                continue
            ops = []
            for idx in el:
                ch = self.channels[idx]
                draw, op_re, op_im = ch.select(planes, n, u[:, idx])
                draws[:, idx] = draw.to(torch.int32)
                ops.append((ch.targets, torch.complex(
                    op_re.double(), op_im.double()).numpy()))
            for s in range(b):
                H.compile_circuit_host(
                    tuple(GateOp("matrix", t, operand=k[s]) for t, k in ops),
                    n, False)(planes[s])
        return planes, draws


def _compiled_traj(circuit, n: int, device, engine: str = "fused"):
    """The trajectory program of `circuit` on `device` through `engine`
    ('fused', 'banded' or 'host'), cached on the circuit like every
    program (Circuit._cached: keyed on n, engine, the device and
    _engine_mode_key(), the matmul tier and segment driver among it): a
    program keeps the tier and driver it was compiled with, and a flip
    compiles anew. The host engine runs on the CPU whatever `device`."""
    if engine == "host":
        return circuit._cached(("traj-batched", n, "cpu", engine),
                               lambda: HostTrajectoryProgram(circuit, n))
    dev = resolve_device(device)

    def build():
        tier = precision.matmul_precision()
        driver, nbuf = BP.active_driver(), knob_value("QUEST_FUSED_NBUF")
        return TrajectoryProgram(circuit, n, dev, tier, driver, nbuf, engine)
    return circuit._cached(("traj-batched", n, _device_key(dev), engine),
                           build)


def _resolve_engine(engine, n: int) -> str:
    """The engine a run takes (ref trajectories.py:374): the one named,
    else 'fused' from the kernel's 10 qubits and 'banded' below."""
    if engine is None:
        return "fused" if BP.usable(n) else "banded"
    if engine not in ("fused", "banded", "host"):
        raise ValueError(f"engine must be 'fused', 'banded' or 'host', "
                         f"got {engine!r}")
    return engine


def program_key(circuit, engine: str = None):
    """(resolved engine, program identity) of the trajectory program
    run_batched would run for `circuit` (ref trajectories.py:807): the
    serving engine's rule for trajectory requests, two of which share
    launches iff their identities are equal. It holds the circuit object
    (compared by identity), its op count, the register size, the resolved
    engine and _engine_mode_key(); no shot count (the program takes any
    batch)."""
    from quest_tpu_torch.circuit import _engine_mode_key
    n = circuit.num_qubits
    engine = _resolve_engine(engine, n)
    return engine, ("traj-batched", circuit, len(circuit.ops), n, engine,
                    _engine_mode_key())


def run_batched(circuit, shots: int, *, generator: torch.Generator,
                chunk: int = None, observable: Optional[Callable] = None,
                engine: str = None, device=None):
    """Run `shots` stochastic trajectories of a noisy Circuit (channels
    from the Circuit noise builders) from |0...0> through the batched
    engine on `device` (default: the CUDA card). Returns (planes (shots,
    2, 2^n) f32, draws (shots, C) int32): the final planes, and the
    branch every channel took in every shot (C channels in program
    order).

    `generator` (a torch.Generator) supplies one (shots, C) array of
    uniforms, drawn once per run, shot-major: the same generator state
    gives the same trajectories whatever `chunk` is. At most `chunk`
    states (all `shots` when None) are resident at once; sequential
    chunks reuse one program, the last one at its own size. `observable`
    maps a (b, 2, 2^n) chunk of final planes to per-shot values (leading
    axis kept); the return is then (values (shots, ...), draws) and no
    chunk's planes outlive its reduction. engine: None (the fused engine
    from 10 qubits, the banded program below), 'fused', 'banded' or
    'host' (the native host engine on the CPU, one state at a time,
    HostTrajectoryProgram: `device` must then be None or the CPU, and
    the results are CPU tensors). Equal generator states give every
    engine the same uniforms, and the branches drawn from them follow
    one rule."""
    n = circuit.num_qubits
    engine = _resolve_engine(engine, n)
    if (engine == "host" and device is not None
            and torch.device(device).type != "cpu"):
        raise ValueError(f"engine='host' runs on the CPU, got device="
                         f"{device!r}")
    shots = int(shots)
    if shots < 1:
        raise ValueError(f"shots must be >= 1, got {shots}")
    per_call = shots if chunk is None else max(1, min(int(chunk), shots))
    prog = _compiled_traj(circuit, n, device, engine)
    uniforms = torch.rand((shots, prog.num_channels), generator=generator,
                          dtype=torch.float64,
                          device=generator.device).to(prog.device)
    fn = prog
    if observable is not None:
        def fn(ub):
            planes, draws = prog(ub)
            return observable(planes), draws
    outs, draws_out = [], []
    for lo in range(0, shots, per_call):
        out, draws = fn(uniforms[lo:lo + per_call])
        outs.append(out)
        draws_out.append(draws)
    if len(outs) == 1:
        return outs[0], draws_out[0]
    return torch.cat(outs), torch.cat(draws_out)


def plan_stats(circuit, shots: int, *,
               budgets: BP.Budgets = BP.HOPPER_GEOMETRY) -> dict:
    """Batched-trajectory plan statistics (ref trajectories.py:900),
    computed on the host, for all `shots` in one launch per swept
    segment: launches and passthroughs per application (`hbm_sweeps`,
    the same for every shot count) and the channel mix."""
    n = circuit.num_qubits
    items, channels = _traj_channels_and_items(circuit, n)
    parts = BP.maybe_sweep(
        BP.segment_plan(items, n, batch=shots, budgets=budgets), n,
        budgets=budgets)
    rec = BP.batched_stats(parts, shots)
    rec["channels"] = len(channels)
    rec["inline_channels"] = sum(1 for ch in channels if ch["inline"])
    rec["mixture_channels"] = sum(
        1 for ch in channels if ch["mixture_probs"] is not None)
    return rec


def average_density(planes: torch.Tensor) -> torch.Tensor:
    """Dense (2^n, 2^n) complex128 estimator: the mean over the shot axis
    of |psi><psi| for (shots, 2, 2^n) planes. For checks at small n;
    large runs average observables instead."""
    x = planes.reshape(planes.shape[0], 2, -1).double()
    psi = torch.complex(x[:, 0], x[:, 1])
    return psi.T @ psi.conj() / psi.shape[0]


# ---------------------------------------------------------------------------
# the eager per-shot workers (ref :42-162)
# ---------------------------------------------------------------------------
# One channel applied to ONE trajectory's (2, 2^n) planes, in place, its
# branch drawn from a torch.Generator (one uniform in [0, 1), f64, on the
# generator's device). Each worker has a `*_given` core that takes that
# uniform instead and draws nothing, so a test can feed it the branch the
# reference drew. Branch k is the inverse-CDF pick of the uniform over the
# branch probabilities (_draw); a branch of probability 0 is never drawn.


def _targets_tuple(targets):
    return (targets,) if np.isscalar(targets) else tuple(int(t) for t in targets)


def _uniform(generator: torch.Generator) -> float:
    return float(torch.rand((), generator=generator, dtype=torch.float64,
                            device=generator.device))


def kraus_given(amps: torch.Tensor, u: float, n: int, targets,
                ops) -> Tuple[torch.Tensor, int]:
    """One stochastic application of the Kraus map {K_k} to `targets` at
    the uniform `u`: branch k drawn with Born probability ||K_k psi||^2
    (summed in f64), the planes set to K_k psi / sqrt(p_k) in place.
    Returns (amps, k)."""
    targets = _targets_tuple(targets)
    ops = [np.asarray(K, dtype=np.complex128) for K in ops]
    val._validate_kraus_once(ops, len(targets))
    tier = precision.matmul_precision()
    ws = [A.apply_matrix(amps.clone(), n, K, targets, tier=tier) for K in ops]
    ps = torch.stack([w.double().square().sum() for w in ws])
    k = int(_draw(ps, torch.tensor(float(u), dtype=torch.float64,
                                   device=ps.device)))
    amps.copy_(ws[k] / torch.sqrt(ps[k]).to(amps.dtype))
    return amps, k


def kraus(amps: torch.Tensor, generator: torch.Generator, n: int, targets,
          ops) -> Tuple[torch.Tensor, int]:
    """kraus_given at one uniform drawn from `generator`."""
    return kraus_given(amps, _uniform(generator), n, targets, ops)


def unitary_mixture_given(amps: torch.Tensor, u: float, n: int, targets,
                          probs, unitaries) -> Tuple[torch.Tensor, int]:
    """A unitary mixture sum_k p_k U_k . U_k^+ at the uniform `u`: the
    probabilities do not depend on the state, so the branch is drawn
    first and only U_k is applied, in place. Returns (amps, k)."""
    targets = _targets_tuple(targets)
    probs = torch.as_tensor(np.asarray(probs, dtype=np.float64))
    k = int(_draw(probs, torch.tensor(float(u), dtype=torch.float64)))
    A.apply_matrix(amps, n, np.asarray(unitaries[k], dtype=np.complex128),
                   targets, tier=precision.matmul_precision())
    return amps, k


def unitary_mixture(amps: torch.Tensor, generator: torch.Generator, n: int,
                    targets, probs, unitaries) -> Tuple[torch.Tensor, int]:
    return unitary_mixture_given(amps, _uniform(generator), n, targets,
                                 probs, unitaries)


def _validate_channel_prob(p: float, what: str) -> float:
    """Trajectory channels take the full CPTP range 0 <= p <= 1 (ref
    :125); out of range fails loudly."""
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise val.QuESTError(
            f"Invalid probability: the {what} probability must be in "
            f"[0, 1] for a trajectory unraveling, got {p}")
    return p


def _damping_args(target, prob):
    return target, M.damping_kraus(_validate_channel_prob(prob, "damping"))


def _dephasing_args(target, prob):
    p = _validate_channel_prob(prob, "dephasing")
    return target, [1.0 - p, p], [M.PAULI_I, M.PAULI_Z]


def _depolarising_args(target, prob):
    p = _validate_channel_prob(prob, "depolarising")
    return target, [1.0 - p, p / 3.0, p / 3.0, p / 3.0], list(M.PAULIS)


def _pauli_args(target, px, py, pz):
    px = _validate_channel_prob(px, "Pauli-X")
    py = _validate_channel_prob(py, "Pauli-Y")
    pz = _validate_channel_prob(pz, "Pauli-Z")
    _validate_channel_prob(px + py + pz, "total Pauli error")
    return target, [1.0 - px - py - pz, px, py, pz], list(M.PAULIS)


def damping(amps, generator, n, target, prob):
    """Amplitude damping as a trajectory branch (ref mixDamping)."""
    return kraus(amps, generator, n, *_damping_args(target, prob))


def damping_given(amps, u, n, target, prob):
    return kraus_given(amps, u, n, *_damping_args(target, prob))


def dephasing(amps, generator, n, target, prob):
    """Phase damping (ref mixDephasing): a unitary mixture."""
    return unitary_mixture(amps, generator, n,
                           *_dephasing_args(target, prob))


def dephasing_given(amps, u, n, target, prob):
    return unitary_mixture_given(amps, u, n, *_dephasing_args(target, prob))


def depolarising(amps, generator, n, target, prob):
    """Depolarising channel (ref mixDepolarising): a unitary mixture."""
    return unitary_mixture(amps, generator, n,
                           *_depolarising_args(target, prob))


def depolarising_given(amps, u, n, target, prob):
    return unitary_mixture_given(amps, u, n,
                                 *_depolarising_args(target, prob))


def pauli(amps, generator, n, target, px, py, pz):
    """Probabilistic Pauli error (ref mixPauli): a unitary mixture."""
    return unitary_mixture(amps, generator, n,
                           *_pauli_args(target, px, py, pz))


def pauli_given(amps, u, n, target, px, py, pz):
    return unitary_mixture_given(amps, u, n, *_pauli_args(target, px, py, pz))
