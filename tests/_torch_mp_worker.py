"""One rank of the port's two-process mesh tests (tests/test_torch_multiprocess.py,
tests/test_torch_gang.py); pytest does not collect it.

Usage: python tests/_torch_mp_worker.py SCENARIO ROOT STORE TIMEOUT, with
RANK and WORLD_SIZE in the environment. The rank joins a gloo group through
QuESTEnv(["cpu", "cpu"], distributed=True, init_method="file://STORE"),
so it holds 2 of the mesh's 2 * WORLD_SIZE CPU shards, and writes what the
parent checks under ROOT (its shards as .npy, its records as JSON). The
parent holds them against the JAX package and the port's one-process mesh.

Scenarios (mirroring tests/_multihost_worker.py, tests/_gang_worker.py and
tests/_elastic_worker.py):

  engines     10q d4 through the per-gate and banded engines, a 13q circuit
              with relabel events through the fused engine, a batch of 3
              13q states through the fused-batched engine, the norm's
              reduce, a gather, and the dynamic Bell circuit with feedback;
  consumers   the eager API, sampling, a Pauli-sum energy and a quench on a
              register sharded over the process mesh, and the two calls
              that refuse a process mesh typed (checkpoint.save and
              ServeEngine(durable_mesh=));
  gradients   value_and_grad(mesh=) of a 10q ansatz with both engines in
              f32 and f64 (and as QUEST_ADJOINT / auto resolve them),
              autograd through expec_sharded, plan.autotune(mesh=), and
              save_sharded / load_sharded across the processes: a fault
              mid-save, a background save, a one-process save loaded;
  gang        the four scenarios of the reference's gang worker at 8q, then
              one gang checkpoint left on disk for the parent to read;
  elastic-1 / elastic-solo / elastic-3
              the three generations of the elastic soak (2 ranks -> one
              process -> 2 ranks);
  peer-dies   rank 1 exits after the group forms; rank 0's next exchange
              must fail typed within the timeout.
"""

import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)
if __name__ == "__main__":
    # the ranks yield the CPU to the test processes they run beside: a
    # low priority, and every rank on the last core this process may use
    os.nice(10)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

# set by the command line (the parent imports this module for its helpers)
SCEN = ROOT = STORE = None
TIMEOUT = 60.0
RANK = 0

from quest_tpu_torch import checkpoint as ckpt  # noqa: E402
from quest_tpu_torch import state as TS  # noqa: E402
from quest_tpu_torch.circuit import Circuit, random_circuit  # noqa: E402
from quest_tpu_torch.env import QuESTEnv  # noqa: E402
from quest_tpu_torch.parallel import comm as C  # noqa: E402
from quest_tpu_torch.parallel import sharded as S  # noqa: E402
from quest_tpu_torch.parallel.introspect import sharded_schedule  # noqa: E402
from quest_tpu_torch.parallel.mesh import (ProcessGroupError,  # noqa: E402
                                           make_amp_mesh, shard_planes)
from quest_tpu_torch.resilience import faults  # noqa: E402
from quest_tpu_torch.resilience.durable import run_durable  # noqa: E402


def say(msg: str) -> None:
    print(f"rank {RANK}: {msg}", flush=True)


def join():
    env = QuESTEnv(["cpu", "cpu"], True, init_method="file://" + STORE,
                   timeout=TIMEOUT)
    assert env.rank == RANK and env.num_processes == 2, env.report()
    assert env.num_ranks == 4 and env.mesh.world == 2
    return env, env.mesh


def base(n: int) -> torch.Tensor:
    b = torch.zeros(2, 1 << n)
    b[0, 0] = 1.0
    return b


def batch_states(n: int, batch: int = 3, seed: int = 17) -> torch.Tensor:
    """`batch` normalised random n-qubit states as (B, 2, 2^n) f32 planes
    (the batched case's input; the parent makes the same)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((batch, 2, 1 << n))
    v /= np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return torch.from_numpy(v.astype(np.float32))


def relabel_circuit(nr: int = 13) -> Circuit:
    """The 13-qubit circuit of tests/_multihost_worker.py: three layers of
    rx on every qubit and cz on even pairs."""
    rng = np.random.default_rng(5)
    c = Circuit(nr)
    for _ in range(3):
        for q in range(nr):
            c.rx(q, float(rng.uniform(0, 2 * np.pi)))
        for q in range(0, nr - 1, 2):
            c.cz(q, q + 1)
    return c


def local_block(amps) -> np.ndarray:
    return torch.cat([s for _, s in amps.local()], dim=-1).numpy()


def save(name: str, arr) -> None:
    np.save(os.path.join(ROOT, f"{name}-{RANK}.npy"), np.asarray(arr))


def dump(name: str, rec) -> None:
    with open(os.path.join(ROOT, f"{name}-{RANK}.json"), "w") as f:
        json.dump(rec, f, sort_keys=True, default=str)


SCHED_KEYS = ("collective_permutes", "all_to_alls", "collective_exchanges",
              "ici_bytes_per_device", "all_reduces")


def engines() -> None:
    env, mesh = join()
    recs = {}

    def run(name, prog, n, engine, x0=None):
        x0 = base(n) if x0 is None else x0
        batch = x0.shape[0] if x0.dim() == 3 else 0
        x = shard_planes(x0, mesh, n)
        mesh.recorder.reset()
        prog(x)
        issued = mesh.recorder.stats(mesh.size)
        walked = prog.dry_walk(batch=batch).recorder.stats(mesh.size)
        recs[name] = {"issued": issued, "walked": walked,
                      "strategy": prog.strategy,
                      "launches": prog.launches_per_call,
                      "kernel_parts": prog.kernel_parts}
        if engine is not None:
            rec = sharded_schedule(prog_ops[name], n, False, mesh,
                                   engine=engine)
            recs[name].update(
                predicted={k: rec[k] for k in rec if k.startswith("comm_")},
                dry={k: rec[k] for k in SCHED_KEYS})
        save(name, local_block(x))
        return x

    n = 10
    c = random_circuit(n, 4, seed=21)
    nr = 13
    cr = relabel_circuit(nr)
    assert S.fused_shard_bands(nr, nr - 2) is not None
    prog_ops = {"pergate10": c.ops, "banded10": c.ops, "fused13": cr.ops,
                "relabel13": cr.ops}
    x = run("pergate10", S.compile_circuit_sharded(c.ops, n, False, mesh), n,
            "pergate")
    run("banded10", S.compile_circuit_sharded_banded(c.ops, n, False, mesh),
        n, "banded")
    run("fused13", S.compile_circuit_sharded_fused(cr.ops, nr, False, mesh),
        nr, "fused")
    # the relabel events themselves, as the reference worker runs them:
    # every all_to_all crosses the processes
    run("relabel13", S.compile_circuit_sharded_fused(cr.ops, nr, False, mesh,
                                                     relabel=True), nr, None)
    assert recs["relabel13"]["issued"]["all_to_alls"] > 0
    # a batch through the batched program: (B, 2, m) blocks cross the
    # processes in the same exchanges
    run("batched13", S.compile_circuit_sharded_fused_batched(
        cr.ops, nr, False, mesh), nr, None, batch_states(nr))
    # a one-process mesh built beside the process mesh prices flat
    one = make_amp_mesh(4, devices=["cpu"] * 4)
    recs["one_process_topology"] = C.topology(4, one).describe(4)
    recs["one_process_strategy"] = S.compile_circuit_sharded_banded(
        c.ops, n, False, one).strategy
    norm = mesh.reduce([None if s is None else s.double().pow(2).sum()
                        for s in x.shards])
    recs["norm"] = float(norm)
    save("gather10", x.gather("cpu"))
    dc = Circuit(n).h(0).cnot(0, n - 1).measure(n - 1).x_if(0, (0, 1))
    dc.measure(0)
    fn = S.compile_circuit_sharded_measured(dc.ops, n, False, mesh)
    outs = []
    for seed in range(6):
        xd = shard_planes(base(n), mesh, n)
        _, oc = fn(xd, torch.Generator().manual_seed(seed))
        outs.append(oc.tolist())
        assert oc.tolist()[1] == 0, oc
    save("dyn10", local_block(xd))
    recs["outcomes"] = outs
    recs["wire"] = mesh.wire
    dump("engines", recs)
    say(f"engines ok outcomes {outs}")


def consumer_ops(q, n: int) -> None:
    """The eager gates the consumers scenario applies (the parent applies
    the same to its one-process mesh)."""
    import quest_tpu_torch as qtt
    for t in range(n):
        qtt.gates.hadamard(q, t)
        qtt.gates.rotate_y(q, t, 0.1 + 0.2 * t)
    for t in range(0, n - 1, 2):
        qtt.gates.controlled_not(q, t, t + 1)
    qtt.gates.controlled_phase_flip(q, 0, n - 1)


def consumer_values(q, n: int, env) -> dict:
    """Every reduction, read and draw of the consumers scenario, in one
    record (the parent computes it on its one-process mesh too)."""
    import quest_tpu_torch as qtt
    from quest_tpu_torch import evolution as EV
    from quest_tpu_torch import measurement as MS
    from quest_tpu_torch.entry import tfim_sum
    codes = [[3] * n, [1] + [0] * (n - 1), [0] * (n - 1) + [2]]
    coeffs = [0.5, -0.3, 0.7]
    out = {
        "total": qtt.calc_total_prob(q),
        "p0": [qtt.calc_prob_of_outcome(q, t, 0) for t in range(n)],
        "amp": [[qtt.get_amp(q, k).real, qtt.get_amp(q, k).imag]
                for k in (0, 77, 300, 511)],
        "inner": [qtt.calc_inner_product(q, q).real,
                  qtt.calc_inner_product(q, q).imag],
        "energy": float(qtt.calc_expec_pauli_sum(q, codes, coeffs)),
        "samples": qtt.sample(q, 64, torch.Generator().manual_seed(3)
                              ).tolist(),
        "xeb": qtt.calculations.calc_linear_xeb(q, [0, 77, 300, 511]),
    }
    mesh = q.amps.mesh
    quench = EV.run_evolution(tfim_sum(n), 0.05, 4, state=q, mesh=mesh,
                              engine="banded", energy_every=2)
    out["quench"] = np.asarray(quench.energies).tolist()
    _, outcome, prob = MS.measure_with_stats(q, n - 1)
    out["measured"] = [int(outcome), float(prob)]
    out["total_after"] = qtt.calc_total_prob(q)
    rho = qtt.create_density_qureg(4, env)
    for t in range(4):
        qtt.gates.hadamard(rho, t)
    qtt.gates.controlled_not(rho, 0, 3)
    qtt.channels.mix_dephasing(rho, 3, 0.2)
    out["density"] = [qtt.calc_total_prob(rho), qtt.calc_purity(rho)]
    return out, quench.state


def consumers() -> None:
    import quest_tpu_torch as qtt
    from quest_tpu_torch import random_ as RND
    from quest_tpu_torch import validation as val
    from quest_tpu_torch.serve.engine import ServeEngine
    env, mesh = join()
    n = 9
    RND.seed_quest([7])
    q = qtt.create_qureg(n, env)
    consumer_ops(q, n)
    out, quenched = consumer_values(q, n, env)
    save("consumers", local_block(q.amps))
    save("quench", local_block(quenched.amps))
    refused = {}
    probes = {
        "save": lambda: ckpt.save(q, os.path.join(ROOT, f"save-{RANK}")),
        "serve_durable_mesh": lambda: ServeEngine(device="cpu",
                                                  durable_mesh=mesh),
    }
    for name, call in probes.items():
        try:
            call()
            refused[name] = "ran"
        except val.QuESTError as e:
            refused[name] = [type(e).__name__, str(e)]
    refused["save_wrote"] = os.path.exists(os.path.join(ROOT,
                                                        f"save-{RANK}"))
    out["refused"] = refused
    dump("consumers", out)
    say("consumers ok")


# -- gradients, plans and per-shard checkpoints ------------------------------


GRAD_N = 10
SAVE_LOOP = 20              # an even count leaves the register as it was


def grad_circuit(n: int = GRAD_N) -> Circuit:
    """A hardware-efficient ansatz, one rx or ry a qubit and a layer over
    2 layers with cz entanglers, then the parametric forms the mesh walk
    splits: a controlled rx on the top (cross-process) qubit under a
    local control, a controlled ry on a local target under a global
    control, a phase shift and a parity rotation on global qubits."""
    from quest_tpu_torch.ops import matrices as M
    rng = np.random.default_rng(23)
    c = Circuit(n)
    for layer in range(2):
        for q in range(n):
            (c.rx if (q + layer) % 2 else c.ry)(
                q, float(rng.uniform(-np.pi, np.pi)))
        for q in range(layer % 2, n - 1, 2):
            c.cz(q, q + 1)
    c.cu(M.rotation(0.37, (1, 0, 0)), n - 1, 0)
    c.cu(M.rotation(-0.52, (0, 1, 0)), 1, n - 2)
    c.phase(n - 2, 0.41).multi_rotate_z((2, n - 1), 0.63)
    return c


GRAD_CASES = [(engine, dt) for dt in ("float32", "float64")
              for engine in ("adjoint", "taped")]


def gradient_values(mesh, fn_of) -> dict:
    """Energy, gradient, issued exchanges and the engine of each case
    (fn_of(engine, dtype) -> value_and_grad fn) on `mesh`."""
    c = grad_circuit()
    out = {}
    for engine, dt in GRAD_CASES:
        fn = fn_of(c, engine, dt)
        theta = torch.as_tensor(fn.initial_params)
        mesh.recorder.reset()
        v, g = fn(theta)
        out[f"{engine}-{dt}"] = {
            "engine": fn.engine, "value": float(v),
            "grad": g.double().tolist(), "dtype": str(g.dtype),
            "issued": mesh.recorder.stats(mesh.size),
            "predicted": fn.comm_record}
    return out


def gradients() -> None:
    from quest_tpu_torch import adjoint as AD
    from quest_tpu_torch import plan as PL
    from quest_tpu_torch.entry import tfim_sum
    from quest_tpu_torch.ops import expec as E
    env, mesh = join()
    n = GRAD_N
    codes, coeffs = tfim_sum(n)
    recs = {"grads": gradient_values(mesh, lambda c, eng, dt:
                                     AD.value_and_grad(
                                         c, codes, coeffs=coeffs, mesh=mesh,
                                         engine=eng, dtype=np.dtype(dt)))}
    # the engine as QUEST_ADJOINT and auto resolve it on the mesh
    resolved = {}
    for knob, hbm in (("0", None), ("1", None), ("auto", 1 << 40),
                      ("auto", 1 << 16)):
        os.environ["QUEST_ADJOINT"] = knob
        if hbm is not None:
            os.environ["QUEST_HBM_BYTES"] = str(hbm)
        AD._FN_CACHE.clear()        # the device memory is not in the key
        fn = AD.value_and_grad(grad_circuit(), codes, coeffs=coeffs,
                               mesh=mesh)
        v, g = fn(torch.as_tensor(fn.initial_params))
        resolved[f"{knob}-{hbm}"] = [fn.engine, float(v), g.tolist()]
        os.environ.pop("QUEST_HBM_BYTES", None)
    os.environ.pop("QUEST_ADJOINT", None)
    recs["resolved"] = resolved
    # exchanges over processes sliced apart from those within a process
    os.environ["QUEST_EXCHANGE_SLICES_DCI"] = "2"
    fn = AD.value_and_grad(grad_circuit(), codes, coeffs=coeffs, mesh=mesh,
                           engine="adjoint")
    mesh.recorder.reset()
    fn(torch.as_tensor(fn.initial_params))
    recs["dci_sliced"] = {"issued": mesh.recorder.stats(mesh.size),
                          "predicted": fn.comm_record}
    os.environ.pop("QUEST_EXCHANGE_SLICES_DCI")
    # autograd through the sharded expectation
    x = shard_planes(expec_state(n), mesh, n)
    local = [s.requires_grad_(True) for _, s in x.local()]
    cf = torch.tensor(coeffs, requires_grad=True)
    plan = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=False)
    val = E.expec_sharded(x, cf, plan)
    grads = torch.autograd.grad(val, local + [cf])
    recs["expec"] = {"value": float(val), "cf_grad": grads[-1].tolist()}
    save("expec-grad", torch.cat([g for g in grads[:-1]], dim=-1).numpy())
    recs["exchange_grads"] = exchange_grads(mesh)
    # the plan: every rank the same, with no collective
    p = PL.autotune(grad_circuit(), mesh=mesh, persist=False)
    recs["plan"] = plan_record(p)
    dump("gradients", recs)
    checkpoints(mesh)
    say("gradients ok")


def exchange_grads(mesh) -> dict:
    """Each process's gradients through the process mesh's pair exchange
    and all-to-all of a weighted sum of what it received: block d's
    gradient is the weight its receiver gave it, delivered by the
    backward exchange from the other process."""
    D = mesh.size
    mine = list(mesh.local_ids)
    out = {}
    blocks = [None] * D
    for d in mine:
        blocks[d] = torch.full((2, 4), float(d + 1), requires_grad=True)
    recv = mesh.permute(blocks, 1)
    loss = sum((recv[d] * (10.0 * d + 1.0)).sum() for d in mine)
    grads = torch.autograd.grad(loss, [blocks[d] for d in mine])
    out["permute"] = {str(d): float(g.mean()) for d, g in zip(mine, grads)}
    rows = [None] * D
    for d in mine:
        rows[d] = [torch.full((2, 3), float(d * D + k), requires_grad=True)
                   for k in range(D)]
    recv = mesh.all_to_all(rows)
    loss = sum((recv[k][d] * float(100 * k + d)).sum()
               for k in mine for d in range(D))
    grads = torch.autograd.grad(loss, [rows[d][k] for d in mine
                                       for k in range(D)])
    out["all_to_all"] = {f"{d},{k}": float(grads[i * D + k].mean())
                         for i, d in enumerate(mine) for k in range(D)}
    out["received"] = {f"{k},{d}": float(recv[k][d].mean())
                       for k in mine for d in range(D)}
    return out


def expec_state(n: int) -> torch.Tensor:
    """A normalised random f64 state (2, 2^n), the expectation's input
    (the parent makes the same)."""
    rng = np.random.default_rng(31)
    v = rng.standard_normal((2, 1 << n))
    return torch.from_numpy(v / np.sqrt((v ** 2).sum()))


def plan_record(p) -> dict:
    """A ProgramPlan as JSON-comparable fields."""
    import dataclasses
    return json.loads(json.dumps(dataclasses.asdict(p), sort_keys=True,
                                 default=str))


def checkpoints(mesh) -> None:
    """save_sharded / load_sharded over the process mesh: a save the
    parent reads onto a one-process mesh and one register, a fault in
    rank 1's save (nothing committed, rank 0's save fails typed at its
    timeout, the directory refused typed), the save retried with
    block=False, saves back to back each loaded at once with no barrier
    (a returned save is committed, whichever rank committed it), and the
    one-process save the parent wrote before the ranks started, loaded
    onto the process mesh."""
    from quest_tpu_torch.state import Qureg
    n = GRAD_N
    c = grad_circuit(n)
    x = shard_planes(base(n), mesh, n)
    S.compile_circuit_sharded(c.ops, n, False, mesh)(x)
    q = Qureg(amps=x, num_qubits=n)
    save("ckpt-state", local_block(x))
    rec = {}
    # a fault between rank 1's payload and its stamp: nothing commits
    torn = os.path.join(ROOT, "ckpt-torn")
    plan = faults.FaultPlan()
    if RANK == 1:
        plan.inject("checkpoint.save", after_n=0, times=1)
    with faults.active(plan):
        try:
            ckpt.save_sharded(q, torn, timeout=2.0)
            rec["torn_raised"] = None
        except (faults.InjectedFault, ckpt.CheckpointError) as e:
            rec["torn_raised"] = type(e).__name__
    mesh.barrier()
    rec["torn_committed"] = os.path.exists(torn)
    try:
        ckpt.load_sharded(torn, mesh=mesh)
        rec["torn_load"] = "loaded"
    except ckpt.CheckpointError as e:
        rec["torn_load"] = type(e).__name__
    # the same directory again, in the background: committed whole
    pending = ckpt.save_sharded(q, torn, block=False)
    rec["pending"] = type(pending).__name__
    pending.wait()
    mesh.barrier()
    rec["torn_dirs_left"] = sorted(
        e for e in os.listdir(ROOT) if e.startswith("ckpt-torn.tmp"))
    back = ckpt.load_sharded(torn, mesh=mesh)
    rec["round_trip_equal"] = all(
        torch.equal(back.amps.shards[d], x.shards[d]) for d in mesh.local_ids)
    mesh.barrier()
    # saves back to back into one directory, each loaded as soon as it
    # returns: both ranks race for every commit
    loop = os.path.join(ROOT, "ckpt-loop")
    rec["loop_equal"] = []
    for i in range(SAVE_LOOP):
        for d in mesh.local_ids:
            x.shards[d].mul_(-1.0)
        ckpt.save_sharded(q, loop)
        got = ckpt.load_sharded(loop, mesh=mesh)
        rec["loop_equal"].append(all(
            torch.equal(got.amps.shards[d], x.shards[d])
            for d in mesh.local_ids))
    mesh.barrier()
    rec["loop_left"] = sorted(
        e for e in os.listdir(ROOT) if e.startswith("ckpt-loop."))
    # a save over a committed checkpoint replaces it whole
    over = os.path.join(ROOT, "ckpt-over")
    ckpt.save_sharded(Qureg(amps=shard_planes(base(n), mesh, n),
                            num_qubits=n), over)
    mesh.barrier()
    ckpt.save_sharded(q, over)
    mesh.barrier()
    again = ckpt.load_sharded(over, mesh=mesh)
    rec["overwrite_equal"] = all(
        torch.equal(again.amps.shards[d], x.shards[d])
        for d in mesh.local_ids)
    mesh.barrier()
    # the parent's one-process save, onto the process mesh
    one = ckpt.load_sharded(os.path.join(ROOT, "one-process"), mesh=mesh)
    save("ckpt-from-one", local_block(one.amps))
    rec["from_one_shards"] = sorted(
        d for d, s in enumerate(one.amps.shards) if s is not None)
    dump("checkpoints", rec)


# -- the gang durable scenarios (tests/_gang_worker.py) ----------------------


def gang_circuit(n: int = 8) -> Circuit:
    rng = np.random.default_rng(11)
    c = Circuit(n)
    for _ in range(3):
        for t in range(n):
            c.rx(t, float(rng.uniform(0, 2 * np.pi)))
            c.ry(t, float(rng.uniform(0, 2 * np.pi)))
        for t in range(0, n - 1, 2):
            c.cz(t, t + 1)
    return c


def fresh(mesh, n: int):
    q = TS.create_qureg(n, device="cpu")
    return q.replace_amps(shard_planes(base(n), mesh, n))


def shard_hash(q) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        local_block(q.amps)).tobytes()).hexdigest()[:16]


GANG_EVERY = 1


def gang() -> None:
    env, mesh = join()
    N = 8
    c = gang_circuit(N)
    rec = sharded_schedule(c.ops, N, False, mesh, engine="banded")
    assert rec["comm_matches_hlo"], rec
    assert rec["comm_topology"]["hosts"] == 2, rec["comm_topology"]
    assert rec["comm_dci_bytes"] > 0, rec
    say(f"gang parity ok strategy={rec['comm_strategy']} "
        f"dci={rec['comm_dci_bytes']}")

    # the port's banded plan of this circuit is 4 steps (the reference's
    # is longer), so a checkpoint every step keeps the reference's
    # sequence: kill after two saves, and the mid-save kill in the second
    dir_a = os.path.join(ROOT, "a")
    out_a = run_durable(c, fresh(mesh, N), dir_a, every=GANG_EVERY, mesh=mesh)
    hash_a = shard_hash(out_a)
    assert ckpt.step_dirs(dir_a) == [], "completed run must consume its chain"
    save("gang-a", local_block(out_a.amps))
    say(f"gang uninterrupted ok {hash_a}")

    dir_b = os.path.join(ROOT, "b")
    plan = faults.FaultPlan().inject("durable.preempt", after_n=2, times=1)
    with faults.active(plan):
        try:
            run_durable(c, fresh(mesh, N), dir_b, every=GANG_EVERY, mesh=mesh)
            raise AssertionError("seeded preempt did not fire")
        except faults.InjectedFault:
            pass
    assert ckpt.step_dirs(dir_b), "no gang checkpoint committed before kill"
    out_b = run_durable(c, fresh(mesh, N), dir_b, every=GANG_EVERY, mesh=mesh)
    assert shard_hash(out_b) == hash_a, "gang resume diverged"
    say("gang resume ok")

    dir_c = os.path.join(ROOT, "c")
    plan = faults.FaultPlan()
    if RANK == 1:
        # fire inside the second gang save: slice written, stamp withheld
        plan.inject("checkpoint.save", after_n=1, times=1)
    else:
        # rank 0 is preempted at the boundary right after that save
        plan.inject("durable.preempt", after_n=2, times=1)
    with faults.active(plan):
        try:
            run_durable(c, fresh(mesh, N), dir_c, every=GANG_EVERY, mesh=mesh)
            raise AssertionError("seeded mid-save kill did not fire")
        except faults.InjectedFault:
            pass
    mesh.barrier()
    steps = [s for s, _ in ckpt.step_dirs(dir_c)]
    assert steps == [1], f"mid-save kill leaked a commit: {steps}"
    tmp4 = os.path.join(dir_c, "ckpt-00000002.tmp-gang")
    assert os.path.isdir(tmp4), "the killed save left no gang tmp"
    if RANK == 0:
        assert os.path.exists(os.path.join(tmp4, "prepared-0"))
    assert not os.path.exists(os.path.join(tmp4, "prepared-1")), \
        "the killed rank stamped anyway"
    out_c = run_durable(c, fresh(mesh, N), dir_c, every=GANG_EVERY, mesh=mesh)
    assert shard_hash(out_c) == hash_a, "mid-save-kill resume diverged"
    assert ckpt.step_dirs(dir_c) == [], "completed run must consume chain"
    assert not os.path.isdir(tmp4), "completed run must sweep the gang tmp"
    say("gang midsave ok")

    # one gang step left on disk: the parent reads it with both packages
    x = fresh(mesh, N)
    S.compile_circuit_sharded_banded(c.ops, N, False, mesh)(x.amps)
    cursor = {"kind": "state", "step": 3, "perm": None, "layout": "physical",
              "note": "kept"}
    ckpt.save_step_gang(os.path.join(ROOT, "kept"), 3, qureg=x,
                        extra=cursor)
    mesh.barrier()
    save("kept", local_block(x.amps))
    say("gang kept ok")


# -- the elastic soak (tests/_elastic_worker.py) -----------------------------


def elastic_circuit(n: int = 10, layers: int = 3, seed: int = 7) -> Circuit:
    """bench._build_elastic_circuit on the port's Circuit, draw for draw
    (tests/test_torch_elastic.py elastic_circuit)."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for layer in range(layers):
        for t in range(7):
            c.cz(t, n - 1)
            ang = float(rng.uniform(0, 2 * np.pi))
            (c.rx if (layer + t) % 2 == 0 else c.ry)(t, ang)
        if layer == 0:
            for h in range(7, n):
                c.cnot(h - 7, h)
        for h in range(7, n):
            c.cz(h, (h + layer) % 7)
    return c


EL_N, EL_EVERY = 10, 10


def halves(q) -> dict:
    """sha256 of each contiguous half of the planes this process holds
    (a rank of the 4-shard gang mesh holds one half; one process both)."""
    amps = q.amps
    ids = [d for d, _ in amps.local()]
    block = local_block(amps)
    half_shards = amps.mesh.size // 2
    out = {}
    for h in range(2):
        mine = [i for i, d in enumerate(ids) if d // half_shards == h]
        if not mine:
            continue
        m = block.shape[-1] // len(ids)
        part = np.concatenate([block[:, i * m:(i + 1) * m] for i in mine],
                              axis=-1)
        out[str(h)] = hashlib.sha256(
            np.ascontiguousarray(part).tobytes()).hexdigest()[:16]
    return out


def elastic() -> None:
    from quest_tpu_torch.serve import metrics
    c = elastic_circuit(EL_N)
    chain = os.path.join(ROOT, "chain")
    if SCEN == "elastic-1":
        env, mesh = join()
        out = run_durable(c, fresh(mesh, EL_N), os.path.join(ROOT, "ref"),
                          every=EL_EVERY, mesh=mesh)
        dump("ref-hashes", halves(out))
        plan = faults.FaultPlan()
        if RANK == 1:
            plan.inject("checkpoint.save", after_n=1, times=1)
        else:
            plan.inject("durable.preempt", after_n=2 * EL_EVERY + 1, times=1)
        with faults.active(plan):
            try:
                run_durable(c, fresh(mesh, EL_N), chain, every=EL_EVERY,
                            mesh=mesh)
                raise AssertionError("seeded mid-save kill did not fire")
            except faults.InjectedFault:
                pass
        mesh.barrier()
        steps = [s for s, _ in ckpt.step_dirs(chain)]
        assert steps == [EL_EVERY], steps
        assert all(ckpt.is_gang_step(p) for _, p in ckpt.step_dirs(chain))
        say("elastic baseline ok")
        say("elastic midsave-kill ok")
    elif SCEN == "elastic-solo":
        mesh = make_amp_mesh(2, devices=["cpu"] * 2)
        reg = metrics.Registry()
        plan = faults.FaultPlan().inject("durable.preempt",
                                         after_n=3 * EL_EVERY + 5, times=1)
        with faults.active(plan):
            try:
                run_durable(c, fresh(mesh, EL_N), chain, every=EL_EVERY,
                            mesh=mesh, elastic=True, registry=reg)
                raise AssertionError("seeded preempt did not fire")
            except faults.InjectedFault:
                pass
        # the resume consumed the gang stamp, not a hollow op-0 restart
        assert reg.counter("durable_resumes").value == 1
        assert reg.counter("durable_elastic_resumes").value == 1
        steps = [s for s, _ in ckpt.step_dirs(chain)]
        assert steps and max(steps) > EL_EVERY, steps
        # the newest step is plain now, and the plain save path reclaimed
        # the torn gang tmp of the first generation
        kinds = [ckpt.is_gang_step(p) for _, p in ckpt.step_dirs(chain)]
        assert not kinds[-1], kinds
        assert not os.path.isdir(os.path.join(
            chain, f"ckpt-{2 * EL_EVERY:08d}.tmp-gang"))
        say(f"elastic solo-resume ok {kinds}")
    else:
        env, mesh = join()
        reg = metrics.Registry()
        out = run_durable(c, fresh(mesh, EL_N), chain, every=EL_EVERY,
                          mesh=mesh, elastic=True, registry=reg)
        assert reg.counter("durable_elastic_resumes").value == 1
        with open(os.path.join(ROOT, f"ref-hashes-{RANK}.json")) as f:
            want = json.load(f)
        assert halves(out) == want, (halves(out), want)
        mesh.barrier()
        assert ckpt.step_dirs(chain) == []
        assert not any(".tmp-gang" in p for p in os.listdir(chain))
        say("elastic final ok")


def peer_dies() -> None:
    env, mesh = join()
    n = 6
    x = shard_planes(base(n), mesh, n)
    if RANK == 1:
        os._exit(0)
    t0 = time.perf_counter()
    try:
        S.compile_circuit_sharded(Circuit(n).h(n - 1).ops, n, False, mesh)(x)
    except ProcessGroupError as e:
        say(f"typed ok {time.perf_counter() - t0:.3f} s: {type(e).__name__}")
        return
    raise AssertionError("an exchange with a dead peer did not fail")


if __name__ == "__main__":
    SCEN, ROOT, STORE, TIMEOUT = (sys.argv[1], sys.argv[2], sys.argv[3],
                                  float(sys.argv[4]))
    RANK = 0 if SCEN == "elastic-solo" else int(os.environ["RANK"])
    try:
        {"engines": engines, "consumers": consumers, "gang": gang,
         "gradients": gradients,
         "peer-dies": peer_dies}.get(SCEN, elastic)()
    except ProcessGroupError as e:
        say(f"ProcessGroupError: {e}")
        sys.exit(3)
    sys.stdout.flush()
    os._exit(0)
