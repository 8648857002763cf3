"""Meshes over several processes (quest_tpu_torch/parallel/mesh.py
make_process_mesh, env.QuESTEnv(distributed=True)), mirroring
tests/test_multihost.py and tests/_multihost_worker.py on the CPU.

The gradients scenario holds value_and_grad(mesh=) of both engines (f32
and f64) equal on both ranks, within 1e-12 / 1e-6 relative of the
one-process mesh and 5e-6 / 5e-5 of the JAX package's sharded adjoint
walk, its exchanges equal to the prediction (and that to the JAX
package's); autograd through expec_sharded, autotune(mesh=) equal on
both ranks and to the one-process plan, and save_sharded / load_sharded
across process and one-process meshes, all or nothing under a fault.

Two real processes join a gloo group through a FileStore in the test's
temporary directory (no fixed port) and hold 2 CPU shards each of one
4-shard mesh (tests/_torch_mp_worker.py). Each rank writes its shards and
records; here they are held to:

  * the JAX package's dense result of the same circuit (its per-gate or
    banded engine) within the reference worker's own tolerances, 5e-6
    (10 qubits) and 5e-5 (13 qubits, relabel events);
  * the port's one-process 4-shard mesh, bit for bit, priced under the
    same topology (QUEST_COMM_TOPOLOGY=hosts=2: two processes are two
    hosts, which the ranks derive from their group);
  * the exchanges each rank issued, equal to its dry walk, to the port's
    prediction and, for the banded and per-gate engines, to the JAX
    package's comm planner under hosts=2, with the same strategy;
  * the same measurement outcomes, reductions and samples on both ranks,
    equal to the one-process mesh's and, within the plane dtype's
    rounding, to the JAX package's on the same gates and seed.

A peer that dies, or never comes, fails the other rank with a typed
ProcessGroupError within its timeout. Each rank process is bounded by
communicate(timeout=...) and killed on expiry. No assertion is on time.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quest_tpu.parallel import comm as JCM
from quest_tpu.parallel import sharded as JS
from quest_tpu_torch import random_ as RND
from quest_tpu_torch.circuit import Circuit, random_circuit
from quest_tpu_torch.env import QuESTEnv
from quest_tpu_torch.parallel import comm as TCM
from quest_tpu_torch.parallel import mesh as TM
from quest_tpu_torch.parallel import sharded as S
from quest_tpu_torch.parallel.mesh import (AmpMesh, ProcessGroupError,
                                           make_amp_mesh, shard_planes)

from . import _torch_mp_worker as W
from .test_torch_comm import _one_thread_per_worker, to_reference  # noqa: F401

pytestmark = pytest.mark.dtype_agnostic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
RANK_TIMEOUT = 120.0     # a rank's bound on its group and every collective
WAIT_S = 400             # the parent's bound on a rank process


def worker_env() -> dict:
    """The rank processes' environment: the repo on the path, one BLAS and
    OpenMP thread each (numpy's planning math would otherwise spin a pool
    per process), the topology derived, not set."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = "1"
    env.pop("QUEST_COMM_TOPOLOGY", None)
    return env


def run_ranks(scenario: str, root: str, ranks=(0, 1), world: int = 2,
              timeout: float = RANK_TIMEOUT):
    """Run `scenario` in one process per rank of a `world`-process group
    meeting through a FileStore under `root`; returns (return codes,
    outputs). A process still running after WAIT_S is killed."""
    env = worker_env()
    env["WORLD_SIZE"] = str(world)
    store = os.path.join(root, f"store-{scenario}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, root, store, str(timeout)],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in ranks]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def run_solo(scenario: str, root: str):
    """One ordinary process (no group) of the worker."""
    p = subprocess.Popen([sys.executable, WORKER, scenario, root, "-",
                          str(RANK_TIMEOUT)], env=worker_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=WAIT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return p.returncode, out


def both(root, name):
    """The two ranks' blocks of `name` side by side: the whole planes."""
    return np.concatenate([np.load(os.path.join(root, f"{name}-{r}.npy"))
                           for r in (0, 1)], axis=-1)


def records(root, name):
    out = []
    for r in (0, 1):
        with open(os.path.join(root, f"{name}-{r}.json")) as f:
            out.append(json.load(f))
    return out


def assert_ranks_ok(rcs, outs, marker):
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert marker in out, out[-2000:]


@pytest.fixture(scope="module")
def engines_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("engines"))
    rcs, outs = run_ranks("engines", root)
    assert_ranks_ok(rcs, outs, "engines ok")
    return root, records(root, "engines")


@pytest.fixture(scope="module")
def consumers_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("consumers"))
    rcs, outs = run_ranks("consumers", root)
    assert_ranks_ok(rcs, outs, "consumers ok")
    return root, records(root, "consumers")


@pytest.fixture()
def hosts2(monkeypatch):
    """The one-process mesh priced as the ranks price theirs."""
    monkeypatch.setenv("QUEST_COMM_TOPOLOGY", "hosts=2")


def base(n):
    b = torch.zeros(2, 1 << n)
    b[0, 0] = 1.0
    return b


def inputs(name, n):
    """The planes a case starts from: |0...0>, or the batched case's
    three random states."""
    return W.batch_states(n) if name == "batched13" else base(n)


CASES = {
    # name: (circuit builder, n, port builder, JAX dense engine, tolerance)
    "pergate10": (lambda: random_circuit(10, 4, seed=21), 10,
                  lambda ops, n, m: S.compile_circuit_sharded(ops, n, False,
                                                              m),
                  "compiled", 5e-6),
    "banded10": (lambda: random_circuit(10, 4, seed=21), 10,
                 lambda ops, n, m: S.compile_circuit_sharded_banded(
                     ops, n, False, m), "compiled_banded", 5e-6),
    "fused13": (W.relabel_circuit, 13,
                lambda ops, n, m: S.compile_circuit_sharded_fused(
                    ops, n, False, m), "compiled_banded", 5e-5),
    "relabel13": (W.relabel_circuit, 13,
                  lambda ops, n, m: S.compile_circuit_sharded_fused(
                      ops, n, False, m, relabel=True),
                  "compiled_banded", 5e-5),
    "batched13": (W.relabel_circuit, 13,
                  lambda ops, n, m: S.compile_circuit_sharded_fused_batched(
                      ops, n, False, m),
                  "compiled_banded", 5e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_the_jax_result(engines_run, name):
    root, _ = engines_run
    build, n, _, engine, tol = CASES[name]
    fn = getattr(to_reference(build()), engine)(n, False, donate=False)
    x0 = inputs(name, n).numpy()
    want = (np.stack([np.asarray(fn(s)) for s in x0]) if x0.ndim == 3
            else np.asarray(fn(x0)))
    got = both(root, name)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_equal_the_one_process_mesh_bit_for_bit(engines_run, hosts2,
                                                      name):
    root, recs = engines_run
    build, n, compile_, _, _ = CASES[name]
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    prog = compile_(build().ops, n, mesh)
    x = shard_planes(inputs(name, n), mesh, n)
    prog(x)
    np.testing.assert_array_equal(both(root, name), x.gather("cpu").numpy())
    assert prog.strategy == recs[0][name]["strategy"] == \
        recs[1][name]["strategy"]
    # a rank launches the kernel parts of its own two shards
    assert recs[0][name]["launches"] == prog.launches_per_call // 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_issued_exchanges_equal_the_prediction(engines_run, name):
    _, recs = engines_run
    for rec in recs:
        assert rec[name]["issued"] == rec[name]["walked"]
        if "predicted" in rec[name]:
            pred = rec[name]["predicted"]
            assert rec[name]["dry"] == rec[name]["issued"]
            assert pred["comm_matches_hlo"]
            assert pred["comm_topology"]["hosts"] == 2
            assert pred["comm_exchanges"] == \
                rec[name]["issued"]["collective_exchanges"]
            assert pred["comm_bytes"] == \
                rec[name]["issued"]["ici_bytes_per_device"]
    assert recs[0][name]["issued"] == recs[1][name]["issued"]


@pytest.mark.parametrize("name", ["pergate10", "banded10"])
def test_issued_exchanges_equal_the_jax_prediction(engines_run, hosts2,
                                                   name):
    _, recs = engines_run
    build, n, _, _, _ = CASES[name]
    jops = to_reference(build()).ops
    local_n = n - 2
    if name == "banded10":
        want = JS.comm_plan_record(jops, n, False, 4)
        strategy = want["comm_strategy"]
    else:
        topo = JCM.topology(4)
        info = {}
        chosen = JS.pergate_flat(jops, n, False, local_n, comm_info=info)
        want = JCM.comm_stats(
            JCM.predict_exchanges_flat(chosen, local_n, topo.ici_bits(4)),
            num_devices=4, bytes_per_real=4, topo=topo)
        strategy = info["strategy"]
    for rec in recs:
        issued = rec[name]["issued"]
        assert issued["collective_permutes"] == \
            want["comm_collective_permutes"]
        assert issued["all_to_alls"] == want["comm_all_to_alls"]
        assert issued["collective_exchanges"] == want["comm_exchanges"]
        assert issued["ici_bytes_per_device"] == want["comm_bytes"]
        assert rec[name]["strategy"] == strategy == "hier"


def test_a_one_process_mesh_beside_a_process_mesh_prices_flat(engines_run,
                                                              monkeypatch):
    """The topology follows the planned mesh: a one-process mesh built in
    a rank process prices flat, and its plan is the flat plan."""
    monkeypatch.delenv("QUEST_COMM_TOPOLOGY", raising=False)
    _, recs = engines_run
    flat = S.compile_circuit_sharded_banded(
        random_circuit(10, 4, seed=21).ops, 10, False,
        make_amp_mesh(4, devices=["cpu"] * 4)).strategy
    for rec in recs:
        assert rec["one_process_topology"] == TCM.FLAT.describe(4)
        assert rec["one_process_strategy"] == flat
    assert recs[0]["banded10"]["strategy"] == "hier" != flat


def test_norm_gather_and_wire(engines_run):
    root, recs = engines_run
    for r, rec in enumerate(recs):
        assert abs(rec["norm"] - 1.0) < 1e-5
        assert rec["norm"] == recs[0]["norm"]
        gathered = np.load(os.path.join(root, f"gather10-{r}.npy"))
        np.testing.assert_array_equal(gathered, both(root, "pergate10"))
        # the exchanges that crossed processes went over the wire
        assert rec["wire"]["calls"] > 0 and rec["wire"]["bytes_out"] > 0


def test_dynamic_outcomes_equal_on_both_ranks_and_one_process(engines_run,
                                                               hosts2):
    root, recs = engines_run
    assert recs[0]["outcomes"] == recs[1]["outcomes"]
    assert all(o[1] == 0 for o in recs[0]["outcomes"])
    n = 10
    dc = Circuit(n).h(0).cnot(0, n - 1).measure(n - 1).x_if(0, (0, 1))
    dc.measure(0)
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    fn = S.compile_circuit_sharded_measured(dc.ops, n, False, mesh)
    outs = []
    for seed in range(6):
        x = shard_planes(base(n), mesh, n)
        _, oc = fn(x, torch.Generator().manual_seed(seed))
        outs.append(oc.tolist())
    assert outs == recs[0]["outcomes"]
    assert len({tuple(o) for o in outs}) > 1      # both branches drawn
    np.testing.assert_array_equal(both(root, "dyn10"),
                                  x.gather("cpu").numpy())


# -- the sharded consumers on a process mesh ---------------------------------


@pytest.fixture(scope="module")
def one_process_consumers():
    saved = os.environ.get("QUEST_COMM_TOPOLOGY")
    os.environ["QUEST_COMM_TOPOLOGY"] = "hosts=2"
    try:
        import quest_tpu_torch as qtt
        env = QuESTEnv(["cpu"] * 4)
        n = 9
        RND.seed_quest([7])
        q = qtt.create_qureg(n, env)
        W.consumer_ops(q, n)
        vals, quenched = W.consumer_values(q, n, env)
        RND.seed_quest_default()
        return vals, q.amps.gather("cpu").numpy(), \
            quenched.amps.gather("cpu").numpy()
    finally:
        if saved is None:
            del os.environ["QUEST_COMM_TOPOLOGY"]
        else:
            os.environ["QUEST_COMM_TOPOLOGY"] = saved


@pytest.mark.parametrize("key", ["total", "p0", "amp", "inner", "energy",
                                 "samples", "xeb", "quench", "measured",
                                 "total_after", "density"])
def test_consumers_agree_on_both_ranks_and_with_one_process(
        consumers_run, one_process_consumers, key):
    _, recs = consumers_run
    want = one_process_consumers[0][key]
    assert recs[0][key] == recs[1][key]
    if key in ("samples", "measured"):
        assert recs[0][key] == want
    else:
        np.testing.assert_allclose(np.asarray(recs[0][key], dtype=float),
                                   np.asarray(want, dtype=float),
                                   rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_consumers():
    """The consumers scenario's values from the JAX package: the same
    eager gates, seed and calls on one JAX register; samples are the
    inverse CDF of its probabilities at the ranks' uniforms."""
    import quest_tpu as jqt
    from quest_tpu import evolution as JEV
    from quest_tpu import random_ as JR
    from quest_tpu.ops import channels as JCH
    from quest_tpu.ops import gates as JG
    from quest_tpu_torch.entry import tfim_sum
    n = 9
    JR.seed_quest([7])
    q = jqt.create_qureg(n)
    for t in range(n):
        q = JG.hadamard(q, t)
        q = JG.rotate_y(q, t, 0.1 + 0.2 * t)
    for t in range(0, n - 1, 2):
        q = JG.controlled_not(q, t, t + 1)
    q = JG.controlled_phase_flip(q, 0, n - 1)
    codes = [[3] * n, [1] + [0] * (n - 1), [0] * (n - 1) + [2]]
    coeffs = [0.5, -0.3, 0.7]
    planes = np.asarray(q.amps, dtype=np.float64).reshape(2, -1)
    probs = planes[0] ** 2 + planes[1] ** 2
    cdf = np.cumsum(probs)
    u = torch.rand(64, generator=torch.Generator().manual_seed(3),
                   dtype=torch.float32).double().numpy()
    amps = [jqt.get_amp(q, k) for k in (0, 77, 300, 511)]
    inner = jqt.calc_inner_product(q, q)
    out = {
        "total": jqt.calc_total_prob(q),
        "p0": [jqt.calc_prob_of_outcome(q, t, 0) for t in range(n)],
        "amp": [[a.real, a.imag] for a in amps],
        "inner": [inner.real, inner.imag],
        "energy": float(jqt.calc_expec_pauli_sum(q, codes, coeffs)),
        "samples": np.searchsorted(cdf, u * cdf[-1], side="right").tolist(),
        "xeb": jqt.calculations.calc_linear_xeb(q, [0, 77, 300, 511]),
    }
    codes_h, coeffs_h = tfim_sum(n)
    quench = JEV.run_evolution((np.asarray(codes_h), np.asarray(coeffs_h)),
                               0.05, 4, state=q, engine="banded",
                               energy_every=2)
    out["quench"] = np.asarray(quench.energies).tolist()
    q, outcome, prob = jqt.measurement.measure_with_stats(q, n - 1)
    out["measured"] = [int(outcome), float(prob)]
    out["total_after"] = jqt.calc_total_prob(q)
    rho = jqt.create_density_qureg(4)
    for t in range(4):
        rho = JG.hadamard(rho, t)
    rho = JG.controlled_not(rho, 0, 3)
    rho = JCH.mix_dephasing(rho, 3, 0.2)
    out["density"] = [jqt.calc_total_prob(rho), jqt.calculations.calc_purity(
        rho)]
    return out, np.asarray(quench.state.amps).reshape(2, -1)


@pytest.mark.parametrize("key", ["total", "p0", "amp", "inner", "energy",
                                 "samples", "xeb", "quench", "measured",
                                 "total_after", "density"])
def test_consumers_agree_with_the_jax_package(consumers_run, jax_consumers,
                                              key):
    """The process mesh's consumers on both ranks against the JAX
    package's on the same gates and seed, within f32 rounding (the
    outcome and the samples exactly)."""
    _, recs = consumers_run
    want = jax_consumers[0][key]
    for rec in recs:
        if key == "samples":
            assert rec[key] == want
        elif key == "measured":
            assert rec[key][0] == want[0]
            assert abs(rec[key][1] - want[1]) < 1e-5
        else:
            np.testing.assert_allclose(np.asarray(rec[key], dtype=float),
                                       np.asarray(want, dtype=float),
                                       rtol=1e-5, atol=2e-6)


def test_consumer_quench_holds_the_jax_state(consumers_run, jax_consumers):
    root, _ = consumers_run
    np.testing.assert_allclose(both(root, "quench"), jax_consumers[1],
                               rtol=0, atol=2e-5)


def test_consumer_shards_equal_the_one_process_mesh(consumers_run,
                                                    one_process_consumers):
    root, _ = consumers_run
    _, planes, quenched = one_process_consumers
    np.testing.assert_array_equal(both(root, "consumers"), planes)
    np.testing.assert_allclose(both(root, "quench"), quenched, rtol=0,
                               atol=1e-6)


def test_save_and_a_serving_durable_mesh_refuse_a_process_mesh_typed(
        consumers_run):
    """The two calls that gather a register onto one process, as the
    reference's (jax.device_get, which fails for an array over another
    process's devices), refuse a process mesh typed and write nothing."""
    _, recs = consumers_run
    for rec in recs:
        refused = rec["refused"]
        assert refused["save"][0] == "CheckpointError"
        assert "jax.device_get" in refused["save"][1]
        assert "save_sharded" in refused["save"][1]
        assert refused["serve_durable_mesh"][0] == "QuESTError"
        assert "jax.device_get" in refused["serve_durable_mesh"][1]
        assert refused["save_wrote"] is False


# -- gradients, plans and per-shard checkpoints over the process mesh --------


@pytest.fixture(scope="module")
def gradients_run(tmp_path_factory):
    """The gradients scenario, after a one-process 4-shard save_sharded of
    the scenario's state that the ranks load onto their mesh."""
    from quest_tpu_torch import checkpoint as ckpt
    from quest_tpu_torch.state import Qureg
    root = str(tmp_path_factory.mktemp("gradients"))
    n = W.GRAD_N
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    x = shard_planes(base(n), mesh, n)
    S.compile_circuit_sharded(W.grad_circuit(n).ops, n, False, mesh)(x)
    ckpt.save_sharded(Qureg(amps=x, num_qubits=n),
                      os.path.join(root, "one-process"))
    rcs, outs = run_ranks("gradients", root)
    assert_ranks_ok(rcs, outs, "gradients ok")
    return root, records(root, "gradients"), records(root, "checkpoints"), \
        x.gather("cpu").numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _one_process_grads():
    from quest_tpu_torch import adjoint as AD
    from quest_tpu_torch.entry import tfim_sum
    codes, coeffs = tfim_sum(W.GRAD_N)
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    return mesh, W.gradient_values(mesh, lambda c, eng, dt: AD.value_and_grad(
        c, codes, coeffs=coeffs, mesh=mesh, engine=eng, dtype=np.dtype(dt)))


@pytest.fixture(scope="module")
def one_process_grads():
    return _one_process_grads()[1]


CASE_IDS = [f"{e}-{d}" for e, d in W.GRAD_CASES]
GRAD_REL = {"float32": 1e-6, "float64": 1e-12}
JAX_TOL = {"float32": 5e-5, "float64": 5e-6}


@pytest.mark.parametrize("case", CASE_IDS)
def test_gradients_equal_on_both_ranks_and_the_one_process_mesh(
        gradients_run, one_process_grads, case):
    """Both engines over 2 ranks x 2 CPU shards: the same energy and
    gradient on both ranks, within 1e-12 (f64) / 1e-6 (f32) relative of
    the one-process 4-shard mesh, which sums in another order."""
    _, recs, _, _ = gradients_run
    r0, r1 = (r["grads"][case] for r in recs)
    want = one_process_grads[case]
    engine, dt = case.split("-")
    assert r0["engine"] == r1["engine"] == want["engine"] == engine
    assert r0["dtype"] == r1["dtype"] == f"torch.{dt}"
    assert r0["value"] == r1["value"] and r0["grad"] == r1["grad"]
    assert abs(r0["value"] - want["value"]) <= GRAD_REL[dt] * abs(
        want["value"])
    assert _rel(r0["grad"], want["grad"]) <= GRAD_REL[dt]


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's adjoint value_and_grad of the same circuit on a
    mesh of 4 of its CPU devices, f32 and f64."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from quest_tpu import adjoint as JAD
    from quest_tpu.env import AMP_AXIS
    from quest_tpu_torch.entry import tfim_sum
    codes, coeffs = tfim_sum(W.GRAD_N)
    jmesh = Mesh(np.array(jax.devices()[:4]), (AMP_AXIS,))
    jc = to_reference(W.grad_circuit())
    out = {}
    for dt in ("float32", "float64"):
        fn = JAD.value_and_grad(jc, codes, coeffs=coeffs, mesh=jmesh,
                                engine="adjoint", dtype=np.dtype(dt))
        theta = np.asarray(fn.initial_params, dtype=dt)
        v, g = fn(jnp.asarray(theta))
        out[dt] = (float(v), np.asarray(g, dtype=np.float64))
    return out


@pytest.mark.parametrize("case", CASE_IDS)
def test_gradients_hold_the_jax_package(gradients_run, jax_grads, case):
    """Each engine on the process mesh within 5e-6 (f64) / 5e-5 (f32) of
    the JAX package's sharded adjoint walk."""
    _, recs, _, _ = gradients_run
    dt = case.split("-")[1]
    jv, jg = jax_grads[dt]
    for rec in recs:
        got = rec["grads"][case]
        assert abs(got["value"] - jv) <= JAX_TOL[dt]
        np.testing.assert_allclose(got["grad"], jg, rtol=0,
                                   atol=JAX_TOL[dt])


def test_gradient_exchanges_equal_the_prediction_and_the_jax_prediction(
        gradients_run, hosts2):
    """The adjoint walk's issued exchanges, cross-process ones included,
    equal fn.comm_record (predict_vjp_collectives under the mesh's
    topology), with QUEST_EXCHANGE_SLICES_DCI=2 too; at the default
    slicing that record equals the JAX package's prediction."""
    from quest_tpu import adjoint as JAD
    from quest_tpu.ops import expec as JE
    from quest_tpu_torch.entry import tfim_sum
    _, recs, _, _ = gradients_run
    n = W.GRAD_N
    codes, _ = tfim_sum(n)
    jprog, _ = JAD.build_circuit_program(to_reference(W.grad_circuit()),
                                         False)
    jplan = JE.plan_expec(JE.parse_pauli_sum(codes, n), n, density=False)
    want = JAD.predict_vjp_collectives(jprog, jplan, 4)
    for rec in recs:
        for case in ("adjoint-float32", "adjoint-float64"):
            issued = rec["grads"][case]["issued"]
            pred = rec["grads"][case]["predicted"]
            assert pred == want
            assert issued["collective_permutes"] == \
                pred["collective_permutes"]
            assert issued["all_to_alls"] == pred["all_to_alls"]
            assert issued["all_reduces"] == pred["all_reduces"] == 2
        sliced = rec["dci_sliced"]
        assert sliced["issued"]["collective_permutes"] == \
            sliced["predicted"]["collective_permutes"] > \
            want["collective_permutes"]
    assert recs[0]["dci_sliced"] == recs[1]["dci_sliced"]
    for case in ("taped-float32", "taped-float64"):
        assert recs[0]["grads"][case]["predicted"] is None
        assert recs[0]["grads"][case]["issued"] == \
            recs[1]["grads"][case]["issued"]


def test_the_engine_resolves_on_a_process_mesh(gradients_run):
    """QUEST_ADJOINT 0 / 1 and auto (the capacity model against
    QUEST_HBM_BYTES) pick the engine on a process mesh as on one
    register, and both engines give one gradient."""
    _, recs, _, _ = gradients_run
    for rec in recs:
        res = rec["resolved"]
        assert [res[k][0] for k in ("0-None", "1-None", f"auto-{1 << 40}",
                                    f"auto-{1 << 16}")] == \
            ["taped", "adjoint", "taped", "adjoint"]
        assert _rel(res["0-None"][2], res["1-None"][2]) <= 1e-6
    assert recs[0]["resolved"] == recs[1]["resolved"]


def test_autograd_through_the_sharded_expectation_on_a_process_mesh(
        gradients_run):
    """expec_sharded over the process mesh tapes through the cross-process
    flip exchange and the reduce: each rank's shard gradients and both
    ranks' coefficient gradient equal the one-process mesh's."""
    from quest_tpu_torch.entry import tfim_sum
    from quest_tpu_torch.ops import expec as E
    root, recs, _, _ = gradients_run
    n = W.GRAD_N
    codes, coeffs = tfim_sum(n)
    mesh = make_amp_mesh(4, devices=["cpu"] * 4)
    x = shard_planes(W.expec_state(n), mesh, n)
    for s in x.shards:
        s.requires_grad_(True)
    cf = torch.tensor(coeffs, requires_grad=True)
    plan = E.plan_expec(E.parse_pauli_sum(codes, n), n, density=False)
    val = E.expec_sharded(x, cf, plan)
    grads = torch.autograd.grad(val, x.shards + [cf])
    for rec in recs:
        assert abs(rec["expec"]["value"] - float(val.detach())) <= 1e-12
        np.testing.assert_allclose(rec["expec"]["cf_grad"],
                                   grads[-1].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(both(root, "expec-grad"),
                               torch.cat(grads[:-1], -1).numpy(), rtol=0,
                               atol=1e-12)


def test_the_process_mesh_exchanges_carry_gradients(gradients_run):
    """The pair exchange and the all-to-all of a process mesh are
    autograd Functions: each block's gradient is the weight its receiver
    (in this process or the other) gave it, and the all-to-all still
    delivers block [d][k] to shard k."""
    _, recs, _, _ = gradients_run
    D = 4
    for r, rec in enumerate(recs):
        ex = rec["exchange_grads"]
        mine = (2 * r, 2 * r + 1)
        assert ex["permute"] == {str(d): 10.0 * (d ^ 2) + 1.0 for d in mine}
        assert ex["all_to_all"] == {f"{d},{k}": float(100 * k + d)
                                    for d in mine for k in range(D)}
        assert ex["received"] == {f"{k},{d}": float(d * D + k)
                                  for k in mine for d in range(D)}


def test_autotune_plans_equal_on_both_ranks_and_one_process(gradients_run):
    """plan.autotune(mesh=<process mesh>) prices from constants, so both
    ranks return the same plan with no collective, and it is the
    one-process autotune(devices=4) under the mesh's topology (one host
    a process)."""
    from quest_tpu_torch import plan as PL
    _, recs, _, _ = gradients_run
    assert recs[0]["plan"] == recs[1]["plan"]
    want = PL.autotune(W.grad_circuit(), devices=4, persist=False,
                       topology=TCM.Topology(hosts=2), device="cpu")
    assert recs[0]["plan"] == W.plan_record(want)
    assert recs[0]["plan"]["devices"] == 4


def test_save_sharded_across_processes_round_trips(gradients_run):
    """A process-mesh save loads bit for bit onto the ranks' mesh, onto a
    one-process mesh of the same shard count and onto one register; the
    parent's one-process save loads onto the process mesh."""
    from quest_tpu_torch import checkpoint as ckpt
    root, _, crecs, want = gradients_run
    state = both(root, "ckpt-state")
    np.testing.assert_allclose(state, want, rtol=0, atol=1e-6)
    path = os.path.join(root, "ckpt-torn")
    one = ckpt.load_sharded(path, mesh=make_amp_mesh(4, devices=["cpu"] * 4))
    np.testing.assert_array_equal(one.amps.gather("cpu").numpy(), state)
    reg = ckpt.load_sharded(path, device="cpu")
    np.testing.assert_array_equal(reg.amps.reshape(2, -1).numpy(), state)
    np.testing.assert_array_equal(both(root, "ckpt-from-one"), want)
    for name in ("ckpt-torn", "ckpt-over"):
        assert sorted(os.listdir(os.path.join(root, name))) == sorted(
            ["qureg_meta.json"] + [f"shard-{d}.npz" for d in range(4)])
    assert not [e for e in os.listdir(root)
                if ".tmp" in e or ".old-" in e]
    for r, rec in enumerate(crecs):
        assert rec["round_trip_equal"] is True
        assert rec["overwrite_equal"] is True
        assert rec["pending"] == "PendingCheckpoint"
        assert rec["from_one_shards"] == [2 * r, 2 * r + 1]


def test_a_fault_mid_save_commits_nothing(gradients_run):
    """Rank 1 fails between its shards and its stamp: rank 0's save
    fails typed at its timeout, nothing is committed, the directory is
    refused typed, and the retried save commits and sweeps the torn
    one's files."""
    _, _, crecs, _ = gradients_run
    assert [rec["torn_raised"] for rec in crecs] == ["CheckpointError",
                                                     "InjectedFault"]
    for rec in crecs:
        assert rec["torn_committed"] is False
        assert rec["torn_load"] == "CheckpointError"
        assert rec["torn_dirs_left"] == []


def test_back_to_back_saves_return_committed_on_every_rank(gradients_run):
    """Both ranks race for the commit of each of SAVE_LOOP saves into one
    directory; each rank loads right after its save returns, with no
    barrier, and reads that very save; no tmp or old dir is left."""
    root, _, crecs, _ = gradients_run
    for rec in crecs:
        assert rec["loop_equal"] == [True] * W.SAVE_LOOP
        assert rec["loop_left"] == []
    assert sorted(os.listdir(os.path.join(root, "ckpt-loop"))) == sorted(
        ["qureg_meta.json"] + [f"shard-{d}.npz" for d in range(4)])


# -- a dead or absent peer ---------------------------------------------------


def test_a_dead_peer_fails_the_survivor_typed(tmp_path):
    rcs, outs = run_ranks("peer-dies", str(tmp_path), timeout=30.0)
    assert rcs[1] == 0, outs[1][-2000:]
    assert rcs[0] == 0, outs[0][-3000:]
    assert "typed ok" in outs[0] and "ProcessGroupError" in outs[0]


def test_an_absent_peer_fails_the_join_typed(tmp_path):
    rcs, outs = run_ranks("engines", str(tmp_path), ranks=(0,), timeout=5.0)
    assert rcs[0] == 3, outs[0][-3000:]
    assert "ProcessGroupError" in outs[0]
    assert "engines ok" not in outs[0]


# -- in this process ---------------------------------------------------------


def test_process_mesh_needs_a_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    with pytest.raises(ProcessGroupError, match="init_process_group"):
        TM.make_process_mesh(["cpu"])


def test_a_group_of_one_is_the_one_process_mesh(tmp_path):
    """A mesh over a one-member gloo group is today's AmpMesh: the same
    key, programs and records, and the comm planner stays flat."""
    import datetime
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        pm = TM.make_process_mesh(["cpu"] * 4)
        one = AmpMesh(["cpu"] * 4)
        assert pm.key == one.key and pm.world == 1
        assert TCM.topology(4, pm) == TCM.FLAT
        c = random_circuit(8, 4, seed=3)
        xs = []
        for mesh in (pm, one):
            x = shard_planes(base(8), mesh, 8)
            prog = S.compile_circuit_sharded_banded(c.ops, 8, False, mesh)
            mesh.recorder.reset()
            prog(x)
            xs.append((x.gather("cpu"), mesh.recorder.events))
        np.testing.assert_array_equal(xs[0][0].numpy(), xs[1][0].numpy())
        assert xs[0][1] == xs[1][1]
    finally:
        dist.destroy_process_group()


def test_topology_follows_the_planned_mesh(monkeypatch):
    """Unset, the topology is one host per process of the mesh being
    planned (its dry copy keeps the count); a one-process mesh, a mesh of
    another size and planning without a mesh price flat; the knob
    overrides."""
    monkeypatch.delenv("QUEST_COMM_TOPOLOGY", raising=False)
    spanning = AmpMesh(["meta"] * 8, dry=True)
    spanning.hosts = 2                       # as a 2-process mesh's copy
    dry = spanning.dry_copy()
    assert dry.hosts == 2 and dry.world == 1
    topo = TCM.topology(8, dry)
    assert topo.hosts == 2 and topo.hierarchical
    assert TCM.topology(16, dry) == TCM.FLAT  # not this mesh's size
    assert TCM.topology(8) == TCM.FLAT
    assert TCM.topology(8, AmpMesh(["cpu"] * 8)) == TCM.FLAT
    monkeypatch.setenv("QUEST_COMM_TOPOLOGY", "0")
    assert TCM.topology(8, dry) == TCM.FLAT
    monkeypatch.setenv("QUEST_COMM_TOPOLOGY", "hosts=4")
    assert TCM.topology(8).hosts == 4


def test_a_process_mesh_names_its_group_in_its_key():
    mesh = AmpMesh(["cpu"] * 2)
    assert mesh.key == ("cpu", "cpu")
    assert list(mesh.local_ids) == [0, 1] and mesh.devices == \
        mesh.local_devices
    assert mesh.world == 1 and mesh.owner(1) == 0
