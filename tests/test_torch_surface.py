"""The port's package surface in the reference's calling conventions
(quest_tpu/__init__.py, state.py, env.py, measurement.py, precision.py):
constructors in the reference's positional order, QuESTEnv taking a
device list first, sample's `num_shots`, the default-dtype pair, and
every name the reference's package binds present on quest_tpu_torch."""

import ast
import os

import numpy as np
import pytest
import torch

import quest_tpu
import quest_tpu as qt

import quest_tpu_torch as qtt
from quest_tpu_torch import api
from quest_tpu_torch import env as TE
from quest_tpu_torch import measurement as MS
from quest_tpu_torch import precision
from quest_tpu_torch import state as TS
from quest_tpu_torch.parallel.mesh import ShardedAmps

pytestmark = pytest.mark.dtype_agnostic

CPU = TE.QuESTEnv("cpu")


@pytest.fixture
def restore_default_dtype():
    before = precision.get_default_dtype()
    yield
    precision.set_default_dtype(before)


def test_constructors_take_the_reference_order():
    q = qtt.create_qureg(6, CPU)
    assert q.num_qubits == 6 and q.amps.dtype == torch.float32
    assert q.amps.device.type == "cpu"
    rho = qtt.create_density_qureg(3, CPU, np.complex128)
    assert rho.is_density and rho.amps.dtype == torch.float64
    want = qt.create_density_qureg(3, None, np.complex128)
    np.testing.assert_array_equal(TS.to_dense(rho), qt.state.to_dense(want))
    q64 = TS.create_qureg(4, None, np.complex128, device="cpu")
    assert q64.amps.dtype == torch.float64
    with pytest.raises(TypeError):
        TS.create_qureg(4, None, np.complex64, "cpu")   # device is keyword


def test_quest_env_takes_a_device_list_first():
    env = qtt.QuESTEnv(["cpu", "cpu"])
    assert env.num_ranks == 2 and env.mesh.size == 2
    q = qtt.create_qureg(4, env)
    assert isinstance(q.amps, ShardedAmps)
    assert qtt.calc_total_prob(q) == pytest.approx(1.0)
    one = qtt.QuESTEnv("cpu")
    assert one.num_ranks == 1 and one.device == torch.device("cpu")
    assert qtt.QuESTEnv(["cpu"]).num_ranks == 1
    assert qtt.create_quest_env(["cpu"] * 4).num_ranks == 4
    assert qtt.QuESTEnv(torch.device("cpu")).device.type == "cpu"
    with pytest.raises(NotImplementedError, match="A10c"):
        qtt.QuESTEnv(["cpu"], True)
    with pytest.raises(TypeError):
        qtt.QuESTEnv(["cpu"], device="cpu")     # one way to name a device


def test_sample_names_its_count_num_shots():
    q = qtt.create_qureg(3, CPU)
    qtt.gates.hadamard(q, 0)
    got = qtt.sample(q, num_shots=64,
                     generator=torch.Generator().manual_seed(0))
    assert got.shape == (64,) and set(got.tolist()) <= {0, 1}
    assert MS.sample(q, 8).shape == (8,)


def test_default_dtype_sets_planes_and_precision(restore_default_dtype):
    assert qtt.get_default_dtype() == np.dtype(np.complex64)
    assert api.QuESTPrecision() == 1
    qtt.set_default_dtype(np.complex128)
    assert qtt.create_qureg(3, CPU).amps.dtype == torch.float64
    assert qtt.create_density_qureg(2, CPU).amps.dtype == torch.float64
    assert api.createQureg(3, api.createQuESTEnv(devices="cpu")) \
        .state.amps.dtype == torch.float64
    assert api.QuESTPrecision() == 2
    with pytest.raises(ValueError, match="complex64 or complex128"):
        qtt.set_default_dtype(np.float32)
    qtt.set_default_dtype(np.complex64)
    assert api.QuESTPrecision() == 1
    assert qtt.create_qureg(3, CPU).amps.dtype == torch.float32


def _reference_bound_names():
    """Every name quest_tpu/__init__.py binds (its imports and
    assignments)."""
    path = os.path.join(os.path.dirname(quest_tpu.__file__), "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return sorted(names)


@pytest.mark.parametrize("name", _reference_bound_names())
def test_reference_top_level_name_is_exported(name):
    assert hasattr(qtt, name), name
    if name in qtt._LAZY:
        assert getattr(qtt, name).__name__ == f"quest_tpu_torch.{name}"
    assert name in qtt.__all__ or name == "__version__"
