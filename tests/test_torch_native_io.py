"""The native routes of the port against the reference: the CSV state
writer and reader behind api.reportState / initStateFromSingleFile, the
MT19937 stream of random_, and explain()'s host line.

The reference writes state_rank_0.csv through its native writer when the
library is built and in Python otherwise; the two give the same bytes
(checked below, so the port is held to both). The port's file equals the
reference's byte for byte on either of its own paths, at f32 and f64 and
on a density register, including the sign of amplitudes that round to
zero. Without the library the port takes its Python paths and says so
once per process.
"""

import contextlib
import time
import warnings

import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits as _blas_limit
except ImportError:          # no control over BLAS threads: leave them
    def _blas_limit(limits):
        return contextlib.nullcontext()

from quest_tpu import api as JQ
from quest_tpu import circuit as JC
from quest_tpu import native as JN
from quest_tpu import random_ as JR
from quest_tpu import state as JS

from quest_tpu_torch import api as Q
from quest_tpu_torch import circuit as TC
from quest_tpu_torch import native as TN
from quest_tpu_torch import random_ as TR
from quest_tpu_torch import state as TS

pytestmark = pytest.mark.dtype_agnostic

ENV = Q.createQuESTEnv(devices="cpu")
CSV = "state_rank_0.csv"
DRAWS = 10 ** 4
SEEDS = ([1, 2, 3], [20261018], [0xFFFFFFFF, 7, 1 << 31, 12345])


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """Pin numpy's BLAS and torch to one thread while this module runs
    (the suite runs several workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with _blas_limit(1):
        yield
    torch.set_num_threads(threads)


def _reference_library(wait_s: float = 180.0) -> bool:
    """Whether the JAX package's native library loads in this process,
    its load retried for up to `wait_s` seconds. That package builds the
    library with `make -C native` at its first use in a process and,
    when the build fails, keeps the failure for the rest of the process.
    Test workers that first use it at once build it at once: each `make`
    links the same temporary file and renames it, and a worker whose
    rename finds the file gone fails its build, although a peer's
    library is there a moment later. Each retry loads what a peer built,
    or builds it again."""
    deadline = time.monotonic() + wait_s
    while not JN.available() and time.monotonic() < deadline:
        time.sleep(1.0)
        JN._lib_tried = False
    return JN.available()


@pytest.fixture(scope="module")
def libs():
    if not (TN.available() and _reference_library()):
        pytest.fail(f"the native libraries do not load here: port "
                    f"{TN.unavailable_reason()}, reference "
                    f"{JN.available()}")


@contextlib.contextmanager
def _without_library(monkeypatch, reason="no C++ compiler (test)"):
    """The port as on a machine where the library cannot load, until
    the block ends."""
    with monkeypatch.context() as m:
        m.setattr(TN, "_lib", None)
        m.setattr(TN, "_tried", True)
        m.setattr(TN, "_reason", reason)
        m.setattr(TN, "_degrade_warned", False)
        yield


def _amps(n, seed):
    """A random normalised state whose every 7th amplitude is tiny, so
    that some rows print as -0.000000000000."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 1 << n))
    v[:, ::7] *= 1e-14
    return v / np.sqrt((v ** 2).sum())


def _registers(kind, dtype, n, seed):
    v = _amps(n, seed)
    if kind == "sv":
        mine = Q.Qureg(TS.create_qureg(n, dtype=dtype, device="cpu"), ENV)
        ref = JQ.Qureg(JS.create_qureg(n, dtype=dtype))
        for api, q in ((Q, mine), (JQ, ref)):
            api.initStateFromAmps(q, v[0], v[1])
    else:
        mine = Q.Qureg(TS.create_density_qureg(n, dtype=dtype,
                                               device="cpu"), ENV)
        ref = JQ.Qureg(JS.create_density_qureg(n, dtype=dtype))
        w = _amps(2 * n, seed + 1)
        for api, q in ((Q, mine), (JQ, ref)):
            api.setDensityAmps(q, w[0], w[1])
    return mine, ref


def _reference_text(ref, tmp_path, native: bool = True) -> str:
    """The reference's state_rank_0.csv of `ref`, through its native
    writer or (native False) its Python path."""
    saved = JN.available
    if not native:
        JN.available = lambda: False
    try:
        JQ.reportState(ref)
    finally:
        JN.available = saved
    return (tmp_path / CSV).read_text()


# ---------------------------------------------------------------------------
# reportState / initStateFromSingleFile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sv", "dm"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["f32", "f64"])
def test_reference_writers_agree(libs, tmp_path, monkeypatch, kind, dtype):
    """The reference's native writer and its Python path write the same
    bytes, so the port has one file to equal."""
    monkeypatch.chdir(tmp_path)
    _, ref = _registers(kind, dtype, 5, 11)
    native = _reference_text(ref, tmp_path)
    python = _reference_text(ref, tmp_path, native=False)
    assert native == python
    assert native.count("-0.000000000000") > 0


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", ["sv", "dm"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["f32", "f64"])
def test_report_state_equals_reference_byte_for_byte(
        libs, tmp_path, monkeypatch, route, kind, dtype):
    monkeypatch.chdir(tmp_path)
    mine, ref = _registers(kind, dtype, 5, 3)
    want = _reference_text(ref, tmp_path)
    if route == "python":
        with _without_library(monkeypatch):
            with pytest.warns(RuntimeWarning, match="reportState"):
                Q.reportState(mine)
    else:
        Q.reportState(mine)
    got = (tmp_path / CSV).read_text()
    assert got == want
    assert got.splitlines()[0] == "real, imag"
    assert len(got.splitlines()) == 1 + mine.state.num_amps


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", ["sv", "dm"])
def test_init_state_reads_the_reference_file(libs, tmp_path, monkeypatch,
                                             route, kind):
    monkeypatch.chdir(tmp_path)
    mine, ref = _registers(kind, np.complex128, 5, 5)
    _reference_text(ref, tmp_path)
    want = np.loadtxt(tmp_path / CSV, delimiter=",", skiprows=1)
    fresh = Q.Qureg((TS.create_qureg if kind == "sv"
                     else TS.create_density_qureg)(
        5, dtype=np.complex128, device="cpu"), ENV)
    if route == "python":
        with _without_library(monkeypatch):
            with pytest.warns(RuntimeWarning):
                assert Q.initStateFromSingleFile(fresh, CSV)
    else:
        assert Q.initStateFromSingleFile(fresh, CSV)
    got = fresh.state.amps.reshape(2, -1).numpy()
    assert np.array_equal(got.T, want)
    assert Q.compareStates(fresh, mine, 1e-11)
    assert not Q.initStateFromSingleFile(fresh, "missing.csv")


def test_chunked_report_round_trips(libs, tmp_path, monkeypatch):
    """A register of many slices: the first written, the rest appended;
    the file equals the one-slice file and reads back to the state."""
    monkeypatch.chdir(tmp_path)
    mine, _ = _registers("sv", np.complex128, 9, 7)
    Q.reportState(mine)
    whole = (tmp_path / CSV).read_text()
    monkeypatch.setattr(Q, "REPORT_CHUNK_AMPS", 48)
    Q.reportState(mine)
    assert (tmp_path / CSV).read_text() == whole
    back = Q.Qureg(TS.create_qureg(9, dtype=np.complex128, device="cpu"),
                   ENV)
    assert Q.initStateFromSingleFile(back, CSV)
    assert Q.compareStates(back, mine, 1e-11)


def test_native_csv_functions(libs, tmp_path):
    path = str(tmp_path / "x.csv")
    re = np.linspace(-1, 1, 10)
    im = re[::-1] * 0.5
    assert TN.write_state_csv(path, re[:4], im[:4])
    assert TN.append_state_csv(path, re[4:], im[4:])
    got = TN.read_state_csv(path, 10)
    assert got is not None
    assert np.allclose(got[0], re, atol=1e-12)
    assert np.allclose(got[1], im, atol=1e-12)
    assert TN.read_state_csv(path, 11) is None
    assert TN.read_state_csv(str(tmp_path / "none.csv"), 1) is None
    assert TN.write_state_csv(path, re, im, header=False)
    assert open(path).readline() == "-1.000000000000, 0.500000000000\n"


def test_degrade_path_warns_once_with_the_reason(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mine, _ = _registers("sv", np.complex64, 3, 1)
    with _without_library(monkeypatch, "g++ missing (test)"):
        assert not TN.available()
        assert TN.unavailable_reason() == "g++ missing (test)"
        assert not TN.write_state_csv(CSV, [0.0], [0.0])
        assert TN.read_state_csv(CSV, 1) is None
        with pytest.warns(RuntimeWarning, match=r"g\+\+ missing \(test\)"):
            Q.reportState(mine)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Q.reportState(mine)
            TR.seed_quest([1, 2])
            assert Q.initStateFromSingleFile(mine, CSV)
        assert TR._use_native is False
    TR.seed_quest([1, 2])
    assert TR._use_native is True


# ---------------------------------------------------------------------------
# the MT19937 stream
# ---------------------------------------------------------------------------


def _words(mod, seeds):
    mod.seed_quest(seeds)
    return [mod.uint32() for _ in range(DRAWS)]


def _uniforms(mod, seeds):
    mod.seed_quest(seeds)
    return [mod.uniform() for _ in range(DRAWS)]


@pytest.mark.parametrize("seeds", SEEDS, ids=["three", "one", "wide"])
def test_native_and_python_streams_equal_the_reference(libs, monkeypatch,
                                                       seeds):
    ref_words, ref_unif = _words(JR, seeds), _uniforms(JR, seeds)
    assert _words(TR, seeds) == ref_words and TR._use_native
    assert _uniforms(TR, seeds) == ref_unif
    with _without_library(monkeypatch):
        with pytest.warns(RuntimeWarning, match="MT19937"):
            words = _words(TR, seeds)
        assert not TR._use_native
        assert words == ref_words
        assert _uniforms(TR, seeds) == ref_unif


# ---------------------------------------------------------------------------
# explain()'s host line
# ---------------------------------------------------------------------------


def _circuit(mod, n):
    c = mod.Circuit(n)
    for q in range(n):
        c.h(q)
    c.cnot(0, n - 1).rz(2, 0.3).cphase(0.4, 1, n - 2).rx(n - 1, 0.7)
    return c


@pytest.mark.parametrize("n", [6, 11])
def test_explain_host_line_equals_the_reference(libs, n):
    want = _circuit(JC, n).explain().splitlines()
    got = _circuit(TC, n).explain().splitlines()
    host = [ln for ln in want if ln.startswith("  cpu fallback ")]
    assert len(host) == 1 and want[-1] == host[0]
    assert got[-1] == host[0]


def test_explain_omits_the_host_line_without_the_library(monkeypatch):
    with _without_library(monkeypatch):
        lines = _circuit(TC, 6).explain().splitlines()
    assert not [ln for ln in lines if "cpu fallback" in ln]
