"""quest-lint over the PyTorch port (quest_tpu_torch.analysis).

The port's tree is clean under its own analyzer; every rule fires on a
seeded violation and stays quiet on its clean twin (the fixtures mirror
tests/test_lint.py); the suppression grammar and the CLI are the
reference's; and on shared lock and atomic-write fixtures the port's
QL005, QL007 and QL008 report the (rule, line) pairs of
quest_tpu.analysis.lint.run_lint.
"""

import json
import os
import re
import textwrap
import tokenize

import pytest

from quest_tpu.analysis import lint as JL

from quest_tpu_torch.analysis import JAX_RULES, RULES, run_lint
from quest_tpu_torch.analysis import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.dtype_agnostic


def _fixture(tmp_path, source, name="bad.py", package="quest_tpu_torch",
             sub="ops"):
    """Write `source` as a module of a synthetic package under tmp_path
    (module-keyed rules apply to package files only); returns its path."""
    pkg = tmp_path / package / sub if sub else tmp_path / package
    pkg.mkdir(parents=True, exist_ok=True)
    f = pkg / name
    f.write_text(textwrap.dedent(source))
    return f


def _lint(tmp_path, source, **kw):
    f = _fixture(tmp_path, source, **kw)
    return run_lint([str(f)], root=str(tmp_path))


def _pairs(vs, rule=None):
    return sorted((v.rule, v.line) for v in vs
                  if rule is None or v.rule == rule)


# ---------------------------------------------------------------------------
# the shipped tree and the catalog
# ---------------------------------------------------------------------------


def test_port_tree_is_lint_clean():
    """`python -m quest_tpu_torch.analysis` exits 0 on its default
    paths (in-process)."""
    violations = run_lint(cli.default_paths())
    assert not violations, "\n".join(v.render(REPO) for v in violations)


def test_default_paths_are_the_ports_own():
    paths = [os.path.relpath(p, REPO) for p in cli.default_paths()]
    assert paths[0] == "quest_tpu_torch"
    assert "chip_smoke.py" in paths
    assert os.path.join("scripts", "profile_torch_submit.py") in paths
    tests = [p for p in paths if p.startswith("tests")]
    assert tests and all(os.path.basename(p).startswith("test_torch_")
                         for p in tests)
    assert not any(p.split(os.sep)[0] == "quest_tpu" for p in paths)


def test_rule_catalog_is_the_non_jax_rules():
    assert set(RULES) == {"QL001", "QL004", "QL005", "QL007", "QL008",
                          "QL009"}
    assert set(JAX_RULES) == {"QL002", "QL003", "QL006"}
    assert set(RULES) | set(JAX_RULES) == set(JL.RULES)


@pytest.mark.parametrize("rule", ["QL002", "QL003", "QL006"])
def test_jax_rules_are_refused_with_the_reason(rule, capsys):
    with pytest.raises(ValueError, match="JAX-specific"):
        run_lint([os.path.join(REPO, "quest_tpu_torch", "env.py")],
                 rules=[rule])
    with pytest.raises(SystemExit) as e:
        cli.main(["--rules", rule, os.path.join(REPO, "chip_smoke.py")])
    assert e.value.code == 2
    assert "JAX-specific" in capsys.readouterr().err


def test_unknown_rule_is_refused():
    with pytest.raises(ValueError, match="unknown rule"):
        run_lint([os.path.join(REPO, "quest_tpu_torch", "env.py")],
                 rules=["QL099"])


def test_rule_subset_filtering():
    paths = [os.path.join(REPO, "quest_tpu_torch", "serve", "metrics.py")]
    only = run_lint(paths, rules=["QL001", "QL004"])
    assert not [v for v in only if v.rule not in {"QL001", "QL004"}]


# ---------------------------------------------------------------------------
# QL001: program builders
# ---------------------------------------------------------------------------


def test_ql001_catches_an_unkeyed_read_in_a_cached_build(tmp_path):
    """The stale-program bug: a runtime knob read inside the build
    handed to _cached (and one reached through a helper), which
    engine_mode_key does not carry."""
    vs = _lint(tmp_path, """
        from quest_tpu_torch.env import knob_value

        def helper():
            return knob_value("QUEST_HBM_BYTES")

        class Circuit:
            def compiled(self, n):
                def build():
                    if knob_value("QUEST_PLAN_CACHE"):
                        return n
                    return helper()
                return self._cached(("pergate", n), build)
    """)
    assert _pairs(vs) == [("QL001", 5), ("QL001", 10)], vs


def test_ql001_lambda_and_named_builder_roots(tmp_path):
    """A lambda handed to _cached and the named builders
    (ops/segment.prepare_segment) are roots too."""
    vs = _lint(tmp_path, """
        from quest_tpu_torch.env import knob_value

        def run(circuit, n):
            return circuit._cached(("host", n),
                                   lambda: knob_value("QUEST_NATIVE_LIB2"))

        def prepare_segment(stages):
            return knob_value("QUEST_SERVE_MAX_BATCH")
    """, name="segment.py")
    assert _pairs(vs, "QL001") == [("QL001", 6), ("QL001", 9)], vs


def test_ql001_clean_twin_keyed_and_unreached_reads(tmp_path):
    """Keyed and import_once knobs may be read in a build; a runtime
    knob read outside every builder is not a QL001 concern."""
    vs = _lint(tmp_path, """
        from quest_tpu_torch.env import knob_value

        def serve_config():
            return knob_value("QUEST_SERVE_MAX_BATCH")

        class Circuit:
            def compiled_fused(self, n):
                def build():
                    lib = knob_value("QUEST_NATIVE_LIB")
                    return knob_value("QUEST_FUSED_DRIVER"), lib
                return self._cached(("fused", n), build)
    """)
    assert not vs, vs


# ---------------------------------------------------------------------------
# QL004: loud knobs
# ---------------------------------------------------------------------------


def test_ql004_catches_unregistered_and_bypassing_reads(tmp_path):
    vs = _lint(tmp_path, """
        import os

        def configure():
            a = os.environ.get("QUEST_NOT_A_KNOB")
            b = os.environ.get("QUEST_SERVE_MAX_BATCH", "x")
            c = os.environ._data.get(b"QUEST_SCHEDULE")
            return a, b, c
    """)
    by_line = {v.line: v for v in vs if v.rule == "QL004"}
    assert set(by_line) == {5, 6, 7}, vs
    assert "not registered" in by_line[5].message
    assert "bypasses" in by_line[6].message
    assert "encoded environment" in by_line[7].message


def test_ql004_clean_twin_and_the_sanctioned_encoded_read(tmp_path):
    """Registry reads are clean; env.py itself may read the encoded
    environment (engine_mode_key's read, declared in the rule)."""
    assert not _lint(tmp_path, """
        from quest_tpu_torch.env import knob_value

        def configure():
            return knob_value("QUEST_SERVE_MAX_BATCH")
    """)
    assert not _lint(tmp_path, """
        import os

        _ENV_DATA = os.environ._data

        def engine_mode_key():
            return _ENV_DATA.get(b"QUEST_SCHEDULE"), os.environ.get(
                "QUEST_SCHEDULE")
    """, name="env.py", sub=None)


def test_ql004_driver_code_needs_registration_only(tmp_path):
    """Scripts and tests may read the environment raw, but only
    registered QUEST_* names."""
    f = tmp_path / "tool.py"
    f.write_text("import os\n"
                 "a = os.environ.get('QUEST_SERVE_MAX_BATCH')\n"
                 "b = os.environ.get('QUEST_NOT_A_KNOB')\n")
    vs = run_lint([str(f)], root=str(tmp_path))
    assert _pairs(vs) == [("QL004", 3)], vs


# ---------------------------------------------------------------------------
# QL005: lock discipline
# ---------------------------------------------------------------------------

_QL005_SRC = """
    import threading

    class Engine:
        _GUARDED_BY = {"_lock": ("_pending", "_closed")}

        def __init__(self):
            self._lock = threading.Lock()
            self._pending = 0
            self._closed = False

        def submit(self):
            self._pending += 1        # unlocked write

        def ok_locked(self):
            with self._lock:
                self._pending -= 1
                self._bump()

        def _bump(self):
            self._closed = True       # held helper: clean
"""


def test_ql005_catches_unlocked_touch_of_guarded_attr(tmp_path):
    assert _pairs(_lint(tmp_path, _QL005_SRC)) == [("QL005", 13)]


def test_ql005_clean_twin_owner_thread_and_alias_groups(tmp_path):
    vs = _lint(tmp_path, """
        import threading

        class Engine:
            _GUARDED_BY = {
                "_lock|_cond": ("_pending",),
                "<owner-thread>": ("_stats",),
            }

            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition(self._lock)
                self._pending = 0
                self._stats = {}

            def via_cond(self):
                with self._cond:
                    self._pending += 1

            def owner_only(self):
                self._stats["x"] = 1
    """)
    assert not vs, vs


def test_ql005_requires_a_declaration_on_lock_owners(tmp_path):
    vs = _lint(tmp_path, """
        import threading

        class Bare:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = []

        class Partial:
            _GUARDED_BY = {"_lock": ("_q",)}

            def __init__(self):
                self._lock = threading.Lock()
                self._q = []
                self._other = 0

            def poke(self):
                with self._lock:
                    self._other = 1
    """)
    msgs = [v.message for v in vs if v.rule == "QL005"]
    assert any("declares no _GUARDED_BY" in m for m in msgs), vs
    assert any("missing from _GUARDED_BY" in m for m in msgs), vs


# ---------------------------------------------------------------------------
# QL007: blocking under a lock, in torch terms
# ---------------------------------------------------------------------------


def test_ql007_catches_device_syncs_sleeps_and_socket_io(tmp_path):
    vs = _lint(tmp_path, """
        import threading
        import time

        import torch

        class Engine:
            _GUARDED_BY = {"_lock": ("_q",)}

            def __init__(self, sock):
                self._lock = threading.Lock()
                self._q = []
                self._sock = sock

            def poll(self, x, ev):
                with self._lock:
                    x.item()
                    x.cpu()
                    x.numpy()
                    x.tolist()
                    torch.cuda.synchronize()
                    ev.synchronize()
                    self._sock.sendall(b"x")
                    self._sock.recv(4)
                time.sleep(0.1)           # outside: clean
                x.item()

            def drain(self):
                with self._lock:
                    self._flush()

            def _flush(self):
                time.sleep(0.5)           # held helper: propagated
                open("f", "w")
    """)
    assert _pairs(vs) == [("QL007", line) for line in
                          (17, 18, 19, 20, 21, 22, 23, 24, 33, 34)], vs


def test_ql007_clean_twin(tmp_path):
    vs = _lint(tmp_path, """
        import threading

        import torch

        class Engine:
            _GUARDED_BY = {"_lock": ("_q",)}

            def __init__(self):
                self._lock = threading.Lock()
                self._q = []

            def stage(self, x):
                with self._lock:
                    self._q.append(x)
                    job = self._q.pop()
                torch.cuda.synchronize()
                return job.cpu().numpy()
    """)
    assert not vs, vs


# ---------------------------------------------------------------------------
# QL008: atomic writes in the persistence modules
# ---------------------------------------------------------------------------

_QL008_SRC = """
    import json
    import os

    def save_meta(directory, meta):
        with open(os.path.join(directory, "meta.json"), "w") as fh:
            json.dump(meta, fh)

    def save_meta_atomic(directory, meta):
        path = os.path.join(directory, "meta.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, path)
"""


@pytest.mark.parametrize("module", ["checkpoint.py", "plan.py",
                                    "resilience/durable.py"])
def test_ql008_catches_bare_write_in_persistence_module(tmp_path, module):
    sub, _, name = module.rpartition("/")
    vs = _lint(tmp_path, _QL008_SRC, name=name, sub=sub or None)
    assert _pairs(vs) == [("QL008", 6)], vs


def test_ql008_clean_twin_outside_persistence_modules(tmp_path):
    assert not _lint(tmp_path, _QL008_SRC, name="qasm.py", sub=None)


# ---------------------------------------------------------------------------
# QL009: the fault-site catalog
# ---------------------------------------------------------------------------


def test_ql009_catches_a_literal_outside_the_catalog(tmp_path):
    vs = _lint(tmp_path, """
        from quest_tpu_torch.resilience import faults

        def hot(x):
            if faults.ACTIVE:
                faults.check("serve.not_a_real_site", x=x)
            faults.check("serve.dispatch", x=x)
            return x
    """)
    assert _pairs(vs) == [("QL009", 6)], vs


def test_ql009_catches_unfired_and_unarmed_catalog_entries(tmp_path):
    res = tmp_path / "quest_tpu_torch" / "resilience"
    res.mkdir(parents=True)
    (res / "faults.py").write_text(
        'SITES = ("serve.dispatch", "serve.ghost")\n')
    eng = tmp_path / "quest_tpu_torch" / "engine.py"
    eng.write_text(textwrap.dedent("""
        from quest_tpu_torch.resilience import faults

        def dispatch(x):
            faults.check("serve.dispatch", x=x)
            return x
    """))
    tdir = tmp_path / "tests"
    tdir.mkdir()
    (tdir / "test_torch_faults.py").write_text(
        "def test_dispatch(plan):\n"
        "    plan.inject('serve.dispatch', times=1)\n")
    vs = run_lint([str(tmp_path / "quest_tpu_torch"), str(tdir)],
                  root=str(tmp_path))
    ghost = [v for v in vs if v.rule == "QL009"]
    assert len(ghost) == 2 and all("serve.ghost" in v.message
                                   for v in ghost), vs
    # the clean twin: the ghost fired and armed
    eng.write_text(eng.read_text() + textwrap.dedent("""
        def ghost():
            faults.check("serve.ghost")
    """))
    (tdir / "test_torch_faults.py").write_text(
        "def test_dispatch(plan):\n"
        "    plan.inject('serve.dispatch', times=1)\n"
        "    plan.inject('serve.ghost', times=1)\n")
    assert not run_lint([str(tmp_path / "quest_tpu_torch"), str(tdir)],
                        root=str(tmp_path))


# ---------------------------------------------------------------------------
# the suppression grammar
# ---------------------------------------------------------------------------


def test_suppression_comments(tmp_path):
    assert not _lint(tmp_path, """
        import os

        def configure():
            return os.environ.get("QUEST_NOT_A_KNOB")  # quest-lint: disable=QL004
    """)
    assert not _lint(tmp_path, """
        # quest-lint: disable-file=QL004
        import os

        def configure():
            return os.environ.get("QUEST_NOT_A_KNOB")
    """, name="bad2.py")


def test_reasoned_escape_suppresses_the_next_line(tmp_path):
    src = _QL005_SRC.replace(
        "            self._pending += 1        # unlocked write",
        "            # quest-lint: disable=QL005(a counted racy bump)\n"
        "            self._pending += 1")
    assert not _lint(tmp_path, src)


def test_unused_reasoned_suppression_is_flagged(tmp_path):
    vs = _lint(tmp_path, """
        import os

        def fine():
            # quest-lint: disable=QL004(reads a registered knob, honest)
            return 1

        def also_fine():
            # quest-lint: disable=QL004
            return 2
    """)
    assert [v.rule for v in vs] == ["QL004"], vs
    assert "unused suppression" in vs[0].message


def test_the_ports_escapes_are_all_reasoned_and_line_scoped():
    """Every escape in the package names its reason (so a stale one is
    flagged as unused) and none is file-wide."""
    spec = re.compile(r"quest-lint:\s*(disable(?:-file)?)=(.*)")
    found = 0
    for root, _, names in os.walk(os.path.join(REPO, "quest_tpu_torch")):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                comments = [t.string for t in
                            tokenize.generate_tokens(f.readline)
                            if t.type == tokenize.COMMENT]
            for line in comments:
                m = spec.search(line)
                if not m:
                    continue
                found += 1
                assert m.group(1) == "disable", (path, line)
                assert re.fullmatch(r"(QL\d{3}\([^)]+\)[, ]*)+",
                                    m.group(2).strip()), (path, line)
    assert found >= 15


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _bad_and_good(tmp_path):
    pkg = tmp_path / "quest_tpu_torch"
    pkg.mkdir()
    bad = pkg / "bad.py"
    bad.write_text("import os\n\n"
                   "def f():\n"
                   "    return os.environ.get('QUEST_NOT_A_KNOB')\n")
    good = pkg / "good.py"
    good.write_text("X = 1\n")
    return bad, good


def test_cli_exit_codes(tmp_path, capsys):
    bad, good = _bad_and_good(tmp_path)
    assert cli.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "QL004" in out and "quest-lint: 1 violation in 1 path(s)" in out
    assert cli.main([str(good)]) == 0
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in (*RULES, *JAX_RULES))
    assert cli.main(["--rules", "QL005", str(bad)]) == 0


def test_cli_json_format_schema(tmp_path, capsys):
    bad, good = _bad_and_good(tmp_path)
    assert cli.main(["--format", "json", str(bad)]) == 1
    records = json.loads(capsys.readouterr().out)
    assert records and all(
        list(r) == ["rule", "path", "line", "col", "message"]
        for r in records)
    assert (records[0]["rule"], records[0]["line"]) == ("QL004", 4)
    assert cli.main(["--format", "json", str(good)]) == 0
    assert json.loads(capsys.readouterr().out) == []


# ---------------------------------------------------------------------------
# the cross-check against the reference's analyzer
# ---------------------------------------------------------------------------

_SHARED_LOCK_SRC = """
    import subprocess
    import threading
    import time

    class Fleet:
        _GUARDED_BY = {"_lock|_cond": ("_pending", "_closed"),
                       "<owner-thread>": ("_seen",)}

        def __init__(self):
            self._lock = threading.RLock()
            self._cond = threading.Condition(self._lock)
            self._pending = []
            self._closed = False
            self._seen = 0
            self._extra = 0

        def submit(self, r):
            self._pending.append(r)
            with self._cond:
                self._pending.append(r)
                self._route(r)

        def _route(self, r):
            self._closed = bool(r)
            time.sleep(0.01)

        def close(self):
            self._closed = True
            self._extra = 1
            with self._lock:
                subprocess.run(["true"])
                open("log", "a")
                self._seen += 1

        @property
        def state(self):
            # quest-lint: disable=QL005(racy flag read)
            return self._closed
"""


@pytest.mark.parametrize("rule", ["QL005", "QL007"])
def test_lock_rules_agree_with_the_reference(tmp_path, rule):
    ref = _fixture(tmp_path / "ref", _SHARED_LOCK_SRC, package="quest_tpu")
    port = _fixture(tmp_path / "port", _SHARED_LOCK_SRC)
    want = _pairs(JL.run_lint([str(ref)], rules=[rule],
                              root=str(tmp_path / "ref")))
    got = _pairs(run_lint([str(port)], rules=[rule],
                          root=str(tmp_path / "port")))
    assert got == want and want, (got, want)


def test_atomic_write_rule_agrees_with_the_reference(tmp_path):
    src = textwrap.dedent(_QL008_SRC) + textwrap.dedent("""
        def nested(directory, meta):
            def write(p):
                with open(p, "w") as fh:
                    json.dump(meta, fh)
            tmp = os.path.join(directory, "x.tmp")
            write(tmp)
            os.rename(tmp, os.path.join(directory, "x"))

        def text(directory):
            from pathlib import Path
            p = Path(directory, "y")
            p.write_text("y")
    """)
    for mod in ("checkpoint.py", "plan.py"):
        ref = _fixture(tmp_path / "ref", src, name=mod, package="quest_tpu",
                       sub=None)
        port = _fixture(tmp_path / "port", src, name=mod, sub=None)
        want = _pairs(JL.run_lint([str(ref)], rules=["QL008"],
                                  root=str(tmp_path / "ref")))
        got = _pairs(run_lint([str(port)], rules=["QL008"],
                              root=str(tmp_path / "port")))
        assert got == want == [("QL008", 6), ("QL008", 27)], (mod, got)
