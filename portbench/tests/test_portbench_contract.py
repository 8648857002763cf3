"""The benchmark's contract, on the CPU: BENCHMARK.json's shape, what the
harness and the reference import, the run without a card, cells, kinds,
generators, engines and metrics found by name, and the result line's
keys."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PY = sys.executable


def small(name):
    """A width a CPU test holds, by the cell's register."""
    cell = harness.load_cell(name, ROOT)
    return 5 if cell.config["register"] == "density" else 11


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 1200 + 24 * 180 + (2 + 14 * 24) * (rs + 60) <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        names.add(c["name"])
    used, pairs = set(), set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        harness.load_cell(w["name"], ROOT)          # its files exist
    assert used == names
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells and harness._listed(e2e[m["moves"]], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        got = {m["name"] for m in harness.load_cell(w, ROOT).end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert harness.load_cell(w, ROOT).per_layer
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _modules_after(code):
    out = subprocess.run([PY, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import json, sys, time
        from pathlib import Path
        from portbench import harness, readings, devtrace
        for name in {sorted(w['name'] for w in BENCH['workloads'])!r}:
            cell = harness.load_cell(name, Path('.'))
            n = 5 if cell.config['register'] == 'density' else 11
            harness.run_cell(name, 5, 0.2, True, root=Path('.'),
                             t_start=time.time(), device='cpu', qubits=n)
            for m in cell.end_to_end + cell.per_layer:
                harness.reader(m['name'])
        print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
        """)
    top = _modules_after(code)
    assert "quest_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import json, sys\n"
            "import portbench.reference.circuits, portbench.reference.core\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    top = _modules_after(code)
    assert not top & {"quest_tpu_torch", *harness.FORBIDDEN}


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [PY, "portbench/run.py", "--workload", BENCH["workloads"][0]["name"],
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout and "job_ms" not in out.stdout
    assert "CUDA card" in out.stderr


def _bare_copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_run_in_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    root = _bare_copy(tmp_path)
    code = ("import sys, time; from pathlib import Path\n"
            f"sys.path[:0] = [{str(root)!r}]\n"
            "from portbench import harness\n"
            f"harness.run_cell({BENCH['workloads'][0]['name']!r}, 1, 0.2, False,"
            f" root=Path({str(root)!r}), t_start=time.time(), device='cpu',"
            " qubits=11)\n"
            "print('{}')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([PY, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "quest_tpu_torch" in out.stderr


def test_new_config_mix_limits_and_metric_are_found_by_name(tmp_path):
    root = _bare_copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "sv30.json").read_text())
    (pb / "configs" / "sv12.json").write_text(json.dumps(dict(cfg, qubits=12)))
    mix = json.loads((pb / "mixes" / "rcs_d20.json").read_text())
    (pb / "mixes" / "rcs_d2.json").write_text(json.dumps(dict(mix, depth=2)))
    (pb / "limits" / "sv12.rcs_d2.json").write_text(
        (pb / "limits" / "sv30.rcs_d20.json").read_text())
    (pb / "metrics" / "jobs_done.py").write_text(
        "def read(rec):\n    return rec.jobs\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sv12", "source": "test",
                             "file": "portbench/configs/sv12.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sv12.rcs_d2", "config": "sv12",
                               "traffic": "rcs_d2", "chips": 1, "why": "test"})
    job_ms, = (m for m in bench["end_to_end"] if m["name"] == "job_ms")
    job_ms["workloads"].append("sv12.rcs_d2")
    bench["per_layer"].append({"name": "jobs_done", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "job_ms",
                               "workloads": ["sv12.rcs_d2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time; from pathlib import Path\n"
            f"sys.path[:0] = [{str(root)!r}]\n"
            f"sys.path.append({str(ROOT)!r})\n"
            "from portbench import harness\n"
            f"root = Path({str(root)!r})\n"
            "cell = harness.load_cell('sv12.rcs_d2', root)\n"
            "assert harness.HERE == root / 'portbench'\n"
            "assert cell.config['qubits'] == 12 and cell.mix['depth'] == 2\n"
            "assert [m['name'] for m in cell.end_to_end] == ['job_ms', 'setup_s']\n"
            "assert [m['name'] for m in cell.per_layer][-1] == 'jobs_done'\n"
            "assert harness.reader('jobs_done')(harness.Record(jobs=3)) == 3\n"
            "r = harness.run_cell('sv12.rcs_d2', 3, 0.2, False, root=root,"
            " t_start=time.time(), device='cpu')\n"
            "print(json.dumps(r['correct']))")
    out = subprocess.run([PY, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) is True


NEW_KIND = {
    "generators/ry_ladder.py": """
        from portbench.traffic import stream

        def generate(n, mix, seed):
            a = stream(seed, "angles").uniform(0, 6.28, size=(mix["depth"], n))
            gates = []
            for row in a:
                gates += [("ry", q, float(t)) for q, t in enumerate(row)]
                gates += [("cz", q, q + 1) for q in range(n - 1)]
            return gates
        """,
    "engines/banded.py": """
        evolution = "banded"

        def build(circuit, nbits, density, device, iters=1):
            circuit.compiled_banded(nbits, density, iters=iters, device=device)

        def apply(circuit, q):
            return circuit.apply_banded(q)
        """,
    "kinds/norm.py": """
        import numpy as np
        import torch
        from portbench import counting, traffic, workloads
        from portbench.reference import CONTROL, TRUTH
        from portbench.reference import circuits as R

        class Job(workloads.Job):
            def __init__(self, config, mix, seed, device):
                super().__init__()
                self.n, self.device = int(config["qubits"]), torch.device(device)
                self.engine = workloads.engine(config)
                self.gates = traffic.generate(self.n, mix, seed)
                self.work = counting.circuit_work(self.gates, self.n, False, 1)

            def build(self):
                from quest_tpu_torch.circuit import Circuit
                self.circuit = Circuit(self.n)
                for g in self.gates:
                    getattr(self.circuit, g[0])(*g[1:])
                self.engine.build(self.circuit, self.n, False, self.device)

            def start(self):
                from quest_tpu_torch import state as ST
                self.q = ST.create_qureg(self.n, dtype=np.complex64,
                                         device=self.device)

            def job(self, keep=True):
                from quest_tpu_torch import calculations as K
                from quest_tpu_torch import state as ST
                self.q = self.engine.apply(self.circuit, ST.init_zero_state(self.q))
                rec = {"norm": K.calc_total_prob(self.q)}
                if keep:
                    self.records.append(rec)

            def output(self):
                return {"state": self.q.amps, "records": self.records}

            def control_output(self, jobs):
                psi = R.run_statevector(R.zero_state(self.n, CONTROL, self.device),
                                        self.n, self.gates, CONTROL)
                return {"state": psi, "records": [{"norm": 1.0}] * jobs}

            def compare(self, out):
                psi = R.run_statevector(R.zero_state(self.n, TRUTH, self.device),
                                        self.n, self.gates, TRUTH)
                return {"state_err": workloads.rel_l2(out["state"], psi),
                        "norm_err": max(abs(r["norm"] - 1) for r in out["records"])}
        """,
    "mixes/ry_ladder.json": '{"kind": "norm", "generator": "ry_ladder", "depth": 2}',
    "configs/sv9b.json": json.dumps({
        "name": "sv9b", "source": "test", "register": "statevector",
        "qubits": 9, "precision": "complex64", "matmul_tier": "highest",
        "engine": "banded", "reduced": [], "assumed": []}),
    "limits/sv9b.ry_ladder.json": '{"state_err": 1e-5, "norm_err": 1e-5}',
}


def test_a_new_kind_generator_and_engine_need_only_new_files(tmp_path):
    root = _bare_copy(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    for rel, text in NEW_KIND.items():
        assert not (pb / rel).exists()
        (pb / rel).write_text(textwrap.dedent(text))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sv9b", "source": "test",
                             "file": "portbench/configs/sv9b.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sv9b.ry_ladder", "config": "sv9b",
                               "traffic": "ry_ladder", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time; from pathlib import Path\n"
            f"sys.path[:0] = [{str(root)!r}]\n"
            f"sys.path.append({str(ROOT)!r})\n"
            "from portbench import harness\n"
            "r = harness.run_cell('sv9b.ry_ladder', 2 ** 31 + 5, 0.2, False,"
            f" root=Path({str(root)!r}), t_start=time.time(), device='cpu')\n"
            "print(json.dumps([r['correct'], sorted(r['checks'])]))")
    out = subprocess.run([PY, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == \
        [True, ["norm_err", "state_err"]]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_engine_with_no_file_is_refused_not_replaced():
    from portbench import workloads
    cell = harness.load_cell("sv30.rcs_d20", ROOT)
    with pytest.raises(FileNotFoundError, match="engines/sharded_fused.py"):
        workloads.make(dict(cell.config, engine="sharded_fused"), cell.mix,
                       1, "cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_and_checks_last(trace):
    name = BENCH["workloads"][0]["name"]
    r = harness.run_cell(name, 2 ** 31 + 3, 0.2, bool(trace), root=ROOT,
                         t_start=time.time(), device="cpu",
                         qubits=small(name))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(r) == want + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["metrics"] == {}                  # no device number off the card
    assert r["device"]["platform"] == "cpu"
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    log, out = io.StringIO(), io.StringIO()
    harness.report(r, log=log, out=out)
    assert json.loads(out.getvalue().splitlines()[-1]) == r
    tail = log.getvalue().splitlines()[-len(r["checks"]):]
    assert [t.split()[1] for t in tail] == list(r["checks"])
    assert all(" limit " in t for t in tail)
