"""Find a piece of the benchmark by the name BENCHMARK.json or a mix file
gives it: `portbench/<folder>/<name>.py`, loaded once a process. A
later cell that needs a new job kind, generator, engine or metric adds
its file; no file that is there is edited.

  kinds/<kind>.py            a mix's "kind": `Job`, how one job runs
                             through the port's public API, its readout,
                             and how what it produced is compared
  generators/<generator>.py  a mix's "generator": `generate(n, mix, seed)`,
                             the frozen inputs of every job
  engines/<engine>.py        a configuration's "engine": `build` and
                             `apply` of a circuit through the port
  metrics/<metric>.py        a metric of BENCHMARK.json: `read(record)`
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def module(folder: str, name: str):
    """The module of portbench/<folder>/<name>.py."""
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    key = (f"portbench_{folder}_"
           + name.replace(".", "_dot_").replace("-", "_dash_"))
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
