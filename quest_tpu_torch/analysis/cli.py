"""Command-line front end of the port's quest-lint
(python -m quest_tpu_torch.analysis), with the exit codes and JSON
schema of quest_tpu/analysis/cli.py."""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Sequence

from quest_tpu_torch.analysis.lint import (JAX_RULES, RULES, check_rules,
                                          run_lint)


def default_paths() -> List[str]:
    """The port's package, its tests (tests/test_torch_*.py),
    scripts/profile_torch_submit.py and chip_smoke.py of the checkout
    holding the package. Never the JAX package or its tests: the
    reference's analyzer checks those against its own registry."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(pkg)
    out = [pkg]
    out += sorted(glob.glob(os.path.join(repo, "tests", "test_torch_*.py")))
    for extra in (os.path.join("scripts", "profile_torch_submit.py"),
                  "chip_smoke.py"):
        p = os.path.join(repo, extra)
        if os.path.isfile(p):
            out.append(p)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quest_tpu_torch.analysis",
        description="quest-lint over the PyTorch/CUDA port: program-cache "
                    "keys, knob parsing, lock discipline, atomic writes and "
                    "fault sites (QL001, QL004, QL005, QL007-QL009)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: the "
                         "port's package, tests/test_torch_*.py, "
                         "scripts/profile_torch_submit.py, chip_smoke.py)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset, e.g. QL001,QL004")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULES.items()):
            print(f"{rule}  {doc}")
        for rule, why in sorted(JAX_RULES.items()):
            print(f"{rule}  ({why})")
        return 0

    rules = None
    if args.rules:
        try:
            rules = check_rules([r.strip() for r in args.rules.split(",")
                                 if r.strip()])
        except ValueError as e:
            ap.error(str(e))

    paths = list(args.paths) or default_paths()
    violations = run_lint(paths, rules=rules)

    if args.format == "json":
        # the reference's schema: exactly these keys, in this order,
        # sorted by (path, line, col, rule) like the text form
        print(json.dumps([{"rule": v.rule, "path": v.path,
                           "line": v.line, "col": v.col,
                           "message": v.message}
                          for v in violations], indent=2))
    else:
        for v in violations:
            print(v.render(root=os.getcwd()))
        n = len(violations)
        print(f"quest-lint: {n} violation{'s' if n != 1 else ''} in "
              f"{len(paths)} path(s)")
    return 1 if violations else 0
