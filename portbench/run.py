"""The benchmark's command:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process runs one cell of
BENCHMARK.json on the CUDA card and prints one JSON line last; without
the cards the cell asks for it exits non-zero and prints no result.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402

os.environ.update(harness.cache_env(ROOT))
sys.exit(harness.main(t_start=T_START))
