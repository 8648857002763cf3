"""Build the segment kernel (quest_tpu_torch/csrc/segment.cu) with nvcc at
first use and load it with ctypes.

The source becomes a shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`), named by a hash of its source and flags, in `build/` at the
root of the checkout (listed in .gitignore). A library already built
from the same source is loaded as it is.

One variant besides the kernel itself: COUNTERS, the same source built
with -DQUEST_PHASE_COUNTERS, whose blocks add the clock cycles of their
phases (operator-slice waits and releases, step prologues, the chain,
K3's stores) to device counters that quest_tpu_torch.profiling reads.
`build` compiles the variants it is given side by side, one nvcc each,
holding an exclusive lock on build/quest_tpu_torch/.build.lock while it
does (`build_lock`), so processes that start at once build a library
once: the others wait and load it. A process that sets BUILD_ALLOWED to
False (a serving fleet's card worker, serve/worker_main.py) never
compiles: a library that is not built yet raises BuildError there.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "segment.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "quest_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL: Tuple[str, ...] = ()                     # the kernel's own defines
COUNTERS: Tuple[str, ...] = ("-DQUEST_PHASE_COUNTERS",)

BUILD_LOG = ""                     # nvcc's output for KERNEL, when built here
BUILDS = 0                         # libraries this process compiled
BUILD_ALLOWED = True               # False: load what exists, never compile
_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}
_ACTIVE: Tuple[str, ...] = KERNEL


class BuildError(RuntimeError):
    """The kernel library could not be built: no nvcc, or nvcc failed."""


def nvcc_path() -> str:
    """The CUDA compiler: nvcc on PATH, else the toolkit's default
    location. Raises BuildError when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise BuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "quest_tpu_torch are built at first use on a machine with the CUDA "
        "toolkit")


def library_path(defines: Sequence[str] = KERNEL) -> Path:
    """Where the library built from SOURCE with `defines` lives: keyed by
    a hash of the source and the flags, so an edit rebuilds."""
    flags = " ".join((*NVCC_FLAGS, *defines))
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode()).hexdigest()
    return BUILD_DIR / f"libsegment-{digest[:16]}.so"


def build(*variants: Sequence[str]) -> float:
    """Build the library of each variant (defines; none given: KERNEL)
    that does not exist yet, one nvcc process each, all at once; return
    the wall seconds (0.0 when nothing was built). Raises BuildError
    with nvcc's output when a build fails."""
    variants = tuple(tuple(v) for v in variants) or (KERNEL,)
    if all(library_path(v).exists() for v in variants):
        return 0.0
    if not BUILD_ALLOWED:
        raise BuildError(
            f"the {SOURCE.name} library is not built and this process may "
            f"not compile it (a serving worker loads what its parent "
            f"built): {[str(library_path(v)) for v in variants]}")
    with build_lock():
        # another process may have built them while this one waited
        todo = [v for v in variants if not library_path(v).exists()]
        return _build_locked(todo) if todo else 0.0


@contextlib.contextmanager
def build_lock():
    """An exclusive lock on BUILD_DIR/.build.lock for the block: the
    kernel's and the native host library's builds hold it. The operating
    system releases it when its holder exits, however it exits."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_locked(todo) -> float:
    global BUILD_LOG, BUILDS
    t0 = time.perf_counter()
    procs = []
    for v in todo:
        out = library_path(v)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((v, out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *v, "-o", str(tmp), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for v, out, tmp, proc in procs:
        log = proc.communicate()[0]
        if v == KERNEL:
            BUILD_LOG = log
        if proc.returncode != 0:
            failed.append(f"{' '.join(v) or 'kernel'}: nvcc exited "
                          f"{proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)     # atomic: readers never see half a file
            BUILDS += 1
    if failed:
        raise BuildError(f"CUDA build of {SOURCE.name} failed: "
                           + "\n".join(failed))
    return time.perf_counter() - t0


def load(defines: Optional[Sequence[str]] = None) -> ctypes.CDLL:
    """The loaded library of `defines` (None: the active variant, KERNEL
    unless `active` says otherwise), building it first if needed."""
    key = _ACTIVE if defines is None else tuple(defines)
    if key not in _LIBS:
        build(key)
        _LIBS[key] = ctypes.CDLL(str(library_path(key)))
    return _LIBS[key]


@contextlib.contextmanager
def active(defines: Sequence[str]):
    """Within the block, launches through ops.segment use the library of
    `defines` (e.g. COUNTERS)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, tuple(defines)
    try:
        yield load()
    finally:
        _ACTIVE = before
