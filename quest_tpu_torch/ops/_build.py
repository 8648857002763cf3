"""Build the segment kernel (quest_tpu_torch/csrc/segment.cu) with nvcc at
first use and load it with ctypes.

The source becomes a shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`), named by a hash of its source and flags, in `build/` at the
root of the checkout (listed in .gitignore). A library already built
from the same source is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "segment.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "quest_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOG = ""                     # nvcc's output, when built in this process
_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: nvcc on PATH, else the toolkit's default
    location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "quest_tpu_torch are built at first use on a machine with the CUDA "
        "toolkit")


def library_path() -> Path:
    """Where the library built from SOURCE lives: keyed by a hash of the
    source and the flags, so an edit rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsegment-{digest[:16]}.so"


def build() -> float:
    """Build the library unless it exists; return nvcc's seconds (0.0
    when nothing was built). Raises RuntimeError with nvcc's output when
    the build fails."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    BUILD_LOG = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {SOURCE.name} failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)             # atomic: readers never see half a file
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library, building it first if needed."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(library_path()))
    return _LIB
