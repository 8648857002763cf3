"""ctypes bindings to the native host runtime (native/quest_host.cpp and
native/host_kernels.cpp), built from the checkout at first use.

A port of quest_tpu/native.py. The two C++ sources become one shared
library (`g++ -O3 -march=native -funroll-loops -fPIC -std=c++17
-shared`) in `build/quest_tpu_torch/` at the root of the checkout (listed
in .gitignore, beside the segment kernel's libraries), named by a digest
of the sources, the compiler and the flags, so an edit rebuilds. The
library is linked to a temporary name and renamed into place, so a
process that already mapped an older one keeps a valid mapping; the
build holds the kernel build's file lock (ops/_build.build_lock), so
processes that start at once compile it once. A process that sets
BUILD_ALLOWED to False (a serving fleet's card worker) never compiles.
Nothing is ever written into `native/`.

QUEST_NATIVE_LIB names a library to load instead (it is used as it is,
never rebuilt). A library built here is checked against this machine's
CPU: -march=native ties it to the ISA it was built on, so its name holds
a digest of /proc/cpuinfo's flags (a build directory copied from another
machine builds anew), and one whose `qh_isa_requirements` names an
extension this CPU lacks is rebuilt rather than run into an illegal
instruction.

What it binds: the blocked gate-program runner and the measurement
kernels the host engine calls (host.py), the reference-exact MT19937
(init_by_array seeding, genrand_int32 / genrand_real1 draws) that
random_.py draws from, and the CSV state writer and reader behind
api.reportState / initStateFromSingleFile (`write_state_csv`,
`append_state_csv`, `read_state_csv`, ref quest_tpu/native.py:201-246).

When the library cannot be built or loaded, `available()` is False and
`unavailable_reason()` says why; the host engine then raises
HostEngineUnsupported naming that reason. The MT19937 and CSV callers
keep their Python paths, which give the same words and the same file,
and say so once per process (`warn_degraded`). Nothing falls back
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from quest_tpu_torch.env import knob_value

REPO = Path(__file__).resolve().parents[1]
SOURCES = (REPO / "native" / "quest_host.cpp",
           REPO / "native" / "host_kernels.cpp")
BUILD_DIR = REPO / "build" / "quest_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC",
             "-std=c++17", "-shared")
BUILD_TIMEOUT_S = 300

BUILD_SECONDS = 0.0            # wall seconds of this process's build, if any
BUILD_ALLOWED = True           # False: load what exists, never compile
_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason: Optional[str] = None
_lock = threading.Lock()
_degrade_warned = False


def compiler() -> Optional[str]:
    """The C++ compiler: $CXX, else g++ or c++ on PATH (None: none)."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _cpu_flags() -> str:
    """The first 'flags' line of /proc/cpuinfo ('' where unreadable)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path() -> Path:
    """Where the library built from SOURCES lives: keyed by a digest of
    the sources, the compiler's path, the flags and this CPU's ISA flags
    (-march=native builds for the CPU it runs on, so a build directory
    copied to another machine builds anew there)."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join((compiler() or "", *CXX_FLAGS, _cpu_flags())).encode())
    return BUILD_DIR / f"libquest_host-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> float:
    """Build the library unless it exists (or `force`); return the wall
    seconds spent (0.0 when nothing was built). Raises RuntimeError with
    the compiler's output when the build fails."""
    out = library_path()
    if out.exists() and not force:
        return 0.0
    from quest_tpu_torch.ops._build import BuildError, build_lock
    if not BUILD_ALLOWED:
        raise BuildError(
            f"the native host library {out} is not built and this process "
            f"may not compile it (a serving worker loads what its parent "
            f"built)")
    with build_lock():
        # another process may have built it while this one waited
        if out.exists() and not force:
            return 0.0
        return _build_locked(out)


def _build_locked(out: Path) -> float:
    global BUILD_SECONDS
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES)], capture_output=True,
                          text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host build failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)        # a new inode: mapped copies stay valid
    BUILD_SECONDS = time.perf_counter() - t0
    return BUILD_SECONDS


def _missing_isa(lib: ctypes.CDLL) -> list:
    """ISA extensions the library was built with that this CPU lacks
    (ref quest_tpu/native.py:63): empty when it may run here."""
    try:
        fn = lib.qh_isa_requirements
    except AttributeError:
        return ["qh_isa_requirements"]     # predates the tag
    fn.restype = ctypes.c_char_p
    have = set(_cpu_flags().split())
    if not have:
        return []              # the CPU cannot be read: assume it fits
    return [r for r in fn().decode().split() if r not in have]


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the signatures of every symbol the port calls (an
    AttributeError means the library predates one of them)."""
    i32p, dp = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)
    lib.qh_init_by_array.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                     ctypes.c_int]
    lib.qh_genrand_int32.restype = ctypes.c_uint32
    lib.qh_genrand_real1.restype = ctypes.c_double
    for bits, fp in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        p = ctypes.POINTER(fp)
        fn = getattr(lib, f"qh_run_program_{bits}")
        fn.argtypes = [p, p, ctypes.c_int, i32p, ctypes.c_int64, dp, i32p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"qh_prob0_sv_{bits}")
        fn.argtypes = [p, p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_double
        fn = getattr(lib, f"qh_prob0_dm_{bits}")
        fn.argtypes = [p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_double
        for kind in ("sv", "dm"):
            fn = getattr(lib, f"qh_collapse_{kind}_{bits}")
            fn.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_double]
            fn.restype = None
    lib.qh_write_state_csv.argtypes = [ctypes.c_char_p, dp, dp,
                                       ctypes.c_longlong, ctypes.c_int]
    lib.qh_write_state_csv.restype = ctypes.c_int
    lib.qh_append_state_csv.argtypes = [ctypes.c_char_p, dp, dp,
                                        ctypes.c_longlong]
    lib.qh_append_state_csv.restype = ctypes.c_int
    lib.qh_read_state_csv.argtypes = [ctypes.c_char_p, dp, dp,
                                      ctypes.c_longlong]
    lib.qh_read_state_csv.restype = ctypes.c_longlong


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    return lib


def _load_locked() -> ctypes.CDLL:
    """The bound library; raises RuntimeError naming why there is none."""
    override = knob_value("QUEST_NATIVE_LIB")
    if override:
        path = Path(override)
        try:
            lib = _open(path)
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"QUEST_NATIVE_LIB={path} cannot be "
                               f"loaded: {e}") from None
        missing = _missing_isa(lib)
        if missing:
            raise RuntimeError(f"QUEST_NATIVE_LIB={path} needs {missing}, "
                               f"which this CPU lacks")
        return lib
    path = library_path()
    if path.exists():
        try:
            lib = _open(path)
            if not _missing_isa(lib):
                return lib
        except (OSError, AttributeError):
            pass
        build(force=True)      # stale or built for another CPU
    else:
        build()
    lib = _open(path)
    missing = _missing_isa(lib)
    if missing:
        raise RuntimeError(f"the library built here needs {missing}, "
                           f"which this CPU lacks")
    return lib


def load() -> ctypes.CDLL:
    """The native library, built and bound on the first call. Raises
    RuntimeError naming the reason when it cannot be built or loaded
    (the reason is kept: later calls raise it again without retrying)."""
    global _lib, _tried, _reason
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load_locked()
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _reason = str(e)
        if _lib is None:
            raise RuntimeError(_reason)
        return _lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def unavailable_reason() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    return None if available() else _reason


def warn_degraded(what: str) -> None:
    """Say once per process that `what` takes its Python path because
    the library is unavailable, naming unavailable_reason() (ref
    quest_tpu/native.py:36-52): the results are the same, the speed is
    not, and a silent fallback would hide a dead toolchain."""
    global _degrade_warned
    with _lock:
        if _degrade_warned:
            return
        _degrade_warned = True
    warnings.warn(f"quest_tpu_torch native host library unavailable "
                  f"({unavailable_reason()}): {what} takes the Python "
                  f"path (same results, slower; set QUEST_NATIVE_LIB or "
                  f"install a C++ compiler)", RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# MT19937 (mt19937ar.c): the stream random_.py reproduces in Python
# ---------------------------------------------------------------------------


def init_by_array(seeds) -> None:
    arr = (ctypes.c_uint32 * len(seeds))(
        *[int(s) & 0xFFFFFFFF for s in seeds])
    load().qh_init_by_array(arr, len(seeds))


def genrand_int32() -> int:
    """One 32-bit word of the native stream."""
    return int(load().qh_genrand_int32())


def genrand_real1() -> float:
    """One uniform in [0, 1] of the native stream."""
    return float(load().qh_genrand_real1())


# ---------------------------------------------------------------------------
# CSV state IO (the reference's reportState text: "real, imag" header,
# "%.12f, %.12f" rows; ref quest_tpu/native.py:201-246)
# ---------------------------------------------------------------------------


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_state_csv(path: str, re, im, header: bool = True) -> bool:
    """Write the rows of (re, im) to `path` (truncating it), with the
    header line when `header`. False when the library is unavailable or
    the write failed."""
    if not available():
        return False
    re, im = _f64(re), _f64(im)
    return load().qh_write_state_csv(
        os.fsencode(path), _ptr(re), _ptr(im), re.size,
        1 if header else 0) == 0


def append_state_csv(path: str, re, im) -> bool:
    """Append rows to an existing CSV: a large register streams to disk
    in bounded slices, the first through write_state_csv and the rest
    through this. False when unavailable or the write failed."""
    if not available():
        return False
    re, im = _f64(re), _f64(im)
    return load().qh_append_state_csv(
        os.fsencode(path), _ptr(re), _ptr(im), re.size) == 0


def read_state_csv(path: str,
                   num_amps: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(re, im) float64 arrays of the first `num_amps` rows of `path`
    (a header line is skipped), or None when the library is unavailable,
    the file cannot be opened or it holds fewer rows."""
    if not available():
        return None
    re = np.empty(num_amps, dtype=np.float64)
    im = np.empty(num_amps, dtype=np.float64)
    got = load().qh_read_state_csv(os.fsencode(path), _ptr(re), _ptr(im),
                                   num_amps)
    return (re, im) if got == num_amps else None
