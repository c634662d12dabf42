"""ctypes bindings for the native (C++) tim reader and writer.

Counterpart of ``pta_replicator_tpu/io/native.py``. The source is the
repository's ``csrc/fast_tim.cpp``: it is compiled at first use with
``g++ -O3 -fPIC -shared`` into ``pta_replicator_tpu_torch/_build/``, under
a name made from a hash of the source and the flags (as
``kernels/build.py`` names its CUDA builds, so an edited source rebuilds),
and loaded with ``ctypes``. There is no quiet fallback: a missing source,
a missing compiler or a failed build raises. The Python parser in
``io/tim.py`` runs only when the caller asks for it, or for a file that
holds a stateful directive (INCLUDE/SKIP/NOSKIP/TIME/EFAC/EQUAD), which
the native scanner hands back with a negative count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
#: the native tim scanner and writer, shared with the JAX package
SOURCE = PACKAGE_DIR.parent / "csrc" / "fast_tim.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")

ERR_OPEN = -1
DIRECTIVE_FOUND = -2
ERR_TEXT_OVERFLOW = -3
ERR_WRITE = -4

_LOCK = threading.Lock()
_LOADED: dict = {}


def library_path(source: Path = None) -> Path:
    """Where the library of ``source`` (default :data:`SOURCE`) is built."""
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfast_tim-{digest[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f64 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS") for t in (np.int64, np.float64))
    lib.fast_tim_count.restype = ctypes.c_int64
    lib.fast_tim_count.argtypes = [ctypes.c_char_p]
    lib.fast_tim_parse.restype = ctypes.c_int64
    lib.fast_tim_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64, f64, f64, f64,
                                   ctypes.c_char_p, ctypes.c_int64]
    lib.fast_tim_write.restype = ctypes.c_int64
    lib.fast_tim_write.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64, i64, ctypes.c_char_p]
    return lib


def load_library(source: Path = None) -> ctypes.CDLL:
    """Build ``source`` (default :data:`SOURCE`) unless its library is
    already built, load it once per process, and return it. The library
    appears atomically, so concurrent processes never load a half-written
    file. Raises ``RuntimeError`` when the source or the compiler is
    missing or the build fails."""
    source = Path(source or SOURCE)
    if not source.is_file():
        raise RuntimeError(f"native tim reader: source {source} is missing")
    target = library_path(source)
    with _LOCK:
        if target in _LOADED:
            return _LOADED[target]
        if not target.exists():
            cxx = shutil.which(CXX)
            if cxx is None:
                raise RuntimeError(
                    f"native tim reader: compiler {CXX!r} not found on PATH; it builds "
                    f"{source.name} at first use (read_tim(..., use_native=False) "
                    "asks for the Python parser)"
                )
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                                      capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"native tim reader: {CXX} failed on {source.name}:\n{proc.stderr}"
                    )
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = _bind(ctypes.CDLL(str(target)))
        _LOADED[target] = lib
        return lib


def fast_read_tim(path: str):
    """Parse a plain tim file natively.

    Returns ``(mjd_longdouble, errors_s, freqs_mhz, labels, observatories,
    flag_strings)``, or None when the scanner hands the file back (a
    negative count: a stateful directive, or a file it cannot open), for
    the Python parser. A parse that stops short raises ``OSError``."""
    lib = load_library()
    n = lib.fast_tim_count(path.encode())
    if n < 0:
        return None
    mjd_day = np.empty(n, dtype=np.int64)
    mjd_frac = np.empty(n, dtype=np.float64)
    err_us = np.empty(n, dtype=np.float64)
    freq = np.empty(n, dtype=np.float64)
    # the stored text (label\x1fobs\x1fflags\n per TOA) is bounded by the
    # file itself plus the per-record separators
    text_cap = max(4096, os.path.getsize(path) + 4 * int(n))
    text = ctypes.create_string_buffer(text_cap)
    got = lib.fast_tim_parse(path.encode(), n, mjd_day, mjd_frac, err_us, freq, text, text_cap)
    if got != n:
        raise OSError(f"native tim read of {path} stopped at {got} of {n} TOAs")
    mjd = mjd_day.astype(np.longdouble) + mjd_frac.astype(np.longdouble)
    labels, obs, flag_strs = [], [], []
    raw = text.value.decode(errors="replace")
    # split on the exact record separator fast_tim_parse writes ('\n');
    # splitlines() would also break on \x0b/\x0c/\x85 inside flag tails
    for rec in raw.split("\n"):
        if not rec:
            continue
        parts = rec.split("\x1f", 2)
        labels.append(parts[0] if len(parts) > 0 else "")
        obs.append(parts[1] if len(parts) > 1 else "")
        flag_strs.append(parts[2] if len(parts) > 2 else "")
    return mjd, err_us * 1e-6, freq, labels, obs, flag_strs


def fast_write_tim(path: str, mjd_day, frac15, text: bytes) -> None:
    """Write a FORMAT-1 tim file natively from the split epoch arrays and
    the pre-rendered static line parts (``io.tim`` builds them). Raises
    ``OSError`` when the write fails (e.g. disk full): a failed write must
    never look like a success."""
    lib = load_library()
    n = len(mjd_day)
    got = lib.fast_tim_write(
        path.encode(), n,
        np.ascontiguousarray(mjd_day, dtype=np.int64),
        np.ascontiguousarray(frac15, dtype=np.int64),
        text,
    )
    if got != n:
        reason = {
            ERR_OPEN: "could not open for writing",
            ERR_WRITE: "write or close failed mid-file (disk full?)",
            ERR_TEXT_OVERFLOW: "malformed pre-rendered line stream",
        }.get(got, "unknown failure")
        raise OSError(f"native tim write failed for {path}: {reason} (code {got})")
