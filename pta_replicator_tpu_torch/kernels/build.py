"""Build the CUDA sources under ``csrc/`` at first use, and load them.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (named by a hash of the source and the flags, so an edited
source rebuilds) and loaded with ``ctypes``. There is no fallback: a
missing ``nvcc`` or a failed build raises.

``--use_fast_math`` is deliberately absent: it swaps ``sinf`` for
``__sinf`` at chirp phases of ~100 rad and lets the compiler assume
finite values, which can delete the NaN guard of a merged binary.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}
#: ptxas's report (registers, shared memory, spills) of each build made
#: by this process, by source name
ptxas_reports: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's
    default location, or ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path. The library appears atomically, so
    concurrent builders never load a half-written file."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build csrc/{name}.cu "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        ptxas_reports[name] = proc.stderr.strip()
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def build_variant(name: str, variant: str, edits, out_dir: Path, source_path=None):
    """Build a copy of ``csrc/<name>.cu`` (or of ``source_path``, another
    version of it) with each ``(old, new)`` of ``edits`` replaced once, for
    a study that times a partial or an earlier kernel, into ``out_dir``;
    returns ``(library path, ptxas lines)``. Raises when the source no
    longer holds an ``old`` text or nvcc fails."""
    source = Path(source_path or CSRC_DIR / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in source:
            raise RuntimeError(f"{name} {variant}: the kernel no longer has {old!r}")
        source = source.replace(old, new)
    src = out_dir / f"{name}_{variant}.cu"
    src.write_text(source)
    lib = out_dir / f"lib{name}_{variant}.so"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name} {variant}:\n{proc.stderr}")
    return lib, [l.strip() for l in proc.stderr.splitlines()
                 if "entry function" in l or "Used" in l or "spill" in l]


def build_all(names) -> None:
    """Build several sources at once, one ``nvcc`` each, all started
    together; raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(build, n) for n in names]:
            future.result()


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    ``bind(lib)`` declares its functions' argument and result types once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _loaded[name] = lib
        return lib


def sources() -> list:
    """Names of every CUDA source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
