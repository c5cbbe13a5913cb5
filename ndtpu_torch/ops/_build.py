"""Build and load the port's native libraries (plain C interface + ctypes).

Each kernel source under ``ndtpu_torch/csrc`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library under ``build/ndtpu_torch/`` at the
repository root (listed in ``.gitignore``), at first use and never at
import. The library's file name carries a hash of the source, so an
edited source rebuilds and an unchanged one is loaded as it is. Compiling
to a temporary name and renaming makes concurrent first uses safe. The
host C++ PLY reader (``ndtpu_torch/native``) is built the same way with
its own compiler and flags (``build_library``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ndtpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # one build at a time: the temporary name is per process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def compile_source(src: Path, out: Path, *flags: str) -> str:
    """nvcc ``src`` into the shared library ``out`` (with ``flags`` after
    the port's own); returns what the compiler printed."""
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build_library(src: Path, flags, compile_fn) -> Path:
    """``compile_fn(src, out)`` into the library of ``src`` and ``flags``,
    named by a hash of both, unless it exists: to a temporary name, then
    renamed."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compile_fn(src, tmp)
    os.replace(tmp, out)
    return out


def load_library(src: Path, flags, compile_fn) -> ctypes.CDLL:
    """Build (if needed, one build at a time) and load ``src``'s library."""
    with _lock:
        return ctypes.CDLL(str(build_library(src, flags, compile_fn)))


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    return build_library(_CSRC / source, NVCC_FLAGS, compile_source)


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    return load_library(_CSRC / source, NVCC_FLAGS, compile_source)
