"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain ``extern "C"`` interface.
It is compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use (cached by a hash of the source and the
flags), and loaded with ``ctypes``.  Nothing here imports torch, and
nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# -Xptxas=-v only adds the registers/spills report to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on first use and need the CUDA toolkit")


def build(stem: str) -> tuple[Path, str]:
    """Compile ``csrc/<stem>.cu`` into ``build/`` (cached by content hash).

    Returns the shared library's path and nvcc's log ("" when the library
    was already built).  Safe to call from several threads at once for
    different sources: each runs its own ``nvcc``.
    """
    source = CSRC / f"{stem}.cu"
    src = source.read_bytes()
    tag = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}-{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(stem: str, declare) -> ctypes.CDLL:
    """Build (first call only) and load ``csrc/<stem>.cu``; ``declare(lib)``
    sets each function's ``argtypes`` and ``restype`` once."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)[0]))
            declare(lib)
            _libs[stem] = lib
        return lib
