"""Build and load the port's CUDA kernels.

Every ``thunder_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, on first use,
and loaded with ``ctypes``. The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale build is never loaded.
The build directory is ``thunder_tpu_torch/build/`` (listed in
``.gitignore``).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0. Nothing here
runs at import time: this module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "check", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every entry point: name -> argtypes (all return int)
SIGNATURES = {
    "thunder_log_mel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "thunder_separable_repeat": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "thunder_ctc_alpha": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "thunder_ctc_beta": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of thunder_tpu_torch are built with nvcc on first use")


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return sources


def library_path(extra_flags: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra_flags]).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libthunder_kernels_{digest.hexdigest()[:16]}.so"


def build(extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile the sources (with ``extra_flags`` after ``NVCC_FLAGS``) unless a
    library of the same hash exists; return its path."""
    out = library_path(extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load(extra_flags: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built on first call.

    ``extra_flags`` builds the library with those nvcc flags added and loads it
    in place of the current one, so that every wrapper launches from it until
    the next such call; ``()`` returns to the default build. Only measurements
    (``ctc_fast_math``) pass it.
    """
    global _lib
    with _lock:
        if _lib is None or extra_flags is not None:
            lib = ctypes.CDLL(str(build(extra_flags or ())))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
