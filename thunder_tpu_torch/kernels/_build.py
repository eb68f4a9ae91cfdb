"""Build and load the port's CUDA kernels.

Every ``thunder_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for ``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, on first use, and loaded with
``ctypes``. The library's name carries a hash of the sources, the headers
they share (``*.cuh``) and the flags, so
an edited source is rebuilt and a stale build is never loaded.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point: name -> argtypes (all return int)
SIGNATURES = {
    "thunder_log_mel": [_P, _P, _P, _P, _P, *[_I] * 9, _F, _P],
    "thunder_log_mel_plan": [_I, _I, _I, _I, _P],
    "thunder_separable_repeat": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "thunder_separable_repeat_plan": [_I, _I, _I, _I, _P],
    "thunder_ctc_plan": [_I, _P],
    "thunder_ctc_alpha": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "thunder_ctc_beta": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "thunder_ctc_log_1_3_check": [_P, _P],
    "thunder_ctc_lse3_chain": [_P, _I, _F, _F, _P],
    "thunder_mha_from_qkv": [_P, _P, _P, _I, _I, _I, _P],
    "thunder_add_layer_norm": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "thunder_add_ln_train_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "thunder_add_ln_train_plan": [_I, _I, _P],
    "thunder_add_ln_train_bwd": [*[_P] * 11, _I, _I, _F, _F, _P],
    "thunder_dropout_keep_mask": [_P, _P, _I, _I, _F, _P],
    "thunder_mha_train_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "thunder_mha_train_bwd": [*[_P] * 8, _I, _I, _I, _F, _P],
    "thunder_beam_scan_plan": [_I, _I, _P],
    "thunder_beam_scan": [_P, _P, _P, _P, _F, *[_P] * 13, _I, _I, _I, _I, _I, _I, _P, _P],
    "thunder_beam_backtrace_plan": [_I, _I, _I, _P],
    "thunder_beam_backtrace": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "thunder_beam_backtrace_serial": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "thunder_beam_walk_chain": [_P, _I, _I, _P],
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


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*_sources(), *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libthunder_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists; return its
    path. One ``nvcc -c`` runs for each source, all at once, then one
    ``nvcc -shared`` links the objects."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    sources = _sources()
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objects)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
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
