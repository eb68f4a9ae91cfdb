"""Package hygiene of the port: no JAX, lazy kernels, no CPU fallback for CUDA."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from thunder_tpu_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "thunder_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__") for p in PACKAGE.rglob("*.py")
)


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
    )


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'thunder_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 20


def test_kernel_modules_import_without_nvcc_or_triton():
    # an empty PATH hides nvcc; importing must neither build nor need triton
    code = (
        "import shutil, sys\n"
        "assert shutil.which('nvcc') is None\n"
        "import thunder_tpu_torch.kernels, thunder_tpu_torch.kernels.selftest, thunder_tpu_torch.engine\n"
        "assert 'triton' not in sys.modules\n"
        "from thunder_tpu_torch.kernels import _build\n"
        "assert _build._lib is None\n"
    )
    proc = _run(code, PATH="")
    assert proc.returncode == 0, proc.stderr


def test_sources_are_in_the_package():
    names = {p.name for p in _build.CSRC_DIR.glob("*.cu")}
    assert names == {"log_mel.cu", "separable_repeat.cu", "ctc_recursion.cu", "mha_from_qkv.cu", "add_ln.cu",
                     "beam_search.cu", "mha_train.cu", "add_ln_train.cu"}
    # the headers the sources share are package data too, and an edit to one rebuilds the library
    assert {p.name for p in _build.CSRC_DIR.glob("*.cuh")} == {"mha_forward.cuh", "dropout_hash.cuh"}
    pyproject = (_build.CSRC_DIR.parents[1] / "pyproject.toml").read_text()
    assert '"csrc/*.cu"' in pyproject and '"csrc/*.cuh"' in pyproject
    assert _build.library_path().parent == _build.BUILD_DIR
    sources = {src.name: src.read_text() for src in _build.CSRC_DIR.glob("*.cu")}
    for text in sources.values():
        assert "Replaces: thunder_tpu/kernels/" in text and "bounds it on this card" in text
    # every entry point the loader binds is defined in exactly one source
    for entry in _build.SIGNATURES:
        assert sum(f'extern "C" int {entry}(' in text for text in sources.values()) == 1, entry


def test_cuda_device_without_gpu_raises(monkeypatch):
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.engine import InferenceEngine
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = dict(filters=(64,), kernel_sizes=(5,), repeat=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTCModule.create(torch.Generator(), FilterbankFeatures(), QuartznetEncoder(**enc), Conv1dDecoder(3), device="cuda")
    module = CTCModule.create(torch.Generator(), FilterbankFeatures(), QuartznetEncoder(**enc), Conv1dDecoder(3),
                              device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(module, device="cuda")


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda *a: Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_launch_status_is_checked():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check(700, "thunder_separable_repeat")


def test_chip_smoke_needs_a_gpu():
    # no CUDA device here: the smoke run must fail and print no result line
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
