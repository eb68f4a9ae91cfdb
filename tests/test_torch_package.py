"""Package hygiene of the port: no JAX, lazy kernels, no CPU fallback for CUDA."""

import os
import shutil
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
    assert {"thunder_tpu_torch.streaming", "thunder_tpu_torch.profiling", "thunder_tpu_torch.__main__",
            "thunder_tpu_torch.parallel", "thunder_tpu_torch.parallel.mesh", "thunder_tpu_torch.parallel.spmd"} <= set(MODULES)


def test_cli_without_a_card_exits_with_the_device_error():
    # no card visible and no --device cpu: the CLI refuses before it loads anything, and loads no JAX
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "thunder_tpu_torch", "transcribe", "--checkpoint",
         "tests/fixtures/tiny_quartznet.nemo", "missing.wav"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr and "--device cpu" in proc.stderr
    imported = {line.split("|")[-1].strip().split(".")[0] for line in proc.stderr.splitlines() if "|" in line}
    assert not imported & {"jax", "jaxlib", "flax", "optax", "thunder_tpu"}, imported


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
    assert {p.name for p in _build.CSRC_DIR.glob("*.cuh")} == {"mha_forward.cuh", "dropout_hash.cuh", "hopper.cuh"}
    pyproject = (_build.CSRC_DIR.parents[1] / "pyproject.toml").read_text()
    assert '"csrc/*.cu"' in pyproject and '"csrc/*.cuh"' in pyproject
    assert _build.library_path().parent == _build.BUILD_DIR
    sources = {src.name: src.read_text() for src in _build.CSRC_DIR.glob("*.cu")}
    for text in sources.values():
        assert "Replaces: thunder_tpu/kernels/" in text and "bounds it on this card" in text
    # every entry point the loader binds is defined in exactly one source
    for entry in _build.SIGNATURES:
        assert sum(f'extern "C" int {entry}(' in text for text in sources.values()) == 1, entry


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    # hopper.cuh (TMA, mbarrier and wgmma helpers) is shared by the attention and the separable repeat
    for src in _build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path()
    (tmp_path / "hopper.cuh").write_text((tmp_path / "hopper.cuh").read_text() + "\n// edited\n")
    assert _build.library_path() != before


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


# ---- the native host runtime (thunder_tpu_torch/native.py): built by g++ on first use, named by its source's hash

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on this machine")
PROBE = 'extern "C" int tn_probe(void) {{ return {}; }}\n'


def test_native_runtime_is_package_data_and_never_built_at_import():
    from thunder_tpu_torch import native

    assert native.SRC == PACKAGE / "csrc" / "thunder_native.cpp" and native.SRC.exists()
    assert native.BUILD_DIR == _build.BUILD_DIR
    assert '"csrc/*.cpp"' in (ROOT / "pyproject.toml").read_text()
    # the .cpp is host code: the CUDA library's sources (and its hash) are the .cu files alone
    assert all(src.suffix == ".cu" for src in _build._sources())
    proc = _run("import thunder_tpu_torch.native as n, thunder_tpu_torch.ops.ctc_beam, thunder_tpu_torch.text\n"
                "assert n._lib is None and not n._failed\n")
    assert proc.returncode == 0, proc.stderr


@needs_gxx
def test_native_library_is_rebuilt_after_its_source_changes(tmp_path):
    """C8: the library is named after its source, so an edited source builds a new library and loads it."""
    import ctypes

    from thunder_tpu_torch import native

    src = tmp_path / "probe.cpp"
    src.write_text(PROBE.format(1))
    first = native.build(src, tmp_path / "build")
    src.write_text(PROBE.format(2))
    second = native.build(src, tmp_path / "build")
    assert first != second and first.exists() and second.exists()
    assert ctypes.CDLL(str(first)).tn_probe() == 1 and ctypes.CDLL(str(second)).tn_probe() == 2
    assert native.build(src, tmp_path / "build") == second  # the same source builds nothing new


@needs_gxx
def test_a_failed_native_build_is_not_remembered_past_its_source(tmp_path, monkeypatch):
    """C8: after a failed build, the fixed source builds (the JAX package's ``.build_failed`` marker refuses it)."""
    import thunder_tpu.native as jax_native
    from thunder_tpu_torch import native

    src = tmp_path / "probe.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(src, tmp_path / "build")
    src.write_text(PROBE.format(3))
    assert native.build(src, tmp_path / "build").exists()

    # in the loader: a failure is remembered for the source it failed on, and only for it
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "thunder_native.cpp"
    broken.write_text("#error broken\n" + native.SRC.read_text())
    monkeypatch.setattr(native, "SRC", broken)
    assert not native.native_available() and len(native._failed) == 1
    assert not native.native_available()  # the same source: not rebuilt
    broken.write_text(native.SRC.read_text().replace("#error broken\n", "", 1))
    assert native.native_available() and native.native_edit_distance("abc", "abd") == 1

    # the JAX package's build function, on the same sequence of sources, stays failed
    jax_src = tmp_path / "jax.cpp"
    jax_src.write_text("this is not C++\n")
    monkeypatch.setattr(jax_native, "_SRC", jax_src)
    monkeypatch.setattr(jax_native, "_LIB_PATH", tmp_path / "jax.so")
    monkeypatch.setattr(jax_native, "_FAILED_MARKER", tmp_path / "jax.build_failed")
    assert not jax_native._build()
    jax_src.write_text(PROBE.format(4))
    assert not jax_native._build() and not (tmp_path / "jax.so").exists()  # the fault, not carried over


@needs_gxx
def test_concurrent_native_builds_load_a_whole_library(tmp_path):
    """Processes that build the same source at once wait on one lock: each loads a whole library, no
    temporary file is left."""
    src = tmp_path / "probe.cpp"
    src.write_text(PROBE.format(5) + "".join(f'extern "C" int tn_pad{i}(int x) {{ return x * {i}; }}\n'
                                             for i in range(300)))
    code = ("import ctypes, sys\n"
            "from pathlib import Path\n"
            "from thunder_tpu_torch import native\n"
            "path = native.build(Path(sys.argv[1]), Path(sys.argv[2]))\n"
            "assert ctypes.CDLL(str(path)).tn_probe() == 5\n"
            "print(path)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), str(tmp_path / "build")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT)}) for _ in range(6)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted([Path(outs[0][0].strip()).name,
                                                                             ".native.lock"])
