"""Cycles a frame in each stage of the beam scan kernel, from an instrumented copy of its source.

    python3 -m thunder_tpu_torch.kernels.beam_cycles [--source PATH ...]

For each ``--source`` (default: this checkout's ``csrc/beam_search.cu``; for
example a parent checkout's, unpacked with ``git archive``), the script copies
the file into the build directory, inserts a ``clock64()`` probe before each
of its stage markers (the ``// stage:`` comments of the scan's frame loop,
or the stage comments of the earlier one-warp kernel), builds the copy alone
with ``nvcc`` and runs its scan at each shape of
``compare_builds.BEAM_SHAPES`` on the ``beam_device`` inputs of
``kernels/selftest.py::beam_case`` (standard normal logits with +2 on blank
0, numpy seed 3) with every row at full length. Thread 0 of each block sums
the cycles between its probes over the frames of its row, barrier waits
included; one JSON line per source and shape gives each stage's cycles a
frame (the mean over rows, and row 0's), the frame's, and the instrumented
kernel's time by CUDA events. The shipped source carries no probe.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.kernels.compare_builds import BEAM_SHAPES as SHAPES

#: the earlier one-warp kernel: stage -> the source line before which the stage ends
ONE_WARP_LAYOUT = {
    "candidate load": "// stay rows",
    "stay rows": "// extend rows",
    "extend + merge": "// top-W",
    "top-W": "// commit",
    "commit": "cur = nxt;",
}
#: later layouts mark each stage's start with a ``// stage: <name>`` comment (the name ends at a comma or a
#: colon); the
#: frame's first stage is the candidate load, and the last ends at ``cur = nxt;``
STAGE_MARK = "// stage: "
KERNEL_START = "const int b = blockIdx.x;"
FRAME_START = "for (int t = 0; t < len; ++t) {"
KERNEL_END = "// frames past the length"
MAX_ROWS = 256


def stage_layout(lines: list, start: int) -> dict:
    """stage -> the source line before which it ends, from the ``// stage:`` markers, else the one-warp layout."""
    marks = [re.split("[,:]", line.split(STAGE_MARK, 1)[1])[0].strip() for line in lines[start:] if STAGE_MARK in line]
    if not marks:
        return ONE_WARP_LAYOUT
    names = ["candidate load", *marks]
    return {name: (f"{STAGE_MARK}{nxt}" if nxt else "cur = nxt;") for name, nxt in zip(names, [*marks, None])}


def instrument(source: str) -> tuple[str, list]:
    """The source with the probes in, and the stage names in probe order."""
    lines = source.splitlines()
    start = next(i for i, line in enumerate(lines) if KERNEL_START in line)
    layout = stage_layout(lines, start)
    if len(layout) > 8 or not all(any(m in line for line in lines[start:]) for m in layout.values()):
        raise ValueError("the source's stage markers are not a layout this script knows")
    probes = {}
    for n, (stage, mark) in enumerate(layout.items()):
        at = next(i for i in range(start, len(lines)) if mark in lines[i])
        probes[at] = (f"if (threadIdx.x == 0) {{ const long long _n = clock64(); _cyc[{n}] += _n - _cyc_t; "
                      f"_cyc_t = _n; }}  // {stage}")
    out = []
    for i, line in enumerate(lines):
        if line.startswith("namespace {") and not any("thunder_stage_cycles" in x for x in out):
            out += [f"__device__ long long thunder_stage_cycles[{MAX_ROWS}][8];",
                    'extern "C" int thunder_read_stage_cycles(long long* out) {',
                    "  return (int)cudaMemcpyFromSymbol(out, thunder_stage_cycles, sizeof(thunder_stage_cycles));",
                    "}"]
        if i in probes:
            out.append(probes[i])
        if i > start and KERNEL_END in line:
            out.append(f"if (threadIdx.x == 0 && blockIdx.x < {MAX_ROWS}) {{ "
                       + " ".join(f"thunder_stage_cycles[blockIdx.x][{n}] = _cyc[{n}];" for n in range(8)) + " }")
        out.append(line)
        if i == start:
            out.append("long long _cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; long long _cyc_t = clock64();")
        if i > start and FRAME_START in line:
            out.append("if (threadIdx.x == 0) _cyc_t = clock64();")
    return "\n".join(out) + "\n", list(layout)


def build(source_path: Path, tag: str) -> ctypes.CDLL:
    text, _ = instrument(source_path.read_text())
    out_dir = _build.BUILD_DIR / "beam_cycles"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(source_path.parent), "-shared", "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the instrumented {source_path}:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    dll.thunder_beam_scan.argtypes = _build.SIGNATURES["thunder_beam_scan"]
    dll.thunder_beam_scan.restype = ctypes.c_int
    dll.thunder_read_stage_cycles.argtypes = [ctypes.c_void_p]
    dll.thunder_read_stage_cycles.restype = ctypes.c_int
    return dll


def measure(dll: ctypes.CDLL, stages: list, shape: tuple, iters: int = 5) -> dict:
    import numpy as np
    import torch

    from thunder_tpu_torch.kernels.beam import candidates, fresh_state
    from thunder_tpu_torch.kernels.selftest import beam_case

    batch, frames, vocab, width, k_tokens = shape
    logits, _ = beam_case(3, batch, frames, vocab, "cuda")
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    lens = torch.full((batch,), frames, dtype=torch.int32, device="cuda")
    k, topv, topi = candidates(logp, k_tokens)
    state = fresh_state(batch, width, "cuda")
    parents = torch.empty((batch, frames, width), dtype=torch.int32, device="cuda")
    exts = torch.empty_like(parents)
    outs = [torch.empty((batch, width), dtype=dt, device="cuda") for dt in (torch.float32,) * 3 + (torch.int32,) * 3]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        status = dll.thunder_beam_scan(
            logp.data_ptr(), 0 if topv is None else topv.data_ptr(), 0 if topi is None else topi.data_ptr(),
            lens.data_ptr(), float(np.float32(-12.0)), *(a.data_ptr() for a in state), parents.data_ptr(),
            exts.data_ptr(), *(o.data_ptr() for o in outs), batch, frames, vocab, k, width, 0, stream)
        _build.check(status, "thunder_beam_scan (instrumented)")

    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    cycles = np.zeros((MAX_ROWS, 8), dtype=np.int64)
    _build.check(dll.thunder_read_stage_cycles(cycles.ctypes.data), "thunder_read_stage_cycles")
    per_frame = cycles[:batch, :len(stages)] / frames
    mean = per_frame.mean(axis=0)
    return {"stages": dict(zip(stages, mean.tolist())), "row0": dict(zip(stages, per_frame[0].tolist())),
            "frame_cycles": float(mean.sum()), "ms": start.elapsed_time(end) / iters,
            "us_per_frame": start.elapsed_time(end) / iters / frames * 1e3}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", type=Path,
                        help="a beam_search.cu to instrument (repeatable; default: this checkout's)")
    parser.add_argument("--shapes", default=",".join(SHAPES), help=f"comma-separated, of {list(SHAPES)}")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("beam_cycles: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for n, path in enumerate(args.source or [_build.CSRC_DIR / "beam_search.cu"]):
        _, stages = instrument(path.read_text())
        dll = build(path, f"beam_cycles_{n}")
        for name in args.shapes.split(","):
            print(json.dumps({"source": str(path), "shape": name, **measure(dll, stages, SHAPES[name]),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
