"""Does the CTC kernel pair hold its limit when built with ``-use_fast_math``?

Run on a Hopper card, from the root of a checkout:

    python3 -m thunder_tpu_torch.kernels.ctc_fast_math

The kernel library is built twice: as shipped (full-precision ``expf`` and
``logf``) and with ``nvcc -use_fast_math`` (the ``__expf``/``__logf``
intrinsics). For each build it runs the ``ctc_recursion`` and ``ctc_edge``
checks of :mod:`thunder_tpu_torch.kernels.selftest` and times ``ctc_alpha``
+ ``ctc_beta`` at the QuartzNet training shape (T = 751, B = 16, S = 129)
with CUDA events, in the order shipped, fast, fast, shipped; the fast
build's alpha and gradient there are compared with the shipped build's
element by element. It prints the card's name and power limit, then one
JSON line per build; the shipped library is loaded again at the end.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.kernels.ctc import ctc_alpha, ctc_beta, extended_emissions, ll_from_alpha
from thunder_tpu_torch.kernels.selftest import run_selftests

FAST = ("-use_fast_math",)


def _training_shape_pair(seed: int = 2, t: int = 751, b: int = 16, labels: int = 64, vocab: int = 29):
    """The kernel pair on random emissions at the training shape (43 of 64 labels valid)."""
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(rng.standard_normal((b, t, vocab)).astype(np.float32), device="cuda")
    targets = torch.as_tensor(rng.integers(1, vocab, (b, labels)), dtype=torch.int32, device="cuda")
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    tl = torch.full((b,), 43, dtype=torch.int32, device="cuda")
    lp_z, skip_ok = extended_emissions(torch.log_softmax(logits, dim=-1), targets, blank=0)
    ghat = 1.0 / tl.float()

    def pair():
        alpha = ctc_alpha(lp_z, skip_ok, lens, tl)
        return alpha, ctc_beta(lp_z, alpha, skip_ok, lens, tl, ll_from_alpha(alpha, lens, tl), ghat)

    return pair


def _ms(fn, iters: int = 200) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ctc_fast_math: this measurement needs a CUDA device")
    query = ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(query, capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    pair = _training_shape_pair()
    builds = {"shipped": (), "fast_math": FAST}
    results = {}
    for name, flags in builds.items():
        _build.load(flags)
        checks = run_selftests(["ctc_recursion", "ctc_edge"])
        results[name] = {"library": _build.library_path(flags).name,
                         "checks": {c["name"]: {k: c[k] for k in ("max_err", "tol", "ok")} for c in checks}}
    outputs = {}
    for name, flags in builds.items():
        _build.load(flags)
        outputs[name] = pair()
    (a0, d0), (a1, d1) = outputs["shipped"], outputs["fast_math"]
    results["fast_math"]["vs_shipped"] = {
        "alpha_max_abs_diff": (a1 - a0).abs().max().item(),
        "alpha_elements_differing": int((a1 != a0).sum().item()),
        "dlp_max_diff_over_max_dlp": ((d1 - d0).abs().max() / d0.abs().max()).item(),
        "dlp_elements_differing": int((d1 != d0).sum().item()),
        "elements": a0.numel(),
    }
    times = {name: [] for name in builds}
    for name in ("shipped", "fast_math", "fast_math", "shipped"):
        _build.load(builds[name])
        times[name].append(_ms(pair))
    _build.load(())
    for name, result in results.items():
        print(json.dumps({"build": name, **result, "pair_ms": times[name]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
