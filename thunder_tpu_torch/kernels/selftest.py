"""On-card numerics checks: each CUDA kernel against its plain PyTorch version.

Port of ``thunder_tpu/kernels/selftest.py`` for the kernels this package has,
with its check names and tolerances: ``frontend_log_mel`` (2e-3 absolute,
log-mel units), ``separable_conv`` and ``repeat_tm`` (8 bf16 ULP at the
reference's maximum magnitude). ``separable_conv_stem`` and
``separable_conv_tail`` add QuartzNet's strided stem and dilated tail, which
the TPU kernels did not take; ``repeat_tm`` runs ragged lengths and fails
unless every row beyond a length is exactly zero.

Both sides run on the same device and the same inputs; the float32 reference
runs without TF32 (:func:`exact_float32` is set first).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
from thunder_tpu_torch.kernels.separable_conv import (
    fused_separable_repeat,
    output_length,
    separable_repeat_reference,
)
from thunder_tpu_torch.ops.masking import lengths_to_mask

__all__ = ["run_selftests", "KERNEL_CHECKS", "ulp_bf16_error", "exact_float32"]


def exact_float32() -> None:
    """Make float32 matmuls and cuDNN convolutions on the card full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def ulp_bf16_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want|`` in units of the bf16 ULP at ``max|want|``."""
    got, want = got.float(), want.float()
    mag = max(want.abs().max().item(), 2.0**-14)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return (got - want).abs().max().item() / ulp


def _separable_case(seed, b, t, c, co, k, stride=1, dilation=1, ragged=False, device="cuda"):
    """Random bf16 inputs of one repeat, zero beyond the input lengths, BN scale folded into pw."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b) if ragged else np.full(b, t)
    lengths[:1] = t
    x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    dw = rng.standard_normal((k, c)).astype(np.float32) * 0.1
    scale = rng.standard_normal(co).astype(np.float32)
    pw = rng.standard_normal((c, co)).astype(np.float32) * 0.05 * scale[None, :]
    bias = rng.standard_normal(co).astype(np.float32)
    pad = (dilation * (k - 1) + 1) // 2 if dilation > 1 else k // 2
    out_lengths = (lengths + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    bf = lambda a: torch.as_tensor(a, device=device).to(torch.bfloat16).contiguous()  # noqa: E731
    return dict(
        x=bf(x),
        out_lengths=torch.as_tensor(out_lengths.astype(np.int32), device=device),
        dw=bf(dw),
        pw=bf(pw),
        bias=torch.as_tensor(bias, device=device),
        kernel_size=k,
        stride=stride,
        dilation=dilation,
    )


def _check_frontend(device) -> dict:
    rng = np.random.default_rng(0)
    audio = torch.as_tensor(rng.standard_normal((4, 16000)).astype(np.float32) * 0.2, device=device)
    err = (fused_log_mel(audio) - log_mel_reference(audio)).abs().max().item()
    return {"max_err": err, "max_abs_err": err}


def _separable_check(seed, b, t, c, co, k, stride=1, dilation=1, ragged=False):
    def check(device) -> dict:
        case = _separable_case(seed, b, t, c, co, k, stride, dilation, ragged, device)
        got = fused_separable_repeat(**case)
        want = separable_repeat_reference(**case)
        if got.shape != (b, output_length(t, k, stride, dilation), co):
            return {"max_err": float("inf"), "max_abs_err": float("inf"), "error": f"shape {tuple(got.shape)}"}
        result = {"max_err": ulp_bf16_error(got, want), "max_abs_err": (got.float() - want.float()).abs().max().item()}
        beyond = ~lengths_to_mask(case["out_lengths"], got.shape[1])
        if bool((got[beyond] != 0).any()):
            result["max_err"] = float("inf")
            result["error"] = "nonzero output beyond out_lengths"
        return result

    return check


KERNEL_CHECKS: Dict[str, tuple[Callable[[str], dict], float]] = {
    # name -> (check fn, tolerance); units: absolute log-mel for the frontend,
    # bf16 ULPs at the reference's max magnitude for the separable repeat
    "frontend_log_mel": (_check_frontend, 2e-3),
    "separable_conv": (_separable_check(1, 4, 384, 512, 512, 33), 8.0),  # QuartzNet15x5 body shape
    "separable_conv_stem": (_separable_check(13, 4, 768, 64, 256, 33, stride=2), 8.0),
    "separable_conv_tail": (_separable_check(14, 4, 384, 512, 512, 87, dilation=2), 8.0),
    "repeat_tm": (_separable_check(2, 16, 384, 256, 256, 33, ragged=True), 8.0),  # ragged lengths, exact-zero mask
}


def run_selftests(names: List[str] | None = None, device: str = "cuda") -> List[dict]:
    """Run each check on ``device``; returns ``{"name", "max_err", "max_abs_err", "tol", "ok"}`` dicts.

    A check that raises propagates: a crash is a failure, never a skip.
    """
    exact_float32()
    out = []
    for name, (fn, tol) in KERNEL_CHECKS.items():
        if names is not None and name not in names:
            continue
        result = fn(device)
        out.append({"name": name, **result, "tol": tol, "ok": bool(result["max_err"] <= tol)})
    return out
