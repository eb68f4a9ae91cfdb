"""On-card numerics checks: each CUDA kernel against its plain PyTorch version.

Port of ``thunder_tpu/kernels/selftest.py`` for the kernels this package has,
with its check names and tolerances: ``frontend_log_mel`` (2e-3 absolute,
log-mel units), ``separable_conv`` and ``repeat_tm`` (8 bf16 ULP at the
reference's maximum magnitude), ``ctc_recursion`` (0.01: absolute loss delta
or gradient delta relative to the largest gradient, against the plain time
loop). ``ctc_edge`` holds the CTC kernels to the JAX package's CPU limits on
its edge case (a repeated label, an empty target, T = 61) plus one impossible
alignment, which must give ``+inf`` on both routes and an exactly zero
gradient. ``separable_conv_stem`` and
``separable_conv_tail`` add QuartzNet's strided stem and dilated tail, which
the TPU kernels did not take; ``repeat_tm`` runs ragged lengths and fails
unless every row beyond a length is exactly zero. ``attn_onepanel``
(B = 2, T = 256, 4 heads), ``attn_onepanel_1536`` (B = 2, T = 1536, 12
heads) and ``add_ln`` (8 x 768 rows x 768) keep the JAX names and limits (4,
4 and 2 bf16 ULP); ``attn_onepanel_749`` adds the wav2vec2-base serving
length at 15 s (T = 749, not a multiple of 128) with ragged lengths and a
row of length 0. The attention checks compare every query row, padded ones
included. ``beam_device`` keeps the JAX check's name and shape (B = 64,
T = 751, V = 29, beam 16, standard normal logits with +2 on blank 0, lengths
``linspace(T // 2, T, B)``) and, like it, demands exact agreement: the
kernels' pointers, exts, integer state and best hypotheses must equal the
plain versions'; its number is then the largest difference of the float
state and ``total`` (limit 2e-3, the JAX package's score tolerance against
its host search; both routes compute the same float32 operations, so it is
0 when the card's ``expf``/``log1pf`` round as PyTorch's do).
``beam_device_topk`` runs the ``K < V`` pre-prune at the Citrinet serving
shape (B = 64, T = 188, V = 1025, K = 50, beam 16), and ``beam_stream``
holds four windows that tile the ``beam_device`` utterance, each one scan
from the carried state, to the whole utterance at once: the same state and
the same best prefixes.

Both sides run on the same device and the same inputs; the float32 reference
runs without TF32 (:func:`exact_float32` is set first).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
from thunder_tpu_torch.kernels.beam import beam_backtrace, beam_backtrace_reference, beam_scan, beam_scan_reference
from thunder_tpu_torch.kernels.ctc import ctc_ll, ctc_ll_reference, extended_emissions, scores_from_ll
from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference
from thunder_tpu_torch.kernels.separable_conv import (
    fused_separable_repeat,
    output_length,
    separable_repeat_reference,
)

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
        beyond = torch.arange(got.shape[1], device=got.device)[None, :] >= case["out_lengths"][:, None]
        if bool((got[beyond] != 0).any()):
            result["max_err"] = float("inf")
            result["error"] = "nonzero output beyond out_lengths"
        return result

    return check


def ctc_training_case(seed, b, t, v, l, device):
    """The ``ctc_recursion`` inputs of the JAX selftest: logits, target lengths, targets, logit lengths."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    tl = rng.integers(10, l + 1, (b,))
    targets = rng.integers(1, v, (b, l))
    lens = rng.integers(t // 2, t + 1, (b,))
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return as_t(logits, torch.float32), as_t(targets, torch.int32), as_t(lens, torch.int32), as_t(tl, torch.int32)


def ctc_edge_case(device):
    """``tests/test_ctc_pallas.py``'s case (B = 5, T = 61, V = 12, L = 9: a
    repeated label, an empty target, lengths 2 and 19) plus a sixth row, row 4
    again with 9 frames for its 9 labels and one repeat: an impossible alignment."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 61, 12)).astype(np.float32)
    targets = rng.integers(1, 12, (5, 9))
    targets[0, 1] = targets[0, 0]
    logits = np.concatenate([logits, logits[4:]])
    targets = np.concatenate([targets, targets[4:]])
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return (as_t(logits, torch.float32), as_t(targets, torch.int32), as_t([61, 40, 30, 2, 19, 9], torch.int32),
            as_t([9, 5, 0, 1, 9, 9], torch.int32))


def _ctc_value_and_grad(recursion, logits, targets, lens, tl, mean=False):
    """Per-sample losses, and the gradient of ``sum(zero_inf(loss) / max(tl, 1))``
    (or of its mean over the batch, as ``tests/test_ctc_pallas.py`` takes it) in the logits."""
    x = logits.detach().clone().requires_grad_(True)
    lp_z, skip_ok = extended_emissions(torch.log_softmax(x, dim=-1), targets, blank=0)
    losses = scores_from_ll(recursion(lp_z, skip_ok, lens, tl))
    total = (torch.where(torch.isinf(losses), 0.0, losses) / tl.clamp_min(1)).sum()
    total = total / len(tl) if mean else total
    (grad,) = torch.autograd.grad(total, x)
    return losses.detach(), total.detach(), grad


def _check_ctc_recursion(device) -> dict:
    case = ctc_training_case(11, 16, 751, 29, 43, device)
    losses0, total0, g0 = _ctc_value_and_grad(ctc_ll_reference, *case)
    losses1, total1, g1 = _ctc_value_and_grad(ctc_ll, *case)
    dl = (total0 - total1).abs().item()
    dg_abs = (g0 - g1).abs().max().item()
    dg = dg_abs / max(g0.abs().max().item(), 1e-9)
    return {"max_err": max(dl, dg), "max_abs_err": max(dl, dg_abs), "loss_delta": dl, "grad_rel_delta": dg}


def _check_ctc_edge(device) -> dict:
    case = ctc_edge_case(device)
    losses0, _, g0 = _ctc_value_and_grad(ctc_ll_reference, *case, mean=True)
    losses1, _, g1 = _ctc_value_and_grad(ctc_ll, *case, mean=True)
    inf0, inf1 = torch.isinf(losses0), torch.isinf(losses1)
    result = {"impossible": int(inf0.sum().item())}
    finite = ~inf0
    rel = ((losses1[finite] - losses0[finite]).abs() / losses0[finite].abs()).max().item()
    dg = (g0 - g1).abs().max().item()
    result.update(max_err=max(rel, dg), max_abs_err=max((losses1[finite] - losses0[finite]).abs().max().item(), dg))
    if not torch.equal(inf0, inf1) or int(inf0.sum()) != 1 or not bool(inf0[-1]):
        result.update(max_err=float("inf"), error=f"inf-ness differs: plain {inf0.tolist()}, kernel {inf1.tolist()}")
    elif bool((g1[inf1] != 0).any()) or not bool((g1[~inf1].abs().amax(dim=(1, 2)) > 0).all()):
        result.update(max_err=float("inf"), error="gradient of the impossible row not exactly 0, or of a possible row 0")
    return result


def attention_case(seed, b, t, heads, lengths, device):
    """A random bf16 packed qkv ``(b, t, 3 * heads * 64)`` and int32 ``lengths``."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, t, 3 * heads * 64)).astype(np.float32)
    return (torch.as_tensor(qkv, device=device).to(torch.bfloat16),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


def _attention_check(seed, b, t, heads, lengths):
    def check(device) -> dict:
        qkv, lens = attention_case(seed, b, t, heads, lengths, device)
        got = mha_from_qkv(qkv, lens, heads)
        want = mha_from_qkv_reference(qkv, lens, heads)
        result = {"max_err": ulp_bf16_error(got, want), "max_abs_err": (got.float() - want.float()).abs().max().item()}
        if not bool(torch.isfinite(got).all()):
            result.update(max_err=float("inf"), error="non-finite output")
        return result

    return check


def add_ln_case(seed, rows_shape, d, device):
    """The ``add_ln`` inputs of the JAX selftest: a residual stream of std 3, a branch of std 1, random affine."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.standard_normal((*rows_shape, d)) * 3.0)
    y = bf(rng.standard_normal((*rows_shape, d)))
    scale = torch.as_tensor(rng.standard_normal(d).astype(np.float32) + 1.0, device=device)
    bias = torch.as_tensor(rng.standard_normal(d).astype(np.float32), device=device)
    return x, y, scale, bias


def _check_add_ln(device) -> dict:
    case = add_ln_case(5, (8, 768), 768, device)
    got, want = add_layer_norm(*case), add_layer_norm_reference(*case)
    return {"max_err": ulp_bf16_error(got, want), "max_abs_err": (got.float() - want.float()).abs().max().item()}


def beam_case(seed, b, t, v, device):
    """The ``beam_device`` inputs of the JAX selftest: logits with +2 on blank 0, lengths ``linspace(t // 2, t, b)``."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logits[:, :, 0] += 2.0
    lengths = np.linspace(t // 2, t, b).astype(np.int32)
    return torch.as_tensor(logits, device=device), torch.as_tensor(lengths, device=device)


def _hypotheses(toks: torch.Tensor) -> list:
    return [row[row >= 0].tolist() for row in toks[:, 0].cpu()]


def _float_diff(got, want) -> float:
    """max |got - want| over finite entries; inf where the finite entries differ."""
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        return float("inf")
    return (got[finite] - want[finite]).abs().max().item() if bool(finite.any()) else 0.0


def _beam_check(seed, b, t, v, width, k):
    def check(device) -> dict:
        logits, lengths = beam_case(seed, b, t, v, device)
        logp = torch.log_softmax(logits, dim=-1)
        kw = dict(blank=0, beam_width=width, k_tokens=k)
        runs = []
        for scan, backtrace in ((beam_scan, beam_backtrace), (beam_scan_reference, beam_backtrace_reference)):
            parents, exts, total, state = scan(logp, lengths, -12.0, **kw)
            slots0 = torch.argsort(-total, dim=1, stable=True)[:, :1].to(torch.int32)
            toks, origin = backtrace(parents, exts, slots0)
            runs.append((parents, exts, total, state, toks, origin))
        (p1, e1, t1, s1, k1, o1), (p0, e0, t0, s0, k0, o0) = runs
        err = max(_float_diff(t1, t0), _float_diff(s1[0], s0[0]), _float_diff(s1[1], s0[1]))
        result = {"max_err": err, "max_abs_err": err, "hypotheses": b}
        exact = (torch.equal(p1, p0) and torch.equal(e1, e0) and all(torch.equal(x, y) for x, y in zip(s1[2:], s0[2:]))
                 and torch.equal(k1, k0) and torch.equal(o1, o0) and _hypotheses(k1) == _hypotheses(k0))
        if not exact:
            result.update(max_err=float("inf"), error="pointers, exts, integer state or hypotheses differ")
        return result

    return check


def _check_beam_stream(device) -> dict:
    from thunder_tpu_torch.ops.ctc_beam_device import beam_search_device_stream

    logits, lengths = beam_case(3, 64, 751, 29, device)
    kw = dict(blank=0, beam_width=16, max_tokens_per_step=None)
    whole = beam_search_device_stream(logits, lengths, **kw)
    state = None
    for lo, hi in ((0, 188), (188, 376), (376, 563), (563, 751)):
        state = beam_search_device_stream(logits[:, lo:hi].contiguous(), (lengths - lo).clamp(0, hi - lo), state=state,
                                          **kw)
    err = max(_float_diff(a, b) for a, b in zip(state.arrays[:2], whole.arrays[:2]))
    result = {"max_err": err, "max_abs_err": err}
    same = (all(torch.equal(a, b) for a, b in zip(state.arrays[2:], whole.arrays[2:]))
            and [p.tolist() for p in state.best()] == [p.tolist() for p in whole.best()])
    if not same:
        result.update(max_err=float("inf"), error="integer state or best prefixes differ from the whole utterance")
    return result


KERNEL_CHECKS: Dict[str, tuple[Callable[[str], dict], float]] = {
    # name -> (check fn, tolerance); units: absolute log-mel for the frontend,
    # bf16 ULPs at the reference's max magnitude for the separable repeat
    "frontend_log_mel": (_check_frontend, 2e-3),
    "separable_conv": (_separable_check(1, 4, 384, 512, 512, 33), 8.0),  # QuartzNet15x5 body shape
    "separable_conv_stem": (_separable_check(13, 4, 768, 64, 256, 33, stride=2), 8.0),
    "separable_conv_tail": (_separable_check(14, 4, 384, 512, 512, 87, dilation=2), 8.0),
    "repeat_tm": (_separable_check(2, 16, 384, 256, 256, 33, ragged=True), 8.0),  # ragged lengths, exact-zero mask
    # CTC: max(abs loss delta, grad delta / max|grad|) at B=16, T=751, V=29, L=43, the JAX check's limit;
    # the edge case: max(rel loss delta, abs grad delta), the JAX package's gradient atol, inf on a
    # structural fault
    "ctc_recursion": (_check_ctc_recursion, 0.01),
    "ctc_edge": (_check_ctc_edge, 1e-5),
    # attention and add + LayerNorm: bf16 ULPs at the plain version's max magnitude
    "attn_onepanel": (_attention_check(4, 2, 256, 4, [256, 199]), 4.0),
    "attn_onepanel_1536": (_attention_check(6, 2, 1536, 12, [1536, 1479]), 4.0),
    "attn_onepanel_749": (_attention_check(7, 4, 749, 12, [749, 512, 37, 0]), 4.0),
    "add_ln": (_check_add_ln, 2.0),
    # beam search: exact pointers, exts, integer state and hypotheses (else inf), then the float
    # state's and total's largest difference, within the JAX package's score tolerance
    "beam_device": (_beam_check(3, 64, 751, 29, 16, 29), 2e-3),
    "beam_device_topk": (_beam_check(4, 64, 188, 1025, 16, 50), 2e-3),
    "beam_stream": (_check_beam_stream, 2e-3),
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
