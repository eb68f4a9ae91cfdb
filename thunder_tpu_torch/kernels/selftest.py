"""On-card numerics checks: each CUDA kernel against its plain PyTorch version.

Port of ``thunder_tpu/kernels/selftest.py`` for the kernels this package has,
with its check names and tolerances: ``frontend_log_mel`` (2e-3 absolute,
log-mel units; the ``frontend_log_mel_edge_*`` checks, ``LOG_MEL_EDGES``,
hold the kernel to the same limit at 44.1 and 48 kHz with n_fft 2048, hop
161, n_fft 4096, the dense path's n_fft 400, frame counts that end inside a
tile with a row of zeros, a clip of one frame, 66,536 rows (two launches
over row slices) and the wide path's n_fft 32,768, and fail unless the plan
takes the path named), ``separable_conv`` and ``repeat_tm`` (8 bf16 ULP at the
reference's maximum magnitude), ``ctc_recursion`` (0.01: absolute loss delta
or gradient delta relative to the largest gradient, against the plain time
loop). ``ctc_edge`` holds the CTC kernels to the JAX package's CPU limits on
its edge case (a repeated label, an empty target, T = 61) plus one impossible
alignment, which must give ``+inf`` on both routes and an exactly zero
gradient. ``ctc_long_target`` holds the pair to the plain loop with
``ctc_recursion``'s measure and limit past one warp a row: B = 2, T =
1200, S = 1025 and 2049 (targets of 512 and 1024 labels, and 37 fewer on the
second row, 1200 and 1100 frames). ``ctc_log_1_3`` counts the floats in [1,
3] whose logarithm in the CTC chain differs from CUDA's ``logf`` in a bit
(limit 0). ``separable_conv_stem`` and
``separable_conv_tail`` add QuartzNet's strided stem and dilated tail, which
the TPU kernels did not take; ``repeat_tm`` runs ragged lengths and fails
unless every row beyond a length is exactly zero. The ``separable_edge_*``
checks (``SEPARABLE_EDGES``) hold the kernel at the edges of its tiles: C_in
and C_out no multiple of 64 (200 -> 264), T_out = 1 and 65, k = 1, the
strided stem and the dilated tail with a row of length 0, C_in = 1024, C_in =
C_out = 100 (padded to 104 by the wrapper), C_in = 2048 and 1544 (two
launches over slices of C_in), and spans too long for 64 channels (k 561 and
1201 at dilation 2, k 1601 at stride 2, k 561 at C_in 2048: launches over
slices of the taps), each to 8 bf16 ULP and exact zeros beyond every length; the ``separable_citrinet_*`` checks (``SEPARABLE_CITRINET``)
at Citrinet-256's own shapes: the stem from 80 channels (k 5, T 1501), a
stride-2 repeat without ReLU (256 channels, k 11, T 1501 -> 751) and the
640-channel tail (k 41, T 188). ``frontend_log_mel_80`` is Citrinet's
80-mel frontend at n_fft 512 (the FFT path). ``attn_onepanel``
(B = 2, T = 256, 4 heads), ``attn_onepanel_1536`` (B = 2, T = 1536, 12
heads) and ``add_ln`` (8 x 768 rows x 768) keep the JAX names and limits (4,
4 and 2 bf16 ULP; ``add_ln_width36`` and ``add_ln_width2056`` hold the
kernel that re-reads the row to the same 2); ``attn_onepanel_749`` adds the wav2vec2-base serving
length at 15 s (T = 749, not a multiple of 128) with ragged lengths and a
row of length 0; ``attn_long_3001`` a 60 s chunk (B = 1, T = 3001, 12 heads),
past the 1664 frames that the first kernel's score panel held. The attention
checks compare every query row, padded ones included. ``beam_device`` keeps the JAX check's name and shape (B = 64,
T = 751, V = 29, beam 16, standard normal logits with +2 on blank 0, lengths
``linspace(T // 2, T, B)``) and, like it, demands exact agreement: the
kernels' pointers, exts, integer state and best hypotheses must equal the
plain versions'; its number is then the largest difference of the float
state and ``total`` (limit 2e-3, the JAX package's score tolerance against
its host search; both routes compute the same float32 operations, so it is
0 when the card's ``expf``/``log1pf`` round as PyTorch's do).
``beam_device_v1025_all_tokens`` (B = 4, T = 60, V = K = 1025) and
``beam_device_w300`` (B = 4, T = 120, V = 29, beam 300) hold it exactly past
the JAX package's 8,192 candidates a frame; ``beam_device_k3000`` (B = 16,
T = 188, V = K = 3000, beam 16) and ``beam_device_w64_k1000`` (B = 4, T =
40, V = K = 1000, beam 64, the ranking path) past one block of shared
memory, where the scan walks each frame in chunks; ``beam_device_w3000`` (B =
2, T = 10, V = K = 29, beam 3,000) past the state that fits in shared memory
(the workspace plan), and ``beam_backtrace_w7000`` (B = 1, T = 20, V = K =
5, beam 7,000) walks every slot's path with the backtrace's loads from device
memory; ``beam_backtrace_window`` walks every slot's path of a ``predict_long``
window (B = 2, T = 1001, V = 29, beam 16, rows of 500 and 1,001 frames).
``beam_device_topk`` runs the ``K < V`` pre-prune at the Citrinet serving
shape (B = 64, T = 188, V = 1025, K = 50, beam 16), and ``beam_stream``
holds four windows that tile the ``beam_device`` utterance, each one scan
from the carried state, to the whole utterance at once: the same state and
the same best prefixes. ``beam_ties_dead`` runs the ``beam_device`` shape on
integer-valued logits (:func:`ties_dead_case`: one or two tokens a frame at
+3, half of them the blank, the rest at -2..0, every 50th frame flat,
lengths from 0 to T) with a floor of -3, which keeps one or two tokens a
frame and empties the flat frames: exact ties everywhere, fewer finite
candidates than the beam over each row's first frames (dead picks, index 0)
and skipped frames; it is exact like ``beam_device`` and fails if no slot
ends dead.

The training kernels keep the JAX names, shapes and limits too:
``attn_train_grad`` (B = 2, T = 768, 12 heads, lengths ``[T, T - 129]``, the
cotangent zero on padded queries, no dropout), ``attn_train_dropout`` and
``attn_train_dropout_1536`` (B = 2, 2 heads, rate 0.3, T = 128 and 1536) and
``add_ln_train`` (2 x 512 rows x 768, rate 0.1; ``add_ln_train_width36`` and
``add_ln_train_width2056`` at the widths of ``ADD_LN_WIDTHS``, which run the
kernels that re-read the row), each at 8 bf16 ULP for the
forward and the bf16 gradients, and 1 % relative (1.0 in the check's units)
for the float32 ``dscale`` and ``dbias``. Each holds the kernels both to
their plain versions and to a float32 reference that applies the same mask
(the mask is the shared hash's, so it is computed, not recovered through
probes as on the TPU), and returns ``inf`` when two runs with one seed differ
in any bit, forward or backward, or when the kept fraction lies more than 5
sigma from ``1 - rate``. ``add_ln_train_rows5992`` (8 x 749 rows, the
wav2vec2-base step's, the backward's grid at two blocks an SM) and
``add_ln_train_rows3`` (fewer rows than a backward block has warps) hold
the same limits; ``add_ln_train_repeat`` runs the backward five times at
the step's shape on one seed, with a launch of other rows between, and
fails unless dx, dy, dscale and dbias are equal bit for bit. ``attn_train_749`` adds the training length at 15 s
with ragged lengths, a row of length 0 and rate 0.1: the uniform row must stay
finite forward and backward; ``attn_train_long_2048`` a batch of about 41 s
(B = 2, T = 2048, 12 heads, lengths ``[2048, 1900]``, rate 0.1).

Both sides run on the same device and the same inputs; the float32 reference
runs without TF32 (:func:`exact_float32` is set first).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from thunder_tpu_torch.kernels import _build
from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference
from thunder_tpu_torch.kernels.add_ln_train import (
    add_ln_train_backward,
    add_ln_train_backward_reference,
    add_ln_train_forward,
    add_ln_train_forward_reference,
    dropout_keep_mask,
    dropout_keep_mask_reference,
)
from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference
from thunder_tpu_torch.kernels.attention_train import (
    attention_keep_mask,
    mha_train_backward,
    mha_train_backward_reference,
    mha_train_forward,
    mha_train_forward_reference,
)
from thunder_tpu_torch.kernels.beam import beam_backtrace, beam_backtrace_reference, beam_scan, beam_scan_reference
from thunder_tpu_torch.kernels.ctc import ctc_ll, ctc_ll_reference, extended_emissions, scores_from_ll
from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_plan, log_mel_reference
from thunder_tpu_torch.kernels.separable_conv import (
    fused_separable_repeat,
    output_length,
    separable_repeat_reference,
)

__all__ = ["run_selftests", "KERNEL_CHECKS", "SEPARABLE_EDGES", "SEPARABLE_CITRINET", "LOG_MEL_EDGES", "ADD_LN_WIDTHS",
           "ulp_bf16_error", "exact_float32"]


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


def _separable_case(seed, b, t, c, co, k, stride=1, dilation=1, ragged=False, device="cuda", lengths=None):
    """Random bf16 inputs of one repeat, zero beyond the input lengths, BN scale folded into pw.
    ``lengths`` gives the input lengths; else they are ``t``, or random in ``[1, t]`` (the first ``t``)
    with ``ragged``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    if lengths is not None:
        lengths = np.asarray(lengths)
    else:
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


def _log_mel_check(seed, batch, time, path, zero_row=None, **config):
    """The log-mel kernel against its plain version on noise audio at one configuration (``fused_log_mel``'s
    keywords), with row ``zero_row`` all zeros; ``inf`` unless the plan takes ``path``."""
    def check(device) -> dict:
        audio = np.random.default_rng(seed).standard_normal((batch, time)).astype(np.float32) * 0.2
        if zero_row is not None:
            audio[zero_row] = 0.0
        x = torch.as_tensor(audio, device=device)
        err = (fused_log_mel(x, **config) - log_mel_reference(x, **config)).abs().max().item()
        taken = log_mel_plan(config.get("n_fft", 512), config.get("hop_length", 160), config.get("win_length", 320),
                             config.get("n_mels", 64))["path"]
        result = {"max_err": err, "max_abs_err": err, "path": taken}
        if taken != path:
            result.update(max_err=float("inf"), error=f"the plan takes the {taken} path, not {path}")
        return result
    return check


def _separable_check(seed, b, t, c, co, k, stride=1, dilation=1, ragged=False, lengths=None, relu=True):
    def check(device) -> dict:
        case = {**_separable_case(seed, b, t, c, co, k, stride, dilation, ragged, device, lengths), "relu": relu}
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


def ctc_long_case(seed, s_dim, device, t=1200):
    """B = 2, V = 29: targets of ``(s_dim - 1) / 2`` random labels (repeats included) and 37 fewer, over
    ``t`` and ``t - 100`` frames (every alignment possible when ``t`` leaves room for the repeats)."""
    rng = np.random.default_rng(seed)
    b, v, labels = 2, 29, (s_dim - 1) // 2
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    targets = rng.integers(1, v, (b, labels))
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return (as_t(logits, torch.float32), as_t(targets, torch.int32), as_t([t, t - 100], torch.int32),
            as_t([labels, labels - 37], torch.int32))


def _check_ctc_long_target(device) -> dict:
    """``ctc_recursion``'s measure at S = 1025 and 2049 extended states: five and nine warps of eight states a
    lane."""
    result = {"max_err": 0.0, "max_abs_err": 0.0}
    for s_dim in (1025, 2049):
        case = ctc_long_case(15, s_dim, device)
        losses0, total0, g0 = _ctc_value_and_grad(ctc_ll_reference, *case)
        losses1, total1, g1 = _ctc_value_and_grad(ctc_ll, *case)
        dl = (total0 - total1).abs().item()
        dg_abs = (g0 - g1).abs().max().item()
        dg = dg_abs / max(g0.abs().max().item(), 1e-9)
        result[f"loss_delta_{s_dim}"], result[f"grad_rel_delta_{s_dim}"] = dl, dg
        result["max_err"] = max(result["max_err"], dl, dg)
        result["max_abs_err"] = max(result["max_abs_err"], dl, dg_abs)
        if not (bool(torch.isfinite(losses0).all()) and bool(torch.isfinite(losses1).all())):
            result.update(max_err=float("inf"), error=f"an impossible alignment at S = {s_dim}: {losses0}, {losses1}")
    return result


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


def _check_ctc_log_1_3(device) -> dict:
    """The CTC chain's logarithm (``log_1_3`` in ``csrc/ctc_recursion.cu``: CUDA's ``logf`` on [1, 3] without its
    branches for zero, subnormals and infinities) against ``logf`` on every float in [1, 3]: the count whose bits
    differ. At 0, the kernels' alpha keeps the plain version's bits."""
    differs = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(_build.load().thunder_ctc_log_1_3_check(differs.data_ptr(), stream), "thunder_ctc_log_1_3_check")
    n = float(differs.item())
    return {"max_err": n, "max_abs_err": n, "floats": 0x40400000 - 0x3F800000 + 1}


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


def _add_ln_check(seed, rows_shape, d):
    def check(device) -> dict:
        case = add_ln_case(seed, rows_shape, d, device)
        got, want = add_layer_norm(*case), add_layer_norm_reference(*case)
        return {"max_err": ulp_bf16_error(got, want), "max_abs_err": (got.float() - want.float()).abs().max().item()}

    return check


def attention_f32_reference(qkv, lengths, heads, mask=None, keep=1.0):
    """The JAX selftest's ``_attn_train_ref``: unfused float32 attention over a float32 packed qkv,
    with an optional dropout mask ``(B, heads, T, T)`` on the probabilities; differentiable."""
    b, t, h3 = qkv.shape
    h = h3 // 3
    per_head = lambda a: a.reshape(b, t, heads, h // heads).transpose(1, 2)  # noqa: E731
    q, k, v = (per_head(a) for a in qkv.split(h, dim=-1))
    s = torch.matmul(q * (h // heads) ** -0.5, k.transpose(-1, -2))
    valid = (torch.arange(t, device=qkv.device)[None, :] < lengths[:, None])[:, None, None, :]
    p = torch.softmax(torch.where(valid, s, torch.finfo(torch.float32).min), dim=-1)
    if mask is not None:
        p = p * mask / keep
    return torch.matmul(p, v).transpose(1, 2).reshape(b, t, h)


def _kept_fraction_off(keep: torch.Tensor, rate: float) -> bool:
    """Whether the kept fraction of a mask lies more than 5 sigma from ``1 - rate``."""
    n = keep.numel()
    return abs(keep.float().mean().item() - (1.0 - rate)) > 5.0 * ((1.0 - rate) * rate / n) ** 0.5


def attention_train_case(seed, b, t, heads, lengths, device, zero_padded_cotangent=True):
    """The JAX selftests' training inputs: a bf16 packed qkv of std 0.3, int32 lengths and a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    h = heads * 64
    qkv = rng.standard_normal((b, t, 3 * h)).astype(np.float32) * 0.3
    lengths = np.asarray(lengths, np.int32)
    ct = rng.standard_normal((b, t, h)).astype(np.float32)
    if zero_padded_cotangent:
        ct = ct * (np.arange(t)[None, :] < lengths[:, None])[:, :, None]
    bf = lambda a: torch.as_tensor(a, device=device).to(torch.bfloat16)  # noqa: E731
    return bf(qkv), torch.as_tensor(lengths, device=device), bf(ct)


def _attention_train_check(seed, b, t, heads, lengths, rate, zero_padded_cotangent=True):
    def check(device) -> dict:
        qkv, lens, ct = attention_train_case(seed, b, t, heads, lengths, device, zero_padded_cotangent)
        sd = torch.tensor([20260821], dtype=torch.int32, device=device)
        out, stats = mha_train_forward(qkv, lens, sd, heads, rate)
        dqkv = mha_train_backward(qkv, out, stats, ct, lens, sd, heads, rate)
        out2, stats2 = mha_train_forward(qkv, lens, sd, heads, rate)
        dqkv2 = mha_train_backward(qkv, out2, stats2, ct, lens, sd, heads, rate)
        out_p, stats_p = mha_train_forward_reference(qkv, lens, sd, heads, rate)
        # the plain backward from the kernel's own saved output and statistics: what the kernels were given
        dqkv_p = mha_train_backward_reference(qkv, out, stats, ct, lens, sd, heads, rate)
        mask = attention_keep_mask(sd, b, heads, t, rate) if rate > 0.0 else None
        x = qkv.float().requires_grad_(True)
        out_f = attention_f32_reference(x, lens, heads, None if mask is None else mask.float(), 1.0 - rate)
        (dqkv_f,) = torch.autograd.grad(out_f, x, ct.float())
        errs = {"fwd_vs_plain": ulp_bf16_error(out, out_p), "fwd_vs_f32": ulp_bf16_error(out, out_f.detach()),
                "bwd_vs_plain": ulp_bf16_error(dqkv, dqkv_p), "bwd_vs_f32": ulp_bf16_error(dqkv, dqkv_f)}
        result = {"max_err": max(errs.values()), **errs,
                  "max_abs_err": max((out.float() - out_p.float()).abs().max().item(),
                                     (dqkv.float() - dqkv_p.float()).abs().max().item())}
        if not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(dqkv).all())):
            result.update(max_err=float("inf"), error="non-finite output or gradient")
        elif not (torch.equal(out, out2) and torch.equal(stats, stats2) and torch.equal(dqkv, dqkv2)):
            result.update(max_err=float("inf"), error="two runs with one seed differ")
        elif mask is not None and _kept_fraction_off(mask, rate):
            result.update(max_err=float("inf"), error=f"kept fraction {mask.float().mean().item()} at rate {rate}")
        return result

    return check


def add_ln_train_case(seed, rows_shape, d, device):
    """The ``add_ln_train`` inputs of the JAX selftest: a residual stream of std 2, a branch of std 1,
    random affine, a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.standard_normal((*rows_shape, d)) * 2.0)
    y = bf(rng.standard_normal((*rows_shape, d)))
    scale = torch.as_tensor(rng.standard_normal(d).astype(np.float32) + 1.0, device=device)
    bias = torch.as_tensor(rng.standard_normal(d).astype(np.float32), device=device)
    ct = bf(rng.standard_normal((*rows_shape, d)))
    return x, y, scale, bias, ct


def add_ln_f32_reference(x, y, scale, bias, mask, rate, eps=1e-5):
    """The JAX selftest's float32 reference of ``LayerNorm(x + dropout(y))`` given the mask; differentiable."""
    s = x + y * mask / (1.0 - rate)
    mu = s.mean(dim=-1, keepdim=True)
    var = ((s * s).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (s - mu) * (torch.rsqrt(var + eps) * scale) + bias


def _add_ln_train_check(seed, rows_shape, d, rate=0.1):
    return lambda device: _check_add_ln_train(device, seed, rows_shape, d, rate)


def _check_add_ln_train(device, seed=12, rows_shape=(2, 512), d=768, rate=0.1) -> dict:
    x, y, scale, bias, ct = add_ln_train_case(seed, rows_shape, d, device)
    sd = torch.tensor([20260821], dtype=torch.int32, device=device)
    run = lambda: (add_ln_train_forward(x, y, scale, bias, sd, rate),  # noqa: E731
                   *add_ln_train_backward(x, y, scale, sd, ct, rate))
    got, again = run(), run()
    plain = (add_ln_train_forward_reference(x, y, scale, bias, sd, rate),
             *add_ln_train_backward_reference(x, y, scale, sd, ct, rate))
    mask = dropout_keep_mask(x.shape, sd, rate)
    args = [a.float().requires_grad_(True) for a in (x, y, scale, bias)]
    out_f = add_ln_f32_reference(*args, mask, rate)
    f32 = (out_f.detach(), *torch.autograd.grad(out_f, args, ct.float()))
    errs = {}
    for ref_name, ref in (("plain", plain), ("f32", f32)):
        for i, name in enumerate(("fwd", "dx", "dy")):
            errs[f"{name}_vs_{ref_name}"] = ulp_bf16_error(got[i], ref[i])
        for i, name in ((3, "dscale"), (4, "dbias")):  # float32 sums: 1 % relative is 1.0
            rel = (got[i] - ref[i]).abs().max().item() / max(ref[i].abs().max().item(), 1e-9)
            errs[f"{name}_vs_{ref_name}"] = rel * 100.0
    result = {"max_err": max(errs.values()), **errs, "max_abs_err": (got[0].float() - plain[0].float()).abs().max().item()}
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        result.update(max_err=float("inf"), error="two runs with one seed differ")
    elif not torch.equal(mask, dropout_keep_mask_reference(x.shape, sd, rate)):
        result.update(max_err=float("inf"), error="dropout_keep_mask differs from its plain version")
    elif _kept_fraction_off(mask, rate):
        result.update(max_err=float("inf"), error=f"kept fraction {mask.mean().item()} at rate {rate}")
    return result


def _check_add_ln_train_repeat(device) -> dict:
    """The backward at the train step's shape, five times on one seed with other launches between: dx, dy,
    dscale and dbias equal bit for bit (max_err 0, else inf)."""
    x, y, scale, _, ct = add_ln_train_case(45, (8, 749), 768, device)
    sd = torch.tensor([20260821], dtype=torch.int32, device=device)
    first = add_ln_train_backward(x, y, scale, sd, ct, 0.1)
    small = add_ln_train_case(46, (37,), 768, device)
    same = True
    for _ in range(4):
        add_ln_train_backward(small[0], small[1], small[2], sd, small[4], 0.1)
        same &= all(torch.equal(a, b) for a, b in zip(first, add_ln_train_backward(x, y, scale, sd, ct, 0.1)))
    result = {"max_err": 0.0 if same else float("inf"), "max_abs_err": 0.0, "repeats": 5}
    if not same:
        result["error"] = "the backward gave other bits on one seed"
    return result


def beam_case(seed, b, t, v, device):
    """The ``beam_device`` inputs of the JAX selftest: logits with +2 on blank 0, lengths ``linspace(t // 2, t, b)``."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logits[:, :, 0] += 2.0
    lengths = np.linspace(t // 2, t, b).astype(np.int32)
    return torch.as_tensor(logits, device=device), torch.as_tensor(lengths, device=device)


def pointer_field(seed, b, t, w, n_out, device, offset=0):
    """Random beam pointers (B, T, W) int32 with about 1 in 8 outside [0, W) (-1, -7, W, W + 5), tokens in [-1, 29),
    and start slots (B, n_out) with -1, W and W + 5 among them; ``offset`` int32 words before the fields in their
    storage (a start that is not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, w, (b, t, w))
    off = rng.random((b, t, w)) < 0.125
    parents[off] = rng.choice([-1, -7, w, w + 5], off.sum())
    exts = rng.integers(-1, 29, (b, t, w))
    slots0 = rng.integers(0, w, (b, n_out))
    slots0[: min(b, 3), 0] = [-1, w, w + 5][: min(b, 3)]

    def placed(a):
        flat = torch.zeros(offset + a.size, dtype=torch.int32, device=device)
        flat[offset:] = torch.as_tensor(a.reshape(-1), dtype=torch.int32, device=device)
        return flat[offset:].view(a.shape)

    return placed(parents), placed(exts), torch.as_tensor(slots0, dtype=torch.int32, device=device)


def _hypotheses(toks: torch.Tensor) -> list:
    return [row[row >= 0].tolist() for row in toks[:, 0].cpu()]


def _float_diff(got, want) -> float:
    """max |got - want| over finite entries; inf where the finite entries differ."""
    finite = torch.isfinite(want)
    if not torch.equal(finite, torch.isfinite(got)):
        return float("inf")
    return (got[finite] - want[finite]).abs().max().item() if bool(finite.any()) else 0.0


def ties_dead_case(seed, b, t, v, device):
    """Integer-valued logits: a token at +3 on every frame (the blank on half of them), a second one on about
    a third, the rest at -2..0, every 50th frame flat; lengths ``linspace(0, t, b)``. Under a floor of -3 a
    frame keeps its one or two peaks, and a flat frame (every log-prob ``-log(v)``) keeps none, so a row's
    beams fill over its first frames and the short rows end with dead slots."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(-2, 1, (b, t, v)).astype(np.float32)
    rows, frames = np.meshgrid(np.arange(b), np.arange(t), indexing="ij")
    peak = np.where(rng.random((b, t)) < 0.5, 0, rng.integers(1, v, (b, t)))
    logits[rows, frames, peak] = 3.0
    second = rng.random((b, t)) < 0.3
    logits[rows[second], frames[second], rng.integers(0, v, (b, t))[second]] = 3.0
    logits[:, ::50] = 0.0
    lengths = np.linspace(0, t, b).astype(np.int32)
    return torch.as_tensor(logits, device=device), torch.as_tensor(lengths, device=device)


def _beam_check(seed, b, t, v, width, k, case=beam_case, floor=-12.0, paths=1):
    def check(device) -> dict:
        logits, lengths = case(seed, b, t, v, device)
        logp = torch.log_softmax(logits, dim=-1)
        kw = dict(blank=0, beam_width=width, k_tokens=k)
        runs = []
        for scan, backtrace in ((beam_scan, beam_backtrace), (beam_scan_reference, beam_backtrace_reference)):
            parents, exts, total, state = scan(logp, lengths, floor, **kw)
            slots0 = torch.argsort(-total, dim=1, stable=True)[:, :paths].to(torch.int32)
            toks, origin = backtrace(parents, exts, slots0)
            runs.append((parents, exts, total, state, toks, origin))
        (p1, e1, t1, s1, k1, o1), (p0, e0, t0, s0, k0, o0) = runs
        err = max(_float_diff(t1, t0), _float_diff(s1[0], s0[0]), _float_diff(s1[1], s0[1]))
        result = {"max_err": err, "max_abs_err": err, "hypotheses": b}
        exact = (torch.equal(p1, p0) and torch.equal(e1, e0) and all(torch.equal(x, y) for x, y in zip(s1[2:], s0[2:]))
                 and torch.equal(k1, k0) and torch.equal(o1, o0) and _hypotheses(k1) == _hypotheses(k0))
        result["dead_slots"] = int((s0[2] == -1).sum().item())
        if not exact:
            result.update(max_err=float("inf"), error="pointers, exts, integer state or hypotheses differ")
        elif case is ties_dead_case and result["dead_slots"] == 0:
            result.update(max_err=float("inf"), error="no slot ended dead: the case does not reach the dead picks")
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


#: the separable repeat at the edges of its tiles: name -> (``_separable_check`` arguments, keywords). The kernel
#: tiles 64 frames, 64 input channels a panel and 64 output channels a weight box; QuartzNet's shapes are all
#: multiples of 64, these are not.
SEPARABLE_EDGES = {
    "separable_edge_cin200": ((20, 3, 150, 200, 264, 33), {"lengths": [150, 0, 77]}),  # C_in, C_out not 64k
    "separable_edge_t1": ((21, 2, 1, 256, 256, 33), {}),  # T_out = 1
    "separable_edge_t65": ((22, 3, 65, 512, 520, 51), {"lengths": [65, 64, 0]}),  # one frame past a tile
    "separable_edge_k1": ((23, 2, 100, 128, 136, 1), {"lengths": [100, 0]}),
    "separable_edge_stem": ((24, 3, 301, 64, 256, 33), {"stride": 2, "lengths": [301, 0, 150]}),
    "separable_edge_tail": ((25, 2, 200, 512, 512, 87), {"dilation": 2, "lengths": [200, 0]}),
    "separable_edge_cin1024": ((26, 2, 130, 1024, 1024, 33), {"lengths": [130, 0]}),  # one block an SM
    # channel counts that are not multiples of 8: zero-padded by the wrapper
    "separable_edge_cin100": ((27, 2, 120, 100, 100, 33), {"lengths": [120, 0]}),
    # A tiles past one block: two launches over slices of C_in, the second one not a multiple of 64
    "separable_edge_cin2048": ((28, 2, 130, 2048, 2048, 33), {"lengths": [130, 61]}),
    "separable_edge_cin1544": ((29, 2, 70, 1544, 264, 33), {"lengths": [70, 0]}),
    # spans too long for 64 channels beside their A tile: launches over slices of the taps (two at k = 561 and
    # dilation 2, the smallest such k; three at 1201; at stride 2; and each over 32 slices of C_in at 2048)
    "separable_edge_taps561": ((53, 2, 700, 256, 256, 561), {"dilation": 2, "lengths": [700, 0]}),
    "separable_edge_taps1201": ((54, 2, 900, 256, 264, 1201), {"dilation": 2, "lengths": [900, 311]}),
    "separable_edge_taps_stride2": ((55, 2, 2000, 64, 64, 1601), {"stride": 2, "lengths": [2000, 1500]}),
    "separable_edge_taps_cin2048": ((56, 1, 300, 2048, 128, 561), {"dilation": 2}),
}

#: add + LayerNorm at widths its register-resident kernels do not take (not a multiple of 8, over 2048): the
#: kernels that re-read the row. name -> (seed, rows, width)
ADD_LN_WIDTHS = {"width36": (40, (8, 100), 36), "width2056": (41, (3, 67), 2056)}

#: the log-mel kernel at other sizes: name -> (``_log_mel_check`` arguments, keywords). The FFT path tiles 16
#: frames at n_fft 512 (fewer as n_fft grows); the dense path takes any other n_fft.
LOG_MEL_EDGES = {
    "frontend_log_mel_edge_44k1": ((30, 2, 44100, "fft"),
                                   dict(sample_rate=44100, n_fft=2048, hop_length=441, win_length=1103)),
    "frontend_log_mel_edge_48k": ((31, 2, 48000, "fft"),
                                  dict(sample_rate=48000, n_fft=2048, hop_length=480, win_length=1200)),
    "frontend_log_mel_edge_hop161": ((32, 2, 16000, "fft"), dict(hop_length=161)),
    "frontend_log_mel_edge_n4096": ((33, 2, 48000, "fft"),
                                    dict(sample_rate=48000, n_fft=4096, hop_length=480, win_length=2400, n_mels=128)),
    "frontend_log_mel_edge_dense400": ((34, 3, 16000, "dense"), dict(n_fft=400, win_length=400, n_mels=80)),
    # 101 frames a row: 6 tiles and 5 frames; row 1 all zeros (log 2^-24 everywhere)
    "frontend_log_mel_edge_ragged_zero_row": ((35, 3, 16100, "fft"), dict(zero_row=1)),
    # one frame: 100 samples at hop 160 (the reflect pad needs more than n_fft // 2 = 16)
    "frontend_log_mel_edge_one_frame": ((36, 2, 100, "fft"), dict(n_fft=32, win_length=32, n_mels=16)),
    # 78 frames: 4 tiles and 14 frames
    "frontend_log_mel_edge_frames_off_tile": ((37, 3, 12345, "fft"), {}),
    # Citrinet's 80-mel frontend at the default FFT size (the FFT path; the 80-mel dense check above is n_fft 400)
    "frontend_log_mel_80": ((38, 3, 16000, "fft"), dict(n_mels=80)),
    # past the grid's 65,535 rows: two launches over slices of rows, 0.1 s clips
    "frontend_log_mel_edge_rows66536": ((39, 65536 + 1000, 1600, "fft"), {}),
    # past one block's dense tile: the wide path (power through device memory), n_fft 32,768 with a 1 s window
    "frontend_log_mel_edge_wide32768": ((40, 2, 48000, "wide"),
                                        dict(n_fft=32768, hop_length=4096, win_length=16384, n_mels=128)),
}

#: the separable repeat at Citrinet-256's serving shapes that QuartzNet's do not cover, each with a row of
#: length 0 and a ragged row: the stem from the 80-mel features (a 160-byte row), a stride-2 last repeat
#: without ReLU in the middle of a block, and the 640-channel tail at the 8x-strided frame rate
SEPARABLE_CITRINET = {
    "separable_citrinet_stem": ((50, 4, 1501, 80, 256, 5), {"lengths": [1501, 0, 777, 1]}),
    "separable_citrinet_stride2": ((51, 4, 1501, 256, 256, 11),
                                   {"stride": 2, "relu": False, "lengths": [1501, 0, 1000, 2]}),
    "separable_citrinet_tail": ((52, 4, 188, 256, 640, 41), {"lengths": [188, 0, 95, 1]}),
}

KERNEL_CHECKS: Dict[str, tuple[Callable[[str], dict], float]] = {
    # name -> (check fn, tolerance); units: absolute log-mel for the frontend,
    # bf16 ULPs at the reference's max magnitude for the separable repeat
    "frontend_log_mel": (_check_frontend, 2e-3),
    **{name: (_log_mel_check(*args, **kw), 2e-3) for name, (args, kw) in LOG_MEL_EDGES.items()},
    "separable_conv": (_separable_check(1, 4, 384, 512, 512, 33), 8.0),  # QuartzNet15x5 body shape
    "separable_conv_stem": (_separable_check(13, 4, 768, 64, 256, 33, stride=2), 8.0),
    "separable_conv_tail": (_separable_check(14, 4, 384, 512, 512, 87, dilation=2), 8.0),
    "repeat_tm": (_separable_check(2, 16, 384, 256, 256, 33, ragged=True), 8.0),  # ragged lengths, exact-zero mask
    # the edges of the kernel's tiles, each with a row of length 0 where it has rows to spare
    **{name: (_separable_check(*args, **kw), 8.0) for name, (args, kw) in SEPARABLE_EDGES.items()},
    **{name: (_separable_check(*args, **kw), 8.0) for name, (args, kw) in SEPARABLE_CITRINET.items()},
    # CTC: max(abs loss delta, grad delta / max|grad|) at B=16, T=751, V=29, L=43, the JAX check's limit;
    # the edge case: max(rel loss delta, abs grad delta), the JAX package's gradient atol, inf on a
    # structural fault
    "ctc_recursion": (_check_ctc_recursion, 0.01),
    "ctc_edge": (_check_ctc_edge, 1e-5),
    "ctc_long_target": (_check_ctc_long_target, 0.01),
    # the chain's branch-free logarithm against logf, bit for bit: the floats in [1, 3] that differ
    "ctc_log_1_3": (_check_ctc_log_1_3, 0.0),
    # attention and add + LayerNorm: bf16 ULPs at the plain version's max magnitude
    "attn_onepanel": (_attention_check(4, 2, 256, 4, [256, 199]), 4.0),
    "attn_onepanel_1536": (_attention_check(6, 2, 1536, 12, [1536, 1479]), 4.0),
    "attn_onepanel_749": (_attention_check(7, 4, 749, 12, [749, 512, 37, 0]), 4.0),
    "attn_long_3001": (_attention_check(16, 1, 3001, 12, [3001]), 4.0),
    "add_ln": (_add_ln_check(5, (8, 768), 768), 2.0),
    **{f"add_ln_{name}": (_add_ln_check(*args), 2.0) for name, args in ADD_LN_WIDTHS.items()},
    # the training kernels: bf16 ULPs against the plain version and against the float32 reference with the
    # same mask; inf when two runs differ in a bit or the kept fraction is off (dscale, dbias: 1 % is 1.0)
    "attn_train_grad": (_attention_train_check(8, 2, 768, 12, [768, 768 - 129], 0.0), 8.0),
    "attn_train_dropout": (_attention_train_check(9, 2, 128, 2, [128, 128], 0.3, zero_padded_cotangent=False), 8.0),
    "attn_train_dropout_1536": (_attention_train_check(9, 2, 1536, 2, [1536, 1536], 0.3, zero_padded_cotangent=False), 8.0),
    "attn_train_749": (_attention_train_check(10, 4, 749, 12, [749, 512, 37, 0], 0.1), 8.0),
    "attn_train_long_2048": (_attention_train_check(17, 2, 2048, 12, [2048, 1900], 0.1), 8.0),
    "add_ln_train": (_check_add_ln_train, 8.0),
    **{f"add_ln_train_{name}": (_add_ln_train_check(*args), 8.0) for name, args in ADD_LN_WIDTHS.items()},
    # wav2vec2-base's train step (8 x 749 rows: two blocks an SM), fewer rows than the backward has warps in a
    # block, and the backward's bits from run to run at the step's shape
    "add_ln_train_rows5992": (_add_ln_train_check(43, (8, 749), 768), 8.0),
    "add_ln_train_rows3": (_add_ln_train_check(44, (3,), 768), 8.0),
    "add_ln_train_repeat": (_check_add_ln_train_repeat, 8.0),
    # beam search: exact pointers, exts, integer state and hypotheses (else inf), then the float
    # state's and total's largest difference, within the JAX package's score tolerance
    "beam_device": (_beam_check(3, 64, 751, 29, 16, 29), 2e-3),
    "beam_device_topk": (_beam_check(4, 64, 188, 1025, 16, 50), 2e-3),
    "beam_stream": (_check_beam_stream, 2e-3),
    "beam_ties_dead": (_beam_check(5, 64, 751, 29, 16, 29, case=ties_dead_case, floor=-3.0), 2e-3),
    # past the JAX package's 8,192 candidates a frame: Citrinet's V = 1025 with every token a step, and W = 300
    "beam_device_v1025_all_tokens": (_beam_check(6, 4, 60, 1025, 16, 1025), 2e-3),
    "beam_device_w300": (_beam_check(7, 4, 120, 29, 300, 29), 2e-3),
    # past one block of shared memory (the chunked scan): every token a step at K = 3,000 and W = 16, and W = 64
    # (the ranking path) at K = 1,000
    "beam_device_k3000": (_beam_check(8, 16, 188, 3000, 16, 3000), 2e-3),
    "beam_device_w64_k1000": (_beam_check(9, 4, 40, 1000, 64, 1000), 2e-3),
    # past the shared memory of one block (the workspace plan: the state in device memory) at W = 3,000, and at
    # W = 7,000 every slot's path walked from device memory (one frame of pointers over the backtrace's 48 KB)
    "beam_device_w3000": (_beam_check(10, 2, 10, 29, 3000, 29), 2e-3),
    "beam_backtrace_w7000": (_beam_check(11, 1, 20, 5, 7000, 5, paths=7000), 2e-3),
    # a predict_long window's backtrace: every slot's path (n_out = W = 16) over 1,001 frames, the composed walk
    # (rows of 500 and 1,001 frames)
    "beam_backtrace_window": (_beam_check(12, 2, 1001, 29, 16, 29, paths=16), 2e-3),
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
