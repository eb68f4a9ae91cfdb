"""Analytic model-FLOPs and MFU accounting.

Port of ``thunder_tpu/flops.py``, with its own copy of every counter and
constant. Every perf claim in this repo is RTF-denominated; this module adds
the model-FLOPs-utilization (MFU) view so "fast" is auditable against the
card's peak: ``MFU = model_flops_per_sec / peak_flops``. Model FLOPs are the
*analytic* conv + matmul count of the architecture (the convention from the
PaLM appendix: elementwise and normalization work is excluded,
rematerialization is not credited), so MFU is comparable across
implementations.

Two independent sources are provided and cross-checked in tests:

- analytic counters for the model families (:func:`quartznet_forward_flops`,
  :func:`wav2vec2_forward_flops`, :func:`filterbank_flops`), the same
  integers as the JAX package's;
- :func:`counted_flops`: PyTorch's own count of the products and
  convolutions a call runs (``torch.utils.flop_counter.FlopCounterMode``),
  the counterpart of the JAX package's ``xla_flops``.

Backward pass: the standard 2x-forward rule (one matmul each for the input
and weight gradients), so a train step is ~3x the forward FLOPs of the
trainable path plus 1x the (non-trainable, stop-gradiented) frontend.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = [
    "conv1d_flops",
    "dense_flops",
    "filterbank_flops",
    "quartznet_forward_flops",
    "quartznet_forward_flops_split",
    "quartznet_train_flops",
    "citrinet_forward_flops",
    "citrinet_forward_flops_split",
    "citrinet_train_flops",
    "wav2vec2_forward_flops",
    "wav2vec2_extractor_flops",
    "wav2vec2_train_flops",
    "counted_flops",
    "peak_flops",
    "mfu",
    "CITRINET_256_FILTERS",
    "CITRINET_256_KERNELS",
    "CITRINET_256_STRIDES",
]


def conv1d_flops(kernel_size: int, c_in: int, c_out: int, t_out: int, groups: int = 1, batch: int = 1) -> int:
    """2 * MACs of a 1-D conv producing ``(batch, t_out, c_out)``."""
    return 2 * kernel_size * (c_in // groups) * c_out * t_out * batch


def dense_flops(d_in: int, d_out: int, tokens: int = 1) -> int:
    """2 * MACs of a matmul over ``tokens`` rows."""
    return 2 * d_in * d_out * tokens


def _conv_t_out(t: int, stride: int) -> int:
    # all convs in these families use same-padding: t_out == ceil(t / stride)
    return -(-t // stride)


def filterbank_flops(samples: int, *, hop_length: int = 160, n_fft: int = 512, nfilt: int = 64, batch: int = 1) -> int:
    """Mel frontend as computed here: windowed-DFT matmul + mel matmul.

    The DFT is a real matmul ``(frames, n_fft) x (n_fft, 2*(n_fft//2+1))``
    (`ops/stft.py`), the mel projection ``(frames, n_fft//2+1) x (bins, nfilt)``.
    """
    frames = samples // hop_length + 1
    bins = n_fft // 2 + 1
    dft = dense_flops(n_fft, 2 * bins, frames)
    mel = dense_flops(bins, nfilt, frames)
    return batch * (dft + mel)


def quartznet_forward_flops(
    frames: int,
    *,
    feat_in: int = 64,
    filters=(256, 256, 512, 512, 512),
    kernel_sizes=(33, 39, 51, 63, 75),
    repeat_blocks: int = 3,
    repeat: int = 5,
    num_classes: int = 29,
    batch: int = 1,
) -> int:
    """Analytic conv FLOPs of the QuartzNet encoder + 1x1 CTC decoder.

    Mirrors the block list of ``models/quartznet.py`` exactly: separable stem
    (stride 2), ``repeat_blocks`` x body blocks of ``repeat`` separable convs
    + 1x1 residual, the k=87 dilated and 1x1 1024ch tail blocks, then the
    decoder.  Defaults are the 15x5 flagship.
    """
    dw, matmul = quartznet_forward_flops_split(
        frames,
        feat_in=feat_in,
        filters=filters,
        kernel_sizes=kernel_sizes,
        repeat_blocks=repeat_blocks,
        repeat=repeat,
        num_classes=num_classes,
        batch=batch,
    )
    return dw + matmul


def quartznet_forward_flops_split(
    frames: int,
    *,
    feat_in: int = 64,
    filters=(256, 256, 512, 512, 512),
    kernel_sizes=(33, 39, 51, 63, 75),
    repeat_blocks: int = 3,
    repeat: int = 5,
    num_classes: int = 29,
    batch: int = 1,
) -> tuple:
    """``(depthwise_flops, matmul_flops)`` split of the QuartzNet forward.

    Depthwise convs have no contraction dimension (one weight per
    (tap, channel)) so they run on the card's float32 pipes; everything else
    (pointwise 1x1, residual 1x1, decoder) is a matmul on the tensor cores.
    The two terms hit different rooflines.
    """
    dw = 0
    matmul = 0
    c = feat_in
    # stem: k=33, stride 2, separable, 256ch
    t = _conv_t_out(frames, 2)
    dw += conv1d_flops(33, c, c, t, groups=c)
    matmul += conv1d_flops(1, c, 256, t)
    c = 256
    # body blocks: repeat x separable convs + 1x1 residual from block input
    for f, k in zip(filters, kernel_sizes):
        for _ in range(repeat_blocks):
            c_in_block = c
            for _ in range(repeat):
                dw += conv1d_flops(k, c, c, t, groups=c)
                matmul += conv1d_flops(1, c, f, t)
                c = f
            matmul += conv1d_flops(1, c_in_block, f, t)
    # tail: k=87 dilation-2 512ch separable (no residual), then 1x1 1024ch dense
    dw += conv1d_flops(87, c, c, t, groups=c)
    matmul += conv1d_flops(1, c, 512, t)
    c = 512
    matmul += conv1d_flops(1, c, 1024, t)
    c = 1024
    # decoder: 1x1 conv 1024 -> vocab
    matmul += conv1d_flops(1, c, num_classes, t)
    return batch * dw, batch * matmul


def quartznet_train_flops(samples: int, *, batch: int = 1, hop_length: int = 160, **kw) -> int:
    """Train-step model FLOPs: 3x the trainable path + 1x the frontend
    (stop-gradiented statistics, no parameters — forward only)."""
    frames = samples // hop_length + 1
    return 3 * quartznet_forward_flops(frames, batch=batch, **kw) + filterbank_flops(
        samples, hop_length=hop_length, batch=batch
    )


# Citrinet-256 body: three megablocks (6 + 7 + 8 blocks), stride 2 on the
# first block of each, 256 channels throughout (the per-block
# (filters, kernel, stride) layout the reference's block list consumes,
# `citrinet/blocks.py:219-255`; kernel progression per the Citrinet paper's
# gamma=8 configuration).
CITRINET_256_FILTERS = (256,) * 21
CITRINET_256_KERNELS = (
    11, 13, 15, 17, 19, 21,
    13, 15, 17, 19, 21, 23, 25,
    25, 27, 29, 31, 33, 35, 37, 39,
)
CITRINET_256_STRIDES = tuple(2 if i in (0, 6, 13) else 1 for i in range(21))


def citrinet_forward_flops_split(
    frames: int,
    *,
    feat_in: int = 80,
    filters=CITRINET_256_FILTERS,
    kernel_sizes=CITRINET_256_KERNELS,
    strides=CITRINET_256_STRIDES,
    repeat: int = 5,
    se_reduction_ratio: int = 8,
    num_classes: int = 1025,
    batch: int = 1,
) -> tuple:
    """``(depthwise_flops, matmul_flops)`` split of the Citrinet forward.

    Mirrors ``models/citrinet.py`` exactly: separable SE stem (k=5, 256ch,
    stride 1), per-(filters, kernel, stride) body blocks of ``repeat``
    separable convs with the stride on the LAST repeat only + 1x1 residual
    + squeeze-excite, then the k=41 640ch SE tail block and the 1x1 CTC
    decoder.  Same depthwise/matmul roofline split as
    :func:`quartznet_forward_flops_split`; the squeeze-excite matmuls are
    one token per block (pooled), counted on the matmul side.
    """

    def se(c):
        r = max(c // se_reduction_ratio, 1)
        return dense_flops(c, r) + dense_flops(r, c)

    dw = 0
    matmul = 0
    t = frames
    # stem: k=5, separable, 256ch, SE, no residual, stride 1
    dw += conv1d_flops(5, feat_in, feat_in, t, groups=feat_in)
    matmul += conv1d_flops(1, feat_in, 256, t) + se(256)
    c = 256
    for f, k, s in zip(filters, kernel_sizes, strides):
        c_in_block = c
        for r in range(repeat):
            t_out = _conv_t_out(t, s) if r == repeat - 1 else t
            dw += conv1d_flops(k, c, c, t_out, groups=c)
            matmul += conv1d_flops(1, c, f, t_out)
            c, t = f, t_out
        matmul += conv1d_flops(1, c_in_block, f, t) + se(f)
    # tail: k=41, 640ch, separable, SE, no residual
    dw += conv1d_flops(41, c, c, t, groups=c)
    matmul += conv1d_flops(1, c, 640, t) + se(640)
    c = 640
    matmul += conv1d_flops(1, c, num_classes, t)  # decoder
    return batch * dw, batch * matmul


def citrinet_forward_flops(frames: int, **kw) -> int:
    """Analytic conv + matmul FLOPs of the Citrinet encoder + CTC decoder
    (defaults are the Citrinet-256 configuration)."""
    dw, matmul = citrinet_forward_flops_split(frames, **kw)
    return dw + matmul


def citrinet_train_flops(
    samples: int, *, batch: int = 1, hop_length: int = 160, nfilt: int = 80, **kw
) -> int:
    """Train-step model FLOPs: 3x the trainable path + 1x the (parameter-free,
    stop-gradiented) 80-mel frontend."""
    frames = samples // hop_length + 1
    return 3 * citrinet_forward_flops(frames, batch=batch, **kw) + filterbank_flops(
        samples, hop_length=hop_length, nfilt=nfilt, batch=batch
    )


def wav2vec2_forward_flops(
    samples: int,
    *,
    hidden_size: int = 768,
    num_hidden_layers: int = 12,
    intermediate_size: int = 3072,
    conv_dim=(512, 512, 512, 512, 512, 512, 512),
    conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2),
    num_classes: int = 32,
    batch: int = 1,
) -> int:
    """Analytic conv + matmul FLOPs of the wav2vec2 forward (base config
    defaults): conv feature extractor, feature projection, transformer
    (fused qkv, attention scores/values, out proj, FFN), CTC head."""
    total = 0
    t = samples
    c = 1
    for f, k, s in zip(conv_dim, conv_kernel, conv_stride):
        # extractor convs use VALID padding: t_out = floor((t - k) / s) + 1
        t = (t - k) // s + 1
        total += conv1d_flops(k, c, f, t)
        c = f
    h = hidden_size
    total += dense_flops(c, h, t)  # feature projection
    # pos-conv embedding: k=128 grouped conv (16 groups) in the standard arch
    total += conv1d_flops(128, h, h, t, groups=16)
    per_layer = (
        dense_flops(h, 3 * h, t)  # fused qkv
        + 2 * dense_flops(t, h, t)  # QK^T and AV: 2 * (2 * t * t * h)
        + dense_flops(h, h, t)  # out proj
        + 2 * dense_flops(h, intermediate_size, t)  # FFN up + down
    )
    total += num_hidden_layers * per_layer
    total += dense_flops(h, num_classes, t)  # CTC head
    return batch * total


def wav2vec2_extractor_flops(
    samples: int,
    *,
    conv_dim=(512, 512, 512, 512, 512, 512, 512),
    conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2),
    batch: int = 1,
) -> int:
    """Conv feature-extractor share of the wav2vec2 forward FLOPs."""
    total = 0
    t = samples
    c = 1
    for f, k, s in zip(conv_dim, conv_kernel, conv_stride):
        t = (t - k) // s + 1
        total += conv1d_flops(k, c, f, t)
        c = f
    return batch * total


def wav2vec2_train_flops(
    samples: int, *, batch: int = 1, frozen_extractor: bool = False, **kw
) -> int:
    """Train-step model FLOPs (fwd + ~2x fwd backward).  With the extractor
    frozen (the reference's unconditional ``freeze_feature_encoder()`` on
    load, `huggingface/compatibility.py:27-28`) the extractor backward is
    dead code — it has no trainable inputs upstream — so it counts once."""
    fwd = wav2vec2_forward_flops(samples, batch=batch, **kw)
    if not frozen_extractor:
        return 3 * fwd
    ext_kw = {
        k: v for k, v in kw.items() if k in ("conv_dim", "conv_kernel", "conv_stride")
    }
    ext = wav2vec2_extractor_flops(samples, batch=batch, **ext_kw)
    return 3 * fwd - 2 * ext


def counted_flops(fn, *args) -> int:
    """FLOPs of the products and convolutions that ``fn(*args)`` runs, as PyTorch's ``FlopCounterMode`` counts
    them. Independent cross-check of the analytic counters; like them it leaves elementwise work out, but it
    counts what runs (a convolution's padded taps among it) and sees nothing inside a custom op."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


#: dense bf16 tensor-core peak per card, by ``torch.cuda.get_device_name`` (NVIDIA's data sheet; the SXM part at
#: its 700 W limit)
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device=None) -> Optional[float]:
    """Per-card bf16 peak for the current (or given) device.

    Override with ``THUNDER_PEAK_TFLOPS`` (in TFLOPs) for cards not in the
    table; returns None on CPU/unknown so callers can skip the MFU line
    rather than report one against a made-up peak.
    """
    env = os.environ.get("THUNDER_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for kind, peak in _PEAK_BF16.items():
        if name.startswith(kind):
            return peak
    return None


def mfu(model_flops: float, seconds: float, peak: Optional[float] = None) -> Optional[float]:
    """Model-FLOPs utilization of a measured run; None when no peak is known."""
    peak = peak if peak is not None else peak_flops()
    if not peak or seconds <= 0:
        return None
    return model_flops / seconds / peak
