"""Analytic model FLOPs and the card's peak, for the benchmark's ``mfu.*`` metrics.

Frozen copy of ``thunder_tpu_torch/flops.py`` at commit 6ca5cdbbf336fefac8336cbc2e6f4fc3b5b7d9f8: the
counters ``conv1d_flops``, ``dense_flops``, ``filterbank_flops``, ``quartznet_forward_flops_split``,
``quartznet_forward_flops``, ``quartznet_train_flops``, ``wav2vec2_forward_flops``,
``wav2vec2_extractor_flops`` and ``wav2vec2_train_flops``, the same integers. Model FLOPs are the analytic
conv + matmul count (elementwise and normalization work left out); a train step is 3x the forward of the
trainable path plus 1x what takes no gradient.

``peak_flops`` differs from the program's on purpose: the peak is fixed by the device's name, with no
environment override, so that no run can move the yardstick.
"""

from __future__ import annotations

#: dense bf16 tensor-core peak by ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, the SXM part at 700 W)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_name: str) -> float:
    """The bf16 peak of the named card; raises for a card the table does not hold."""
    for kind, peak in PEAK_BF16_FLOPS.items():
        if device_name.startswith(kind):
            return peak
    raise KeyError(f"no bf16 peak known for {device_name!r}")


def conv1d_flops(kernel_size: int, c_in: int, c_out: int, t_out: int, groups: int = 1, batch: int = 1) -> int:
    """2 * MACs of a 1-D conv producing ``(batch, t_out, c_out)``."""
    return 2 * kernel_size * (c_in // groups) * c_out * t_out * batch


def dense_flops(d_in: int, d_out: int, tokens: int = 1) -> int:
    """2 * MACs of a matmul over ``tokens`` rows."""
    return 2 * d_in * d_out * tokens


def _conv_t_out(t: int, stride: int) -> int:
    return -(-t // stride)


def filterbank_flops(samples: int, *, hop_length: int = 160, n_fft: int = 512, nfilt: int = 64, batch: int = 1) -> int:
    """Mel frontend: the windowed-DFT matmul and the mel matmul."""
    frames = samples // hop_length + 1
    bins = n_fft // 2 + 1
    return batch * (dense_flops(n_fft, 2 * bins, frames) + dense_flops(bins, nfilt, frames))


def quartznet_forward_flops_split(frames: int, *, feat_in: int = 64, filters=(256, 256, 512, 512, 512),
                                  kernel_sizes=(33, 39, 51, 63, 75), repeat_blocks: int = 3, repeat: int = 5,
                                  num_classes: int = 29, batch: int = 1) -> tuple:
    """``(depthwise_flops, matmul_flops)`` of the QuartzNet encoder and its 1x1 CTC decoder."""
    dw = 0
    matmul = 0
    c = feat_in
    t = _conv_t_out(frames, 2)
    dw += conv1d_flops(33, c, c, t, groups=c)
    matmul += conv1d_flops(1, c, 256, t)
    c = 256
    for f, k in zip(filters, kernel_sizes):
        for _ in range(repeat_blocks):
            c_in_block = c
            for _ in range(repeat):
                dw += conv1d_flops(k, c, c, t, groups=c)
                matmul += conv1d_flops(1, c, f, t)
                c = f
            matmul += conv1d_flops(1, c_in_block, f, t)
    dw += conv1d_flops(87, c, c, t, groups=c)
    matmul += conv1d_flops(1, c, 512, t)
    c = 512
    matmul += conv1d_flops(1, c, 1024, t)
    c = 1024
    matmul += conv1d_flops(1, c, num_classes, t)
    return batch * dw, batch * matmul


def quartznet_forward_flops(frames: int, **kw) -> int:
    """Analytic conv FLOPs of the QuartzNet encoder + 1x1 CTC decoder."""
    dw, matmul = quartznet_forward_flops_split(frames, **kw)
    return dw + matmul


def quartznet_train_flops(samples: int, *, batch: int = 1, hop_length: int = 160, **kw) -> int:
    """Train-step model FLOPs: 3x the trainable path + 1x the frontend."""
    frames = samples // hop_length + 1
    return 3 * quartznet_forward_flops(frames, batch=batch, **kw) + filterbank_flops(
        samples, hop_length=hop_length, batch=batch)


def wav2vec2_forward_flops(samples: int, *, hidden_size: int = 768, num_hidden_layers: int = 12,
                           intermediate_size: int = 3072, conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                           conv_stride=(5, 2, 2, 2, 2, 2, 2), num_classes: int = 32, batch: int = 1) -> int:
    """Analytic conv + matmul FLOPs of the wav2vec2 forward: the conv feature extractor, the feature
    projection, the positional conv (k=128, 16 groups), the transformer and the CTC head."""
    total = 0
    t = samples
    c = 1
    for f, k, s in zip(conv_dim, conv_kernel, conv_stride):
        t = (t - k) // s + 1
        total += conv1d_flops(k, c, f, t)
        c = f
    h = hidden_size
    total += dense_flops(c, h, t)
    total += conv1d_flops(128, h, h, t, groups=16)
    per_layer = (dense_flops(h, 3 * h, t) + 2 * dense_flops(t, h, t) + dense_flops(h, h, t)
                 + 2 * dense_flops(h, intermediate_size, t))
    total += num_hidden_layers * per_layer
    total += dense_flops(h, num_classes, t)
    return batch * total


def wav2vec2_extractor_flops(samples: int, *, conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                             conv_stride=(5, 2, 2, 2, 2, 2, 2), batch: int = 1) -> int:
    """The conv feature extractor's share of the wav2vec2 forward FLOPs."""
    total = 0
    t = samples
    c = 1
    for f, k, s in zip(conv_dim, conv_kernel, conv_stride):
        t = (t - k) // s + 1
        total += conv1d_flops(k, c, f, t)
        c = f
    return batch * total


def wav2vec2_train_flops(samples: int, *, batch: int = 1, frozen_extractor: bool = False, **kw) -> int:
    """Train-step model FLOPs; a frozen extractor runs forward only, so it counts once."""
    fwd = wav2vec2_forward_flops(samples, batch=batch, **kw)
    if not frozen_extractor:
        return 3 * fwd
    ext_kw = {k: v for k, v in kw.items() if k in ("conv_dim", "conv_kernel", "conv_stride")}
    return 3 * fwd - 2 * wav2vec2_extractor_flops(samples, batch=batch, **ext_kw)
