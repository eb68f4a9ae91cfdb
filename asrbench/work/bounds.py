"""The least time of a kernel's function at its shapes: the rooflines of the ``roofline.*`` metrics.

The bound arithmetic is a frozen copy of ``chip_smoke.py`` at commit
6ca5cdbbf336fefac8336cbc2e6f4fc3b5b7d9f8 (``bound``, ``separable_bound``, ``attention_bound``,
``attention_train_bounds``): bytes count each input read once and each output written once, at
3.35 TB/s; operations run at 989 TFLOP/s on the bf16 tensor cores and 67 TFLOP/s on the float32 pipes,
which work side by side, so the larger of their times counts, not their sum. Each function counts the
work of the function the kernel computes from its shapes, whatever implements it.

The ``*_bound_s`` functions below sum those bounds over the calls a traced slice ran: each call is a dict
with the padded ``batch`` and ``samples`` of one forward or one train step.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound(n_bytes: float, bf16_flop: float = 0.0, f32_flop: float = 0.0) -> float:
    """Seconds: the largest of bytes over the memory rate and operations over the peak of their type."""
    return max(n_bytes / HBM_BYTES_PER_S, bf16_flop / BF16_FLOP_PER_S, f32_flop / F32_FLOP_PER_S)


def separable_bound(batch, t_in, t_out, c_in, c_out, k) -> float:
    """bf16 input, taps and weights in, bf16 output out, float32 bias; the depthwise taps on the float32 pipes,
    the pointwise product on the bf16 tensor cores."""
    n_bytes = 2 * (batch * t_in * c_in + k * c_in + c_in * c_out + batch * t_out * c_out) + 4 * c_out
    return bound(n_bytes, bf16_flop=2.0 * batch * t_out * c_in * c_out, f32_flop=2.0 * batch * t_out * c_in * k)


def attention_bound(batch: int, t: int, heads: int, dh: int = 64) -> float:
    """Serving: the packed qkv in and the output out (bf16, plus the int32 lengths); q k^T and P V."""
    h = heads * dh
    return bound(2 * batch * t * 4 * h + 4 * batch, bf16_flop=4.0 * batch * heads * t * t * dh)


def attention_train_bounds(batch: int, t: int, heads: int, dh: int = 64) -> tuple[float, float]:
    """Training forward (qkv in, the output out, two products) and backward (qkv, o and do in, dqkv out, five
    products: dP, dS K, dS^T q, P^T dO and the scores, whatever the kernels recompute)."""
    h = heads * dh
    pairs = batch * heads * float(t) * t * dh
    return (bound(2 * batch * t * 4 * h + 4 * batch, bf16_flop=4.0 * pairs),
            bound(2 * batch * t * 8 * h + 4 * batch, bf16_flop=10.0 * pairs))


def mel_frames(samples: int, hop: int = 160) -> int:
    """Frames of the centered STFT: ``samples // hop + 1``."""
    return samples // hop + 1


def extractor_frames(samples: int, kernels, strides) -> int:
    """Frames out of wav2vec2's conv feature extractor (valid convs)."""
    t = samples
    for k, s in zip(kernels, strides):
        t = (t - k) // s + 1
    return t


def quartznet_separable_shapes(config: dict, frames: int) -> list:
    """Each separable repeat of the QuartzNet plan as ``(t_in, t_out, c_in, c_out, k)``: the stride-2 stem,
    ``repeat_blocks`` blocks of ``repeat`` repeats per (filters, kernel), the dilated tail; the 1x1 block, the
    residuals and the decoder are products, not separable repeats."""
    t_in, t = frames, -(-frames // 2)
    shapes = [(t_in, t, config["feat_in"], 256, 33)]
    c = 256
    for f, k in zip(config["filters"], config["kernel_sizes"]):
        for _ in range(config["repeat_blocks"]):
            for _ in range(config["repeat"]):
                shapes.append((t, t, c, f, k))
                c = f
    shapes.append((t, t, c, 512, 87))
    return shapes


def separable_repeat_bound_s(config: dict, calls: list) -> float:
    """Every separable repeat of every traced forward."""
    total = 0.0
    for call in calls:
        for t_in, t_out, c_in, c_out, k in quartznet_separable_shapes(config, mel_frames(call["samples"])):
            total += separable_bound(call["batch"], t_in, t_out, c_in, c_out, k)
    return total


def _attention_shape(config: dict, call: dict) -> tuple:
    t = extractor_frames(call["samples"], config["conv_kernel"], config["conv_stride"])
    heads = config["num_attention_heads"]
    return call["batch"], t, heads, config["hidden_size"] // heads


def mha_from_qkv_bound_s(config: dict, calls: list) -> float:
    """One serving attention a layer of every traced forward."""
    return sum(config["num_hidden_layers"] * attention_bound(*_attention_shape(config, call)) for call in calls)


def mha_train_bound_s(config: dict, calls: list) -> float:
    """One training attention forward and its backward (the dq and dk/dv kernels) a layer of every traced step."""
    return sum(config["num_hidden_layers"] * sum(attention_train_bounds(*_attention_shape(config, call)))
               for call in calls)
