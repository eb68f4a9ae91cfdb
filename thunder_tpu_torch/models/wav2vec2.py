"""wav2vec2 encoder as ``nn.Module``s: conv feature extractor + transformer.

Port of ``thunder_tpu/models/wav2vec2.py`` (float mode, eval and training), both variants:

- ``feat_extract_norm="group"`` + post-LayerNorm layers (wav2vec2-base);
- ``feat_extract_norm="layer"`` + pre-LayerNorm ("stable") layers
  (wav2vec2-large / lv60).

Layout and names follow the flax modules, so weights map one to one through
``bridge.py``: channels-last ``(batch, frames, hidden)``, conv kernels
``(kernel_size, in // groups, out)``, dense kernels ``(in, out)``, norms as
``scale``/``bias``, the attention's fused ``qkv_proj``. Each module's ``dtype``
is its compute type, cast where flax's ``promote_dtype`` casts; parameters
stay as they are stored.

On the bfloat16 serving path the two TPU kernels' counterparts carry every
layer: the residual add + LayerNorm of the post-LN variant goes through
``kernels.add_ln.add_layer_norm`` and the attention through
``kernels.attention.mha_from_qkv`` at every length (each runs its CUDA kernel
for a CUDA tensor and its plain version for a CPU tensor). In bfloat16 train
mode their training counterparts take the same places:
``kernels.add_ln_train.add_ln_dropout_train`` (the hidden dropout of the
residual branch inside the kernel) and ``kernels.attention_train.mha_train``
(the attention dropout inside the kernel), each differentiable through its
own backward kernels and seeded afresh from the call's generator. The
attention kernels take heads of 64 (the JAX module's ``mha_from_qkv`` and
``mha_train`` routes) and of 80 (MMS-1b's widths: the JAX module's flash
route, ``_flash_mha``, which trains only at ``attention_dropout == 0``; so
here heads of 80 train on the kernels at that rate and unfused above it).
float32 keeps the JAX module's own unfused math, with dropout masks drawn
from the generator. The TPU-only gates of the JAX module (the 640-frame flash
threshold, ``T % 128``, the 128-frame pad around the layer stack and the
kill-switch environment variables) change no valid frame and are not ported.

The serving engine's modes build their copy through :func:`serving_copy`:
``posconv_dense`` folds the grouped positional conv into a block-diagonal
dense one; ``int8_compute`` serves the transformer's four big Dense layers
and the extractor convs of at least 64 input channels as W8A8 products
(:class:`_Int8Dense`, :class:`_Int8Conv`: the JAX module's ``_Dense`` and
``_ExtractorConv`` int8 branches); ``int8_weights`` keeps the other Dense
kernels in int8 and dequantizes them in the compute dtype at each call.

The family's variants, each after the JAX module:

- WavLM (``rel_pos_buckets``): the bucketed relative position bias
  (:func:`_wavlm_position_bias`) from the encoder's ``rel_attn_embed``,
  computed once a forward in float32 and shared by every layer, each layer's
  attention scaling it by its gate (``gru_rel_pos_linear``, a float32 Dense
  on the attention's input by heads, and ``gru_rel_pos_const``). A biased
  attention takes the unfused path, as the JAX module's (both of its kernel
  routes need ``position_bias is None``); the bias is cast to the scores'
  type (bf16 scores when serving in bf16, float32 in train mode);
- data2vec-audio (``pos_conv_stack``): ``num_conv_pos_embeddings`` grouped
  convs ``pos_conv{i}`` of kernel ``conv_pos_kernel_size``, each followed by
  a parameter-free LayerNorm (eps 1e-5) and gelu;
- SEW (``sew_style``): ``sew_extract_ln`` on the extractor's output (and a
  projection when ``conv_dim[-1] != hidden_size``), the transformer on an
  average-pooled sequence plus a stride-``squeeze_factor`` positional conv,
  then ``upsample_projection`` back to the extractor's frame rate; the CTC
  lengths stay the extractor's;
- the conv adapter (``add_adapter``): ``adapter_proj`` + ``adapter_proj_ln``
  when ``output_hidden_size`` differs, then ``num_adapter_layers`` strided GLU
  convs ``adapter_conv{i}``, whose lengths ``(L - 1) // stride + 1`` the CTC
  head then runs at;
- the MMS attention adapter (``adapter_attn_dim``): a residual
  ``adapter_norm`` -> ``adapter_dense1`` -> ReLU -> ``adapter_dense2`` at the
  tail of every stable-LN layer.
"""

from __future__ import annotations

import contextlib
import copy as _copy
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from thunder_tpu_torch.kernels.add_ln import add_layer_norm
from thunder_tpu_torch.kernels.add_ln_train import add_ln_dropout_train
from thunder_tpu_torch.kernels.attention import HEAD_DIMS, mha_from_qkv
from thunder_tpu_torch.kernels.attention_train import mha_train
from thunder_tpu_torch.kernels.dropout_hash import new_seed
from thunder_tpu_torch.models.layers import Dense, dense, dropout, run_block
from thunder_tpu_torch.ops.conv import conv1d
from thunder_tpu_torch.ops.masking import lengths_to_mask
from thunder_tpu_torch.parallel import spmd
from thunder_tpu_torch.quantization import (
    SCALE,
    VALUES,
    column_major,
    dynamic_int8_conv,
    dynamic_int8_matmul,
    quantize_tree,
    quantize_tree_compute,
)

__all__ = ["Wav2Vec2Config", "Wav2Vec2Encoder", "LayerNorm", "feat_extract_output_lengths", "gelu", "fold_pos_conv",
           "serving_copy"]

# minimax odd-polynomial fit of Phi(x) = 0.5*(1+erf(x/sqrt(2))) on [-4, 4], the
# JAX module's coefficients (gelu absolute error 2.0e-3, exact 0/1 tails)
_GELU_COEFFS = (
    3.9532497308e-01,
    -6.1340755325e-02,
    7.4120497122e-03,
    -5.5134104003e-04,
    2.2377131731e-05,
    -3.7642009188e-07,
)


def _fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """The JAX module's polynomial gelu (max abs error 2.0e-3), in float32, cast back to ``x.dtype``.

    Its error sits below bf16 rounding, and the JAX package serves bf16 with
    it, so the bf16 path uses it too. In-place steps keep it to one float32
    temporary beside the clipped input.
    """
    f = x.float()
    t = f.clamp(-4.0, 4.0)
    t2 = t * t
    p = t2 * _GELU_COEFFS[-1] + _GELU_COEFFS[-2]
    for c in _GELU_COEFFS[-3::-1]:
        p.mul_(t2).add_(c)
    del t2
    phi = p.mul_(t).add_(0.5)
    phi.masked_fill_(f > 4.0, 1.0).masked_fill_(f < -4.0, 0.0)
    return phi.mul_(f).to(x.dtype)


def gelu(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Exact (erf) gelu for float32; the polynomial for bfloat16 compute."""
    if (dtype or x.dtype) == torch.bfloat16:
        return _fast_gelu(x)
    return F.gelu(x, approximate="none")


class Wav2Vec2Config:
    """The JAX package's ``Wav2Vec2Config``, field for field (defaults = base; the dropout rates are HF's
    defaults and act in train mode only), the variants' fields included (see the module docstring)."""

    def __init__(
        self,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512),
        conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
        conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
        conv_bias: bool = False,
        feat_extract_norm: str = "group",
        do_stable_layer_norm: bool = False,
        num_conv_pos_embeddings: int = 128,
        num_conv_pos_embedding_groups: int = 16,
        layer_norm_eps: float = 1e-5,
        hidden_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        feat_proj_dropout: float = 0.1,
        feat_proj_layer_norm: bool = True,
        pos_conv_stack: bool = False,
        conv_pos_kernel_size: Optional[int] = None,
        rel_pos_buckets: int = 0,
        rel_pos_max_distance: int = 0,
        sew_style: bool = False,
        squeeze_factor: int = 1,
        add_adapter: bool = False,
        output_hidden_size: Optional[int] = None,
        num_adapter_layers: int = 3,
        adapter_kernel_size: int = 3,
        adapter_stride: int = 2,
        adapter_attn_dim: Optional[int] = None,
    ):
        if feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm is 'group' or 'layer', got {feat_extract_norm!r}")
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.conv_dim = tuple(conv_dim)
        self.conv_kernel = tuple(conv_kernel)
        self.conv_stride = tuple(conv_stride)
        self.conv_bias = conv_bias
        self.feat_extract_norm = feat_extract_norm
        self.do_stable_layer_norm = do_stable_layer_norm
        self.num_conv_pos_embeddings = num_conv_pos_embeddings
        self.num_conv_pos_embedding_groups = num_conv_pos_embedding_groups
        self.layer_norm_eps = layer_norm_eps
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.feat_proj_dropout = feat_proj_dropout
        #: HuBERT can drop the feature-projection LayerNorm
        self.feat_proj_layer_norm = feat_proj_layer_norm
        self.pos_conv_stack = pos_conv_stack
        self.conv_pos_kernel_size = conv_pos_kernel_size
        self.rel_pos_buckets = rel_pos_buckets
        self.rel_pos_max_distance = rel_pos_max_distance
        self.sew_style = sew_style
        self.squeeze_factor = squeeze_factor
        self.add_adapter = add_adapter
        self.output_hidden_size = output_hidden_size or hidden_size
        self.num_adapter_layers = num_adapter_layers
        self.adapter_kernel_size = adapter_kernel_size
        self.adapter_stride = adapter_stride
        self.adapter_attn_dim = adapter_attn_dim

    @classmethod
    def from_hf(cls, hf_config) -> "Wav2Vec2Config":
        """Any wav2vec2-family HF config (wav2vec2, HuBERT, WavLM, data2vec-audio, SEW): the JAX package's
        ``Wav2Vec2Config.from_hf``."""
        model_type = getattr(hf_config, "model_type", "wav2vec2")
        is_d2v = model_type == "data2vec-audio"
        return cls(
            hidden_size=hf_config.hidden_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            conv_dim=hf_config.conv_dim,
            conv_kernel=hf_config.conv_kernel,
            conv_stride=hf_config.conv_stride,
            conv_bias=hf_config.conv_bias,
            # data2vec-audio hardcodes per-layer LN convs and post-norm layers (its config has neither flag)
            feat_extract_norm="layer" if is_d2v else hf_config.feat_extract_norm,
            do_stable_layer_norm=getattr(hf_config, "do_stable_layer_norm", False),
            num_conv_pos_embeddings=hf_config.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=hf_config.num_conv_pos_embedding_groups,
            layer_norm_eps=hf_config.layer_norm_eps,
            hidden_dropout=getattr(hf_config, "hidden_dropout", 0.1),
            attention_dropout=getattr(hf_config, "attention_dropout", 0.1),
            feat_proj_dropout=getattr(hf_config, "feat_proj_dropout", 0.1),
            feat_proj_layer_norm=getattr(hf_config, "feat_proj_layer_norm", True),
            pos_conv_stack=is_d2v,
            conv_pos_kernel_size=getattr(hf_config, "conv_pos_kernel_size", None),
            rel_pos_buckets=getattr(hf_config, "num_buckets", 0) if model_type == "wavlm" else 0,
            rel_pos_max_distance=getattr(hf_config, "max_bucket_distance", 0) if model_type == "wavlm" else 0,
            sew_style=model_type == "sew",
            squeeze_factor=getattr(hf_config, "squeeze_factor", 1) if model_type == "sew" else 1,
            add_adapter=bool(getattr(hf_config, "add_adapter", False)),
            output_hidden_size=getattr(hf_config, "output_hidden_size", None),
            num_adapter_layers=getattr(hf_config, "num_adapter_layers", 3),
            adapter_kernel_size=getattr(hf_config, "adapter_kernel_size", 3),
            adapter_stride=getattr(hf_config, "adapter_stride", 2),
            adapter_attn_dim=getattr(hf_config, "adapter_attn_dim", None),
        )


def feat_extract_output_lengths(lengths, kernels: Sequence[int], strides: Sequence[int]):
    """HF ``_get_feat_extract_output_lengths``: ``floor((L - k) / s) + 1`` per layer."""
    for k, s in zip(kernels, strides):
        lengths = (lengths - k) // s + 1
    return lengths


def _layer_norm_f32(f: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's LayerNorm math on float32 ``f``: the fast variance clipped at 0, then
    ``(f - mu) * (rsqrt(var + eps) * scale) + bias``."""
    mu = f.mean(dim=-1, keepdim=True)
    var = ((f * f).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (f - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()


def _plain_layer_norm(x: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``nn.LayerNorm(use_scale=False, use_bias=False)``: :func:`_layer_norm_f32`'s statistics, no
    parameters, output in ``dtype``."""
    f = x.float()
    mu = f.mean(dim=-1, keepdim=True)
    var = ((f * f).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((f - mu) * torch.rsqrt(var + eps)).to(dtype)


def _wavlm_buckets(t: int, num_buckets: int, max_distance: int, device=None) -> torch.Tensor:
    """WavLM's T5-style bidirectional buckets ``(T, T)`` int64 of ``key - query``: half the buckets for the
    sign, half of those for the exact small distances, the rest log-spaced up to ``max_distance`` (float32
    arithmetic, as the JAX function's)."""
    nb = num_buckets // 2
    pos = torch.arange(t, dtype=torch.int32, device=device)
    rel = pos[None, :] - pos[:, None]
    buckets = (rel > 0).to(torch.int32) * nb
    dist = rel.abs()
    max_exact = nb // 2
    scaled = torch.log(dist.clamp_min(1).float() / max_exact) / math.log(max_distance / max_exact) * (nb - max_exact)
    large = (max_exact + scaled.to(torch.int32)).clamp_max(nb - 1)
    return (buckets + torch.where(dist < max_exact, dist, large)).long()


def _wavlm_position_bias(embed: torch.Tensor, t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM's relative position bias: the ``(num_buckets, H)`` table -> ``(H, T, T)`` float32."""
    return embed.float()[_wavlm_buckets(t, num_buckets, max_distance, embed.device)].permute(2, 0, 1)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: float32 statistics, output in ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = spmd.gathered(self.scale), spmd.gathered(self.bias)
        return _layer_norm_f32(x.float(), scale, bias, self.epsilon).to(self.dtype)


class _AddLayerNorm(nn.Module):
    """``LayerNorm(x + dropout(y))`` with ``nn.LayerNorm``'s parameters.

    bfloat16 runs the fused kernels (the kernel on the card, its plain version
    on the CPU), which add in float32: in eval mode ``kernels.add_ln``, in
    train mode ``kernels.add_ln_train`` with the dropout inside the kernel
    under a fresh seed from ``generator`` (rate 0 draws none). float32 applies
    dropout to ``y`` in train mode and then runs the JAX module's unfused math,
    which adds in the compute dtype.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        scale, bias = spmd.gathered(self.scale), spmd.gathered(self.bias)
        if self.dtype == torch.bfloat16 and train:
            seed = new_seed(generator, x.device, dropout_rate)
            first = spmd.row_offset() * math.prod(x.shape[1:-1])  # the first flattened row in the global batch's
            return add_ln_dropout_train(x, y, scale, bias, seed, dropout_rate, self.epsilon, row_offset=first)
        if train:
            y = dropout(y, dropout_rate, generator)
        if self.dtype == torch.bfloat16:
            return add_layer_norm(x.contiguous(), y.contiguous(), scale.float(), bias.float(), self.epsilon)
        return _layer_norm_f32((x + y).float(), scale, bias, self.epsilon).to(self.dtype)


class _MaskedInstanceNorm(nn.Module):
    """Per-(row, channel) normalization over the valid frames (HF's first-layer
    GroupNorm with groups == channels, with masked statistics).

    One-pass float32 statistics ``E[x]``, ``E[x^2] - E[x]^2`` clipped at 0,
    then the folded ``x * a + b``; the parameters apply in float32.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.float()[:, :, None]
        n = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        xf = x.float()
        xm = xf * m
        mean = xm.sum(dim=1, keepdim=True) / n
        var = ((xm * xf).sum(dim=1, keepdim=True) / n - mean * mean).clamp_min(0.0)
        del xm
        a = spmd.gathered(self.scale).float() * torch.rsqrt(var + self.epsilon)
        b = spmd.gathered(self.bias).float() - mean * a
        return torch.addcmul(b, xf, a).to(self.dtype)


class _Conv(nn.Module):
    """flax's ``nn.Conv`` over time (and the JAX module's ``_ExtractorConv`` in float
    mode): WIO kernel, symmetric ``padding``, ``groups``; input, kernel and bias
    cast to ``dtype``."""

    kernel_init = "lecun_normal"

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def _conv(self, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        bias = None if bias is None else bias.to(self.dtype)
        return conv1d(x.to(self.dtype), kernel.to(self.dtype), bias, stride=self.stride, padding=self.padding,
                      groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups == 1:  # the extractor's convs: column-parallel over sharded output channels
            return spmd.column_parallel(self._conv, x, self.kernel, self.bias)
        return self._conv(x, spmd.gathered(self.kernel), spmd.gathered(self.bias))  # the grouped positional conv


class _FeatureExtractor(nn.Module):
    """Raw audio ``(batch, samples)`` -> ``(batch, frames, conv_dim[-1])``: the 7-conv stack,
    each conv followed by its norm (masked instance norm after conv0 for "group", a LayerNorm
    after every conv for "layer") and gelu.

    The convs return channels-last views of PyTorch's channels-first results and the
    elementwise steps keep that memory order, so the next conv reads its input with no copy.
    """

    def __init__(self, config: Wav2Vec2Config, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        c_in = 1
        for i, (dim, k, s) in enumerate(zip(config.conv_dim, config.conv_kernel, config.conv_stride)):
            self.add_module(f"conv{i}", _Conv(c_in, dim, k, stride=s, use_bias=config.conv_bias, dtype=dtype))
            if config.feat_extract_norm == "group" and i == 0:
                self.gn = _MaskedInstanceNorm(dim, config.layer_norm_eps, dtype=dtype)
            elif config.feat_extract_norm == "layer":
                self.add_module(f"ln{i}", LayerNorm(dim, config.layer_norm_eps, dtype=dtype))
            c_in = dim

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x[:, :, None]
        cur = lengths.to(torch.int32)
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            x = getattr(self, f"conv{i}")(x)
            cur = (cur - k) // s + 1
            if cfg.feat_extract_norm == "group" and i == 0:
                x = self.gn(x, lengths_to_mask(cur, x.shape[1]))
            elif cfg.feat_extract_norm == "layer":
                x = getattr(self, f"ln{i}")(x)
            x = gelu(x, self.dtype)
        return x


class _Attention(nn.Module):
    """Self-attention with a fused ``qkv_proj`` (one ``(h, 3h)`` GEMM) and ``out_proj``.

    bfloat16 with no position bias runs the attention kernels on the packed
    GEMM output at every length: ``kernels.attention.mha_from_qkv`` in eval
    mode at dh 64 or 80; ``kernels.attention_train.mha_train`` in train mode
    at dh 64, with ``attention_dropout`` inside the kernel under a fresh seed
    from ``generator``, and at dh 80 when ``attention_dropout == 0`` (the
    JAX module's flash route trains only there). Every other case, dh 80 in
    train mode with dropout among them, runs the JAX module's unfused path: the
    scores in the compute dtype (float32 in train mode), WavLM's gated bias
    added in that type, the key mask at its minimum, the softmax in float32,
    and in train mode dropout on the probabilities.

    With ``rel_pos_buckets`` the module holds WavLM's gate: ``gru_rel_pos_linear``
    (a float32 ``Dense(dh, 8)`` over the input by heads) and ``gru_rel_pos_const``
    (``(1, heads, 1, 1)``); the gate scales the shared ``position_bias`` by
    batch, head and query.
    """

    def __init__(self, config: Wav2Vec2Config, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h, heads = config.hidden_size, config.num_attention_heads
        self.qkv_proj = Dense(h, 3 * h, dtype=dtype)
        self.out_proj = Dense(h, h, dtype=dtype)
        if config.rel_pos_buckets:
            self.gru_rel_pos_linear = Dense(h // heads, 8, dtype=torch.float32)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))

    def _gated_bias(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        """``gate (B, H, T, 1) * position_bias (H, T, T)`` in float32 (``modeling_wavlm.WavLMAttention``)."""
        b, t, h = x.shape
        heads = self.config.num_attention_heads
        g = x.reshape(b, t, heads, h // heads).transpose(1, 2).float()
        gates = torch.sigmoid(self.gru_rel_pos_linear(g).reshape(b, heads, t, 2, 4).sum(-1))
        const = spmd.gathered(self.gru_rel_pos_const).float()[:, :, :, 0]
        gate_out = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0
        return gate_out[..., None] * position_bias[None]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, position_bias: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        cfg = self.config
        b, t, h = x.shape
        heads = cfg.num_attention_heads
        dh = h // heads
        qkv = self.qkv_proj(x)
        fused = self.dtype == torch.bfloat16 and dh in HEAD_DIMS and position_bias is None
        if fused and (dh == 64 or not train or cfg.attention_dropout == 0.0):
            if not train:
                return self.out_proj(mha_from_qkv(qkv, lengths.to(torch.int32), heads))
            rate = cfg.attention_dropout
            seed = new_seed(generator, x.device, rate)
            out = mha_train(qkv, lengths.to(torch.int32), seed, heads, rate, row_offset=spmd.row_offset())
            return self.out_proj(out)
        q, k, v = qkv.split(h, dim=-1)
        q = q * dh**-0.5  # HF scales the query projection
        per_head = lambda a: a.reshape(b, t, heads, dh)  # noqa: E731
        score_t = torch.float32 if train else self.dtype
        scores = torch.einsum("bqhd,bkhd->bhqk", per_head(q).to(score_t), per_head(k).to(score_t))
        if position_bias is not None:
            scores = scores + self._gated_bias(x, position_bias).to(scores.dtype)
        key_mask = lengths_to_mask(lengths, t)[:, None, None, :]
        scores = torch.where(key_mask, scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        if train:
            probs = dropout(probs, cfg.attention_dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, per_head(v)).reshape(b, t, h)
        return self.out_proj(out)


class _EncoderLayer(nn.Module):
    """One transformer layer: post-LN (``LayerNorm(x + attn(x))``, then ``LayerNorm(x + ffn(x))``,
    both fused add + LayerNorm) or, with ``do_stable_layer_norm``, pre-LN with plain LayerNorms
    and, with ``adapter_attn_dim``, the MMS attention adapter at the tail. In train mode
    ``hidden_dropout`` acts on both residual branches: inside the add + LayerNorm for post-LN,
    around each branch for pre-LN. ``position_bias`` is WavLM's shared bias, passed to the
    attention."""

    def __init__(self, config: Wav2Vec2Config, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = _Attention(config, dtype=dtype)
        norm = LayerNorm if config.do_stable_layer_norm else _AddLayerNorm
        self.layer_norm = norm(h, eps, dtype=dtype)
        self.intermediate_dense = Dense(h, config.intermediate_size, dtype=dtype)
        self.output_dense = Dense(config.intermediate_size, h, dtype=dtype)
        self.final_layer_norm = norm(h, eps, dtype=dtype)
        if config.do_stable_layer_norm and config.adapter_attn_dim:
            self.adapter_norm = LayerNorm(h, eps, dtype=dtype)
            self.adapter_dense1 = Dense(h, config.adapter_attn_dim, dtype=dtype)
            self.adapter_dense2 = Dense(config.adapter_attn_dim, h, dtype=dtype)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(gelu(self.intermediate_dense(x), self.dtype))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, position_bias: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.config.hidden_dropout if train else 0.0
        attend = lambda a: self.attention(a, lengths, position_bias, train=train, generator=generator)  # noqa: E731
        if self.config.do_stable_layer_norm:
            x = x + dropout(attend(self.layer_norm(x)), rate, generator)
            x = x + dropout(self._ffn(self.final_layer_norm(x)), rate, generator)
            if self.config.adapter_attn_dim:
                x = x + self.adapter_dense2(torch.relu(self.adapter_dense1(self.adapter_norm(x))))
            return x
        x = self.layer_norm(x, attend(x), train=train, dropout_rate=rate, generator=generator)
        return self.final_layer_norm(x, self._ffn(x), train=train, dropout_rate=rate, generator=generator)


class Wav2Vec2Encoder(nn.Module):
    """Waveform ``(batch, samples)`` -> hidden states ``(batch, frames, hidden)``, with lengths.

    Drop-in encoder for ``CTCModel`` (the conv encoders' ``(x, lengths, train)``
    contract). ``train=True`` applies ``feat_proj_dropout`` after the feature
    projection, ``hidden_dropout`` after the positional embedding's LayerNorm
    and in every layer, and ``attention_dropout`` in every attention, each
    drawn from ``generator``.

    ``freeze_feature_extractor`` stops gradients at the conv feature
    extractor's output (HF's ``freeze_feature_encoder()``): the extractor then
    runs without recording a graph, so none of its activations is kept for the
    backward, and its parameters receive no gradient.

    ``mask_input`` records the checkpoint's feature-extractor setting, as the
    JAX encoder's field does (the frontend's ``Wav2Vec2Preprocess`` acts on
    it; an inference bundle's ``config.json`` carries it).

    ``remat`` rematerializes each transformer layer in the backward
    (:func:`~thunder_tpu_torch.models.layers.checkpointed`) in train mode with
    gradients on: the training kernels' forwards run again in the recompute
    with the same seeds, so the loss and gradients are those without it.
    """

    #: drawn from N(0, 1) by ``init_parameters`` (flax's ``normal(stddev=1.0)``)
    normal_parameters = ("rel_attn_embed",)

    def __init__(self, config: Optional[Wav2Vec2Config] = None, dtype=torch.float32, remat: bool = False,
                 freeze_feature_extractor: bool = False, mask_input: bool = True):
        super().__init__()
        config = config or Wav2Vec2Config()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.freeze_feature_extractor = freeze_feature_extractor
        self.mask_input = mask_input
        h, eps, groups = config.hidden_size, config.layer_norm_eps, config.num_conv_pos_embedding_groups
        self.feature_extractor = _FeatureExtractor(config, dtype=dtype)
        if config.sew_style:
            self.sew_extract_ln = LayerNorm(config.conv_dim[-1], eps, dtype=dtype)
        elif config.feat_proj_layer_norm:
            self.fp_layer_norm = LayerNorm(config.conv_dim[-1], eps, dtype=dtype)
        if not config.sew_style or config.conv_dim[-1] != h:
            self.fp_projection = Dense(config.conv_dim[-1], h, dtype=dtype)
        if config.pos_conv_stack:
            k = config.conv_pos_kernel_size
            for i in range(config.num_conv_pos_embeddings):
                self.add_module(f"pos_conv{i}", _Conv(h, h, k, padding=k // 2, groups=groups, dtype=dtype))
        else:
            k, stride = config.num_conv_pos_embeddings, config.squeeze_factor if config.sew_style else 1
            self.pos_conv = _Conv(h, h, k, stride=stride, padding=k // 2, groups=groups, dtype=dtype)
        if config.rel_pos_buckets:
            self.rel_attn_embed = nn.Parameter(torch.zeros(config.rel_pos_buckets, config.num_attention_heads))
        plain_ln = config.do_stable_layer_norm or config.sew_style
        self.enc_layer_norm = (LayerNorm if plain_ln else _AddLayerNorm)(h, eps, dtype=dtype)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer{i}", _EncoderLayer(config, dtype=dtype))
        if config.sew_style:
            self.upsample_projection = Dense(h, h * config.squeeze_factor, dtype=dtype)
        if config.add_adapter:
            out = config.output_hidden_size
            if out != h:
                self.adapter_proj = Dense(h, out, dtype=dtype)
                self.adapter_proj_ln = LayerNorm(out, 1e-5, dtype=dtype)  # HF builds it with torch's eps
            for i in range(config.num_adapter_layers):
                self.add_module(f"adapter_conv{i}", _Conv(out, 2 * out, config.adapter_kernel_size,
                                                          stride=config.adapter_stride, padding=1, dtype=dtype))

    @property
    def final_dimension(self) -> int:
        return self.config.output_hidden_size if self.config.add_adapter else self.config.hidden_size

    def output_lengths(self, lengths):
        """Frames out of the encoder for ``lengths`` samples (an int or a tensor): the extractor's convs, then the
        adapter's by HF's ``add_adapter`` formula, ``(L - 1) // stride + 1`` a conv."""
        cfg = self.config
        frames = feat_extract_output_lengths(lengths, cfg.conv_kernel, cfg.conv_stride)
        for _ in range(cfg.num_adapter_layers if cfg.add_adapter else 0):
            frames = (frames - 1) // cfg.adapter_stride + 1
        return frames

    def _layers(self, h: torch.Tensor, lengths: torch.Tensor, position_bias, train: bool, generator) -> torch.Tensor:
        for i in range(self.config.num_hidden_layers):
            h = run_block(getattr(self, f"layer{i}"), h, lengths, position_bias, remat=self.remat, train=train,
                          generator=generator)
        return h

    def _positional(self, h: torch.Tensor) -> torch.Tensor:
        """The convolutional positional embedding of ``h``: data2vec-audio's stack or the one grouped conv; an
        even kernel's trailing frame dropped (HF's ``SamePad``)."""
        cfg, t = self.config, h.shape[1]
        if not cfg.pos_conv_stack:
            pos = self.pos_conv(h)
            return gelu(pos[:, :t] if cfg.num_conv_pos_embeddings % 2 == 0 else pos, self.dtype)
        pos = h
        for i in range(cfg.num_conv_pos_embeddings):
            pos = getattr(self, f"pos_conv{i}")(pos)
            if cfg.conv_pos_kernel_size % 2 == 0:
                pos = pos[:, :t]
            pos = gelu(_plain_layer_norm(pos, 1e-5, self.dtype), self.dtype)
        return pos

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        cfg = self.config
        with torch.no_grad() if self.freeze_feature_extractor else contextlib.nullcontext():
            feats = self.feature_extractor(x, lengths)
        out_lengths = feat_extract_output_lengths(lengths.to(torch.int32), cfg.conv_kernel, cfg.conv_stride)
        if cfg.sew_style:
            return self._sew_encode(feats, out_lengths, train, generator)
        h = feats
        if cfg.feat_proj_layer_norm:
            h = self.fp_layer_norm(h)
        h = self.fp_projection(h)
        if train:
            h = dropout(h, cfg.feat_proj_dropout, generator)
        # padding is masked out of attention and zeroed before the transformer
        h = torch.where(lengths_to_mask(out_lengths, h.shape[1])[:, :, None], h, 0.0)
        pos = self._positional(h)
        if cfg.do_stable_layer_norm:
            h = h + pos
        else:
            h = self.enc_layer_norm(h, pos, train=train)
        if train:  # HF's encoder-level dropout, after the positional embedding (and its LayerNorm)
            h = dropout(h, cfg.hidden_dropout, generator)
        position_bias = None
        if cfg.rel_pos_buckets:  # WavLM: one bias for every layer, each layer gating it
            position_bias = _wavlm_position_bias(spmd.gathered(self.rel_attn_embed), h.shape[1],
                                                 cfg.rel_pos_buckets, cfg.rel_pos_max_distance)
        h = self._layers(h, out_lengths, position_bias, train, generator)
        if cfg.do_stable_layer_norm:
            h = self.enc_layer_norm(h)
        if cfg.add_adapter:
            return self._adapter(h), self.output_lengths(lengths.to(torch.int32))
        return h, out_lengths

    def _adapter(self, h: torch.Tensor) -> torch.Tensor:
        """HF ``Wav2Vec2Adapter``: the optional projection and its LayerNorm, then the strided GLU convs."""
        cfg = self.config
        if cfg.output_hidden_size != cfg.hidden_size:
            h = self.adapter_proj_ln(self.adapter_proj(h))
        for i in range(cfg.num_adapter_layers):
            a, b = getattr(self, f"adapter_conv{i}")(h).chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
        return h

    def _sew_encode(self, feats: torch.Tensor, out_lengths: torch.Tensor, train: bool, generator):
        """SEW (``modeling_sew.SEWModel``/``SEWEncoder``): LayerNorm on the extractor's output (and the
        projection), the average pool by ``squeeze_factor`` (the remainder dropped) plus the strided positional
        conv (an even kernel drops its *last* frame), a plain LayerNorm, the post-LN layers on the short
        sequence with key lengths ``out_lengths // s``, then the upsample projection, gelu and a reshape back
        to the extractor's frames, zeros past the upsampled tail. The CTC lengths stay the extractor's."""
        cfg = self.config
        h = self.sew_extract_ln(feats)
        if cfg.conv_dim[-1] != cfg.hidden_size:
            h = self.fp_projection(h)
        if train:
            h = dropout(h, cfg.feat_proj_dropout, generator)
        h = torch.where(lengths_to_mask(out_lengths, h.shape[1])[:, :, None], h, 0.0)
        s, (b, t_in, hidden) = cfg.squeeze_factor, h.shape
        pos = self.pos_conv(h)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        pos = gelu(pos, self.dtype)
        pooled = h[:, : t_in // s * s].reshape(b, t_in // s, s, hidden).sum(dim=2) / s
        m = min(pos.shape[1], pooled.shape[1])
        hq = self.enc_layer_norm(pooled[:, :m] + pos[:, :m])
        if train:
            hq = dropout(hq, cfg.hidden_dropout, generator)
        hq = self._layers(hq, torch.div(out_lengths, s, rounding_mode="floor"), None, train, generator)
        up = gelu(self.upsample_projection(hq), self.dtype).reshape(b, m * s, hidden)
        if up.shape[1] < t_in:
            up = F.pad(up, (0, 0, 0, t_in - up.shape[1]))
        return up[:, :t_in], out_lengths


class _Int8Dense(nn.Module):
    """A Dense served from int8: ``kernel_q8`` (int8, ``(in, out)``) and ``kernel_scale`` (float32, one a
    column) as buffers, with the bias.

    ``compute=False`` (the engine's ``int8_weights``): the kernel is dequantized in ``weight_dtype`` (the
    engine's compute dtype) at each call, ``q.to(weight_dtype) * scale.to(weight_dtype)``, and :class:`Dense`'s
    math runs on it in ``dtype`` (float32 for WavLM's gate, as the JAX module promotes). ``compute=True``
    (``int8_compute``, the JAX module's ``_Dense`` int8 branch): :func:`dynamic_int8_matmul` over the flattened
    rows, the bias added in float32, then a cast to ``dtype``; the kernel is kept in :func:`column_major`
    order, which the card's int8 product takes fastest."""

    def __init__(self, kernel_q8: torch.Tensor, kernel_scale: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype, compute: bool, weight_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype, self.compute, self.weight_dtype = dtype, compute, weight_dtype or dtype
        self.register_buffer("kernel_q8", column_major(kernel_q8) if compute else kernel_q8)
        self.register_buffer("kernel_scale", kernel_scale.reshape(-1))
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.compute:
            wdt = self.weight_dtype
            return dense(x, self.kernel_q8.to(wdt) * self.kernel_scale.to(wdt), self.bias, self.dtype)
        y = dynamic_int8_matmul(x.reshape(-1, x.shape[-1]), self.kernel_q8, self.kernel_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype).reshape(*x.shape[:-1], y.shape[-1])


class _Int8Conv(nn.Module):
    """A conv served from int8. ``compute=True`` (``int8_compute``): an extractor conv (VALID, one group) W8A8,
    the JAX module's ``_ExtractorConv`` int8 branch: :func:`dynamic_int8_conv`, the bias added in float32, then
    a cast to ``dtype``; the kernel in :func:`column_major` order. ``compute=False`` (``int8_weights``, which
    takes the kernels of size 1, such as SEW's extractor's): the kernel dequantized in ``dtype`` at each call
    and :class:`_Conv`'s math on it."""

    def __init__(self, kernel_q8: torch.Tensor, kernel_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                 dtype: torch.dtype, compute: bool = True, padding: int = 0, groups: int = 1):
        super().__init__()
        self.stride, self.dtype, self.compute, self.padding, self.groups = stride, dtype, compute, padding, groups
        self.register_buffer("kernel_q8", column_major(kernel_q8) if compute else kernel_q8)
        self.register_buffer("kernel_scale", kernel_scale)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.compute:
            kernel = self.kernel_q8.to(self.dtype) * self.kernel_scale.to(self.dtype)
            bias = None if self.bias is None else self.bias.to(self.dtype)
            return conv1d(x.to(self.dtype), kernel, bias, stride=self.stride, padding=self.padding, groups=self.groups)
        y = dynamic_int8_conv(x, self.kernel_q8, self.kernel_scale, self.stride)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


def fold_pos_conv(config: Wav2Vec2Config, state: dict) -> tuple[Wav2Vec2Config, dict]:
    """The JAX engine's ``posconv_dense`` fold: without a positional conv stack, with more than one group of
    ``gs`` channels and ``groups * gs == hidden``, the grouped ``(K, gs, hidden)`` kernel becomes a block-diagonal
    ``(K, hidden, hidden)`` one (off-block zeros add exactly 0) under a copy of ``config`` with one group. Else
    ``(config, state)`` as they are."""
    groups, w = config.num_conv_pos_embedding_groups, state.get("pos_conv.kernel")
    if config.pos_conv_stack or groups <= 1 or w is None or groups * w.shape[1] != w.shape[2]:
        return config, state
    taps, gs, h = w.shape
    folded = torch.zeros((taps, h, h), dtype=w.dtype)
    for g in range(groups):
        folded[:, g * gs:(g + 1) * gs, g * gs:(g + 1) * gs] = w[:, :, g * gs:(g + 1) * gs]
    config = _copy.copy(config)
    config.num_conv_pos_embedding_groups = 1
    return config, {**state, "pos_conv.kernel": folded}


def _replace(root: nn.Module, path: str, module: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent), name, module)


def serving_copy(encoder: Wav2Vec2Encoder, dtype: torch.dtype, posconv_dense: bool = False,
                 int8_compute: bool = False, int8_weights: bool = False) -> Wav2Vec2Encoder:
    """A copy of ``encoder`` that computes in ``dtype``, with its weights pre-cast once
    (the JAX engine's serving copy): every parameter is rounded to ``dtype`` except the
    masked instance norm's, which apply in float32. Conv and dense weights are stored in
    ``dtype``; norm parameters keep float32 storage (the add + LayerNorm kernel's type)
    with their values rounded through ``dtype``, as the JAX engine's bf16 copies promote.
    WavLM's ``rel_attn_embed`` and gate parameters are rounded too and still apply in float32.

    The engine's modes, in the JAX engine's order: ``posconv_dense`` (:func:`fold_pos_conv`), then
    ``int8_compute`` (:func:`quantize_tree_compute`: each selected Dense becomes an :class:`_Int8Dense`
    with ``compute=True`` and each selected extractor conv an :class:`_Int8Conv`, both with the float32
    bias), then ``int8_weights`` (:func:`quantize_tree` over what is left: every 2-D kernel's Dense becomes an
    :class:`_Int8Dense` with ``compute=False``, the bias as in float mode, and every conv of kernel size 1 an
    :class:`_Int8Conv` with ``compute=False``). Quantization starts from ``encoder``'s float32 weights."""
    config, state = encoder.config, {k: v.detach().float().cpu() for k, v in encoder.state_dict().items()}
    if posconv_dense:
        config, state = fold_pos_conv(config, state)
    copy = Wav2Vec2Encoder(config, dtype=dtype)
    copy.load_state_dict(state)
    with torch.no_grad():
        for module in copy.modules():
            if isinstance(module, _MaskedInstanceNorm):
                continue
            rounded_only = isinstance(module, (LayerNorm, _AddLayerNorm))
            for p in module.parameters(recurse=False):
                p.data = p.data.to(dtype).float() if rounded_only else p.data.to(dtype)
    tree = quantize_tree_compute(state) if int8_compute else state
    for name in [k for k in tree if k.endswith(".kernel_q8")]:
        path = name[: -len(".kernel_q8")]
        old = copy.get_submodule(path)
        bias = state.get(f"{path}.bias")
        q, scale = tree[name], tree[f"{path}.kernel_scale"]
        _replace(copy, path, _Int8Dense(q, scale, bias, dtype, compute=True) if isinstance(old, Dense)
                 else _Int8Conv(q, scale, bias, old.stride, dtype))
    if int8_weights:
        tree = quantize_tree(tree)
        for name in [k for k in tree if k.endswith(f".kernel.{VALUES}")]:
            path = name[: -len(f".kernel.{VALUES}")]
            old = copy.get_submodule(path)
            bias = None if old.bias is None else old.bias.detach()
            q, scale = tree[name], tree[f"{path}.kernel.{SCALE}"]
            if isinstance(old, Dense):
                _replace(copy, path, _Int8Dense(q, scale, bias, old.dtype, compute=False, weight_dtype=dtype))
            else:  # a conv of kernel size 1
                _replace(copy, path, _Int8Conv(q, scale, bias, old.stride, dtype, compute=False, padding=old.padding,
                                               groups=old.groups))
    return copy.requires_grad_(False).eval()
