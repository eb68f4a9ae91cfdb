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
own backward kernels and seeded afresh from the call's generator. float32
keeps the JAX module's own unfused math, with dropout masks drawn from the
generator. The TPU-only gates of the JAX module (the 640-frame flash
threshold, ``T % 128``, the 128-frame pad around the layer stack and the
kill-switch environment variables) change no valid frame and are not ported.

Not ported (they raise ``NotImplementedError``): ``remat``, SEW, the MMS
adapters, data2vec-audio's positional conv stack, WavLM's relative position
bias, int8 compute and ``Wav2Vec2Config.from_hf``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from thunder_tpu_torch.kernels.add_ln import add_layer_norm
from thunder_tpu_torch.kernels.add_ln_train import add_ln_dropout_train
from thunder_tpu_torch.kernels.attention import HEAD_DIM, mha_from_qkv
from thunder_tpu_torch.kernels.attention_train import mha_train
from thunder_tpu_torch.kernels.dropout_hash import new_seed
from thunder_tpu_torch.models.layers import Dense, dropout
from thunder_tpu_torch.ops.conv import conv1d
from thunder_tpu_torch.ops.masking import lengths_to_mask

__all__ = ["Wav2Vec2Config", "Wav2Vec2Encoder", "LayerNorm", "feat_extract_output_lengths", "gelu", "serving_copy"]

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
    """The fields of the JAX package's ``Wav2Vec2Config`` that the port reads (defaults = base;
    the dropout rates are HF's defaults and act in train mode only).

    The flags of the variants the port does not run yet (``sew_style``, ``add_adapter``, ``adapter_attn_dim``,
    ``pos_conv_stack``, ``rel_pos_buckets``) are kept so that
    :class:`Wav2Vec2Encoder` can refuse them.
    """

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
        rel_pos_buckets: int = 0,
        sew_style: bool = False,
        add_adapter: bool = False,
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
        self.rel_pos_buckets = rel_pos_buckets
        self.sew_style = sew_style
        self.add_adapter = add_adapter
        self.adapter_attn_dim = adapter_attn_dim


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


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: float32 statistics, output in ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm_f32(x.float(), self.scale, self.bias, self.epsilon).to(self.dtype)


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
        if self.dtype == torch.bfloat16 and train:
            seed = new_seed(generator, x.device, dropout_rate)
            return add_ln_dropout_train(x, y, self.scale, self.bias, seed, dropout_rate, self.epsilon)
        if train:
            y = dropout(y, dropout_rate, generator)
        if self.dtype == torch.bfloat16:
            return add_layer_norm(x.contiguous(), y.contiguous(), self.scale.float(), self.bias.float(), self.epsilon)
        return _layer_norm_f32((x + y).float(), self.scale, self.bias, self.epsilon).to(self.dtype)


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
        a = self.scale.float() * torch.rsqrt(var + self.epsilon)
        b = self.bias.float() - mean * a
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv1d(x.to(self.dtype), self.kernel.to(self.dtype), bias, stride=self.stride, padding=self.padding,
                      groups=self.groups)


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

    bfloat16 with dh = 64 runs the attention kernels on the packed GEMM output
    at every length: ``kernels.attention.mha_from_qkv`` in eval mode,
    ``kernels.attention_train.mha_train`` in train mode, with
    ``attention_dropout`` inside the kernel under a fresh seed from
    ``generator``. Every other case runs the JAX module's unfused path: the
    scores in the compute dtype (float32 in train mode), the key mask at that
    dtype's minimum, the softmax in float32, and in train mode dropout on the
    probabilities.
    """

    def __init__(self, config: Wav2Vec2Config, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h = config.hidden_size
        self.qkv_proj = Dense(h, 3 * h, dtype=dtype)
        self.out_proj = Dense(h, h, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, position_bias: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        if position_bias is not None:
            raise NotImplementedError("WavLM's relative position bias is not ported yet")
        cfg = self.config
        b, t, h = x.shape
        heads = cfg.num_attention_heads
        dh = h // heads
        qkv = self.qkv_proj(x)
        if self.dtype == torch.bfloat16 and dh == HEAD_DIM:
            if not train:
                return self.out_proj(mha_from_qkv(qkv, lengths.to(torch.int32), heads))
            rate = cfg.attention_dropout
            return self.out_proj(mha_train(qkv, lengths.to(torch.int32), new_seed(generator, x.device, rate), heads, rate))
        q, k, v = qkv.split(h, dim=-1)
        q = q * dh**-0.5  # HF scales the query projection
        per_head = lambda a: a.reshape(b, t, heads, dh)  # noqa: E731
        score_t = torch.float32 if train else self.dtype
        scores = torch.einsum("bqhd,bkhd->bhqk", per_head(q).to(score_t), per_head(k).to(score_t))
        key_mask = lengths_to_mask(lengths, t)[:, None, None, :]
        scores = torch.where(key_mask, scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        if train:
            probs = dropout(probs, cfg.attention_dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, per_head(v)).reshape(b, t, h)
        return self.out_proj(out)


class _EncoderLayer(nn.Module):
    """One transformer layer: post-LN (``LayerNorm(x + attn(x))``, then ``LayerNorm(x + ffn(x))``,
    both fused add + LayerNorm) or, with ``do_stable_layer_norm``, pre-LN with plain LayerNorms.
    In train mode ``hidden_dropout`` acts on both residual branches: inside the add + LayerNorm
    for post-LN, around each branch for pre-LN."""

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

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(gelu(self.intermediate_dense(x), self.dtype))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.config.hidden_dropout if train else 0.0
        attend = lambda a: self.attention(a, lengths, train=train, generator=generator)  # noqa: E731
        if self.config.do_stable_layer_norm:
            x = x + dropout(attend(self.layer_norm(x)), rate, generator)
            return x + dropout(self._ffn(self.final_layer_norm(x)), rate, generator)
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
    """

    def __init__(self, config: Optional[Wav2Vec2Config] = None, dtype=torch.float32, remat: bool = False,
                 freeze_feature_extractor: bool = False):
        super().__init__()
        config = config or Wav2Vec2Config()
        unported = {
            "sew_style": config.sew_style,
            "add_adapter": config.add_adapter,
            "adapter_attn_dim": config.adapter_attn_dim,
            "pos_conv_stack": config.pos_conv_stack,
            "rel_pos_buckets": config.rel_pos_buckets,
            "remat": remat,
        }
        for flag, value in unported.items():
            if value:
                raise NotImplementedError(f"Wav2Vec2Encoder: {flag}={value!r} is not ported to thunder_tpu_torch yet")
        self.config = config
        self.dtype = dtype
        self.freeze_feature_extractor = freeze_feature_extractor
        h, eps, k = config.hidden_size, config.layer_norm_eps, config.num_conv_pos_embeddings
        self.feature_extractor = _FeatureExtractor(config, dtype=dtype)
        if config.feat_proj_layer_norm:
            self.fp_layer_norm = LayerNorm(config.conv_dim[-1], eps, dtype=dtype)
        self.fp_projection = Dense(config.conv_dim[-1], h, dtype=dtype)
        self.pos_conv = _Conv(h, h, k, padding=k // 2, groups=config.num_conv_pos_embedding_groups, dtype=dtype)
        self.enc_layer_norm = (LayerNorm if config.do_stable_layer_norm else _AddLayerNorm)(h, eps, dtype=dtype)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer{i}", _EncoderLayer(config, dtype=dtype))

    @property
    def final_dimension(self) -> int:
        return self.config.hidden_size

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False, generator=None):
        cfg = self.config
        with torch.no_grad() if self.freeze_feature_extractor else contextlib.nullcontext():
            feats = self.feature_extractor(x, lengths)
        out_lengths = feat_extract_output_lengths(lengths.to(torch.int32), cfg.conv_kernel, cfg.conv_stride)
        h = feats
        if cfg.feat_proj_layer_norm:
            h = self.fp_layer_norm(h)
        h = self.fp_projection(h)
        if train:
            h = dropout(h, cfg.feat_proj_dropout, generator)
        # padding is masked out of attention and zeroed before the transformer
        h = torch.where(lengths_to_mask(out_lengths, h.shape[1])[:, :, None], h, 0.0)
        pos = self.pos_conv(h)
        if cfg.num_conv_pos_embeddings % 2 == 0:  # HF SamePad drops the trailing frame of an even kernel
            pos = pos[:, : h.shape[1]]
        pos = gelu(pos, self.dtype)
        if cfg.do_stable_layer_norm:
            h = h + pos
        else:
            h = self.enc_layer_norm(h, pos, train=train)
        if train:  # HF's encoder-level dropout, after the positional embedding (and its LayerNorm)
            h = dropout(h, cfg.hidden_dropout, generator)
        for i in range(cfg.num_hidden_layers):
            h = getattr(self, f"layer{i}")(h, out_lengths, train=train, generator=generator)
        if cfg.do_stable_layer_norm:
            h = self.enc_layer_norm(h)
        return h, out_lengths


def serving_copy(encoder: Wav2Vec2Encoder, dtype: torch.dtype) -> Wav2Vec2Encoder:
    """A copy of ``encoder`` that computes in ``dtype``, with its weights pre-cast once
    (the JAX engine's serving copy): every parameter is rounded to ``dtype`` except the
    masked instance norm's, which apply in float32. Conv and dense weights are stored in
    ``dtype``; norm parameters keep float32 storage (the add + LayerNorm kernel's type)
    with their values rounded through ``dtype``, as the JAX engine's bf16 copies promote."""
    copy = Wav2Vec2Encoder(encoder.config, dtype=dtype)
    copy.load_state_dict(encoder.state_dict())
    with torch.no_grad():
        for module in copy.modules():
            if isinstance(module, _MaskedInstanceNorm):
                continue
            rounded_only = isinstance(module, (LayerNorm, _AddLayerNorm))
            for p in module.parameters(recurse=False):
                p.data = p.data.to(dtype).float() if rounded_only else p.data.to(dtype)
    return copy.requires_grad_(False).eval()
