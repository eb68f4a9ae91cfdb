"""CTC inference engine: the serving hot path.

Port of ``thunder_tpu/engine.py::InferenceEngine`` for QuartzNet, Citrinet
and wav2vec2, with its serving modes (``int8_weights``, ``int8_compute``,
``posconv_dense``; the JAX engine's ``mesh`` and ``use_pallas`` are not taken:
the port serves one card and always runs its kernels). The conv path (QuartzNet and Citrinet), planned
from the encoder's blocks:

- batch norm folded into the pointwise weights and a float32 bias at build
  time (eval-mode running statistics);
- every separable repeat (QuartzNet's stride-2 stem, 75 body repeats and
  dilation-2 tail; Citrinet's stem, 105 body repeats, the last of each
  stride-2 block strided, and k=41 tail) is one launch of the fused
  separable-repeat kernel, which also applies bias, ReLU and the
  zero-beyond-length mask;
- the dense 1x1 convs (residual branches, strided ``x[:, ::s]`` in
  Citrinet's stride-2 blocks; the 1024-channel block) and the decoder are
  matmuls in the compute dtype with float32 accumulation, with the mask
  folded into the same elementwise pass (masks cached per length of time
  within a forward);
- Citrinet's squeeze-excite (the JAX engine's ``_apply_se``): the mean over
  each row's valid frames, ``fc1`` with float32 accumulation, ReLU, a cast
  to the compute dtype, ``fc2`` with float32 accumulation, the sigmoid cast
  to the activations' dtype, and the gate; after the repeats, before the
  residual add;
- the log-mel frontend is one launch of the fused log-mel kernel.

The wav2vec2 path (after the JAX engine's wav2vec2 branch): the waveform
normalization in float32, then a copy of the encoder whose weights are
pre-cast once to the compute dtype (the masked instance norm's stay float32;
see ``models.wav2vec2.serving_copy``), whose layers run the attention and add
+ LayerNorm kernels, then the decoder as a product with float32 accumulation
and a float32 bias.

The serving modes, as the JAX engine builds them (``models.wav2vec2.serving_copy``
for wav2vec2):

- ``posconv_dense`` (wav2vec2, off by default): the grouped positional conv
  folded into a block-diagonal dense conv of one group;
- ``int8_compute`` (wav2vec2 only; any other encoder raises ``ValueError``):
  the transformer's four big Dense layers and the extractor convs of at least
  64 input channels as W8A8 products (``quantization.dynamic_int8_matmul``
  and ``dynamic_int8_conv``: dynamic per-row or per-sample int8 activations,
  ``torch._int_mm`` on the card);
- ``int8_weights``: the remaining matmul weights stay int8 with a float32
  scale a column on the device (wav2vec2: the Dense kernels; the conv path:
  every separable repeat's folded pointwise weights, the 1x1 convs and the
  residuals), and are dequantized in the compute dtype at each use,
  ``q * scale`` (the scale pre-cast once, which gives the same values); the
  separable-repeat kernel then runs on the dequantized weights. The decoder
  kernel is quantized in every int8 mode.

The JAX engine keeps the unquantized weights of its int8 modes in float32 and
rounds them to the compute dtype in each call; the port stores them as its
float mode does (the compute dtype; norm parameters as ``serving_copy`` keeps
them), which gives the same values, except that the JAX engine applies the
LayerNorm parameters unrounded there. ``weight_bytes()`` counts the tensors
the engine keeps on the device.

Any other encoder is served through the module's eval forward (the JAX
engine's generic fallback): its dtype, no BN folding, no kernels of its own.
A module without a decoder (an encoder-only checkpoint) serves the encoder's
output as float32 logits.

Decoding is greedy by default, on the argmax ids the forward computed;
``predict(beam_width=...)`` runs the prefix beam search on the host (the C++ runtime)
or, with ``beam_backend="device"``, on the forward's logits where they lie,
through the beam scan and backtrace kernels; ``predict_long`` decodes long
audio in overlapped chunks, greedy or as one continuous beam search.

Compute is bfloat16 on the card (as the JAX engine computes in bf16 on its
accelerator) and float32 on the CPU, where every kernel wrapper runs its
plain version. Asking for float32 on the card raises. Audio is padded to a
multiple of ``pad_multiple`` samples (16000 by default), as the JAX engine
pads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat
from thunder_tpu_torch.models.citrinet import CitrinetEncoder
from thunder_tpu_torch.models.decoders import Conv1dDecoder, LinearDecoder
from thunder_tpu_torch.models.layers import BN_EPS
from thunder_tpu_torch.models.quartznet import QuartznetEncoder
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder, serving_copy
from thunder_tpu_torch.module import (
    _BEAM_UNSET,
    CTCModule,
    long_transcribe,
    pad_to_bucket,
    require_device,
    to_device,
    transcribe,
)
from thunder_tpu_torch.ops.conv import conv_output_length, get_same_padding
from thunder_tpu_torch.ops.ctc import greedy_decode
from thunder_tpu_torch.ops.masking import lengths_to_mask
from thunder_tpu_torch.quantization import quantize_array

__all__ = ["InferenceEngine"]


def _fold_bn(bn) -> tuple[np.ndarray, np.ndarray]:
    p = {name: t.detach().cpu().numpy() for name, t in bn.state_dict().items()}  # scale, bias, mean, var
    scale = p["scale"] / np.sqrt(p["var"] + BN_EPS)
    bias = p["bias"] - p["mean"] * scale
    return scale.astype(np.float32), bias.astype(np.float32)


@dataclass
class _RepeatPlan:
    kind: str  # "separable" | "dense"
    kernel_size: int
    stride: int
    dilation: int
    relu: bool
    bias: torch.Tensor  # (C_out,) float32 for the separable kernel, the compute dtype for a dense product
    dw: Optional[torch.Tensor] = None  # (k, C_in) compute dtype
    pw: Optional[torch.Tensor] = None  # (C_in, C_out) compute dtype, BN scale folded in; int8 with q_scale
    q_scale: Optional[torch.Tensor] = None  # (1, C_out) int8_weights: pw's scale, in the compute dtype

    def weights(self) -> torch.Tensor:
        """``pw`` in the compute dtype: dequantized under ``int8_weights``."""
        return self.pw if self.q_scale is None else self.pw * self.q_scale


@dataclass
class _BlockPlan:
    repeats: List[_RepeatPlan]
    res: Optional[_RepeatPlan]
    se: Optional[tuple] = None  # (fc1 (C, C / r), fc2 (C / r, C)) float32, rounded to the compute dtype


def _decoder_weights(decoder) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The head's ``(C, V)`` kernel and ``(V,)`` bias; ``(None, None)`` without a head."""
    if decoder is None:
        return None, None
    if isinstance(decoder, Conv1dDecoder):
        return decoder.kernel.detach()[0], decoder.bias.detach()
    if isinstance(decoder, LinearDecoder):
        return decoder.dense.kernel.detach(), decoder.dense.bias.detach()
    raise NotImplementedError(f"InferenceEngine serves Conv1dDecoder and LinearDecoder heads, "
                              f"got {type(decoder).__name__}")


def _check_residual_lengths(repeats: List[_RepeatPlan], res: _RepeatPlan, block: int, longest: int = 1 << 16) -> None:
    """Raise unless the residual branch gives the lengths (and so the frames) of the block's repeats for every
    input length up to ``longest``: the forward adds the two and keeps the repeats' lengths."""
    lengths = want = np.arange(longest + 1)
    for rp in repeats:
        want = conv_output_length(want, rp.kernel_size, rp.stride, get_same_padding(rp.kernel_size, rp.stride,
                                                                                    rp.dilation), rp.dilation)
    got = conv_output_length(lengths, 1, res.stride, 0)
    if not np.array_equal(got, want):
        raise NotImplementedError(f"block {block}: the residual's lengths differ from its repeats' (residual "
                                  f"stride {res.stride}, repeat strides {[rp.stride for rp in repeats]})")


class InferenceEngine:
    """CTC inference over a ``CTCModule``'s weights (QuartzNet and Citrinet with BN folded, wav2vec2, or any
    other encoder through the module's eval forward)."""

    def __init__(self, module: CTCModule, compute_dtype: Optional[torch.dtype] = None, device=None,
                 pad_multiple: int = 16000, int8_weights: bool = False, int8_compute: bool = False,
                 posconv_dense: Optional[bool] = None):
        """``int8_weights``, ``int8_compute`` and ``posconv_dense`` are the JAX engine's serving modes, with its
        defaults (see the module docstring); ``int8_compute`` raises ``ValueError`` for any encoder but wav2vec2."""
        self.device = require_device(device if device is not None else module.device)
        on_cuda = self.device.type == "cuda"
        self.dtype = compute_dtype or (torch.bfloat16 if on_cuda else torch.float32)
        if on_cuda and self.dtype != torch.bfloat16:
            raise ValueError("on the card the engine computes in bfloat16 (the kernels' type)")
        encoder = module.model.encoder
        self.int8_weights, self.int8_compute = bool(int8_weights), bool(int8_compute)
        if self.int8_compute and not isinstance(encoder, Wav2Vec2Encoder):
            raise ValueError("int8_compute is a wav2vec2 serving mode")
        self.module = module
        self.pad_multiple = pad_multiple
        self.frontend = module.model.audio_transform.to(self.device)
        if isinstance(encoder, Wav2Vec2Encoder):
            self._encoder = serving_copy(encoder, self.dtype, posconv_dense=bool(posconv_dense),
                                         int8_compute=self.int8_compute, int8_weights=self.int8_weights)
            self._encoder.to(self.device)
            self._forward = self._forward_wav2vec2
        elif isinstance(encoder, (QuartznetEncoder, CitrinetEncoder)):
            self._plan = self._build_plan(encoder)
            self._forward = self._forward_conv
        else:
            self._model = module.to(self.device).model if self.device != module.device else module.model
            self._forward = self._forward_module
            return
        kernel, bias = _decoder_weights(module.model.decoder)
        self._dec_bias = None if bias is None else bias.to(self.device, torch.float32)
        self._dec_kernel = self._dec_scale = None  # (C, V); int8 with (1, V) scale in the int8 modes
        if kernel is not None and (self.int8_weights or self.int8_compute):
            self._dec_kernel, self._dec_scale = self._quantized(kernel)
        elif kernel is not None:
            self._dec_kernel = kernel.to(self.device, self.dtype)

    def _quantized(self, w) -> tuple[torch.Tensor, torch.Tensor]:
        """``quantize_array(w)`` on the device: int8 values and the scale, pre-cast to the compute dtype."""
        q, scale = quantize_array(w)
        return torch.as_tensor(q, device=self.device), torch.as_tensor(scale, device=self.device).to(self.dtype)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    def _repeat_plan(self, rep, relu) -> _RepeatPlan:
        scale, bias = _fold_bn(rep.bn)
        put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        if rep.separable:
            conv = rep.depthwise
            dw = conv.kernel.detach().cpu().numpy()[:, 0, :]  # (k, C)
            pw = rep.pointwise.kernel.detach().cpu().numpy()[0] * scale[None, :]  # (C, C_out)
            plan = _RepeatPlan("separable", dw.shape[0], conv.stride, conv.dilation, relu, put(bias),
                               dw=put(dw).to(self.dtype).contiguous())
        else:
            kernel = rep.conv.kernel.detach().cpu().numpy()
            if kernel.shape[0] != 1:
                raise NotImplementedError("dense convs other than 1x1 are not on the QuartzNet or Citrinet path")
            pw = kernel[0] * scale[None, :]
            plan = _RepeatPlan("dense", 1, rep.conv.stride, 1, relu, put(bias).to(self.dtype))
        if self.int8_weights:  # every pointwise and 1x1 product of the plan
            plan.pw, plan.q_scale = self._quantized(pw)
        else:
            plan.pw = put(pw).to(self.dtype).contiguous()
        return plan

    def _build_plan(self, encoder) -> List[_BlockPlan]:
        """One :class:`_BlockPlan` per ``EncoderBlock`` of a QuartzNet or Citrinet encoder, read from the
        blocks themselves: each repeat's own stride, the residual's stride and the squeeze-excite."""
        plan = []
        for b in range(encoder.num_blocks):
            block = getattr(encoder, f"block{b}")
            repeats = [self._repeat_plan(getattr(block, f"rep{r}"), relu=r != block.repeat - 1)
                       for r in range(block.repeat)]
            res = None
            if block.res is not None:
                res = self._repeat_plan(block.res, relu=False)
                _check_residual_lengths(repeats, res, b)
            se = None
            if block.se is not None:
                # float32 copies of the compute-dtype weights: the products accumulate in float32
                se = tuple(fc.kernel.detach().to(self.device, self.dtype).float()
                           for fc in (block.se.fc1, block.se.fc2))
            plan.append(_BlockPlan(repeats, res, se))
        return plan

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _apply_repeat(self, rp: _RepeatPlan, x, lengths, mask_cache: Dict[int, torch.Tensor]):
        """One conv repeat. The input is zero beyond ``lengths``; so is the output."""
        pad = get_same_padding(rp.kernel_size, rp.stride, rp.dilation)
        if rp.stride == 1 and 2 * pad == rp.dilation * (rp.kernel_size - 1):
            new_lengths = lengths  # same padding at stride 1 keeps every length: no launches to recompute them
        else:
            new_lengths = conv_output_length(lengths, rp.kernel_size, rp.stride, pad, rp.dilation)
        if rp.kind == "separable":
            y = fused_separable_repeat(x, new_lengths, rp.dw, rp.weights(), rp.bias, rp.kernel_size,
                                       stride=rp.stride, dilation=rp.dilation, relu=rp.relu)
            return y, new_lengths
        if rp.stride > 1:
            x = x[:, :: rp.stride]  # a 1x1 conv's same padding is 0
        y = torch.matmul(x, rp.weights()) + rp.bias
        if rp.relu:
            y = torch.relu(y)
        t = y.shape[1]
        if t not in mask_cache:
            mask_cache[t] = lengths_to_mask(new_lengths, t).to(self.dtype)[:, :, None]
        return y * mask_cache[t], new_lengths

    def _apply_se(self, se, x, lengths):
        """Squeeze-excite gate of ``x``, which is zero beyond ``lengths``: its masked mean is its sum over
        the frames (float32) over the valid count, at least 1."""
        fc1, fc2 = se
        count = lengths.clamp(1, x.shape[1]).to(torch.float32)[:, None]
        pooled = (x.sum(dim=1, dtype=torch.float32) / count).to(self.dtype)
        y = torch.relu(torch.matmul(pooled.float(), fc1)).to(self.dtype)
        y = torch.matmul(y.float(), fc2)
        return x * torch.sigmoid(y).to(x.dtype)[:, None, :]

    def _decode(self, x: torch.Tensor):
        """Encoder output -> float32 logits (compute-dtype product, float32 accumulation and bias; without a
        decoder the encoder output itself) and argmax."""
        if self._dec_kernel is None:
            logits = x.float()
        else:
            kernel = self._dec_kernel if self._dec_scale is None else self._dec_kernel * self._dec_scale
            logits = torch.matmul(x.float(), kernel.float()) + self._dec_bias
        return logits, greedy_decode(logits)

    def _forward_conv(self, audio: torch.Tensor, lengths: torch.Tensor):
        feats, out_lengths = self.frontend(audio, lengths)
        x = feats.to(self.dtype)
        mask_cache: Dict[int, torch.Tensor] = {}
        for block in self._plan:
            inp, inp_lengths = x, out_lengths
            for rp in block.repeats:
                x, out_lengths = self._apply_repeat(rp, x, out_lengths, mask_cache)
            if block.se is not None:
                x = self._apply_se(block.se, x, out_lengths)
            if block.res is not None:
                res, _ = self._apply_repeat(block.res, inp, inp_lengths, mask_cache)
                x = x + res
            x = torch.relu(x)
        return (*self._decode(x), out_lengths)

    def _forward_wav2vec2(self, audio: torch.Tensor, lengths: torch.Tensor):
        feats, feat_lengths = self.frontend(audio, lengths)
        h, out_lengths = self._encoder(feats, feat_lengths)
        return (*self._decode(h), out_lengths)

    def _forward_module(self, audio: torch.Tensor, lengths: torch.Tensor):
        logits, out_lengths = self._model(audio, lengths)
        return logits, greedy_decode(logits), out_lengths

    @torch.inference_mode()
    def infer(self, audio, lengths):
        """Padded audio ``(B, T)`` and lengths -> ``(logits, preds, out_lengths)`` on the device."""
        return self._forward(to_device(audio, torch.float32, self.device), to_device(lengths, torch.int32, self.device))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def __call__(self, audio, lengths):
        logits, _, out_lengths = self.infer(audio, lengths)
        return logits, out_lengths

    def weight_bytes(self) -> int:
        """Bytes of the weight tensors the engine keeps on its device: the conv plan or the wav2vec2 serving
        copy's parameters and buffers, and the decoder (the module's parameters and buffers for the generic
        encoder path). The int8 modes hold their quantized weights as int8 and a scale a column."""
        if hasattr(self, "_model"):
            tensors = [*self._model.parameters(), *self._model.buffers()]
        else:
            if hasattr(self, "_encoder"):
                tensors = [*self._encoder.parameters(), *self._encoder.buffers()]
            else:
                tensors = [t for block in self._plan for rp in (*block.repeats, block.res) if rp is not None
                           for t in (rp.dw, rp.pw, rp.q_scale, rp.bias)]
                tensors += [t for block in self._plan for t in block.se or ()]
            tensors += [self._dec_kernel, self._dec_scale, self._dec_bias]
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def warmup(self, batch_sizes, durations_s, sample_rate: int = 16000) -> int:
        """Run every (batch size, bucketed duration) pair once, so the kernels are
        built and loaded before the first request. Returns the number of shapes run."""
        n = 0
        for b in batch_sizes:
            for s in durations_s:
                samples = pad_to_bucket(int(s * sample_rate), self.pad_multiple)
                audio = np.zeros((b, samples), dtype=np.float32)
                lengths = np.full((b,), samples, dtype=np.int32)
                self.infer(audio, lengths)[1].cpu()
                n += 1
        return n

    def predict(self, audio, lengths=None, beam_width: Optional[int] = None, prune_logp: float = _BEAM_UNSET, lm=None,
                lm_weight: float = _BEAM_UNSET, nbest: Optional[int] = None, beam_backend: Optional[str] = None,
                **beam_kwargs) -> List[str]:
        """Greedy decode of an audio batch (or one clip) by default; ``beam_width``
        switches to CTC prefix beam search over the logits, ``beam_backend="host"``
        (default, the C++ search, in-search LM fusion) or ``"device"`` (the beam
        kernels on the forward's logits, which stay on the device; an ``lm`` ranks
        the surviving beam on the host). With ``nbest=k``, returns per sample the
        top-k ``(text, log_prob)`` pairs instead of one string."""
        return transcribe(self.module, self.infer, self.pad_multiple, audio, lengths, beam_width, prune_logp, lm,
                          lm_weight, nbest, beam_backend, beam_kwargs)

    def predict_long(self, audio, chunk_seconds: float = 20.0, overlap_seconds: float = 2.0, sample_rate: int = 16000,
                     beam_width: Optional[int] = None, **beam_kwargs) -> str:
        """Chunked long-audio transcription on the engine's forward; ``beam_width``
        beam-decodes the chunks' trimmed frame windows as one continuous search
        (see :func:`thunder_tpu_torch.module.chunked_transcribe`)."""
        if self.module.text_transform is None:
            raise ValueError("predict_long requires a text_transform")
        return long_transcribe(self.module, self.infer, self.predict, audio, chunk_seconds, overlap_seconds,
                               sample_rate, beam_width, beam_kwargs)
