"""Greedy-CTC inference engine for QuartzNet: the serving hot path.

Port of the QuartzNet path of ``thunder_tpu/engine.py::InferenceEngine``:

- batch norm folded into the pointwise weights and a float32 bias at build
  time (eval-mode running statistics);
- every separable repeat (the stride-2 stem, the 75 body repeats and the
  dilation-2 tail) is one launch of the fused separable-repeat kernel, which
  also applies bias, ReLU and the zero-beyond-length mask;
- the dense 1x1 convs (residual branches, the 1024-channel block) and the
  decoder are matmuls in the compute dtype with float32 accumulation, with
  the mask folded into the same elementwise pass (masks cached per length of
  time within a forward);
- the log-mel frontend is one launch of the fused log-mel kernel.

Compute is bfloat16 on the card (as the JAX engine computes in bf16 on its
accelerator) and float32 on the CPU, where every kernel wrapper runs its
plain version. Asking for float32 on the card raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from thunder_tpu_torch.kernels.separable_conv import fused_separable_repeat
from thunder_tpu_torch.models.layers import BN_EPS
from thunder_tpu_torch.models.quartznet import QuartznetEncoder
from thunder_tpu_torch.module import CTCModule, decode_greedy, host_batch, pad_to_bucket, require_device, to_device
from thunder_tpu_torch.ops.conv import conv_output_length, get_same_padding
from thunder_tpu_torch.ops.ctc import greedy_decode
from thunder_tpu_torch.ops.masking import lengths_to_mask

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
    bias: torch.Tensor  # (C_out,) float32
    dw: Optional[torch.Tensor] = None  # (k, C_in) compute dtype
    pw: Optional[torch.Tensor] = None  # (C_in, C_out) compute dtype, BN scale folded in


@dataclass
class _BlockPlan:
    repeats: List[_RepeatPlan]
    res: Optional[_RepeatPlan]


class InferenceEngine:
    """Greedy-CTC inference over a ``CTCModule``'s weights with BN folded."""

    def __init__(self, module: CTCModule, compute_dtype: Optional[torch.dtype] = None, device=None):
        self.device = require_device(device if device is not None else module.device)
        on_cuda = self.device.type == "cuda"
        self.dtype = compute_dtype or (torch.bfloat16 if on_cuda else torch.float32)
        if on_cuda and self.dtype != torch.bfloat16:
            raise ValueError("on the card the engine computes in bfloat16 (the kernels' type)")
        encoder = module.model.encoder
        if not isinstance(encoder, QuartznetEncoder):
            raise NotImplementedError(f"InferenceEngine serves QuartzNet only for now, got {type(encoder).__name__}")
        self.module = module
        self.frontend = module.model.audio_transform.to(self.device)
        self._plan = self._build_plan(encoder)
        decoder = module.model.decoder
        self._dec_kernel = decoder.kernel.detach()[0].to(self.device, self.dtype)  # (C, V)
        self._dec_bias = decoder.bias.detach().to(self.device, torch.float32)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    def _repeat_plan(self, rep, stride, dilation, relu) -> _RepeatPlan:
        scale, bias = _fold_bn(rep.bn)
        put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        if rep.separable:
            dw = rep.depthwise.kernel.detach().cpu().numpy()[:, 0, :]  # (k, C)
            pw = rep.pointwise.kernel.detach().cpu().numpy()[0] * scale[None, :]  # (C, C_out)
            return _RepeatPlan("separable", dw.shape[0], stride, dilation, relu, put(bias),
                               dw=put(dw).to(self.dtype).contiguous(), pw=put(pw).to(self.dtype).contiguous())
        kernel = rep.conv.kernel.detach().cpu().numpy()
        if kernel.shape[0] != 1 or stride != 1:
            raise NotImplementedError("dense convs other than 1x1 with stride 1 are not on the QuartzNet path")
        return _RepeatPlan("dense", 1, stride, 1, relu, put(bias), pw=put(kernel[0] * scale[None, :]).to(self.dtype))

    def _build_plan(self, encoder: QuartznetEncoder) -> List[_BlockPlan]:
        plan = []
        for b in range(encoder.num_blocks):
            block = getattr(encoder, f"block{b}")
            repeats = []
            for r in range(block.repeat):
                rep = getattr(block, f"rep{r}")
                conv = rep.depthwise if rep.separable else rep.conv
                repeats.append(self._repeat_plan(rep, conv.stride, conv.dilation, relu=r != block.repeat - 1))
            res = None
            if block.res is not None:
                res = self._repeat_plan(block.res, block.res.conv.stride, 1, relu=False)
            plan.append(_BlockPlan(repeats, res))
        return plan

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def _apply_repeat(self, rp: _RepeatPlan, x, lengths, mask_cache: Dict[int, torch.Tensor]):
        """One conv repeat. The input is zero beyond ``lengths``; so is the output."""
        pad = get_same_padding(rp.kernel_size, rp.stride, rp.dilation)
        new_lengths = conv_output_length(lengths, rp.kernel_size, rp.stride, pad, rp.dilation)
        if rp.kind == "separable":
            y = fused_separable_repeat(x, new_lengths, rp.dw, rp.pw, rp.bias, rp.kernel_size,
                                       stride=rp.stride, dilation=rp.dilation, relu=rp.relu)
            return y, new_lengths
        y = torch.matmul(x, rp.pw) + rp.bias.to(self.dtype)
        if rp.relu:
            y = torch.relu(y)
        t = y.shape[1]
        if t not in mask_cache:
            mask_cache[t] = lengths_to_mask(new_lengths, t).to(self.dtype)[:, :, None]
        return y * mask_cache[t], new_lengths

    def _forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        feats, out_lengths = self.frontend(audio, lengths)
        x = feats.to(self.dtype)
        mask_cache: Dict[int, torch.Tensor] = {}
        for block in self._plan:
            inp, inp_lengths = x, out_lengths
            for rp in block.repeats:
                x, out_lengths = self._apply_repeat(rp, x, out_lengths, mask_cache)
            if block.res is not None:
                res, _ = self._apply_repeat(block.res, inp, inp_lengths, mask_cache)
                x = x + res
            x = torch.relu(x)
        logits = torch.matmul(x.float(), self._dec_kernel.float()) + self._dec_bias
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

    def warmup(self, batch_sizes, durations_s, sample_rate: int = 16000) -> int:
        """Run every (batch size, bucketed duration) pair once, so the kernels are
        built and loaded before the first request. Returns the number of shapes run."""
        n = 0
        for b in batch_sizes:
            for s in durations_s:
                samples = pad_to_bucket(int(s * sample_rate), self.module.pad_multiple)
                audio = np.zeros((b, samples), dtype=np.float32)
                lengths = np.full((b,), samples, dtype=np.int32)
                self.infer(audio, lengths)[1].cpu()
                n += 1
        return n

    def predict(self, audio, lengths=None) -> List[str]:
        """Greedy decode of an audio batch (or one clip) into strings."""
        tt = self.module.text_transform
        if tt is None:
            raise ValueError("predict requires a text_transform")
        audio, lengths = host_batch(audio, lengths, self.module.pad_multiple)
        _, preds, out_lengths = self.infer(audio, lengths)
        return decode_greedy(tt, preds, out_lengths)
