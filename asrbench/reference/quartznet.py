"""QuartzNet (Kriman et al., arXiv:1910.10261) in plain float32 PyTorch: the log-mel frontend, the separable
encoder and the 1x1 CTC decoder, in eval mode (running statistics) and in train mode (masked batch
statistics, dropout 0.1 after each activated repeat and each block, the dither).

Weights are read by name from a state dict in the layout the benchmark makes them in: conv kernels
``(kernel_size, in // groups, out)``, batch norm as ``scale``/``bias``/``mean``/``var`` (eps 1e-3). The blocks:
the stride-2 separable stem (k 33, 256 channels), ``repeat_blocks`` residual blocks of ``repeat`` separable
repeats for each (filters, kernel), the dilation-2 k-87 tail and the 1x1 1,024-channel block; each conv reads
its input zeroed beyond the row's valid frames; a block is ReLU (then dropout) of its last repeat plus, where it
has one, the 1x1 conv + batch norm residual of its input.

``operand`` rounds both operands of every convolution and product, and ``gradient`` the gradient that reaches
each one's output in the backward (both the identity for the reference; a lower precision for a control).
``draws`` is the training step's random source, in the order the step draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asrbench.reference import frontend

BN_EPS = 1e-3


def blocks(config: dict) -> list:
    """The block list: dicts of features, repeat, kernel, stride, dilation, residual, separable."""
    out = [dict(features=256, repeat=1, kernel=33, stride=2, dilation=1, residual=False, separable=True)]
    for f, k in zip(config["filters"], config["kernel_sizes"]):
        out += [dict(features=f, repeat=config["repeat"], kernel=k, stride=1, dilation=1, residual=True,
                     separable=True)] * config["repeat_blocks"]
    out.append(dict(features=512, repeat=1, kernel=87, stride=1, dilation=2, residual=False, separable=True))
    out.append(dict(features=1024, repeat=1, kernel=1, stride=1, dilation=1, residual=False, separable=False))
    return out


def _same_padding(k: int, stride: int, dilation: int) -> int:
    return (dilation * (k - 1) + 1) // 2 if dilation > 1 else k // 2


def _out_lengths(lengths, k, stride, padding, dilation):
    return torch.div(lengths + 2 * padding - dilation * (k - 1) - 1, stride, rounding_mode="floor") + 1


def _mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def _identity(x):
    return x


class QuartzNet:
    """``forward(audio, lengths)`` -> float32 logits ``(B, frames, V)`` and their lengths."""

    def __init__(self, config: dict, state: dict, operand=_identity, gradient=_identity):
        self.config = config
        self.state = state
        self.operand = operand
        self.gradient = gradient
        self.blocks = blocks(config)
        self.fit = False  # calibrate: each batch norm's running statistics set from its input as it runs

    def _conv(self, x, key, lengths, k, stride, dilation, groups):
        """Channels-first ``x`` zeroed beyond ``lengths``, convolved with ``key``'s WIO kernel."""
        x = torch.where(_mask(lengths, x.shape[2])[:, None, :], x, 0.0)
        pad = _same_padding(k, stride, dilation)
        w = self.state[key].permute(2, 1, 0)
        y = self.gradient(F.conv1d(self.operand(x), self.operand(w), stride=stride, padding=pad, dilation=dilation,
                                   groups=groups))
        return y, _out_lengths(lengths, k, stride, pad, dilation)

    def _bn(self, x, prefix, lengths, train):
        s = self.state
        if self.fit:
            flat = x.transpose(1, 2).reshape(-1, x.shape[1])
            s[prefix + ".mean"].copy_(flat.mean(0))
            s[prefix + ".var"].copy_(flat.var(0))
        if train:
            m = _mask(lengths, x.shape[2]).float()[:, None, :]
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dim=(0, 2)) / n
            var = ((x - mean[None, :, None]).square() * m).sum(dim=(0, 2)) / n
        else:
            mean, var = s[prefix + ".mean"], s[prefix + ".var"]
        y = (x - mean[None, :, None]) * torch.rsqrt(var + BN_EPS)[None, :, None]
        return y * s[prefix + ".scale"][None, :, None] + s[prefix + ".bias"][None, :, None]

    def _conv_bn(self, x, lengths, prefix, blk, c_in, separable, train, draws, activation, k, stride):
        if separable:
            x, lengths = self._conv(x, prefix + ".depthwise.kernel", lengths, k, stride, blk["dilation"], c_in)
            x, lengths = self._conv(x, prefix + ".pointwise.kernel", lengths, 1, 1, 1, 1)
        else:
            x, lengths = self._conv(x, prefix + ".conv.kernel", lengths, k, stride, blk["dilation"], 1)
        x = self._bn(x, prefix + ".bn", lengths, train)
        if activation:
            x = torch.relu(x)
            if train:
                x = self._dropout(x, draws)
        return x, lengths

    def _dropout(self, x, draws):
        rate = self.config["dropout"]
        if rate == 0.0:
            return x
        keep = draws.rand(x.transpose(1, 2).shape).transpose(1, 2) < (1.0 - rate)  # the draw is channels-last
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def encode(self, feats, frames, train=False, draws=None):
        """Channels-last features -> channels-first encoder output and its lengths."""
        x, lengths = feats.transpose(1, 2), frames
        c = self.config["feat_in"]
        for i, blk in enumerate(self.blocks):
            inp, inp_lengths = x, lengths
            for r in range(blk["repeat"]):
                last = r == blk["repeat"] - 1
                x, lengths = self._conv_bn(x, lengths, f"encoder.block{i}.rep{r}", blk, c if r == 0 else blk["features"],
                                           blk["separable"], train, draws, not last, blk["kernel"], blk["stride"])
            if blk["residual"]:
                res, _ = self._conv_bn(inp, inp_lengths, f"encoder.block{i}.res", blk, c, False, train, draws, False,
                                       1, 1)
                x = x + res
            x = torch.relu(x)
            if train:
                x = self._dropout(x, draws)
            c = blk["features"]
        return x, lengths

    def forward(self, audio, lengths, train=False, draws=None):
        lengths = torch.as_tensor(lengths, device=audio.device).long()
        noise = draws.randn(audio.shape) if train and self.config["frontend"]["dither"] > 0 else None
        feats, frames = frontend.features(audio, lengths, self.config["frontend"], noise)
        x, out_lengths = self.encode(feats, frames, train, draws)
        w = self.state["decoder.kernel"][0]
        logits = self.gradient(torch.matmul(self.operand(x.transpose(1, 2)), self.operand(w)))
        logits = logits + self.state["decoder.bias"]
        return logits, out_lengths

    @torch.no_grad()
    def calibrate(self, audio, lengths) -> None:
        """Set every batch norm's running mean and (unbiased) variance to those of its input on ``audio``
        (full-length rows), layer by layer in one eval forward: a deep random network then keeps the scale of
        its input, as a trained one does."""
        self.fit = True
        try:
            self.forward(audio, lengths)
        finally:
            self.fit = False
