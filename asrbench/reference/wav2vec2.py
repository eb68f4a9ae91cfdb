"""wav2vec2 with a CTC head (Baevski et al., arXiv:2006.11477; HF ``Wav2Vec2ForCTC``, the base layout:
group-norm extractor, post-LayerNorm layers) in plain float32 PyTorch, in eval and train mode.

- The waveform: zero mean and unit population variance over each row's valid samples, ``(x - mean) /
  (std + 1e-7)``, zero beyond them.
- The extractor: seven valid convs without bias (the first followed by a per-channel norm over the row's valid
  frames), each then the exact (erf) gelu.
- The feature projection: LayerNorm, a product, dropout (train), the frames beyond each row's length zeroed.
- The positional embedding: a grouped conv (kernel 128, 16 groups, padding 64, the trailing frame dropped),
  gelu, then LayerNorm(h + pos) and dropout (train).
- Each layer: LayerNorm(x + dropout(attention(x))), then LayerNorm(x + dropout(ffn(x))); the attention's
  fused qkv product, the query scaled by dh^-0.5, keys beyond the row's length masked, float32 softmax and
  dropout on the probabilities (train).
- The head: dropout (train), then the product to the vocabulary.

Weights are read by name from the benchmark's state dict: conv kernels ``(k, in // groups, out)``, dense
kernels ``(in, out)``, norms as ``scale``/``bias``.

In train mode ``draws`` gives every random number in the order the step draws it: a uniform draw for each
``torch.rand`` dropout, and a 31-bit seed for each dropout the training kernels hash (the attention's
probabilities: :func:`~asrbench.work.dropout_hash.attention_keep`; the two residual branches of a layer:
:func:`~asrbench.work.dropout_hash.rows_keep`). ``operand`` rounds both operands of every product and
convolution, and ``gradient`` the gradient that reaches each product's output in the backward (both the
identity for the reference; a lower precision for a control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asrbench.work import dropout_hash


def _identity(x):
    return x


def _mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def extractor_lengths(lengths, kernels, strides):
    for k, s in zip(kernels, strides):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


class Wav2Vec2:
    """``forward(audio, lengths)`` -> float32 logits ``(B, frames, V)`` and their lengths."""

    def __init__(self, config: dict, state: dict, operand=_identity, gradient=_identity, attention_rows: int = 256):
        self.config = config
        self.state = state
        self.operand = operand
        self.gradient = gradient
        self.attention_rows = attention_rows  # query rows a block when the hashed mask is worked out

    def _dense(self, x, name):
        w, b = self.state[name + ".kernel"], self.state.get(name + ".bias")
        y = self.gradient(torch.matmul(self.operand(x), self.operand(w)))
        return y if b is None else y + b

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.state[name + ".scale"], self.state[name + ".bias"],
                            self.config["layer_norm_eps"])

    def _dropout(self, x, rate, draws):
        if rate == 0.0:
            return x
        keep = draws.rand(x.shape) < (1.0 - rate)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def _hashed(self, y, rate, draws):
        """The add + LayerNorm kernel's dropout of its branch ``y``."""
        if rate == 0.0:
            return y
        keep = dropout_hash.rows_keep(draws.seed(), y.shape, rate)
        return torch.where(keep, y / (1.0 - rate), 0.0)

    def preprocess(self, audio, lengths):
        m = _mask(lengths, audio.shape[1]).float()
        n = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        x = audio.float() * m
        mean = x.sum(dim=1, keepdim=True) / n
        std = torch.sqrt(((x - mean) * m).square().sum(dim=1, keepdim=True) / n)
        return (x - mean) / (std + 1e-7) * m

    def extract(self, x, lengths):
        """Normalized audio ``(B, samples)`` -> ``(B, frames, C)``; the frame lengths."""
        cfg = self.config
        h = x[:, None, :]
        cur = lengths
        for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
            w = self.state[f"encoder.feature_extractor.conv{i}.kernel"].permute(2, 1, 0)
            h = self.gradient(F.conv1d(self.operand(h), self.operand(w), stride=s))
            cur = torch.div(cur - k, s, rounding_mode="floor") + 1
            if i == 0:
                m = _mask(cur, h.shape[2]).float()[:, None, :]
                n = m.sum(dim=2, keepdim=True).clamp_min(1.0)
                mean = (h * m).sum(dim=2, keepdim=True) / n
                var = ((h - mean).square() * m).sum(dim=2, keepdim=True) / n
                gn = "encoder.feature_extractor.gn"
                h = (h - mean) * torch.rsqrt(var + cfg["layer_norm_eps"])
                h = h * self.state[gn + ".scale"][None, :, None] + self.state[gn + ".bias"][None, :, None]
            h = F.gelu(h)
        return h.transpose(1, 2), cur

    def attention(self, x, lengths, prefix, train, draws):
        cfg = self.config
        b, t, hidden = x.shape
        heads = cfg["num_attention_heads"]
        dh = hidden // heads
        qkv = self._dense(x, prefix + ".qkv_proj")
        q, k, v = (a.reshape(b, t, heads, dh).transpose(1, 2) for a in qkv.split(hidden, dim=-1))
        q = q * dh**-0.5
        rate = cfg["attention_dropout"] if train else 0.0
        seed = draws.seed() if rate > 0.0 else None
        key_ok = _mask(lengths, t)[:, None, None, :]
        out = []
        for lo in range(0, t, self.attention_rows):
            rows = torch.arange(lo, min(lo + self.attention_rows, t), device=x.device)
            s = self.gradient(torch.matmul(self.operand(q[:, :, rows]), self.operand(k).transpose(-1, -2)))
            p = torch.softmax(torch.where(key_ok, s, torch.finfo(torch.float32).min), dim=-1)
            if seed is not None:
                keep = dropout_hash.attention_keep(seed, b, heads, t, rate, rows)
                p = torch.where(keep, p / (1.0 - rate), 0.0)
            out.append(self.gradient(torch.matmul(self.operand(p), self.operand(v))))
        o = torch.cat(out, dim=2).transpose(1, 2).reshape(b, t, hidden)
        return self._dense(o, prefix + ".out_proj")

    def encode(self, feats, out_lengths, train=False, draws=None):
        cfg = self.config
        rate = cfg["hidden_dropout"] if train else 0.0
        h = self._ln(feats, "encoder.fp_layer_norm")
        h = self._dense(h, "encoder.fp_projection")
        if train:
            h = self._dropout(h, cfg["feat_proj_dropout"], draws)
        h = torch.where(_mask(out_lengths, h.shape[1])[:, :, None], h, 0.0)
        w = self.state["encoder.pos_conv.kernel"].permute(2, 1, 0)
        k = w.shape[2]
        pos = self.gradient(F.conv1d(self.operand(h.transpose(1, 2)), self.operand(w), padding=k // 2,
                                     groups=cfg["num_conv_pos_embedding_groups"]))
        pos = pos + self.state["encoder.pos_conv.bias"][None, :, None]
        pos = F.gelu(pos[:, :, : h.shape[1]].transpose(1, 2))
        h = self._ln(h + pos, "encoder.enc_layer_norm")
        if train:
            h = self._dropout(h, cfg["hidden_dropout"], draws)
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layer{i}"
            a = self.attention(h, out_lengths, p + ".attention", train, draws)
            h = self._ln(h + self._hashed(a, rate, draws), p + ".layer_norm")
            f = self._dense(F.gelu(self._dense(h, p + ".intermediate_dense")), p + ".output_dense")
            h = self._ln(h + self._hashed(f, rate, draws), p + ".final_layer_norm")
        return h

    def forward(self, audio, lengths, train=False, draws=None, extractor_grad=False):
        lengths = torch.as_tensor(lengths, device=audio.device).long()
        x = self.preprocess(audio, lengths)
        with torch.set_grad_enabled(extractor_grad and torch.is_grad_enabled()):
            feats, out_lengths = self.extract(x, lengths)
        h = self.encode(feats, out_lengths, train, draws)
        if train:
            h = self._dropout(h, self.config["final_dropout"], draws)
        return self._dense(h, "decoder.dense"), out_lengths
