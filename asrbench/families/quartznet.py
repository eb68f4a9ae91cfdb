"""The QuartzNet family: the state the benchmark makes from a seed, the port's module and engine built on it,
the plain reference, and the work counted for ``mfu.*``.

A configuration file of this family (``"family": "quartznet"``) gives the encoder's plan (``feat_in``,
``filters``, ``kernel_sizes``, ``repeat_blocks``, ``repeat``), the vocabulary, the frontend's settings and the
training dropout. The port is imported inside the functions that build it, never by the reference.
"""

from __future__ import annotations

import torch

from asrbench.reference import quartznet as ref
from asrbench.work import flops, waveform

CALIBRATION_ROWS, CALIBRATION_SECONDS = 8, 15


def state_shapes(config: dict) -> list:
    """``(name, shape, kind)`` of every tensor of the model's state dict; ``kind`` says how it is drawn."""
    out = []
    c = config["feat_in"]
    for i, blk in enumerate(ref.blocks(config)):
        f, k = blk["features"], blk["kernel"]
        for r in range(blk["repeat"]):
            c_in = c if r == 0 else f
            p = f"encoder.block{i}.rep{r}"
            if blk["separable"]:
                out += [(p + ".depthwise.kernel", (k, 1, c_in), "kernel"), (p + ".pointwise.kernel", (1, c_in, f), "kernel")]
            else:
                out.append((p + ".conv.kernel", (k, c_in, f), "kernel"))
            out += [(p + f".bn.{n}", (f,), "bn_" + n) for n in ("scale", "bias", "mean", "var")]
        if blk["residual"]:
            p = f"encoder.block{i}.res"
            out.append((p + ".conv.kernel", (1, c, f), "kernel"))
            out += [(p + f".bn.{n}", (f,), "bn_" + n) for n in ("scale", "bias", "mean", "var")]
        c = f
    v = len(config["vocabulary"]) + 1
    return out + [("decoder.kernel", (1, c, v), "kernel"), ("decoder.bias", (v,), "bias")]


def make_state(config: dict, seed: int, device) -> dict:
    """The weights from ``seed``, on ``device`` in float32, in two draws: a normal one for the kernels (scaled by
    ``1/sqrt(fan_in)``) and the decoder's bias (0.02), a uniform one for the batch norms' affines (scale in
    [0.2, 0.5], bias in [0.5, 1.0], so that the ReLUs mostly pass). Then every running mean and variance is set
    to its input's on full-length calibration clips, layer by layer (:meth:`QuartzNet.calibrate`)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = state_shapes(config)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in shapes]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    state, at = {}, 0
    for (name, shape, kind), n in zip(shapes, sizes):
        z, u = normal[at: at + n].reshape(shape), uniform[at: at + n].reshape(shape)
        at += n
        if kind == "kernel":
            t = z * (1.0 / float(torch.Size(shape[:-1]).numel()) ** 0.5)
        elif kind == "bias":
            t = 0.02 * z
        elif kind == "bn_scale":
            t = 0.2 + 0.3 * u
        elif kind == "bn_bias":
            t = 0.5 + 0.5 * u
        elif kind == "bn_mean":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.ones(shape, device=device)
        state[name] = t.contiguous()
    samples = CALIBRATION_SECONDS * waveform.SAMPLE_RATE
    clips = waveform.waveforms([samples] * CALIBRATION_ROWS, int(seed) + 1, device)
    audio = torch.as_tensor(torch.stack([torch.as_tensor(c) for c in clips]), device=device)
    reference(config, state).calibrate(audio, torch.full((CALIBRATION_ROWS,), samples, device=device))
    return state


def reference(config: dict, state: dict, **precision):
    """The plain reference on ``state``; ``precision`` may give its ``operand`` and ``gradient`` rounding."""
    return ref.QuartzNet(config, state, **precision)


def port_module(config: dict, state: dict, device, train: bool = False):
    """The port's ``CTCModule`` holding ``state``: bf16 compute in train mode (the serving engine casts itself)."""
    from thunder_tpu_torch.audio import FilterbankFeatures
    from thunder_tpu_torch.models import Conv1dDecoder, QuartznetEncoder
    from thunder_tpu_torch.module import CTCModel, CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    fe = config["frontend"]
    dtype = torch.bfloat16 if train else torch.float32  # the configuration trains in bf16, on the CPU too
    frontend = FilterbankFeatures(sample_rate=fe["sample_rate"], n_window_size=fe["win_length"],
                                  n_window_stride=fe["hop_length"], n_fft=fe["n_fft"], preemph=fe["preemph"],
                                  nfilt=fe["n_mels"], dither=fe["dither"], div_guard=fe["norm_guard"])
    encoder = QuartznetEncoder(feat_in=config["feat_in"], filters=config["filters"],
                               kernel_sizes=config["kernel_sizes"], repeat_blocks=config["repeat_blocks"],
                               repeat=config["repeat"], dropout=config["dropout"] if train else 0.0, dtype=dtype)
    tt = BatchTextTransformer(config["vocabulary"])
    model = CTCModel(frontend, encoder, Conv1dDecoder(tt.num_tokens, dtype=dtype)).to(device)
    return CTCModule(model=model.eval(), text_transform=tt, device=torch.device(device)).with_state(state)


def engine(module, control: bool = False):
    """The serving engine; ``control`` switches on the program's own lower-precision path (int8 weights)."""
    from thunder_tpu_torch.engine import InferenceEngine

    return InferenceEngine(module, int8_weights=control)


def forward_flops(config: dict, batch: int, samples: int) -> int:
    frames = samples // config["frontend"]["hop_length"] + 1
    return flops.quartznet_forward_flops(frames, feat_in=config["feat_in"], filters=tuple(config["filters"]),
                                         kernel_sizes=tuple(config["kernel_sizes"]),
                                         repeat_blocks=config["repeat_blocks"], repeat=config["repeat"],
                                         num_classes=len(config["vocabulary"]) + 1, batch=batch)


def train_flops(config: dict, batch: int, samples: int) -> int:
    fe = config["frontend"]
    return 3 * forward_flops(config, batch, samples) + flops.filterbank_flops(
        samples, hop_length=fe["hop_length"], n_fft=fe["n_fft"], nfilt=fe["n_mels"], batch=batch)


def trainable(config: dict, state: dict) -> list:
    """The leaves training updates: every parameter (the running statistics are buffers)."""
    return [n for n in state if not n.endswith((".bn.mean", ".bn.var"))]
