"""The wav2vec2 family (base layout: group-norm extractor, post-LayerNorm layers): the state the benchmark makes
from a seed, the port's module and engine built on it, the plain reference, and the work counted for ``mfu.*``.

A configuration file of this family (``"family": "wav2vec2"``) holds the HF config's sizes (``hidden_size``,
``num_hidden_layers``, ``num_attention_heads``, ``intermediate_size``, ``conv_dim``, ``conv_kernel``,
``conv_stride``, ``num_conv_pos_embeddings``, ``num_conv_pos_embedding_groups``, ``layer_norm_eps``), its
dropout rates and the vocabulary. The port is imported inside the functions that build it.
"""

from __future__ import annotations

import torch

from asrbench.reference import wav2vec2 as ref
from asrbench.work import flops


def state_shapes(config: dict) -> list:
    """``(name, shape, kind)`` of every tensor of the model's state dict."""
    h, ffn = config["hidden_size"], config["intermediate_size"]
    out, c = [], 1
    for i, (dim, k) in enumerate(zip(config["conv_dim"], config["conv_kernel"])):
        out.append((f"encoder.feature_extractor.conv{i}.kernel", (k, c, dim), "kernel"))
        c = dim
    norm = lambda p, n: [(p + ".scale", (n,), "scale"), (p + ".bias", (n,), "bias")]  # noqa: E731
    dense = lambda p, i, o: [(p + ".kernel", (i, o), "kernel"), (p + ".bias", (o,), "bias")]  # noqa: E731
    out += norm("encoder.feature_extractor.gn", c) + norm("encoder.fp_layer_norm", c)
    out += dense("encoder.fp_projection", c, h)
    k, groups = config["num_conv_pos_embeddings"], config["num_conv_pos_embedding_groups"]
    out += [("encoder.pos_conv.kernel", (k, h // groups, h), "kernel"), ("encoder.pos_conv.bias", (h,), "bias")]
    out += norm("encoder.enc_layer_norm", h)
    for i in range(config["num_hidden_layers"]):
        p = f"encoder.layer{i}"
        out += dense(p + ".attention.qkv_proj", h, 3 * h) + dense(p + ".attention.out_proj", h, h)
        out += norm(p + ".layer_norm", h) + dense(p + ".intermediate_dense", h, ffn)
        out += dense(p + ".output_dense", ffn, h) + norm(p + ".final_layer_norm", h)
    return out + dense("decoder.dense", h, len(config["vocabulary"]) + 1)


def make_state(config: dict, seed: int, device) -> dict:
    """The weights from ``seed``, on ``device`` in float32, from one normal draw: kernels scaled by
    ``1/sqrt(fan_in)``, biases by 0.02, norm scales ``1 + 0.02 z``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = state_shapes(config)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in shapes]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    state, at = {}, 0
    for (name, shape, kind), n in zip(shapes, sizes):
        z = normal[at: at + n].reshape(shape)
        at += n
        if kind == "kernel":
            t = z * (1.0 / float(torch.Size(shape[:-1]).numel()) ** 0.5)
        elif kind == "scale":
            t = 1.0 + 0.02 * z
        else:
            t = 0.02 * z
        state[name] = t.contiguous()
    return state


def reference(config: dict, state: dict, **precision):
    """The plain reference on ``state``; ``precision`` may give its ``operand`` and ``gradient`` rounding."""
    return ref.Wav2Vec2(config, state, **precision)


def port_module(config: dict, state: dict, device, train: bool = False):
    """The port's ``CTCModule`` holding ``state``. Train mode computes in bf16 with the configuration's dropout
    rates, the extractor frozen (``freeze_feature_extractor`` and ``frozen_paths``)."""
    from thunder_tpu_torch.audio import Wav2Vec2Preprocess
    from thunder_tpu_torch.models import LinearDecoder, Wav2Vec2Config, Wav2Vec2Encoder
    from thunder_tpu_torch.module import CTCModel, CTCModule
    from thunder_tpu_torch.text import BatchTextTransformer

    rates = {k: config[k] if train else 0.0 for k in ("hidden_dropout", "attention_dropout", "feat_proj_dropout")}
    cfg = Wav2Vec2Config(hidden_size=config["hidden_size"], num_hidden_layers=config["num_hidden_layers"],
                         num_attention_heads=config["num_attention_heads"],
                         intermediate_size=config["intermediate_size"], conv_dim=config["conv_dim"],
                         conv_kernel=config["conv_kernel"], conv_stride=config["conv_stride"], conv_bias=False,
                         feat_extract_norm="group", do_stable_layer_norm=False,
                         num_conv_pos_embeddings=config["num_conv_pos_embeddings"],
                         num_conv_pos_embedding_groups=config["num_conv_pos_embedding_groups"],
                         layer_norm_eps=config["layer_norm_eps"], **rates)
    dtype = torch.bfloat16 if train else torch.float32  # the configuration trains in bf16, on the CPU too
    tt = BatchTextTransformer(config["vocabulary"])
    encoder = Wav2Vec2Encoder(cfg, dtype=dtype, freeze_feature_extractor=train)
    decoder = LinearDecoder(tt.num_tokens, dropout=config["final_dropout"] if train else 0.0, dtype=dtype)
    model = CTCModel(Wav2Vec2Preprocess(mask_input=True), encoder, decoder).to(device)
    module = CTCModule(model=model.eval(), text_transform=tt, device=torch.device(device)).with_state(state)
    if train:
        module.frozen_paths = [("encoder", "feature_extractor")]
    return module


def engine(module, control: bool = False):
    """The serving engine; ``control`` switches on the program's own lower-precision path (W8A8 products)."""
    from thunder_tpu_torch.engine import InferenceEngine

    return InferenceEngine(module, int8_compute=control)


def _sizes(config: dict) -> dict:
    return dict(hidden_size=config["hidden_size"], num_hidden_layers=config["num_hidden_layers"],
                intermediate_size=config["intermediate_size"], conv_dim=tuple(config["conv_dim"]),
                conv_kernel=tuple(config["conv_kernel"]), conv_stride=tuple(config["conv_stride"]),
                num_classes=len(config["vocabulary"]) + 1)


def forward_flops(config: dict, batch: int, samples: int) -> int:
    return flops.wav2vec2_forward_flops(samples, batch=batch, **_sizes(config))


def train_flops(config: dict, batch: int, samples: int) -> int:
    return flops.wav2vec2_train_flops(samples, batch=batch, frozen_extractor=True, **_sizes(config))


def trainable(config: dict, state: dict) -> list:
    """The leaves training updates: all but the frozen conv feature extractor's."""
    return [n for n in state if not n.startswith("encoder.feature_extractor.")]
