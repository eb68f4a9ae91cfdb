"""HuggingFace checkpoint import for the wav2vec2 model family.

Port of ``thunder_tpu/compat/hf.py``: ``load_huggingface_checkpoint(name)``
reads a torch ``AutoModelForCTC`` (hub id or local ``save_pretrained``
folder), maps its weights onto the flax paths of the JAX package's
``Wav2Vec2Encoder`` (:func:`hf_state_to_variables`) and through
:func:`~thunder_tpu_torch.bridge.from_flax_variables` into the port's,
builds the text transform from the tokenizer's vocabulary, and copies
``lm_head`` into a ``LinearDecoder``.

wav2vec2 (both norms, with the conv adapter and MMS's attention adapters),
HuBERT, UniSpeech, UniSpeechSat, WavLM, data2vec-audio and SEW load. The
weight-normed positional conv (``weight_g``/``weight_v`` or
``parametrizations.weight.original{0,1}``) is folded into a plain kernel;
data2vec-audio's positional convs are plain.

``transformers`` is imported inside :func:`load_huggingface_checkpoint`
only; nothing else of the port needs it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional
from warnings import warn

import numpy as np
import torch

from thunder_tpu_torch.audio.frontend import Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.models.decoders import LinearDecoder
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text.transform import BatchTextTransformer

__all__ = ["load_huggingface_checkpoint", "hf_state_to_variables", "tokenizer_to_transform"]


def _extra_special_tokens(tokenizer) -> list:
    """The tokenizer's post-hoc special tokens: ``additional_special_tokens``, named ``extra_special_tokens``
    from transformers 5 on."""
    if hasattr(tokenizer, "additional_special_tokens"):
        return list(tokenizer.additional_special_tokens)
    return list(tokenizer.extra_special_tokens)


def _get_special_token(tokenizer, token_name: str) -> Optional[str]:
    token = getattr(tokenizer, token_name)
    if token in _extra_special_tokens(tokenizer):
        return None
    return token


def tokenizer_to_transform(tokenizer) -> BatchTextTransformer:
    """HF CTC tokenizer -> BatchTextTransformer.

    The vocabulary is ordered by token id (the decoder's output axis), "|"
    maps to a space, and the post-hoc special tokens are dropped.
    """
    by_id = sorted(tokenizer.get_vocab().items(), key=lambda kv: kv[1])
    extras = set(_extra_special_tokens(tokenizer))
    vocab = [(" " if tok == "|" else tok) for tok, _ in by_id if tok not in extras]
    return BatchTextTransformer(
        tokens=vocab,
        blank_token=_get_special_token(tokenizer, "pad_token"),
        pad_token=_get_special_token(tokenizer, "pad_token"),
        unknown_token=_get_special_token(tokenizer, "unk_token"),
    )


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weight = g * v / ||v|| with the norm over the dims where g is size-1."""
    reduce_dims = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=reduce_dims, keepdims=True))
    return (g * v / norm).astype(np.float32)


def _conv_t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _nest(flat: Dict[tuple, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def hf_state_to_variables(state: Dict[str, np.ndarray], config: Wav2Vec2Config) -> Dict[str, Any]:
    """HF ``Wav2Vec2Model`` state dict (numpy) -> the encoder's flax params tree (nested dicts of numpy).

    Every mapping of the JAX package's: both feature-extractor norms, pre- and post-LN layers, HuBERT's
    optional feature-projection LayerNorm, SEW's extractor LayerNorm, projection and upsample,
    data2vec-audio's positional conv stack, WavLM's bias table (layer 0's) and gates, MMS's attention
    adapters and the conv adapter.
    """
    p: Dict[tuple, np.ndarray] = {}

    def dense(src: str, dst: tuple):
        p[dst + ("kernel",)] = np.ascontiguousarray(state[src + ".weight"].T)
        if src + ".bias" in state:
            p[dst + ("bias",)] = state[src + ".bias"]

    def norm(src: str, dst: tuple):
        p[dst + ("scale",)] = state[src + ".weight"]
        p[dst + ("bias",)] = state[src + ".bias"]

    def conv(src: str, dst: tuple):
        p[dst + ("kernel",)] = _conv_t(state[f"{src}.weight"])
        p[dst + ("bias",)] = state[f"{src}.bias"]

    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        p[("feature_extractor", f"conv{i}", "kernel")] = _conv_t(state[f"{base}.conv.weight"])
        if f"{base}.conv.bias" in state:
            p[("feature_extractor", f"conv{i}", "bias")] = state[f"{base}.conv.bias"]
        if config.feat_extract_norm == "group" and i == 0:
            norm(f"{base}.layer_norm", ("feature_extractor", "gn"))
        elif config.feat_extract_norm == "layer":
            norm(f"{base}.layer_norm", ("feature_extractor", f"ln{i}"))

    if config.sew_style:
        # SEW: a LayerNorm on the extractor's output, a bare projection (only when conv_dim[-1] != hidden) and
        # the upsample projection after the transformer
        norm("layer_norm", ("sew_extract_ln",))
        if "feature_projection.weight" in state:
            dense("feature_projection", ("fp_projection",))
        dense("encoder.upsample.projection", ("upsample_projection",))
    else:
        if config.feat_proj_layer_norm:
            norm("feature_projection.layer_norm", ("fp_layer_norm",))
        dense("feature_projection.projection", ("fp_projection",))

    if config.pos_conv_stack:  # data2vec-audio: plain grouped convs
        for i in range(config.num_conv_pos_embeddings):
            conv(f"encoder.pos_conv_embed.layers.{i}.conv", (f"pos_conv{i}",))
    else:
        pc = "encoder.pos_conv_embed.conv"
        if f"{pc}.weight_g" in state:
            g, v = state[f"{pc}.weight_g"], state[f"{pc}.weight_v"]
        else:
            g = state[f"{pc}.parametrizations.weight.original0"]
            v = state[f"{pc}.parametrizations.weight.original1"]
        p[("pos_conv", "kernel")] = _conv_t(_fold_weight_norm(np.asarray(g), np.asarray(v)))
        p[("pos_conv", "bias")] = state[f"{pc}.bias"]

    if config.rel_pos_buckets:  # WavLM: the table lives on layer 0; the encoder owns it
        p[("rel_attn_embed",)] = state["encoder.layers.0.attention.rel_attn_embed.weight"]

    norm("encoder.layer_norm", ("enc_layer_norm",))
    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        dst = (f"layer{i}",)
        # q/k/v concatenate into the encoder's fused qkv projection (one (h, 3h) product)
        p[dst + ("attention", "qkv_proj", "kernel")] = np.ascontiguousarray(
            np.concatenate(
                [state[f"{base}.attention.{proj}.weight"].T for proj in ("q_proj", "k_proj", "v_proj")], axis=1
            )
        )
        p[dst + ("attention", "qkv_proj", "bias")] = np.concatenate(
            [state[f"{base}.attention.{proj}.bias"] for proj in ("q_proj", "k_proj", "v_proj")]
        )
        dense(f"{base}.attention.out_proj", dst + ("attention", "out_proj"))
        if config.rel_pos_buckets:
            dense(f"{base}.attention.gru_rel_pos_linear", dst + ("attention", "gru_rel_pos_linear"))
            p[dst + ("attention", "gru_rel_pos_const")] = state[f"{base}.attention.gru_rel_pos_const"]
        norm(f"{base}.layer_norm", dst + ("layer_norm",))
        dense(f"{base}.feed_forward.intermediate_dense", dst + ("intermediate_dense",))
        dense(f"{base}.feed_forward.output_dense", dst + ("output_dense",))
        norm(f"{base}.final_layer_norm", dst + ("final_layer_norm",))
        if config.adapter_attn_dim and f"{base}.adapter_layer.norm.weight" in state:  # MMS's attention adapter
            norm(f"{base}.adapter_layer.norm", dst + ("adapter_norm",))
            dense(f"{base}.adapter_layer.linear_1", dst + ("adapter_dense1",))
            dense(f"{base}.adapter_layer.linear_2", dst + ("adapter_dense2",))

    if config.add_adapter:  # the conv adapter: the optional projection, then the strided GLU convs
        if "adapter.proj.weight" in state:
            dense("adapter.proj", ("adapter_proj",))
            norm("adapter.proj_layer_norm", ("adapter_proj_ln",))
        for i in range(config.num_adapter_layers):
            conv(f"adapter.layers.{i}.conv", (f"adapter_conv{i}",))

    return _nest(p)


def load_huggingface_checkpoint(model_name: str, device="cuda", **model_kwargs) -> CTCModule:
    """HF hub id (or local ``save_pretrained`` folder) -> a CTCModule on ``device``, ready to predict.

    The module's ``frozen_paths`` is ``[("encoder", "feature_extractor")]``:
    HF freezes the conv feature extractor of a loaded CTC model, and the
    ``Trainer`` keeps it out of the optimizer.
    """
    from transformers import AutoFeatureExtractor, AutoModelForCTC, AutoTokenizer

    model = AutoModelForCTC.from_pretrained(model_name, **model_kwargs)
    feature_extractor = AutoFeatureExtractor.from_pretrained(model_name)
    config = Wav2Vec2Config.from_hf(model.config)
    mask_input = bool(getattr(feature_extractor, "return_attention_mask", False))
    encoder = Wav2Vec2Encoder(config=config, mask_input=mask_input, freeze_feature_extractor=True)
    state = {k: v.detach().cpu().float().numpy() for k, v in model.base_model.state_dict().items()}

    text_transform = None
    decoder = None
    try:
        tokenizer = AutoTokenizer.from_pretrained(model_name)
        text_transform = tokenizer_to_transform(tokenizer)
        decoder = LinearDecoder(num_classes=text_transform.num_tokens, dropout=0.0)
    except (OSError, KeyError, TypeError, ValueError):
        # recent transformers raise TypeError/ValueError for a missing tokenizer where older ones raised OSError
        warn(UserWarning("Huggingface model is missing the tokenizer! decoder and text_transform were not initialized"))

    module = CTCModule.create(torch.Generator().manual_seed(0), Wav2Vec2Preprocess(mask_input=mask_input), encoder,
                              decoder, text_transform, device=device)
    params = {"encoder": hf_state_to_variables(state, config)}
    if decoder is not None and hasattr(model, "lm_head"):
        lm_kernel = np.ascontiguousarray(model.lm_head.weight.detach().numpy().T)
        if lm_kernel.shape[-1] != text_transform.num_tokens:
            # a head misaligned with the tokenizer's vocabulary would decode wrong ids
            raise ValueError(
                f"lm_head emits {lm_kernel.shape[-1]} classes but the tokenizer "
                f"vocabulary has {text_transform.num_tokens}; refusing to "
                "install a misaligned CTC head"
            )
        params["decoder"] = {"dense": {"kernel": lm_kernel, "bias": model.lm_head.bias.detach().numpy()}}
    loaded = from_flax_variables({"params": params})
    current = module.model.state_dict()
    encoder_keys = {k for k in current if k.startswith("encoder.")}
    if set(k for k in loaded if k.startswith("encoder.")) != encoder_keys:
        raise KeyError(f"checkpoint and encoder leaves differ: {sorted(encoder_keys ^ set(loaded))[:5]}")
    for key, value in loaded.items():
        if tuple(value.shape) != tuple(current[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != model {tuple(current[key].shape)}")
    module = module.with_state({**current, **loaded})
    module.frozen_paths = [("encoder", "feature_extractor")]
    return module
