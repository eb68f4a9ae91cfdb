"""Inference bundles: a module's weights beside its architecture and vocabulary.

Port of ``save_inference_bundle`` / ``load_inference_bundle`` from
``thunder_tpu/export.py``. A bundle folder holds

- ``config.json``: the encoder, frontend, decoder and text settings, in the
  JAX package's schema;
- ``tokenizer.model`` when the text transform is a sentencepiece one;
- ``module.pt``: the model's ``state_dict`` (where the JAX package writes an
  Orbax checkpoint).

``load_inference_bundle`` rebuilds the whole ``CTCModule``, host-side text
decoding included, on ``device`` (the card unless the caller asks for the
CPU). ``aot_export`` / ``aot_load`` are not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from thunder_tpu_torch.audio.frontend import FilterbankFeatures, Wav2Vec2Preprocess
from thunder_tpu_torch.models.citrinet import CitrinetEncoder
from thunder_tpu_torch.models.decoders import Conv1dDecoder, LinearDecoder
from thunder_tpu_torch.models.quartznet import QuartznetEncoder
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text.tokenizer import BPETokenizer
from thunder_tpu_torch.text.transform import BatchTextTransformer
from thunder_tpu_torch.training.checkpointing import MODULE_FILE, restore_module_variables, save_module

__all__ = ["save_inference_bundle", "load_inference_bundle"]


def _encoder_config(encoder) -> dict:
    if isinstance(encoder, QuartznetEncoder):
        return {
            "family": "quartznet",
            "feat_in": encoder.feat_in,
            "filters": list(encoder.filters),
            "kernel_sizes": list(encoder.kernel_sizes),
            "repeat_blocks": encoder.repeat_blocks,
            "repeat": encoder.repeat,
            "dropout": encoder.dropout,
        }
    if isinstance(encoder, CitrinetEncoder):
        return {
            "family": "citrinet",
            "feat_in": encoder.feat_in,
            "filters": list(encoder.filters),
            "kernel_sizes": list(encoder.kernel_sizes),
            "strides": list(encoder.strides),
            "repeat": encoder.repeat,
            "dropout": encoder.dropout,
        }
    if isinstance(encoder, Wav2Vec2Encoder):
        return {
            "family": "wav2vec2",
            "mask_input": encoder.mask_input,
            "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(encoder.config).items()},
        }
    raise ValueError(f"unsupported encoder type for export: {type(encoder)}")


def _frontend_config(frontend) -> dict:
    if isinstance(frontend, FilterbankFeatures):
        return {
            "kind": "filterbank",
            "sample_rate": frontend.sample_rate,
            "n_window_size": frontend.n_window_size,
            "n_window_stride": frontend.n_window_stride,
            "n_fft": frontend.n_fft,
            "preemph": frontend.preemph,
            "nfilt": frontend.nfilt,
            "dither": frontend.dither,
        }
    if isinstance(frontend, Wav2Vec2Preprocess):
        return {"kind": "wav2vec2", "div_guard": frontend.div_guard, "mask_input": frontend.mask_input}
    raise ValueError(f"unsupported frontend type for export: {type(frontend)}")


def _decoder_config(decoder) -> Optional[dict]:
    if decoder is None:
        return None
    if isinstance(decoder, Conv1dDecoder):
        return {"kind": "conv1d", "num_classes": decoder.num_classes}
    if isinstance(decoder, LinearDecoder):
        return {"kind": "linear", "num_classes": decoder.num_classes, "dropout": decoder.dropout}
    raise ValueError(f"unsupported decoder type for export: {type(decoder)}")


def _text_config(tt: Optional[BatchTextTransformer]) -> Optional[dict]:
    if tt is None:
        return None
    v = tt.vocab
    return {
        "tokens": list(v.itos),
        "blank_token": v.blank_token,
        "pad_token": v.pad_token,
        "unknown_token": v.unknown_token,
        "start_token": v.start_token,
        "end_token": v.end_token,
        "tokenizer": "sentencepiece" if isinstance(tt.tokenizer, BPETokenizer) else "char",
    }


def save_inference_bundle(directory: str, module: CTCModule) -> str:
    """Write the weights, ``config.json`` and any ``tokenizer.model`` into ``directory``; returns it."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    config = {
        "encoder": _encoder_config(module.model.encoder),
        "frontend": _frontend_config(module.model.audio_transform),
        "decoder": _decoder_config(module.model.decoder),
        "text": _text_config(module.text_transform),
        "encoder_final_dimension": module.encoder_final_dimension,
    }
    (directory / "config.json").write_text(json.dumps(config, indent=2))
    if module.text_transform is not None and isinstance(module.text_transform.tokenizer, BPETokenizer):
        module.text_transform.tokenizer.model.save(str(directory / "tokenizer.model"))
    save_module(str(directory), module)
    return str(directory)


def load_inference_bundle(directory: str, device="cuda") -> CTCModule:
    """Rebuild a CTCModule on ``device`` from :func:`save_inference_bundle`'s folder."""
    directory = Path(directory)
    config = json.loads((directory / "config.json").read_text())

    enc_cfg = dict(config["encoder"])
    family = enc_cfg.pop("family")
    if family == "quartznet":
        encoder = QuartznetEncoder(**enc_cfg)
    elif family == "citrinet":
        encoder = CitrinetEncoder(**enc_cfg)
    elif family == "wav2vec2":
        encoder = Wav2Vec2Encoder(config=Wav2Vec2Config(**enc_cfg["config"]), mask_input=enc_cfg.get("mask_input", True))
    else:
        raise ValueError(f"unknown encoder family {family}")

    f_cfg = dict(config["frontend"])
    kind = f_cfg.pop("kind")
    frontend = FilterbankFeatures(**f_cfg) if kind == "filterbank" else Wav2Vec2Preprocess(**f_cfg)

    d_cfg = config["decoder"]
    if d_cfg is None:
        decoder = None
    elif d_cfg["kind"] == "conv1d":
        decoder = Conv1dDecoder(num_classes=d_cfg["num_classes"])
    else:
        decoder = LinearDecoder(num_classes=d_cfg["num_classes"], dropout=d_cfg.get("dropout", 0.0))

    t_cfg = config["text"]
    text_transform = None
    if t_cfg is not None:
        sp = directory / "tokenizer.model"
        text_transform = BatchTextTransformer(
            tokens=t_cfg["tokens"],
            blank_token=t_cfg["blank_token"],
            pad_token=t_cfg["pad_token"],
            unknown_token=t_cfg["unknown_token"],
            start_token=t_cfg["start_token"],
            end_token=t_cfg["end_token"],
            sentencepiece_model=str(sp) if sp.exists() else None,
        )

    module = CTCModule.create(torch.Generator().manual_seed(0), frontend, encoder, decoder, text_transform,
                              device=device)
    return restore_module_variables(str(directory / MODULE_FILE), module)
