"""NeMo ``.nemo`` checkpoint import for QuartzNet and Citrinet.

Port of ``thunder_tpu/compat/nemo.py``:

- extract the ``.nemo`` tar (``model_config.yaml`` + ``model_weights.ckpt``
  [+ ``tokenizer.model``]);
- parse the NeMo YAML into the encoder, frontend and text transform;
- map each NeMo key to its flax path (:func:`nemo_key_map`, the JAX
  package's table) and the weights through
  :func:`~thunder_tpu_torch.bridge.from_flax_variables` into the module, so
  the conv kernels keep the flax ``(k, in, out)`` layout that the serving
  engine's plan reads.

Loading is strict, as NeMo's ``strict=True`` load is: every checkpoint tensor
lands on a model leaf of the same shape, and every model leaf is covered. The
module is built on ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from tempfile import TemporaryDirectory
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import yaml

from thunder_tpu_torch.audio.frontend import FilterbankFeatures
from thunder_tpu_torch.bridge import state_key
from thunder_tpu_torch.compat.torch_reader import load_torch_checkpoint
from thunder_tpu_torch.models.citrinet import CitrinetEncoder
from thunder_tpu_torch.models.decoders import Conv1dDecoder
from thunder_tpu_torch.models.quartznet import QuartznetEncoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text.transform import BatchTextTransformer
from thunder_tpu_torch.utils import BaseCheckpoint, download_checkpoint

__all__ = [
    "QuartznetCheckpoint",
    "CitrinetCheckpoint",
    "load_quartznet_checkpoint",
    "load_citrinet_checkpoint",
    "load_components_from_quartznet_config",
    "load_components_from_citrinet_config",
    "load_nemo_weights",
    "nemo_key_map",
    "fix_vocab",
]


# fmt: off
class QuartznetCheckpoint(BaseCheckpoint):
    """NGC-hosted QuartzNet checkpoints."""
    QuartzNet15x5Base_En = "https://api.ngc.nvidia.com/v2/models/nvidia/nemospeechmodels/versions/1.0.0a5/files/QuartzNet15x5Base-En.nemo"
    QuartzNet15x5Base_Zh = "https://api.ngc.nvidia.com/v2/models/nvidia/nemospeechmodels/versions/1.0.0a5/files/QuartzNet15x5Base-Zh.nemo"
    QuartzNet5x5LS_En = "https://api.ngc.nvidia.com/v2/models/nvidia/nemospeechmodels/versions/1.0.0a5/files/QuartzNet5x5LS-En.nemo"
    QuartzNet15x5NR_En = "https://api.ngc.nvidia.com/v2/models/nvidia/nemospeechmodels/versions/1.0.0a5/files/QuartzNet15x5NR-En.nemo"

    stt_ca_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_ca_quartznet15x5/versions/1.0.0rc1/files/stt_ca_quartznet15x5.nemo"
    stt_it_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_it_quartznet15x5/versions/1.0.0rc1/files/stt_it_quartznet15x5.nemo"
    stt_fr_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_fr_quartznet15x5/versions/1.0.0rc1/files/stt_fr_quartznet15x5.nemo"
    stt_es_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_es_quartznet15x5/versions/1.0.0rc1/files/stt_es_quartznet15x5.nemo"
    stt_de_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_de_quartznet15x5/versions/1.0.0rc1/files/stt_de_quartznet15x5.nemo"
    stt_pl_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_pl_quartznet15x5/versions/1.0.0rc1/files/stt_pl_quartznet15x5.nemo"
    stt_ru_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_ru_quartznet15x5/versions/1.0.0rc1/files/stt_ru_quartznet15x5.nemo"
    stt_en_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_en_quartznet15x5/versions/1.0.0rc1/files/stt_en_quartznet15x5.nemo"
    stt_zh_quartznet15x5 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_zh_quartznet15x5/versions/1.0.0rc1/files/stt_zh_quartznet15x5.nemo"


class CitrinetCheckpoint(BaseCheckpoint):
    """NGC-hosted Citrinet checkpoints."""
    stt_en_citrinet_256 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_en_citrinet_256/versions/1.0.0rc1/files/stt_en_citrinet_256.nemo"
    stt_en_citrinet_512 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_en_citrinet_512/versions/1.0.0rc1/files/stt_en_citrinet_512.nemo"
    stt_en_citrinet_1024 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_en_citrinet_1024/versions/1.0.0rc1/files/stt_en_citrinet_1024.nemo"
    stt_es_citrinet_512 = "https://api.ngc.nvidia.com/v2/models/nvidia/nemo/stt_es_citrinet_512/versions/1.0.0/files/stt_es_citrinet_512.nemo"
# fmt: on


def _extract_nemo(nemo_path: str, dest: str):
    with tarfile.open(nemo_path) as tar:
        tar.extractall(dest, filter="data")


def _cfg_section(conf: dict, key: str) -> dict:
    """NeMo configs nest hyperparameters under 'params' in old versions."""
    section = conf[key]
    return section.get("params", section)


def _preprocess_cfg(preprocess: dict, augment_params: Optional[dict]) -> dict:
    augment_params = dict(augment_params or {})
    augment_params.pop("dropout", None)
    return dict(
        sample_rate=preprocess["sample_rate"],
        n_window_size=int(preprocess["window_size"] * preprocess["sample_rate"]),
        n_window_stride=int(preprocess["window_stride"] * preprocess["sample_rate"]),
        n_fft=preprocess["n_fft"],
        nfilt=preprocess["features"],
        dither=preprocess["dither"],
        **augment_params,
    )


def _read_config(config_path: Union[str, Path]) -> dict:
    with open(config_path) as f:
        return yaml.safe_load(f)


def _labels(conf: dict) -> list:
    return conf["labels"] if "labels" in conf else _cfg_section(conf, "decoder")["vocabulary"]


def load_components_from_quartznet_config(
    config_path: Union[str, Path], augment_params: Optional[dict] = None
) -> Tuple[QuartznetEncoder, FilterbankFeatures, BatchTextTransformer]:
    """NeMo ``model_config.yaml`` -> (encoder, audio_transform, text_transform).

    The body blocks are ``jasper[1:-2]``; the labels come from ``labels`` or
    the decoder's vocabulary. ``augment_params`` sets the frontend's
    augmentation and, under ``"dropout"``, the encoder's dropout.
    """
    augment_params = dict(augment_params or {})
    conf = _read_config(config_path)
    jasper = _cfg_section(conf, "encoder")["jasper"]
    body = jasper[1:-2]
    dropout = augment_params.pop("dropout", 0.0)
    preprocess = _preprocess_cfg(_cfg_section(conf, "preprocessor"), augment_params)
    # NeMo configs list every body block explicitly (15x5 = 15 entries), which
    # is the same architecture as repeat_blocks=1 over the full list.
    encoder = QuartznetEncoder(
        feat_in=preprocess["nfilt"],
        filters=tuple(b["filters"] for b in body),
        kernel_sizes=tuple(b["kernel"][0] for b in body),
        repeat_blocks=1,
        repeat=jasper[1]["repeat"] if body else 5,
        dropout=dropout,
    )
    return encoder, FilterbankFeatures(**preprocess), BatchTextTransformer(tokens=list(_labels(conf)))


def load_components_from_citrinet_config(
    config_path: Union[str, Path],
    sentencepiece_path: Union[str, Path],
    augment_params: Optional[dict] = None,
) -> Tuple[CitrinetEncoder, FilterbankFeatures, BatchTextTransformer]:
    """NeMo Citrinet ``model_config.yaml`` -> components; the body blocks are
    ``jasper[1:-1]`` and carry their strides."""
    augment_params = dict(augment_params or {})
    conf = _read_config(config_path)
    body = _cfg_section(conf, "encoder")["jasper"][1:-1]
    dropout = augment_params.pop("dropout", 0.0)
    preprocess = _preprocess_cfg(_cfg_section(conf, "preprocessor"), augment_params)
    encoder = CitrinetEncoder(
        filters=tuple(b["filters"] for b in body),
        kernel_sizes=tuple(b["kernel"][0] for b in body),
        strides=tuple(b["stride"][0] for b in body),
        feat_in=preprocess["nfilt"],
        repeat=body[0]["repeat"] if body else 5,
        dropout=dropout,
    )
    text_transform = BatchTextTransformer(
        tokens=fix_vocab(list(_labels(conf))), sentencepiece_model=str(sentencepiece_path)
    )
    return encoder, FilterbankFeatures(**preprocess), text_transform


def fix_vocab(vocab_tokens):
    """NeMo wordpiece-style labels back to sentencepiece style:
    ``##x`` -> ``x``, else prefixed with ``▁``."""
    return [token[2:] if token.startswith("##") else "▁" + token for token in vocab_tokens]


# ---------------------------------------------------------------------------
# weight remapping
# ---------------------------------------------------------------------------


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    # torch conv (out, in/groups, k) -> flax (k, in/groups, out)
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


_BN_TARGET = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def nemo_key_map(key: str, separable_blocks: Dict[int, bool]):
    """Map one NeMo state-dict key to (collection, flax path tuple, transform).

    NeMo layout (torch ModuleList indices; act/drop layers hold no params):

    ==========================================  =============================
    NeMo key                                    flax path
    ==========================================  =============================
    encoder.encoder.B.mconv.I.conv.weight       encoder/blockB/repR/{depthwise|pointwise|conv→conv}/conv/kernel
    encoder.encoder.B.mconv.I.{weight,bias}     encoder/blockB/repR/bn/{scale,bias}
    encoder.encoder.B.mconv.I.running_{mean,var} batch_stats .../bn/{mean,var}
    encoder.encoder.B.mconv.I.fc.{0,2}.weight   encoder/blockB/se/fc{1,2}/kernel
    encoder.encoder.B.res.0.0.conv.weight       encoder/blockB/res/conv/conv/kernel
    encoder.encoder.B.res.0.1.*                 encoder/blockB/res/bn/*
    decoder.decoder_layers.0.{weight,bias}      decoder/conv/{kernel,bias}
    ==========================================  =============================

    where I groups into repeats of 5 (separable: dw, pw, bn, act, drop) or 4
    (dense: conv, bn, act, drop). ``num_batches_tracked`` maps to ``(None, None, None)``.
    """
    parts = key.split(".")
    if parts[0] == "decoder":
        if parts[-1] == "weight":
            return "params", ("decoder", "conv", "kernel"), _conv_to_flax
        return "params", ("decoder", "conv", "bias"), None

    if parts[0] == "encoder":
        block = int(parts[2])
        rest = parts[3:]
        prefix = ("encoder", f"block{block}")
        separable = separable_blocks.get(block, True)
        group = 5 if separable else 4
        leaf = rest[-1]
        if leaf == "num_batches_tracked":
            return None, None, None

        if rest[0] == "mconv":
            idx = int(rest[1])
            if rest[2] == "fc":  # squeeze-excite: mconv.I.fc.{0|2}.weight
                fc = "fc1" if rest[3] == "0" else "fc2"
                return "params", prefix + ("se", fc, "kernel"), lambda w: np.ascontiguousarray(w.T)
            rep = f"rep{idx // group}"
            if rest[2] == "conv":  # masked conv layer
                sub = ("depthwise" if idx % group == 0 else "pointwise") if separable else "conv"
                return "params", prefix + (rep, sub, "conv", "kernel"), _conv_to_flax
            collection, name = _BN_TARGET[leaf]
            return collection, prefix + (rep, "bn", name), None

        if rest[0] == "res":  # res.0.{0|1}.<...>
            if rest[2] == "0":
                return "params", prefix + ("res", "conv", "conv", "kernel"), _conv_to_flax
            collection, name = _BN_TARGET[leaf]
            return collection, prefix + ("res", "bn", name), None

    raise KeyError(f"unrecognized NeMo checkpoint key: {key}")


def load_nemo_weights(model_state: Dict[str, torch.Tensor], weights: Dict[str, np.ndarray],
                      separable_blocks: Dict[int, bool]) -> Dict[str, torch.Tensor]:
    """A NeMo state dict -> the model's ``state_dict``, by way of the flax paths.

    Strict: every checkpoint tensor must land on an existing model leaf with a
    matching shape, and every leaf of ``model_state`` must be covered.
    """
    state: Dict[str, torch.Tensor] = {}
    for key, value in weights.items():
        collection, path, transform = nemo_key_map(key, separable_blocks)
        if collection is None:
            continue
        value = np.asarray(value, dtype=np.float32)
        if transform is not None:
            value = transform(value)
        target = state_key(collection, path)
        if target not in model_state:
            raise KeyError(f"{key} -> {collection}/{'/'.join(path)} not present in model tree")
        expected = tuple(model_state[target].shape)
        if tuple(value.shape) != expected:
            raise ValueError(f"{key}: shape {value.shape} != model {expected}")
        state[target] = torch.from_numpy(np.array(value, dtype=np.float32))
    missing = [k for k in model_state if k not in state]
    if missing:
        raise KeyError(f"model leaves not covered by checkpoint: {missing[:5]} (+{max(0, len(missing) - 5)} more)")
    return state


def _block_layout(encoder) -> Dict[int, bool]:
    """Separable or not, by block index, as the encoders build their blocks."""
    if isinstance(encoder, QuartznetEncoder):
        blocks = 1 + len(encoder.filters) * encoder.repeat_blocks + 2
        return {b: b != blocks - 1 for b in range(blocks)}  # the final 1x1 block is dense
    return {b: True for b in range(1 + len(encoder.filters) + 1)}


def _load_nemo_module(checkpoint, components_fn, save_folder=None, augment_params=None, needs_tokenizer=False,
                      device="cuda") -> CTCModule:
    if isinstance(checkpoint, BaseCheckpoint):
        nemo_filepath = download_checkpoint(checkpoint, save_folder)
    else:
        nemo_filepath = Path(checkpoint)

    with TemporaryDirectory() as extract_folder:
        _extract_nemo(str(nemo_filepath), extract_folder)
        extract_path = Path(extract_folder)
        config_path = extract_path / "model_config.yaml"
        if needs_tokenizer:
            sp_path = extract_path / "tokenizer.model"
            sp_candidates = list(extract_path.glob("*.model"))
            if not sp_path.exists() and sp_candidates:
                sp_path = sp_candidates[0]
            encoder, audio_transform, text_transform = components_fn(config_path, sp_path, augment_params)
        else:
            encoder, audio_transform, text_transform = components_fn(config_path, augment_params)
        weights = load_torch_checkpoint(str(extract_path / "model_weights.ckpt"))

    module = CTCModule.create(torch.Generator().manual_seed(0), audio_transform, encoder,
                              Conv1dDecoder(num_classes=text_transform.num_tokens), text_transform, device=device)
    return module.with_state(load_nemo_weights(module.model.state_dict(), weights, _block_layout(encoder)))


def load_quartznet_checkpoint(checkpoint: Union[str, QuartznetCheckpoint], save_folder=None, augment_params=None,
                              device="cuda") -> CTCModule:
    """Local ``.nemo`` path or checkpoint enum -> a CTCModule on ``device``, ready to predict."""
    return _load_nemo_module(checkpoint, load_components_from_quartznet_config, save_folder=save_folder,
                             augment_params=augment_params, device=device)


def load_citrinet_checkpoint(checkpoint: Union[str, CitrinetCheckpoint], save_folder=None, augment_params=None,
                             device="cuda") -> CTCModule:
    """Local ``.nemo`` path or checkpoint enum -> a CTCModule on ``device``, ready to predict."""
    return _load_nemo_module(checkpoint, load_components_from_citrinet_config, save_folder=save_folder,
                             augment_params=augment_params, needs_tokenizer=True, device=device)
