"""Model export: an ahead-of-time predict graph, and inference bundles.

Port of ``thunder_tpu/export.py``.

:func:`aot_export` / :func:`aot_load`: ``torch.export`` traces the whole
predict function (the model's eval forward, then the argmax) at fixed padded
shapes into an ``ExportedProgram``, saved with ``torch.export.save``: the
weights ride inside it, and a process with no model code loads and serves it.
The port's kernels appear in its graph as the custom ops ``thunder_tpu::*``
(``kernels/frontend.py``, ``kernels/add_ln.py``, ``kernels/attention.py``), so
a loaded artifact launches the same kernels as the live module, and counts
them the same way.

:func:`save_inference_bundle` / :func:`load_inference_bundle`: the module's
weights beside its architecture and vocabulary. A bundle folder holds

- ``config.json``: the encoder, frontend, decoder and text settings, in the
  JAX package's schema;
- ``tokenizer.model`` when the text transform is a sentencepiece one;
- ``module.pt``: the model's ``state_dict`` (where the JAX package writes an
  Orbax checkpoint, ``module/``).

``load_inference_bundle`` rebuilds the whole ``CTCModule``, host-side text
decoding included, on ``device`` (the card unless the caller asks for the
CPU), from either package's bundle: a JAX-written one's Orbax checkpoint
(OCDBT of zarr arrays) is read through ``tensorstore``, imported by that
reader only, and goes through the bridge.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from thunder_tpu_torch.audio.frontend import FilterbankFeatures, Wav2Vec2Preprocess
from thunder_tpu_torch.bridge import from_flax_variables
from thunder_tpu_torch.models.citrinet import CitrinetEncoder
from thunder_tpu_torch.models.decoders import Conv1dDecoder, LinearDecoder
from thunder_tpu_torch.models.quartznet import QuartznetEncoder
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from thunder_tpu_torch.module import CTCModule
from thunder_tpu_torch.text.tokenizer import BPETokenizer
from thunder_tpu_torch.text.transform import BatchTextTransformer
from thunder_tpu_torch.training.checkpointing import (
    MODULE_FILE,
    migrate_fused_qkv,
    restore_module_variables,
    save_module,
)

__all__ = ["aot_export", "aot_load", "AotPredict", "save_inference_bundle", "load_inference_bundle"]

#: the JAX package's bundle keeps its variables in this Orbax checkpoint folder
JAX_MODULE_DIR = "module"


class _Predict(torch.nn.Module):
    """The JAX package's ``predict_fn``: the model's eval forward, then int32 argmax ids and the logits' lengths."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, out_lengths = self.model(audio, lengths)
        return logits.argmax(dim=-1).to(torch.int32), out_lengths


def aot_export(module: CTCModule, batch_size: int, num_samples: int, path: Optional[str] = None) -> bytes:
    """Serialize the full predict graph (logits + argmax) for fixed shapes: float32 audio ``(batch_size,
    num_samples)`` and int32 lengths ``(batch_size,)`` on the module's device.

    Returns the serialized bytes (also written to ``path`` if given). The artifact embeds the weights: a pure
    serving payload.
    """
    args = (torch.zeros((batch_size, num_samples), dtype=torch.float32, device=module.device),
            torch.full((batch_size,), num_samples, dtype=torch.int32, device=module.device))
    with torch.no_grad():
        program = torch.export.export(_Predict(module.model.eval()), args)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    blob = buffer.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


class AotPredict:
    """A loaded predict graph; run it with :meth:`call`. It computes under the process's float32 settings, as a
    live module does: the port's entry points run float32 in full on the card
    (:func:`thunder_tpu_torch.kernels.selftest.exact_float32`), where cuDNN's float32 convolutions would otherwise
    take TF32."""

    def __init__(self, program: "torch.export.ExportedProgram"):
        self.program = program
        self._fn = program.module()
        audio = next(n for n in program.graph.nodes if n.op == "placeholder"
                     and n.name == program.graph_signature.user_inputs[0])
        self.device = audio.meta["val"].device

    def call(self, audio, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(preds, out_lengths)`` of a batch of the exported shapes (numpy arrays or tensors, moved to the
        artifact's device)."""
        with torch.no_grad():
            return self._fn(torch.as_tensor(audio, dtype=torch.float32, device=self.device),
                            torch.as_tensor(lengths, dtype=torch.int32, device=self.device))


def aot_load(blob_or_path) -> AotPredict:
    """Deserialize an exported predict graph; run it via ``.call(audio, lengths)``."""
    import thunder_tpu_torch.kernels  # noqa: F401  (registers the thunder_tpu:: ops the graph calls)

    if isinstance(blob_or_path, (str, Path)):
        blob_or_path = Path(blob_or_path).read_bytes()
    return AotPredict(torch.export.load(io.BytesIO(bytes(blob_or_path))))


def read_orbax_variables(path) -> Dict[str, Any]:
    """The JAX package's ``save_module`` checkpoint (Orbax's ``StandardCheckpointer``: an OCDBT store of one zarr
    array a leaf, keyed by the leaf's path joined with ".") -> the variables as nested dicts of numpy arrays, with
    pre-fusion q/k/v projections fused (:func:`migrate_fused_qkv`)."""
    import tensorstore as ts

    base = {"driver": "ocdbt", "base": f"file://{Path(path).absolute()}/"}
    tree: Dict[str, Any] = {}
    for key in ts.KvStore.open(base).result().list().result():
        name = key.decode()
        if not name.endswith("/.zarray"):
            continue
        leaf = name[: -len("/.zarray")]
        array = ts.open({"driver": "zarr", "kvstore": {**base, "path": leaf + "/"}}).result().read().result()
        *parents, last = leaf.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.asarray(array)
    return migrate_fused_qkv(tree)[0]


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
    """Rebuild a CTCModule on ``device`` from :func:`save_inference_bundle`'s folder or the JAX package's (its
    Orbax ``module/`` read by :func:`read_orbax_variables`)."""
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
    if not (directory / MODULE_FILE).exists() and (directory / JAX_MODULE_DIR).is_dir():  # the JAX package's
        return module.with_state(from_flax_variables(read_orbax_variables(directory / JAX_MODULE_DIR)))
    return restore_module_variables(str(directory / MODULE_FILE), module)
