"""thunder_tpu_torch: the PyTorch + CUDA port of thunder_tpu for NVIDIA Hopper.

Mirrors the module layout of the JAX package (``thunder_tpu``), which stays
the numerical reference. Layout, names and contracts are kept:

- channels-last ``(batch, time, channels)`` activations and WIO conv weights;
- ``(tensor, lengths)`` pairs with zero-beyond-length masks;
- the hot kernels of the serving and training paths are hand-written for ``sm_90a``
  (``thunder_tpu_torch/csrc``); each wrapper runs its plain PyTorch version
  only for tensors that live on the CPU.

Nothing here imports ``jax`` or ``thunder_tpu``. Importing the package loads
no submodule; the conveniences below resolve on first use.
"""

__version__ = "0.1.0"

_LAZY = {
    "CTCModule": "thunder_tpu_torch.module",
    "InferenceEngine": "thunder_tpu_torch.engine",
    "StreamingTranscriber": "thunder_tpu_torch.streaming",
    "StreamingPool": "thunder_tpu_torch.streaming",
    "FilterbankFeatures": "thunder_tpu_torch.audio",
    "Wav2Vec2Preprocess": "thunder_tpu_torch.audio",
    "QuartznetEncoder": "thunder_tpu_torch.models",
    "CitrinetEncoder": "thunder_tpu_torch.models",
    "Wav2Vec2Encoder": "thunder_tpu_torch.models",
    "Wav2Vec2Config": "thunder_tpu_torch.models",
    "Conv1dDecoder": "thunder_tpu_torch.models",
    "LinearDecoder": "thunder_tpu_torch.models",
    "BatchTextTransformer": "thunder_tpu_torch.text",
    "Trainer": "thunder_tpu_torch.training.trainer",
    "load_pretrained": "thunder_tpu_torch.registry",
    "register_checkpoint_enum": "thunder_tpu_torch.registry",
    "finetune_ctc_module": "thunder_tpu_torch.finetune",
    "save_inference_bundle": "thunder_tpu_torch.export",
    "load_inference_bundle": "thunder_tpu_torch.export",
    "NGramLM": "thunder_tpu_torch.text.lm",
    "ArpaLM": "thunder_tpu_torch.text.lm",
    "WordFusionLM": "thunder_tpu_torch.text.word_fusion",
    "WordNGramLM": "thunder_tpu_torch.text.word_fusion",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'thunder_tpu_torch' has no attribute {name!r}")
