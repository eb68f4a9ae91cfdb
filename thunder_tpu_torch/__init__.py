"""thunder_tpu_torch: the PyTorch + CUDA port of thunder_tpu for NVIDIA Hopper.

Mirrors the module layout of the JAX package (``thunder_tpu``), which stays
the numerical reference. Layout, names and contracts are kept:

- channels-last ``(batch, time, channels)`` activations and WIO conv weights;
- ``(tensor, lengths)`` pairs with zero-beyond-length masks;
- the hot kernels of the serving path are hand-written for ``sm_90a``
  (``thunder_tpu_torch/csrc``); each wrapper runs its plain PyTorch version
  only for tensors that live on the CPU.

Nothing here imports ``jax`` or ``thunder_tpu``. Importing the package loads
no submodule; the conveniences below resolve on first use.
"""

__version__ = "0.1.0"

_LAZY = {
    "CTCModule": "thunder_tpu_torch.module",
    "InferenceEngine": "thunder_tpu_torch.engine",
    "FilterbankFeatures": "thunder_tpu_torch.audio",
    "QuartznetEncoder": "thunder_tpu_torch.models",
    "Conv1dDecoder": "thunder_tpu_torch.models",
    "BatchTextTransformer": "thunder_tpu_torch.text",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'thunder_tpu_torch' has no attribute {name!r}")
