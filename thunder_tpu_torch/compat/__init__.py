"""Checkpoint compatibility: NeMo (``.nemo``) and HuggingFace importers."""

from thunder_tpu_torch.compat.nemo import (  # noqa: F401
    CitrinetCheckpoint,
    QuartznetCheckpoint,
    fix_vocab,
    load_citrinet_checkpoint,
    load_quartznet_checkpoint,
)
from thunder_tpu_torch.compat.torch_reader import load_torch_checkpoint  # noqa: F401
