"""Audio frontends."""

from thunder_tpu_torch.audio.frontend import FilterbankFeatures  # noqa: F401
