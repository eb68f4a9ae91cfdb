"""Audio frontends."""

from thunder_tpu_torch.audio.frontend import FilterbankFeatures, Wav2Vec2Preprocess  # noqa: F401
