"""Host-side data helpers."""

from thunder_tpu_torch.data.collate import bucket_length  # noqa: F401
