"""Host-side data: WAV reading, manifest datasets, collation and the threaded loader."""

from thunder_tpu_torch.data.audio_io import AudioFileLoader, AudioInfo, audio_info, load_audio, resample  # noqa: F401
from thunder_tpu_torch.data.collate import asr_collate, bucket_length  # noqa: F401
from thunder_tpu_torch.data.datamodule import BaseDataModule, DataLoader, ManifestDatamodule  # noqa: F401
from thunder_tpu_torch.data.dataset import BaseSpeechDataset, ManifestSpeechDataset  # noqa: F401
