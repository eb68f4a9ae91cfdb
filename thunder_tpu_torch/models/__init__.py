"""Model zoo of the port: the QuartzNet and wav2vec2 encoders and the CTC decoder heads."""

from thunder_tpu_torch.models.decoders import Conv1dDecoder, LinearDecoder  # noqa: F401
from thunder_tpu_torch.models.layers import ConvBnAct, Dense, EncoderBlock, MaskedConv1d, TorchBatchNorm  # noqa: F401
from thunder_tpu_torch.models.quartznet import QuartznetEncoder  # noqa: F401
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder  # noqa: F401
