"""Model zoo of the port: the QuartzNet, Citrinet and wav2vec2 encoders and the CTC decoder heads."""

from thunder_tpu_torch.models.citrinet import CitrinetEncoder  # noqa: F401
from thunder_tpu_torch.models.decoders import Conv1dDecoder, LinearDecoder  # noqa: F401
from thunder_tpu_torch.models.layers import (  # noqa: F401
    ConvBnAct,
    Dense,
    EncoderBlock,
    InitMode,
    MaskedConv1d,
    SqueezeExcite,
    TorchBatchNorm,
    weight_init,
)
from thunder_tpu_torch.models.quartznet import QuartznetEncoder  # noqa: F401
from thunder_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder  # noqa: F401
