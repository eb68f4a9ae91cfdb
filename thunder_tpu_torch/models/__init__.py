"""Model zoo of the port: the QuartzNet encoder and the CTC decoder head."""

from thunder_tpu_torch.models.decoders import Conv1dDecoder  # noqa: F401
from thunder_tpu_torch.models.layers import ConvBnAct, EncoderBlock, MaskedConv1d, TorchBatchNorm  # noqa: F401
from thunder_tpu_torch.models.quartznet import QuartznetEncoder  # noqa: F401
