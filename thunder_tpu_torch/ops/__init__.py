"""Tensor ops of the port: masking, conv arithmetic, spectral features, SpecAugment, CTC loss, decode and forced alignment."""

from thunder_tpu_torch.ops.conv import conv1d, conv_output_length, get_same_padding  # noqa: F401
from thunder_tpu_torch.ops.ctc import (  # noqa: F401
    alignment_segments,
    calculate_ctc,
    collapse_ctc,
    ctc_forced_align,
    ctc_forward_scores,
    ctc_loss,
    greedy_decode,
)
from thunder_tpu_torch.ops.masking import (  # noqa: F401
    apply_mask,
    lengths_to_mask,
    masked_feature_normalize,
    masked_mean_std,
    normalize_tensor,
)
from thunder_tpu_torch.ops.specaugment import spec_augment, spec_cutout  # noqa: F401
from thunder_tpu_torch.ops.stft import (  # noqa: F401
    convolution_stft,
    mel_features,
    power_spectrum,
    power_spectrum_lengths,
    preemphasis,
)
