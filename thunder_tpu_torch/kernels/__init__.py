"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The kernels are built from ``thunder_tpu_torch/csrc`` on first launch (see
``_build``); importing these modules needs neither ``nvcc`` nor a GPU.
"""

from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference  # noqa: F401
from thunder_tpu_torch.kernels.separable_conv import (  # noqa: F401
    fused_separable_repeat,
    separable_repeat_reference,
)

#: every kernel wrapper; each carries a ``launches`` count of its kernel launches
KERNEL_WRAPPERS = (fused_log_mel, fused_separable_repeat)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
