"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The kernels are built from ``thunder_tpu_torch/csrc`` on first launch (see
``_build``); importing these modules needs neither ``nvcc`` nor a GPU. The
three wrappers that a model's eval forward reaches (``fused_log_mel``,
``mha_from_qkv``, ``add_layer_norm``) are also ``torch.library`` custom ops
(``torch.ops.thunder_tpu.*``), which importing them registers: a traced call
goes through the op, so that ``torch.export`` holds each as one node
(``export.aot_export``); an eager call skips the op's dispatch, which costs
tens of microseconds of host time a call.
"""

from thunder_tpu_torch.kernels.add_ln import add_layer_norm, add_layer_norm_reference  # noqa: F401
from thunder_tpu_torch.kernels.add_ln_train import (  # noqa: F401
    add_ln_dropout_train,
    add_ln_train_backward,
    add_ln_train_forward,
    dropout_keep_mask,
)
from thunder_tpu_torch.kernels.attention_train import mha_train, mha_train_backward, mha_train_forward  # noqa: F401
from thunder_tpu_torch.kernels.beam import (  # noqa: F401
    beam_backtrace,
    beam_backtrace_reference,
    beam_scan,
    beam_scan_reference,
)
from thunder_tpu_torch.kernels.attention import mha_from_qkv, mha_from_qkv_reference  # noqa: F401
from thunder_tpu_torch.kernels.ctc import ctc_alpha, ctc_beta, ctc_ll, ctc_ll_reference  # noqa: F401
from thunder_tpu_torch.kernels.frontend import fused_log_mel, log_mel_reference  # noqa: F401
from thunder_tpu_torch.kernels.separable_conv import (  # noqa: F401
    fused_separable_repeat,
    separable_repeat_reference,
)

#: every kernel wrapper; each carries a ``launches`` count of its kernel launches
KERNEL_WRAPPERS = (fused_log_mel, fused_separable_repeat, ctc_alpha, ctc_beta, mha_from_qkv, add_layer_norm,
                   beam_scan, beam_backtrace, mha_train_forward, mha_train_backward, add_ln_train_forward,
                   add_ln_train_backward, dropout_keep_mask)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
