"""Model FLOPs utilization of the window: the analytic FLOPs of all the work it completed (``spec["work"]``, a
function of the configuration's family: ``forward_flops`` or ``train_flops``, at each call's padded shape) over
the window's wall seconds, over the card's bf16 peak (:func:`asrbench.work.flops.peak_flops`)."""

import torch

from asrbench.work import flops


def read(spec, ctx):
    window = ctx.record["window"]
    if window["seconds"] <= 0 or not window["calls"]:
        return None
    work = getattr(ctx.family, spec["work"])
    total = sum(work(ctx.config, c["batch"], c["samples"]) for c in window["calls"])
    return total / window["seconds"] / flops.peak_flops(torch.cuda.get_device_name(0))
