"""A percentile of every sample of the window (``spec["samples"]``, ``spec["percentile"]``), with the sample
count written to standard error first."""

import sys

import numpy as np


def read(spec, ctx):
    samples = ctx.record["window"][spec["samples"]]
    if not samples:
        return None
    print(f"asrbench: {spec['samples']}: {len(samples)} samples", file=sys.stderr)
    return float(np.percentile(np.asarray(samples, dtype=np.float64), spec["percentile"]))
