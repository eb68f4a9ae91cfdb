"""The share of the traced slice in which no kernel or copy ran on the card."""

from asrbench import trace


def read(spec, ctx):
    t = ctx.record.get("trace")
    if not t:
        return None
    lo, hi = t["bounds"]
    if hi <= lo:
        return None
    return 1.0 - trace.union([(d[1], d[2]) for d in t["device"]], lo, hi) / (hi - lo)
