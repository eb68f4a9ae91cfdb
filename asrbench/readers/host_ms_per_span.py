"""The host's own time in each of the benchmark's spans of the traced slice (``spec["span"]``): the span's length
less the time the card was busy inside it (the union of kernels and copies), the mean over the spans, in ms."""

from asrbench import trace


def read(spec, ctx):
    t = ctx.record.get("trace")
    if not t:
        return None
    device = [(d[1], d[2]) for d in t["device"]]
    own = [(e - s) - trace.union(device, s, e) for name, s, e in t["spans"] if name == trace.SPAN_PREFIX + spec["span"]]
    return sum(own) / len(own) * 1e-3 if own else None
