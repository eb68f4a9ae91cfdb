"""A kernel's share of its roofline over the traced slice: the least time of its function at the slice's shapes
(``spec["work"]``, ``module:function``, given the configuration and the slice's calls) over the
summed device time of the kernels whose names hold one of ``spec["patterns"]``.

Where no kernel matches, or the trace holds another number of them than the port's launch counters
(``spec["counters"]``) saw in the slice (the profiler lost records), the reader returns nothing."""

import importlib
import sys


def read(spec, ctx):
    t = ctx.record.get("trace")
    if not t:
        return None
    lo, hi = t["bounds"]
    events = [(s, e) for name, s, e in t["device"] if any(p in name for p in spec["patterns"]) and s >= lo and e <= hi]
    launched = sum(t["launches"].get(c, 0) for c in spec["counters"])
    if not events:
        print(f"asrbench: no kernel named like {spec['patterns']} in the slice", file=sys.stderr)
        return None
    if len(events) != launched:
        print(f"asrbench: {len(events)} kernel records against {launched} launches counted: records lost",
              file=sys.stderr)
        return None
    busy = sum(e - s for s, e in events) * 1e-6
    module, function = spec["work"].split(":")
    least = getattr(importlib.import_module(module), function)(ctx.config, t["calls"])
    print(f"asrbench: {len(events)} kernels, {busy:.6f} s on the card, bound {least:.6f} s", file=sys.stderr)
    return least / busy
