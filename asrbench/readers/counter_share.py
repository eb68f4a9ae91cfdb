"""A program counter's share over the window: ``spec["part"]`` over the sum of ``spec["whole"]``, each the
counter's change from the window's start to its end."""


def read(spec, ctx):
    counters = ctx.record["window"].get("counters")
    if not counters:
        return None
    whole = sum(counters[k] for k in spec["whole"])
    return counters[spec["part"]] / whole if whole else None
