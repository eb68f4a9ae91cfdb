"""A quantity of the whole window over the window's wall seconds (``spec["quantity"]`` of the window record:
unpadded audio seconds, for the rates in audio s/s)."""


def read(spec, ctx):
    window = ctx.record["window"]
    return window[spec["quantity"]] / window["seconds"] if window["seconds"] > 0 else None
