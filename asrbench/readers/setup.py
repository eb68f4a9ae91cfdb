"""``setup_s``: process start to the window's start, on the host clock."""


def read(spec, ctx):
    return ctx.setup_s
