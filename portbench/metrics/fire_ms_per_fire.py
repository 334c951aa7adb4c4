"""The operator's fire path a fire: its ``fire`` phase (the gather on the
card, the download, the rows' keys on the host), over the window's
fires."""


def read(ctx):
    return ctx.phase_ms_per(("fire",), "fires")
