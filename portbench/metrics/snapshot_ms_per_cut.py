"""A checkpoint's state read: the operator's ``snapshot`` phase (the
replica's cells downloaded from the card), over the window's cuts."""


def read(ctx):
    return ctx.phase_ms_per(("snapshot",), "cuts")
