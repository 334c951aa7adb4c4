"""The key index's host time a batch: the operator's ``probe`` phase (the
C keydict's lookup-or-insert), with ``probe_mirror`` where the host tier's
C pass does the lookup, over the window's batches."""


def read(ctx):
    return ctx.phase_ms_per(("probe", "probe_mirror"), "batches")
