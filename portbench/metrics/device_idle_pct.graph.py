"""The share of the traced window in which no kernel, copy or memset ran
on the device (the complement of the union of their intervals in
``torch.profiler``'s trace)."""


def read(ctx):
    return ctx.idle_pct()
