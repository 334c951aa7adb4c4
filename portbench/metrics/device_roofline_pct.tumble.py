"""The least time the window's work needs on the card (``work/<config>
.py``'s bytes at the peak bandwidth, or its operations at the f32 peak,
whichever is longer) as a share of the time the device was busy in the
traced window (the union of its kernels', copies' and memsets' intervals
in ``torch.profiler``'s trace)."""


def read(ctx):
    return ctx.roofline_pct()
