"""The fold's dispatch a batch: the operator's ``device_dispatch`` phase
(staging, the upload and the ``scatter_fold`` launches under the
watchdog's guard, host wall), over the window's batches."""


def read(ctx):
    return ctx.phase_ms_per(("device_dispatch",), "batches")
