"""The bytes and operations a keyed tumbling sum's window needs, from the
shapes and the data, whatever kernels do the work: each record's key
(8 B), value (4 B) and timestamp (8 B) read once; each distinct (key,
pane) cell a batch touches read and written once (its f32 sum); each
fired row written once (key 8 B + sum 4 B).  One add a record."""

import numpy as np

RECORD_BYTES = 8 + 4 + 8
CELL_BYTES = 4
ROW_BYTES = 8 + 4


def window_work(ctx):
    c = ctx.counters
    if not c.get("batches"):
        return None
    n_keys = int(ctx.cell.config["keys"])
    # a batch spans one pane: its distinct keys are its cells
    cells = np.array([np.count_nonzero(np.bincount(k, minlength=n_keys))
                      for k, _, _ in c["pool"]])
    records = c["batches"] * c["batch_size"]
    touched = int((cells * c["pool_visits"]).sum())
    n_bytes = (records * RECORD_BYTES + 2 * touched * CELL_BYTES
               + c["fired_rows"] * ROW_BYTES)
    return n_bytes, records
