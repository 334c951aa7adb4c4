"""Multi-process cluster example, the port of
``examples/distributed_wordcount.py``: a keyed sum across two worker
processes with periodic checkpoints and a restart on worker loss.

    python -m flink_tpu_torch.examples.distributed_wordcount [--device cpu]

The job ships as this module's :func:`build` (the jar analog): every
worker imports it and deploys its share of the subtasks; the edges between
processes ride credit-controlled TCP channels.  The workers run on the
coordinator's device (the card unless the CPU is asked for).
"""

import argparse
import tempfile

import numpy as np

#: records, and the distinct "words" they cycle through
N_RECORDS = 100_000
N_WORDS = 1000


def build():
    from flink_tpu_torch.datastream.api import StreamExecutionEnvironment

    env = StreamExecutionEnvironment()
    env.set_parallelism(2)
    words = (np.arange(N_RECORDS) % N_WORDS).astype(np.int64)
    (env.from_collection(columns={"word": words,
                                  "one": np.ones(N_RECORDS)},
                         batch_size=1024)
        .key_by("word")
        .sum("one", output_column="count")
        .collect())
    return env.get_stream_graph("distributed-wordcount")


def main(device=None, timeout_s: float = 300.0):
    """Run :func:`build` on a 2-worker cluster; prints a summary and
    returns ``(result, final count by word)``."""
    from flink_tpu_torch.cluster.distributed import ProcessCluster
    from flink_tpu_torch.runtime.checkpoint.storage import \
        FileCheckpointStorage

    with tempfile.TemporaryDirectory(prefix="flink-tpu-ckpt-") as d:
        pc = ProcessCluster(
            "flink_tpu_torch.examples.distributed_wordcount:build",
            n_workers=2, checkpoint_storage=FileCheckpointStorage(d),
            checkpoint_interval_ms=500, restart_attempts=2, device=device)
        res = pc.run(timeout_s=timeout_s)
    final = {}
    for r in res["rows"]:
        final[r["word"]] = r["count"]
    print(f"state={res['state']} attempts={res['attempts']} "
          f"checkpoints={len(res['completed_checkpoints'])} "
          f"words={len(final)} total={sum(final.values()):.0f}")
    return res, final


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
