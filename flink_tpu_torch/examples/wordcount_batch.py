"""Batch WordCount over the DataSet API (flink-examples batch flagship),
the port of ``examples/wordcount_batch.py``.

    python -m flink_tpu_torch.examples.wordcount_batch [--device cpu]
"""

import argparse

import numpy as np

from flink_tpu_torch.dataset import ExecutionEnvironment

TEXT = """to be or not to be that is the question whether tis nobler in
the mind to suffer the slings and arrows of outrageous fortune""".split()


def main(device=None):
    """Print and return the five most frequent words with their counts."""
    env = ExecutionEnvironment.get_execution_environment(device=device)
    counts = (env.from_columns({"word": np.asarray(TEXT, object)})
              .group_by("word").count()
              .sort_partition("count", ascending=False))
    top = counts.first_n(5).collect()
    for row in top:
        print(f"{row['word']}: {row['count']}")
    return top


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
