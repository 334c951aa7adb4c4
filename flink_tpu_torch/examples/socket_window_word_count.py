"""SocketWindowWordCount, the reference's flagship example
(flink-examples/.../SocketWindowWordCount.java:69-84, baseline config #1):
socket text -> split words -> keyBy(word) -> 5 s tumbling window -> count.
The port of ``examples/socket_window_word_count.py``.

Run a text server first (e.g. ``nc -lk 9999``), then:

    python -m flink_tpu_torch run flink_tpu_torch/examples/socket_window_word_count.py
"""

import numpy as np


def main(env, host="localhost", port=9999):
    """Register the job on ``env``; returns its collect sink (the rows of
    each fired window: ``word``, ``count`` and the window's bounds)."""
    from flink_tpu_torch.windowing.assigners import \
        TumblingProcessingTimeWindows

    def split_words(cols):
        words, src = [], []
        for i, line in enumerate(np.asarray(cols["line"]).tolist()):
            for w in line.split():
                words.append(w)
                src.append(i)
        return {"word": np.asarray(words, object)}, np.asarray(src, np.int64)

    counts = (env.socket_text_stream(host, port)
              .flat_map(split_words)
              .key_by("word")
              .window(TumblingProcessingTimeWindows.of(5000))
              .count())
    counts.print()
    return counts.collect()
