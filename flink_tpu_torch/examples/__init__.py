"""The port's user programs, one for each of ``examples/``: batch
WordCount over the DataSet API, the socket window word count, the fraud
detection walkthrough and the multi-process keyed sum.  Each imports only
``flink_tpu_torch`` and runs on the card unless the CPU is asked for::

    python -m flink_tpu_torch.examples.wordcount_batch [--device cpu]
    python -m flink_tpu_torch run flink_tpu_torch/examples/socket_window_word_count.py
    python -m flink_tpu_torch run flink_tpu_torch/examples/fraud_detection.py
    python -m flink_tpu_torch.examples.distributed_wordcount [--device cpu]
"""
