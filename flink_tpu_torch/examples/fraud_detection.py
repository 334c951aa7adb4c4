"""Fraud detection walkthrough (flink-walkthroughs analog), the port of
``examples/fraud_detection.py``: the pattern and the CEP topology are the
port's fraud-detection scenario's (``flink_tpu_torch.scenarios.
fraud_detection``), so the example and the scenario cannot diverge.

    python -m flink_tpu_torch run flink_tpu_torch/examples/fraud_detection.py

A SMALL "bait" transaction immediately followed by a LARGE "strike" on
the same account raises an alert; alerts print and collect.
"""

import numpy as np

#: the accounts with a planted bait -> strike pair, and the pair's position
PLANTED = ((7, 100), (21, 2000), (33, 7777))


def transactions():
    """The walkthrough's 10,000 seeded transactions over 50 accounts, with
    a bait -> strike pair planted for each account of :data:`PLANTED`."""
    from flink_tpu_torch.scenarios.fraud_detection import (LARGE_MIN,
                                                           SMALL_MAX)

    rng = np.random.default_rng(7)
    n = 10_000
    accounts = rng.integers(0, 50, n).astype(np.int64)
    # legitimate traffic sits strictly between the thresholds
    amounts = SMALL_MAX + rng.random(n) * (LARGE_MIN - SMALL_MAX)
    ts = np.arange(n, dtype=np.int64)
    for acct, pos in PLANTED:
        accounts[pos] = accounts[pos + 1] = acct
        amounts[pos] = 0.5          # bait
        amounts[pos + 1] = 900.0    # strike
    return {"account": accounts, "amount": amounts, "t": ts}


def main(env):
    """Register the job on ``env``; returns the alerts' collect sink."""
    from flink_tpu_torch.scenarios.fraud_detection import detect_frauds

    tx = (env.from_collection(columns=transactions(), batch_size=1024)
          .assign_timestamps_and_watermarks(0, timestamp_column="t")
          .key_by("account"))
    # the scenario's CEP stage: Pattern(small -> large within 4 windows)
    alerts = detect_frauds(tx, window_ms=1000, amount_column="amount")
    alerts.print(prefix="ALERT")
    return alerts.collect()
