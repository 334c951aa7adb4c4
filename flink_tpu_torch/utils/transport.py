"""Transport calibration: the measured cost of keeping a device replica in
sync (port of ``flink_tpu/utils/transport.py``).

The window operator's host emit tier can keep its device replica current
batch by batch (``device_sync="scatter"``) or refresh it from the host
mirror at sync points (``"deferred"``).  Which one is cheaper depends on
what a dispatched update step costs the host per uploaded MB: near nothing
on a card behind a direct link, tens of ms per MB on a taxed transport
(a tunneled device, or a slow host where the fold itself is the cost).

The verdict is self-measured: under ``device_sync="auto"`` the operator
times its own first few real update steps, upload, launches and wait until
the card is done, and feeds them to :func:`record_dispatch_cost`; this
module keeps the verdict process-wide (the link does not change under a
running process, so later operators skip the measurement).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

#: dispatch cost above this marks the link taxed (ms per uploaded MB)
DISPATCH_TAXED_ABOVE_MS_PER_MB = 6.0

#: samples needed before a verdict; the MIN per-MB cost is used, so the
#: first sample's build time and queue-drain noise cannot tip the scale
MIN_SAMPLES = 3

#: samples below this upload size are discarded: a healthy link's FIXED
#: launch latency divided by a sub-MB payload would read as a huge per-MB
#: cost and freeze a false "taxed" verdict process-wide.  Tiny-batch
#: workloads therefore never calibrate and keep per-batch scatter
MIN_SAMPLE_MB = 0.5

_samples: List[Tuple[float, float]] = []  # (mb, seconds)
_verdict: Optional[bool] = None


def record_dispatch_cost(mb: float, seconds: float) -> None:
    """Feed one measured (uploaded MB, until-ready seconds) sample of a real
    update step.  Sub-``MIN_SAMPLE_MB`` samples are ignored."""
    global _verdict
    if mb < MIN_SAMPLE_MB:
        return
    _samples.append((mb, seconds))
    if _verdict is None and len(_samples) >= MIN_SAMPLES:
        best = min(s / m for m, s in _samples)
        _verdict = best * 1e3 > DISPATCH_TAXED_ABOVE_MS_PER_MB


def dispatch_taxed() -> Optional[bool]:
    """True/False once calibrated; None while samples are still needed."""
    return _verdict


def dispatch_ms_per_mb() -> Optional[float]:
    """Best measured dispatch cost in ms per uploaded MB (None = unmeasured)."""
    if not _samples:
        return None
    return min(s / m for m, s in _samples) * 1e3


def reset(verdict: Optional[bool] = None) -> None:
    """Clear the calibration (tests, the chip smoke), optionally pinning a
    verdict."""
    global _samples, _verdict
    _samples = []
    _verdict = verdict
