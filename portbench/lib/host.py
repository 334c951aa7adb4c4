"""What the host did over a run's window, kept beside the run's numbers so
that a spread between runs can be traced to the host: the process's CPU
seconds, the machine's busy and steal seconds (``/proc/stat``), the mean
clock its cores report (``/proc/cpuinfo``), and, after the window, the
time of a fixed random gather in host memory, a reading of how fast the
host serves this process at that moment.  Nothing here is a metric."""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

#: the gather's table (int32 entries) and reads
GATHER_TABLE = 1 << 25
GATHER_READS = 1 << 22


def _stat() -> Optional[list]:
    """The machine's CPU ticks: user, nice, system, idle, iowait, irq,
    softirq, steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def _mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def gather_ms() -> float:
    """The least of three timings of the same random gather from a 128 MiB
    table, in milliseconds."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, GATHER_TABLE, dtype=np.int32)
    idx = rng.integers(0, GATHER_TABLE, GATHER_READS)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        table[idx].sum()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


class HostClock:
    """``begin()`` and ``end()`` around the window; ``reading()`` after."""

    def begin(self) -> None:
        self._times, self._stat, self._mhz = os.times(), _stat(), _mhz()

    def end(self) -> None:
        self._times1, self._stat1, self._mhz1 = os.times(), _stat(), _mhz()

    def reading(self) -> dict:
        a, b = self._times, self._times1
        out = {"cpu_s": (b.user + b.system) - (a.user + a.system),
               "cores": os.cpu_count()}
        if self._stat is not None and self._stat1 is not None:
            hz = os.sysconf("SC_CLK_TCK")
            d = [y - x for x, y in zip(self._stat, self._stat1)]
            out["machine_busy_s"] = (sum(d) - d[3] - d[4]) / hz
            out["steal_s"] = d[7] / hz if len(d) > 7 else None
        if self._mhz is not None and self._mhz1 is not None:
            out["mhz"] = (self._mhz + self._mhz1) / 2
        out["gather_ms"] = gather_ms()
        return out
