"""The 95th percentile, nearest rank, over every fire of the window: the
host wall time of the ``process_watermark`` call that closes a window,
from its start to that window's rows on the host, handed to the sink."""

from portbench.lib import stats


def read(ctx):
    fires = ctx.counters.get("fire_ms")
    return stats.percentile(fires, 95) if fires else None
