"""Keyed state: the backends behind ``KeyedStream.process`` (port of
``flink_tpu/state/__init__.py``)."""


def make_keyed_backend(config=None, max_parallelism: int = 128,
                       directory=None):
    """Construct the configured keyed state backend (``StateOptions.BACKEND``,
    as JAX's): 'hbm'/'heap'/'host' -> the heap backend, 'spill' -> the C
    spill tier (``state/spill.py``), 'changelog'/'changelog-heap' and
    'changelog-spill' -> the changelog wrapper over the heap or the spill
    backend.  Other names raise ``ValueError``."""
    from flink_tpu_torch.config.options import StateOptions
    from flink_tpu_torch.state.heap import HeapKeyedStateBackend

    name = "hbm"
    if config is not None:
        name = (config.get(StateOptions.BACKEND) or "hbm").lower()
    if name in ("hbm", "heap", "host"):
        return HeapKeyedStateBackend(max_parallelism=max_parallelism)
    if name == "spill":
        from flink_tpu_torch.state.spill import SpillKeyedStateBackend
        return SpillKeyedStateBackend(directory,
                                      max_parallelism=max_parallelism)
    if name in ("changelog", "changelog-heap"):
        from flink_tpu_torch.state.changelog import ChangelogKeyedStateBackend
        return ChangelogKeyedStateBackend(
            HeapKeyedStateBackend(max_parallelism=max_parallelism))
    if name == "changelog-spill":
        from flink_tpu_torch.state.changelog import ChangelogKeyedStateBackend
        from flink_tpu_torch.state.spill import SpillKeyedStateBackend
        return ChangelogKeyedStateBackend(
            SpillKeyedStateBackend(directory,
                                   max_parallelism=max_parallelism))
    raise ValueError(f"unknown state.backend {name!r}; "
                     f"use hbm|spill|changelog|changelog-spill")
