"""Keyed state: the backends behind ``KeyedStream.process`` (port of
``flink_tpu/state/__init__.py``)."""

#: the refusal of the spill backend, which a later slice of the local job
#: path brings (ROADMAP Queue A item 8.1)
SPILL_BACKEND = ("not in this slice of flink_tpu_torch: the spill keyed "
                 "state backend comes with the rest of the local job path "
                 "(ROADMAP Queue A item 8.1)")


def make_keyed_backend(config=None, max_parallelism: int = 128,
                       directory=None):
    """Construct the configured keyed state backend (``StateOptions.BACKEND``,
    as JAX's): 'hbm'/'heap'/'host' -> the heap backend, 'changelog' /
    'changelog-heap' -> the changelog wrapper over it.  'spill' and
    'changelog-spill' raise ``NotImplementedError``; other names raise
    ``ValueError``."""
    from flink_tpu_torch.config.options import StateOptions
    from flink_tpu_torch.state.heap import HeapKeyedStateBackend

    name = "hbm"
    if config is not None:
        name = (config.get(StateOptions.BACKEND) or "hbm").lower()
    if name in ("hbm", "heap", "host"):
        return HeapKeyedStateBackend(max_parallelism=max_parallelism)
    if name in ("spill", "changelog-spill"):
        raise NotImplementedError(SPILL_BACKEND)
    if name in ("changelog", "changelog-heap"):
        from flink_tpu_torch.state.changelog import ChangelogKeyedStateBackend
        return ChangelogKeyedStateBackend(
            HeapKeyedStateBackend(max_parallelism=max_parallelism))
    raise ValueError(f"unknown state.backend {name!r}; "
                     f"use hbm|spill|changelog|changelog-spill")
