"""Test infrastructure: operator harness + chaos/fault injection (port of
``flink_tpu/testing/__init__.py``).

Lazy exports (PEP 562): runtime modules import
``flink_tpu_torch.testing.chaos`` for fault points, and that must not drag
the operator harness (and its operator/core imports) into every runtime
import.
"""

from typing import TYPE_CHECKING

__all__ = ["KeyedOneInputOperatorHarness", "TestProcessingTimeService",
           "chaos"]

if TYPE_CHECKING:  # pragma: no cover
    from flink_tpu_torch.testing.harness import (
        KeyedOneInputOperatorHarness, TestProcessingTimeService)


def __getattr__(name):
    import importlib
    if name in ("KeyedOneInputOperatorHarness", "TestProcessingTimeService"):
        harness = importlib.import_module("flink_tpu_torch.testing.harness")
        return getattr(harness, name)
    if name == "chaos":
        return importlib.import_module("flink_tpu_torch.testing.chaos")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
