"""Complex Event Processing (CEP) library (port of ``flink_tpu/cep``).

Analog of ``flink-libraries/flink-cep``: a fluent ``Pattern`` API compiled
to an NFA run over keyed streams, with vectorized condition evaluation per
batch and — for eligible patterns — batched NFA transitions advancing every
key's partial matches at once (``cep/vectorized.py``; on a CUDA device the
step runs on the card).  ``CEP`` and ``PatternStream`` build DataStreams and
come with the runtime stack slice: reaching them raises
``NotImplementedError``.
"""

from flink_tpu_torch.cep.operator import LATER_DATASTREAM, CepOperator, NFA
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern, Stage
from flink_tpu_torch.cep.vectorized import (TransitionTable, classify_pattern,
                                            compile_pattern)

__all__ = ["AfterMatchSkipStrategy", "CepOperator", "NFA", "Pattern", "Stage",
           "TransitionTable", "classify_pattern", "compile_pattern"]


def __getattr__(name: str):
    if name in ("CEP", "PatternStream"):
        raise NotImplementedError(f"{name}: {LATER_DATASTREAM}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
