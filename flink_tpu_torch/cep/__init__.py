"""Complex Event Processing (CEP) library (port of ``flink_tpu/cep``).

Analog of ``flink-libraries/flink-cep``: a fluent ``Pattern`` API compiled
to an NFA run over keyed streams, with vectorized condition evaluation per
batch and — for eligible patterns — batched NFA transitions advancing every
key's partial matches at once (``cep/vectorized.py``; on a CUDA device the
step runs on the card).  ``CEP.pattern(keyed_stream, pattern).select(fn)``
is the DataStream entry.
"""

from flink_tpu_torch.cep.operator import CEP, CepOperator, NFA, PatternStream
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern, Stage
from flink_tpu_torch.cep.vectorized import (TransitionTable, classify_pattern,
                                            compile_pattern)

__all__ = ["AfterMatchSkipStrategy", "CEP", "CepOperator", "NFA", "Pattern",
           "PatternStream", "Stage", "TransitionTable", "classify_pattern",
           "compile_pattern"]
