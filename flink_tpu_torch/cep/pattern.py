"""CEP Pattern API (copy of ``flink_tpu/cep/pattern.py``, pure Python).

Analog of ``flink-libraries/flink-cep``'s fluent pattern builder
(``cep/pattern/Pattern.java``): a pattern is a sequence of *stages*, each
with a vectorized predicate (``SimpleCondition`` analog — here a columnar
closure over the batch, so condition evaluation is one vector op per stage
per batch), a contiguity mode (``next`` = strict, ``followedBy`` = relaxed,
``PatternStream`` semantics), a quantifier (``times``/``oneOrMore``/
``optional``, ``Quantifier.java``), and an optional ``within`` window.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, List, Mapping, Optional

import numpy as np

#: predicate over the batch's columns dict -> bool mask [B]
Condition = Callable[[Mapping[str, Any]], np.ndarray]


class AfterMatchSkipStrategy:
    """What happens to partial matches after a match emits
    (``AfterMatchSkipStrategy.java``)."""

    NO_SKIP = "no_skip"
    SKIP_PAST_LAST_EVENT = "skip_past_last_event"


@dataclass(frozen=True)
class Stage:
    """One pattern element (``Pattern`` node + its ``Quantifier``)."""

    name: str
    condition: Optional[Condition] = None
    #: 'strict' (next), 'relaxed' (followedBy)
    contiguity: str = "relaxed"
    times_min: int = 1
    times_max: Optional[int] = 1   # None = unbounded (oneOrMore)
    optional: bool = False
    #: not-pattern (``notNext``/``notFollowedBy``): the condition must NOT
    #: match — strict checks exactly the next event, relaxed forbids any
    #: matching event before the following stage matches
    negated: bool = False
    #: greedy looping stage: when an event matches both the loop and the
    #: following stage, the loop consumes it (``Quantifier.greedy``)
    greedy: bool = False
    #: loop stop condition (``oneOrMore().until(cond)``): a matching event
    #: closes the loop without being taken into it
    until: Optional[Condition] = None

    def matches(self, cols: Mapping[str, Any]) -> np.ndarray:
        n = int(np.shape(next(iter(cols.values())))[0]) if cols else 0
        if self.condition is None:
            return np.ones(n, bool)
        return np.asarray(self.condition(cols), bool)

    def until_matches(self, cols: Mapping[str, Any]) -> np.ndarray:
        n = int(np.shape(next(iter(cols.values())))[0]) if cols else 0
        if self.until is None:
            return np.zeros(n, bool)
        return np.asarray(self.until(cols), bool)


class Pattern:
    """Fluent pattern builder: ``Pattern.begin("a").where(...).followed_by("b")...``"""

    def __init__(self, stages: List[Stage], within_ms: Optional[int] = None,
                 skip_strategy: str = AfterMatchSkipStrategy.NO_SKIP):
        self.stages = stages
        self.within_ms = within_ms
        self.skip_strategy = skip_strategy

    # -- construction --------------------------------------------------------
    @staticmethod
    def begin(name: str,
              skip_strategy: str = AfterMatchSkipStrategy.NO_SKIP) -> "Pattern":
        return Pattern([Stage(name, contiguity="relaxed")],
                       skip_strategy=skip_strategy)

    def _mod_last(self, **kw) -> "Pattern":
        stages = self.stages[:-1] + [replace(self.stages[-1], **kw)]
        return Pattern(stages, self.within_ms, self.skip_strategy)

    def where(self, condition: Condition) -> "Pattern":
        last = self.stages[-1]
        if last.condition is None:
            return self._mod_last(condition=condition)
        prev = last.condition  # AND with existing (Pattern.where chaining)
        return self._mod_last(condition=lambda cols: np.asarray(
            prev(cols), bool) & np.asarray(condition(cols), bool))

    def or_where(self, condition: Condition) -> "Pattern":
        last = self.stages[-1]
        if last.condition is None:
            return self._mod_last(condition=condition)
        prev = last.condition
        return self._mod_last(condition=lambda cols: np.asarray(
            prev(cols), bool) | np.asarray(condition(cols), bool))

    def next(self, name: str) -> "Pattern":
        """Strict contiguity: the very next event must match."""
        return Pattern(self.stages + [Stage(name, contiguity="strict")],
                       self.within_ms, self.skip_strategy)

    def followed_by(self, name: str) -> "Pattern":
        """Relaxed contiguity: non-matching events in between are skipped."""
        return Pattern(self.stages + [Stage(name, contiguity="relaxed")],
                       self.within_ms, self.skip_strategy)

    def followed_by_any(self, name: str) -> "Pattern":
        """Non-deterministic relaxed contiguity (``followedByAny``): matching
        events may also be skipped, yielding every combination."""
        return Pattern(self.stages + [Stage(name, contiguity="relaxed_any")],
                       self.within_ms, self.skip_strategy)

    def not_next(self, name: str) -> "Pattern":
        """``notNext``: the event IMMEDIATELY after the previous stage's
        match must not satisfy the condition (``NFA.java`` StateType.Stop
        via strict negation)."""
        if len(self.stages) == 0:
            raise ValueError("a pattern cannot begin with a not-stage")
        return Pattern(self.stages + [Stage(name, contiguity="strict",
                                            negated=True)],
                       self.within_ms, self.skip_strategy)

    def not_followed_by(self, name: str) -> "Pattern":
        """``notFollowedBy``: NO event matching the condition may occur
        between the previous stage's match and the following stage's match.
        As in the reference, it cannot END a pattern unless ``within`` is
        set (checked at operator build)."""
        if len(self.stages) == 0:
            raise ValueError("a pattern cannot begin with a not-stage")
        return Pattern(self.stages + [Stage(name, contiguity="relaxed",
                                            negated=True)],
                       self.within_ms, self.skip_strategy)

    def times(self, n: int, n_max: Optional[int] = None) -> "Pattern":
        if self.stages[-1].negated:
            raise ValueError("a not-stage cannot be quantified")
        return self._mod_last(times_min=n,
                              times_max=n_max if n_max is not None else n)

    def one_or_more(self) -> "Pattern":
        if self.stages[-1].negated:
            raise ValueError("a not-stage cannot be quantified")
        return self._mod_last(times_min=1, times_max=None)

    def greedy(self) -> "Pattern":
        """Looping quantifier consumes preferentially: an event matching
        both the loop and the next stage extends the loop
        (``Quantifier.greedy``)."""
        last = self.stages[-1]
        if last.times_max == 1 and last.times_min == 1:
            raise ValueError("greedy() applies to a looping stage "
                             "(times/one_or_more)")
        return self._mod_last(greedy=True)

    def until(self, condition: Condition) -> "Pattern":
        """Stop condition for ``one_or_more`` loops (``Pattern.until``):
        a matching event closes the loop and is not taken into it."""
        last = self.stages[-1]
        if last.times_max is not None:
            raise ValueError("until() applies to an unbounded loop "
                             "(one_or_more)")
        return self._mod_last(until=condition)

    def optional(self) -> "Pattern":
        if self.stages[-1].negated:
            raise ValueError("a not-stage cannot be optional")
        return self._mod_last(optional=True)

    def within(self, ms: int) -> "Pattern":
        return Pattern(self.stages, ms, self.skip_strategy)

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.stages]
