"""SLO classes and the class-aware admission queue.

The port's own copy of what ``DecodeEngine`` admission uses from
``rafiki_tpu/serving/slo.py``: ``SLO_CLASSES``/``SLO_PRIORITY``,
``DEFAULT_SLO``, ``normalize_slo``, ``slo_priority`` and ``ClassQueue``.
The preemption helpers (``evictable_occupants``, ``preemption_victim``)
and the brownout ladder wait for the slices that port preemption and the
predictor.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Optional, Tuple

#: priority order, highest first: admission serves interactive before
#: batch before background.
SLO_CLASSES: Tuple[str, ...] = ("interactive", "batch", "background")

#: class -> rank (lower = more urgent)
SLO_PRIORITY: Dict[str, int] = {c: i for i, c in enumerate(SLO_CLASSES)}

DEFAULT_SLO = "interactive"


def normalize_slo(value: Any, default: str = DEFAULT_SLO) -> str:
    """The one SLO-class validator: ``None``/empty → ``default``;
    anything else must (case-insensitively) name one of
    :data:`SLO_CLASSES` or ``ValueError``."""
    if value is None:
        return default
    s = str(value).strip().lower()
    if not s:
        return default
    if s not in SLO_PRIORITY:
        raise ValueError(
            f"unknown SLO class {value!r} (one of: "
            f"{', '.join(SLO_CLASSES)})")
    return s


def slo_priority(slo: str) -> int:
    """Rank of a class (0 = most urgent); unknown classes rank last."""
    return SLO_PRIORITY.get(slo, len(SLO_CLASSES))


class ClassQueue:
    """Per-class FIFO admission queue with starvation-bounding aging.

    Not thread-safe on purpose: the decode engine mutates it under its
    own admission lock.

    Aging: every :meth:`pop` that serves class X increments a skip
    counter on every lower-priority class that had a waiter; a class
    whose counter reaches ``aging_skips`` is served next regardless of
    priority (and its counter resets)."""

    #: admissions a lower class may be skipped before force-promotion
    DEFAULT_AGING_SKIPS = 16

    def __init__(self, aging_skips: int = DEFAULT_AGING_SKIPS) -> None:
        self.aging_skips = max(1, int(aging_skips))
        self._qs: Dict[str, Deque[Any]] = {
            c: collections.deque() for c in SLO_CLASSES}
        self._skips: Dict[str, int] = {c: 0 for c in SLO_CLASSES}
        #: force-promotions performed (the aging mechanism firing)
        self.promotions = 0
        #: did the last pop fire the aging mechanism?
        self.last_pop_promoted = False

    def push(self, slo: str, item: Any, front: bool = False) -> None:
        """Enqueue ``item`` under ``slo`` (validated); ``front`` puts it
        ahead of its class peers."""
        q = self._qs[normalize_slo(slo)]
        if front:
            q.appendleft(item)
        else:
            q.append(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs.values())

    def __bool__(self) -> bool:
        return any(self._qs.values())

    def depth(self, slo: str) -> int:
        return len(self._qs[normalize_slo(slo)])

    def depths(self) -> Dict[str, int]:
        return {c: len(q) for c, q in self._qs.items()}

    def next_class(self) -> Optional[str]:
        """The class the next :meth:`pop` will serve: an aged class
        first (most-skipped wins ties), else the highest-priority
        non-empty one. None when empty."""
        aged = [c for c in SLO_CLASSES
                if self._qs[c] and self._skips[c] >= self.aging_skips]
        if aged:
            return max(aged, key=lambda c: self._skips[c])
        for c in SLO_CLASSES:
            if self._qs[c]:
                return c
        return None

    def peek(self) -> Optional[Tuple[str, Any]]:
        """(class, head item) the next pop would return, without
        popping."""
        c = self.next_class()
        if c is None:
            return None
        return c, self._qs[c][0]

    def pop(self) -> Optional[Tuple[str, Any]]:
        """Serve the next item (see :meth:`next_class`), updating the
        aging counters."""
        c = self.next_class()
        if c is None:
            return None
        self.last_pop_promoted = bool(
            self._skips[c] >= self.aging_skips and any(
                self._qs[h] for h in SLO_CLASSES
                if SLO_PRIORITY[h] < SLO_PRIORITY[c]))
        if self.last_pop_promoted:
            self.promotions += 1
        item = self._qs[c].popleft()
        self._skips[c] = 0
        for lower in SLO_CLASSES:
            if SLO_PRIORITY[lower] > SLO_PRIORITY[c] and self._qs[lower]:
                self._skips[lower] += 1
        return c, item

    def clear(self) -> None:
        for c in SLO_CLASSES:
            self._qs[c].clear()
            self._skips[c] = 0
