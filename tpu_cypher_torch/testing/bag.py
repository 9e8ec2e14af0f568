"""Bag (multiset) result assertions (reference ``okapi-testing/.../Bag.scala``
+ ``RecordMatchingTestSupport``)."""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Mapping

from ..api.values import CypherMap


class Bag:
    def __init__(self, items: Iterable):
        self.counter = Counter(
            m if isinstance(m, CypherMap) else CypherMap(m) for m in items
        )

    def __eq__(self, other) -> bool:
        if isinstance(other, Bag):
            return self.counter == other.counter
        if isinstance(other, (list, tuple)):
            return self == Bag(other)
        return NotImplemented

    def __len__(self) -> int:
        return sum(self.counter.values())

    def __repr__(self) -> str:
        items = []
        for m, c in self.counter.items():
            items.append(f"{m!r} x{c}" if c > 1 else repr(m))
        return "Bag(" + ", ".join(items) + ")"


def bag_of(*maps: Mapping) -> Bag:
    return Bag(maps)
