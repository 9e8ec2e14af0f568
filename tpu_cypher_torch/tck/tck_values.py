"""TCK expected-value grammar and result comparison.

The TCK describes expected results as strings (``1``, ``'a'``, ``true``,
``null``, ``[1, 2]``, ``{k: 1}``, ``(:L {p: 1})``, ``[:T {p: 1}]``,
``<(:A)-[:T]->(:B)>``). The reference converts both sides through the
``tck-api`` value classes (``TCKFixture.scala:156-213``); here we parse the
strings ourselves and compare structurally — nodes by label set + properties,
relationships by type + properties, ids ignored (TCK semantics).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..api.values import Node, Path, Relationship


class TckValueError(Exception):
    pass


@dataclass(frozen=True)
class TckNode:
    labels: frozenset
    properties: Tuple[Tuple[str, Any], ...]


@dataclass(frozen=True)
class TckRelationship:
    rel_type: str
    properties: Tuple[Tuple[str, Any], ...]


@dataclass(frozen=True)
class TckPath:
    # alternating node / rel / node / ... with relationship directions:
    # elements[i] for odd i is (TckRelationship, forward: bool)
    elements: Tuple[Any, ...]


_NUM_INT = re.compile(r"[+-]?\d+$")
_NUM_FLOAT = re.compile(r"[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch: str):
        if not self.s.startswith(ch, self.i):
            raise TckValueError(
                f"Expected {ch!r} at {self.i} in {self.s!r}"
            )
        self.i += len(ch)

    def try_eat(self, ch: str) -> bool:
        self.ws()
        if self.s.startswith(ch, self.i):
            self.i += len(ch)
            return True
        return False

    # -- values ------------------------------------------------------------

    def value(self):
        self.ws()
        c = self.peek()
        if c == "'":
            return self.string()
        if c == "[":
            # relationship or list
            save = self.i
            try:
                return self.relationship()
            except TckValueError:
                self.i = save
                return self.list_()
        if c == "{":
            return self.map_()
        if c == "(":
            return self.node()
        if c == "<":
            return self.path()
        return self.scalar()

    def string(self) -> str:
        self.expect("'")
        out = []
        while True:
            if self.i >= len(self.s):
                raise TckValueError(f"Unterminated string in {self.s!r}")
            ch = self.s[self.i]
            if ch == "\\" and self.i + 1 < len(self.s):
                nxt = self.s[self.i + 1]
                if nxt in ("'", "\\"):
                    out.append(nxt)
                    self.i += 2
                    continue
                out.append(ch)
                self.i += 1
                continue
            if ch == "'":
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1

    def scalar(self):
        j = self.i
        while j < len(self.s) and self.s[j] not in ",]}|)>":
            j += 1
        tok = self.s[self.i:j].strip()
        self.i = j
        if tok == "null":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok == "NaN":
            return float("nan")
        if tok in ("Inf", "Infinity", "+Inf"):
            return math.inf
        if tok in ("-Inf", "-Infinity"):
            return -math.inf
        if _NUM_INT.match(tok):
            return int(tok)
        if _NUM_FLOAT.match(tok):
            return float(tok)
        raise TckValueError(f"Cannot parse scalar {tok!r} in {self.s!r}")

    def list_(self) -> list:
        self.expect("[")
        out = []
        self.ws()
        if self.try_eat("]"):
            return out
        out.append(self.value())
        while self.try_eat(","):
            out.append(self.value())
        self.ws()
        self.expect("]")
        return out

    def map_(self) -> dict:
        self.expect("{")
        out: Dict[str, Any] = {}
        self.ws()
        if self.try_eat("}"):
            return out
        while True:
            self.ws()
            key = self.ident()
            self.ws()
            self.expect(":")
            out[key] = self.value()
            if self.try_eat(","):
                continue
            self.ws()
            self.expect("}")
            return out

    def ident(self) -> str:
        if self.peek() == "`":
            self.i += 1
            j = self.s.index("`", self.i)
            out = self.s[self.i:j]
            self.i = j + 1
            return out
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", self.s[self.i:])
        if not m:
            raise TckValueError(f"Expected identifier at {self.i} in {self.s!r}")
        self.i += m.end()
        return m.group()

    def _labels(self) -> frozenset:
        labels = set()
        while self.try_eat(":"):
            labels.add(self.ident())
        return frozenset(labels)

    def node(self) -> TckNode:
        self.expect("(")
        self.ws()
        labels = self._labels()
        self.ws()
        props: Dict[str, Any] = {}
        if self.peek() == "{":
            props = self.map_()
        self.ws()
        self.expect(")")
        return TckNode(labels, tuple(sorted(props.items(), key=lambda kv: kv[0])))

    def relationship(self) -> TckRelationship:
        self.expect("[")
        self.ws()
        if not self.try_eat(":"):
            raise TckValueError("not a relationship")
        t = self.ident()
        self.ws()
        props: Dict[str, Any] = {}
        if self.peek() == "{":
            props = self.map_()
        self.ws()
        self.expect("]")
        return TckRelationship(t, tuple(sorted(props.items(), key=lambda kv: kv[0])))

    def path(self) -> TckPath:
        self.expect("<")
        elements: List[Any] = [self.node()]
        while True:
            self.ws()
            if self.try_eat(">"):
                return TckPath(tuple(elements))
            if self.try_eat("<-["):
                self.i -= len("[")
                rel = self.relationship()
                self.ws()
                self.expect("-")
                elements.append((rel, False))
            elif self.try_eat("-["):
                self.i -= len("[")
                rel = self.relationship()
                self.ws()
                self.expect("->")
                elements.append((rel, True))
            else:
                raise TckValueError(f"Bad path syntax in {self.s!r}")
            self.ws()
            elements.append(self.node())


def parse_tck_value(cell: str):
    p = _P(cell.strip())
    v = p.value()
    p.ws()
    if p.i != len(p.s):
        raise TckValueError(f"Trailing input in TCK value {cell!r}")
    return v


# ---------------------------------------------------------------------------
# comparison: engine result value vs parsed TCK expectation
# ---------------------------------------------------------------------------


def normalize_result_value(v, ignore_list_order: bool = False):
    """Engine → comparable: elements become structural Tck* values."""
    if isinstance(v, Node):
        return TckNode(
            frozenset(v.labels),
            tuple(
                sorted(
                    (
                        (k, normalize_result_value(x, ignore_list_order))
                        for k, x in v.properties.items()
                    ),
                    key=lambda kv: kv[0],
                )
            ),
        )
    if isinstance(v, Relationship):
        return TckRelationship(
            v.rel_type,
            tuple(
                sorted(
                    (
                        (k, normalize_result_value(x, ignore_list_order))
                        for k, x in v.properties.items()
                    ),
                    key=lambda kv: kv[0],
                )
            ),
        )
    if isinstance(v, Path):
        els: List[Any] = []
        prev_node_id = None
        for el in v.elements:
            if isinstance(el, Node):
                els.append(normalize_result_value(el, ignore_list_order))
                prev_node_id = el.id
            else:
                fwd = el.start == prev_node_id
                els.append((normalize_result_value(el, ignore_list_order), fwd))
                prev_node_id = el.end if fwd else el.start
        return TckPath(tuple(els))
    if isinstance(v, (list, tuple)):
        items = [normalize_result_value(x, ignore_list_order) for x in v]
        if ignore_list_order:
            return ("bag", _bag_key(items))
        return tuple(items)
    if isinstance(v, dict):
        return (
            "map",
            tuple(
                sorted(
                    (k, normalize_result_value(x, ignore_list_order))
                    for k, x in v.items()
                )
            ),
        )
    # tag numeric kinds: the TCK distinguishes 1 from 1.0 and true from 1
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, int):
        return ("int", v)
    if isinstance(v, float):
        if math.isnan(v):
            return ("float", "NaN")
        return ("float", v)
    return v


def normalize_expected_value(v, ignore_list_order: bool = False):
    if isinstance(v, TckNode):
        return TckNode(
            v.labels,
            tuple(
                (k, normalize_expected_value(x, ignore_list_order))
                for k, x in v.properties
            ),
        )
    if isinstance(v, TckRelationship):
        return TckRelationship(
            v.rel_type,
            tuple(
                (k, normalize_expected_value(x, ignore_list_order))
                for k, x in v.properties
            ),
        )
    if isinstance(v, TckPath):
        out = []
        for el in v.elements:
            if isinstance(el, tuple):
                rel, fwd = el
                out.append((normalize_expected_value(rel, ignore_list_order), fwd))
            else:
                out.append(normalize_expected_value(el, ignore_list_order))
        return TckPath(tuple(out))
    if isinstance(v, list):
        items = [normalize_expected_value(x, ignore_list_order) for x in v]
        if ignore_list_order:
            return ("bag", _bag_key(items))
        return tuple(items)
    if isinstance(v, dict):
        return (
            "map",
            tuple(
                sorted(
                    (k, normalize_expected_value(x, ignore_list_order))
                    for k, x in v.items()
                )
            ),
        )
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, int):
        return ("int", v)
    if isinstance(v, float):
        if math.isnan(v):
            return ("float", "NaN")
        return ("float", v)
    return v


def _bag_key(items: list):
    return tuple(sorted((repr(x) for x in items)))
