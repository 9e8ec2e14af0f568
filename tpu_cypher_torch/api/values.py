"""Cypher runtime values.

TPU-native re-design of the reference's boxed ``CypherValue`` hierarchy
(``okapi-api/src/main/scala/org/opencypher/okapi/api/value/CypherValue.scala:139``):
instead of boxing everything we use Python natives (None/bool/int/float/str/
Decimal/date/datetime/list/dict) plus dedicated classes for graph elements
(``Node`` ≈ ``CypherValue.scala:382``, ``Relationship`` ≈ ``:428``), ``Duration``
and row maps (``CypherMap`` ≈ ``:301``).

Two notions of sameness (reference distinguishes equality vs equivalence):

* ``cypher_equals(a, b)`` — ternary Cypher ``=``: returns None when either side
  is null (or a list/map containing null compares inconclusively).
* ``cypher_equivalent(a, b)`` — boolean, null ≡ null, NaN ≡ NaN; used for
  DISTINCT, grouping and test-bag comparison.
"""

from __future__ import annotations

import datetime as _dt
import math
from decimal import Decimal
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


class Duration:
    """Cypher duration: months / days / seconds / microseconds components.

    Mirrors ``okapi-api/.../impl/temporal/Duration.scala`` — calendar-aware
    (months and days don't normalize into seconds).
    """

    __slots__ = ("months", "days", "seconds", "microseconds")

    def __init__(self, months: int = 0, days: int = 0, seconds: int = 0, microseconds: int = 0):
        # normalize micros into seconds, keep months/days separate
        extra_s, us = divmod(microseconds, 1_000_000)
        self.months = int(months)
        self.days = int(days)
        self.seconds = int(seconds + extra_s)
        self.microseconds = int(us)

    @staticmethod
    def of(
        years: float = 0,
        months: float = 0,
        weeks: float = 0,
        days: float = 0,
        hours: float = 0,
        minutes: float = 0,
        seconds: float = 0,
        milliseconds: float = 0,
        microseconds: float = 0,
        nanoseconds: float = 0,
    ) -> "Duration":
        total_months = years * 12 + months
        whole_months = int(total_months)
        frac_month_days = (total_months - whole_months) * 30.4375  # avg month
        total_days = weeks * 7 + days + frac_month_days
        whole_days = int(total_days)
        frac_day_secs = (total_days - whole_days) * 86400
        total_secs = hours * 3600 + minutes * 60 + seconds + frac_day_secs
        whole_secs = int(total_secs)
        total_us = (
            (total_secs - whole_secs) * 1e6
            + milliseconds * 1000
            + microseconds
            + nanoseconds / 1000
        )
        return Duration(whole_months, whole_days, whole_secs, round(total_us))

    # total microseconds treating a month as 30.4375 days? Reference compares
    # durations by their components; we expose a canonical tuple instead.
    def _key(self) -> Tuple[int, int, int, int]:
        return (self.months, self.days, self.seconds, self.microseconds)

    def total_seconds_approx(self) -> float:
        return (
            self.months * 30.4375 * 86400
            + self.days * 86400
            + self.seconds
            + self.microseconds / 1e6
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, Duration) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(("Duration",) + self._key())

    def __add__(self, other: "Duration") -> "Duration":
        if not isinstance(other, Duration):
            return NotImplemented
        return Duration(
            self.months + other.months,
            self.days + other.days,
            self.seconds + other.seconds,
            self.microseconds + other.microseconds,
        )

    def __sub__(self, other: "Duration") -> "Duration":
        if not isinstance(other, Duration):
            return NotImplemented
        return Duration(
            self.months - other.months,
            self.days - other.days,
            self.seconds - other.seconds,
            self.microseconds - other.microseconds,
        )

    def __neg__(self) -> "Duration":
        return Duration(-self.months, -self.days, -self.seconds, -self.microseconds)

    def __repr__(self) -> str:
        return f"Duration(months={self.months}, days={self.days}, seconds={self.seconds}, microseconds={self.microseconds})"

    def cypher_str(self) -> str:
        """ISO-8601-ish rendering, e.g. P1Y2M3DT4H5M6.007S.

        Components carry their own sign (Neo4j-style): months, days and the
        time part are each rendered signed, truncating toward zero.
        """
        y = int(self.months / 12) if self.months else 0
        mo = self.months - 12 * y
        out = "P"
        if y:
            out += f"{y}Y"
        if mo:
            out += f"{mo}M"
        if self.days:
            out += f"{self.days}D"
        us_total = self.seconds * 1_000_000 + self.microseconds
        if us_total:
            neg = "-" if us_total < 0 else ""
            a = abs(us_total)
            h, rem = divmod(a, 3_600_000_000)
            m, rem = divmod(rem, 60_000_000)
            s, us = divmod(rem, 1_000_000)
            out += "T"
            if h:
                out += f"{neg}{h}H"
            if m:
                out += f"{neg}{m}M"
            if s or us:
                if us:
                    frac = f"{us / 1e6:.6f}".split(".")[1].rstrip("0")
                    out += f"{neg}{s}.{frac}S"
                else:
                    out += f"{neg}{s}S"
        if out == "P":
            out = "PT0S"
        return out


class Element:
    """Common base for Node / Relationship (reference ``CypherElement``)."""

    __slots__ = ("id", "properties")

    def __init__(self, id: int, properties: Optional[Mapping[str, Any]] = None):
        self.id = id
        self.properties = dict(properties or {})


class Node(Element):
    """Reference: ``CypherValue.scala:382`` (id-typed; here int64 ids)."""

    __slots__ = ("labels",)

    def __init__(self, id: int, labels: Iterable[str] = (), properties: Optional[Mapping[str, Any]] = None):
        super().__init__(id, properties)
        self.labels = frozenset(labels)

    def __eq__(self, other) -> bool:
        return isinstance(other, Node) and other.id == self.id

    def __hash__(self) -> int:
        return hash(("Node", self.id))

    def __repr__(self) -> str:
        lbl = "".join(f":{l}" for l in sorted(self.labels))
        props = ", ".join(f"{k}: {to_cypher_string(v)}" for k, v in sorted(self.properties.items()))
        inner = " ".join(x for x in [lbl, "{" + props + "}" if props else ""] if x)
        return f"({inner})"


class Relationship(Element):
    """Reference: ``CypherValue.scala:428``."""

    __slots__ = ("start", "end", "rel_type")

    def __init__(
        self,
        id: int,
        start: int,
        end: int,
        rel_type: str,
        properties: Optional[Mapping[str, Any]] = None,
    ):
        super().__init__(id, properties)
        self.start = start
        self.end = end
        self.rel_type = rel_type

    def __eq__(self, other) -> bool:
        return isinstance(other, Relationship) and other.id == self.id

    def __hash__(self) -> int:
        return hash(("Relationship", self.id))

    def __repr__(self) -> str:
        props = ", ".join(f"{k}: {to_cypher_string(v)}" for k, v in sorted(self.properties.items()))
        inner = ":" + self.rel_type + (" {" + props + "}" if props else "")
        return f"[{inner}]"


class Path:
    __slots__ = ("elements",)

    def __init__(self, elements: Iterable[Element]):
        self.elements = tuple(elements)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self.elements == other.elements

    def __hash__(self) -> int:
        return hash(("Path", self.elements))

    def __repr__(self) -> str:
        # TCK-style: <(:A)-[:R]->(:B)>; arrow orientation from the stored
        # relationship endpoints relative to the previous node in the walk
        out = []
        prev_node_id = None
        for e in self.elements:
            if isinstance(e, Relationship):
                if prev_node_id is not None and e.start == prev_node_id:
                    out.append(f"-{e!r}->")
                    prev_node_id = None
                else:
                    out.append(f"<-{e!r}-")
                    prev_node_id = None
            else:
                out.append(repr(e))
                prev_node_id = e.id
        return "<" + "".join(out) + ">"


class CypherMap(dict):
    """A row of named Cypher values (reference ``CypherMap``, ``:301``).

    Hash/eq use *equivalence* so CypherMaps can live in Bags (multisets).
    """

    def __hash__(self) -> int:  # type: ignore[override]
        return hash(tuple(sorted((k, _equiv_key(v)) for k, v in self.items())))

    def __eq__(self, other) -> bool:  # type: ignore[override]
        if not isinstance(other, Mapping) or set(self.keys()) != set(other.keys()):
            return False
        return all(cypher_equivalent(self[k], other[k]) for k in self)

    def __ne__(self, other) -> bool:  # type: ignore[override]
        return not self.__eq__(other)

    def __repr__(self) -> str:
        return "{" + ", ".join(f"{k}: {to_cypher_string(v)}" for k, v in self.items()) + "}"


# ---------------------------------------------------------------------------
# Equality / equivalence / ordering
# ---------------------------------------------------------------------------


def cypher_equals(a, b) -> Optional[bool]:
    """Ternary Cypher ``=``; None means unknown (null semantics)."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, bool):
        return a == b
    if isinstance(a, (int, float, Decimal)) and isinstance(b, (int, float, Decimal)):
        if isinstance(a, float) and math.isnan(a):
            return False
        if isinstance(b, float) and math.isnan(b):
            return False
        # Python's cross-type numeric == is exact — no float64 collapse of
        # ints beyond 2**53 (graph-tagged element ids live at 2**54+)
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        saw_null = False
        for x, y in zip(a, b):
            r = cypher_equals(x, y)
            if r is False:
                return False
            if r is None:
                saw_null = True
        return None if saw_null else True
    if (
        isinstance(a, Mapping)
        and isinstance(b, Mapping)
        and not isinstance(a, Element)
        and not isinstance(b, Element)
    ):
        if set(a.keys()) != set(b.keys()):
            return False
        saw_null = False
        for k in a:
            r = cypher_equals(a[k], b[k])
            if r is False:
                return False
            if r is None:
                saw_null = True
        return None if saw_null else True
    if type(a) is not type(b) and not (
        isinstance(a, Element) and isinstance(b, Element)
    ):
        if isinstance(a, (str,)) and isinstance(b, (str,)):
            pass
        else:
            return False
    return a == b


def cypher_equivalent(a, b) -> bool:
    """Equivalence: null ≡ null, NaN ≡ NaN. Used for DISTINCT/grouping/tests."""
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float, Decimal)) and isinstance(b, (int, float, Decimal)):
        a_nan = _num_is_nan(a)
        b_nan = _num_is_nan(b)
        if a_nan or b_nan:
            return a_nan and b_nan
        return a == b  # exact cross-type numeric equality
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(cypher_equivalent(x, y) for x, y in zip(a, b))
    if (
        isinstance(a, Mapping)
        and isinstance(b, Mapping)
        and not isinstance(a, Element)
        and not isinstance(b, Element)
    ):
        return set(a.keys()) == set(b.keys()) and all(
            cypher_equivalent(a[k], b[k]) for k in a
        )
    return a == b


def _num_is_nan(x) -> bool:
    return (isinstance(x, float) and math.isnan(x)) or (
        isinstance(x, Decimal) and x.is_nan()
    )


def _equiv_key(v) -> Any:
    """A hashable key st. equivalence-equal values share a key — must agree
    with :func:`cypher_equivalent` (used for DISTINCT/grouping/hash joins)."""
    if v is None:
        return ("null",)
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, (int, float, Decimal)):
        # ints/Decimals exactly representable in float64 share the float's
        # key (Cypher equivalence: 1 = 1.0); beyond 2**53 the float would
        # collapse distinct ids (graph-tagged element ids live at 2**54+),
        # so non-representable values key on their exact value
        if isinstance(v, int):
            try:
                f = float(v)
            except OverflowError:  # ints >= ~1.8e308
                return ("num", v)
            if not math.isinf(f) and int(f) == v:
                return ("num", f)
            return ("num", v)
        if isinstance(v, Decimal):
            if v.is_nan():
                return ("nan",)
            if v.is_infinite():
                return ("num", math.inf if v > 0 else -math.inf)
            try:
                f = float(v)
            except OverflowError:
                f = math.inf if v > 0 else -math.inf
            if not math.isinf(f) and Decimal(f) == v:
                return ("num", f)  # exactly representable: shares float key
            if v == v.to_integral_value():
                return ("num", int(v))  # exact integral beyond float range
            return ("num", "dec", str(v.normalize()))  # exact non-integral
        f = v  # plain float
        if math.isnan(f):
            return ("nan",)
        return ("num", f)
    if isinstance(v, (list, tuple)):
        return ("list", tuple(_equiv_key(x) for x in v))
    if isinstance(v, Element):
        return ("elem", v.id)
    if isinstance(v, Mapping):
        return ("map", tuple(sorted((k, _equiv_key(x)) for k, x in v.items())))
    return ("v", v)


_TYPE_ORDER = {
    # Cypher global sort order (descending per openCypher): MAP > NODE > REL >
    # LIST > PATH > STRING > BOOLEAN > NUMBER > VOID(null last in ASC)
    "map": 0,
    "node": 1,
    "relationship": 2,
    "list": 3,
    "path": 4,
    "string": 5,
    "boolean": 6,
    "number": 7,
    # temporal instants fall in the default "other" class (8; ISO strings
    # order chronologically); durations get their own slot with an
    # average-length key (below)
    "duration": 9,
}

# duration order key basis: average-length microseconds with a month of
# 30.4375 days (the reference compares CalendarIntervals by their converted
# java.time.Duration, TemporalUdafs.scala; same constants as the device key
# in backend/tpu/column.py). Ties are resolved by stability (first
# occurrence) on BOTH backends, never by value.
_DUR_MONTH_US = 2_629_800_000_000
_DUR_DAY_US = 86_400_000_000


def duration_order_us(v: "Duration") -> int:
    return (
        v.months * _DUR_MONTH_US
        + v.days * _DUR_DAY_US
        + v.seconds * 1_000_000
        + v.microseconds
    )


def _order_class(v) -> str:
    if isinstance(v, Duration):
        return "duration"
    if isinstance(v, Node):
        return "node"
    if isinstance(v, Relationship):
        return "relationship"
    if isinstance(v, Path):
        return "path"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float, Decimal)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "list"
    if isinstance(v, Mapping):
        return "map"
    return "other"


def order_key(v):
    """Total-order sort key implementing Cypher's orderability.

    Nulls sort last ascending (caller appends null flag first).
    """
    if v is None:
        return (1, 0, 0)
    cls = _order_class(v)
    o = _TYPE_ORDER.get(cls, 8)
    if cls == "number":
        if isinstance(v, int):
            # keep ints exact: float64 would collapse ids beyond 2**53
            # (Python orders int vs float exactly, so mixing is safe)
            key = (False, v)
        else:
            f = float(v)
            key = (math.isnan(f), f)  # NaN greater than all numbers
    elif cls == "boolean":
        key = v
    elif cls == "string":
        key = v
    elif cls in ("node", "relationship"):
        key = v.id
    elif cls == "list":
        key = tuple(order_key(x) for x in v)
    elif cls == "map":
        key = tuple(sorted((k, order_key(x)) for k, x in v.items()))
    elif cls == "duration":
        key = duration_order_us(v)
    else:
        key = str(v)
    return (0, o, key)


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------


def to_cypher_string(v) -> str:
    """Render a value the way Cypher would print it."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 1e15:
            return f"{v:.1f}"
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if isinstance(v, Duration):
        return f"'{v.cypher_str()}'"
    if isinstance(v, _dt.datetime):
        return f"'{v.isoformat()}'"
    if isinstance(v, _dt.date):
        return f"'{v.isoformat()}'"
    if isinstance(v, (Node, Relationship)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(to_cypher_string(x) for x in v) + "]"
    if isinstance(v, Mapping):
        return "{" + ", ".join(f"{k}: {to_cypher_string(x)}" for k, x in v.items()) + "}"
    if isinstance(v, Decimal):
        return str(v)
    return str(v)


def format_utc_offset(total_seconds: int) -> str:
    """'+HH:MM' (':SS' only when nonzero) — ONE formatter for zone offsets,
    shared by the oracle accessors and the device column metadata."""
    sign = "+" if total_seconds >= 0 else "-"
    h, rem = divmod(abs(int(total_seconds)), 3600)
    m, sec = divmod(rem, 60)
    base = f"{sign}{h:02d}:{m:02d}"
    return base + (f":{sec:02d}" if sec else "")
