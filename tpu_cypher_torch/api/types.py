"""Cypher structural type lattice.

TPU-native re-design of the reference's ``CypherType`` system
(``okapi-api/src/main/scala/org/opencypher/okapi/api/types/CypherType.scala:32``):
a structural lattice with ``CTNode(labels)`` / ``CTRelationship(types)`` element
types, ``CTList``/``CTMap`` containers, union types (``CTUnion``, reference
``CypherType.scala:284``), and nullability modelled as union-with-``CTNull``.

Unlike the JVM reference this module is deliberately *hashable-frozen-dataclass*
flavoured so types can key dictionaries (RecordHeader) and be compared
structurally. The lattice operations are ``subtype_of``, ``join`` (least upper
bound) and ``meet`` (greatest lower bound).
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Mapping, Optional


import re as _re

_IDENT = _re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def _esc(name: str) -> str:
    """Backtick-escape names that aren't plain identifiers (parser round-trip)."""
    return name if _IDENT.match(name) else f"`{name}`"


class CypherType:
    """Base class for all Cypher types. Immutable, hashable."""

    __slots__ = ()

    # -- nullability ------------------------------------------------------

    @property
    def is_nullable(self) -> bool:
        return False

    @property
    def nullable(self) -> "CypherType":
        """This type or null."""
        if self.is_nullable:
            return self
        return CTUnion.of(self, CTNull)

    @property
    def material(self) -> "CypherType":
        """This type without null."""
        return self

    # -- lattice ----------------------------------------------------------

    def subtype_of(self, other: "CypherType") -> bool:
        if self == other:
            return True
        # ANY is the *material* top: it does not include null
        if isinstance(other, CTAnyType) and not self.is_nullable:
            return True
        if isinstance(other, CTUnion):
            return any(self.subtype_of(a) for a in other.alternatives)
        return self._subtype_of_material(other)

    def _subtype_of_material(self, other: "CypherType") -> bool:
        return False

    def supertype_of(self, other: "CypherType") -> bool:
        return other.subtype_of(self)

    def join(self, other: "CypherType") -> "CypherType":
        """Least upper bound."""
        if self.subtype_of(other):
            return other
        if other.subtype_of(self):
            return self
        special = self._join_special(other) or other._join_special(self)
        if special is not None:
            return special
        return CTUnion.of(self, other)

    def _join_special(self, other: "CypherType") -> Optional["CypherType"]:
        return None

    def meet(self, other: "CypherType") -> "CypherType":
        """Greatest lower bound."""
        if self.subtype_of(other):
            return self
        if other.subtype_of(self):
            return other
        special = self._meet_special(other) or other._meet_special(self)
        if special is not None:
            return special
        return CTVoid

    def _meet_special(self, other: "CypherType") -> Optional["CypherType"]:
        return None

    def couldBe(self, other: "CypherType") -> bool:
        return self.meet(other) != CTVoid

    # -- misc --------------------------------------------------------------

    @property
    def name(self) -> str:
        return repr(self)

    def __repr__(self) -> str:  # pragma: no cover - overridden
        return self.__class__.__name__


# ---------------------------------------------------------------------------
# Leaf / singleton types
# ---------------------------------------------------------------------------


class _Singleton(CypherType):
    __slots__ = ()
    _NAME = "?"

    def __repr__(self) -> str:
        return self._NAME

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)


class CTAnyType(_Singleton):
    """Top of the material lattice (does not include null)."""

    _NAME = "ANY"

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTAnyType)


class CTVoidType(_Singleton):
    """Bottom (no value)."""

    _NAME = "VOID"

    def subtype_of(self, other: CypherType) -> bool:
        return True


class CTNullType(_Singleton):
    _NAME = "NULL"

    @property
    def is_nullable(self) -> bool:
        return True

    @property
    def material(self) -> CypherType:
        return CTVoid

    def _subtype_of_material(self, other: CypherType) -> bool:
        return other.is_nullable


class CTBooleanType(_Singleton):
    _NAME = "BOOLEAN"


class CTStringType(_Singleton):
    _NAME = "STRING"


class CTIntegerType(_Singleton):
    _NAME = "INTEGER"

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTNumberType)


class CTFloatType(_Singleton):
    _NAME = "FLOAT"

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTNumberType)


class CTNumberType(_Singleton):
    """Supertype of INTEGER and FLOAT (reference: CTNumber = union)."""

    _NAME = "NUMBER"


class CTDateType(_Singleton):
    _NAME = "DATE"


class CTLocalDateTimeType(_Singleton):
    _NAME = "LOCALDATETIME"


class CTDateTimeType(_Singleton):
    """Zoned datetime (instant + zone offset) — reference CTDateTime; its
    ``TemporalUdfs.scala:40`` warns on timezone loss, we keep the offset."""

    _NAME = "DATETIME"


class CTLocalTimeType(_Singleton):
    _NAME = "LOCALTIME"


class CTTimeType(_Singleton):
    """Zoned time-of-day (local micros + zone offset) — reference CTTime."""

    _NAME = "TIME"


class CTDurationType(_Singleton):
    _NAME = "DURATION"


class CTBigDecimalType(CypherType):
    """BIGDECIMAL(precision, scale) — reference CTBigDecimal."""

    __slots__ = ("precision", "scale")

    def __init__(self, precision: int = 38, scale: int = 18):
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)

    def __repr__(self) -> str:
        return f"BIGDECIMAL({self.precision},{self.scale})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CTBigDecimalType)
            and self.precision == other.precision
            and self.scale == other.scale
        )

    def __hash__(self) -> int:
        return hash(("BIGDECIMAL", self.precision, self.scale))

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTNumberType)


class CTPathType(_Singleton):
    _NAME = "PATH"


class CTElementIdType(_Singleton):
    """Internal: an element id column type (int64 on device)."""

    _NAME = "ELEMENTID"


# ---------------------------------------------------------------------------
# Element types
# ---------------------------------------------------------------------------


class CTNodeType(CypherType):
    """Node with *at least* the given labels: more labels = more specific.

    Reference: ``CypherType.scala:222`` — ``CTNode(labels)``; subtyping is
    label-superset.
    """

    __slots__ = ("labels",)

    def __init__(self, labels: Iterable[str] = ()):  # noqa: D401
        object.__setattr__(self, "labels", frozenset(labels))

    def __repr__(self) -> str:
        if not self.labels:
            return "NODE"
        return "NODE(" + ":".join(_esc(l) for l in sorted(self.labels)) + ")"

    def __eq__(self, other) -> bool:
        return isinstance(other, CTNodeType) and self.labels == other.labels

    def __hash__(self) -> int:
        return hash(("NODE", self.labels))

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTNodeType) and other.labels <= self.labels

    def _join_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTNodeType):
            return CTNodeType(self.labels & other.labels)
        return None

    def _meet_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTNodeType):
            return CTNodeType(self.labels | other.labels)
        return None


class CTRelationshipType(CypherType):
    """Relationship with type in the given set (empty = any type).

    Reference: ``CypherType.scala:242`` — ``CTRelationship(types)``; a
    relationship has exactly one type, so *fewer* alternatives = more specific.
    """

    __slots__ = ("types",)

    def __init__(self, types: Iterable[str] = ()):  # noqa: D401
        object.__setattr__(self, "types", frozenset(types))

    def __repr__(self) -> str:
        if not self.types:
            return "RELATIONSHIP"
        return "RELATIONSHIP(" + "|".join(_esc(t) for t in sorted(self.types)) + ")"

    def __eq__(self, other) -> bool:
        return isinstance(other, CTRelationshipType) and self.types == other.types

    def __hash__(self) -> int:
        return hash(("RELATIONSHIP", self.types))

    def _subtype_of_material(self, other: CypherType) -> bool:
        if not isinstance(other, CTRelationshipType):
            return False
        if not other.types:
            return True
        return bool(self.types) and self.types <= other.types

    def _join_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTRelationshipType):
            if not self.types or not other.types:
                return CTRelationshipType()
            return CTRelationshipType(self.types | other.types)
        return None

    def _meet_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTRelationshipType):
            if not self.types:
                return other
            if not other.types:
                return self
            inter = self.types & other.types
            return CTRelationshipType(inter) if inter else CTVoid
        return None


# ---------------------------------------------------------------------------
# Container types
# ---------------------------------------------------------------------------


class CTListType(CypherType):
    __slots__ = ("inner",)

    def __init__(self, inner: CypherType):
        object.__setattr__(self, "inner", inner)

    def __repr__(self) -> str:
        return f"LIST({self.inner!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, CTListType) and self.inner == other.inner

    def __hash__(self) -> int:
        return hash(("LIST", self.inner))

    def _subtype_of_material(self, other: CypherType) -> bool:
        return isinstance(other, CTListType) and self.inner.subtype_of(other.inner)

    def _join_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTListType):
            return CTListType(self.inner.join(other.inner))
        return None

    def _meet_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTListType):
            return CTListType(self.inner.meet(other.inner))
        return None


class CTMapType(CypherType):
    """Map with known fields (width subtyping) or CTMapType(None) = any map."""

    __slots__ = ("fields",)

    def __init__(self, fields: Optional[Mapping[str, CypherType]] = None):
        object.__setattr__(
            self,
            "fields",
            None if fields is None else tuple(sorted(fields.items())),
        )

    @property
    def fields_dict(self) -> Optional[dict]:
        return None if self.fields is None else dict(self.fields)

    def __repr__(self) -> str:
        if self.fields is None:
            return "MAP"
        inner = ", ".join(f"{_esc(k)}: {v!r}" for k, v in self.fields)
        return f"MAP({inner})"

    def __eq__(self, other) -> bool:
        return isinstance(other, CTMapType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(("MAP", self.fields))

    def _subtype_of_material(self, other: CypherType) -> bool:
        if not isinstance(other, CTMapType):
            return False
        if other.fields is None:
            return True
        if self.fields is None:
            return False
        mine = dict(self.fields)
        theirs = dict(other.fields)
        # every key of ours must be known to `other`; keys we lack must be
        # nullable there (join marks one-sided keys nullable, keeping join
        # an upper bound)
        if not set(mine) <= set(theirs):
            return False
        return all(
            mine[k].subtype_of(theirs[k]) if k in mine else theirs[k].is_nullable
            for k in theirs
        )

    def _join_special(self, other: CypherType) -> Optional[CypherType]:
        if isinstance(other, CTMapType):
            if self.fields is None or other.fields is None:
                return CTMapType(None)
            mine = dict(self.fields)
            theirs = dict(other.fields)
            out = {}
            for k in set(mine) | set(theirs):
                if k in mine and k in theirs:
                    out[k] = mine[k].join(theirs[k])
                else:
                    out[k] = (mine.get(k) or theirs.get(k)).nullable
            return CTMapType(out)
        return None


# ---------------------------------------------------------------------------
# Union types
# ---------------------------------------------------------------------------


class CTUnion(CypherType):
    """Union of alternatives; nullability is CTNull-membership.

    Reference: ``CypherType.scala:284``.
    """

    __slots__ = ("alternatives",)

    def __init__(self, alternatives: FrozenSet[CypherType]):
        object.__setattr__(self, "alternatives", frozenset(alternatives))

    @staticmethod
    def of(*types: CypherType) -> CypherType:
        """Construct a simplified union."""
        flat: set = set()

        def add(t: CypherType):
            if isinstance(t, CTUnion):
                for a in t.alternatives:
                    add(a)
            elif isinstance(t, CTVoidType):
                pass
            else:
                flat.add(t)

        for t in types:
            add(t)
        if not flat:
            return CTVoid
        # drop alternatives subsumed by others
        pruned = {
            t
            for t in flat
            if not any(o is not t and t != o and t.subtype_of(o) for o in flat)
        }
        # INTEGER | FLOAT -> NUMBER
        if CTInteger in pruned and CTFloat in pruned:
            pruned -= {CTInteger, CTFloat}
            pruned.add(CTNumber)
        if len(pruned) == 1:
            return next(iter(pruned))
        return CTUnion(frozenset(pruned))

    @property
    def is_nullable(self) -> bool:
        return any(a.is_nullable for a in self.alternatives)

    @property
    def material(self) -> CypherType:
        return CTUnion.of(*[a for a in self.alternatives if a != CTNull])

    def subtype_of(self, other: CypherType) -> bool:
        if self == other:
            return True
        return all(a.subtype_of(other) for a in self.alternatives)

    def _join_special(self, other: CypherType) -> Optional[CypherType]:
        return CTUnion.of(*self.alternatives, other)

    def _meet_special(self, other: CypherType) -> Optional[CypherType]:
        met = [a.meet(other) for a in self.alternatives]
        return CTUnion.of(*met)

    def __repr__(self) -> str:
        mat = self.material
        if self.is_nullable and not isinstance(mat, CTUnion) and mat != CTVoid:
            return f"{mat!r}?"
        return "UNION(" + ", ".join(sorted(repr(a) for a in self.alternatives)) + ")"

    def __eq__(self, other) -> bool:
        return isinstance(other, CTUnion) and self.alternatives == other.alternatives

    def __hash__(self) -> int:
        return hash(("UNION", self.alternatives))


# ---------------------------------------------------------------------------
# Singletons & helpers
# ---------------------------------------------------------------------------

CTAny = CTAnyType()
CTVoid = CTVoidType()
CTNull = CTNullType()
CTBoolean = CTBooleanType()
CTString = CTStringType()
CTInteger = CTIntegerType()
CTFloat = CTFloatType()
CTNumber = CTNumberType()
CTDate = CTDateType()
CTLocalDateTime = CTLocalDateTimeType()
CTDateTime = CTDateTimeType()
CTLocalTime = CTLocalTimeType()
CTTime = CTTimeType()
CTDuration = CTDurationType()
CTPath = CTPathType()
CTElementId = CTElementIdType()


def CTNode(*labels: str) -> CTNodeType:
    if len(labels) == 1 and not isinstance(labels[0], str):
        return CTNodeType(labels[0])
    return CTNodeType(labels)


def CTRelationship(*types: str) -> CTRelationshipType:
    if len(types) == 1 and not isinstance(types[0], str):
        return CTRelationshipType(types[0])
    return CTRelationshipType(types)


def CTList(inner: CypherType) -> CTListType:
    return CTListType(inner)


def CTMap(fields: Optional[Mapping[str, CypherType]] = None) -> CTMapType:
    return CTMapType(fields)


CTAnyNullable = CTAny.nullable


def join_types(types: Iterable[CypherType]) -> CypherType:
    out: CypherType = CTVoid
    for t in types:
        out = out.join(t)
    return out


# -- value -> type inference -------------------------------------------------


def type_of_value(value) -> CypherType:
    """Infer the CypherType of a Python-represented Cypher value."""
    from . import values as _v
    import datetime as _dt
    from decimal import Decimal

    if value is None:
        return CTNull
    if isinstance(value, bool):
        return CTBoolean
    if isinstance(value, int):
        return CTInteger
    if isinstance(value, float):
        return CTFloat
    if isinstance(value, str):
        return CTString
    if isinstance(value, Decimal):
        return CTBigDecimalType()
    if isinstance(value, _v.Node):
        return CTNodeType(value.labels)
    if isinstance(value, _v.Relationship):
        return CTRelationshipType([value.rel_type])
    if isinstance(value, _v.Duration):
        return CTDuration
    if isinstance(value, _v.Path):
        return CTPath
    if isinstance(value, _dt.datetime):
        return CTDateTime if value.tzinfo is not None else CTLocalDateTime
    if isinstance(value, _dt.date):
        return CTDate
    if isinstance(value, _dt.time):
        return CTTime if value.tzinfo is not None else CTLocalTime
    if isinstance(value, (list, tuple)):
        return CTListType(join_types(type_of_value(v) for v in value))
    if isinstance(value, Mapping):
        return CTMapType({k: type_of_value(v) for k, v in value.items()})
    raise TypeError(f"No CypherType for value {value!r} ({type(value)})")


# -- parsing (schema JSON round-trip) ----------------------------------------


def parse_type(s: str) -> CypherType:
    """Parse the textual form produced by ``repr``.

    Mirrors the reference's ``CypherTypeParser``
    (``okapi-api/.../impl/types/CypherTypeParser.scala``).
    """
    from .type_parser import parse_cypher_type

    return parse_cypher_type(s)
