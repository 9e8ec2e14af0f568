"""Property graph schema.

Re-design of ``okapi-api/src/main/scala/org/opencypher/okapi/api/schema/PropertyGraphSchema.scala:62``
and its impl (``impl/schema/PropertyGraphSchemaImpl.scala``, ``ImpliedLabels.scala``,
``LabelCombinations.scala``): maps *label combinations* (the exact set of labels on a
node) to property keys/types, and relationship types to property keys/types; tracks
schema patterns (which (srcLabels, relType, dstLabels) triplets exist, used for
pattern-scan recognition) and supports merge (``++``/union), restriction
(``for_node`` / ``for_relationship``) and JSON round-trip.
"""

from __future__ import annotations

import json
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Set, Tuple

from . import types as T
from .types import CypherType

LabelCombo = FrozenSet[str]
PropertyKeys = Dict[str, CypherType]


def _merge_keys(a: PropertyKeys, b: PropertyKeys) -> PropertyKeys:
    """Join property keys: shared keys join types; one-sided keys become nullable."""
    out: PropertyKeys = {}
    for k in set(a) | set(b):
        if k in a and k in b:
            out[k] = a[k].join(b[k])
        else:
            out[k] = (a.get(k) or b.get(k)).nullable
    return out


class SchemaPattern:
    """A (source labels, rel type, target labels) triplet known to the schema.

    Reference: ``PropertyGraphSchema.scala`` schema patterns / ``SchemaPattern``.
    """

    __slots__ = ("source_labels", "rel_type", "target_labels")

    def __init__(self, source_labels: Iterable[str], rel_type: str, target_labels: Iterable[str]):
        self.source_labels = frozenset(source_labels)
        self.rel_type = rel_type
        self.target_labels = frozenset(target_labels)

    def _key(self):
        return (self.source_labels, self.rel_type, self.target_labels)

    def __eq__(self, other):
        return isinstance(other, SchemaPattern) and self._key() == other._key()

    def __hash__(self):
        return hash(("SchemaPattern",) + tuple(map(hash, self._key())))

    def __repr__(self):
        s = ":".join(sorted(self.source_labels))
        t = ":".join(sorted(self.target_labels))
        return f"(:{s})-[:{self.rel_type}]->(:{t})"


class PropertyGraphSchema:
    __slots__ = ("_node_keys", "_rel_keys", "_patterns")

    def __init__(
        self,
        node_keys: Optional[Mapping[LabelCombo, PropertyKeys]] = None,
        rel_keys: Optional[Mapping[str, PropertyKeys]] = None,
        patterns: Optional[Iterable[SchemaPattern]] = None,
    ):
        self._node_keys: Dict[LabelCombo, PropertyKeys] = {
            frozenset(k): dict(v) for k, v in (node_keys or {}).items()
        }
        self._rel_keys: Dict[str, PropertyKeys] = {k: dict(v) for k, v in (rel_keys or {}).items()}
        self._patterns: Set[SchemaPattern] = set(patterns or ())

    # -- constructors -----------------------------------------------------

    @staticmethod
    def empty() -> "PropertyGraphSchema":
        return PropertyGraphSchema()

    def with_node_combination(
        self, labels: Iterable[str], keys: Optional[Mapping[str, CypherType]] = None
    ) -> "PropertyGraphSchema":
        combo = frozenset(labels)
        nk = {k: dict(v) for k, v in self._node_keys.items()}
        if combo in nk:
            nk[combo] = _merge_keys(nk[combo], dict(keys or {}))
        else:
            nk[combo] = dict(keys or {})
        return PropertyGraphSchema(nk, self._rel_keys, self._patterns)

    def with_relationship_type(
        self, rel_type: str, keys: Optional[Mapping[str, CypherType]] = None
    ) -> "PropertyGraphSchema":
        rk = {k: dict(v) for k, v in self._rel_keys.items()}
        if rel_type in rk:
            rk[rel_type] = _merge_keys(rk[rel_type], dict(keys or {}))
        else:
            rk[rel_type] = dict(keys or {})
        return PropertyGraphSchema(self._node_keys, rk, self._patterns)

    def with_schema_patterns(self, *patterns: SchemaPattern) -> "PropertyGraphSchema":
        return PropertyGraphSchema(
            self._node_keys, self._rel_keys, self._patterns | set(patterns)
        )

    # -- accessors --------------------------------------------------------

    @property
    def labels(self) -> FrozenSet[str]:
        out: Set[str] = set()
        for combo in self._node_keys:
            out |= combo
        return frozenset(out)

    @property
    def label_combinations(self) -> FrozenSet[LabelCombo]:
        return frozenset(self._node_keys.keys())

    @property
    def relationship_types(self) -> FrozenSet[str]:
        return frozenset(self._rel_keys.keys())

    @property
    def schema_patterns(self) -> FrozenSet[SchemaPattern]:
        return frozenset(self._patterns)

    def combinations_for(self, labels: Iterable[str]) -> FrozenSet[LabelCombo]:
        """All stored combos that contain all the given labels."""
        want = frozenset(labels)
        return frozenset(c for c in self._node_keys if want <= c)

    def node_property_keys(self, combo: Iterable[str]) -> PropertyKeys:
        """Exact-combination property keys."""
        return dict(self._node_keys.get(frozenset(combo), {}))

    def node_property_keys_for_combinations(
        self, combos: Iterable[LabelCombo]
    ) -> PropertyKeys:
        out: Optional[PropertyKeys] = None
        for c in combos:
            keys = self._node_keys.get(frozenset(c), {})
            out = dict(keys) if out is None else _merge_keys(out, keys)
        return out or {}

    def node_property_keys_for_labels(self, labels: Iterable[str]) -> PropertyKeys:
        """Keys a node known to have (at least) ``labels`` may have."""
        return self.node_property_keys_for_combinations(self.combinations_for(labels))

    def relationship_property_keys(self, rel_type: str) -> PropertyKeys:
        return dict(self._rel_keys.get(rel_type, {}))

    def relationship_property_keys_for_types(self, types: Iterable[str]) -> PropertyKeys:
        ts = list(types) or list(self._rel_keys)
        out: Optional[PropertyKeys] = None
        for t in ts:
            keys = self._rel_keys.get(t, {})
            out = dict(keys) if out is None else _merge_keys(out, keys)
        return out or {}

    @property
    def implied_labels(self) -> Dict[str, FrozenSet[str]]:
        """label -> labels implied by it (present in every combo containing it).

        Reference: ``ImpliedLabels.scala``.
        """
        out: Dict[str, FrozenSet[str]] = {}
        for label in self.labels:
            combos = [c for c in self._node_keys if label in c]
            if combos:
                implied = frozenset.intersection(*combos) - {label}
                out[label] = implied
        return out

    # -- type helpers -----------------------------------------------------

    def node_type(self, *labels: str) -> T.CTNodeType:
        return T.CTNodeType(labels)

    def to_node_type(self, combo: LabelCombo) -> T.CTNodeType:
        return T.CTNodeType(combo)

    # -- combination -------------------------------------------------------

    def union(self, other: "PropertyGraphSchema") -> "PropertyGraphSchema":
        """Reference ``++`` (PropertyGraphSchema.scala join)."""
        nk = {k: dict(v) for k, v in self._node_keys.items()}
        for combo, keys in other._node_keys.items():
            nk[combo] = _merge_keys(nk[combo], keys) if combo in nk else dict(keys)
        rk = {k: dict(v) for k, v in self._rel_keys.items()}
        for t, keys in other._rel_keys.items():
            rk[t] = _merge_keys(rk[t], keys) if t in rk else dict(keys)
        return PropertyGraphSchema(nk, rk, self._patterns | other._patterns)

    __add__ = union

    def for_node(self, labels: Iterable[str]) -> "PropertyGraphSchema":
        """Restrict to combos matching a scan on ``labels``."""
        labels = frozenset(labels)
        combos = self.combinations_for(labels) if labels else self.label_combinations
        nk = {c: self._node_keys[c] for c in combos}
        return PropertyGraphSchema(nk, {}, set())

    def for_relationship(self, rel: T.CTRelationshipType) -> "PropertyGraphSchema":
        types = rel.types or self.relationship_types
        rk = {t: self._rel_keys[t] for t in types if t in self._rel_keys}
        return PropertyGraphSchema({}, rk, set())

    # -- equality / repr ---------------------------------------------------

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PropertyGraphSchema)
            and self._node_keys == other._node_keys
            and self._rel_keys == other._rel_keys
            and self._patterns == other._patterns
        )

    def __hash__(self) -> int:
        return hash(
            (
                frozenset((c, frozenset(k.items())) for c, k in self._node_keys.items()),
                frozenset((t, frozenset(k.items())) for t, k in self._rel_keys.items()),
                frozenset(self._patterns),
            )
        )

    def __repr__(self) -> str:
        lines = ["PropertyGraphSchema:"]
        for combo in sorted(self._node_keys, key=lambda c: sorted(c)):
            keys = ", ".join(
                f"{k}: {v!r}" for k, v in sorted(self._node_keys[combo].items())
            )
            lines.append(f"  (:{':'.join(sorted(combo)) or ''}) {{{keys}}}")
        for t in sorted(self._rel_keys):
            keys = ", ".join(f"{k}: {v!r}" for k, v in sorted(self._rel_keys[t].items()))
            lines.append(f"  [:{t}] {{{keys}}}")
        for p in sorted(self._patterns, key=repr):
            lines.append(f"  {p!r}")
        return "\n".join(lines)

    # -- JSON round trip (reference JsonSerialization) ---------------------

    def to_json(self) -> str:
        doc = {
            "version": 1,
            "nodes": [
                {
                    "labels": sorted(combo),
                    "properties": {k: repr(v) for k, v in keys.items()},
                }
                for combo, keys in sorted(
                    self._node_keys.items(), key=lambda kv: sorted(kv[0])
                )
            ],
            "relationships": [
                {
                    "type": t,
                    "properties": {k: repr(v) for k, v in keys.items()},
                }
                for t, keys in sorted(self._rel_keys.items())
            ],
            "patterns": [
                {
                    "sourceLabels": sorted(p.source_labels),
                    "relType": p.rel_type,
                    "targetLabels": sorted(p.target_labels),
                }
                for p in sorted(self._patterns, key=repr)
            ],
        }
        return json.dumps(doc, indent=2)

    @staticmethod
    def from_json(s: str) -> "PropertyGraphSchema":
        doc = json.loads(s)
        nk = {
            frozenset(n["labels"]): {
                k: T.parse_type(v) for k, v in n.get("properties", {}).items()
            }
            for n in doc.get("nodes", [])
        }
        rk = {
            r["type"]: {k: T.parse_type(v) for k, v in r.get("properties", {}).items()}
            for r in doc.get("relationships", [])
        }
        patterns = {
            SchemaPattern(p["sourceLabels"], p["relType"], p["targetLabels"])
            for p in doc.get("patterns", [])
        }
        return PropertyGraphSchema(nk, rk, patterns)
