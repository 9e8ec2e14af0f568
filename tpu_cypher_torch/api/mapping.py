"""Element mappings: table columns -> graph elements.

Re-design of the reference's ``ElementMapping`` builders
(``okapi-api/.../io/conversion/ElementMapping.scala:53``,
``NodeMappingBuilder``, ``RelationshipMappingBuilder``): declarative mapping
from a table's columns onto a node/relationship element — id column, implied
labels (or optional per-label boolean columns), start/end columns, property
key -> column renames — with validation."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

from .schema import PropertyGraphSchema
from .types import CypherType


class MappingError(Exception):
    pass


@dataclass(frozen=True)
class NodeMapping:
    id_key: str
    implied_labels: FrozenSet[str]
    optional_labels: Tuple[Tuple[str, str], ...] = ()  # (label, bool column)
    property_mapping: Tuple[Tuple[str, str], ...] = ()  # (property key, column)

    @property
    def all_columns(self) -> Tuple[str, ...]:
        return (
            (self.id_key,)
            + tuple(c for _, c in self.optional_labels)
            + tuple(c for _, c in self.property_mapping)
        )

    def pattern(self):
        from .graph_pattern import NodePattern
        from .types import CTNodeType

        return NodePattern(CTNodeType(frozenset(self.implied_labels)))


@dataclass(frozen=True)
class RelationshipMapping:
    id_key: str
    source_key: str
    target_key: str
    rel_type: str
    property_mapping: Tuple[Tuple[str, str], ...] = ()

    @property
    def all_columns(self) -> Tuple[str, ...]:
        return (self.id_key, self.source_key, self.target_key) + tuple(
            c for _, c in self.property_mapping
        )

    def pattern(self):
        from .graph_pattern import RelationshipPattern
        from .types import CTRelationshipType

        return RelationshipPattern(CTRelationshipType(frozenset({self.rel_type})))


class NodeMappingBuilder:
    """``NodeMappingBuilder.on("id").withImpliedLabel("Person")
    .withPropertyKey("name", "name_col").build()``"""

    def __init__(self, id_key: str):
        self._id = id_key
        self._implied: set = set()
        self._optional: Dict[str, str] = {}
        self._props: Dict[str, str] = {}

    @staticmethod
    def on(id_key: str) -> "NodeMappingBuilder":
        return NodeMappingBuilder(id_key)

    def with_implied_label(self, *labels: str) -> "NodeMappingBuilder":
        self._implied.update(labels)
        return self

    def with_optional_label(self, label: str, column: Optional[str] = None) -> "NodeMappingBuilder":
        self._optional[label] = column or label
        return self

    def with_property_key(self, key: str, column: Optional[str] = None) -> "NodeMappingBuilder":
        self._props[key] = column or key
        return self

    def with_property_keys(self, *keys: str) -> "NodeMappingBuilder":
        for k in keys:
            self.with_property_key(k)
        return self

    def build(self) -> NodeMapping:
        m = NodeMapping(
            self._id,
            frozenset(self._implied),
            tuple(sorted(self._optional.items())),
            tuple(sorted(self._props.items())),
        )
        validate_node_mapping(m)
        return m


class RelationshipMappingBuilder:
    def __init__(self, id_key: str):
        self._id = id_key
        self._source: Optional[str] = None
        self._target: Optional[str] = None
        self._type: Optional[str] = None
        self._props: Dict[str, str] = {}

    @staticmethod
    def on(id_key: str) -> "RelationshipMappingBuilder":
        return RelationshipMappingBuilder(id_key)

    def from_(self, source_key: str) -> "RelationshipMappingBuilder":
        self._source = source_key
        return self

    def to(self, target_key: str) -> "RelationshipMappingBuilder":
        self._target = target_key
        return self

    def with_relationship_type(self, rel_type: str) -> "RelationshipMappingBuilder":
        self._type = rel_type
        return self

    def with_property_key(self, key: str, column: Optional[str] = None) -> "RelationshipMappingBuilder":
        self._props[key] = column or key
        return self

    def with_property_keys(self, *keys: str) -> "RelationshipMappingBuilder":
        for k in keys:
            self.with_property_key(k)
        return self

    def build(self) -> RelationshipMapping:
        if self._source is None or self._target is None:
            raise MappingError("Relationship mapping requires from_() and to()")
        if not self._type:
            raise MappingError("Relationship mapping requires a relationship type")
        m = RelationshipMapping(
            self._id,
            self._source,
            self._target,
            self._type,
            tuple(sorted(self._props.items())),
        )
        validate_relationship_mapping(m)
        return m


def validate_node_mapping(m: NodeMapping):
    cols = list(m.all_columns)
    if len(set(cols)) != len(cols):
        raise MappingError(f"Duplicate columns in node mapping: {cols}")
    if not m.implied_labels and not m.optional_labels:
        raise MappingError("Node mapping requires at least one label")
    overlap = m.implied_labels & {l for l, _ in m.optional_labels}
    if overlap:
        raise MappingError(f"Labels both implied and optional: {overlap}")


def validate_relationship_mapping(m: RelationshipMapping):
    ids = {m.id_key, m.source_key, m.target_key}
    if len(ids) != 3:
        raise MappingError("id/source/target columns must be distinct")
    prop_cols = [c for _, c in m.property_mapping]
    if set(prop_cols) & ids:
        raise MappingError("Property columns overlap id/source/target columns")


# -- composite (stored-pattern) mappings ------------------------------------
#
# Reference: ``ElementMapping`` generalized over a ``Pattern``
# (``ElementMapping.scala:53`` + ``Pattern.scala:135-182``). A composite
# table stores several elements per row: NodeRel = a node plus one of its
# outgoing relationships; Triplet = (source node, relationship, target node).


@dataclass(frozen=True)
class NodeRelMapping:
    """One table row = one (node, outgoing relationship) pair."""

    node: NodeMapping
    relationship: RelationshipMapping

    @property
    def all_columns(self) -> Tuple[str, ...]:
        seen = dict.fromkeys(self.node.all_columns + self.relationship.all_columns)
        return tuple(seen)

    def pattern(self):
        from .graph_pattern import NodeRelPattern
        from .types import CTNodeType, CTRelationshipType

        return NodeRelPattern(
            CTNodeType(frozenset(self.node.implied_labels)),
            CTRelationshipType(frozenset({self.relationship.rel_type})),
        )


@dataclass(frozen=True)
class TripletMapping:
    """One table row = one full (source)-[rel]->(target) triplet."""

    source: NodeMapping
    relationship: RelationshipMapping
    target: NodeMapping

    @property
    def all_columns(self) -> Tuple[str, ...]:
        seen = dict.fromkeys(
            self.source.all_columns
            + self.relationship.all_columns
            + self.target.all_columns
        )
        return tuple(seen)

    def pattern(self):
        from .graph_pattern import TripletPattern
        from .types import CTNodeType, CTRelationshipType

        return TripletPattern(
            CTNodeType(frozenset(self.source.implied_labels)),
            CTRelationshipType(frozenset({self.relationship.rel_type})),
            CTNodeType(frozenset(self.target.implied_labels)),
        )


def validate_node_rel_mapping(m: NodeRelMapping):
    if m.relationship.source_key != m.node.id_key:
        raise MappingError(
            "NodeRel mapping: the relationship's source column must be the "
            f"node id column ({m.relationship.source_key!r} != {m.node.id_key!r})"
        )


def validate_triplet_mapping(m: TripletMapping):
    if m.relationship.source_key != m.source.id_key:
        raise MappingError(
            "Triplet mapping: relationship source column must be the source "
            f"node id column ({m.relationship.source_key!r} != {m.source.id_key!r})"
        )
    if m.relationship.target_key != m.target.id_key:
        raise MappingError(
            "Triplet mapping: relationship target column must be the target "
            f"node id column ({m.relationship.target_key!r} != {m.target.id_key!r})"
        )
    if m.source.id_key == m.target.id_key:
        raise MappingError("Triplet mapping: source and target id columns collide")


def node_rel_mapping(node: NodeMapping, relationship: RelationshipMapping) -> NodeRelMapping:
    m = NodeRelMapping(node, relationship)
    validate_node_rel_mapping(m)
    return m


def triplet_mapping(
    source: NodeMapping, relationship: RelationshipMapping, target: NodeMapping
) -> TripletMapping:
    m = TripletMapping(source, relationship, target)
    validate_triplet_mapping(m)
    return m
