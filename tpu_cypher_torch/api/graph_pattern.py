"""Stored-pattern vocabulary: the scan shapes a graph can answer.

Re-design of the reference's ``Pattern`` family
(``okapi-api/.../api/graph/Pattern.scala:135-182``): a graph's element
tables may store composite patterns — a node co-stored with its outgoing
relationships (``NodeRelPattern``) or a full (source, rel, target) triplet
(``TripletPattern``) — and ``find_mapping`` embeds a search pattern into a
stored one (same shape; each search element type a supertype of the stored
element type, or equal under ``exact``). The logical optimizer uses this to
collapse Expand cascades into single ``PatternScan``s
(``LogicalOptimizer.scala:67``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from . import types as T

# canonical entity names inside a stored pattern (reference DEFAULT_NODE_NAME
# / "source_"/"target_" prefixes, Pattern.scala:135-182)
NODE_ENTITY = "node"
REL_ENTITY = "rel"
SOURCE_ENTITY = "source_node"
TARGET_ENTITY = "target_node"


def _node_subtype(search: T.CTNodeType, stored: T.CTNodeType) -> bool:
    """search ⊒ stored: every stored row satisfies the search type — i.e.
    the search label set is a subset of the stored labels."""
    return frozenset(search.labels) <= frozenset(stored.labels)


def _rel_subtype(search: T.CTRelationshipType, stored: T.CTRelationshipType) -> bool:
    if not search.types:  # untyped search matches any stored types
        return True
    if not stored.types:  # stored any-type cannot be guaranteed to satisfy
        return False
    return frozenset(stored.types) <= frozenset(search.types)


@dataclass(frozen=True)
class GraphPattern:
    """Base class; subclasses define ``entities`` (name -> CypherType)."""

    def entities(self) -> Dict[str, T.CypherType]:
        raise NotImplementedError

    def find_mapping(
        self, search: "GraphPattern", exact: bool = False
    ) -> Optional[Dict[str, str]]:
        """Embed ``search`` into this STORED pattern: same shape, pairwise
        type embedding. Returns {search entity -> stored entity} or None
        (reference ``Pattern.findMapping``)."""
        if type(search) is not type(self):
            return None
        pairs = list(zip(search.entities().items(), self.entities().items()))
        for (sn, st), (on, ot) in pairs:
            if exact:
                if st != ot:
                    return None
            elif isinstance(st, T.CTNodeType) and isinstance(ot, T.CTNodeType):
                if not _node_subtype(st, ot):
                    return None
            elif isinstance(st, T.CTRelationshipType) and isinstance(
                ot, T.CTRelationshipType
            ):
                if not _rel_subtype(st, ot):
                    return None
            else:
                return None
        return {sn: on for (sn, _), (on, _) in pairs}


@dataclass(frozen=True)
class NodePattern(GraphPattern):
    node_type: T.CTNodeType

    def entities(self) -> Dict[str, T.CypherType]:
        return {NODE_ENTITY: self.node_type}


@dataclass(frozen=True)
class RelationshipPattern(GraphPattern):
    rel_type: T.CTRelationshipType

    def entities(self) -> Dict[str, T.CypherType]:
        return {REL_ENTITY: self.rel_type}


@dataclass(frozen=True)
class NodeRelPattern(GraphPattern):
    """A node co-stored with one of its OUTGOING relationships."""

    node_type: T.CTNodeType
    rel_type: T.CTRelationshipType

    def entities(self) -> Dict[str, T.CypherType]:
        return {NODE_ENTITY: self.node_type, REL_ENTITY: self.rel_type}


@dataclass(frozen=True)
class TripletPattern(GraphPattern):
    """(source)-[rel]->(target) stored in one table."""

    source_type: T.CTNodeType
    rel_type: T.CTRelationshipType
    target_type: T.CTNodeType

    def entities(self) -> Dict[str, T.CypherType]:
        return {
            SOURCE_ENTITY: self.source_type,
            REL_ENTITY: self.rel_type,
            TARGET_ENTITY: self.target_type,
        }
