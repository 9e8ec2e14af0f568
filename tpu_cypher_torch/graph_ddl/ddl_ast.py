"""Graph DDL abstract syntax.

Mirrors the reference AST vocabulary (``graph-ddl/.../GraphDdlAst.scala:33-139``)
as plain frozen dataclasses; tree rewriting is not needed for DDL, so these do
not participate in the TreeNode substrate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..api import types as T

# a property declaration: name -> CypherType
Property = Tuple[str, T.CypherType]
# KEY <name> (col1, col2, ...)
KeyDefinition = Tuple[str, Tuple[str, ...]]
# dotted column identifier, e.g. ("view_alias", "column")
ColumnIdentifier = Tuple[str, ...]


@dataclass(frozen=True)
class SetSchemaDefinition:
    """``SET SCHEMA dataSource.schema`` (reference ``GraphDdlAst.scala:53``)."""

    data_source: str
    schema: str


@dataclass(frozen=True)
class ElementTypeDefinition:
    """``Name EXTENDS A, B ( prop TYPE, ... ) KEY k (col, ...)``
    (reference ``GraphDdlAst.scala:58``)."""

    name: str
    parents: Tuple[str, ...] = ()
    properties: Tuple[Property, ...] = ()
    key: Optional[KeyDefinition] = None

    @property
    def property_map(self) -> Dict[str, T.CypherType]:
        return dict(self.properties)


@dataclass(frozen=True)
class NodeTypeDefinition:
    """``(A, B)`` (reference ``GraphDdlAst.scala:80``)."""

    element_types: Tuple[str, ...]

    def __str__(self) -> str:
        return f"({','.join(self.element_types)})"


@dataclass(frozen=True)
class RelationshipTypeDefinition:
    """``(A)-[R]->(B)`` (reference ``GraphDdlAst.scala:95``)."""

    start_node_type: NodeTypeDefinition
    element_types: Tuple[str, ...]
    end_node_type: NodeTypeDefinition

    def __str__(self) -> str:
        return (
            f"{self.start_node_type}-[{','.join(self.element_types)}]->"
            f"{self.end_node_type}"
        )


@dataclass(frozen=True)
class GraphTypeDefinition:
    """``CREATE GRAPH TYPE name ( ... )`` (reference ``GraphDdlAst.scala:65``)."""

    name: str
    statements: Tuple[object, ...] = ()


@dataclass(frozen=True)
class ViewDefinition:
    """``view.id alias`` (reference ``GraphDdlAst.scala:117``)."""

    view_id: Tuple[str, ...]
    alias: str


@dataclass(frozen=True)
class JoinOnDefinition:
    """``JOIN ON a.x = b.y AND ...`` (reference ``GraphDdlAst.scala:120``)."""

    join_predicates: Tuple[Tuple[ColumnIdentifier, ColumnIdentifier], ...]


@dataclass(frozen=True)
class NodeToViewDefinition:
    """``FROM view (col AS prop, ...)`` (reference ``GraphDdlAst.scala:105``)."""

    view_id: Tuple[str, ...]
    property_mapping: Optional[Tuple[Tuple[str, str], ...]] = None  # prop -> column


@dataclass(frozen=True)
class NodeMappingDefinition:
    """``(A) FROM v1 (...), FROM v2 (...)`` (reference ``GraphDdlAst.scala:111``)."""

    node_type: NodeTypeDefinition
    node_to_view: Tuple[NodeToViewDefinition, ...] = ()


@dataclass(frozen=True)
class NodeTypeToViewDefinition:
    """``(A) FROM view alias JOIN ON ...`` (reference ``GraphDdlAst.scala:122``)."""

    node_type: NodeTypeDefinition
    view_def: ViewDefinition
    join_on: JoinOnDefinition


@dataclass(frozen=True)
class RelationshipTypeToViewDefinition:
    """``FROM view alias (cols) START NODES ... END NODES ...``
    (reference ``GraphDdlAst.scala:128``)."""

    view_def: ViewDefinition
    property_mapping: Optional[Tuple[Tuple[str, str], ...]]
    start_node: NodeTypeToViewDefinition
    end_node: NodeTypeToViewDefinition


@dataclass(frozen=True)
class RelationshipMappingDefinition:
    """``(A)-[R]->(B) FROM ...`` (reference ``GraphDdlAst.scala:135``)."""

    rel_type: RelationshipTypeDefinition
    rel_type_to_view: Tuple[RelationshipTypeToViewDefinition, ...] = ()


@dataclass(frozen=True)
class GraphDefinition:
    """``CREATE GRAPH name OF type ( ... )`` (reference ``GraphDdlAst.scala:71``)."""

    name: str
    graph_type_name: Optional[str] = None
    statements: Tuple[object, ...] = ()


@dataclass(frozen=True)
class DdlDefinition:
    """A whole DDL script (reference ``GraphDdlAst.scala:45``)."""

    statements: Tuple[object, ...] = field(default_factory=tuple)
