"""Graph DDL: declare property-graph types and map existing SQL-style tables
("views") onto property graphs.

The port's copy of the JAX package's ``graph_ddl/`` (itself a re-design of
the reference ``graph-ddl/`` module
(``GraphDdlAst.scala``, ``GraphDdlParser.scala:60``, ``GraphDdl.scala:38``)):
a pure-Python recursive-descent parser (replacing fastparse) and a semantic
model that resolves element-type inheritance into a
:class:`~tpu_cypher_torch.api.schema.PropertyGraphSchema` plus per-view element
mappings, feeding host-table ingestion into device-resident scan graphs. Pure
Python: nothing here touches a device.
"""

from .ddl_ast import (
    DdlDefinition,
    ElementTypeDefinition,
    GraphDefinition,
    GraphTypeDefinition,
    JoinOnDefinition,
    NodeMappingDefinition,
    NodeToViewDefinition,
    NodeTypeDefinition,
    NodeTypeToViewDefinition,
    RelationshipMappingDefinition,
    RelationshipTypeDefinition,
    RelationshipTypeToViewDefinition,
    SetSchemaDefinition,
    ViewDefinition,
)
from .model import (
    EdgeToViewMapping,
    EdgeViewKey,
    ElementType,
    Graph,
    GraphDdl,
    GraphDdlError,
    GraphType,
    Join,
    NodeToViewMapping,
    NodeType,
    NodeViewKey,
    RelationshipType,
    ViewId,
)
from .parser import GraphDdlParseError, parse_ddl

__all__ = [
    "DdlDefinition",
    "EdgeToViewMapping",
    "EdgeViewKey",
    "ElementType",
    "ElementTypeDefinition",
    "Graph",
    "GraphDdl",
    "GraphDdlError",
    "GraphDdlParseError",
    "GraphDefinition",
    "GraphType",
    "GraphTypeDefinition",
    "Join",
    "JoinOnDefinition",
    "NodeMappingDefinition",
    "NodeToViewDefinition",
    "NodeToViewMapping",
    "NodeType",
    "NodeTypeDefinition",
    "NodeTypeToViewDefinition",
    "NodeViewKey",
    "RelationshipMappingDefinition",
    "RelationshipType",
    "RelationshipTypeDefinition",
    "RelationshipTypeToViewDefinition",
    "SetSchemaDefinition",
    "ViewDefinition",
    "ViewId",
    "parse_ddl",
]
