"""Graph DDL semantic model.

Re-design of the reference resolver (``graph-ddl/.../GraphDdl.scala:42-673``):
resolves element-type inheritance (EXTENDS) with cycle detection, merges
property declarations (conflicting types are an error), expands node/relationship
types to label sets, and attaches view mappings. The resulting
:class:`GraphDdl` exposes, per graph, a
:class:`~tpu_cypher_torch.api.schema.PropertyGraphSchema` plus node/edge view
mappings that an ingestion layer (``tpu_cypher_torch.io.sql``) turns into
device-resident scan graphs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..api import types as T
from ..api.schema import PropertyGraphSchema, SchemaPattern
from . import ddl_ast as A
from .parser import parse_ddl


class GraphDdlError(Exception):
    """Semantic error in a DDL script (reference ``GraphDdlException.scala``)."""


def _duplicate(kind: str, name) -> "GraphDdlError":
    return GraphDdlError(f"Duplicate {kind}: {name}")


def _unresolved(kind: str, name, known: Sequence[str] = ()) -> "GraphDdlError":
    hint = f"; known: {sorted(known)}" if known else ""
    return GraphDdlError(f"Unresolved {kind}: {name}{hint}")


# ---------------------------------------------------------------------------
# resolved model vocabulary (reference GraphDdl.scala:447-673)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViewId:
    """A fully / partially qualified view name plus the ambient SET SCHEMA
    (reference ``ViewId`` in ``GraphDdl.scala``)."""

    set_schema: Optional[Tuple[str, str]]  # (dataSource, schema)
    parts: Tuple[str, ...]

    @property
    def data_source(self) -> str:
        return self.resolved[0]

    @property
    def schema(self) -> str:
        return self.resolved[1]

    @property
    def table_name(self) -> str:
        return self.resolved[2]

    @property
    def resolved(self) -> Tuple[str, str, str]:
        if len(self.parts) == 3:
            return (self.parts[0], self.parts[1], self.parts[2])
        if self.set_schema is None:
            raise GraphDdlError(
                f"Relative view name {'.'.join(self.parts)!r} requires a "
                "SET SCHEMA statement or a fully qualified name "
                "(dataSource.schema.view)"
            )
        ds, schema = self.set_schema
        if len(self.parts) == 1:
            return (ds, schema, self.parts[0])
        return (ds, self.parts[0], self.parts[1])

    def __str__(self) -> str:
        return ".".join(self.resolved)


@dataclass(frozen=True)
class ElementType:
    """A resolved element type (reference ``ElementType`` in ``GraphDdl.scala``)."""

    name: str
    parents: FrozenSet[str] = frozenset()
    properties: Tuple[Tuple[str, T.CypherType], ...] = ()
    key: Optional[Tuple[str, Tuple[str, ...]]] = None

    @property
    def property_map(self) -> Dict[str, T.CypherType]:
        return dict(self.properties)


@dataclass(frozen=True)
class NodeType:
    """A node type = a label combination (reference ``NodeType``)."""

    labels: FrozenSet[str]

    @staticmethod
    def of(*labels: str) -> "NodeType":
        return NodeType(frozenset(labels))

    def __str__(self) -> str:
        return f"({','.join(sorted(self.labels))})"


@dataclass(frozen=True)
class RelationshipType:
    """A typed relationship between node types (reference ``RelationshipType``)."""

    start_node_type: NodeType
    labels: FrozenSet[str]
    end_node_type: NodeType

    @staticmethod
    def of(start: str, label: str, end: str) -> "RelationshipType":
        return RelationshipType(NodeType.of(start), frozenset({label}), NodeType.of(end))

    def __str__(self) -> str:
        return (
            f"{self.start_node_type}-[{','.join(sorted(self.labels))}]->"
            f"{self.end_node_type}"
        )


@dataclass(frozen=True)
class Join:
    """One equi-join column pair: node-view column = edge-view column
    (reference ``Join`` in ``GraphDdl.scala:383``)."""

    node_column: str
    edge_column: str


@dataclass(frozen=True)
class NodeViewKey:
    node_type: NodeType
    view_id: ViewId

    def __str__(self) -> str:
        return f"node {self.node_type} from {self.view_id}"


@dataclass(frozen=True)
class EdgeViewKey:
    rel_type: RelationshipType
    view_id: ViewId

    def __str__(self) -> str:
        return f"relationship {self.rel_type} from {self.view_id}"


@dataclass(frozen=True)
class NodeToViewMapping:
    node_type: NodeType
    view: ViewId
    property_mappings: Tuple[Tuple[str, str], ...]  # property -> column

    @property
    def key(self) -> NodeViewKey:
        return NodeViewKey(self.node_type, self.view)


@dataclass(frozen=True)
class StartNode:
    node_view_key: NodeViewKey
    join_predicates: Tuple[Join, ...]


@dataclass(frozen=True)
class EndNode:
    node_view_key: NodeViewKey
    join_predicates: Tuple[Join, ...]


@dataclass(frozen=True)
class EdgeToViewMapping:
    rel_type: RelationshipType
    view: ViewId
    start_node: StartNode
    end_node: EndNode
    property_mappings: Tuple[Tuple[str, str], ...]  # property -> column

    @property
    def key(self) -> EdgeViewKey:
        return EdgeViewKey(self.rel_type, self.view)


# ---------------------------------------------------------------------------
# graph type (resolved schema-level info)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GraphType:
    """Resolved element/node/relationship types of a graph (type)
    (reference ``GraphType`` in ``GraphDdl.scala:464-530``)."""

    name: str
    element_types: Tuple[ElementType, ...] = ()
    node_types: Tuple[NodeType, ...] = ()
    rel_types: Tuple[RelationshipType, ...] = ()

    @property
    def element_types_by_name(self) -> Dict[str, ElementType]:
        return {e.name: e for e in self.element_types}

    def node_property_keys(self, node_type: NodeType) -> Dict[str, T.CypherType]:
        return self._merged_properties(node_type.labels)

    def rel_property_keys(self, rel_type: RelationshipType) -> Dict[str, T.CypherType]:
        return self._merged_properties(rel_type.labels)

    def _merged_properties(self, labels: FrozenSet[str]) -> Dict[str, T.CypherType]:
        by_name = self.element_types_by_name
        merged: Dict[str, T.CypherType] = {}
        for label in sorted(labels):
            et = by_name.get(label)
            if et is None:
                raise _unresolved("element type", label, by_name)
            for k, v in et.properties:
                if k in merged and merged[k] != v:
                    raise GraphDdlError(
                        f"Property {k!r} declared with conflicting types "
                        f"{merged[k]} and {v} across {sorted(labels)}"
                    )
                merged[k] = v
        return merged

    def to_schema(self) -> PropertyGraphSchema:
        """Lower to the session-level property-graph schema
        (reference ``GraphType.asOkapiSchema``)."""
        s = PropertyGraphSchema.empty()
        for nt in self.node_types:
            s = s.with_node_combination(nt.labels, self.node_property_keys(nt))
        patterns = []
        for rt in self.rel_types:
            if len(rt.labels) != 1:
                raise GraphDdlError(
                    f"Relationship type must have exactly one label: {rt}"
                )
            (label,) = rt.labels
            s = s.with_relationship_type(label, self.rel_property_keys(rt))
            patterns.append(
                SchemaPattern(rt.start_node_type.labels, label, rt.end_node_type.labels)
            )
        if patterns:
            s = s.with_schema_patterns(*patterns)
        return s


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


class _PartialGraphType:
    """Accumulates element/node/rel type definitions while resolving EXTENDS
    (reference ``PartialGraphType``, ``GraphDdl.scala:152-273``)."""

    def __init__(self, name: str, element_types: Dict[str, A.ElementTypeDefinition]):
        self.name = name
        self.element_types = element_types
        self.node_defs: List[A.NodeTypeDefinition] = []
        self.rel_defs: List[A.RelationshipTypeDefinition] = []

    def push(self, name: str, statements: Sequence[object]) -> "_PartialGraphType":
        local: Dict[str, A.ElementTypeDefinition] = {}
        for st in statements:
            if isinstance(st, A.ElementTypeDefinition):
                if st.name in local:
                    raise _duplicate("element type", st.name)
                local[st.name] = st
        merged = dict(self.element_types)
        merged.update(local)  # local shadows global
        out = _PartialGraphType(name, merged)
        out.node_defs = list(self.node_defs)
        out.rel_defs = list(self.rel_defs)
        for st in statements:
            if isinstance(st, A.NodeTypeDefinition):
                out.node_defs.append(st)
            elif isinstance(st, A.RelationshipTypeDefinition):
                out.rel_defs.append(st)
        return out

    # -- element-type resolution ------------------------------------------

    def _resolve_one(self, name: str) -> A.ElementTypeDefinition:
        et = self.element_types.get(name)
        if et is None:
            raise _unresolved("element type", name, self.element_types)
        return et

    def _expand(self, name: str, path: Tuple[str, ...] = ()) -> List[A.ElementTypeDefinition]:
        """The element type plus all transitive parents; cycle-checked
        (reference ``resolveElementTypes``/``detectCircularDependency``)."""
        if name in path:
            cyc = " -> ".join(path + (name,))
            raise GraphDdlError(f"Circular element type inheritance: {cyc}")
        et = self._resolve_one(name)
        out = [et]
        for p in sorted(et.parents):
            out.extend(self._expand(p, path + (name,)))
        # de-dup preserving first occurrence
        seen = set()
        uniq = []
        for e in out:
            if e.name not in seen:
                seen.add(e.name)
                uniq.append(e)
        return uniq

    def resolve_labels(self, nt: A.NodeTypeDefinition) -> FrozenSet[str]:
        labels: set = set()
        for name in nt.element_types:
            labels.update(e.name for e in self._expand(name))
        return frozenset(labels)

    def to_node_type(self, nt: A.NodeTypeDefinition) -> NodeType:
        return NodeType(self.resolve_labels(nt))

    def to_rel_type(self, rt: A.RelationshipTypeDefinition) -> RelationshipType:
        labels: set = set()
        for name in rt.element_types:
            labels.update(e.name for e in self._expand(name))
        return RelationshipType(
            self.to_node_type(rt.start_node_type),
            frozenset(labels),
            self.to_node_type(rt.end_node_type),
        )

    def to_graph_type(self) -> GraphType:
        node_types = _distinct(self.to_node_type(n) for n in self.node_defs)
        rel_types = _distinct(self.to_rel_type(r) for r in self.rel_defs)
        # the element types actually referenced (with their parents), resolved
        # with merged properties
        needed: Dict[str, ElementType] = {}

        def add(name: str):
            for et in self._expand(name):
                if et.name not in needed:
                    merged = self._merge_inherited(et.name)
                    needed[et.name] = ElementType(
                        name=et.name,
                        parents=frozenset(et.parents),
                        properties=tuple(sorted(merged.items())),
                        key=(et.key[0], et.key[1]) if et.key else None,
                    )

        for nt in node_types:
            for label in nt.labels:
                add(label)
        for rt in rel_types:
            for label in rt.labels:
                add(label)
        return GraphType(
            self.name,
            tuple(needed[k] for k in sorted(needed)),
            tuple(node_types),
            tuple(rel_types),
        )

    def _merge_inherited(self, name: str) -> Dict[str, T.CypherType]:
        """An element type's own + inherited properties
        (reference ``mergeProperties``, ``GraphDdl.scala:237``)."""
        merged: Dict[str, T.CypherType] = {}
        for et in self._expand(name):
            for k, v in et.properties:
                if k in merged and merged[k] != v:
                    raise GraphDdlError(
                        f"Property {k!r} of element type {name!r} inherited with "
                        f"conflicting types {merged[k]} and {v}"
                    )
                merged[k] = v
        return merged


def _distinct(items) -> List:
    seen = set()
    out = []
    for it in items:
        if it not in seen:
            seen.add(it)
            out.append(it)
    return out


@dataclass(frozen=True)
class Graph:
    """A resolved graph: type + view mappings (reference ``Graph`` in
    ``GraphDdl.scala:451-462``)."""

    name: str
    graph_type: GraphType
    node_to_view_mappings: Tuple[NodeToViewMapping, ...] = ()
    edge_to_view_mappings: Tuple[EdgeToViewMapping, ...] = ()

    def node_id_columns_for(self, key: NodeViewKey) -> Optional[Tuple[str, ...]]:
        """The node-view columns that identify a node of this view — the join
        columns of the first edge mapping referencing it (reference
        ``Graph.nodeIdColumnsFor``, ``GraphDdl.scala:458``)."""
        for evm in self.edge_to_view_mappings:
            if evm.start_node.node_view_key == key:
                return tuple(j.node_column for j in evm.start_node.join_predicates)
            if evm.end_node.node_view_key == key:
                return tuple(j.node_column for j in evm.end_node.join_predicates)
        return None

    @property
    def schema(self) -> PropertyGraphSchema:
        return self.graph_type.to_schema()


@dataclass(frozen=True)
class GraphDdl:
    """The resolved result of a whole DDL script (reference ``GraphDdl`` in
    ``GraphDdl.scala:447``)."""

    graphs: Dict[str, Graph] = field(default_factory=dict)

    @staticmethod
    def parse(ddl_text: str) -> "GraphDdl":
        return resolve_ddl(parse_ddl(ddl_text))

    def union(self, other: "GraphDdl") -> "GraphDdl":
        merged = dict(self.graphs)
        merged.update(other.graphs)
        return GraphDdl(merged)


# ---------------------------------------------------------------------------
# top-level resolver
# ---------------------------------------------------------------------------


def resolve_ddl(ddl: A.DdlDefinition) -> GraphDdl:
    """AST → resolved model (reference ``GraphDdl.apply``, ``GraphDdl.scala:52``)."""
    set_schema: Optional[Tuple[str, str]] = None
    global_types: Dict[str, A.ElementTypeDefinition] = {}
    graph_types: Dict[str, Tuple[object, ...]] = {}
    graphs: Dict[str, Graph] = {}

    for st in ddl.statements:
        if isinstance(st, A.SetSchemaDefinition):
            set_schema = (st.data_source, st.schema)
        elif isinstance(st, A.ElementTypeDefinition):
            if st.name in global_types:
                raise _duplicate("element type", st.name)
            global_types[st.name] = st
        elif isinstance(st, A.GraphTypeDefinition):
            if st.name in graph_types:
                raise _duplicate("graph type", st.name)
            graph_types[st.name] = st.statements
        elif isinstance(st, A.GraphDefinition):
            if st.name in graphs:
                raise _duplicate("graph", st.name)
            graphs[st.name] = _resolve_graph(
                st, set_schema, global_types, graph_types
            )
        else:
            raise GraphDdlError(f"Unexpected top-level statement: {st!r}")
    return GraphDdl(graphs)


def _resolve_graph(
    gd: A.GraphDefinition,
    set_schema: Optional[Tuple[str, str]],
    global_types: Dict[str, A.ElementTypeDefinition],
    graph_types: Dict[str, Tuple[object, ...]],
) -> Graph:
    partial = _PartialGraphType("", dict(global_types))
    if gd.graph_type_name is not None:
        stmts = graph_types.get(gd.graph_type_name)
        if stmts is None:
            raise _unresolved("graph type", gd.graph_type_name, graph_types)
        partial = partial.push(gd.graph_type_name, stmts)

    type_stmts = [
        s
        for s in gd.statements
        if isinstance(
            s,
            (A.ElementTypeDefinition, A.NodeTypeDefinition, A.RelationshipTypeDefinition),
        )
    ]
    # node/rel types referenced only via mappings are declared implicitly
    for s in gd.statements:
        if isinstance(s, A.NodeMappingDefinition):
            type_stmts.append(s.node_type)
        elif isinstance(s, A.RelationshipMappingDefinition):
            type_stmts.append(s.rel_type)
            type_stmts.append(s.rel_type.start_node_type)
            type_stmts.append(s.rel_type.end_node_type)
    partial = partial.push(gd.name, type_stmts)
    graph_type = partial.to_graph_type()

    node_mappings: List[NodeToViewMapping] = []
    seen_node_keys: set = set()
    for s in gd.statements:
        if not isinstance(s, A.NodeMappingDefinition):
            continue
        node_type = partial.to_node_type(s.node_type)
        props = graph_type.node_property_keys(node_type)
        for ntv in s.node_to_view:
            vid = ViewId(set_schema, ntv.view_id)
            mapping = _property_mappings(props, ntv.property_mapping)
            nvm = NodeToViewMapping(node_type, vid, mapping)
            if nvm.key in seen_node_keys:
                raise _duplicate("node mapping", str(nvm.key))
            seen_node_keys.add(nvm.key)
            node_mappings.append(nvm)
    by_key = {m.key: m for m in node_mappings}

    edge_mappings: List[EdgeToViewMapping] = []
    seen_edge_keys: set = set()
    for s in gd.statements:
        if not isinstance(s, A.RelationshipMappingDefinition):
            continue
        rel_type = partial.to_rel_type(s.rel_type)
        props = graph_type.rel_property_keys(rel_type)
        for rtv in s.rel_type_to_view:
            vid = ViewId(set_schema, rtv.view_def.view_id)
            edge_alias = rtv.view_def.alias
            start = _resolve_endpoint(
                rtv.start_node, partial, set_schema, by_key, edge_alias, "START"
            )
            end = _resolve_endpoint(
                rtv.end_node, partial, set_schema, by_key, edge_alias, "END"
            )
            evm = EdgeToViewMapping(
                rel_type=rel_type,
                view=vid,
                start_node=StartNode(*start),
                end_node=EndNode(*end),
                property_mappings=_property_mappings(props, rtv.property_mapping),
            )
            if evm.key in seen_edge_keys:
                raise _duplicate("relationship mapping", str(evm.key))
            seen_edge_keys.add(evm.key)
            edge_mappings.append(evm)

    return Graph(gd.name, graph_type, tuple(node_mappings), tuple(edge_mappings))


def _resolve_endpoint(
    ntv: A.NodeTypeToViewDefinition,
    partial: _PartialGraphType,
    set_schema: Optional[Tuple[str, str]],
    node_mappings_by_key: Dict[NodeViewKey, NodeToViewMapping],
    edge_alias: str,
    side: str,
) -> Tuple[NodeViewKey, Tuple[Join, ...]]:
    node_type = partial.to_node_type(ntv.node_type)
    vid = ViewId(set_schema, ntv.view_def.view_id)
    key = NodeViewKey(node_type, vid)
    if key not in node_mappings_by_key:
        raise _unresolved(
            f"{side} node view", str(key), [str(k) for k in node_mappings_by_key]
        )
    node_alias = ntv.view_def.alias
    joins: List[Join] = []
    for lhs, rhs in ntv.join_on.join_predicates:
        joins.append(_to_join(node_alias, edge_alias, lhs, rhs))
    return key, tuple(joins)


def _to_join(
    node_alias: str, edge_alias: str, lhs: Tuple[str, ...], rhs: Tuple[str, ...]
) -> Join:
    """Orient a join predicate by alias (reference ``toJoin``,
    ``GraphDdl.scala:383-396``)."""

    def split(col: Tuple[str, ...]) -> Tuple[str, str]:
        return col[0], ".".join(col[1:])

    la, lc = split(lhs)
    ra, rc = split(rhs)
    if la == node_alias and ra == edge_alias:
        return Join(node_column=lc, edge_column=rc)
    if la == edge_alias and ra == node_alias:
        return Join(node_column=rc, edge_column=lc)
    raise GraphDdlError(
        f"Join predicate {'.'.join(lhs)} = {'.'.join(rhs)} must relate the "
        f"node view alias {node_alias!r} and the edge view alias {edge_alias!r}"
    )


def _property_mappings(
    declared: Dict[str, T.CypherType],
    explicit: Optional[Tuple[Tuple[str, str], ...]],
) -> Tuple[Tuple[str, str], ...]:
    """Explicit ``column AS property`` pairs, defaulting unmapped properties to
    identically-named columns (reference ``toPropertyMappings``,
    ``GraphDdl.scala:398-413``)."""
    out: Dict[str, str] = {}
    explicit_map = dict(explicit or ())
    for prop in explicit_map:
        if prop not in declared:
            raise _unresolved("property", prop, declared)
    for prop in declared:
        out[prop] = explicit_map.get(prop, prop)
    return tuple(sorted(out.items()))
