"""Relational property-graph implementations.

Re-design of the reference's graph implementations
(``okapi-relational/.../impl/graph/*.scala``): ``ScanGraph`` (a sequence of
element tables; ``scanOperator`` selects matching scans, aligns their headers
to the target and unions them — ``ScanGraph.scala:59-110``), ``UnionGraph``
(members get a distinct id prefix then scans union — ``UnionGraph``/
``PrefixedGraph``), and ``EmptyGraph``. Element tables pair a backend Table
with an ``ElementMapping`` (``api/io/ElementTable.scala:43``)."""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..api import types as T
from ..api.graph_pattern import GraphPattern
from ..api.mapping import (
    NodeMapping,
    NodeRelMapping,
    RelationshipMapping,
    TripletMapping,
)
from ..api.schema import PropertyGraphSchema
from ..api.table import Table
from ..ir import expr as E
from .header import (
    RecordHeader,
    header_for_node,
    header_for_relationship,
)
from .ops import (
    EmptyRecordsOp,
    RelationalOperator,
    RelationalRuntimeContext,
    TableOp,
    UnionAllOp,
)

ElementMappingT = Union[
    NodeMapping, RelationshipMapping, NodeRelMapping, TripletMapping
]


def _element_alignment(m, e: E.Expr, col: str, pairs, consts) -> None:
    """Dispatch ONE target header expression for ONE element mapping onto
    (source column -> target column) pairs or constant columns — the single
    copy of the alignment rules shared by node scans, relationship scans and
    composite pattern scans (reference ``RelationalPlanner.alignWith``)."""
    if isinstance(e, E.Id):
        pairs.append((m.id_key, col))
    elif isinstance(e, E.StartNode):
        pairs.append((m.source_key, col))
    elif isinstance(e, E.EndNode):
        pairs.append((m.target_key, col))
    elif isinstance(e, E.HasType):
        consts.append((E.Lit(e.rel_type == m.rel_type), col))
    elif isinstance(e, E.HasLabel):
        opt = dict(m.optional_labels)
        if e.label in m.implied_labels:
            consts.append((E.Lit(True), col))
        elif e.label in opt:
            pairs.append((opt[e.label], col))
        else:
            consts.append((E.Lit(False), col))
    elif isinstance(e, E.Property):
        props = dict(m.property_mapping)
        if e.key in props:
            pairs.append((props[e.key], col))
        else:
            consts.append((E.Lit(None), col))


class ElementTable:
    """A backend table + mapping describing how its columns form elements."""

    def __init__(self, mapping: ElementMappingT, table: Table):
        self.mapping = mapping
        self.table = table
        missing = [c for c in mapping.all_columns if c not in table.physical_columns]
        if missing:
            raise ValueError(
                f"Mapping references missing columns {missing}; table has "
                f"{table.physical_columns}"
            )

    @property
    def is_node(self) -> bool:
        return isinstance(self.mapping, NodeMapping)

    @property
    def is_composite(self) -> bool:
        return isinstance(self.mapping, (NodeRelMapping, TripletMapping))

    def pattern(self) -> GraphPattern:
        """The stored pattern this table answers (reference
        ``ElementMapping.pattern``)."""
        return self.mapping.pattern()

    def schema(self) -> PropertyGraphSchema:
        """Schema contributed by this table (reference ``ElementTable.schema``)."""
        m = self.mapping
        if isinstance(m, NodeRelMapping):
            return self._sub_schema(m.node) + self._sub_schema(m.relationship)
        if isinstance(m, TripletMapping):
            s = (
                self._sub_schema(m.source)
                + self._sub_schema(m.relationship)
                + self._sub_schema(m.target)
            )
            from ..api.schema import SchemaPattern

            return s.with_schema_patterns(
                SchemaPattern(
                    m.source.implied_labels,
                    m.relationship.rel_type,
                    m.target.implied_labels,
                )
            )
        return self._sub_schema(m)

    def _sub_schema(self, m) -> PropertyGraphSchema:
        prop_types = {
            key: self.table.column_type(col).nullable
            for key, col in m.property_mapping
        }
        if isinstance(m, NodeMapping):
            s = PropertyGraphSchema.empty()
            opt = [l for l, _ in m.optional_labels]
            for k in range(len(opt) + 1):
                for subset in itertools.combinations(opt, k):
                    s = s.with_node_combination(
                        m.implied_labels | set(subset), prop_types
                    )
            return s
        return PropertyGraphSchema.empty().with_relationship_type(
            m.rel_type, prop_types
        )


class RelationalCypherGraph:
    """Abstract graph (reference ``RelationalCypherGraph.scala:82``)."""

    schema: PropertyGraphSchema

    def scan_operator(
        self, var_name: str, ct: T.CypherType, ctx: RelationalRuntimeContext
    ) -> RelationalOperator:
        raise NotImplementedError

    @property
    def patterns(self) -> frozenset:
        """Stored patterns this graph can answer with ONE scan (reference
        ``RelationalCypherGraph.patterns`` / ``ScanGraph.scala:105``)."""
        return frozenset()

    def supports_pattern_rewrite(self, search) -> bool:
        """True when replacing an Expand of ``search``'s shape with a
        PatternScan is GUARANTEED bag-equivalent to the classic plan."""
        return False

    def pattern_scan_op(
        self,
        entity_fields,  # ((entity name, field name, CypherType), ...)
        search,  # GraphPattern
        ctx: RelationalRuntimeContext,
    ) -> RelationalOperator:
        raise NotImplementedError(f"{type(self).__name__} stores no patterns")

    # -- convenience -------------------------------------------------------

    def node_scan(self, ctx, var_name: str = "n", labels=()) -> RelationalOperator:
        return self.scan_operator(var_name, T.CTNodeType(labels), ctx)

    def rel_scan(self, ctx, var_name: str = "r", types=()) -> RelationalOperator:
        return self.scan_operator(var_name, T.CTRelationshipType(types), ctx)


class EmptyGraph(RelationalCypherGraph):
    def __init__(self):
        self.schema = PropertyGraphSchema.empty()

    def scan_operator(self, var_name, ct, ctx) -> RelationalOperator:
        if isinstance(ct, T.CTNodeType):
            h = header_for_node(var_name, ct, self.schema)
        else:
            h = header_for_relationship(var_name, ct, self.schema)
        return EmptyRecordsOp(self, ctx, h)


class ScanGraph(RelationalCypherGraph):
    def __init__(
        self,
        scans: Sequence[ElementTable],
        schema: Optional[PropertyGraphSchema] = None,
    ):
        self.scans = list(scans)
        self._patterns = None
        if schema is None:
            schema = PropertyGraphSchema.empty()
            for s in self.scans:
                schema = schema + s.schema()
        self.schema = schema

    # ------------------------------------------------------------------

    def scan_operator(self, var_name, ct, ctx) -> RelationalOperator:
        # per-CONTEXT scan cache: repeated scans of the same var/type in one
        # query (UNION branches, EXISTS stems, var-length steps) share ONE
        # operator object, which the CSE pass then merges parents over. The
        # cache deliberately lives on the runtime context, NOT the graph:
        # leaf operators pin their ctx (parameters flow up from leaves), so
        # a graph-level cache would leak the first query's parameters into
        # later queries.
        cache = getattr(ctx, "_scan_op_cache", None)
        if cache is None:
            cache = {}
            try:
                object.__setattr__(ctx, "_scan_op_cache", cache)
            except Exception:  # pragma: no cover - fault-ok: exotic frozen context, cache disabled
                cache = None
        key = (id(self), var_name, ct)
        if cache is not None and key in cache:
            return cache[key]
        if isinstance(ct, T.CTNodeType):
            op = self._node_scan_op(var_name, ct, ctx)
        elif isinstance(ct, T.CTRelationshipType):
            op = self._rel_scan_op(var_name, ct, ctx)
        else:
            raise TypeError(f"Cannot scan for {ct!r}")
        if cache is not None:
            cache[key] = op
        return op

    def _node_scan_op(self, var_name, ct: T.CTNodeType, ctx) -> RelationalOperator:
        target = header_for_node(var_name, ct, self.schema)
        var = E.Var(var_name).with_type(ct)
        required = set(ct.labels)
        aligned: List[RelationalOperator] = []
        for et in self.scans:
            if not et.is_node or et.is_composite:
                continue
            m: NodeMapping = et.mapping
            available = m.implied_labels | {l for l, _ in m.optional_labels}
            if not required <= available:
                continue
            aligned.append(self._align_node(et, var, target, required, ctx))
        return self._union(aligned, target, ctx)

    def _align_node(
        self, et: ElementTable, var: E.Var, target: RecordHeader, required, ctx
    ) -> RelationalOperator:
        m: NodeMapping = et.mapping
        opt = dict(m.optional_labels)
        t = et.table
        # filter rows lacking a required-but-optional label
        need_filter = [opt[l] for l in required if l in opt and l not in m.implied_labels]
        pairs: List[Tuple[str, str]] = []
        consts: List[Tuple[E.Expr, str]] = []
        for e in target.expressions:
            _element_alignment(m, e, target.column(e), pairs, consts)
        for c in need_filter:
            t = t.filter(E.Var(c).with_type(T.CTBoolean), _col_header(c), {})
        t = t.project(pairs)
        if consts:
            t = t.with_columns(consts, None, {})
        t = t.select(target.columns)
        return TableOp(self, ctx, target, t)

    def _rel_scan_op(self, var_name, ct: T.CTRelationshipType, ctx) -> RelationalOperator:
        target = header_for_relationship(var_name, ct, self.schema)
        var = E.Var(var_name).with_type(ct)
        wanted = ct.types or self.schema.relationship_types
        aligned: List[RelationalOperator] = []
        for et in self.scans:
            if et.is_node and not et.is_composite:
                continue
            # composite tables store exactly ONE relationship per row: the
            # rel sub-mapping extracts a plain relationship scan (keeps every
            # query shape correct even when edges live only in composites)
            m = et.mapping.relationship if et.is_composite else et.mapping
            if m.rel_type not in wanted:
                continue
            t = et.table
            pairs: List[Tuple[str, str]] = []
            consts: List[Tuple[E.Expr, str]] = []
            for e in target.expressions:
                _element_alignment(m, e, target.column(e), pairs, consts)
            t = t.project(pairs)
            if consts:
                t = t.with_columns(consts, None, {})
            t = t.select(target.columns)
            aligned.append(TableOp(self, ctx, target, t))
        return self._union(aligned, target, ctx)

    # -- stored composite patterns (reference ScanGraph.scala:59-110) ----

    @property
    def patterns(self) -> frozenset:
        if self._patterns is None:
            self._patterns = frozenset(et.pattern() for et in self.scans)
        return self._patterns

    def supports_pattern_rewrite(self, search) -> bool:
        """The rewrite is bag-equivalent iff (a) some composite tables embed
        the search, (b) EVERY table contributing relationships of the
        searched types is one of them (edges split across plain rel tables
        or other-shape composites would silently vanish), (c) the stored
        node label sets are exact in the schema (no combo strictly extends
        them — otherwise HasLabel columns lie), and (d) the composite
        sub-mappings cover every schema property of their elements
        (uncovered properties would flip from values to nulls)."""
        matching = [
            et
            for et in self.scans
            if et.is_composite and et.pattern().find_mapping(search) is not None
        ]
        if not matching:
            return False
        rel_ct = search.rel_type
        searched = set(rel_ct.types) if rel_ct.types else None  # None = any
        for et in self.scans:
            if et.is_node and not et.is_composite:
                continue
            m = et.mapping.relationship if et.is_composite else et.mapping
            contributes = searched is None or m.rel_type in searched
            if contributes and all(et is not x for x in matching):
                return False
        combos = self.schema.label_combinations
        def label_exact(implied) -> bool:
            i = frozenset(implied)
            return not any(i < frozenset(c) for c in combos)
        for et in matching:
            cm = et.mapping
            node_subs = (
                [cm.source, cm.target]
                if isinstance(cm, TripletMapping)
                else [cm.node]
            )
            for nm_ in node_subs:
                if not label_exact(nm_.implied_labels):
                    return False
                want = set(self.schema.node_property_keys(nm_.implied_labels) or {})
                if not want <= {k for k, _ in nm_.property_mapping}:
                    return False
            rm_ = cm.relationship
            want = set(self.schema.relationship_property_keys(rm_.rel_type) or {})
            if not want <= {k for k, _ in rm_.property_mapping}:
                return False
        return True

    def pattern_scan_op(self, entity_fields, search, ctx) -> RelationalOperator:
        """One scan answering a whole stored pattern: selects the composite
        tables whose stored pattern embeds ``search`` (``find_mapping``),
        aligns each to the target header and unions
        (reference ``ScanGraph.scanOperator`` + ``scansForType``)."""
        target = RecordHeader()
        for _, field, ct in entity_fields:
            m = ct.material if hasattr(ct, "material") else ct
            if isinstance(m, T.CTNodeType):
                target = header_for_node(field, m, self.schema, target)
            else:
                target = header_for_relationship(field, m, self.schema, target)
        aligned: List[RelationalOperator] = []
        for et in self.scans:
            if not et.is_composite:
                continue
            embedding = et.pattern().find_mapping(search)
            if embedding is None:
                continue
            aligned.append(
                self._align_composite(et, entity_fields, target, ctx)
            )
        return self._union(aligned, target, ctx)

    def _align_composite(
        self, et: ElementTable, entity_fields, target: RecordHeader, ctx
    ) -> RelationalOperator:
        """Rename/derive the composite table's columns onto the target
        header — one pass over all bound elements of the single table (the
        reference folds per-element ``alignWith`` calls instead)."""
        cm = et.mapping
        sub: Dict[str, object] = {}
        if isinstance(cm, TripletMapping):
            from ..api.graph_pattern import REL_ENTITY, SOURCE_ENTITY, TARGET_ENTITY

            sub = {
                SOURCE_ENTITY: cm.source,
                REL_ENTITY: cm.relationship,
                TARGET_ENTITY: cm.target,
            }
        else:
            from ..api.graph_pattern import NODE_ENTITY, REL_ENTITY

            sub = {NODE_ENTITY: cm.node, REL_ENTITY: cm.relationship}
        field_to_sub: Dict[str, object] = {}
        field_to_ct: Dict[str, object] = {}
        for entity, field, ct in entity_fields:
            field_to_sub[field] = sub[entity]
            field_to_ct[field] = ct.material if hasattr(ct, "material") else ct
        t = et.table
        pairs: List[Tuple[str, str]] = []
        consts: List[Tuple[E.Expr, str]] = []
        for e in target.expressions:
            col = target.column(e)
            owner = getattr(getattr(e, "expr", None), "name", None)
            if owner is None or owner not in field_to_sub:
                continue
            _element_alignment(field_to_sub[owner], e, col, pairs, consts)
        t = t.project(pairs)
        if consts:
            t = t.with_columns(consts, None, {})
        t = t.select(target.columns)
        return TableOp(self, ctx, target, t)

    def _union(
        self, ops: List[RelationalOperator], header: RecordHeader, ctx
    ) -> RelationalOperator:
        if not ops:
            return EmptyRecordsOp(self, ctx, header)
        out = ops[0]
        for o in ops[1:]:
            out = UnionAllOp(out, o)
        return out


class PrefixedGraph(RelationalCypherGraph):
    """Wraps a graph, tagging all element ids with a prefix
    (reference ``PrefixedGraph`` / ``RelationalOperator.PrefixGraph:185``)."""

    def __init__(self, graph: RelationalCypherGraph, prefix: int):
        self.graph = graph
        self.prefix = prefix
        self.schema = graph.schema

    def scan_operator(self, var_name, ct, ctx) -> RelationalOperator:
        op = self.graph.scan_operator(var_name, ct, ctx)
        return self._prefixed(op, ctx)

    @property
    def patterns(self) -> frozenset:
        return self.graph.patterns

    def supports_pattern_rewrite(self, search) -> bool:
        return self.graph.supports_pattern_rewrite(search)

    def pattern_scan_op(self, entity_fields, search, ctx) -> RelationalOperator:
        op = self.graph.pattern_scan_op(entity_fields, search, ctx)
        return self._prefixed(op, ctx)

    def _prefixed(self, op: RelationalOperator, ctx) -> RelationalOperator:
        h = op.header
        items: List[Tuple[E.Expr, str]] = []
        for e in h.expressions:
            if isinstance(e, (E.Id, E.StartNode, E.EndNode)):
                items.append(
                    (E.PrefixId(e, self.prefix).with_type(T.CTInteger), h.column(e))
                )
        t = op.table.with_columns(items, h, ctx.parameters)
        return TableOp(self, ctx, h, t)


class UnionGraph(RelationalCypherGraph):
    """Union of member graphs with per-member id prefixes
    (reference ``UnionGraph.scala``).

    Nested unions are FLATTENED before tags are assigned: a single OR into the
    tag bits does not compose (tag 2 then 1 == tag 1 then 2), so the member
    list is the transitive closure of leaf graphs, each tagged once."""

    def __init__(self, graphs: Sequence[RelationalCypherGraph]):
        if not graphs:
            raise ValueError("UnionGraph requires at least one member")
        leaves: List[RelationalCypherGraph] = []

        def flatten(g: RelationalCypherGraph):
            if isinstance(g, UnionGraph):
                for m in g.members:
                    assert isinstance(m, PrefixedGraph)
                    flatten(m.graph)
            elif isinstance(g, PrefixedGraph):
                flatten(g.graph)
            else:
                leaves.append(g)

        for g in graphs:
            flatten(g)
        # tags 1..510; tag 511 is reserved for CONSTRUCT-created elements
        # (relational/construct.py NEW_ELEMENT_TAG)
        if len(leaves) > 510:
            raise ValueError("UnionGraph supports at most 510 member graphs")
        self.members = [PrefixedGraph(g, i + 1) for i, g in enumerate(leaves)]
        schema = PropertyGraphSchema.empty()
        for g in graphs:
            schema = schema + g.schema
        self.schema = schema

    def scan_operator(self, var_name, ct, ctx) -> RelationalOperator:
        return _member_union_scan(self, self.members, var_name, ct, ctx)


class OverlayGraph(RelationalCypherGraph):
    """Union of member graphs WITHOUT re-tagging ids.

    Used by ``CONSTRUCT ON g1, g2``: constructed elements must keep identity
    with the base graphs' elements so new relationships can attach to base
    nodes (reference ``ConstructGraphPlanner`` ON-graph handling —
    cloned/base ids keep their existing graph tag). Scans are deduplicated
    per element id, keeping the FIRST member's row — the construct planner
    lists the constructed part first so CLONE ... SET values supersede the
    base graph's rows."""

    def __init__(self, members: Sequence[RelationalCypherGraph]):
        if not members:
            raise ValueError("OverlayGraph requires at least one member")
        self.members = list(members)
        schema = PropertyGraphSchema.empty()
        for g in self.members:
            schema = schema + g.schema
        self.schema = schema

    def scan_operator(self, var_name, ct, ctx) -> RelationalOperator:
        return _member_union_scan(
            self, self.members, var_name, ct, ctx, dedup_var=var_name
        )


def _member_union_scan(
    graph: RelationalCypherGraph,
    members: Sequence[RelationalCypherGraph],
    var_name: str,
    ct: T.CypherType,
    ctx: RelationalRuntimeContext,
    dedup_var: Optional[str] = None,
) -> RelationalOperator:
    """Union the members' scans aligned to the combined schema's header.

    ``dedup_var``: when set, rows are deduplicated on that variable's id
    column (keep-first) — OverlayGraph semantics; UnionGraph members have
    disjoint id tags so no dedup is needed there."""
    if isinstance(ct, T.CTNodeType):
        target = header_for_node(var_name, ct, graph.schema)
    else:
        target = header_for_relationship(var_name, ct, graph.schema)
    ops = []
    for g in members:
        if isinstance(ct, T.CTNodeType) and ct.labels:
            if not g.schema.combinations_for(ct.labels):
                continue
        op = g.scan_operator(var_name, ct, ctx)
        ops.append(_align_to(op, target, graph, ctx))
    if not ops:
        return EmptyRecordsOp(graph, ctx, target)
    out = ops[0]
    for o in ops[1:]:
        out = UnionAllOp(out, o)
    if dedup_var is not None and len(ops) > 1:
        id_col = target.column(target.id_expr(target.var(dedup_var)))
        return TableOp(graph, ctx, target, out.table.distinct([id_col]))
    return out


def _align_to(
    op: RelationalOperator, target: RecordHeader, graph, ctx
) -> RelationalOperator:
    """Align a member scan to a wider union header: add missing label/property
    columns as constants (reference ``RelationalPlanner.alignWith``)."""
    h = op.header
    t = op.table
    rename: Dict[str, str] = {}
    consts: List[Tuple[E.Expr, str]] = []
    for e in target.expressions:
        col = target.column(e)
        if e in h:
            if h.column(e) != col:
                rename[h.column(e)] = col
        elif isinstance(e, (E.HasLabel, E.HasType)):
            consts.append((E.Lit(False), col))
        else:
            consts.append((E.Lit(None), col))
    keep = [h.column(e) for e in target.expressions if e in h]
    t = t.select(list(dict.fromkeys(keep)))
    if rename:
        t = t.rename(rename)
    if consts:
        t = t.with_columns(consts, None, {})
    t = t.select(target.columns)
    return TableOp(graph, ctx, target, t)


def _col_header(col: str) -> RecordHeader:
    return RecordHeader({E.Var(col).with_type(T.CTBoolean): col})
