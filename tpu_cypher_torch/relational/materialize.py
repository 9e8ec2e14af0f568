"""Shared element materialization: header columns -> Node/Relationship values.

Single source of truth used by both the result layer (``records.py``) and the
local evaluator (``eval.py``) — the analog of the reference backends'
``rowToCypherMap``."""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..api import types as T
from ..api.values import Node, Path, Relationship
from ..ir import expr as E
from ..obs.metrics import REGISTRY
from .header import RecordHeader

RowFn = Callable[[Dict[str, Any]], Any]

# element-materializer builds by kind — counted at FACTORY time (once per
# result column), never per row: the row closures stay uninstrumented so
# collect() hot loops pay nothing
MATERIALIZERS_BUILT = REGISTRY.counter(
    "tpu_cypher_materializers_built_total",
    "element materializers built per kind (node/relationship/path)",
    labels=("kind",),
)


def node_materializer(header: RecordHeader, var: E.Var) -> RowFn:
    MATERIALIZERS_BUILT.inc(kind="node")
    id_col = header.column(header.id_expr(var))
    label_cols = [(e.label, header.column(e)) for e in header.labels_for(var)]
    prop_cols = [(e.key, header.column(e)) for e in header.properties_for(var)]

    def make(r: Dict[str, Any]):
        i = r.get(id_col)
        if i is None:
            return None
        return Node(
            i,
            [l for l, c in label_cols if r.get(c)],
            {k: r.get(c) for k, c in prop_cols if r.get(c) is not None},
        )

    return make


def relationship_materializer(header: RecordHeader, var: E.Var) -> RowFn:
    MATERIALIZERS_BUILT.inc(kind="relationship")
    id_col = header.column(header.id_expr(var))
    start_col = header.column(
        next(e for e in header.expressions_for(var) if isinstance(e, E.StartNode))
    )
    end_col = header.column(
        next(e for e in header.expressions_for(var) if isinstance(e, E.EndNode))
    )
    type_cols = [(e.rel_type, header.column(e)) for e in header.types_for(var)]
    prop_cols = [(e.key, header.column(e)) for e in header.properties_for(var)]

    def make(r: Dict[str, Any]):
        i = r.get(id_col)
        if i is None:
            return None
        return Relationship(
            i,
            r.get(start_col),
            r.get(end_col),
            next((t for t, c in type_cols if r.get(c)), ""),
            {k: r.get(c) for k, c in prop_cols if r.get(c) is not None},
        )

    return make


def path_materializer(header: RecordHeader, var: E.Var) -> RowFn:
    """Assemble a Path value from its member element columns (named paths:
    a capability the reference blacklists in TCK — ``morpheus-tck/src/test/
    resources/failing_blacklist`` "Named path" scenarios).

    Members alternate node / relationship fields in traversal order; a
    var-length member's column holds a (possibly empty) list of Relationship
    values, spliced inline. A zero-length segment contributes no relationship,
    so the adjacent node appears twice — collapsed below. A null first node
    (e.g. unmatched OPTIONAL MATCH) makes the whole path null."""
    MATERIALIZERS_BUILT.inc(kind="path")
    from .header import path_nodes_companion

    makers = []
    for f in header.path_entities(var.name):
        v = header.var(f)
        m = (v.cypher_type or T.CTAny.nullable).material
        if isinstance(m, T.CTNodeType):
            makers.append((False, node_materializer(header, v)))
        elif isinstance(m, T.CTRelationshipType):
            makers.append((False, relationship_materializer(header, v)))
        else:  # var-length segment: list-of-relationships column
            col = header.column(v)
            # companion column with the full intermediate node elements
            # (present when the planner captured them for this path)
            try:
                ncol = header.column(header.var(path_nodes_companion(f)))
            except KeyError:
                ncol = None
            makers.append(((col, ncol), None))

    def make(r: Dict[str, Any]):
        elems = []
        for spec, fn in makers:
            if fn is None:  # var-length segment
                col, ncol = spec
                rels = r.get(col)
                if rels is None:
                    return None
                # intermediate nodes: captured full elements if present,
                # else id-only stubs reconstructed from the endpoint chain
                nodes = (r.get(ncol) or []) if ncol is not None else []
                cur = elems[-1].id if elems and isinstance(elems[-1], Node) else None
                for i, rel in enumerate(rels):
                    elems.append(rel)
                    cur = rel.end if rel.start == cur else rel.start
                    if i < len(nodes):
                        elems.append(nodes[i])
                    else:
                        elems.append(Node(cur, [], {}))
                continue
            v = fn(r)
            if v is None:
                return None
            if (
                elems
                and isinstance(v, Node)
                and isinstance(elems[-1], Node)
                and elems[-1].id == v.id
            ):
                # same node twice: zero-length segment, or an intermediate
                # standing in for the fully-materialized node — keep the
                # richer value
                elems[-1] = v
            else:
                elems.append(v)
        return Path(elems)

    return make
