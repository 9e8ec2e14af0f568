"""In-memory test graphs from CREATE queries.

Re-design of the reference's test-graph factory
(``okapi-testing/.../propertygraph/CreateQueryParser.scala:97`` ->
``InMemoryTestGraph.scala:48`` -> backend ``ScanGraphFactory``): a CREATE
query (optionally preceded by UNWIND) is interpreted into nodes/relationships,
then grouped by label-combination / relationship type into element tables.
This is how every acceptance suite builds its fixture graph
(``initGraph("CREATE (a:Person)...")``)."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..api import types as T
from ..api.mapping import NodeMappingBuilder, RelationshipMappingBuilder
from ..api.values import Node, Relationship
from ..frontend import ast as A
from ..frontend.parser import parse as parse_cypher
from ..ir import expr as E
from ..relational.graphs import ElementTable, ScanGraph


class CreateQueryError(Exception):
    pass


@dataclass
class InMemoryTestGraph:
    nodes: List[Node] = field(default_factory=list)
    relationships: List[Relationship] = field(default_factory=list)


def _eval_literal(e: E.Expr, bindings: Dict[str, Any]) -> Any:
    if isinstance(e, E.Lit):
        return e.value
    if isinstance(e, E.ListLit):
        return [_eval_literal(i, bindings) for i in e.items]
    if isinstance(e, E.MapLit):
        return {k: _eval_literal(v, bindings) for k, v in zip(e.keys, e.values)}
    if isinstance(e, E.Neg):
        return -_eval_literal(e.expr, bindings)
    if isinstance(e, E.Var):
        if e.name in bindings:
            return bindings[e.name]
        raise CreateQueryError(f"Unbound variable {e.name!r} in CREATE property")
    if isinstance(e, E.FunctionCall):
        from ..ir.functions import lookup

        args = [_eval_literal(a, bindings) for a in e.args]
        return lookup(e.name).fn(*args)
    raise CreateQueryError(f"Unsupported expression in CREATE: {e.pretty_expr()}")


def parse_create_query(query: str) -> InMemoryTestGraph:
    stmt = parse_cypher(query)
    if not isinstance(stmt, A.SingleQuery):
        raise CreateQueryError("Expected a single CREATE query")
    graph = InMemoryTestGraph()
    next_id = itertools.count()
    env: Dict[str, Any] = {}

    def run_clauses(clauses: Tuple[A.Clause, ...], bindings: Dict[str, Any]):
        for clause in clauses:
            if isinstance(clause, A.Unwind):
                values = _eval_literal(clause.expr, bindings)
                rest = clauses[clauses.index(clause) + 1 :]
                for v in values:
                    b2 = dict(bindings)
                    b2[clause.var] = v
                    run_clauses(rest, b2)
                return
            if not isinstance(clause, A.CreateClause):
                raise CreateQueryError(
                    f"Only CREATE/UNWIND supported in test graphs, got {type(clause).__name__}"
                )
            _run_create(clause, bindings)

    def _run_create(clause: A.CreateClause, bindings: Dict[str, Any]):
        for part in clause.pattern.parts:
            elems = part.elements
            prev = _resolve_node(elems[0], bindings)
            for j in range(1, len(elems), 2):
                rp: A.RelPattern = elems[j]
                nxt = _resolve_node(elems[j + 1], bindings)
                if len(rp.types) != 1:
                    raise CreateQueryError("CREATE relationships need exactly one type")
                props = (
                    {
                        k: _eval_literal(v, bindings)
                        for k, v in zip(rp.properties.keys, rp.properties.values)
                    }
                    if rp.properties is not None
                    else {}
                )
                props = {k: v for k, v in props.items() if v is not None}
                if rp.direction == A.INCOMING:
                    src, dst = nxt, prev
                else:
                    src, dst = prev, nxt
                rel = Relationship(next(next_id), src.id, dst.id, rp.types[0], props)
                graph.relationships.append(rel)
                if rp.var:
                    bindings[rp.var] = rel
                prev = nxt

    def _resolve_node(np: A.NodePattern, bindings: Dict[str, Any]) -> Node:
        if np.var and np.var in bindings:
            existing = bindings[np.var]
            if not isinstance(existing, Node):
                raise CreateQueryError(f"{np.var!r} is not a node")
            return existing
        props = (
            {
                k: _eval_literal(v, bindings)
                for k, v in zip(np.properties.keys, np.properties.values)
            }
            if np.properties is not None
            else {}
        )
        props = {k: v for k, v in props.items() if v is not None}
        node = Node(next(next_id), np.labels, props)
        graph.nodes.append(node)
        if np.var:
            bindings[np.var] = node
        return node

    run_clauses(stmt.clauses, env)
    return graph


def scan_graph_from_test_graph(graph: InMemoryTestGraph, table_cls) -> ScanGraph:
    """Group by label-combo / rel-type into element tables
    (reference ``ScanGraphFactory``)."""
    tables: List[ElementTable] = []
    by_combo: Dict[frozenset, List[Node]] = {}
    for n in graph.nodes:
        by_combo.setdefault(frozenset(n.labels), []).append(n)
    for combo, nodes in sorted(by_combo.items(), key=lambda kv: sorted(kv[0])):
        keys = sorted({k for n in nodes for k in n.properties})
        cols: Dict[str, List[Any]] = {"id": [n.id for n in nodes]}
        for k in keys:
            cols[f"p_{k}"] = [n.properties.get(k) for n in nodes]
        if combo:
            builder = NodeMappingBuilder.on("id").with_implied_label(*sorted(combo))
            for k in keys:
                builder.with_property_key(k, f"p_{k}")
            mapping = builder.build()
        else:
            # unlabeled nodes: the empty label combination (valid in Cypher;
            # the builder's >=1-label validation targets user IO mappings)
            from ..api.mapping import NodeMapping

            mapping = NodeMapping(
                "id", frozenset(), (), tuple((k, f"p_{k}") for k in keys)
            )
        tables.append(ElementTable(mapping, table_cls.from_columns(cols)))
    by_type: Dict[str, List[Relationship]] = {}
    for r in graph.relationships:
        by_type.setdefault(r.rel_type, []).append(r)
    for rel_type, rels in sorted(by_type.items()):
        keys = sorted({k for r in rels for k in r.properties})
        cols = {
            "id": [r.id for r in rels],
            "src": [r.start for r in rels],
            "dst": [r.end for r in rels],
        }
        for k in keys:
            cols[f"p_{k}"] = [r.properties.get(k) for r in rels]
        builder = (
            RelationshipMappingBuilder.on("id")
            .from_("src")
            .to("dst")
            .with_relationship_type(rel_type)
        )
        for k in keys:
            builder.with_property_key(k, f"p_{k}")
        tables.append(ElementTable(builder.build(), table_cls.from_columns(cols)))
    return ScanGraph(tables)


def graph_from_create_query(session, query: str):
    from ..relational.session import PropertyGraph

    test_graph = parse_create_query(query)
    return PropertyGraph(
        session, scan_graph_from_test_graph(test_graph, session.table_cls)
    )
