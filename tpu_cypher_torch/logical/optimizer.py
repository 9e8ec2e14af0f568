"""Logical optimizer.

Mirrors the reference's rule pipeline (``LogicalOptimizer.scala:41``):

* ``discard_scans_for_nonexistent_labels`` — scans on labels absent from the
  schema become EmptyRecords (``LogicalOptimizer.scala`` rule 1),
* ``replace_cartesian_with_value_join`` — a Filter(Equals) above a
  CartesianProduct whose sides each solve one operand becomes a ValueJoin
  (``LogicalOptimizer.scala:53``),
* filter pushdown below cartesian products (our addition — the reference
  relies on engine optimizers (Catalyst/Calcite) for this; we have no engine
  below us, so simple pushdown lives here).
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..api.schema import PropertyGraphSchema
from ..api import types as T
from ..ir import expr as E
from ..trees import TreeNode
from . import ops as L


def optimize(
    plan: L.LogicalOperator,
    schema: Optional[PropertyGraphSchema] = None,
    catalog_schemas: Optional[Dict[str, PropertyGraphSchema]] = None,
    ambient_qgn: Optional[str] = None,
    graph_patterns: Optional[Dict[str, frozenset]] = None,
) -> L.LogicalOperator:
    if schema is not None:
        plan = discard_scans_for_nonexistent_labels(
            plan, schema, catalog_schemas, ambient_qgn
        )
    plan = replace_cartesian_with_value_join(plan)
    if graph_patterns:
        plan = replace_scans_with_recognized_patterns(plan, graph_patterns)
    return plan


def replace_scans_with_recognized_patterns(
    plan: L.LogicalOperator, graph_patterns: Dict[str, object]
) -> L.LogicalOperator:
    """Rewrite Expand over a graph that STORES a matching composite pattern
    into a single ``PatternScan`` (reference
    ``LogicalOptimizer.replaceScansWithRecognizedPatterns``,
    ``LogicalOptimizer.scala:67-130``):

    * stored TripletPattern covering (source, rel, target): the expand's
      rel-scan + 2 joins collapse to one scan; when the source is already
      solved by a larger subtree, the pattern scan (with a renamed source)
      value-joins that subtree on the source id.
    * stored NodeRelPattern covering (source, rel): the source scan + rel
      scan collapse; one join against the target scan remains.
    """
    from ..api.graph_pattern import (
        NODE_ENTITY,
        REL_ENTITY,
        SOURCE_ENTITY,
        TARGET_ENTITY,
        NodeRelPattern,
        TripletPattern,
    )

    def field_type(op: L.LogicalOperator, name: str):
        for n, t in op.fields:
            if n == name:
                return t
        return None

    def scan_qgn(op: L.LogicalOperator) -> Optional[str]:
        if isinstance(op, L.NodeScan) and isinstance(op.in_op, L.Start):
            return op.in_op.qgn
        return None

    def rewrite(op: L.LogicalOperator) -> L.LogicalOperator:
        if not isinstance(op, L.Expand) or op.direction != ">":
            return op
        qgn = scan_qgn(op.rhs)
        if qgn is None or qgn not in graph_patterns:
            return op
        graph = graph_patterns[qgn]
        src_t = field_type(op.lhs, op.source)
        tgt_t = field_type(op.rhs, op.target)
        rel_t = op.rel_type
        if src_t is None or tgt_t is None:
            return op
        src_m = src_t.material if hasattr(src_t, "material") else src_t
        tgt_m = tgt_t.material if hasattr(tgt_t, "material") else tgt_t
        rel_m = rel_t.material if hasattr(rel_t, "material") else rel_t
        if not isinstance(src_m, T.CTNodeType) or not isinstance(
            tgt_m, T.CTNodeType
        ):
            return op
        triplet = TripletPattern(src_m, rel_m, tgt_m)
        has_triplet = graph.supports_pattern_rewrite(triplet)
        node_rel = NodeRelPattern(src_m, rel_m)
        has_node_rel = not has_triplet and graph.supports_pattern_rewrite(
            node_rel
        )
        bare_source = (
            isinstance(op.lhs, L.NodeScan)
            and isinstance(op.lhs.in_op, L.Start)
            and op.lhs.fld == op.source
        )
        start = L.Start(qgn, ())
        if has_triplet:
            if bare_source:
                return L.PatternScan(
                    start,
                    binds=(
                        (op.source, src_t),
                        (op.rel, rel_t),
                        (op.target, tgt_t),
                    ),
                    entity_map=(
                        (SOURCE_ENTITY, op.source),
                        (REL_ENTITY, op.rel),
                        (TARGET_ENTITY, op.target),
                    ),
                    pattern=triplet,
                )
            renamed = op.source + "$ps"
            ps = L.PatternScan(
                start,
                binds=((renamed, src_t), (op.rel, rel_t), (op.target, tgt_t)),
                entity_map=(
                    (SOURCE_ENTITY, renamed),
                    (REL_ENTITY, op.rel),
                    (TARGET_ENTITY, op.target),
                ),
                pattern=triplet,
            )
            join = E.Equals(
                E.Id(E.Var(op.source).with_type(src_t)),
                E.Id(E.Var(renamed).with_type(src_t)),
            ).with_type(T.CTBoolean)
            return L.ValueJoin(op.lhs, ps, (join,))
        if has_node_rel:
            if bare_source:
                base: L.LogicalOperator = L.PatternScan(
                    start,
                    binds=((op.source, src_t), (op.rel, rel_t)),
                    entity_map=((NODE_ENTITY, op.source), (REL_ENTITY, op.rel)),
                    pattern=node_rel,
                )
            else:
                renamed = op.source + "$ps"
                ps = L.PatternScan(
                    start,
                    binds=((renamed, src_t), (op.rel, rel_t)),
                    entity_map=((NODE_ENTITY, renamed), (REL_ENTITY, op.rel)),
                    pattern=node_rel,
                )
                join = E.Equals(
                    E.Id(E.Var(op.source).with_type(src_t)),
                    E.Id(E.Var(renamed).with_type(src_t)),
                ).with_type(T.CTBoolean)
                base = L.ValueJoin(op.lhs, ps, (join,))
            end_join = E.Equals(
                E.EndNode(E.Var(op.rel).with_type(rel_t)).with_type(T.CTInteger),
                E.Id(E.Var(op.target).with_type(tgt_t)).with_type(T.CTInteger),
            ).with_type(T.CTBoolean)
            return L.ValueJoin(base, op.rhs, (end_join,))
        return op

    return plan.rewrite(rewrite)


def discard_scans_for_nonexistent_labels(
    plan: L.LogicalOperator,
    schema: PropertyGraphSchema,
    catalog_schemas: Optional[Dict[str, PropertyGraphSchema]] = None,
    ambient_qgn: Optional[str] = None,
) -> L.LogicalOperator:
    """A scan whose labels can't exist in its source graph's schema becomes
    EmptyRecords. The scan's OWN graph (``n.graph_name``) decides — a scan
    after FROM GRAPH must be pruned against that graph's schema, not the
    ambient one (reference ``LogicalOptimizer.discardScansForNonexistentLabels``)."""

    def schema_for(qgn: str) -> Optional[PropertyGraphSchema]:
        if ambient_qgn is not None and qgn == ambient_qgn:
            return schema
        if catalog_schemas is not None and qgn in catalog_schemas:
            return catalog_schemas[qgn]
        if ambient_qgn is None and catalog_schemas is None:
            return schema  # legacy single-schema call
        return None  # unknown graph (e.g. mid-query CONSTRUCT result): keep scan

    def rule(n: TreeNode) -> TreeNode:
        if isinstance(n, L.NodeScan):
            t = n.node_type
            s = schema_for(n.graph_name)
            if s is not None and isinstance(t, T.CTNodeType) and not (
                t.labels <= s.labels
            ):
                return L.EmptyRecords(n.graph_name, n.fields)
        return n

    return plan.rewrite(rule)


def _vars_of(e: E.Expr) -> Set[str]:
    return {v.name for v in e.iter_nodes() if isinstance(v, E.Var)}


def replace_cartesian_with_value_join(plan: L.LogicalOperator) -> L.LogicalOperator:
    """Filter(Equals(l, r), CartesianProduct(a, b)) -> ValueJoin(a, b, l=r)."""

    def rule(n: TreeNode) -> TreeNode:
        if not isinstance(n, L.Filter):
            return n
        pred = n.predicate
        eqs = [pred] if isinstance(pred, E.Equals) else (
            [p for p in pred.exprs if isinstance(p, E.Equals)]
            if isinstance(pred, E.Ands)
            else []
        )
        if not eqs or not isinstance(n.in_op, L.CartesianProduct):
            return n
        cart = n.in_op
        lhs_fields = {f for f, _ in cart.lhs.fields}
        rhs_fields = {f for f, _ in cart.rhs.fields}
        join_preds = []
        rest = (
            list(pred.exprs) if isinstance(pred, E.Ands) else [pred]
        )
        for eq in eqs:
            lv, rv = _vars_of(eq.lhs), _vars_of(eq.rhs)
            if lv <= lhs_fields and rv <= rhs_fields:
                join_preds.append(eq)
                rest.remove(eq)
            elif lv <= rhs_fields and rv <= lhs_fields:
                join_preds.append(E.Equals(eq.rhs, eq.lhs).with_type(eq.cypher_type))
                rest.remove(eq)
        if not join_preds:
            return n
        out: L.LogicalOperator = L.ValueJoin(cart.lhs, cart.rhs, tuple(join_preds))
        if rest:
            remaining = rest[0] if len(rest) == 1 else E.Ands(tuple(rest)).with_type(
                T.CTBoolean.nullable
            )
            out = L.Filter(out, remaining)
        return out

    return plan.rewrite(rule)
