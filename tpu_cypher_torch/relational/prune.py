"""Fused-expand column pruning: emit only columns somebody consumes.

The reference delegates column pruning to its engines (Catalyst/Calcite
prune project lists through the whole DataFrame plan); our physical tree has
no optimizer underneath it, so multi-hop expands would gather every
pass-through column of every variable at every hop — the dominant HBM cost
of a k-hop MATCH.

This pass runs once per query, after relational planning, flowing
REQUIREMENTS top-down through the plan DAG:

1. each operator contributes its LOCAL consumption (filter predicates,
   projections, join keys, sort keys, aggregation inputs, select lists);
2. requirements flow from parents to children, except across projection
   BARRIERS (AggregateOp, SelectOp): an aggregate's children owe only the
   group fields and aggregation inputs — parents' needs are satisfied by
   the aggregate's outputs, so a pruned count(*) plan asks its expand for
   NOTHING and the fused op can answer with a pure degree-sum;
3. each fused CSR expand operator (``CsrExpandOp``/``CsrExpandIntoOp``) is
   restricted to the requirements that reached it, and cached
   headers/tables are invalidated so the narrowed headers propagate.

Soundness: an expression can only be read from a child table through a
header lookup, and every such lookup site is enumerated in the local rules
below (or covered by the conservative default: unknown operators pass
everything through and add their own and children's headers). Only the
fused ops' gather lists shrink — scans stay full.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..ir import expr as E
from . import ops as O


def _subexprs(e: E.Expr, out: Set[E.Expr]) -> None:
    out.add(e)
    for c in getattr(e, "children", ()) or ():
        if isinstance(c, E.Expr):
            _subexprs(c, out)


def _plan_children(op: O.RelationalOperator):
    """Live children. Fused ops' classic shadow plans (children[1]) are NOT
    descended into: their join expressions would pollute requirements
    (keeping every id/start/end column alive), and their caches are
    self-consistent for the fallback path."""
    from ..backend.cuda.expand_op import _FusedExpandBase

    if isinstance(op, _FusedExpandBase):
        return (op.children[0],)
    return op.children


def _mention_var_exprs(m: Set[E.Expr], h, name: str) -> None:
    try:
        v = h.var(name)
    except Exception:  # fault-ok: plan-time header probe, no device work at plan time
        return
    m.update(h.expressions_for(v))


def _mention_tree(m: Set[E.Expr], e: E.Expr, h) -> None:
    """An expr tree consumes its header-resident subexprs; an element Var
    inside it is resolved through ALL that var's columns (id/labels/
    properties — e.g. count(x) counts via x's id column)."""
    sub: Set[E.Expr] = set()
    _subexprs(e, sub)
    m.update(sub)
    for s in sub:
        if isinstance(s, E.Var):
            _mention_var_exprs(m, h, s.name)


def _mention_enforced_pairs(m: Set[E.Expr], op, h) -> None:
    """A fused expand op with in-op relationship-uniqueness pairs reads the
    partner rels' id columns from its input on the materializing path —
    keep them alive through pruning."""
    for pr in getattr(op, "enforced_pairs", ()):
        for r in pr:
            if r == getattr(op, "rel_fld", None):
                continue
            try:
                m.add(h.id_expr(h.var(r)))
            except Exception:  # fault-ok: plan-time expression probe, host-only
                pass


def _local_mentions(op: O.RelationalOperator) -> Set[E.Expr]:
    """What this operator itself reads from its children's tables."""
    from ..backend.cuda.expand_op import CsrExpandOp

    # not ported yet (ROADMAP.md queue 1): no plan holds these operators,
    # and an empty class tuple never matches an isinstance check
    CsrExpandIntoOp = CsrOptionalExpandOp = CsrVarExpandOp = ()
    MultiwayIntersectOp = ()

    m: Set[E.Expr] = set()
    if isinstance(op, O.FilterOp):
        _mention_tree(m, op.predicate, op.children[0].header)
    elif isinstance(op, O.AddOp):
        _mention_tree(m, op.expr, op.children[0].header)
    elif isinstance(op, O.UnwindOp):
        _mention_tree(m, op.list_expr, op.children[0].header)
    elif isinstance(op, O.SelectOp):
        m.update(op.header.expressions)
    elif isinstance(op, O.AliasOp):
        h = op.children[0].header
        for orig, _ in op.aliases:
            _mention_var_exprs(m, h, orig.name)
    elif isinstance(op, O.DistinctOp):
        # mirror DistinctOp._compute_table: element vars dedup on their id
        # column alone, so only that column is consumed
        from ..api import types as T

        for f in op.fields:
            try:
                v = op.header.var(f)
            except Exception:  # fault-ok: plan-time header probe, host-only
                continue
            mt = v.cypher_type.material if v.cypher_type is not None else None
            if isinstance(
                mt, (T.CTNodeType, T.CTRelationshipType)
            ) and not op.header.has_path(f):
                try:
                    m.add(op.header.id_expr(v))
                    continue
                except Exception:  # fault-ok: plan-time id-expr probe, host-only
                    pass
            _mention_var_exprs(m, op.header, f)
    elif isinstance(op, O.AggregateOp):
        h = op.children[0].header
        for f in op.group_fields:
            _mention_var_exprs(m, h, f)
        for _, agg in op.aggregations:
            if getattr(agg, "expr", None) is not None:
                _mention_tree(m, agg.expr, h)
    elif isinstance(op, O.OrderByOp):
        for f, _ in op.items:
            try:
                v = op.header.var(f)
                m.add(op.header.id_expr(v))
            except Exception:  # fault-ok: plan-time header probe, host-only
                m.update(op.header.expressions)
    elif isinstance(op, O.JoinOp):
        for le, re_ in op.join_exprs:
            _mention_tree(m, le, op.children[0].header)
            _mention_tree(m, re_, op.children[1].header)
    elif isinstance(op, O.UnionAllOp):
        m.update(op.children[0].header.expressions)
        m.update(op.children[1].header.expressions)
    elif isinstance(op, O.SwapStartEndOp):
        _mention_var_exprs(m, op.children[0].header, op.rel_var.name)
    elif isinstance(op, (CsrExpandOp, CsrOptionalExpandOp)):
        h = op.children[0].header
        try:
            m.add(h.id_expr(h.var(op.frontier_fld)))
        except Exception:  # fault-ok: plan-time header probe, host-only
            m.update(h.expressions)
        _mention_enforced_pairs(m, op, h)
    elif isinstance(op, CsrExpandIntoOp):
        h = op.children[0].header
        for f in (op.source_fld, op.target_fld):
            try:
                m.add(h.id_expr(h.var(f)))
            except Exception:  # fault-ok: plan-time header probe, host-only
                m.update(h.expressions)
        _mention_enforced_pairs(m, op, h)
    elif isinstance(op, MultiwayIntersectOp):
        h = op.children[0].header
        for f in (op.pivot.frontier_fld,) + tuple(
            c.anchor_fld for c in op.closes
        ):
            try:
                m.add(h.id_expr(h.var(f)))
            except Exception:  # fault-ok: plan-time header probe, host-only
                m.update(h.expressions)
        _mention_enforced_pairs(m, op, h)
    elif isinstance(op, CsrVarExpandOp):
        # the fused path reads only the source id, but the classic SHADOW
        # cascade ends in a SelectOp whose plan-time field list names every
        # lhs var — pruning them away upstream would break the shadow's
        # header (and the fallback). Var-length therefore pins its whole
        # input header; fixed-hop expands upstream stay un-pruned.
        m.update(op.children[0].header.expressions)
    return m


# operators whose output columns are REBUILT rather than passed through:
# children owe only the operator's local consumption
_BARRIERS = (O.AggregateOp, O.SelectOp)

_KNOWN = (
    O.FilterOp,
    O.AddOp,
    O.UnwindOp,
    O.SelectOp,
    O.AliasOp,
    O.DistinctOp,
    O.AggregateOp,
    O.OrderByOp,
    O.JoinOp,
    O.UnionAllOp,
    O.SwapStartEndOp,
    O.StartOp,
    O.EmptyRecordsOp,
    O.TableOp,
    O.CacheOp,
    O.SkipOp,
    O.LimitOp,
    O.DropOp,
)


def flow_requirements(root: O.RelationalOperator) -> Dict[int, Set[E.Expr]]:
    """Per-operator incoming requirement sets (keyed by id(op))."""
    from ..backend.cuda.expand_op import _FusedExpandBase

    # topological order over the live DAG (parents before children)
    indeg: Dict[int, int] = {}
    nodes: Dict[int, O.RelationalOperator] = {}

    def discover(op):
        if id(op) in nodes:
            return
        nodes[id(op)] = op
        indeg.setdefault(id(op), 0)
        for c in _plan_children(op):
            indeg[id(c)] = indeg.get(id(c), 0) + 1
            discover(c)

    discover(root)
    ready = [root]
    req: Dict[int, Set[E.Expr]] = {id(root): set(root.header.expressions)}
    while ready:
        op = ready.pop()
        incoming = req.setdefault(id(op), set())
        own = _local_mentions(op)
        known = isinstance(op, _KNOWN) or isinstance(op, _FusedExpandBase)
        if isinstance(op, _BARRIERS):
            down: Set[E.Expr] = set(own)
        elif known:
            down = incoming | own
        else:
            # unknown operator (PathBindOp, construct ops, ...): fully
            # conservative — keep everything it or its children expose
            down = incoming | own | set(op.header.expressions)
            for c in _plan_children(op):
                down |= set(c.header.expressions)
        for c in _plan_children(op):
            req.setdefault(id(c), set()).update(down)
            indeg[id(c)] -= 1
            if indeg[id(c)] == 0:
                ready.append(c)
    return req


def prune_fused_columns(root: O.RelationalOperator) -> O.RelationalOperator:
    """Apply requirement-flow pruning to fused expand ops (no-op without any)."""
    try:
        from ..backend.cuda.expand_op import _FusedExpandBase
    except Exception:  # fault-ok: backend not importable, nothing to prune
        return root
    ops: List[O.RelationalOperator] = []
    seen: Set[int] = set()

    def walk(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        ops.append(op)
        for c in _plan_children(op):
            walk(c)

    walk(root)
    fused = [op for op in ops if isinstance(op, _FusedExpandBase)]
    if not fused:
        return root
    req = flow_requirements(root)
    for f in fused:
        f.required_exprs = frozenset(req[id(f)])
    # a fused op sitting at the ROOT of another fused op's shadow subtree
    # answers for the same parent, so it owes exactly the same columns:
    # seed it with the shadow-parent's requirement set (and recurse — a
    # shadow plan can itself carry a fused shadow). Without this a tier
    # decline lands on a WIDE classic plan: e.g. the multiway intersect's
    # count hand-back would pay a full materializing expand-into instead
    # of the same fused count tiers ``off`` mode plans. Interior fused
    # ops of a shadow cascade stay unseeded (their requirements are not
    # the parent's); the fused count tiers peel them without executing.
    spine = {id(f) for f in fused}
    pending = list(fused)
    while pending:
        f = pending.pop()
        if len(f.children) < 2:
            continue
        s = f.children[1]
        while isinstance(s, O.CacheOp):
            s = s.children[0]
        if isinstance(s, _FusedExpandBase) and id(s) not in spine:
            spine.add(id(s))
            s.required_exprs = frozenset(req[id(f)])
            req[id(s)] = req[id(f)]
            pending.append(s)
    # invalidate cached headers/tables so narrowed headers propagate lazily.
    # The walk here includes the classic SHADOW subtrees (children[1] of
    # fused ops, excluded from requirement flow): a shadow cascade shares
    # the pruned fused op as its input, so its cached plan-time headers
    # would otherwise go stale and break the fallback path with a
    # header/table column mismatch.
    all_ops: List[O.RelationalOperator] = []
    seen_all: Set[int] = set()

    def walk_all(op):
        if id(op) in seen_all:
            return
        seen_all.add(id(op))
        all_ops.append(op)
        for c in op.children:
            walk_all(c)

    walk_all(root)
    for op in all_ops:
        op._header = None
        op._table = None
        if isinstance(op, O.JoinOp):
            op._plan = None
    return root
