"""Cost-based join-order search over the logical plan.

The logical planner emits pattern chains in **syntax order**: a stack of
``Expand`` / ``ExpandInto`` / ``Filter`` nodes over a base (a free
``NodeScan`` anchoring the pattern, or whatever operator bound the first
endpoint). :func:`maybe_reorder` rewrites each such chain into the order
the :class:`~tpu_cypher.optimizer.cost.CostModel` prices cheapest:

* exact dynamic programming over connected sub-patterns up to
  ``TPU_CYPHER_OPT_DP_MAX_RELS`` relationships (states are solved-rel
  subsets; connectivity keeps the reachable state count far below 2^k),
  greedy cheapest-next-step beyond that;
* when the base is a free scan the anchor node is part of the search —
  the model may start the pattern from a rarer label;
* interleaved filters are re-applied at the earliest point their
  variables are bound, exactly once each;
* every chain node's label scan travels with it, so each node's
  constraint is enforced exactly once in any order;
* **cyclic** chains (any ``ExpandInto`` closing a cycle) are left in
  syntax order: the multiway-intersect fastpath is worst-case optimal on
  cyclic patterns and the pure-count tiers fuse the syntax shape — a
  reorder that breaks that pattern-match trades a fused closed-form
  count for materialized frontiers and loses even when its modelled row
  volume is far lower.

Rewrites preserve semantics (same rows, possibly different row order) and
identity discipline: shared subtrees are memoized by object id so DAG
sharing (``Optional``/``Exists`` rhs embedding the lhs) survives, and a
chain whose chosen order equals syntax order returns the ORIGINAL object,
keeping plan-cache keys and CSE behaviour byte-stable.

``TPU_CYPHER_OPT`` gates everything: ``syntax`` disables reordering,
``auto`` (default) applies a reorder only when its modelled cost beats
syntax order by the ``TPU_CYPHER_OPT_MARGIN`` hysteresis, ``force``
always applies the model's choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..ir.expr import walk_vars
from ..logical import ops as L
from ..obs import trace as _obs_trace
from ..utils.config import OPT_DP_MAX_RELS, OPT_MARGIN, OPT_MODE
from .cost import CostModel


@dataclass
class _Rel:
    """One movable relationship of a chain (original op attrs verbatim)."""

    rel: str
    rel_type: object
    source: str
    target: str
    direction: str


@dataclass
class _Chain:
    base: L.LogicalOperator  # operator below the chain (not part of it)
    base_scan: Optional[L.NodeScan]  # set when base is a free anchor scan
    rels: List[_Rel]  # bottom-up (syntax) order
    filters: List[Tuple[L.Filter, FrozenSet[str]]]  # (op, var names), bottom-up
    node_types: Dict[str, object]  # node field -> CypherType (labelled scans)
    scans: Dict[str, L.NodeScan]  # node field -> original scan op
    qgn: str


def _is_free_scan(op) -> bool:
    return (
        isinstance(op, L.NodeScan)
        and isinstance(op.in_op, L.Start)
        and not op.in_op.input_fields
    )


def _extract_chain(head: L.LogicalOperator) -> Optional[_Chain]:
    """Walk down from a topmost Expand/ExpandInto collecting the movable
    chain; None when the shape is not one this pass understands."""
    rels: List[_Rel] = []
    filters: List[Tuple[L.Filter, FrozenSet[str]]] = []
    node_types: Dict[str, object] = {}
    scans: Dict[str, L.NodeScan] = {}
    cur = head
    while True:
        if isinstance(cur, L.Expand):
            if cur.direction not in (">", "-") or not _is_free_scan(cur.rhs):
                return None
            scan = cur.rhs
            node_types[scan.fld] = scan.node_type
            scans[scan.fld] = scan
            rels.append(
                _Rel(cur.rel, cur.rel_type, cur.source, cur.target, cur.direction)
            )
            cur = cur.lhs
        elif isinstance(cur, L.ExpandInto):
            # cycle closure: leave the whole chain in syntax order — the
            # WCOJ fastpath and the fused count tiers already key on this
            # shape and beat any materialized reorder (module docstring)
            return None
        elif isinstance(cur, L.Filter):
            names = frozenset(v.name for v in walk_vars(cur.predicate))
            filters.append((cur, names))
            cur = cur.in_op
        else:
            break
    if len(rels) < 2:
        return None
    names = [r.rel for r in rels]
    if len(set(names)) != len(names):  # repeated rel var: not a plain chain
        return None
    rels.reverse()
    filters.reverse()
    base_scan = None
    base = cur
    if _is_free_scan(cur):
        base_scan = cur
        node_types[cur.fld] = cur.node_type
        scans[cur.fld] = cur
        base = cur.in_op  # the bare Start
    try:
        qgn = cur.graph_name
    except AssertionError:
        return None
    return _Chain(base, base_scan, rels, filters, node_types, scans, qgn)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _labels_of(chain: _Chain, node: str) -> Tuple[str, ...]:
    t = chain.node_types.get(node)
    labels = getattr(t, "labels", None) if t is not None else None
    return tuple(sorted(labels)) if labels else ()


def _types_of(rel: _Rel) -> Tuple[str, ...]:
    types = getattr(rel.rel_type, "types", None)
    return tuple(sorted(types)) if types else ()


class _Search:
    """Shared step/filter pricing for DP, greedy, and the syntax-order
    baseline so every candidate is scored by the identical model."""

    def __init__(self, chain: _Chain, model: CostModel):
        self.chain = chain
        self.model = model
        # filters keyed by index so re-application stays exactly-once
        self.filter_vars = [vs for _, vs in chain.filters]

    def start_state(self, anchor: Optional[str], bound0: FrozenSet[str]):
        """(bound names, est rows, cost, applied-filter indexes) after the
        anchor scan (or the opaque base)."""
        if anchor is not None:
            est, cost = self.model.scan(_labels_of(self.chain, anchor))
            bound = frozenset([anchor])
        else:
            # opaque base: its cost is a shared constant across orders and
            # its cardinality unknowable here; a neutral prior keeps the
            # relative ranking of the movable suffix meaningful
            est = float(max(self.model.stats.node_count(()), 1))
            cost = 0.0
            bound = bound0
        return self._apply_filters(bound, est, cost, frozenset())

    def step(self, bound, est, cost, applied, rel: _Rel):
        """Price one relationship given the bound set; None when the rel
        does not touch the bound set (disconnected transition)."""
        src_b, dst_b = rel.source in bound, rel.target in bound
        types = _types_of(rel)
        if src_b and dst_b:
            est, dc = self.model.expand_into(est, types)
            cost += dc
            new_bound = bound | {rel.rel}
        elif src_b or dst_b:
            new_node = rel.target if src_b else rel.source
            reverse = dst_b
            est, dc = self.model.expand(
                est, types, reverse, _labels_of(self.chain, new_node)
            )
            if rel.direction == "-":  # both orientations traversed
                est *= 2.0
            cost += dc
            new_bound = bound | {rel.rel, new_node}
        else:
            return None
        return self._apply_filters(new_bound, est, cost, applied)

    def _apply_filters(self, bound, est, cost, applied):
        for i, vs in enumerate(self.filter_vars):
            if i not in applied and vs <= bound:
                est, dc = self.model.filter(est)
                cost += dc
                applied = applied | {i}
        return bound, est, cost, applied

    # -- candidate orders -------------------------------------------------

    def price_order(self, anchor, bound0, order: List[_Rel]) -> Optional[float]:
        bound, est, cost, applied = self.start_state(anchor, bound0)
        for rel in order:
            got = self.step(bound, est, cost, applied, rel)
            if got is None:
                return None
            bound, est, cost, applied = got
        return cost

    def best_order(self, anchors: List[Optional[str]], bound0: FrozenSet[str]):
        """Cheapest (anchor, rel order, cost) over all start choices; DP
        when the pattern is small enough, greedy otherwise."""
        best = None
        exact = len(self.chain.rels) <= int(OPT_DP_MAX_RELS.get())
        for anchor in anchors:
            got = self._dp(anchor, bound0) if exact else self._greedy(anchor, bound0)
            if got is not None and (best is None or got[2] < best[2]):
                best = got
        return best

    def _dp(self, anchor, bound0):
        rels = self.chain.rels
        init = self.start_state(anchor, bound0)
        # solved-rel index subset -> (cost, est, bound, applied, order)
        frontier: Dict[FrozenSet[int], tuple] = {
            frozenset(): (init[2], init[1], init[0], init[3], [])
        }
        for _ in range(len(rels)):
            nxt: Dict[FrozenSet[int], tuple] = {}
            for solved, (cost, est, bound, applied, order) in frontier.items():
                for i, rel in enumerate(rels):
                    if i in solved:
                        continue
                    got = self.step(bound, est, cost, applied, rel)
                    if got is None:
                        continue
                    b2, e2, c2, a2 = got
                    key = solved | {i}
                    old = nxt.get(key)
                    if old is None or c2 < old[0]:
                        nxt[key] = (c2, e2, b2, a2, order + [rel])
            if not nxt:  # chain not connected from this anchor
                return None
            frontier = nxt
        full = frontier.get(frozenset(range(len(rels))))
        if full is None:
            return None
        return anchor, full[4], full[0]

    def _greedy(self, anchor, bound0):
        bound, est, cost, applied = self.start_state(anchor, bound0)
        remaining = list(self.chain.rels)
        order: List[_Rel] = []
        while remaining:
            best = None
            for rel in remaining:
                got = self.step(bound, est, cost, applied, rel)
                if got is None:
                    continue
                if best is None or got[2] < best[1][2]:
                    best = (rel, got)
            if best is None:
                return None
            rel, (bound, est, cost, applied) = best
            order.append(rel)
            remaining.remove(rel)
        return anchor, order, cost


# ---------------------------------------------------------------------------
# rebuild
# ---------------------------------------------------------------------------


def _rebuild(chain: _Chain, base: L.LogicalOperator, anchor, order: List[_Rel]):
    """Reassemble the chain in the chosen order on the (already
    transformed) base, reusing original scan objects per node."""

    def scan_for(node: str) -> L.NodeScan:
        got = chain.scans.get(node)
        if got is not None:
            return got
        return L.NodeScan(L.Start(chain.qgn, ()), node, chain.node_types[node])

    if anchor is not None:
        plan: L.LogicalOperator = scan_for(anchor)
        bound: Set[str] = {anchor}
    else:
        plan = base
        bound = {n for n, _ in base.fields}
    applied: Set[int] = set()

    def place_filters():
        nonlocal plan
        for i, (f, vs) in enumerate(chain.filters):
            if i not in applied and vs <= bound:
                plan = L.Filter(plan, f.predicate)
                applied.add(i)

    place_filters()
    for rel in order:
        src_b, dst_b = rel.source in bound, rel.target in bound
        if src_b and dst_b:
            plan = L.ExpandInto(
                plan, rel.source, rel.rel, rel.rel_type, rel.target, rel.direction
            )
            bound.add(rel.rel)
        else:
            new_node = rel.target if src_b else rel.source
            plan = L.Expand(
                plan,
                scan_for(new_node),
                rel.source,
                rel.rel,
                rel.rel_type,
                rel.target,
                rel.direction,
            )
            bound.update((rel.rel, new_node))
        place_filters()
    # any unplaced filter (vars outside the chain scope) keeps its spot on top
    for i, (f, _) in enumerate(chain.filters):
        if i not in applied:
            plan = L.Filter(plan, f.predicate)
    return plan


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _reorder_chain(head, chain: _Chain, ctx, transform) -> Optional[L.LogicalOperator]:
    graph = ctx.resolve_graph(chain.qgn)
    model = CostModel(graph, ctx)
    search = _Search(chain, model)

    if chain.base_scan is not None:
        # free anchor: every typed chain node is a candidate start
        chain_nodes = set(chain.node_types)
        anchors: List[Optional[str]] = sorted(chain_nodes)
        bound0: FrozenSet[str] = frozenset()
        syntax_anchor: Optional[str] = chain.base_scan.fld
    else:
        anchors = [None]
        bound0 = frozenset(n for n, _ in chain.base.fields)
        syntax_anchor = None

    syntax_cost = search.price_order(syntax_anchor, bound0, chain.rels)
    best = search.best_order(anchors, bound0)
    if best is None or syntax_cost is None:
        return None
    anchor, order, best_cost = best

    mode = OPT_MODE.get().strip().lower()
    unchanged = anchor == syntax_anchor and [r.rel for r in order] == [
        r.rel for r in chain.rels
    ]
    if unchanged:
        chosen = "syntax"
    elif mode == "force":
        chosen = "model"
    else:  # auto: hysteresis — only clearly-cheaper plans replace syntax order
        chosen = (
            "model" if best_cost < float(OPT_MARGIN.get()) * syntax_cost else "syntax"
        )
    _obs_trace.note(
        "join_order",
        {
            "rels": len(chain.rels),
            "chosen": chosen,
            "syntax_cost": round(float(syntax_cost), 1),
            "model_cost": round(float(best_cost), 1),
            "anchor": anchor or "(bound)",
            "factorized_steps": int(model.factorized_steps),
        },
    )
    if chosen == "syntax":
        return None
    new_base = transform(chain.base) if chain.base_scan is None else chain.base
    return _rebuild(chain, new_base, anchor, order)


def maybe_reorder(plan: L.LogicalOperator, ctx) -> L.LogicalOperator:
    """Rewrite every reorderable pattern chain in ``plan`` to its modelled
    cheapest join order. Identity-preserving: untouched subtrees (and
    chains whose best order IS syntax order) come back as the same
    objects. Never raises — any model failure returns the plan as given
    (device faults re-raise typed for the session ladder)."""
    if OPT_MODE.get().strip().lower() == "syntax":
        return plan
    memo: Dict[int, L.LogicalOperator] = {}
    # chain ops under a cycle-closing ExpandInto: the whole cyclic pattern
    # stays in syntax order (see module docstring), including the acyclic
    # prefix the generic recursion would otherwise visit on its own
    pinned: Set[int] = set()

    def pin_chain(op) -> None:
        cur = op
        while isinstance(cur, (L.Expand, L.ExpandInto, L.Filter)):
            pinned.add(id(cur))
            cur = cur.lhs if isinstance(cur, L.Expand) else cur.in_op

    def transform(op: L.LogicalOperator) -> L.LogicalOperator:
        got = memo.get(id(op))
        if got is not None:
            return got
        new = None
        if isinstance(op, L.ExpandInto):
            pin_chain(op)
        elif isinstance(op, L.Expand) and id(op) not in pinned:
            chain = _extract_chain(op)
            if chain is not None:
                new = _reorder_chain(op, chain, ctx, transform)
        if new is None:
            kids = op.children
            new_kids = tuple(
                transform(c) if isinstance(c, L.LogicalOperator) else c
                for c in kids
            )
            new = (
                op
                if all(a is b for a, b in zip(kids, new_kids))
                else op.with_new_children(new_kids)
            )
        memo[id(op)] = new
        return new

    try:
        return transform(plan)
    except Exception as exc:
        from ..errors import reraise_if_device

        reraise_if_device(exc, site="optimizer.joinorder")
        return plan
