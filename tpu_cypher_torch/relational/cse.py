"""Common-subplan sharing + cache insertion for the relational plan.

The reference's only relational optimizer rule is ``InsertCachingOperators``
(``RelationalOptimizer.scala:41-90``): count duplicate subtrees, wrap each
non-trivial duplicate in ``Cache`` so the engine persists it instead of
recomputing per consumer. Our planner already shares operator OBJECTS when
two logical nodes coincide (memoization), but structurally-equal subtrees
built independently — identical UNION branches, repeated scan+filter stems,
EXISTS subqueries repeating a match stem — are distinct objects whose lazy
``_table`` caches don't help each other.

This pass runs bottom-up over the plan DAG:

1. MERGE: structurally-equal operators (same type, same merged children,
   same non-cache attributes) collapse to one shared object, so its lazily
   cached table computes once per query run;
2. CACHE: any merged operator with more than one parent is wrapped in a
   single shared ``CacheOp`` (the reference's Cache), pinning the computed
   table's device buffers for the later consumers.

Signatures hash attribute values by structure where cheap (tuples of
hashables, Exprs are value-hashable) and by IDENTITY for everything else
(tables, graphs, contexts) — identity is conservative: it can only miss a
merge, never merge two different plans.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..ir import expr as E
from . import ops as O
from .prune import _plan_children as _live_children

# lazy caches + plumbing that must not participate in structural identity
_SKIP_ATTRS = frozenset({"children", "_header", "_table", "_plan"})

# functions whose every syntactic occurrence is an independent evaluation:
# two structurally-equal subtrees containing them are NOT the same value
# (mirrors the TPU compiler's _NONDETERMINISTIC const-fold guard)
_NONDETERMINISTIC = frozenset({"rand", "randomuuid"})


def _has_nondeterminism(v: Any) -> bool:
    if isinstance(v, E.Expr):
        if (
            isinstance(v, E.FunctionCall)
            and v.name.lower() in _NONDETERMINISTIC
        ):
            return True
        return any(
            _has_nondeterminism(c)
            for c in getattr(v, "children", ()) or ()
        )
    if isinstance(v, (list, tuple, set, frozenset)):
        return any(_has_nondeterminism(x) for x in v)
    if isinstance(v, dict):
        return any(_has_nondeterminism(x) for x in v.values())
    return False


def _freeze(v: Any) -> Any:
    from .header import RecordHeader

    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(
            ((_freeze(k), _freeze(x)) for k, x in v.items()),
            key=repr,
        ))
    if isinstance(v, (set, frozenset)):
        return frozenset(_freeze(x) for x in v)
    if isinstance(v, RecordHeader):
        # headers are value objects: freeze structurally so equal headers
        # built independently still merge
        return (
            "__rh__",
            frozenset((e, v.column(e)) for e in v.expressions),
            _freeze(getattr(v, "paths", None)),
        )
    try:
        hash(v)
        return v
    except TypeError:
        # tables / graphs / contexts: IDENTITY is the value — conservative
        # (misses merges across equal-but-distinct objects, never wrong)
        return ("__id__", id(v))


def _signature(op: O.RelationalOperator, child_ids: Tuple[int, ...]) -> Optional[Any]:
    parts = [type(op), child_ids]
    for k in sorted(op.__dict__):
        if k in _SKIP_ATTRS:
            continue
        v = op.__dict__[k]
        if _has_nondeterminism(v):
            return None  # rand()/randomUUID(): each occurrence is distinct
        parts.append((k, _freeze(v)))
    key = tuple(parts)
    try:
        hash(key)
    except TypeError:  # pragma: no cover - identity fallback covers leaves
        return None
    return key


def share_common_subplans(root: O.RelationalOperator) -> O.RelationalOperator:
    """Merge structurally-equal subplans, then wrap multi-parent operators
    in shared CacheOps. Mutates children links in place; returns the root."""
    canon: Dict[Any, O.RelationalOperator] = {}
    memo: Dict[int, O.RelationalOperator] = {}

    def merge(op: O.RelationalOperator) -> O.RelationalOperator:
        got = memo.get(id(op))
        if got is not None:
            return got
        new_children = tuple(merge(c) for c in op.children)
        if new_children != op.children:
            op.children = new_children
        sig = _signature(op, tuple(id(c) for c in new_children))
        out = op if sig is None else canon.setdefault(sig, op)
        memo[id(op)] = out
        return out

    root = merge(root)

    # count parents over the LIVE dag only (prune's _plan_children: classic
    # shadow plans of fused expand ops are excluded): shadow references
    # would wrap live chain links in CacheOps and force materialization the
    # fused count/distinct chains would otherwise skip entirely
    parents: Dict[int, int] = {}
    seen: set = set()

    def count(op: O.RelationalOperator) -> None:
        if id(op) in seen:
            return
        seen.add(id(op))
        for c in _live_children(op):
            parents[id(c)] = parents.get(id(c), 0) + 1
            count(c)

    count(root)

    # one shared CacheOp per multi-parent non-trivial operator (leaves and
    # existing caches have nothing to gain)
    wrapped: Dict[int, O.RelationalOperator] = {}

    def cache_for(op: O.RelationalOperator) -> O.RelationalOperator:
        if (
            parents.get(id(op), 0) <= 1
            or not op.children
            or isinstance(op, O.CacheOp)
        ):
            return op
        w = wrapped.get(id(op))
        if w is None:
            w = O.CacheOp(op)
            wrapped[id(op)] = w
        return w

    rewired: set = set()

    def rewire(op: O.RelationalOperator) -> None:
        if id(op) in rewired:
            return
        rewired.add(id(op))
        for c in op.children:
            rewire(c)
        new_children = tuple(cache_for(c) for c in op.children)
        if new_children != op.children:
            op.children = new_children

    rewire(root)
    return root
