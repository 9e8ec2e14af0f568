"""Relational (physical) operator tree.

Re-design of the reference's lazy physical plan
(``okapi-relational/.../impl/operators/RelationalOperator.scala:48-514``):
each node computes ``header`` and ``table`` from its children; every
``table`` pull calls exactly one Table-SPI method. Mirrored ops: Start,
Alias, Add, Drop, Filter, Select, Distinct, Aggregate, OrderBy, Skip, Limit,
EmptyRecords, Join, TabularUnionAll, ReturnGraph, plus scan/swap helpers the
reference keeps inside its graph implementations."""

from __future__ import annotations

import math

from dataclasses import dataclass, field as dc_field
from functools import cached_property
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api import types as T
from ..api.table import Table
from ..ir import expr as E
from ..obs import trace as _obs_trace
from .header import RecordHeader


class RelationalError(Exception):
    pass


@dataclass
class RelationalRuntimeContext:
    """Reference ``RelationalRuntimeContext``: parameter map + graph resolver
    + backend table factory."""

    resolve_graph: Any  # Callable[[str], RelationalCypherGraph]
    parameters: Dict[str, Any] = dc_field(default_factory=dict)
    table_cls: type = None  # Table implementation class


class RelationalOperator:
    def __init__(self, *children: "RelationalOperator"):
        self.children = children
        self._header: Optional[RecordHeader] = None
        self._table: Optional[Table] = None

    # -- lazy header/table ------------------------------------------------

    @property
    def header(self) -> RecordHeader:
        if self._header is None:
            self._header = self._compute_header()
        return self._header

    @property
    def table(self) -> Table:
        if self._table is None:
            # every first pull is an operator span in the query's trace
            # tree (obs.trace); children pulled inside _compute_table nest
            # naturally. Memoized re-reads stay span-free — they do no
            # work. HOST wall time only: under JAX async dispatch this is
            # dispatch cost, never an added device sync.
            with _obs_trace.span(type(self).__name__, kind="operator"):
                t = self._compute_table()
            cols = set(t.physical_columns)
            need = set(self.header.columns)
            if need - cols:
                raise RelationalError(
                    f"{type(self).__name__}: header columns {sorted(need - cols)} "
                    f"missing from table columns {sorted(cols)}"
                )
            self._table = t
        return self._table

    def _compute_header(self) -> RecordHeader:
        return self.children[0].header

    def _compute_table(self) -> Table:
        raise NotImplementedError

    @property
    def context(self) -> RelationalRuntimeContext:
        return self.children[0].context

    @property
    def graph(self):
        return self.children[0].graph

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        inner = self._show_inner()
        lines = [f"{pad}{type(self).__name__}{'(' + inner + ')' if inner else ''}"]
        for c in self.children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def _show_inner(self) -> str:
        return ""


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


class StartOp(RelationalOperator):
    """Start from a table (unit table or driving table) bound to a graph."""

    def __init__(
        self,
        graph,
        ctx: RelationalRuntimeContext,
        table: Optional[Table] = None,
        header: Optional[RecordHeader] = None,
    ):
        super().__init__()
        self._graph = graph
        self._ctx = ctx
        self._start_table = table if table is not None else ctx.table_cls.unit()
        self._start_header = header if header is not None else RecordHeader()

    def _compute_header(self) -> RecordHeader:
        return self._start_header

    def _compute_table(self) -> Table:
        return self._start_table

    @property
    def context(self) -> RelationalRuntimeContext:
        return self._ctx

    @property
    def graph(self):
        return self._graph


class EmptyRecordsOp(RelationalOperator):
    def __init__(self, graph, ctx: RelationalRuntimeContext, header: RecordHeader):
        super().__init__()
        self._graph = graph
        self._ctx = ctx
        self._empty_header = header

    def _compute_header(self) -> RecordHeader:
        return self._empty_header

    def _compute_table(self) -> Table:
        return self._ctx.table_cls.empty(self._empty_header.columns)

    @property
    def context(self):
        return self._ctx

    @property
    def graph(self):
        return self._graph


class TableOp(RelationalOperator):
    """A precomputed (header, table) pair as an operator (scan results)."""

    def __init__(self, graph, ctx, header: RecordHeader, table: Table):
        super().__init__()
        self._graph = graph
        self._ctx = ctx
        self._h = header
        self._t = table

    def _compute_header(self):
        return self._h

    def _compute_table(self):
        return self._t

    @property
    def context(self):
        return self._ctx

    @property
    def graph(self):
        return self._graph


# ---------------------------------------------------------------------------
# Unary ops
# ---------------------------------------------------------------------------


class CacheOp(RelationalOperator):
    """Reference ``Cache`` (``RelationalOperator.scala:198``)."""

    def _compute_table(self) -> Table:
        return self.children[0].table.cache()


class AliasOp(RelationalOperator):
    """Bind aliases to existing columns — metadata only (reference ``Alias``)."""

    def __init__(self, in_op: RelationalOperator, aliases: Sequence[Tuple[E.Var, E.Var]]):
        super().__init__(in_op)
        self.aliases = list(aliases)  # (existing var, alias var)

    def _compute_header(self) -> RecordHeader:
        h = self.children[0].header
        for orig, alias in self.aliases:
            h = h.with_alias(alias, orig)
        return h

    def _compute_table(self) -> Table:
        return self.children[0].table

    def _show_inner(self) -> str:
        return ", ".join(f"{o.name} AS {a.name}" for o, a in self.aliases)


class PathBindOp(RelationalOperator):
    """Register a named-path binding in the header — metadata only; the path
    value is reassembled from member element columns at materialization."""

    def __init__(self, in_op: RelationalOperator, path_var: str, entities: Sequence[str]):
        super().__init__(in_op)
        self.path_var = path_var
        self.entities = tuple(entities)

    def _compute_header(self) -> RecordHeader:
        return self.children[0].header.with_path(self.path_var, self.entities)

    def _compute_table(self) -> Table:
        return self.children[0].table

    def _show_inner(self) -> str:
        return f"{self.path_var} = ({', '.join(self.entities)})"


class AddOp(RelationalOperator):
    """Project an expression into a (new or replaced) field column
    (reference ``Add``/``AddInto``, ``RelationalOperator.scala:219-249``)."""

    def __init__(self, in_op: RelationalOperator, expr: E.Expr, fld: str):
        super().__init__(in_op)
        self.expr = expr
        self.fld = fld

    @cached_property
    def _var(self) -> E.Var:
        return E.Var(self.fld).with_type(self.expr.cypher_type)

    def _compute_header(self) -> RecordHeader:
        h = self.children[0].header
        existing = [v for v in h.vars if v.name == self.fld]
        if existing:
            h = h.without(existing[0])
        return h.with_expr(self._var)

    def _compute_table(self) -> Table:
        in_op = self.children[0]
        col = self.header.column(self._var)
        return in_op.table.with_columns(
            [(self.expr, col)], in_op.header, self.context.parameters
        )

    def _show_inner(self) -> str:
        return f"{self.fld} := {self.expr.pretty_expr()}"


class DropOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, exprs: Sequence[E.Expr]):
        super().__init__(in_op)
        self.exprs = list(exprs)

    def _compute_header(self) -> RecordHeader:
        h = self.children[0].header
        m = {e: c for e, c in ((e, h.get(e)) for e in h.expressions) if e not in self.exprs}
        return RecordHeader(m)

    def _compute_table(self) -> Table:
        keep = self.header.columns
        return self.children[0].table.select(keep)


class FilterOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, predicate: E.Expr):
        super().__init__(in_op)
        self.predicate = predicate

    def _compute_table(self) -> Table:
        in_op = self.children[0]
        return in_op.table.filter(self.predicate, in_op.header, self.context.parameters)

    def _show_inner(self) -> str:
        return self.predicate.pretty_expr()


class SelectOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, fields: Sequence[str]):
        super().__init__(in_op)
        self.fields = list(fields)

    def _compute_header(self) -> RecordHeader:
        h = self.children[0].header
        vars_ = [h.var(f) for f in self.fields]
        return h.select(vars_)

    def _compute_table(self) -> Table:
        return self.children[0].table.select(self.header.columns)

    def _show_inner(self) -> str:
        return ", ".join(self.fields)


class DistinctOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, fields: Sequence[str]):
        super().__init__(in_op)
        self.fields = list(fields)

    def distinct_columns(self) -> List[str]:
        h = self.header
        cols: List[str] = []
        for f in self.fields:
            v = h.var(f)
            m = v.cypher_type.material if v.cypher_type is not None else None
            if isinstance(m, (T.CTNodeType, T.CTRelationshipType)) and not h.has_path(f):
                # an element's id determines its labels/type/properties —
                # distinct on the id column alone (the reference relies on
                # the engines' optimizers for the same reduction)
                c = h.column(h.id_expr(v))
                if c not in cols:
                    cols.append(c)
                continue
            for e in h.expressions_for(v):
                c = h.column(e)
                if c not in cols:
                    cols.append(c)
        return cols

    def _compute_table(self) -> Table:
        cols = self.distinct_columns()
        t = self.children[0].table
        return t.distinct(cols) if cols else t.distinct()

    def _show_inner(self) -> str:
        return ", ".join(self.fields)


class AggregateOp(RelationalOperator):
    def __init__(
        self,
        in_op: RelationalOperator,
        group_fields: Sequence[str],
        aggregations: Sequence[Tuple[str, E.Agg]],
    ):
        super().__init__(in_op)
        self.group_fields = list(group_fields)
        self.aggregations = list(aggregations)

    def _compute_header(self) -> RecordHeader:
        in_h = self.children[0].header
        h = RecordHeader()
        for f in self.group_fields:
            v = in_h.var(f)
            for e in in_h.expressions_for(v):
                h = h.with_expr(e, in_h.column(e))
            if in_h.has_path(f):
                h = h.with_path(f, in_h.path_entities(f))
        for name, agg in self.aggregations:
            h = h.with_expr(E.Var(name).with_type(agg.cypher_type))
        return h

    def _compute_table(self) -> Table:
        in_op = self.children[0]
        in_h = in_op.header
        by: List[str] = []
        for f in self.group_fields:
            v = in_h.var(f)
            for e in in_h.expressions_for(v):
                c = in_h.column(e)
                if c not in by:
                    by.append(c)
        aggs = []
        for name, agg in self.aggregations:
            out_col = self.header.column(E.Var(name))
            aggs.append((out_col, agg))
        # count-over-distinct pushdown: WITH DISTINCT a, b ... RETURN
        # count(*) never materializes the deduped rows — the count is the
        # number of first-occurrence groups (the engines get the same from
        # their optimizers' aggregate pushdown)
        if (
            not by
            and isinstance(in_op, DistinctOp)
            and all(
                getattr(agg, "expr", None) is None and not getattr(agg, "distinct", False)
                for _, agg in self.aggregations
            )
        ):
            # deepest pushdown first: a fused expand chain can count its
            # DISTINCT endpoints without materializing ANY row set (the
            # backend op advertises `distinct_endpoints_count`). Column
            # projections keep the row multiset, so peel SelectOps as long
            # as the distinct fields survive them.
            inner = in_op.children[0]
            while (
                isinstance(inner, SelectOp)
                and set(in_op.fields) <= set(inner.fields)
            ) or isinstance(inner, CacheOp):
                inner = inner.children[0]
            fused = getattr(inner, "distinct_endpoints_count", None)
            if fused is not None:
                n = fused(in_op.fields)
                if n is not None:
                    cols = {out_col: [n] for out_col, _ in aggs}
                    return self.context.table_cls.from_columns(cols)
            src = in_op.children[0].table
            n = src.distinct_count(in_op.distinct_columns())
            if n is not None:
                cols = {out_col: [n] for out_col, _ in aggs}
                return type(src).from_columns(cols)
        return in_op.table.group(by, aggs, in_h, self.context.parameters)

    def _show_inner(self) -> str:
        return f"group={self.group_fields}"


class OrderByOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, items: Sequence[Tuple[str, bool]]):
        super().__init__(in_op)
        self.items = list(items)  # (field, ascending)

    def sort_cols(self) -> List[Tuple[str, bool]]:
        """(physical column, ascending) sort keys — shared with LimitOp's
        top-k fusion so key resolution cannot diverge between paths."""
        h = self.header
        cols = []
        for f, asc in self.items:
            v = h.var(f)
            cols.append((h.column(h.id_expr(v)), asc))
        return cols

    def _compute_table(self) -> Table:
        return self.children[0].table.order_by(self.sort_cols())


class SkipOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, expr: E.Expr):
        super().__init__(in_op)
        self.expr = expr

    def _count(self) -> int:
        v = _static_value(self.expr, self.context.parameters)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise RelationalError(f"SKIP requires a non-negative integer, got {v!r}")
        return v

    def _compute_table(self) -> Table:
        return self.children[0].table.skip(self._count())


class LimitOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, expr: E.Expr):
        super().__init__(in_op)
        self.expr = expr

    @staticmethod
    def _peel_cache(op: "RelationalOperator") -> "RelationalOperator":
        while isinstance(op, CacheOp):
            op = op.children[0]
        return op

    def _compute_table(self) -> Table:
        v = _static_value(self.expr, self.context.parameters)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise RelationalError(f"LIMIT requires a non-negative integer, got {v!r}")
        # top-k fusion: LIMIT k (with optional SKIP s) directly over ORDER BY
        # asks the backend for the first s+k sorted rows instead of a full
        # sort (TpuTable answers with one lax.top_k when the keys allow it)
        node = self._peel_cache(self.children[0])
        skip = 0
        ob = None
        if isinstance(node, SkipOp):
            try:
                skip = node._count()
                inner = self._peel_cache(node.children[0])
                if isinstance(inner, OrderByOp):
                    ob = inner
            except RelationalError:
                ob = None
        elif isinstance(node, OrderByOp):
            ob = node
        # skip the fusion when the sorted table is already materialized
        # (a CSE-shared sibling computed it): slicing it is free
        if ob is not None and ob._table is None:
            in_t = ob.children[0].table
            hook = getattr(in_t, "order_by_limit", None)
            if hook is not None:
                t = hook(ob.sort_cols(), skip + v)
                if t is not None:
                    return t.skip(skip) if skip else t
        return self.children[0].table.limit(v)


class UnwindOp(RelationalOperator):
    def __init__(self, in_op: RelationalOperator, list_expr: E.Expr, fld: str, fld_type):
        super().__init__(in_op)
        self.list_expr = list_expr
        self.fld = fld
        self.fld_type = fld_type

    @cached_property
    def _var(self):
        return E.Var(self.fld).with_type(self.fld_type)

    def _compute_header(self) -> RecordHeader:
        return self.children[0].header.with_expr(self._var)

    def _compute_table(self) -> Table:
        in_op = self.children[0]
        col = self.header.column(self._var)
        return in_op.table.explode(
            self.list_expr, col, in_op.header, self.context.parameters
        )


class SwapStartEndOp(RelationalOperator):
    """Produce the reversed orientation of a relationship scan (START<->END
    columns swapped) — used for undirected expands (reference plans undirected
    as a union of both orientations, ``RelationalPlanner.scala``)."""

    def __init__(self, in_op: RelationalOperator, rel_var: E.Var):
        super().__init__(in_op)
        self.rel_var = rel_var

    def _compute_table(self) -> Table:
        h = self.children[0].header
        start = next(
            e for e in h.expressions_for(self.rel_var) if isinstance(e, E.StartNode)
        )
        end = next(
            e for e in h.expressions_for(self.rel_var) if isinstance(e, E.EndNode)
        )
        sc, ec = h.column(start), h.column(end)
        return self.children[0].table.rename({sc: ec, ec: sc})


# ---------------------------------------------------------------------------
# Binary ops
# ---------------------------------------------------------------------------


class JoinOp(RelationalOperator):
    """Equi-join on expression pairs; colliding rhs columns are renamed before
    the join and deduplicated after (reference ``Join``
    ``RelationalOperator.scala:423-449`` + ``safeJoin`` renaming
    ``TableOps.scala:146``)."""

    _counter = 0

    def __init__(
        self,
        lhs: RelationalOperator,
        rhs: RelationalOperator,
        join_exprs: Sequence[Tuple[E.Expr, E.Expr]],
        kind: str = "inner",
    ):
        super().__init__(lhs, rhs)
        self.join_exprs = list(join_exprs)
        self.kind = kind
        self._plan: Optional[Tuple] = None

    def _analyze(self):
        if self._plan is not None:
            return self._plan
        lhs, rhs = self.children
        lh, rh = lhs.header, rhs.header
        l_cols = set(lh.columns)
        renames: Dict[str, str] = {}
        for c in rh.columns:
            if c in l_cols:
                JoinOp._counter += 1
                renames[c] = f"__rjoin_{JoinOp._counter}_{c}"
        # rhs exprs not in lhs keep their (possibly renamed) column
        new_map: Dict[E.Expr, str] = {}
        drop_cols: List[str] = []
        for c in rh.columns:
            target = renames.get(c, c)
            exprs = rh.exprs_for_column(c)
            keep_exprs = [e for e in exprs if e not in lh]
            if keep_exprs:
                for e in keep_exprs:
                    new_map[e] = target
            elif target != c:
                drop_cols.append(target)
        # all rhs columns that were renamed but only duplicate lhs data get dropped;
        # join key columns from rhs are also dropped post-join
        header = RecordHeader(
            {**{e: lh.column(e) for e in lh.expressions}, **new_map},
            {**lh.paths, **rh.paths},
        )
        self._plan = (renames, new_map, drop_cols, header)
        return self._plan

    def _compute_header(self) -> RecordHeader:
        return self._analyze()[3]

    def _compute_table(self) -> Table:
        lhs, rhs = self.children
        renames, new_map, drop_cols, header = self._analyze()
        rt = rhs.table.rename(renames) if renames else rhs.table
        if self.kind == "cross":
            joined = lhs.table.join(rt, "cross", [])
        else:
            pairs = []
            for le, re_ in self.join_exprs:
                lc = lhs.header.column(le)
                rc = rhs.header.column(re_)
                pairs.append((lc, renames.get(rc, rc)))
            joined = lhs.table.join(rt, self.kind, pairs)
        # remove join-duplicate columns
        join_key_cols = []
        for le, re_ in self.join_exprs:
            rc = rhs.header.column(re_)
            rc2 = renames.get(rc, rc)
            keeps = new_map.values()
            if rc2 not in keeps and rc2 not in drop_cols and rc2 not in lhs.header.columns:
                join_key_cols.append(rc2)
        to_drop = [c for c in set(drop_cols) | set(join_key_cols) if c in joined.physical_columns]
        if to_drop:
            joined = joined.drop(to_drop)
        return joined

    def _show_inner(self) -> str:
        pairs = ", ".join(
            f"{l.pretty_expr()}={r.pretty_expr()}" for l, r in self.join_exprs
        )
        return f"{self.kind} on [{pairs}]"


class UnionAllOp(RelationalOperator):
    """Union by aligned header expressions (reference ``TabularUnionAll``)."""

    def __init__(self, lhs: RelationalOperator, rhs: RelationalOperator):
        super().__init__(lhs, rhs)

    def _compute_header(self) -> RecordHeader:
        return self.children[0].header

    def _compute_table(self) -> Table:
        lhs, rhs = self.children
        lh, rh = lhs.header, rhs.header
        # map each lhs column onto the rhs column carrying the same expression
        pairs: Dict[str, str] = {}
        for e in lh.expressions:
            if e not in rh:
                raise RelationalError(
                    f"UNION branches differ: missing {e.pretty_expr()} on rhs"
                )
            lc, rc = lh.column(e), rh.column(e)
            if pairs.setdefault(lc, rc) != rc:
                raise RelationalError(
                    f"UNION branches map column {lc} ambiguously"
                )
        if len(set(pairs.values())) != len(pairs):
            raise RelationalError(
                "UNION requires a distinct rhs column per lhs column"
            )
        rt = rhs.table.select(list(pairs.values()))
        rt = rt.rename({rc: lc for lc, rc in pairs.items() if rc != lc})
        cols = lh.columns
        return lhs.table.select(cols).union_all(rt.select(cols))


def _static_value(expr: E.Expr, params: Dict[str, Any]):
    """Constant-fold a variable-free SKIP/LIMIT expression (literals,
    parameters, and arithmetic over them — ``SKIP 1 + 1``; reference
    ``SkipLimitAcceptance``). Anything mentioning a variable stays an
    error, matching openCypher's static requirement."""
    if isinstance(expr, E.Lit):
        return expr.value
    if isinstance(expr, E.Param):
        return params.get(expr.name)
    if isinstance(expr, E.Neg):
        v = _static_value(expr.expr, params)
        return -v if v is not None else None
    if isinstance(expr, (E.Add, E.Subtract, E.Multiply, E.Divide, E.Modulo)):
        l = _static_value(expr.lhs, params)
        r = _static_value(expr.rhs, params)
        if l is None or r is None:
            return None
        if isinstance(expr, E.Add):
            return l + r
        if isinstance(expr, E.Subtract):
            return l - r
        if isinstance(expr, E.Multiply):
            return l * r
        both_int = isinstance(l, int) and isinstance(r, int)
        if isinstance(expr, E.Divide):
            if both_int:
                if r == 0:
                    raise RelationalError("/ by zero")
                q = abs(l) // abs(r)  # Cypher int division truncates to zero
                return q if (l >= 0) == (r >= 0) else -q
            return l / r
        if both_int:
            if r == 0:
                raise RelationalError("% by zero")
            m = abs(l) % abs(r)
            return m if l >= 0 else -m
        return math.fmod(l, r)
    raise RelationalError(
        f"Expected a literal or parameter, got {expr.pretty_expr()}"
    )
