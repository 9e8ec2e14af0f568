"""Relational planner: logical operators -> physical operator tree.

Re-design of the reference ``RelationalPlanner``
(``okapi-relational/.../impl/planning/RelationalPlanner.scala:55-610``):

* Expand      = relationship scan + 2 hash joins (``:130-165``)
* ExpandInto  = 1 join on both endpoints (``:167-189``)
* undirected  = union of both rel orientations
* Optional    = left outer join on the common fields (``:298``)
* Exists      = distinct + true-flag + left outer join + IsNotNull (``:224-246``)
* var-length  = bounded unrolled join loop with per-step edge-distinctness
                filters (``VarLengthExpandPlanner.scala:45-330``)
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional as Opt, Sequence, Tuple

from ..api import types as T
from ..ir import expr as E
from ..logical import ops as L
from .header import (
    RecordHeader,
    header_for_node,
    header_for_relationship,
    path_nodes_companion,
)
from .ops import (
    AddOp,
    AliasOp,
    AggregateOp,
    CacheOp,
    DistinctOp,
    DropOp,
    EmptyRecordsOp,
    FilterOp,
    JoinOp,
    LimitOp,
    OrderByOp,
    PathBindOp,
    RelationalError,
    RelationalOperator,
    RelationalRuntimeContext,
    SelectOp,
    SkipOp,
    StartOp,
    SwapStartEndOp,
    TableOp,
    UnionAllOp,
    UnwindOp,
)


class RelationalPlanner:
    def __init__(self, ctx: RelationalRuntimeContext, driving_table=None, driving_header=None):
        self.ctx = ctx
        self.driving_table = driving_table
        self.driving_header = driving_header
        self._fresh = itertools.count()
        # graphs created by CONSTRUCT earlier in THIS query: later clauses
        # (MATCH after CONSTRUCT — Cypher 10 query continuation) Start from
        # the constructed QGN before the session catalog is consulted
        self.constructed_graphs = {}

    def resolve_graph(self, qgn):
        got = self.constructed_graphs.get(qgn)
        return got if got is not None else self.ctx.resolve_graph(qgn)

    def fresh(self, prefix: str) -> str:
        return f"__{prefix}_{next(self._fresh)}"

    # ------------------------------------------------------------------

    def process(self, op: L.LogicalOperator) -> RelationalOperator:
        # Memoize by logical-node identity: shared logical subtrees (Optional /
        # Exists rhs contain the lhs subtree) map to the SAME relational
        # operator, whose lazily computed table is cached — the analog of the
        # reference's InsertCachingOperators duplicate-subtree pass
        # (RelationalOptimizer.scala:41-90).
        if not hasattr(self, "_memo"):
            self._memo: Dict[int, RelationalOperator] = {}
        key = id(op)
        got = self._memo.get(key)
        if got is not None:
            return got
        method = getattr(self, f"_plan_{type(op).__name__}", None)
        if method is None:
            raise RelationalError(f"No physical planning for {type(op).__name__}")
        out = method(op)
        self._memo[key] = out
        return out

    # -- leaves ---------------------------------------------------------

    def _plan_Start(self, op: L.Start) -> RelationalOperator:
        graph = self.resolve_graph(op.qgn)
        return StartOp(graph, self.ctx)

    def _plan_DrivingTable(self, op: L.DrivingTable) -> RelationalOperator:
        graph = self.resolve_graph(op.qgn)
        return StartOp(graph, self.ctx, self.driving_table, self.driving_header)

    def _plan_EmptyRecords(self, op: L.EmptyRecords) -> RelationalOperator:
        graph = self.resolve_graph(op.qgn)
        h = RecordHeader()
        for name, t in op.empty_fields:
            m = t.material
            if isinstance(m, T.CTNodeType):
                h = header_for_node(name, m, graph.schema, h)
            elif isinstance(m, T.CTRelationshipType):
                h = header_for_relationship(name, m, graph.schema, h)
            else:
                h = h.with_expr(E.Var(name).with_type(t))
        return EmptyRecordsOp(graph, self.ctx, h)

    # -- scans ----------------------------------------------------------

    def _plan_NodeScan(self, op: L.NodeScan) -> RelationalOperator:
        in_plan = self.process(op.in_op)
        scan = in_plan.graph.scan_operator(op.fld, op.node_type.material, self.ctx)
        if in_plan.header.expressions:
            return JoinOp(in_plan, scan, [], "cross")
        return scan

    def _plan_PatternScan(self, op: L.PatternScan) -> RelationalOperator:
        """One scan binding every field of a stored composite pattern
        (reference ``RelationalPlanner`` PatternScan case + ``ScanGraph
        .scanOperator``); no joins — the point of the rewrite."""
        in_plan = self.process(op.in_op)
        by_field = dict(op.binds)
        entity_fields = tuple(
            (entity, field, by_field[field]) for entity, field in op.entity_map
        )
        scan = in_plan.graph.pattern_scan_op(entity_fields, op.pattern, self.ctx)
        if in_plan.header.expressions:
            return JoinOp(in_plan, scan, [], "cross")
        return scan

    # -- unary ----------------------------------------------------------

    def _plan_Filter(self, op: L.Filter) -> RelationalOperator:
        child = self.process(op.in_op)
        fast = getattr(self.ctx.table_cls, "plan_filter_fastpath", None)
        if fast is not None:
            out = fast(self, op, child)
            if out is not None:
                return out
        return FilterOp(child, op.predicate)

    def _plan_BindPath(self, op: L.BindPath) -> RelationalOperator:
        return PathBindOp(self.process(op.in_op), op.path_var, op.entities)

    def _plan_Project(self, op: L.Project) -> RelationalOperator:
        in_plan = self.process(op.in_op)
        expr = op.projection
        fld = op.fld
        if fld is None:
            return in_plan
        if isinstance(expr, E.Var) and expr.name != fld:
            # pure alias: share columns (reference Alias op)
            existing = {v.name for v in in_plan.header.vars}
            if expr.name in existing and fld not in existing:
                orig = in_plan.header.var(expr.name)
                alias = E.Var(fld).with_type(expr.cypher_type or orig.typ)
                return AliasOp(in_plan, [(orig, alias)])
        return AddOp(in_plan, expr, fld)

    def _plan_Aggregate(self, op: L.Aggregate) -> RelationalOperator:
        return AggregateOp(
            self.process(op.in_op), [n for n, _ in op.group], list(op.aggregations)
        )

    def _plan_Distinct(self, op: L.Distinct) -> RelationalOperator:
        return DistinctOp(self.process(op.in_op), list(op.on_fields))

    def _plan_Select(self, op: L.Select) -> RelationalOperator:
        return SelectOp(self.process(op.in_op), list(op.select_fields))

    def _plan_OrderBy(self, op: L.OrderBy) -> RelationalOperator:
        items = []
        for s in op.sort_items:
            assert isinstance(s.expr, E.Var), "sort exprs are pre-projected"
            items.append((s.expr.name, s.ascending))
        return OrderByOp(self.process(op.in_op), items)

    def _plan_Skip(self, op: L.Skip) -> RelationalOperator:
        return SkipOp(self.process(op.in_op), op.expr)

    def _plan_Limit(self, op: L.Limit) -> RelationalOperator:
        return LimitOp(self.process(op.in_op), op.expr)

    def _plan_Unwind(self, op: L.Unwind) -> RelationalOperator:
        return UnwindOp(self.process(op.in_op), op.list_expr, op.fld, op.fld_type)

    def _plan_FromGraph(self, op: L.FromGraph) -> RelationalOperator:
        in_plan = self.process(op.in_op)
        graph = self.resolve_graph(op.qgn)
        return TableOp(graph, self.ctx, in_plan.header, in_plan.table)

    def _plan_ReturnGraph(self, op: L.ReturnGraph) -> RelationalOperator:
        return self.process(op.in_op)

    def _plan_ConstructGraph(self, op: L.ConstructGraph) -> RelationalOperator:
        from .construct import plan_construct

        return plan_construct(self, op)

    # -- joins ----------------------------------------------------------

    def _plan_CartesianProduct(self, op: L.CartesianProduct) -> RelationalOperator:
        return JoinOp(self.process(op.lhs), self.process(op.rhs), [], "cross")

    def _plan_ValueJoin(self, op: L.ValueJoin) -> RelationalOperator:
        lhs, rhs = self.process(op.lhs), self.process(op.rhs)
        pairs: List[Tuple[E.Expr, E.Expr]] = []
        for eq in op.predicates:
            assert isinstance(eq, E.Equals)
            ids = self._element_ids(lhs, eq.lhs, rhs, eq.rhs)
            if ids is not None:
                pairs.append(ids)
                continue
            lhs, le = self._ensure_column(lhs, eq.lhs)
            rhs, re_ = self._ensure_column(rhs, eq.rhs)
            pairs.append((le, re_))
        return JoinOp(lhs, rhs, pairs, "inner")

    @staticmethod
    def _element_ids(lhs, le: E.Expr, rhs, re_: E.Expr) -> Opt[Tuple[E.Expr, E.Expr]]:
        """Two element variables of one kind join on their id columns: two
        elements are equal when their ids are. None for any other pair."""
        for kind in (T.CTNodeType, T.CTRelationshipType):
            if all(
                isinstance(e, E.Var) and isinstance(e.cypher_type.material, kind)
                for e in (le, re_)
            ):
                try:
                    ids = lhs.header.id_expr(le), rhs.header.id_expr(re_)
                except KeyError:
                    return None
                return ids if all(isinstance(i, E.Id) for i in ids) else None
        return None

    def _ensure_column(
        self, plan: RelationalOperator, expr: E.Expr
    ) -> Tuple[RelationalOperator, E.Expr]:
        if expr in plan.header:
            return plan, expr
        fld = self.fresh("jkey")
        plan = AddOp(plan, expr, fld)
        return plan, E.Var(fld).with_type(expr.cypher_type)

    @staticmethod
    def _correlated_names(op, lhs, rhs) -> List[str]:
        """Semijoin/group keys for a subquery: the fields the subquery
        actually references (``op.correlated``), restricted to those present
        on both sides. NOT all common columns — lhs columns the subquery
        never touches may be null (OPTIONAL MATCH), and null join keys
        would silently empty the subquery result."""
        lvars = {v.name for v in lhs.header.vars}
        rvars = {v.name for v in rhs.header.vars}
        return [n for n in op.correlated if n in lvars and n in rvars]

    def _common_join_pairs(
        self, lhs: RelationalOperator, rhs: RelationalOperator
    ) -> List[Tuple[E.Expr, E.Expr]]:
        pairs = []
        lh, rh = lhs.header, rhs.header
        lvars = {v.name for v in lh.vars}
        for v in rh.vars:
            if v.name in lvars:
                e = rh.id_expr(v)
                if e in lh:
                    pairs.append((e, e))
        return pairs

    def _plan_Optional(self, op: L.Optional) -> RelationalOperator:
        """Reference ``RelationalPlanner.scala:298``: Optional = left outer
        join — or the fused left-outer CSR expand when the backend offers
        one (classic join kept as the same-header shadow plan)."""
        lhs, rhs = self.process(op.lhs), self.process(op.rhs)
        pairs = self._common_join_pairs(lhs, rhs)
        classic = JoinOp(lhs, rhs, pairs, "left_outer")
        fast = getattr(self.ctx.table_cls, "plan_optional_expand_fastpath", None)
        if fast is not None:
            out = fast(self, op, lhs, rhs, classic)
            if out is not None:
                return out
        return classic

    def _plan_ExistsSubQuery(self, op: L.ExistsSubQuery) -> RelationalOperator:
        lhs, rhs = self.process(op.lhs), self.process(op.rhs)
        common = self._correlated_names(op, lhs, rhs)
        rhs_sel = DistinctOp(SelectOp(rhs, common), common)
        flag = self.fresh("flag")
        rhs_flag = AddOp(rhs_sel, E.Lit(True).with_type(T.CTBoolean), flag)
        pairs = self._common_join_pairs(lhs, rhs_flag)
        joined = JoinOp(lhs, rhs_flag, pairs, "left_outer")
        flag_var = E.Var(flag).with_type(T.CTBoolean)
        with_target = AddOp(
            joined, E.IsNotNull(flag_var).with_type(T.CTBoolean), op.target_field
        )
        return DropOp(with_target, [flag_var])

    def _plan_PatternComprehension(
        self, op: L.PatternComprehension
    ) -> RelationalOperator:
        """Collect the projection over rhs matches per outer row: project
        the value, group by the correlated outer vars collecting a list,
        left-outer-join the lists back, and default no-match rows to []."""
        lhs, rhs = self.process(op.lhs), self.process(op.rhs)
        common = self._correlated_names(op, lhs, rhs)
        val = self.fresh("pcval")
        rhs_val = AddOp(rhs, op.projection, val)
        rhs_sel = SelectOp(rhs_val, common + [val])
        lst = self.fresh("pclist")
        agg = E.Agg("collect", E.Var(val).with_type(op.projection.cypher_type))
        object.__setattr__(agg, "_typ", op.list_type)
        rhs_agg = AggregateOp(rhs_sel, common, [(lst, agg)])
        pairs = self._common_join_pairs(lhs, rhs_agg)
        joined = JoinOp(lhs, rhs_agg, pairs, "left_outer")
        lst_var = E.Var(lst).with_type(op.list_type)
        empty = E.ListLit(()).with_type(op.list_type)
        coalesced = E.FunctionCall("coalesce", (lst_var, empty)).with_type(
            op.list_type
        )
        with_target = AddOp(joined, coalesced, op.target_field)
        return DropOp(with_target, [lst_var])

    def _plan_TabularUnionAll(self, op: L.TabularUnionAll) -> RelationalOperator:
        return UnionAllOp(self.process(op.lhs), self.process(op.rhs))

    # -- expands ---------------------------------------------------------

    def _rel_scan(
        self, graph, rel: str, rel_type, direction: str
    ) -> RelationalOperator:
        scan = graph.scan_operator(rel, rel_type.material, self.ctx)
        if direction == "-":
            return self._undirected(scan, rel)
        return scan

    @staticmethod
    def _undirected(scan: RelationalOperator, rel: str) -> RelationalOperator:
        """Union of both orientations; the swapped side excludes self-loops
        (a loop's two orientations are the same variable binding, which
        openCypher matches once)."""
        var = scan.header.var(rel)
        start = RelationalPlanner._start_of(scan, rel)
        end = RelationalPlanner._end_of(scan, rel)
        no_loop = FilterOp(
            scan, E.Neq(start, end).with_type(T.CTBoolean)
        )
        return UnionAllOp(scan, SwapStartEndOp(no_loop, var))

    @staticmethod
    def _id_of(plan: RelationalOperator, name: str) -> E.Expr:
        return plan.header.id_expr(plan.header.var(name))

    @staticmethod
    def _start_of(plan: RelationalOperator, rel: str) -> E.Expr:
        v = plan.header.var(rel)
        return next(
            e for e in plan.header.expressions_for(v) if isinstance(e, E.StartNode)
        )

    @staticmethod
    def _end_of(plan: RelationalOperator, rel: str) -> E.Expr:
        v = plan.header.var(rel)
        return next(
            e for e in plan.header.expressions_for(v) if isinstance(e, E.EndNode)
        )

    def _plan_Expand(self, op: L.Expand) -> RelationalOperator:
        """Reference ``RelationalPlanner.scala:130-165``: rel scan + 2 joins —
        swapped for a fused CSR expand when the backend offers one (the
        classic cascade stays attached as the same-header shadow plan)."""
        classic = self._plan_expand_classic(op)
        fast = getattr(self.ctx.table_cls, "plan_expand_fastpath", None)
        if fast is not None:
            out = fast(self, op, self.process(op.lhs), self.process(op.rhs), classic)
            if out is not None:
                return out
        return classic

    def _plan_expand_classic(self, op: L.Expand) -> RelationalOperator:
        lhs = self.process(op.lhs)
        rhs = self.process(op.rhs)
        graph = rhs.graph
        rel_scan = self._rel_scan(graph, op.rel, op.rel_type, op.direction)
        lhs_fields = {v.name for v in lhs.header.vars}
        if op.source in lhs_fields:
            first = JoinOp(
                lhs,
                rel_scan,
                [(self._id_of(lhs, op.source), self._start_of(rel_scan, op.rel))],
            )
            return JoinOp(
                first,
                rhs,
                [(self._end_of(first, op.rel), self._id_of(rhs, op.target))],
            )
        # lhs solves the target; expand backwards
        first = JoinOp(
            lhs,
            rel_scan,
            [(self._id_of(lhs, op.target), self._end_of(rel_scan, op.rel))],
        )
        return JoinOp(
            first,
            rhs,
            [(self._start_of(first, op.rel), self._id_of(rhs, op.source))],
        )

    def _plan_ExpandInto(self, op: L.ExpandInto) -> RelationalOperator:
        """Reference ``RelationalPlanner.scala:167-189``: single join on both
        endpoints — or the fused CSR edge-key probe when available. When the
        ExpandInto CLOSES A CYCLE in the solved pattern graph it is first
        offered to the backend's multiway-intersect hook (worst-case-optimal
        join routing with EmptyHeaded-style degree-stats eligibility); the
        hook declines acyclic or small patterns and the binary plan stands."""
        classic = self._plan_expand_into_classic(op)
        in_plan = self.process(op.in_op)
        if self._closes_pattern_cycle(op):
            wcoj = getattr(
                self.ctx.table_cls, "plan_multiway_intersect_fastpath", None
            )
            if wcoj is not None:
                out = wcoj(self, op, in_plan, classic)
                if out is not None:
                    return out
        fast = getattr(self.ctx.table_cls, "plan_expand_into_fastpath", None)
        if fast is not None:
            out = fast(self, op, in_plan, classic)
            if out is not None:
                return out
        return classic

    @staticmethod
    def _closes_pattern_cycle(op: L.ExpandInto) -> bool:
        """Join-variable cycle detection: this ExpandInto closes a cycle iff
        its endpoints are already CONNECTED in the pattern graph of the
        solved subtree — union-find over the endpoint pair of every
        relationship-shaped logical node below (Expand / ExpandInto /
        var-length all carry ``source``/``target``). Both endpoints merely
        being bound is not enough: a cartesian product binds both sides of
        a disconnected pattern, and a multiway intersection buys nothing
        there."""
        parent: Dict[str, str] = {}

        def find(x: str) -> str:
            parent.setdefault(x, x)
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        stack: List[L.LogicalOperator] = [op.in_op]
        while stack:
            node = stack.pop()
            src = getattr(node, "source", None)
            tgt = getattr(node, "target", None)
            if isinstance(src, str) and isinstance(tgt, str):
                parent[find(src)] = find(tgt)
            stack.extend(node.children)
        return find(op.source) == find(op.target)

    def _plan_expand_into_classic(self, op: L.ExpandInto) -> RelationalOperator:
        in_plan = self.process(op.in_op)
        graph = in_plan.graph
        rel_scan = self._rel_scan(graph, op.rel, op.rel_type, op.direction)
        return JoinOp(
            in_plan,
            rel_scan,
            [
                (self._id_of(in_plan, op.source), self._start_of(rel_scan, op.rel)),
                (self._id_of(in_plan, op.target), self._end_of(rel_scan, op.rel)),
            ],
        )

    def _plan_BoundedVarLengthExpand(
        self, op: L.BoundedVarLengthExpand
    ) -> RelationalOperator:
        """Reference ``VarLengthExpandPlanner.scala:45-330``: unrolled iterated
        join with per-step edge-distinctness (isomorphism) filters; union of
        per-length results — or the fused CSR frontier loop when the backend
        offers one (classic cascade kept as the same-header shadow plan)."""
        classic = self._plan_var_expand_classic(op)
        fast = getattr(self.ctx.table_cls, "plan_var_expand_fastpath", None)
        if fast is not None:
            out = fast(self, op, self.process(op.lhs), self.process(op.rhs), classic)
            if out is not None:
                return out
        return classic

    def _plan_var_expand_classic(self, op: L.BoundedVarLengthExpand) -> RelationalOperator:
        lhs = self.process(op.lhs)
        rhs = self.process(op.rhs)
        if op.upper is not None:
            branches = self._var_expand_branches(op, lhs, rhs, op.upper)
            out = branches[0]
            for b in branches[1:]:
                out = UnionAllOp(out, b)
            return out
        # unbounded '*': the step loop runs at TABLE time (FixpointVarExpandOp)
        # so planning stays lazy — relationship isomorphism bounds the walk
        # by the matching-edge count and the loop exits at the first empty
        # step. The reference rejects unbounded outright
        # (flink-cypher-tck/.../scenario_blacklist:6-7).
        return FixpointVarExpandOp(self, op, lhs, rhs)

    def _var_expand_branches(
        self,
        op: L.BoundedVarLengthExpand,
        lhs: RelationalOperator,
        rhs: RelationalOperator,
        upper: int,
        probe: bool = False,
        ctx: Opt[RelationalRuntimeContext] = None,
    ) -> List[RelationalOperator]:
        """Per-length result branches of the unrolled cascade. ``probe``
        (fixpoint evaluation) pulls each step's table and stops as soon as a
        step yields no rows; ``ctx`` overrides the planning context so
        branches built at table time inside a cloned plan use ITS context."""
        ctx = ctx or self.ctx
        graph = rhs.graph
        out_fields = [v.name for v in lhs.header.vars] + [op.target, op.rel]
        rel_elem_type = op.rel_type.material
        capture = getattr(op, "capture_path_nodes", False)
        node_companion = path_nodes_companion(op.rel)
        node_elem_type = T.CTNodeType(frozenset())
        if capture:
            out_fields.append(node_companion)

        def with_companion(branch, node_vars):
            if not capture:
                return branch
            items = tuple(E.Var(n).with_type(node_elem_type) for n in node_vars)
            expr = E.ListLit(items).with_type(T.CTListType(node_elem_type))
            return AddOp(branch, expr, node_companion)

        branches: List[RelationalOperator] = []
        if op.lower == 0:
            # length 0: target IS the source; empty relationship list
            # (reference VarLengthExpandPlanner zero-length init branch)
            zero = JoinOp(
                lhs, rhs, [(self._id_of(lhs, op.source), self._id_of(rhs, op.target))]
            )
            empty_list = E.ListLit(()).with_type(T.CTListType(rel_elem_type))
            zero = AddOp(zero, empty_list, op.rel)
            zero = with_companion(zero, [])
            branches.append(SelectOp(zero, out_fields))
        current = lhs
        step_vars: List[str] = []
        node_vars: List[str] = []  # intermediate hop nodes (named paths only)
        prev_end: E.Expr = self._id_of(lhs, op.source)
        for step in range(1, upper + 1):
            step_var = self.fresh(f"step_{op.rel}")
            scan = graph.scan_operator(step_var, rel_elem_type, ctx)
            if op.direction == "-":
                scan = self._undirected(scan, step_var)
            current = JoinOp(
                current, scan, [(prev_end, self._start_of(scan, step_var))]
            )
            # isomorphism: this edge differs from all previous edges
            for prev in step_vars:
                neq = E.Neq(
                    E.Id(E.Var(step_var).with_type(rel_elem_type)).with_type(T.CTInteger),
                    E.Id(E.Var(prev).with_type(rel_elem_type)).with_type(T.CTInteger),
                ).with_type(T.CTBoolean)
                current = FilterOp(current, neq)
            step_vars.append(step_var)
            prev_end = self._end_of(current, step_var)
            if probe and step > op.lower and int(current.table.size) == 0:
                break
            if step >= op.lower:
                branch = JoinOp(
                    current, rhs, [(prev_end, self._id_of(rhs, op.target))]
                )
                # materialize the rel-list variable
                items = tuple(
                    E.Var(s).with_type(rel_elem_type) for s in step_vars
                )
                list_expr = E.ListLit(items).with_type(T.CTListType(rel_elem_type))
                branch = AddOp(branch, list_expr, op.rel)
                branch = with_companion(branch, node_vars)
                branch = SelectOp(branch, out_fields)
                branches.append(branch)
            if capture and step < upper:
                # join the full node element at this hop boundary so named
                # paths carry real intermediate nodes, not id-only stubs
                nv = self.fresh(f"pn_{op.rel}")
                nscan = graph.scan_operator(nv, node_elem_type, ctx)
                current = JoinOp(
                    current, nscan, [(prev_end, self._id_of(nscan, nv))]
                )
                node_vars.append(nv)
        return branches


class FixpointVarExpandOp(RelationalOperator):
    """Unbounded ``*`` var-length expand: evaluates the unrolled cascade
    step by step at table-compute time, stopping at the empty-frontier
    fixpoint, with the matching-edge count as the hard bound (relationship
    isomorphism forbids longer walks). The count tier is handled upstream by
    the fused CSR op; this is the materializing tier."""

    def __init__(self, planner: "RelationalPlanner", op, lhs, rhs):
        super().__init__(lhs, rhs)
        self._planner = planner
        self._op = op

    def _compute_header(self) -> RecordHeader:
        lhs, rhs = self.children
        shape = self._planner._var_expand_branches(
            self._op, lhs, rhs, max(self._op.lower, 1), ctx=lhs.context
        )
        return shape[0].header

    def _compute_table(self):
        lhs, rhs = self.children
        ctx = lhs.context
        op = self._op
        probe = rhs.graph.scan_operator(
            self._planner.fresh(f"cnt_{op.rel}"), op.rel_type.material, ctx
        )
        upper = max(int(probe.table.size), op.lower, 1)
        branches = self._planner._var_expand_branches(
            op, lhs, rhs, upper, probe=True, ctx=ctx
        )
        out = branches[0]
        for b in branches[1:]:
            out = UnionAllOp(out, b)
        return out.table

    def _show_inner(self) -> str:
        return (
            f"({self._op.source})-[{self._op.rel}*{self._op.lower}..]->"
            f"({self._op.target})"
        )


def plan_relational(
    logical_plan: L.LogicalOperator,
    ctx: RelationalRuntimeContext,
    driving_table=None,
    driving_header=None,
) -> RelationalOperator:
    from ..optimizer.joinorder import maybe_reorder

    logical_plan = maybe_reorder(logical_plan, ctx)
    return RelationalPlanner(ctx, driving_table, driving_header).process(logical_plan)
