"""Logical planner: IR blocks -> logical operator tree.

Re-design of the reference ``LogicalPlanner``
(``okapi-logical/.../impl/LogicalPlanner.scala:47``, planBlock/planLeaf/
planNonLeaf ``:93-190``) and ``LogicalOperatorProducer``: connected-component
analysis of match patterns produces Expand chains joined by CartesianProduct;
optional matches become ``Optional``; pattern predicates become
``ExistsSubQuery``; projections/aggregations/slices map 1:1 onto operators.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field as dc_field, replace as dc_replace
from typing import Dict, List, Optional as Opt, Set, Tuple

from ..api import types as T
from ..frontend.ast import SortItem
from ..ir import blocks as B
from ..ir import expr as E
from ..ir.pattern import BOTH, Connection, IRPattern
from . import ops as L


class LogicalPlanningError(Exception):
    pass


@dataclass
class LogicalPlannerContext:
    working_graph: str = "session.ambient"
    input_fields: L.FieldsT = ()


class LogicalPlanner:
    def __init__(self, ctx: LogicalPlannerContext):
        self.ctx = ctx
        self._fresh = itertools.count()
        # path var -> member entity fields (shadowing checks: a projection
        # that rebinds a member name must not corrupt later path reads)
        self._path_entities: Dict[str, Tuple[str, ...]] = {}

    def fresh(self, prefix: str) -> str:
        return f"__{prefix}_{next(self._fresh)}"

    # ------------------------------------------------------------------

    def plan(self, ir) -> L.LogicalOperator:
        if isinstance(ir, B.UnionIR):
            plans = [self.plan(q) for q in ir.queries]
            out = plans[0]
            for p in plans[1:]:
                out = L.TabularUnionAll(out, p)
            if not ir.all:
                out = L.Distinct(out, tuple(ir.returns or ()))
            return out
        assert isinstance(ir, B.QueryIR)
        graph = ir.source_graph
        if self.ctx.input_fields:
            plan: L.LogicalOperator = L.DrivingTable(graph, self.ctx.input_fields)
        else:
            plan = L.Start(graph, ())
        for blk in ir.blocks:
            plan = self.plan_block(blk, plan)
        return plan

    # ------------------------------------------------------------------

    def plan_block(self, blk: B.Block, plan: L.LogicalOperator) -> L.LogicalOperator:
        if isinstance(blk, B.MatchBlock):
            return self.plan_match(blk, plan)
        if isinstance(blk, B.ProjectBlock):
            # All items are evaluated against the PRE-projection scope
            # (simultaneous assignment: WITH a AS b, b AS a must swap).
            assigned = {
                name
                for name, ex in blk.items
                if not (isinstance(ex, E.Var) and ex.name == name)
            }

            # paths materialize LAZILY from their member columns, so a
            # projection that rebinds a member name (RETURN x.name AS x
            # with p = (x)-->(y) in scope) would corrupt every later path
            # read. Re-alias the shadowed members to hidden names and
            # re-register the path over them BEFORE any rebinding — the
            # hidden names are never assigned, so the path survives both
            # same-block reads (p IS NULL) and being carried forward (p).
            in_fields = dict(plan.fields)
            for pname, fields in list(self._path_entities.items()):
                if pname in assigned or pname not in in_fields:
                    # the path name itself is rebound / out of scope: it is
                    # no longer a live path — drop the stale registration
                    self._path_entities.pop(pname, None)
                    continue
                if not any(m in assigned for m in fields):
                    continue
                new_fields = []
                for m in fields:
                    if m in assigned and m in in_fields:
                        hid = self.fresh("pmem")
                        plan = L.Project(
                            plan, E.Var(m).with_type(in_fields[m]), hid
                        )
                        new_fields.append(hid)
                    else:
                        new_fields.append(m)
                plan = L.BindPath(plan, pname, tuple(new_fields))
                self._path_entities[pname] = tuple(new_fields)

            def _referenced(ex: E.Expr) -> set:
                # a PATH var reference depends on its member entities too
                names = {v.name for v in E.walk_vars(ex)}
                for n in list(names):
                    names |= set(self._path_entities.get(n, ()))
                return names

            item_refs = [
                (name, ex, _referenced(ex))
                for name, ex in blk.items
                if not (isinstance(ex, E.Var) and ex.name == name)
            ]
            needs_temps = any(
                name in refs and name != other
                for other, _, refs in item_refs
                for name in assigned
            )
            if needs_temps:
                renames: List[Tuple[str, E.Expr]] = []
                for name, ex in blk.items:
                    if isinstance(ex, E.Var) and ex.name == name:
                        continue
                    ex, plan = self._extract_exists(ex, plan)
                    tmp = self.fresh("proj")
                    plan = L.Project(plan, ex, tmp)
                    renames.append((name, E.Var(tmp).with_type(ex.cypher_type)))
                for name, var in renames:
                    plan = L.Project(plan, var, name)
            else:
                for name, ex in blk.items:
                    if isinstance(ex, E.Var) and ex.name == name:
                        continue
                    ex, plan = self._extract_exists(ex, plan)
                    plan = L.Project(plan, ex, name)
            return plan
        if isinstance(blk, B.AggregationBlock):
            for name, ex in blk.group:
                if not (isinstance(ex, E.Var) and ex.name == name):
                    ex, plan = self._extract_exists(ex, plan)
                    plan = L.Project(plan, ex, name)
            # aggregation INPUTS can hold exists patterns too:
            # count(exists((a)-->())) / sum(CASE WHEN exists(...) ...)
            aggs = []
            for name, agg in blk.aggregations:
                inner = getattr(agg, "expr", None)
                if inner is not None and any(
                    isinstance(nd, E.ExistsPattern) for nd in inner.iter_nodes()
                ):
                    inner, plan = self._extract_exists(inner, plan)
                    rebuilt = dc_replace(agg, expr=inner)
                    # dataclasses.replace drops the typer's non-field _typ —
                    # restore it or the output column degrades to ANY?
                    if agg.typ is not None:
                        rebuilt = rebuilt.with_type(agg.typ)
                    agg = rebuilt
                aggs.append((name, agg))
            d = dict(plan.fields)
            group = tuple((n, d[n]) for n, _ in blk.group)
            return L.Aggregate(plan, group, tuple(aggs))
        if isinstance(blk, B.FilterBlock):
            return self._plan_predicate(blk.predicate, plan)
        if isinstance(blk, B.DistinctBlock):
            return L.Distinct(plan, blk.fields)
        if isinstance(blk, B.OrderAndSliceBlock):
            if blk.sort_items:
                items: List[SortItem] = []
                for s in blk.sort_items:
                    if isinstance(s.expr, E.Var):
                        items.append(s)
                    else:
                        ex, plan = self._extract_exists(s.expr, plan)
                        f = self.fresh("sort")
                        plan = L.Project(plan, ex, f)
                        items.append(
                            SortItem(E.Var(f).with_type(ex.cypher_type), s.ascending)
                        )
                plan = L.OrderBy(plan, tuple(items))
            if blk.skip is not None:
                plan = L.Skip(plan, blk.skip)
            if blk.limit is not None:
                plan = L.Limit(plan, blk.limit)
            return plan
        if isinstance(blk, B.UnwindBlock):
            lx, plan = self._extract_exists(blk.list_expr, plan)
            inner = lx.cypher_type.material
            t = inner.inner if isinstance(inner, T.CTListType) else T.CTAny.nullable
            return L.Unwind(plan, lx, blk.fld, t)
        if isinstance(blk, (B.SelectBlock, B.ResultBlock)):
            current = tuple(n for n, _ in plan.fields)
            if current == tuple(blk.fields):
                return plan
            return L.Select(plan, tuple(blk.fields))
        if isinstance(blk, B.FromGraphBlock):
            return L.FromGraph(plan, blk.qgn)
        if isinstance(blk, B.GraphResultBlock):
            return L.ReturnGraph(plan)
        if isinstance(blk, B.ConstructBlock):
            # SET / property-map values may contain subquery expressions
            # (exists, pattern comprehensions) — extract them into the
            # binding plan before the construct consumes it
            import dataclasses

            def _ex(items):
                nonlocal plan
                out = []
                for owner, key, expr in items:
                    ex, plan = self._extract_exists(expr, plan)
                    out.append((owner, key, ex))
                return tuple(out)

            new_properties = _ex(blk.new_properties)
            sets = _ex(blk.sets)
            if new_properties != blk.new_properties or sets != blk.sets:
                blk = dataclasses.replace(
                    blk, new_properties=new_properties, sets=sets
                )
            return L.ConstructGraph(plan, blk, self.fresh("constructed"))
        raise LogicalPlanningError(f"Cannot plan block {type(blk).__name__}")

    # ------------------------------------------------------------------
    # MATCH planning
    # ------------------------------------------------------------------

    def plan_match(self, blk: B.MatchBlock, plan: L.LogicalOperator) -> L.LogicalOperator:
        # paths bind before predicates so WHERE can reference the path var
        if blk.optional:
            rhs = self._plan_pattern(blk.pattern, plan)
            for pname, fields in sorted(blk.pattern.paths.items()):
                rhs = L.BindPath(rhs, pname, tuple(fields))
                self._path_entities[pname] = tuple(fields)
            for p in blk.predicates:
                rhs = self._plan_predicate(p, rhs)
            return L.Optional(plan, rhs)
        plan = self._plan_pattern(blk.pattern, plan)
        for pname, fields in sorted(blk.pattern.paths.items()):
            plan = L.BindPath(plan, pname, tuple(fields))
            self._path_entities[pname] = tuple(fields)
        for p in blk.predicates:
            plan = self._plan_predicate(p, plan)
        return plan

    def _plan_pattern(
        self, pattern: IRPattern, base: L.LogicalOperator
    ) -> L.LogicalOperator:
        graph = base.graph_name
        bound: Set[str] = {n for n, _ in base.fields}
        solved_nodes: Set[str] = {n for n in pattern.node_types if n in bound}
        unsolved_conns: Dict[str, Connection] = {
            r: c for r, c in pattern.topology.items() if r not in bound
        }
        plan = base

        def node_scan(fld: str, on: Opt[L.LogicalOperator] = None) -> L.LogicalOperator:
            src = on if on is not None else L.Start(graph, ())
            return L.NodeScan(src, fld, pattern.node_types[fld])

        # deterministic component order: components containing bound nodes
        # first, then fixed-length-only components before ones with
        # var-length connections (so fixed rels are in scope when a
        # var-length plans — its isomorphism-vs-fixed predicates can then
        # push into the fused walk as forbidden edges instead of filtering
        # a materialized rel list), then by smallest member name
        def comp_key(comp):
            has_var = any(
                c.is_var_length
                for r, c in unsolved_conns.items()
                if c.source in comp or c.target in comp
            )
            return (not any(n in bound for n in comp), has_var, sorted(comp)[0])

        comps = sorted(pattern.components(), key=comp_key)
        for comp in comps:
            comp_conns = {
                r: c
                for r, c in unsolved_conns.items()
                if c.source in comp or c.target in comp
            }
            if not any(n in solved_nodes for n in comp):
                # need a fresh scan to anchor this component
                start = self._pick_start(comp, pattern)
                scan = node_scan(start)
                if not plan.fields and isinstance(plan, L.Start):
                    plan = scan
                else:
                    plan = L.CartesianProduct(plan, scan)
                solved_nodes.add(start)
            # expand until the whole component is solved
            while comp_conns:
                progress = False
                for r in sorted(
                    comp_conns, key=lambda n: (comp_conns[n].is_var_length, n)
                ):
                    c = comp_conns[r]
                    src_solved = c.source in solved_nodes
                    dst_solved = c.target in solved_nodes
                    if not (src_solved or dst_solved):
                        continue
                    plan = self._plan_connection(
                        plan, pattern, r, c, src_solved, dst_solved, graph
                    )
                    solved_nodes.add(c.source)
                    solved_nodes.add(c.target)
                    del comp_conns[r]
                    del unsolved_conns[r]
                    progress = True
                    break
                if not progress:  # pragma: no cover - components guarantee progress
                    raise LogicalPlanningError("Disconnected pattern component")
            # isolated unsolved nodes (no connections)
            for n in sorted(comp):
                if n not in solved_nodes:
                    plan = L.CartesianProduct(plan, node_scan(n))
                    solved_nodes.add(n)
        return plan

    @staticmethod
    def _pick_start(comp, pattern: IRPattern) -> str:
        # prefer labelled nodes (cheaper scans), then name determinism
        def key(n):
            t = pattern.node_types[n]
            return (-len(t.labels), n)

        return min(comp, key=key)

    def _plan_connection(
        self,
        plan: L.LogicalOperator,
        pattern: IRPattern,
        rel: str,
        c: Connection,
        src_solved: bool,
        dst_solved: bool,
        graph: str,
    ) -> L.LogicalOperator:
        rel_type = pattern.rel_types[rel]
        if not c.is_var_length:
            if src_solved and dst_solved:
                return L.ExpandInto(plan, c.source, rel, rel_type, c.target, c.direction)
            new_node = c.target if src_solved else c.source
            scan = L.NodeScan(L.Start(graph, ()), new_node, pattern.node_types[new_node])
            return L.Expand(plan, scan, c.source, rel, rel_type, c.target, c.direction)
        # var-length; upper None = unbounded, resolved at relational planning
        upper = c.upper
        capture = any(rel in fields for fields in pattern.paths.values())
        if dst_solved and not src_solved:
            # the walk reached this connection from its TARGET: the classic
            # cascade and the fused frontier loop both expand FROM the
            # source, so bring the source into the plan (cartesian) and
            # reuse the both-solved alignment below. The optimizer's
            # filter/value-join rewrites then tighten the product.
            scan = L.NodeScan(
                L.Start(graph, ()), c.source, pattern.node_types[c.source]
            )
            plan = L.CartesianProduct(plan, scan)
            src_solved = True
        if src_solved and dst_solved:
            # expand to a fresh target, then align on id equality
            fresh_t = self.fresh(f"vt_{c.target}")
            t_type = pattern.node_types[c.target]
            scan = L.NodeScan(L.Start(graph, ()), fresh_t, t_type)
            expand = L.BoundedVarLengthExpand(
                plan, scan, c.source, rel, rel_type, fresh_t, c.direction,
                c.lower, upper, capture,
            )
            eq = E.Equals(
                E.Id(E.Var(fresh_t).with_type(t_type)).with_type(T.CTInteger),
                E.Id(E.Var(c.target).with_type(t_type)).with_type(T.CTInteger),
            ).with_type(T.CTBoolean)
            return L.Filter(expand, eq)
        new_node = c.target if src_solved else c.source
        scan = L.NodeScan(L.Start(graph, ()), new_node, pattern.node_types[new_node])
        return L.BoundedVarLengthExpand(
            plan, scan, c.source, rel, rel_type, c.target, c.direction,
            c.lower, upper, capture,
        )

    # ------------------------------------------------------------------
    # predicates (incl. exists subqueries)
    # ------------------------------------------------------------------

    def _extract_exists(
        self, expr: E.Expr, plan: L.LogicalOperator
    ) -> Tuple[E.Expr, L.LogicalOperator]:
        """Replace every exists-pattern inside ``expr`` with the boolean
        flag var of a planned ``ExistsSubQuery`` (works in WHERE and in
        projections alike — reference
        ``extractSubqueryFromPatternExpression``)."""
        subs = [
            n
            for n in expr.iter_nodes()
            if isinstance(n, (E.ExistsPattern, E.PatternComprehension))
        ]
        mapping: Dict[E.Expr, E.Expr] = {}
        for ep in subs:
            sub_pattern = getattr(ep, "_ir_pattern", None)
            if sub_pattern is None:
                raise LogicalPlanningError(
                    f"{type(ep).__name__} missing IR pattern"
                )
            # the lhs fields the subquery actually references: pattern vars
            # plus free vars of its predicates/projection (including inside
            # nested subquery bodies). These are the semijoin/group keys —
            # joining on ALL common columns breaks under null outer columns
            # (OPTIONAL MATCH): null keys never match, silently emptying
            # the subquery result
            lhs_fields = {n for n, _ in plan.fields}
            used = (
                set(sub_pattern.node_types)
                | set(sub_pattern.rel_types)
                | set(sub_pattern.paths)
            )
            for p in getattr(ep, "_ir_predicates", ()):
                used |= _subquery_free_vars(p)
            if isinstance(ep, E.ExistsPattern):
                correlated = tuple(sorted(used & lhs_fields))
                target = ep.target_field or self.fresh("exists")
                rhs = self._plan_pattern(sub_pattern, plan)
                for p in getattr(ep, "_ir_predicates", ()):
                    rhs = self._plan_predicate(p, rhs)
                plan = L.ExistsSubQuery(plan, rhs, target, correlated)
                mapping[ep] = E.Var(target).with_type(T.CTBoolean)
                continue
            target = ep.target_field or self.fresh("pc")
            used |= _subquery_free_vars(ep._ir_projection)
            correlated = tuple(sorted(used & lhs_fields))
            # expand from outer rows deduplicated on the CORRELATED fields
            # (the collect group keys): outer rows that are distinct in
            # other columns but share the correlated bindings must drive
            # the pattern exactly once, or the collected list is inflated
            # by the duplicate count. An UNcorrelated comprehension is
            # driven by a single row (DistinctOp treats an empty field list
            # as distinct-over-all, which would keep the duplicates).
            if correlated:
                dedup: L.LogicalOperator = L.Distinct(plan, correlated)
            else:
                dedup = L.Limit(plan, E.Lit(1).with_type(T.CTInteger))
            rhs = self._plan_pattern(sub_pattern, dedup)
            for pname, fields in sorted(sub_pattern.paths.items()):
                rhs = L.BindPath(rhs, pname, tuple(fields))
            for p in getattr(ep, "_ir_predicates", ()):
                rhs = self._plan_predicate(p, rhs)
            # nested comprehensions/exists in the projection extract into rhs
            proj, rhs = self._extract_exists(ep._ir_projection, rhs)
            list_type = T.CTListType(proj.cypher_type)
            plan = L.PatternComprehension(
                plan, rhs, proj, target, list_type, correlated
            )
            mapping[ep] = E.Var(target).with_type(list_type)
        if mapping:
            expr = E.substitute(expr, mapping)
        return expr, plan

    def _plan_predicate(self, pred: E.Expr, plan: L.LogicalOperator) -> L.LogicalOperator:
        pred, plan = self._extract_exists(pred, plan)
        return L.Filter(plan, pred)


def _subquery_free_vars(expr: E.Expr) -> set:
    """Variable names an expression references, INCLUDING inside nested
    subquery bodies (exists patterns / pattern comprehensions), whose inner
    expressions are boxed away from generic traversal."""
    out = set()
    stack = [expr]
    while stack:
        e = stack.pop()
        for n in e.iter_nodes():
            if isinstance(n, E.Var):
                out.add(n.name)
            if isinstance(n, (E.ExistsPattern, E.PatternComprehension)):
                sub = getattr(n, "_ir_pattern", None)
                if sub is not None:
                    out |= (
                        set(sub.node_types)
                        | set(sub.rel_types)
                        | set(sub.paths)
                    )
                stack.extend(getattr(n, "_ir_predicates", ()))
                inner = getattr(n, "_ir_projection", None)
                if inner is not None:
                    stack.append(inner)
    return out


def plan_logical(ir, ctx: Opt[LogicalPlannerContext] = None) -> L.LogicalOperator:
    return LogicalPlanner(ctx or LogicalPlannerContext()).plan(ir)
