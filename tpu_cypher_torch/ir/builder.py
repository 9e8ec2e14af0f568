"""IR builder: frontend AST -> typed block pipeline.

Re-design of the reference's eff-monad IR builder
(``okapi-ir/.../impl/IRBuilder.scala:51``, clause match at ``:71-690``) plus its
``ExpressionConverter``/``PatternConverter`` and incremental typer
(``impl/typer/TypeTracker.scala``): a single pass that

* converts patterns to :class:`~tpu_cypher.ir.pattern.IRPattern` (fresh names
  for anonymous entities, property maps lowered to equality predicates —
  matching the reference's pattern conversion),
* converts + types expressions against the scope environment and graph schema
  (label info refines ``CTNode`` types; property lookups consult the schema),
* performs aggregation isolation (reference ``isolateAggregation`` rewriter):
  projection items containing aggregators are split into an AggregationBlock
  over extracted aggregates plus a post-projection,
* tracks the WITH/RETURN horizon discipline via Select blocks,
* handles multiple-graph clauses (FROM GRAPH switching the schema context,
  CONSTRUCT, RETURN GRAPH) and CATALOG statements.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from ..api import types as T
from ..api.schema import PropertyGraphSchema
from ..api.types import CypherType
from ..frontend import ast as A
from ..frontend.lexer import CypherSyntaxError
from . import blocks as B
from . import expr as E
from .functions import CypherTypeError, lookup as lookup_function
from .pattern import BOTH, INCOMING, OUTGOING, Connection, IRPattern


class IRBuildError(Exception):
    pass


# clauses that make a single query a WRITE query (docs/mutation.md)
_WRITE_CLAUSES = (A.CreateClause, A.MergeClause, A.SetClause, A.DeleteClause)


class UnsupportedFeatureError(IRBuildError):
    """A feature the grammar accepts but the engine does not execute
    (procedure calls). The reference's analog: its frontend parses CALL and
    the backends blacklist ProcedureCallAcceptance at TCK level."""


@dataclass
class IRBuilderContext:
    schema: PropertyGraphSchema
    parameters: Dict[str, Any] = dc_field(default_factory=dict)
    catalog_schemas: Dict[str, PropertyGraphSchema] = dc_field(default_factory=dict)
    working_graph: str = "session.ambient"
    # driving-table input fields (session.cypher(query, drivingTable))
    input_fields: Dict[str, CypherType] = dc_field(default_factory=dict)


class IRBuilder:
    def __init__(self, ctx: IRBuilderContext):
        self.ctx = ctx
        self.schema = ctx.schema
        self._fresh = itertools.count()

    # ------------------------------------------------------------------
    def fresh_name(self, prefix: str = "a") -> str:
        return f"__{prefix}{next(self._fresh)}"

    def build(self, stmt: A.Statement):
        if isinstance(stmt, A.SingleQuery):
            if any(isinstance(c, _WRITE_CLAUSES) for c in stmt.clauses):
                return self._build_update(stmt)
            return self._build_single(stmt)
        if isinstance(stmt, A.UnionQuery):
            irs = [self._build_single(q) for q in stmt.queries]
            cols = irs[0].returns
            for ir in irs[1:]:
                if ir.returns != cols:
                    raise IRBuildError(
                        f"UNION requires same return columns: {cols} vs {ir.returns}"
                    )
            return B.UnionIR(tuple(irs), all=stmt.all, returns=cols)
        if isinstance(stmt, A.CreateGraphStatement):
            inner = IRBuilder(self.ctx).build(stmt.inner)
            if isinstance(inner, B.UpdateIR):
                raise IRBuildError(
                    "CREATE GRAPH inner queries cannot contain write "
                    "clauses (use FROM/CONSTRUCT/RETURN GRAPH)"
                )
            return B.CreateGraphIR(stmt.qgn, inner)
        if isinstance(stmt, A.CreateViewStatement):
            return B.CreateViewIR(stmt.name, stmt.params, stmt.inner_text)
        if isinstance(stmt, A.DropGraphStatement):
            return B.DropGraphIR(stmt.qgn, stmt.view)
        raise IRBuildError(f"Unsupported statement {type(stmt).__name__}")

    # ------------------------------------------------------------------

    def _build_single(self, q: A.SingleQuery) -> B.QueryIR:
        env: Dict[str, CypherType] = dict(self.ctx.input_fields)
        blocks: List[B.Block] = []
        returns: Optional[Tuple[str, ...]] = None
        clauses = list(q.clauses)
        i = 0
        saw_return = False
        while i < len(clauses):
            c = clauses[i]
            if isinstance(c, A.Match):
                blocks.extend(self._convert_match(c, env))
            elif isinstance(c, A.Unwind):
                lst = self.convert_expr(c.expr, env)
                inner = self._list_inner_type(lst.cypher_type)
                blocks.append(B.UnwindBlock(lst, c.var))
                env[c.var] = inner
            elif isinstance(c, (A.With, A.Return)) and not isinstance(c, A.ReturnGraph):
                is_return = isinstance(c, A.Return)
                new_env, seg = self._convert_projection(c, env)
                blocks.extend(seg)
                env = new_env
                if is_return:
                    returns = tuple(env.keys())
                    blocks.append(B.ResultBlock(returns))
                    saw_return = True
            elif isinstance(c, A.FromGraph):
                if c.args:
                    # view invocations are expanded by the session BEFORE IR
                    # building; reaching here means the caller skipped
                    # CypherSession._expand_views
                    raise IRBuildError(
                        f"Unresolved view invocation {c.graph_name}(...) — "
                        "views resolve at the session level"
                    )
                qgn = self._resolve_qgn(c.graph_name)
                if qgn not in self.ctx.catalog_schemas:
                    raise IRBuildError(f"Unknown graph {qgn!r}")
                self.schema = self.ctx.catalog_schemas[qgn]
                blocks.append(B.FromGraphBlock(qgn))
            elif isinstance(c, A.ConstructClause):
                blocks.append(self._convert_construct(c, env))
            elif isinstance(c, A.ReturnGraph):
                blocks.append(B.GraphResultBlock())
                saw_return = True
            elif isinstance(c, _WRITE_CLAUSES):
                # single-query writes route through _build_update; reaching
                # here means a UNION branch or view body carries a write
                raise IRBuildError(
                    f"{type(c).__name__}: write clauses are only supported "
                    "in top-level single queries"
                )
            elif isinstance(c, A.CallClause):
                raise UnsupportedFeatureError(
                    f"CALL {c.procedure}: procedure calls are not supported"
                )
            else:
                raise IRBuildError(f"Unsupported clause {type(c).__name__}")
            i += 1
        if not saw_return:
            raise IRBuildError("Query must end in RETURN")
        return B.QueryIR(tuple(blocks), returns, self.ctx.working_graph)

    # ------------------------------------------------------------------
    # write queries (docs/mutation.md)
    # ------------------------------------------------------------------

    def _build_update(self, q: A.SingleQuery) -> B.UpdateIR:
        """Split a write query at its first write clause: the read prefix
        becomes a normal QueryIR returning every in-scope field (planned
        and executed on the pinned snapshot), the write suffix becomes
        host-evaluated write ops (relational/mutate.py)."""
        clauses = list(q.clauses)
        first = next(
            i for i, c in enumerate(clauses) if isinstance(c, _WRITE_CLAUSES)
        )
        reads, writes = clauses[:first], clauses[first:]
        env: Dict[str, CypherType] = dict(self.ctx.input_fields)
        blocks: List[B.Block] = []
        for c in reads:
            if isinstance(c, A.Match):
                blocks.extend(self._convert_match(c, env))
            elif isinstance(c, A.Unwind):
                lst = self.convert_expr(c.expr, env)
                blocks.append(B.UnwindBlock(lst, c.var))
                env[c.var] = self._list_inner_type(lst.cypher_type)
            elif isinstance(c, A.With) and not isinstance(c, A.Return):
                new_env, seg = self._convert_projection(c, env)
                blocks.extend(seg)
                env = new_env
            else:
                raise IRBuildError(
                    f"{type(c).__name__} cannot precede a write clause"
                )
        read_ir: Optional[B.QueryIR] = None
        if blocks:
            fields = tuple(n for n in env if not n.startswith("__"))
            blocks.append(B.ResultBlock(fields))
            read_ir = B.QueryIR(tuple(blocks), fields, self.ctx.working_graph)
        ops: List[B.Block] = []
        for c in writes:
            if isinstance(c, A.CreateClause):
                nodes, rels = self._convert_write_pattern(c.pattern, env)
                ops.append(B.CreateOp(nodes, rels))
            elif isinstance(c, A.MergeClause):
                ops.append(self._convert_merge(c, env))
            elif isinstance(c, A.SetClause):
                ops.append(
                    B.SetOp(
                        tuple(self._convert_set_item(it, env) for it in c.items)
                    )
                )
            elif isinstance(c, A.DeleteClause):
                ops.append(self._convert_delete(c, env))
            else:
                raise IRBuildError(
                    f"{type(c).__name__} cannot follow a write clause — "
                    "write queries end at their writes (RETURN after a "
                    "write is not supported; they return write counters)"
                )
        return B.UpdateIR(read_ir, tuple(ops), self.ctx.working_graph)

    def _convert_write_pattern(
        self, pattern: A.Pattern, env: Dict[str, CypherType]
    ) -> Tuple[Tuple[B.NodeTemplate, ...], Tuple[B.RelTemplate, ...]]:
        nodes: List[B.NodeTemplate] = []
        rels: List[B.RelTemplate] = []
        for part in pattern.parts:
            if part.path_var:
                raise IRBuildError("path variables are not allowed in writes")
            elems = part.elements
            prev = self._convert_write_node(elems[0], env, nodes)
            for j in range(1, len(elems), 2):
                rp: A.RelPattern = elems[j]
                nxt = self._convert_write_node(elems[j + 1], env, nodes)
                if len(rp.types) != 1:
                    raise IRBuildError(
                        "created relationships need exactly one type"
                    )
                if rp.direction == A.BOTH:
                    raise IRBuildError(
                        "created relationships need a direction"
                    )
                if rp.var and rp.var in env:
                    raise IRBuildError(
                        f"relationship variable {rp.var!r} already bound"
                    )
                var = rp.var or self.fresh_name("wr")
                props = self._convert_write_props(rp.properties, env)
                src, dst = (
                    (nxt, prev) if rp.direction == A.INCOMING else (prev, nxt)
                )
                rels.append(
                    B.RelTemplate(var, rp.types[0], src, dst, props)
                )
                env[var] = T.CTRelationshipType((rp.types[0],))
                prev = nxt
        return tuple(nodes), tuple(rels)

    def _convert_write_node(
        self, np: A.NodePattern, env: Dict[str, CypherType], out: List
    ) -> str:
        if np.var and np.var in env:
            m = env[np.var].material
            if not isinstance(m, T.CTNodeType):
                raise IRBuildError(f"{np.var!r} is not a node")
            if np.labels or np.properties is not None:
                raise IRBuildError(
                    f"bound variable {np.var!r} cannot carry labels or "
                    "properties in a write pattern"
                )
            out.append(B.NodeTemplate(np.var, bound=True))
            return np.var
        var = np.var or self.fresh_name("wn")
        props = self._convert_write_props(np.properties, env)
        out.append(
            B.NodeTemplate(var, bound=False, labels=tuple(np.labels), props=props)
        )
        env[var] = T.CTNodeType(tuple(np.labels))
        return var

    def _convert_write_props(
        self, properties, env: Dict[str, CypherType]
    ) -> Tuple[Tuple[str, E.Expr], ...]:
        if properties is None:
            return ()
        out = []
        for k, v in zip(properties.keys, properties.values):
            if k.startswith("__"):
                raise IRBuildError(
                    f"property key {k!r} is reserved (double-underscore "
                    "prefix marks system columns)"
                )
            out.append((k, self.convert_expr(v, env)))
        return tuple(out)

    def _convert_merge(
        self, c: A.MergeClause, env: Dict[str, CypherType]
    ) -> B.MergeOp:
        nodes, rels = self._convert_write_pattern(c.pattern, env)
        if len(rels) > 1:
            raise IRBuildError("MERGE supports at most one relationship")
        if rels:
            by_var = {t.var: t for t in nodes}
            for end in (rels[0].src, rels[0].dst):
                if not by_var[end].bound:
                    raise IRBuildError(
                        "MERGE relationship endpoints must be bound "
                        "variables (merge the nodes first)"
                    )
        on_create = tuple(self._convert_set_item(i, env) for i in c.on_create)
        on_match = tuple(self._convert_set_item(i, env) for i in c.on_match)
        return B.MergeOp(nodes, rels, on_create, on_match)

    def _convert_set_item(
        self, item: A.SetItem, env: Dict[str, CypherType]
    ) -> B.SetItemSpec:
        target = item.target
        if isinstance(target, E.Property):
            if not isinstance(target.expr, E.Var):
                raise IRBuildError("SET target must be a variable property")
            var = target.expr.name
            self._check_set_var(var, env)
            if target.key.startswith("__"):
                raise IRBuildError(
                    f"property key {target.key!r} is reserved"
                )
            return B.SetItemSpec(
                var, key=target.key, value=self.convert_expr(item.value, env)
            )
        if isinstance(target, E.Var):
            var = target.name
            self._check_set_var(var, env)
            if item.labels:
                return B.SetItemSpec(var, labels=tuple(item.labels))
            return B.SetItemSpec(var, value=self.convert_expr(item.value, env))
        raise IRBuildError(f"unsupported SET target {target.pretty_expr()}")

    def _check_set_var(self, var: str, env: Dict[str, CypherType]) -> None:
        if var not in env:
            raise IRBuildError(f"SET on unbound variable {var!r}")
        m = env[var].material
        if not isinstance(m, (T.CTNodeType, T.CTRelationshipType)):
            raise IRBuildError(f"SET target {var!r} is not an element")

    def _convert_delete(
        self, c: A.DeleteClause, env: Dict[str, CypherType]
    ) -> B.DeleteOp:
        fields = []
        for e in c.exprs:
            if not isinstance(e, E.Var):
                raise IRBuildError("DELETE takes bound element variables")
            if e.name not in env:
                raise IRBuildError(f"DELETE on unbound variable {e.name!r}")
            m = env[e.name].material
            if not isinstance(m, (T.CTNodeType, T.CTRelationshipType)):
                raise IRBuildError(f"DELETE target {e.name!r} is not an element")
            fields.append(e.name)
        return B.DeleteOp(tuple(fields), c.detach)

    def _resolve_qgn(self, name: str) -> str:
        if "." in name:
            return name
        return f"session.{name}"

    @staticmethod
    def _list_inner_type(t: CypherType) -> CypherType:
        m = t.material
        if isinstance(m, T.CTListType):
            return m.inner
        return T.CTAny.nullable

    # ------------------------------------------------------------------
    # MATCH
    # ------------------------------------------------------------------

    def _convert_match(self, c: A.Match, env: Dict[str, CypherType]) -> List[B.Block]:
        pattern, predicates = self.convert_pattern(c.pattern, env)
        # register new entities into env
        for n, t in pattern.node_types.items():
            env[n] = t
        for r, t in pattern.rel_types.items():
            conn = pattern.topology.get(r)
            if conn is not None and conn.is_var_length:
                env[r] = T.CTListType(t)
            else:
                env[r] = t
        for pname in pattern.paths:
            if pname in env or pname in pattern.node_types or pname in pattern.rel_types:
                raise IRBuildError(f"Path variable {pname!r} already bound")
            env[pname] = T.CTPath
        preds = list(predicates)
        if c.where is not None:
            w = self.convert_expr(c.where, env)
            preds.extend(w.exprs if isinstance(w, E.Ands) else [w])
        # assign target fields to exists-pattern predicates
        preds = [self._assign_exists_targets(p, env) for p in preds]
        return [B.MatchBlock(pattern, tuple(preds), c.optional)]

    def _assign_exists_targets(self, p: E.Expr, env) -> E.Expr:
        def rule(n):
            if isinstance(n, E.ExistsPattern) and n.target_field is None:
                sub_pattern, sub_preds = self.convert_pattern(n.pattern, dict(env))
                target = self.fresh_name("exists")
                clone = E.ExistsPattern(n.pattern, target)
                object.__setattr__(clone, "_ir_pattern", sub_pattern)
                object.__setattr__(clone, "_ir_predicates", tuple(sub_preds))
                object.__setattr__(clone, "_typ", T.CTBoolean)
                return clone
            return n

        return p.rewrite_top_down(rule)

    # ------------------------------------------------------------------
    # Pattern conversion
    # ------------------------------------------------------------------

    def convert_pattern(
        self,
        pattern: A.Pattern,
        env: Dict[str, CypherType],
        rel_uniqueness: bool = True,
    ) -> Tuple[IRPattern, List[E.Expr]]:
        """Frontend pattern -> IRPattern + lowered property predicates.

        ``rel_uniqueness`` adds the openCypher per-MATCH relationship-
        isomorphism predicates ``id(r_i) <> id(r_j)`` for every pair of
        fixed-length relationship variables whose type sets can intersect —
        the rewrite Neo4j's frontend performs (AddUniquenessPredicates)
        before the reference ever sees the query. CONSTRUCT patterns define
        NEW elements and pass False."""
        ir = IRPattern()
        predicates: List[E.Expr] = []

        def node_field(np: A.NodePattern) -> str:
            name = np.var or self.fresh_name("n")
            prev = env.get(name) or ir.node_types.get(name)
            if prev is not None:
                base = prev.material
                if not isinstance(base, T.CTNodeType):
                    raise IRBuildError(
                        f"Variable {name!r} already bound to {base!r}, cannot re-bind as node"
                    )
                labels = base.labels | frozenset(np.labels)
            else:
                labels = frozenset(np.labels)
                # label implication from schema
            t = T.CTNodeType(labels)
            ir.node_types[name] = t
            if np.labels and prev is not None:
                # extra label constraints on a bound var become predicates
                for l in np.labels:
                    predicates.append(
                        E.HasLabel(E.Var(name).with_type(t), l).with_type(T.CTBoolean)
                    )
            if np.properties is not None:
                var = E.Var(name).with_type(t)
                for k, v in zip(np.properties.keys, np.properties.values):
                    lhs = self._type_property(E.Property(var, k), t)
                    rhs = self.convert_expr(v, env)
                    predicates.append(
                        E.Equals(lhs, rhs).with_type(T.CTBoolean.nullable)
                    )
            if np.base_var:
                ir.base_entities[name] = np.base_var
            return name

        for part in pattern.parts:
            elems = part.elements
            prev_node = node_field(elems[0])
            path_fields: List[str] = [prev_node]
            for j in range(1, len(elems), 2):
                rp: A.RelPattern = elems[j]
                nxt = node_field(elems[j + 1])
                rname = rp.var or self.fresh_name("r")
                if rname in ir.rel_types or rname in ir.node_types:
                    # openCypher: a relationship variable cannot be re-bound
                    # within one pattern
                    raise IRBuildError(
                        f"Relationship variable {rname!r} bound more than once"
                    )
                bound_prev = env.get(rname)
                if bound_prev is not None:
                    # pre-bound relationship variable: plan the pattern step
                    # with a hidden fresh variable and JOIN it back on
                    # identity (the reference's bound-relationship planning;
                    # its failing_blacklist VarLengthAcceptance2 marks the
                    # var-length form — here the walked rel LIST must equal
                    # the bound value, [r] for a single pre-bound rel)
                    base = bound_prev.material
                    outer = E.Var(rname).with_type(bound_prev)
                    hidden = self.fresh_name("r")
                    is_varlen = rp.length is not None and rp.length != (1, 1)
                    if isinstance(base, T.CTRelationshipType) and not is_varlen:
                        inner_t = T.CTRelationshipType(rp.types)
                        predicates.append(
                            E.Equals(
                                E.Id(E.Var(hidden).with_type(inner_t)).with_type(
                                    T.CTInteger
                                ),
                                E.Id(outer).with_type(T.CTInteger),
                            ).with_type(T.CTBoolean)
                        )
                    elif isinstance(
                        base, (T.CTRelationshipType, T.CTListType)
                    ) and is_varlen:
                        inner_t = T.CTListType(
                            T.CTRelationshipType(rp.types)
                        )
                        rhs = (
                            E.ListLit((outer,)).with_type(inner_t)
                            if isinstance(base, T.CTRelationshipType)
                            else outer
                        )
                        predicates.append(
                            E.Equals(
                                E.Var(hidden).with_type(inner_t), rhs
                            ).with_type(T.CTBoolean.nullable)
                        )
                    else:
                        raise IRBuildError(
                            f"Variable {rname!r} already bound to {base!r}, "
                            "cannot re-bind as relationship"
                        )
                    rname = hidden
                rt = T.CTRelationshipType(rp.types)
                ir.rel_types[rname] = rt
                if rp.direction == INCOMING:
                    src, dst, direction = nxt, prev_node, OUTGOING
                elif rp.direction == OUTGOING:
                    src, dst, direction = prev_node, nxt, OUTGOING
                else:
                    src, dst, direction = prev_node, nxt, BOTH
                var_syntax = rp.length is not None
                if rp.length is None:
                    lo, hi = 1, 1
                else:
                    # hi None = unbounded '*' — resolved at relational
                    # planning to the matching-edge count (relationship
                    # isomorphism bounds any walk by the number of edges),
                    # with the frontier loop exiting at the empty-frontier
                    # fixpoint. The reference REJECTS unbounded (flink
                    # scenario_blacklist:6-7) — we execute it.
                    lo, hi = rp.length
                ir.topology[rname] = Connection(
                    src, dst, direction, lo, hi, var_syntax
                )
                if rp.properties is not None:
                    var = E.Var(rname).with_type(rt)
                    for k, v in zip(rp.properties.keys, rp.properties.values):
                        lhs = self._type_property(E.Property(var, k), rt)
                        rhs = self.convert_expr(v, env)
                        predicates.append(
                            E.Equals(lhs, rhs).with_type(T.CTBoolean.nullable)
                        )
                if rp.base_var:
                    ir.base_entities[rname] = rp.base_var
                path_fields.append(rname)
                path_fields.append(nxt)
                prev_node = nxt
            if part.path_var:
                if part.path_var in ir.paths:
                    raise IRBuildError(
                        f"Path variable {part.path_var!r} already bound"
                    )
                ir.paths[part.path_var] = tuple(path_fields)
        if rel_uniqueness:
            predicates.extend(self._uniqueness_predicates(ir))
        return ir, predicates

    def _uniqueness_predicates(self, ir: IRPattern) -> List[E.Expr]:
        """openCypher per-MATCH relationship-isomorphism predicates for
        every pair of relationship variables whose type sets can intersect
        (the rewrite Neo4j's frontend performs — AddUniquenessPredicates —
        before the reference ever sees the query; reference
        ``VarLengthExpandPlanner.scala:96,173-186`` additionally filters a
        var-length's edges against every rel element in scope):

        * fixed vs fixed — ``id(r1) <> id(r2)``;
        * fixed vs var-length — ``none(x IN rs WHERE id(x) = id(r))``;
        * var-length vs var-length —
          ``none(x IN rs1 WHERE any(y IN rs2 WHERE id(x) = id(y)))``.
        """
        fixed = [r for r, conn in ir.topology.items() if not conn.is_var_length]
        varlen = [r for r, conn in ir.topology.items() if conn.is_var_length]

        def may_intersect(r1: str, r2: str) -> bool:
            t1 = ir.rel_types[r1].types or None  # None/empty = any
            t2 = ir.rel_types[r2].types or None
            return t1 is None or t2 is None or bool(set(t1) & set(t2))

        def rel_id(r: str) -> E.Expr:
            return E.Id(E.Var(r).with_type(ir.rel_types[r])).with_type(T.CTInteger)

        def local_rel(rs: str) -> E.Var:
            return E.Var(self.fresh_name("uq")).with_type(ir.rel_types[rs])

        def local_id(v: E.Var) -> E.Expr:
            return E.Id(v).with_type(T.CTInteger)

        def list_of(rs: str) -> E.Expr:
            return E.Var(rs).with_type(T.CTListType(ir.rel_types[rs]))

        preds: List[E.Expr] = []
        for i in range(len(fixed)):
            for j in range(i + 1, len(fixed)):
                r1, r2 = fixed[i], fixed[j]
                if not may_intersect(r1, r2):
                    continue
                preds.append(
                    E.Neq(rel_id(r1), rel_id(r2)).with_type(T.CTBoolean)
                )
        for rs in varlen:
            for r in fixed:
                if not may_intersect(rs, r):
                    continue
                x = local_rel(rs)
                preds.append(
                    E.Quantified(
                        "none",
                        x,
                        list_of(rs),
                        E.Equals(local_id(x), rel_id(r)).with_type(T.CTBoolean),
                    ).with_type(T.CTBoolean)
                )
        for i in range(len(varlen)):
            for j in range(i + 1, len(varlen)):
                rs1, rs2 = varlen[i], varlen[j]
                if not may_intersect(rs1, rs2):
                    continue
                x, y = local_rel(rs1), local_rel(rs2)
                inner = E.Quantified(
                    "any",
                    y,
                    list_of(rs2),
                    E.Equals(local_id(x), local_id(y)).with_type(T.CTBoolean),
                ).with_type(T.CTBoolean)
                preds.append(
                    E.Quantified("none", x, list_of(rs1), inner).with_type(
                        T.CTBoolean
                    )
                )
        return preds

    # ------------------------------------------------------------------
    # WITH / RETURN
    # ------------------------------------------------------------------

    def _convert_projection(
        self, c: A.ProjectionClause, env: Dict[str, CypherType]
    ) -> Tuple[Dict[str, CypherType], List[B.Block]]:
        blocks: List[B.Block] = []
        items: List[Tuple[str, E.Expr]] = []
        seen: set = set()
        if c.star:
            for name, t in env.items():
                if name.startswith("__"):
                    continue
                items.append((name, E.Var(name).with_type(t)))
                seen.add(name)
        for it in c.items:
            # convert_expr assigns exists-pattern targets inline, so the
            # projected expression is subquery-ready for the planner's
            # _extract_exists (the reference's pattern-expression rewriter)
            converted = self.convert_expr(it.expr, env)
            name = it.alias or it.name
            if name in seen:
                raise IRBuildError(f"Duplicate return column {name!r}")
            seen.add(name)
            items.append((name, converted))

        has_agg = any(E.has_aggregation(e) for _, e in items)
        if has_agg:
            blocks.extend(self._aggregation_blocks(items, env))
        else:
            blocks.append(B.ProjectBlock(tuple(items), distinct=False))
        # environment after projection (pre-narrowing): old fields + new
        wide_env = dict(env)
        new_env: Dict[str, CypherType] = {}
        for name, e in items:
            t = e.cypher_type
            if E.has_aggregation(e):
                t = self._agg_result_type(e)
            wide_env[name] = t
            new_env[name] = t
        if has_agg:
            # aggregation narrows the horizon immediately
            wide_env = dict(new_env)

        # with DISTINCT the horizon narrows first: WHERE/ORDER BY may only
        # reference the projected items (Neo4j's scoping rule); otherwise the
        # wide pre-narrowing scope is visible
        rest_env = new_env if c.distinct else wide_env

        def convert_rest(ast_expr) -> E.Expr:
            """After aggregation, ORDER BY/WHERE may also reference grouping
            or aggregate EXPRESSIONS (``ORDER BY b.name``, ``ORDER BY
            count(*)``): convert them in the pre-projection scope and
            substitute each projected expression with its output column."""
            try:
                return self.convert_expr(ast_expr, rest_env)
            except IRBuildError:
                if not has_agg:
                    raise
                e = self.convert_expr(ast_expr, env)
                proj_sub = {
                    pe: E.Var(nm).with_type(new_env[nm]) for nm, pe in items
                }
                e = E.substitute(e, proj_sub)
                for node in e.iter_nodes():
                    if isinstance(node, E.Var) and node.name not in rest_env:
                        raise IRBuildError(
                            f"Variable {node.name!r} not visible after aggregation"
                        )
                return e

        where_pred = None
        if c.where is not None:
            where_pred = convert_rest(c.where)

        sort_items = []
        for s in c.order_by:
            sort_items.append(A.SortItem(convert_rest(s.expr), s.ascending))
        skip = self.convert_expr(c.skip, rest_env) if c.skip is not None else None
        limit = self.convert_expr(c.limit, rest_env) if c.limit is not None else None

        if c.distinct:
            blocks.append(B.SelectBlock(tuple(new_env.keys())))
            blocks.append(B.DistinctBlock(tuple(new_env.keys())))
            if where_pred is not None:
                blocks.append(B.FilterBlock(where_pred))
            if sort_items or skip is not None or limit is not None:
                blocks.append(B.OrderAndSliceBlock(tuple(sort_items), skip, limit))
        else:
            if where_pred is not None:
                blocks.append(B.FilterBlock(where_pred))
            if sort_items or skip is not None or limit is not None:
                blocks.append(B.OrderAndSliceBlock(tuple(sort_items), skip, limit))
            blocks.append(B.SelectBlock(tuple(new_env.keys())))
        return new_env, blocks

    def _aggregation_blocks(
        self, items: List[Tuple[str, E.Expr]], env: Dict[str, CypherType]
    ) -> List[B.Block]:
        """Aggregation isolation (reference ``isolateAggregation`` rewriter)."""
        group: List[Tuple[str, E.Expr]] = []
        aggs: List[Tuple[str, E.Agg]] = []
        post: List[Tuple[str, E.Expr]] = []
        needs_post = False

        for name, e in items:
            if not E.has_aggregation(e):
                group.append((name, e))
                post.append((name, E.Var(name).with_type(e.cypher_type)))
                continue
            if isinstance(e, (E.Agg, E.CountStar)):
                agg = self._normalize_agg(e)
                aggs.append((name, agg))
                post.append((name, E.Var(name).with_type(self._agg_result_type(e))))
            else:
                # expression over aggregates: extract each Agg into a fresh field
                mapping: Dict[E.Expr, E.Expr] = {}
                for node in e.iter_nodes():
                    if isinstance(node, (E.Agg, E.CountStar)) and node not in mapping:
                        f = self.fresh_name("agg")
                        aggs.append((f, self._normalize_agg(node)))
                        mapping[node] = E.Var(f).with_type(self._agg_result_type(node))
                rewritten = E.substitute(e, mapping)
                rewritten = self._retype(rewritten, {**env, **{m.name: m.cypher_type for m in mapping.values()}})
                post.append((name, rewritten))
                needs_post = True

        blocks: List[B.Block] = [B.AggregationBlock(tuple(group), tuple(aggs))]
        if needs_post:
            blocks.append(B.ProjectBlock(tuple(post), distinct=False))
            blocks.append(B.SelectBlock(tuple(n for n, _ in post)))
        return blocks

    @staticmethod
    def _normalize_agg(e: E.Expr) -> E.Agg:
        if isinstance(e, E.CountStar):
            return E.Agg("count", None, False)
        assert isinstance(e, E.Agg)
        return e

    @staticmethod
    def _agg_result_type(e: E.Expr) -> CypherType:
        if isinstance(e, E.CountStar):
            return T.CTInteger
        if isinstance(e, E.Agg):
            name = e.name
            at = e.expr.cypher_type.material if e.expr is not None else T.CTAny
            if name == "count":
                return T.CTInteger
            if name == "collect":
                return T.CTListType(at)
            if name in ("min", "max"):
                return at.nullable
            if name == "sum":
                return at if at in (T.CTInteger, T.CTFloat) else T.CTNumber
            if name == "avg":
                return T.CTDuration if at == T.CTDuration else T.CTFloat
            if name in ("stdev", "stdevp"):
                return T.CTFloat
            if name in ("percentilecont",):
                return T.CTFloat.nullable
            if name == "percentiledisc":
                return at.nullable
        # expression over aggregations
        return e.cypher_type

    # ------------------------------------------------------------------
    # CONSTRUCT
    # ------------------------------------------------------------------

    def _convert_construct(self, c: A.ConstructClause, env) -> B.ConstructBlock:
        clones: List[Tuple[str, str]] = []
        for item in c.clones:
            if not isinstance(item.expr, E.Var):
                raise IRBuildError("CLONE items must be variables")
            src = item.expr.name
            if src not in env:
                raise IRBuildError(f"CLONE of unbound variable {src!r}")
            clones.append((item.alias or src, src))
        clone_env = dict(env)
        for new, src in clones:
            clone_env[new] = env[src]
        new_pattern = IRPattern()
        new_props: List[Tuple[str, str, E.Expr]] = []
        cloned = {new for new, _ in clones}
        for pat in c.news:
            ir, preds = self.convert_pattern(pat, clone_env, rel_uniqueness=False)
            for n, base in ir.base_entities.items():
                # a COPY OF target must be a FRESH name: colliding with a
                # bound var, clone alias, or earlier COPY declaration would
                # silently drop one of the two meanings
                if n in clone_env:
                    raise IRBuildError(
                        f"COPY OF target {n!r} is already bound; use a "
                        "fresh variable (CLONE keeps element identity)"
                    )
                prev = new_pattern.base_entities.get(n)
                if prev is not None and prev != base:
                    raise IRBuildError(
                        f"COPY OF target {n!r} declared more than once"
                    )
            for n, t in ir.node_types.items():
                if n in clone_env:
                    # references an existing/cloned entity: an implicit clone
                    # (reference: bound vars in NEW patterns are cloned)
                    if n in env and n not in cloned:
                        clones.append((n, n))
                        cloned.add(n)
                    continue
                prev = new_pattern.node_types.get(n)
                if prev is not None:
                    # the same new node re-referenced by a later NEW clause:
                    # label sets UNION (overwriting would drop the first
                    # declaration's labels)
                    t = T.CTNodeType(
                        prev.material.labels | t.material.labels
                    )
                new_pattern.node_types[n] = t
            for r, t in ir.rel_types.items():
                new_pattern.rel_types[r] = t
            new_pattern.topology.update(ir.topology)
            new_pattern.base_entities.update(ir.base_entities)
            # property map predicates become property settings
            for p in preds:
                if isinstance(p, E.Equals) and isinstance(p.lhs, E.Property):
                    owner = p.lhs.expr
                    assert isinstance(owner, E.Var)
                    new_props.append((owner.name, p.lhs.key, p.rhs))
        # COPY OF targets resolve like their base in SET value expressions
        # (the planner aliases the target's columns to the base's)
        for name, base in new_pattern.base_entities.items():
            if base in clone_env and name not in clone_env:
                clone_env[name] = clone_env[base]
        sets: List[Tuple[str, str, E.Expr]] = []
        set_labels: List[Tuple[str, Tuple[str, ...]]] = []
        for s in c.sets:
            if s.labels:
                assert isinstance(s.target, E.Var)
                set_labels.append((s.target.name, s.labels))
            elif isinstance(s.target, E.Property):
                owner = s.target.expr
                assert isinstance(owner, E.Var)
                sets.append(
                    (owner.name, s.target.key, self.convert_expr(s.value, clone_env))
                )
            else:
                raise IRBuildError("Unsupported SET item in CONSTRUCT")
        on_graphs = tuple(self._resolve_qgn(g) for g in c.on_graphs)
        return B.ConstructBlock(
            on_graphs, tuple(clones), new_pattern, tuple(new_props), tuple(sets), tuple(set_labels)
        )

    # ------------------------------------------------------------------
    # Expressions + typing
    # ------------------------------------------------------------------

    def convert_expr(self, e: E.Expr, env: Dict[str, CypherType]) -> E.Expr:
        return self._retype(e, env)

    def _retype(self, e: E.Expr, env: Dict[str, CypherType]) -> E.Expr:
        conv = self._retype  # shorthand

        if isinstance(e, E.Var):
            if e.name not in env:
                raise IRBuildError(f"Variable {e.name!r} not defined")
            return e.with_type(env[e.name])
        if isinstance(e, E.Param):
            val = self.ctx.parameters.get(e.name)
            t = T.type_of_value(val) if val is not None else T.CTAny.nullable
            return e.with_type(t)
        if isinstance(e, E.Lit):
            return e.with_type(T.type_of_value(e.value))
        if isinstance(e, E.ListLit):
            items = tuple(conv(i, env) for i in e.items)
            inner = T.join_types(i.cypher_type for i in items)
            return E.ListLit(items).with_type(T.CTListType(inner))
        if isinstance(e, E.MapLit):
            vals = tuple(conv(v, env) for v in e.values)
            return E.MapLit(e.keys, vals).with_type(
                T.CTMapType({k: v.cypher_type for k, v in zip(e.keys, vals)})
            )
        if isinstance(e, E.Property):
            owner = conv(e.expr, env)
            return self._type_property(E.Property(owner, e.key), owner.cypher_type)
        if isinstance(e, E.HasLabel):
            return E.HasLabel(conv(e.expr, env), e.label).with_type(T.CTBoolean)
        if isinstance(e, E.HasType):
            return E.HasType(conv(e.expr, env), e.rel_type).with_type(T.CTBoolean)
        if isinstance(e, (E.Id, E.StartNode, E.EndNode)):
            inner = conv(e.expr, env)
            t = T.CTInteger if isinstance(e, E.Id) else T.CTNodeType(())
            return type(e)(inner).with_type(t)
        if isinstance(e, E.Ands):
            return E.Ands(tuple(conv(x, env) for x in e.exprs)).with_type(
                T.CTBoolean.nullable
            )
        if isinstance(e, E.Ors):
            return E.Ors(tuple(conv(x, env) for x in e.exprs)).with_type(
                T.CTBoolean.nullable
            )
        if isinstance(e, (E.Xor,)):
            return E.Xor(conv(e.lhs, env), conv(e.rhs, env)).with_type(
                T.CTBoolean.nullable
            )
        if isinstance(e, E.Not):
            return E.Not(conv(e.expr, env)).with_type(T.CTBoolean.nullable)
        if isinstance(e, (E.IsNull, E.IsNotNull)):
            return type(e)(conv(e.expr, env)).with_type(T.CTBoolean)
        if isinstance(e, E.BinaryPredicate):
            lhs, rhs = conv(e.lhs, env), conv(e.rhs, env)
            return type(e)(lhs, rhs).with_type(T.CTBoolean.nullable)
        if isinstance(e, E.Neg):
            inner = conv(e.expr, env)
            return E.Neg(inner).with_type(inner.cypher_type)
        if isinstance(e, E.ArithmeticExpr):
            lhs, rhs = conv(e.lhs, env), conv(e.rhs, env)
            return type(e)(lhs, rhs).with_type(self._arith_type(type(e), lhs, rhs))
        if isinstance(e, E.FunctionCall):
            return self._type_function(e, env)
        if isinstance(e, E.Agg):
            inner = conv(e.expr, env) if e.expr is not None else None
            extra = tuple(conv(x, env) for x in e.extra)
            out = E.Agg(e.name, inner, e.distinct, extra)
            return out.with_type(self._agg_result_type(out))
        if isinstance(e, E.CountStar):
            return e.with_type(T.CTInteger)
        if isinstance(e, E.CaseExpr):
            operand = conv(e.operand, env) if e.operand is not None else None
            whens = tuple(conv(w, env) for w in e.whens)
            thens = tuple(conv(t, env) for t in e.thens)
            default = conv(e.default, env) if e.default is not None else None
            result = T.join_types(t.cypher_type for t in thens)
            if default is not None:
                result = result.join(default.cypher_type)
            else:
                result = result.nullable
            return E.CaseExpr(operand, whens, thens, default).with_type(result)
        if isinstance(e, E.Index):
            owner = conv(e.expr, env)
            idx = conv(e.index, env)
            m = owner.cypher_type.material
            if isinstance(m, T.CTListType):
                t = m.inner.nullable
            elif isinstance(m, T.CTMapType) and m.fields is not None:
                t = T.join_types(dict(m.fields).values()).nullable
            else:
                t = T.CTAny.nullable
            return E.Index(owner, idx).with_type(t)
        if isinstance(e, E.ListSlice):
            owner = conv(e.expr, env)
            return E.ListSlice(
                owner,
                conv(e.from_, env) if e.from_ is not None else None,
                conv(e.to, env) if e.to is not None else None,
            ).with_type(owner.cypher_type.material.nullable if isinstance(owner.cypher_type.material, T.CTListType) else T.CTListType(T.CTAny).nullable)
        if isinstance(e, E.ListComprehension):
            lst = conv(e.list_expr, env)
            inner_t = self._list_inner_type(lst.cypher_type)
            env2 = {**env, e.var.name: inner_t}
            where = conv(e.where, env2) if e.where is not None else None
            proj = conv(e.projection, env2) if e.projection is not None else None
            out_t = proj.cypher_type if proj is not None else inner_t
            return E.ListComprehension(
                e.var.with_type(inner_t), lst, where, proj
            ).with_type(T.CTListType(out_t))
        if isinstance(e, E.Quantified):
            lst = conv(e.list_expr, env)
            inner_t = self._list_inner_type(lst.cypher_type)
            env2 = {**env, e.var.name: inner_t}
            return E.Quantified(
                e.kind, e.var.with_type(inner_t), lst, conv(e.predicate, env2)
            ).with_type(T.CTBoolean.nullable)
        if isinstance(e, E.Reduce):
            lst = conv(e.list_expr, env)
            inner_t = self._list_inner_type(lst.cypher_type)
            init = conv(e.init, env)
            env2 = {**env, e.var.name: inner_t, e.acc.name: init.cypher_type}
            body = conv(e.expr, env2)
            # widen accumulator
            env2[e.acc.name] = init.cypher_type.join(body.cypher_type)
            body = conv(e.expr, env2)
            return E.Reduce(
                e.acc.with_type(env2[e.acc.name]),
                init,
                e.var.with_type(inner_t),
                lst,
                body,
            ).with_type(body.cypher_type)
        if isinstance(e, E.MapProjection):
            var = conv(e.var, env)
            items = tuple(
                (k, conv(v, env) if v is not None else None) for k, v in e.items
            )
            return E.MapProjection(var, items, e.all_props).with_type(T.CTMapType(None))
        if isinstance(e, E.ExistsPattern):
            return self._assign_exists_targets(e, env)
        if isinstance(e, E.PatternComprehension):
            return self._convert_pattern_comprehension(e, env)
        raise IRBuildError(f"Cannot convert expression {type(e).__name__}")

    def _convert_pattern_comprehension(
        self, e: E.PatternComprehension, env: Dict[str, CypherType]
    ) -> E.PatternComprehension:
        """Convert the comprehension's inner pattern/WHERE/projection in an
        inner scope (outer vars correlated, pattern vars fresh) and attach
        the results for the logical planner's collect-subquery extraction
        (the exists-pattern treatment, ``_assign_exists_targets``)."""
        if e.target_field is not None:
            return e
        inner_env = dict(env)
        sub_pattern, sub_preds = self.convert_pattern(e.pattern, inner_env)
        for n, t in sub_pattern.node_types.items():
            inner_env[n] = t
        for r, t in sub_pattern.rel_types.items():
            conn = sub_pattern.topology.get(r)
            if conn is not None and conn.is_var_length:
                inner_env[r] = T.CTListType(t)
            else:
                inner_env[r] = t
        for pname in sub_pattern.paths:
            inner_env[pname] = T.CTPath
        preds = list(sub_preds)
        if e.where is not None:
            w = self.convert_expr(e.where.value, inner_env)
            preds.extend(w.exprs if isinstance(w, E.Ands) else [w])
        proj = self.convert_expr(e.projection.value, inner_env)
        target = self.fresh_name("pc")
        clone = E.PatternComprehension(
            e.pattern, e.path_var, e.where, E.Opaque(proj), target
        )
        object.__setattr__(clone, "_ir_pattern", sub_pattern)
        object.__setattr__(clone, "_ir_predicates", tuple(preds))
        object.__setattr__(clone, "_ir_projection", proj)
        object.__setattr__(clone, "_typ", T.CTListType(proj.cypher_type))
        return clone

    def _type_property(self, p: E.Property, owner_t: CypherType) -> E.Expr:
        m = owner_t.material
        key = p.key
        if isinstance(m, T.CTNodeType):
            keys = self.schema.node_property_keys_for_labels(m.labels)
            t = keys.get(key, T.CTNull)
        elif isinstance(m, T.CTRelationshipType):
            keys = self.schema.relationship_property_keys_for_types(m.types)
            t = keys.get(key, T.CTNull)
        elif isinstance(m, T.CTMapType):
            if m.fields is None:
                t = T.CTAny.nullable
            else:
                t = dict(m.fields).get(key, T.CTNull)
        elif isinstance(
            m,
            (
                T.CTDateType,
                T.CTLocalDateTimeType,
                T.CTDateTimeType,
                T.CTTimeType,
                T.CTLocalTimeType,
            ),
        ):
            t = (
                T.CTString
                if key.lower() in ("timezone", "offset")
                else T.CTInteger
            )
        elif isinstance(m, T.CTDurationType):
            t = T.CTInteger
        elif isinstance(m, T.CTListType):
            # var-length rel list: properties distribute over elements
            t = T.CTListType(T.CTAny.nullable)
        else:
            t = T.CTAny.nullable
        if owner_t.is_nullable and not t.is_nullable and t != T.CTNull:
            t = t.nullable
        return p.with_type(t)

    @staticmethod
    def _arith_type(op, lhs: E.Expr, rhs: E.Expr) -> CypherType:
        lt, rt = lhs.cypher_type.material, rhs.cypher_type.material
        nullable = lhs.cypher_type.is_nullable or rhs.cypher_type.is_nullable
        out: CypherType
        if op is E.Add:
            if lt == T.CTString or rt == T.CTString:
                out = T.CTString
            elif isinstance(lt, T.CTListType) or isinstance(rt, T.CTListType):
                li = lt.inner if isinstance(lt, T.CTListType) else lt
                ri = rt.inner if isinstance(rt, T.CTListType) else rt
                out = T.CTListType(li.join(ri))
            elif lt == T.CTDuration and rt in (T.CTDate, T.CTLocalDateTime):
                out = rt
            elif rt == T.CTDuration and lt in (T.CTDate, T.CTLocalDateTime, T.CTDuration):
                out = lt
            else:
                out = IRBuilder._numeric_join(lt, rt)
        elif op is E.Subtract:
            if rt == T.CTDuration and lt in (T.CTDate, T.CTLocalDateTime, T.CTDuration):
                out = lt
            else:
                out = IRBuilder._numeric_join(lt, rt)
        elif op is E.Divide:
            if lt == T.CTInteger and rt == T.CTInteger:
                out = T.CTInteger
            else:
                out = IRBuilder._numeric_join(lt, rt)
        elif op is E.Pow:
            out = T.CTFloat
        else:
            out = IRBuilder._numeric_join(lt, rt)
        return out.nullable if nullable else out

    @staticmethod
    def _numeric_join(lt: CypherType, rt: CypherType) -> CypherType:
        if lt == T.CTFloat or rt == T.CTFloat:
            return T.CTFloat
        if lt == T.CTInteger and rt == T.CTInteger:
            return T.CTInteger
        if isinstance(lt, T.CTBigDecimalType) or isinstance(rt, T.CTBigDecimalType):
            if isinstance(lt, T.CTBigDecimalType) and isinstance(rt, T.CTBigDecimalType):
                return T.CTBigDecimalType()
            return T.CTBigDecimalType()
        return T.CTNumber

    def _type_function(self, e: E.FunctionCall, env) -> E.Expr:
        args = tuple(self._retype(a, env) for a in e.args)
        name = e.name
        # element-column rewrites (these ARE physical columns)
        if name == "id" and len(args) == 1:
            return E.Id(args[0]).with_type(T.CTInteger)
        if name == "startnode" and len(args) == 1:
            m = args[0].cypher_type.material
            return E.StartNode(args[0]).with_type(T.CTNodeType(()))
        if name == "endnode" and len(args) == 1:
            return E.EndNode(args[0]).with_type(T.CTNodeType(()))
        f = lookup_function(name)
        if len(args) < f.min_args or (f.max_args >= 0 and len(args) > f.max_args):
            raise IRBuildError(
                f"Wrong number of arguments for {name}(): got {len(args)}"
            )
        t = f.result_type([a.cypher_type for a in args])
        if f.null_prop and any(a.cypher_type.is_nullable for a in args):
            t = t.nullable
        return E.FunctionCall(name, args).with_type(t)


def build_ir(stmt: A.Statement, ctx: IRBuilderContext):
    """Entry point (reference ``IRBuilder.process``)."""
    return IRBuilder(ctx).build(stmt)
