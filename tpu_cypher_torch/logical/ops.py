"""Logical operator ADT.

Mirrors the reference's ``LogicalOperator`` hierarchy
(``okapi-logical/.../impl/LogicalOperator.scala:39-342``): ``PatternScan``
(here NodeScan/PatternScan), ``Expand``, ``ExpandInto``,
``BoundedVarLengthExpand``, ``ValueJoin``, ``CartesianProduct``, ``Optional``,
``ExistsSubQuery``, ``Filter``, ``Project``, ``Aggregate``, ``Distinct``,
``Select``, ``OrderBy``, ``Skip``, ``Limit``, ``Unwind``, ``TabularUnionAll``,
``FromGraph``, ``ReturnGraph``, ``Start``, ``DrivingTable``, ``EmptyRecords``,
``ConstructGraph``.

Every operator exposes ``fields`` — the solved (name -> CypherType) scope —
the analog of the reference's ``SolvedQueryModel``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional as Opt, Tuple

from ..api.types import CypherType
from ..frontend.ast import SortItem
from ..ir.blocks import ConstructBlock
from ..ir.expr import Agg, Expr, Var
from ..trees import TreeNode

FieldsT = Tuple[Tuple[str, CypherType], ...]


def fields_dict(f: FieldsT) -> Dict[str, CypherType]:
    return dict(f)


class LogicalOperator(TreeNode):
    @property
    def fields(self) -> FieldsT:
        raise NotImplementedError

    @property
    def graph_name(self) -> str:
        for c in self.children:
            if isinstance(c, LogicalOperator):
                return c.graph_name
        raise AssertionError("no graph")

    def _show_inner(self) -> str:
        return ""


# -- leaves -----------------------------------------------------------------


@dataclass(frozen=True)
class Start(LogicalOperator):
    """Start from a catalog graph (reference ``Start``)."""

    qgn: str
    input_fields: FieldsT = ()

    @property
    def fields(self) -> FieldsT:
        return self.input_fields

    @property
    def graph_name(self) -> str:
        return self.qgn

    def _show_inner(self) -> str:
        return self.qgn


@dataclass(frozen=True)
class DrivingTable(LogicalOperator):
    """Start from an externally supplied table (reference ``DrivingTable``)."""

    qgn: str
    input_fields: FieldsT = ()

    @property
    def fields(self) -> FieldsT:
        return self.input_fields

    @property
    def graph_name(self) -> str:
        return self.qgn


@dataclass(frozen=True)
class EmptyRecords(LogicalOperator):
    qgn: str
    empty_fields: FieldsT = ()

    @property
    def fields(self) -> FieldsT:
        return self.empty_fields

    @property
    def graph_name(self) -> str:
        return self.qgn


# -- unary ------------------------------------------------------------------


@dataclass(frozen=True)
class UnaryOp(LogicalOperator):
    in_op: LogicalOperator

    @property
    def fields(self) -> FieldsT:
        return self.in_op.fields


@dataclass(frozen=True)
class NodeScan(UnaryOp):
    """Scan all nodes matching a node type (reference ``PatternScan`` with a
    single-node pattern, ``LogicalOperator.scala:136``)."""

    fld: str
    node_type: CypherType

    @property
    def fields(self) -> FieldsT:
        return self.in_op.fields + ((self.fld, self.node_type),)

    def _show_inner(self) -> str:
        return f"{self.fld}: {self.node_type!r}"


@dataclass(frozen=True)
class PatternScan(UnaryOp):
    """Scan a stored composite pattern (NodeRel / Triplet): one table scan
    binds several query fields at once. Produced by the optimizer rule
    ``replace_scans_with_recognized_patterns``
    (``LogicalOptimizer.scala:67``, ``Pattern.scala:135-182``)."""

    binds: FieldsT  # all fields bound by the stored pattern, entity order
    entity_map: Tuple[Tuple[str, str], ...]  # (pattern entity name, field)
    pattern: object = None  # the search GraphPattern (frozen, hashable)

    @property
    def fields(self) -> FieldsT:
        return self.in_op.fields + self.binds

    def _show_inner(self) -> str:
        return ", ".join(f"{e}={f}" for e, f in self.entity_map)


@dataclass(frozen=True)
class BindPath(UnaryOp):
    """Bind a named path variable to its ordered member element fields
    (``MATCH p = (...)``). No reference analog — the reference blacklists all
    named-path TCK scenarios (``morpheus-tck/.../failing_blacklist``)."""

    path_var: str = ""
    entities: Tuple[str, ...] = ()

    @property
    def fields(self) -> FieldsT:
        from ..api import types as _T

        return self.in_op.fields + ((self.path_var, _T.CTPath),)

    def _show_inner(self) -> str:
        return f"{self.path_var} = ({', '.join(self.entities)})"


@dataclass(frozen=True)
class Filter(UnaryOp):
    predicate: Expr

    def _show_inner(self) -> str:
        return self.predicate.pretty_expr()


@dataclass(frozen=True)
class Project(UnaryOp):
    projection: Expr
    fld: Opt[str] = None

    @property
    def fields(self) -> FieldsT:
        if self.fld is None:
            return self.in_op.fields
        t = self.projection.cypher_type
        return tuple((n, ty) for n, ty in self.in_op.fields if n != self.fld) + (
            (self.fld, t),
        )

    def _show_inner(self) -> str:
        return f"{self.fld} := {self.projection.pretty_expr()}"


@dataclass(frozen=True)
class Unwind(UnaryOp):
    list_expr: Expr
    fld: str
    fld_type: CypherType

    @property
    def fields(self) -> FieldsT:
        return self.in_op.fields + ((self.fld, self.fld_type),)

    def _show_inner(self) -> str:
        return f"{self.fld} IN {self.list_expr.pretty_expr()}"


@dataclass(frozen=True)
class Aggregate(UnaryOp):
    group: FieldsT
    aggregations: Tuple[Tuple[str, Agg], ...]

    @property
    def fields(self) -> FieldsT:
        out = list(self.group)
        for name, agg in self.aggregations:
            out.append((name, agg.cypher_type))
        return tuple(out)

    def _show_inner(self) -> str:
        g = ", ".join(n for n, _ in self.group)
        a = ", ".join(f"{n}:={a.pretty_expr()}" for n, a in self.aggregations)
        return f"group=[{g}] aggs=[{a}]"


@dataclass(frozen=True)
class Distinct(UnaryOp):
    on_fields: Tuple[str, ...]

    def _show_inner(self) -> str:
        return ", ".join(self.on_fields)


@dataclass(frozen=True)
class Select(UnaryOp):
    select_fields: Tuple[str, ...]

    @property
    def fields(self) -> FieldsT:
        d = dict(self.in_op.fields)
        return tuple((n, d[n]) for n in self.select_fields)

    def _show_inner(self) -> str:
        return ", ".join(self.select_fields)


@dataclass(frozen=True)
class OrderBy(UnaryOp):
    sort_items: Tuple[SortItem, ...]


@dataclass(frozen=True)
class Skip(UnaryOp):
    expr: Expr


@dataclass(frozen=True)
class Limit(UnaryOp):
    expr: Expr


@dataclass(frozen=True)
class FromGraph(UnaryOp):
    qgn: str

    @property
    def graph_name(self) -> str:
        return self.qgn

    def _show_inner(self) -> str:
        return self.qgn


@dataclass(frozen=True)
class ReturnGraph(UnaryOp):
    pass


@dataclass(frozen=True)
class ConstructGraph(UnaryOp):
    construct: ConstructBlock
    new_graph_name: str

    @property
    def graph_name(self) -> str:
        return self.new_graph_name


# -- binary -----------------------------------------------------------------


@dataclass(frozen=True)
class BinaryOp(LogicalOperator):
    lhs: LogicalOperator
    rhs: LogicalOperator

    @property
    def fields(self) -> FieldsT:
        d = dict(self.lhs.fields)
        for n, t in self.rhs.fields:
            d.setdefault(n, t)
        return tuple(d.items())

    @property
    def graph_name(self) -> str:
        return self.lhs.graph_name


@dataclass(frozen=True)
class CartesianProduct(BinaryOp):
    pass


@dataclass(frozen=True)
class ValueJoin(BinaryOp):
    """Inner join on equality predicates (reference ``ValueJoin``)."""

    predicates: Tuple[Expr, ...]

    def _show_inner(self) -> str:
        return ", ".join(p.pretty_expr() for p in self.predicates)


@dataclass(frozen=True)
class Optional(BinaryOp):
    """OPTIONAL MATCH: rhs plans the optional part over lhs's fields."""


@dataclass(frozen=True)
class ExistsSubQuery(BinaryOp):
    """rhs existence flag bound to ``target_field`` (reference
    ``ExistsSubQuery``, planned as semijoin flag ``RelationalPlanner.scala:224-246``).

    ``correlated``: the lhs fields the subquery actually references — the
    semijoin key. Joining on ALL common columns would break under null
    outer columns (OPTIONAL MATCH): null keys never match."""

    target_field: str
    correlated: Tuple[str, ...] = ()

    @property
    def fields(self) -> FieldsT:
        from ..api.types import CTBoolean

        return self.lhs.fields + ((self.target_field, CTBoolean),)


@dataclass(frozen=True)
class PatternComprehension(BinaryOp):
    """Per-lhs-row list of ``projection`` values over rhs pattern matches,
    bound to ``target_field``; no matches yield the empty list. Planned as
    collect-aggregate + left outer join (the reference blacklists pattern
    comprehensions at TCK level — ``failing_blacklist`` — we execute them)."""

    projection: Expr
    target_field: str
    list_type: CypherType
    correlated: Tuple[str, ...] = ()

    @property
    def fields(self) -> FieldsT:
        return self.lhs.fields + ((self.target_field, self.list_type),)


@dataclass(frozen=True)
class Expand(BinaryOp):
    """(source)-[rel]->(target): lhs solves ONE endpoint (source or target —
    inspect ``lhs.fields``), rhs scans the other
    (reference ``Expand``, ``LogicalOperator.scala:162``)."""

    source: str
    rel: str
    rel_type: CypherType
    target: str
    direction: str  # '>' outgoing from source, '-' undirected

    @property
    def fields(self) -> FieldsT:
        return BinaryOp.fields.fget(self) + ((self.rel, self.rel_type),)

    def _show_inner(self) -> str:
        arrow = "->" if self.direction == ">" else "-"
        return f"({self.source})-[{self.rel}:{self.rel_type!r}]{arrow}({self.target})"


@dataclass(frozen=True)
class ExpandInto(UnaryOp):
    """Both endpoints already bound (reference ``ExpandInto``,
    ``LogicalOperator.scala:209``)."""

    source: str
    rel: str
    rel_type: CypherType
    target: str
    direction: str

    @property
    def fields(self) -> FieldsT:
        return self.in_op.fields + ((self.rel, self.rel_type),)

    def _show_inner(self) -> str:
        return f"({self.source})-[{self.rel}]-({self.target}) INTO"


@dataclass(frozen=True)
class BoundedVarLengthExpand(BinaryOp):
    """(source)-[rel*lo..hi]->(target) (reference ``BoundedVarLengthExpand``,
    ``LogicalOperator.scala:177``)."""

    source: str
    rel: str
    rel_type: CypherType  # element type; the bound list var is CTList(rel_type)
    target: str
    direction: str
    lower: int
    upper: Opt[int]  # None = unbounded '*' (resolved at relational planning)
    # when a named path spans this rel, intermediate hop nodes are captured
    # (per-hop node-scan joins + hidden companion list column) so the path
    # value carries full node elements, not id-only placeholders
    capture_path_nodes: bool = False

    @property
    def fields(self) -> FieldsT:
        from ..api.types import CTListType

        return BinaryOp.fields.fget(self) + ((self.rel, CTListType(self.rel_type)),)

    def _show_inner(self) -> str:
        return f"({self.source})-[{self.rel}*{self.lower}..{self.upper}]->({self.target})"


@dataclass(frozen=True)
class TabularUnionAll(BinaryOp):
    @property
    def fields(self) -> FieldsT:
        return self.lhs.fields


@dataclass(frozen=True)
class GraphUnionAll(LogicalOperator):
    graphs: Tuple[LogicalOperator, ...]
    qgn: str

    @property
    def fields(self) -> FieldsT:
        return ()

    @property
    def graph_name(self) -> str:
        return self.qgn
