"""Frontend AST: query clauses and patterns.

The reference delegates parsing to Neo4j's ``cypher-frontend 9.0`` (external
dependency, ``build.params.gradle:15``; pipeline ``CypherParser.scala:66-79``).
We own the parser, so this module defines our AST: clause nodes mirroring the
openCypher 9 query structure plus the multiple-graph extensions the reference
supports (FROM GRAPH / CONSTRUCT / CATALOG CREATE GRAPH|VIEW).

Expressions inside clauses are ``tpu_cypher.ir.expr`` nodes directly (single
shared expression tree — see that module's docstring).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..ir.expr import Expr, MapLit, Var
from ..ir.pattern import BOTH, INCOMING, OUTGOING  # single source of truth
from ..trees import TreeNode


@dataclass(frozen=True)
class NodePattern(TreeNode):
    var: Optional[str]
    labels: Tuple[str, ...] = ()
    properties: Optional[MapLit] = None
    base_var: Optional[str] = None  # COPY OF base in CONSTRUCT: (n COPY OF m)

    def __repr__(self) -> str:
        lbl = "".join(f":{l}" for l in self.labels)
        return f"({self.var or ''}{lbl})"


@dataclass(frozen=True)
class RelPattern(TreeNode):
    var: Optional[str]
    types: Tuple[str, ...] = ()
    direction: str = OUTGOING  # OUTGOING | INCOMING | BOTH
    properties: Optional[MapLit] = None
    length: Optional[Tuple[int, Optional[int]]] = None  # (min, max|None) for var-length
    base_var: Optional[str] = None

    @property
    def is_var_length(self) -> bool:
        return self.length is not None

    def __repr__(self) -> str:
        t = "|".join(self.types)
        arrow = {
            OUTGOING: f"-[{self.var or ''}:{t}]->",
            INCOMING: f"<-[{self.var or ''}:{t}]-",
            BOTH: f"-[{self.var or ''}:{t}]-",
        }[self.direction]
        return arrow


@dataclass(frozen=True)
class PatternPart(TreeNode):
    """One comma-separated path: node (rel node)*; optionally named."""

    elements: Tuple[TreeNode, ...]  # alternating NodePattern / RelPattern
    path_var: Optional[str] = None

    @property
    def nodes(self) -> Tuple[NodePattern, ...]:
        return tuple(e for e in self.elements if isinstance(e, NodePattern))

    @property
    def rels(self) -> Tuple[RelPattern, ...]:
        return tuple(e for e in self.elements if isinstance(e, RelPattern))


@dataclass(frozen=True)
class Pattern(TreeNode):
    parts: Tuple[PatternPart, ...]


# ---------------------------------------------------------------------------
# Clause building blocks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SortItem(TreeNode):
    expr: Expr
    ascending: bool = True


@dataclass(frozen=True)
class ReturnItem(TreeNode):
    expr: Expr
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if isinstance(self.expr, Var):
            return self.expr.name
        return self.expr.pretty_expr()


# ---------------------------------------------------------------------------
# Clauses
# ---------------------------------------------------------------------------


class Clause(TreeNode):
    pass


@dataclass(frozen=True)
class Match(Clause):
    pattern: Pattern
    where: Optional[Expr] = None
    optional: bool = False


@dataclass(frozen=True)
class Unwind(Clause):
    expr: Expr
    var: str


@dataclass(frozen=True)
class ProjectionClause(Clause):
    """Shared body of WITH / RETURN."""

    items: Tuple[ReturnItem, ...]
    star: bool = False  # WITH * / RETURN *
    distinct: bool = False
    order_by: Tuple[SortItem, ...] = ()
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None
    where: Optional[Expr] = None  # WITH ... WHERE only


@dataclass(frozen=True)
class With(ProjectionClause):
    pass


@dataclass(frozen=True)
class Return(ProjectionClause):
    pass


@dataclass(frozen=True)
class FromGraph(Clause):
    """FROM GRAPH <qualified name> or a parameterized VIEW invocation
    ``FROM GRAPH v(g1, g2)`` (multiple-graph support)."""

    graph_name: str
    args: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ReturnGraph(Clause):
    """RETURN GRAPH"""


@dataclass(frozen=True)
class ConstructClause(Clause):
    """CONSTRUCT [ON g1, g2] [CLONE a, b AS c] [NEW (...)] [SET ...]

    Reference IR: ``IRBuilder.scala:271-330`` / ``LogicalPatternGraph``.
    """

    on_graphs: Tuple[str, ...] = ()
    clones: Tuple[ReturnItem, ...] = ()  # expr must be Var; alias optional
    news: Tuple[Pattern, ...] = ()
    sets: Tuple["SetItem", ...] = ()


@dataclass(frozen=True)
class SetItem(TreeNode):
    """SET a.prop = expr | SET a:Label | SET a = {..} (CONSTRUCT / CREATE)"""

    target: Expr  # Property(var, key) or Var for label set
    value: Optional[Expr] = None
    labels: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CreateClause(Clause):
    """CREATE pattern — a graph write against a mutable ambient graph
    (docs/mutation.md); also reused by the in-memory test-graph factory
    (reference ``CreateQueryParser.scala:97``) and CONSTRUCT NEW."""

    pattern: Pattern


@dataclass(frozen=True)
class MergeClause(Clause):
    """MERGE pattern [ON CREATE SET ...] [ON MATCH SET ...]"""

    pattern: Pattern  # single pattern part
    on_create: Tuple["SetItem", ...] = ()
    on_match: Tuple["SetItem", ...] = ()


@dataclass(frozen=True)
class SetClause(Clause):
    """SET item [, item]* as a standalone write clause."""

    items: Tuple["SetItem", ...]


@dataclass(frozen=True)
class DeleteClause(Clause):
    """[DETACH] DELETE expr [, expr]* — exprs must be bound element vars."""

    exprs: Tuple[Expr, ...]
    detach: bool = False


@dataclass(frozen=True)
class CallClause(Clause):
    """CALL proc.name(args) [YIELD item, ...] — parsed for a clean typed
    "unsupported" error downstream (the reference parses procedure calls via
    its frontend and blacklists ProcedureCallAcceptance at TCK level)."""

    procedure: str
    args: Tuple[Expr, ...] = ()
    yields: Tuple[ReturnItem, ...] = ()
    star: bool = False


# ---------------------------------------------------------------------------
# Queries / statements
# ---------------------------------------------------------------------------


class Statement(TreeNode):
    pass


@dataclass(frozen=True)
class SingleQuery(Statement):
    clauses: Tuple[Clause, ...]


@dataclass(frozen=True)
class UnionQuery(Statement):
    queries: Tuple[Statement, ...]
    all: bool = False


@dataclass(frozen=True)
class CreateGraphStatement(Statement):
    """CATALOG CREATE GRAPH <qgn> { <query> }"""

    qgn: str
    inner: Statement


@dataclass(frozen=True)
class CreateViewStatement(Statement):
    """CATALOG CREATE VIEW <name>($p1, $p2) { <query> }"""

    name: str
    params: Tuple[str, ...]
    inner_text: str


@dataclass(frozen=True)
class DropGraphStatement(Statement):
    qgn: str
    view: bool = False
