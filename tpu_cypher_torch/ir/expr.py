"""The expression tree.

Re-design of the reference's ``Expr`` hierarchy
(``okapi-ir/src/main/scala/org/opencypher/okapi/ir/api/expr/Expr.scala:52-1220``,
~150 case classes). Key differences:

* ONE expression tree is shared by the parser AST, the IR, and the physical
  layer (the reference has a separate Neo4j-frontend AST; we own the parser, so
  a single tree with an optional ``typ`` slot that the typer fills suffices).
* Scalar functions are a single ``FunctionCall`` node resolved against a
  signature table (``tpu_cypher.ir.functions``) instead of ~70 case classes;
  aggregators are a single ``Agg`` node. Column-level expressions that the
  RecordHeader tracks per element variable (``Id``, ``HasLabel``, ``HasType``,
  ``StartNode``, ``EndNode``, ``Property``) stay dedicated nodes as in the
  reference (``Expr.scala``: ``Id``, ``HasLabel``, ``HasType``, ``StartNode``,
  ``EndNode``, ``Property``) because they key physical columns.

All nodes are frozen dataclasses on the TreeNode substrate, so plan rewrites
(CNF normalization, alias substitution) reuse the generic rewriting machinery.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

from ..api import types as CT
from ..api.types import CypherType
from ..trees import TreeNode


@dataclass(frozen=True)
class Expr(TreeNode):
    """Base expression. ``typ`` is None until the typer runs."""

    def __post_init__(self):
        pass

    @property
    def typ(self) -> Optional[CypherType]:
        return getattr(self, "_typ", None)

    def with_type(self, t: CypherType) -> "Expr":
        clone = replace(self)
        object.__setattr__(clone, "_typ", t)
        return clone

    @property
    def cypher_type(self) -> CypherType:
        t = self.typ
        return t if t is not None else CT.CTAny.nullable

    def with_new_children(self, new_children):
        out = super().with_new_children(new_children)
        if out is not self and self.typ is not None and out.typ is None:
            object.__setattr__(out, "_typ", self.typ)
        return out

    def _show_inner(self) -> str:  # pragma: no cover - cosmetic
        return super()._show_inner()

    def __str__(self) -> str:
        return self.pretty_expr()

    def pretty_expr(self) -> str:
        return repr(self)


def _copy_type(src: Expr, dst: Expr) -> Expr:
    t = src.typ
    if t is not None:
        object.__setattr__(dst, "_typ", t)
    return dst


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Var(Expr):
    """A named binding (reference ``Var``, ``Expr.scala:106``)."""

    name: str

    def pretty_expr(self) -> str:
        return self.name


@dataclass(frozen=True)
class Param(Expr):
    """$parameter (reference ``Param``)."""

    name: str

    def pretty_expr(self) -> str:
        return f"${self.name}"


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    """A literal scalar (int/float/str/bool/None)."""

    value: Any

    # custom eq/hash: Python's 1 == True would conflate Lit(1) and Lit(True)
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Lit)
            and type(other.value) is type(self.value)
            and other.value == self.value
        )

    def __hash__(self) -> int:
        return hash(("Lit", type(self.value).__name__, self.value))

    def pretty_expr(self) -> str:
        from ..api.values import to_cypher_string

        return to_cypher_string(self.value)


NULL = Lit(None)
TRUE = Lit(True)
FALSE = Lit(False)


@dataclass(frozen=True)
class ListLit(Expr):
    items: Tuple[Expr, ...]

    def pretty_expr(self) -> str:
        return "[" + ", ".join(i.pretty_expr() for i in self.items) + "]"


@dataclass(frozen=True)
class MapLit(Expr):
    keys: Tuple[str, ...]
    values: Tuple[Expr, ...]

    def pretty_expr(self) -> str:
        inner = ", ".join(f"{k}: {v.pretty_expr()}" for k, v in zip(self.keys, self.values))
        return "{" + inner + "}"


# ---------------------------------------------------------------------------
# Column-level element expressions (RecordHeader keys)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Id(Expr):
    """Element id of a var (reference ``Id``)."""

    expr: Expr

    def pretty_expr(self) -> str:
        return f"id({self.expr.pretty_expr()})"


@dataclass(frozen=True)
class StartNode(Expr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"startNode({self.expr.pretty_expr()})"


@dataclass(frozen=True)
class EndNode(Expr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"endNode({self.expr.pretty_expr()})"


@dataclass(frozen=True)
class HasLabel(Expr):
    expr: Expr
    label: str

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()}:{self.label}"


@dataclass(frozen=True)
class HasType(Expr):
    expr: Expr
    rel_type: str

    def pretty_expr(self) -> str:
        return f"type({self.expr.pretty_expr()}) = '{self.rel_type}'"


@dataclass(frozen=True)
class Property(Expr):
    expr: Expr
    key: str

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()}.{self.key}"


@dataclass(frozen=True)
class AliasExpr(Expr):
    """``expr AS alias`` (reference ``AliasExpr``)."""

    expr: Expr
    alias: Var

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()} AS {self.alias.name}"


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ands(Expr):
    exprs: Tuple[Expr, ...]

    @staticmethod
    def of(*exprs: Expr) -> Expr:
        flat = []
        for e in exprs:
            if isinstance(e, Ands):
                flat.extend(e.exprs)
            else:
                flat.append(e)
        flat = [e for e in flat if e != TRUE]
        if not flat:
            return TRUE
        if len(flat) == 1:
            return flat[0]
        return Ands(tuple(flat))

    def pretty_expr(self) -> str:
        return " AND ".join(f"({e.pretty_expr()})" for e in self.exprs)


@dataclass(frozen=True)
class Ors(Expr):
    exprs: Tuple[Expr, ...]

    @staticmethod
    def of(*exprs: Expr) -> Expr:
        flat = []
        for e in exprs:
            if isinstance(e, Ors):
                flat.extend(e.exprs)
            else:
                flat.append(e)
        if not flat:
            return FALSE
        if len(flat) == 1:
            return flat[0]
        return Ors(tuple(flat))

    def pretty_expr(self) -> str:
        return " OR ".join(f"({e.pretty_expr()})" for e in self.exprs)


@dataclass(frozen=True)
class Xor(Expr):
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Not(Expr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"NOT ({self.expr.pretty_expr()})"


class BinaryPredicate(Expr):
    pass


def _binop(name: str, symbol: str):
    @dataclass(frozen=True)
    class _Op(BinaryPredicate):
        lhs: Expr
        rhs: Expr

        def pretty_expr(self) -> str:
            return f"{self.lhs.pretty_expr()} {symbol} {self.rhs.pretty_expr()}"

    _Op.__name__ = _Op.__qualname__ = name
    _Op.symbol = symbol
    return _Op


Equals = _binop("Equals", "=")
Neq = _binop("Neq", "<>")
LessThan = _binop("LessThan", "<")
LessThanOrEqual = _binop("LessThanOrEqual", "<=")
GreaterThan = _binop("GreaterThan", ">")
GreaterThanOrEqual = _binop("GreaterThanOrEqual", ">=")
In = _binop("In", "IN")
StartsWith = _binop("StartsWith", "STARTS WITH")
EndsWith = _binop("EndsWith", "ENDS WITH")
Contains = _binop("Contains", "CONTAINS")
RegexMatch = _binop("RegexMatch", "=~")


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()} IS NULL"


@dataclass(frozen=True)
class IsNotNull(Expr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()} IS NOT NULL"


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


class ArithmeticExpr(Expr):
    pass


def _arith(name: str, symbol: str):
    @dataclass(frozen=True)
    class _Op(ArithmeticExpr):
        lhs: Expr
        rhs: Expr

        def pretty_expr(self) -> str:
            return f"({self.lhs.pretty_expr()} {symbol} {self.rhs.pretty_expr()})"

    _Op.__name__ = _Op.__qualname__ = name
    _Op.symbol = symbol
    return _Op


Add = _arith("Add", "+")
Subtract = _arith("Subtract", "-")
Multiply = _arith("Multiply", "*")
Divide = _arith("Divide", "/")
Modulo = _arith("Modulo", "%")
Pow = _arith("Pow", "^")


@dataclass(frozen=True)
class Neg(ArithmeticExpr):
    expr: Expr

    def pretty_expr(self) -> str:
        return f"-({self.expr.pretty_expr()})"


# ---------------------------------------------------------------------------
# Functions & aggregators
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FunctionCall(Expr):
    """A scalar function call, resolved by name against ``ir.functions``."""

    name: str  # canonical lower-case
    args: Tuple[Expr, ...]

    def pretty_expr(self) -> str:
        return f"{self.name}(" + ", ".join(a.pretty_expr() for a in self.args) + ")"


@dataclass(frozen=True)
class Agg(Expr):
    """An aggregator (count/sum/avg/min/max/collect/stDev/stDevP/percentiles).

    Reference: ``Expr.scala`` ``Aggregator`` family.
    """

    name: str
    expr: Optional[Expr]
    distinct: bool = False
    extra: Tuple[Expr, ...] = ()  # e.g. percentile fraction

    def pretty_expr(self) -> str:
        inner = "DISTINCT " if self.distinct else ""
        arg = self.expr.pretty_expr() if self.expr is not None else "*"
        return f"{self.name}({inner}{arg})"


@dataclass(frozen=True)
class CountStar(Expr):
    def pretty_expr(self) -> str:
        return "count(*)"


# ---------------------------------------------------------------------------
# Conditionals / comprehensions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CaseExpr(Expr):
    """Both simple (operand != None) and generic CASE."""

    operand: Optional[Expr]
    whens: Tuple[Expr, ...]
    thens: Tuple[Expr, ...]
    default: Optional[Expr]

    def pretty_expr(self) -> str:
        parts = ["CASE"]
        if self.operand is not None:
            parts.append(self.operand.pretty_expr())
        for w, t in zip(self.whens, self.thens):
            parts.append(f"WHEN {w.pretty_expr()} THEN {t.pretty_expr()}")
        if self.default is not None:
            parts.append(f"ELSE {self.default.pretty_expr()}")
        parts.append("END")
        return " ".join(parts)


@dataclass(frozen=True)
class ListComprehension(Expr):
    """[var IN list WHERE pred | proj]"""

    var: Var
    list_expr: Expr
    where: Optional[Expr]
    projection: Optional[Expr]


@dataclass(frozen=True)
class Opaque:
    """Wraps an expression so generic tree traversal does NOT descend into
    it (it is not a TreeNode): sub-expressions scoped to an inner context
    (pattern comprehension bodies) must not be rewritten/extracted against
    the OUTER plan."""

    value: Any


@dataclass(frozen=True)
class PatternComprehension(Expr):
    """[path = (a)-[:R]->(b) WHERE pred | proj] — a correlated subquery
    producing a list per outer row (reference: ``PatternComprehension`` in
    the Neo4j frontend, rewritten by ``extractSubqueryFromPatternExpression``;
    the reference backends blacklist it at TCK level — we execute it).

    Carries the raw frontend pattern and inner expressions (boxed so outer
    traversals skip them); the IR builder attaches the converted inner
    pattern/predicates/projection, and the logical planner extracts it into
    a collect-subquery the way exists-patterns become ``ExistsSubQuery``."""

    pattern: Any  # frontend.ast.Pattern (untyped to avoid import cycle)
    path_var: Optional[str]
    where: Optional[Opaque]
    projection: Opaque
    # filled by IR builder with a fresh target var name
    target_field: Optional[str] = None


@dataclass(frozen=True)
class ListSlice(Expr):
    expr: Expr
    from_: Optional[Expr]
    to: Optional[Expr]

    def pretty_expr(self) -> str:
        f = self.from_.pretty_expr() if self.from_ is not None else ""
        t = self.to.pretty_expr() if self.to is not None else ""
        return f"{self.expr.pretty_expr()}[{f}..{t}]"


@dataclass(frozen=True)
class Index(Expr):
    """container[index] — list index or map key lookup."""

    expr: Expr
    index: Expr

    def pretty_expr(self) -> str:
        return f"{self.expr.pretty_expr()}[{self.index.pretty_expr()}]"


@dataclass(frozen=True)
class Quantified(Expr):
    """any/all/none/single(var IN list WHERE pred)."""

    kind: str  # any|all|none|single
    var: Var
    list_expr: Expr
    predicate: Expr


@dataclass(frozen=True)
class Reduce(Expr):
    """reduce(acc = init, var IN list | expr)"""

    acc: Var
    init: Expr
    var: Var
    list_expr: Expr
    expr: Expr


@dataclass(frozen=True)
class ExistsPattern(Expr):
    """A pattern used as predicate: WHERE (a)-[:R]->(b) / EXISTS(...).

    Carries the raw frontend pattern; the IR builder converts it into an
    exists-subquery (reference ``ExistsPatternExpr``).
    """

    pattern: Any  # frontend.ast.Pattern (untyped to avoid import cycle)
    # filled by IR builder with a fresh target var name
    target_field: Optional[str] = None


@dataclass(frozen=True)
class MapProjection(Expr):
    """map projection: var{.key, .*, key: expr, var}"""

    var: Var
    items: Tuple[Tuple[str, Optional[Expr]], ...]  # (key, None=.key | expr)
    all_props: bool = False


@dataclass(frozen=True)
class PrefixId(Expr):
    """Tag an element id with a graph prefix in the high bits.

    TPU-native replacement for the reference's varint-prefix codegen
    (``AddPrefix.scala:27-60`` / ``EncodeLong.scala:40-100``): ids stay fixed
    width int64 — ``id | (tag << 54)`` is a cheap XLA bitwise op, where the
    reference's byte-array prefixing is hostile to device columns.
    """

    expr: Expr
    tag: int

    def pretty_expr(self) -> str:
        return f"prefix({self.expr.pretty_expr()}, {self.tag})"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def walk_vars(e: Expr):
    """All Var leaves in an expression."""
    return [n for n in e.iter_nodes() if isinstance(n, Var)]


def substitute(e: Expr, mapping) -> Expr:
    """Replace sub-expressions per ``mapping`` (dict Expr->Expr), preserving types."""

    def rule(n: TreeNode) -> TreeNode:
        if isinstance(n, Expr) and n in mapping:
            return mapping[n]
        return n

    return e.rewrite_top_down(rule)


def has_aggregation(e: Expr) -> bool:
    return any(isinstance(n, (Agg, CountStar)) for n in e.iter_nodes())
