"""Cypher recursive-descent parser.

Replaces the reference's external Neo4j ``cypher-frontend 9.0`` dependency
(pipeline wrapped at ``okapi-ir/.../impl/parse/CypherParser.scala:52-79``) with
an owned parser producing ``frontend.ast`` clauses over the shared
``ir.expr`` expression tree.

Grammar coverage: single/union read queries (MATCH / OPTIONAL MATCH / WHERE /
WITH / RETURN / UNWIND / ORDER BY / SKIP / LIMIT / DISTINCT), full expression
grammar (boolean ops, chained comparisons, string/list/null predicates,
arithmetic, CASE, list/map literals, comprehensions, quantifiers, reduce,
functions/aggregates, pattern predicates), patterns incl. undirected and
variable-length relationships, named paths, and the multiple-graph surface
(CATALOG CREATE GRAPH/VIEW, DROP, FROM GRAPH, CONSTRUCT, RETURN GRAPH) plus
CREATE for test-graph construction.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..ir import expr as E
from . import ast as A
from .lexer import CypherSyntaxError, Token, tokenize

AGG_NAMES = {
    "count",
    "sum",
    "avg",
    "min",
    "max",
    "collect",
    "stdev",
    "stdevp",
    "percentilecont",
    "percentiledisc",
}

QUANTIFIERS = {"any", "all", "none", "single"}

_CLAUSE_STARTS = {
    "MATCH",
    "OPTIONAL",
    "WITH",
    "RETURN",
    "UNWIND",
    "WHERE",
    "ORDER",
    "SKIP",
    "LIMIT",
    "UNION",
    "CREATE",
    "CONSTRUCT",
    "FROM",
    "CLONE",
    "NEW",
    "SET",
    "ON",
    "CATALOG",
    "DETACH",
    "DELETE",
    "MERGE",
}


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.tokens) - 1)
        return self.tokens[j]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_sym(self, s: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "SYM" and t.text == s

    def at_kw(self, *kws: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "IDENT" and t.upper in kws

    def eat_sym(self, s: str) -> Token:
        if not self.at_sym(s):
            self.fail(f"Expected {s!r}")
        return self.next()

    def eat_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            self.fail(f"Expected {kw}")
        return self.next()

    def try_sym(self, s: str) -> bool:
        if self.at_sym(s):
            self.next()
            return True
        return False

    def try_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def fail(self, msg: str):
        t = self.peek()
        raise CypherSyntaxError(f"{msg}, found {t.text!r}", self.text, t.pos)

    def name(self) -> str:
        t = self.peek()
        if t.kind in ("IDENT", "ESC_IDENT"):
            self.next()
            return t.text
        self.fail("Expected identifier")

    # -- entry points ------------------------------------------------------

    def parse_statement(self) -> A.Statement:
        if self.at_kw("CATALOG") or (
            self.at_kw("CREATE") and self.at_kw("GRAPH", "VIEW", ahead=1)
        ) or (self.at_kw("DROP") and self.at_kw("GRAPH", "VIEW", ahead=1)):
            stmt = self.parse_catalog_statement()
        else:
            stmt = self.parse_query()
        self.try_sym(";")
        if self.peek().kind != "EOF":
            self.fail("Unexpected input after query")
        return stmt

    def parse_query(self) -> A.Statement:
        first = self.parse_single_query()
        queries = [first]
        alls: List[bool] = []
        while self.at_kw("UNION"):
            self.next()
            alls.append(self.try_kw("ALL"))
            queries.append(self.parse_single_query())
        if len(queries) == 1:
            return first
        if any(alls) and not all(alls):
            self.fail("Cannot mix UNION and UNION ALL")
        return A.UnionQuery(tuple(queries), all=bool(alls and alls[0]))

    def parse_catalog_statement(self) -> A.Statement:
        self.try_kw("CATALOG")
        if self.try_kw("CREATE"):
            if self.try_kw("GRAPH"):
                qgn = self.parse_qgn()
                self.eat_sym("{")
                inner = self.parse_query()
                self.eat_sym("}")
                return A.CreateGraphStatement(qgn, inner)
            if self.try_kw("VIEW"):
                vname = self.name()
                params: List[str] = []
                if self.try_sym("("):
                    while not self.at_sym(")"):
                        self.eat_sym("$")
                        params.append(self.name())
                        self.try_sym(",")
                    self.eat_sym(")")
                self.eat_sym("{")
                start = self.peek().pos
                depth = 1
                while depth > 0:
                    t = self.next()
                    if t.kind == "EOF":
                        self.fail("Unterminated view body")
                    if t.kind == "SYM" and t.text == "{":
                        depth += 1
                    elif t.kind == "SYM" and t.text == "}":
                        depth -= 1
                        end = t.pos
                return A.CreateViewStatement(vname, tuple(params), self.text[start:end])
            self.fail("Expected GRAPH or VIEW")
        if self.try_kw("DROP"):
            if self.try_kw("GRAPH"):
                return A.DropGraphStatement(self.parse_qgn())
            if self.try_kw("VIEW"):
                return A.DropGraphStatement(self.parse_qgn(), view=True)
            self.fail("Expected GRAPH or VIEW")
        self.fail("Expected CREATE or DROP after CATALOG")

    def parse_qgn(self) -> str:
        parts = [self.name()]
        while self.try_sym("."):
            parts.append(self.name())
        return ".".join(parts)

    # -- single query ------------------------------------------------------

    def parse_single_query(self) -> A.SingleQuery:
        clauses: List[A.Clause] = []
        while True:
            t = self.peek()
            if t.kind == "EOF" or self.at_kw("UNION") or self.at_sym("}") or self.at_sym(";"):
                break
            clauses.append(self.parse_clause())
        if not clauses:
            self.fail("Empty query")
        return A.SingleQuery(tuple(clauses))

    def parse_clause(self) -> A.Clause:
        if self.at_kw("MATCH"):
            return self.parse_match(optional=False)
        if self.at_kw("OPTIONAL"):
            self.next()
            return self.parse_match(optional=True)
        if self.at_kw("UNWIND"):
            self.next()
            e = self.parse_expression()
            self.eat_kw("AS")
            return A.Unwind(e, self.name())
        if self.at_kw("WITH"):
            self.next()
            return self.parse_projection(A.With, allow_where=True)
        if self.at_kw("RETURN"):
            self.next()
            if self.try_kw("GRAPH"):
                return A.ReturnGraph()
            return self.parse_projection(A.Return, allow_where=False)
        if self.at_kw("FROM"):
            self.next()
            self.try_kw("GRAPH")
            name = self.parse_qgn()
            args: List[str] = []
            if self.try_sym("("):
                # parameterized view invocation: FROM GRAPH v(g1, g2)
                while not self.at_sym(")"):
                    args.append(self.parse_qgn())
                    if not self.at_sym(")"):
                        self.eat_sym(",")
                self.eat_sym(")")
            return A.FromGraph(name, tuple(args))
        if self.at_kw("CONSTRUCT"):
            self.next()
            return self.parse_construct()
        if self.at_kw("CREATE"):
            self.next()
            return A.CreateClause(self.parse_pattern())
        if self.at_kw("MERGE"):
            self.next()
            pattern = self.parse_pattern(single_part=True)
            on_create: List[A.SetItem] = []
            on_match: List[A.SetItem] = []
            while self.try_kw("ON"):
                if self.try_kw("CREATE"):
                    items = on_create
                elif self.try_kw("MATCH"):
                    items = on_match
                else:
                    self.fail("Expected CREATE or MATCH after ON")
                self.eat_kw("SET")
                items.append(self.parse_set_item())
                while self.try_sym(","):
                    items.append(self.parse_set_item())
            return A.MergeClause(pattern, tuple(on_create), tuple(on_match))
        if self.at_kw("SET"):
            self.next()
            items = [self.parse_set_item()]
            while self.try_sym(","):
                items.append(self.parse_set_item())
            return A.SetClause(tuple(items))
        if self.at_kw("DELETE") or self.at_kw("DETACH"):
            detach = self.try_kw("DETACH")
            self.eat_kw("DELETE")
            exprs = [self.parse_expression()]
            while self.try_sym(","):
                exprs.append(self.parse_expression())
            return A.DeleteClause(tuple(exprs), detach)
        if self.at_kw("CALL"):
            self.next()
            return self.parse_call()
        self.fail("Expected a clause")

    def parse_call(self) -> A.CallClause:
        parts = [self.name()]
        while self.try_sym("."):
            parts.append(self.name())
        args: List[E.Expr] = []
        if self.try_sym("("):
            while not self.at_sym(")"):
                args.append(self.parse_expression())
                if not self.at_sym(")"):
                    self.eat_sym(",")
            self.eat_sym(")")
        yields: List[A.ReturnItem] = []
        star = False
        if self.try_kw("YIELD"):
            if self.at_sym("*"):
                self.next()
                star = True
            else:
                yields.append(self.parse_return_item())
                while self.try_sym(","):
                    yields.append(self.parse_return_item())
        return A.CallClause(
            ".".join(parts), tuple(args), tuple(yields), star
        )

    def parse_match(self, optional: bool) -> A.Match:
        self.eat_kw("MATCH")
        pattern = self.parse_pattern()
        where = None
        if self.try_kw("WHERE"):
            where = self.parse_expression()
        return A.Match(pattern, where, optional)

    def parse_projection(self, cls, allow_where: bool) -> A.ProjectionClause:
        distinct = self.try_kw("DISTINCT")
        star = False
        items: List[A.ReturnItem] = []
        if self.at_sym("*"):
            self.next()
            star = True
            while self.try_sym(","):
                items.append(self.parse_return_item())
        else:
            items.append(self.parse_return_item())
            while self.try_sym(","):
                items.append(self.parse_return_item())
        order_by: Tuple[A.SortItem, ...] = ()
        skip = limit = where = None
        if self.at_kw("ORDER"):
            self.next()
            self.eat_kw("BY")
            sorts = [self.parse_sort_item()]
            while self.try_sym(","):
                sorts.append(self.parse_sort_item())
            order_by = tuple(sorts)
        if self.try_kw("SKIP"):
            skip = self.parse_expression()
        if self.try_kw("LIMIT"):
            limit = self.parse_expression()
        if allow_where and self.try_kw("WHERE"):
            where = self.parse_expression()
        return cls(
            items=tuple(items),
            star=star,
            distinct=distinct,
            order_by=order_by,
            skip=skip,
            limit=limit,
            where=where,
        )

    def parse_return_item(self) -> A.ReturnItem:
        e = self.parse_expression()
        alias = None
        if self.try_kw("AS"):
            alias = self.name()
        return A.ReturnItem(e, alias)

    def parse_sort_item(self) -> A.SortItem:
        e = self.parse_expression()
        asc = True
        if self.try_kw("ASC", "ASCENDING"):
            asc = True
        elif self.try_kw("DESC", "DESCENDING"):
            asc = False
        return A.SortItem(e, asc)

    def parse_construct(self) -> A.ConstructClause:
        on_graphs: List[str] = []
        clones: List[A.ReturnItem] = []
        news: List[A.Pattern] = []
        sets: List[A.SetItem] = []
        if self.try_kw("ON"):
            on_graphs.append(self.parse_qgn())
            while self.try_sym(","):
                on_graphs.append(self.parse_qgn())
        while True:
            if self.try_kw("CLONE"):
                clones.append(self.parse_return_item())
                while self.try_sym(","):
                    clones.append(self.parse_return_item())
            elif self.try_kw("NEW") or self.try_kw("CREATE"):
                news.append(self.parse_pattern(single_part=True))
            elif self.try_kw("SET"):
                sets.append(self.parse_set_item())
                while self.try_sym(","):
                    sets.append(self.parse_set_item())
            else:
                break
        return A.ConstructClause(tuple(on_graphs), tuple(clones), tuple(news), tuple(sets))

    def parse_set_item(self) -> A.SetItem:
        var = E.Var(self.name())
        if self.try_sym("."):
            key = self.name()
            self.eat_sym("=")
            return A.SetItem(E.Property(var, key), self.parse_expression())
        if self.at_sym(":"):
            labels = []
            while self.try_sym(":"):
                labels.append(self.name())
            return A.SetItem(var, labels=tuple(labels))
        self.eat_sym("=")
        return A.SetItem(var, self.parse_expression())

    # -- patterns ----------------------------------------------------------

    def parse_pattern(self, single_part: bool = False) -> A.Pattern:
        parts = [self.parse_pattern_part()]
        if not single_part:
            while self.try_sym(","):
                parts.append(self.parse_pattern_part())
        return A.Pattern(tuple(parts))

    def parse_pattern_part(self) -> A.PatternPart:
        path_var = None
        if (
            self.peek().kind in ("IDENT", "ESC_IDENT")
            and self.at_sym("=", ahead=1)
            and self.peek().upper not in _CLAUSE_STARTS
        ):
            path_var = self.name()
            self.eat_sym("=")
        elements: List = [self.parse_node_pattern()]
        while self.at_sym("-") or self.at_sym("<-") or self.at_sym("<"):
            rel = self.parse_rel_pattern()
            node = self.parse_node_pattern()
            elements.append(rel)
            elements.append(node)
        return A.PatternPart(tuple(elements), path_var)

    def parse_node_pattern(self) -> A.NodePattern:
        self.eat_sym("(")
        var = None
        base_var = None
        labels: List[str] = []
        props = None
        if self.peek().kind in ("IDENT", "ESC_IDENT") and not self.at_kw("COPY"):
            var = self.name()
        if self.try_kw("COPY"):
            self.eat_kw("OF")
            base_var = self.name()
        while self.try_sym(":"):
            labels.append(self.name())
        if self.at_sym("{"):
            props = self.parse_map_literal()
        self.eat_sym(")")
        return A.NodePattern(var, tuple(labels), props, base_var)

    def parse_rel_pattern(self) -> A.RelPattern:
        # entry token is '-', '<-' or '<'
        if self.try_sym("<-"):
            incoming_start = True
        elif self.try_sym("<"):
            self.eat_sym("-")
            incoming_start = True
        else:
            self.eat_sym("-")
            incoming_start = False
        var = None
        base_var = None
        types: List[str] = []
        props = None
        length = None
        if self.try_sym("["):
            if self.peek().kind in ("IDENT", "ESC_IDENT") and not self.at_kw("COPY"):
                var = self.name()
            if self.try_kw("COPY"):
                self.eat_kw("OF")
                base_var = self.name()
            if self.try_sym(":"):
                types.append(self.name())
                while self.try_sym("|"):
                    self.try_sym(":")
                    types.append(self.name())
            if self.try_sym("*"):
                lo, hi = 1, None
                if self.peek().kind == "INT":
                    lo = int(self.next().text)
                    hi = lo
                if self.try_sym(".."):
                    hi = None
                    if self.peek().kind == "INT":
                        hi = int(self.next().text)
                length = (lo, hi)
            if self.at_sym("{"):
                props = self.parse_map_literal()
            self.eat_sym("]")
        # closing arrow
        if self.try_sym("->"):
            outgoing_end = True
        elif self.try_sym("-"):
            outgoing_end = False
            if self.try_sym(">"):
                outgoing_end = True
        else:
            self.fail("Expected relationship arrow")
        if incoming_start and outgoing_end:
            direction = A.BOTH  # <-[]-> treated as undirected
        elif incoming_start:
            direction = A.INCOMING
        elif outgoing_end:
            direction = A.OUTGOING
        else:
            direction = A.BOTH
        return A.RelPattern(var, tuple(types), direction, props, length, base_var)

    def parse_map_literal(self) -> E.MapLit:
        self.eat_sym("{")
        keys: List[str] = []
        values: List[E.Expr] = []
        while not self.at_sym("}"):
            keys.append(self.name())
            self.eat_sym(":")
            values.append(self.parse_expression())
            if not self.try_sym(","):
                break
        self.eat_sym("}")
        return E.MapLit(tuple(keys), tuple(values))

    # -- expressions -------------------------------------------------------

    def parse_expression(self) -> E.Expr:
        return self.parse_or()

    def parse_or(self) -> E.Expr:
        e = self.parse_xor()
        if self.at_kw("OR"):
            terms = [e]
            while self.try_kw("OR"):
                terms.append(self.parse_xor())
            return E.Ors.of(*terms)
        return e

    def parse_xor(self) -> E.Expr:
        e = self.parse_and()
        while self.at_kw("XOR"):
            self.next()
            e = E.Xor(e, self.parse_and())
        return e

    def parse_and(self) -> E.Expr:
        e = self.parse_not()
        if self.at_kw("AND"):
            terms = [e]
            while self.try_kw("AND"):
                terms.append(self.parse_not())
            return E.Ands.of(*terms)
        return e

    def parse_not(self) -> E.Expr:
        if self.try_kw("NOT"):
            return E.Not(self.parse_not())
        return self.parse_comparison()

    _CMP = {
        "=": E.Equals,
        "<>": E.Neq,
        "<": E.LessThan,
        "<=": E.LessThanOrEqual,
        ">": E.GreaterThan,
        ">=": E.GreaterThanOrEqual,
    }

    def parse_comparison(self) -> E.Expr:
        e = self.parse_predicated()
        comparisons: List[E.Expr] = []
        left = e
        while self.peek().kind == "SYM" and self.peek().text in self._CMP:
            op = self.next().text
            right = self.parse_predicated()
            comparisons.append(self._CMP[op](left, right))
            left = right
        if not comparisons:
            return e
        if len(comparisons) == 1:
            return comparisons[0]
        return E.Ands.of(*comparisons)

    def parse_predicated(self) -> E.Expr:
        """STARTS WITH / ENDS WITH / CONTAINS / IN / =~ / IS [NOT] NULL."""
        e = self.parse_additive()
        while True:
            if self.at_kw("STARTS"):
                self.next()
                self.eat_kw("WITH")
                e = E.StartsWith(e, self.parse_additive())
            elif self.at_kw("ENDS"):
                self.next()
                self.eat_kw("WITH")
                e = E.EndsWith(e, self.parse_additive())
            elif self.at_kw("CONTAINS"):
                self.next()
                e = E.Contains(e, self.parse_additive())
            elif self.at_kw("IN"):
                self.next()
                e = E.In(e, self.parse_additive())
            elif self.at_sym("=~"):
                self.next()
                e = E.RegexMatch(e, self.parse_additive())
            elif self.at_kw("IS"):
                self.next()
                if self.try_kw("NOT"):
                    self.eat_kw("NULL")
                    e = E.IsNotNull(e)
                else:
                    self.eat_kw("NULL")
                    e = E.IsNull(e)
            else:
                return e

    def parse_additive(self) -> E.Expr:
        e = self.parse_multiplicative()
        while True:
            if self.at_sym("+"):
                self.next()
                e = E.Add(e, self.parse_multiplicative())
            elif self.at_sym("-"):
                self.next()
                e = E.Subtract(e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self) -> E.Expr:
        e = self.parse_unary()
        while True:
            if self.at_sym("*"):
                self.next()
                e = E.Multiply(e, self.parse_unary())
            elif self.at_sym("/"):
                self.next()
                e = E.Divide(e, self.parse_unary())
            elif self.at_sym("%"):
                self.next()
                e = E.Modulo(e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> E.Expr:
        # power binds tighter than unary minus (openCypher: -2^2 = -(2^2))
        if self.try_sym("-"):
            inner = self.parse_unary()
            if (
                isinstance(inner, E.Lit)
                and isinstance(inner.value, (int, float))
                and not isinstance(inner.value, bool)
            ):
                return E.Lit(-inner.value)
            return E.Neg(inner)
        if self.try_sym("+"):
            return self.parse_unary()
        return self.parse_power()

    def parse_power(self) -> E.Expr:
        e = self.parse_postfix()
        if self.at_sym("^"):
            self.next()
            return E.Pow(e, self.parse_unary())  # right-assoc; exponent may be unary
        return e

    def parse_postfix(self) -> E.Expr:
        e = self.parse_atom()
        while True:
            if self.at_sym("."):
                self.next()
                e = E.Property(e, self.name())
            elif self.at_sym("["):
                self.next()
                lo: Optional[E.Expr] = None
                if not self.at_sym("..") and not self.at_sym("]"):
                    lo = self.parse_expression()
                if self.try_sym(".."):
                    hi: Optional[E.Expr] = None
                    if not self.at_sym("]"):
                        hi = self.parse_expression()
                    self.eat_sym("]")
                    e = E.ListSlice(e, lo, hi)
                else:
                    self.eat_sym("]")
                    if lo is None:
                        self.fail("Empty index")
                    e = E.Index(e, lo)
            elif (
                self.at_sym(":")
                and self.peek(1).kind in ("IDENT", "ESC_IDENT")
            ):
                # label/type predicate: n:Person[:Employee...]
                preds: List[E.Expr] = []
                while self.try_sym(":"):
                    preds.append(E.HasLabel(e, self.name()))
                e = E.Ands.of(*preds)
            else:
                return e

    def parse_atom(self) -> E.Expr:
        t = self.peek()
        if t.kind == "INT":
            self.next()
            return E.Lit(int(t.text))
        if t.kind == "FLOAT":
            self.next()
            return E.Lit(float(t.text))
        if t.kind == "STRING":
            self.next()
            return E.Lit(t.text)
        if t.kind == "SYM" and t.text == "$":
            self.next()
            p = self.peek()
            if p.kind in ("IDENT", "ESC_IDENT", "INT"):
                self.next()
                return E.Param(p.text)
            self.fail("Expected parameter name")
        if t.kind == "SYM" and t.text == "[":
            return self.parse_list_atom()
        if t.kind == "SYM" and t.text == "{":
            return self.parse_map_literal()
        if t.kind == "SYM" and t.text == "(":
            return self.parse_paren_or_pattern()
        if t.kind == "ESC_IDENT":
            self.next()
            return E.Var(t.text)
        if t.kind == "IDENT":
            u = t.upper
            if u == "TRUE":
                self.next()
                return E.TRUE
            if u == "FALSE":
                self.next()
                return E.FALSE
            if u == "NULL":
                self.next()
                return E.NULL
            if u == "CASE":
                return self.parse_case()
            if u == "COUNT" and self.at_sym("(", ahead=1) and self.at_sym("*", ahead=2):
                self.next()
                self.next()
                self.next()
                self.eat_sym(")")
                return E.CountStar()
            if u == "EXISTS" and self.at_sym("(", ahead=1):
                self.next()
                self.next()
                inner = self.parse_pattern_or_expr()
                self.eat_sym(")")
                if isinstance(inner, A.Pattern):
                    return E.ExistsPattern(inner)
                return E.IsNotNull(inner)
            if u == "REDUCE" and self.at_sym("(", ahead=1):
                self.next()
                self.next()
                acc = E.Var(self.name())
                self.eat_sym("=")
                init = self.parse_expression()
                self.eat_sym(",")
                var = E.Var(self.name())
                self.eat_kw("IN")
                lst = self.parse_expression()
                self.eat_sym("|")
                body = self.parse_expression()
                self.eat_sym(")")
                return E.Reduce(acc, init, var, lst, body)
            if t.text.lower() in QUANTIFIERS and self.at_sym("(", ahead=1):
                # any/all/none/single(x IN list WHERE pred) — must look like a
                # quantifier, not a same-named function with 1 plain arg
                save = self.i
                kind = t.text.lower()
                self.next()
                self.next()
                if self.peek().kind in ("IDENT", "ESC_IDENT") and self.at_kw("IN", ahead=1):
                    var = E.Var(self.name())
                    self.eat_kw("IN")
                    lst = self.parse_expression()
                    pred: E.Expr = E.TRUE
                    if self.try_kw("WHERE"):
                        pred = self.parse_expression()
                    self.eat_sym(")")
                    return E.Quantified(kind, var, lst, pred)
                self.i = save
            if u == "FILTER" and self.at_sym("(", ahead=1):
                self.next()
                self.next()
                var = E.Var(self.name())
                self.eat_kw("IN")
                lst = self.parse_expression()
                pred = None
                if self.try_kw("WHERE"):
                    pred = self.parse_expression()
                self.eat_sym(")")
                return E.ListComprehension(var, lst, pred, None)
            if u == "EXTRACT" and self.at_sym("(", ahead=1):
                self.next()
                self.next()
                var = E.Var(self.name())
                self.eat_kw("IN")
                lst = self.parse_expression()
                proj = None
                if self.try_sym("|"):
                    proj = self.parse_expression()
                self.eat_sym(")")
                return E.ListComprehension(var, lst, None, proj)
            # function call? (incl. qualified names like duration.between)
            if self.at_sym("(", ahead=1):
                return self.parse_function_call()
            if (
                self.at_sym(".", ahead=1)
                and self.peek(2).kind == "IDENT"
                and self.at_sym("(", ahead=3)
            ):
                return self.parse_function_call()
            # map projection: var{...}
            if self.at_sym("{", ahead=1):
                vname = self.name()
                return self.parse_map_projection(E.Var(vname))
            # plain variable
            self.next()
            return E.Var(t.text)
        self.fail("Expected expression")

    def parse_function_call(self) -> E.Expr:
        fname = self.name()
        while self.at_sym(".") and self.peek(1).kind == "IDENT":
            self.next()
            fname += "." + self.name()
        lowered = fname.lower()
        self.eat_sym("(")
        distinct = self.try_kw("DISTINCT")
        args: List[E.Expr] = []
        while not self.at_sym(")"):
            args.append(self.parse_expression())
            if not self.try_sym(","):
                break
        self.eat_sym(")")
        if lowered in AGG_NAMES:
            if not args:
                self.fail(f"Aggregator {fname} requires an argument")
            return E.Agg(lowered, args[0], distinct, tuple(args[1:]))
        if distinct:
            self.fail(f"DISTINCT only allowed in aggregations, not {fname}")
        return E.FunctionCall(lowered, tuple(args))

    def parse_map_projection(self, var: E.Var) -> E.Expr:
        self.eat_sym("{")
        items: List[Tuple[str, Optional[E.Expr]]] = []
        all_props = False
        while not self.at_sym("}"):
            if self.try_sym("."):
                if self.try_sym("*"):
                    all_props = True
                else:
                    items.append((self.name(), None))
            else:
                key = self.name()
                if self.try_sym(":"):
                    items.append((key, self.parse_expression()))
                else:
                    items.append((key, E.Var(key)))
            if not self.try_sym(","):
                break
        self.eat_sym("}")
        return E.MapProjection(var, tuple(items), all_props)

    def parse_case(self) -> E.Expr:
        self.eat_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expression()
        whens: List[E.Expr] = []
        thens: List[E.Expr] = []
        while self.try_kw("WHEN"):
            whens.append(self.parse_expression())
            self.eat_kw("THEN")
            thens.append(self.parse_expression())
        default = None
        if self.try_kw("ELSE"):
            default = self.parse_expression()
        self.eat_kw("END")
        if not whens:
            self.fail("CASE requires at least one WHEN")
        return E.CaseExpr(operand, tuple(whens), tuple(thens), default)

    def parse_list_atom(self) -> E.Expr:
        """List literal or list comprehension."""
        self.eat_sym("[")
        # pattern comprehension: [p = (a)-[:R]->(b) WHERE pred | proj]
        # (path binding optional). Backtracks: a '[' may also open a list
        # literal whose first element is a parenthesized expression.
        save = self.i
        try:
            part = self.parse_pattern_part()
            if part.rels and (self.at_kw("WHERE") or self.at_sym("|")):
                where = None
                if self.try_kw("WHERE"):
                    where = self.parse_expression()
                self.eat_sym("|")
                proj = self.parse_expression()
                self.eat_sym("]")
                return E.PatternComprehension(
                    A.Pattern((part,)),
                    part.path_var,
                    E.Opaque(where) if where is not None else None,
                    E.Opaque(proj),
                )
        except CypherSyntaxError:
            pass
        self.i = save
        # list comprehension: [x IN expr WHERE p | proj]
        if self.peek().kind in ("IDENT", "ESC_IDENT") and self.at_kw("IN", ahead=1):
            var = E.Var(self.name())
            self.eat_kw("IN")
            lst = self.parse_expression()
            where = None
            proj = None
            if self.try_kw("WHERE"):
                where = self.parse_expression()
            if self.try_sym("|"):
                proj = self.parse_expression()
            self.eat_sym("]")
            return E.ListComprehension(var, lst, where, proj)
        items: List[E.Expr] = []
        while not self.at_sym("]"):
            items.append(self.parse_expression())
            if not self.try_sym(","):
                break
        self.eat_sym("]")
        return E.ListLit(tuple(items))

    def parse_paren_or_pattern(self) -> E.Expr:
        """'(' — either a parenthesized expression or a pattern predicate."""
        save = self.i
        try:
            part = self.parse_pattern_part()
            if part.rels:
                return E.ExistsPattern(A.Pattern((part,)))
        except CypherSyntaxError:
            pass
        self.i = save
        self.eat_sym("(")
        e = self.parse_expression()
        self.eat_sym(")")
        # a parenthesized expr may still begin a pattern: (a)-[:R]->(b);
        # but '(expr) - x' is arithmetic — backtrack only if a pattern parses
        if self.at_sym("-") or self.at_sym("<-"):
            after = self.i
            self.i = save
            try:
                part = self.parse_pattern_part()
                return E.ExistsPattern(A.Pattern((part,)))
            except CypherSyntaxError:
                self.i = after
        return e

    def parse_pattern_or_expr(self):
        save = self.i
        try:
            pattern = self.parse_pattern()
            if any(p.rels for p in pattern.parts) and self.at_sym(")"):
                return pattern
        except CypherSyntaxError:
            pass
        self.i = save
        return self.parse_expression()


def parse(text: str) -> A.Statement:
    """Parse a Cypher statement."""
    return Parser(text).parse_statement()


def parse_expr(text: str) -> E.Expr:
    """Parse a standalone expression (testing convenience)."""
    p = Parser(text)
    e = p.parse_expression()
    if p.peek().kind != "EOF":
        p.fail("Unexpected input after expression")
    return e
