"""Recursive-descent Graph DDL parser.

Replaces the reference's fastparse grammar (``GraphDdlParser.scala:60-199``)
with a hand-written tokenizer + parser. Grammar surface (case-insensitive
keywords, ``--`` and ``//`` line comments, ``/* */`` block comments):

    ddl           := (setSchema | elementType | graphType | graph)*
    setSchema     := SET SCHEMA ident '.' ident ';'?
    elementType   := CREATE ELEMENT TYPE etd
    etd           := ident [EXTENDS ident (',' ident)*] [properties] [key]
    properties    := '(' [ident TYPE (',' ident TYPE)*] ')'
    key           := KEY ident '(' ident (',' ident)* ')'
    graphType     := CREATE GRAPH TYPE ident '(' (etd | nodeType | relType)^',' ')'
    nodeType      := '(' ident (',' ident)* ')'
    relType       := nodeType '-' '[' ident (',' ident)* ']' '->' nodeType
    graph         := CREATE GRAPH ident [OF ident] '(' graphStmt^',' ')'
    graphStmt     := relMapping | nodeMapping | etd | relType | nodeType
    nodeMapping   := nodeType (FROM viewId [propMapping])+
    propMapping   := '(' column AS prop (',' column AS prop)* ')'
    relMapping    := relType relToView+
    relToView     := FROM viewId alias [propMapping]
                     START NODES nodeToView END NODES nodeToView
    nodeToView    := nodeType FROM viewId alias JOIN ON joins
    joins         := qualCol '=' qualCol (AND qualCol '=' qualCol)*
    viewId        := escapedIdent ('.' escapedIdent){0,2}
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..api.type_parser import parse_cypher_type
from . import ddl_ast as A


class GraphDdlParseError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<arrow>->)
  | (?P<sym>[()\[\],.;=\-])
  | (?P<escaped>`(?:[^`]|``)*`)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<qmark>\?)
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {
    "CREATE", "ELEMENT", "EXTENDS", "KEY", "GRAPH", "TYPE", "OF", "AS",
    "FROM", "START", "END", "NODES", "JOIN", "ON", "AND", "SET", "SCHEMA",
}


class _Tok:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind  # 'word' | 'escaped' | 'sym' | 'arrow' | 'qmark'
        self.text = text
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.text!r}"


def _tokenize(s: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m:
            raise GraphDdlParseError(f"Unexpected character {s[i]!r} at offset {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        toks.append(_Tok(kind, m.group(), m.start()))
    return toks


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = _tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Optional[_Tok]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise GraphDdlParseError("Unexpected end of DDL input")
        self.i += 1
        return t

    def fail(self, what: str):
        t = self.peek()
        where = f"{t.text!r} (offset {t.pos})" if t else "end of input"
        line = self.text.count("\n", 0, t.pos) + 1 if t else "?"
        raise GraphDdlParseError(f"Expected {what} but found {where} at line {line}")

    def at_keyword(self, *kws: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "word" and t.text.upper() in kws

    def eat_keyword(self, kw: str):
        if not self.at_keyword(kw):
            self.fail(kw)
        self.next()

    def opt_keyword(self, kw: str) -> bool:
        if self.at_keyword(kw):
            self.next()
            return True
        return False

    def at_sym(self, sym: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t is not None and t.kind in ("sym", "arrow") and t.text == sym

    def eat_sym(self, sym: str):
        if not self.at_sym(sym):
            self.fail(repr(sym))
        self.next()

    def opt_sym(self, sym: str) -> bool:
        if self.at_sym(sym):
            self.next()
            return True
        return False

    def identifier(self) -> str:
        t = self.peek()
        if t is None or t.kind != "word":
            self.fail("identifier")
        self.next()
        return t.text

    def escaped_identifier(self) -> str:
        t = self.peek()
        if t is None:
            self.fail("identifier")
        if t.kind == "escaped":
            self.next()
            return t.text[1:-1].replace("``", "`")
        if t.kind == "word":
            self.next()
            return t.text
        self.fail("identifier")

    # -- grammar -----------------------------------------------------------

    def parse(self) -> A.DdlDefinition:
        stmts: List[object] = []
        while self.peek() is not None:
            stmts.append(self.ddl_statement())
        return A.DdlDefinition(tuple(stmts))

    def ddl_statement(self):
        if self.at_keyword("SET"):
            return self.set_schema()
        if self.at_keyword("CREATE"):
            nxt = self.peek(1)
            if nxt is not None and nxt.kind == "word":
                up = nxt.text.upper()
                if up == "ELEMENT":
                    return self.global_element_type()
                if up == "GRAPH":
                    third = self.peek(2)
                    if (
                        third is not None
                        and third.kind == "word"
                        and third.text.upper() == "TYPE"
                    ):
                        return self.graph_type_definition()
                    return self.graph_definition()
        self.fail("SET SCHEMA, CREATE ELEMENT TYPE, CREATE GRAPH TYPE or CREATE GRAPH")

    def set_schema(self) -> A.SetSchemaDefinition:
        self.eat_keyword("SET")
        self.eat_keyword("SCHEMA")
        ds = self.identifier()
        self.eat_sym(".")
        schema = self.identifier()
        self.opt_sym(";")
        return A.SetSchemaDefinition(ds, schema)

    def global_element_type(self) -> A.ElementTypeDefinition:
        self.eat_keyword("CREATE")
        self.eat_keyword("ELEMENT")
        self.eat_keyword("TYPE")
        return self.element_type_definition()

    def element_type_definition(self) -> A.ElementTypeDefinition:
        name = self.identifier()
        parents: Tuple[str, ...] = ()
        if self.opt_keyword("EXTENDS"):
            ps = [self.identifier()]
            while self.opt_sym(","):
                ps.append(self.identifier())
            parents = tuple(ps)
        props: Tuple[A.Property, ...] = ()
        if self.at_sym("("):
            props = self.properties()
        key: Optional[A.KeyDefinition] = None
        if self.at_keyword("KEY"):
            key = self.key_definition()
        return A.ElementTypeDefinition(name, parents, props, key)

    def properties(self) -> Tuple[A.Property, ...]:
        self.eat_sym("(")
        out: List[A.Property] = []
        if not self.at_sym(")"):
            out.append(self.property())
            while self.opt_sym(","):
                out.append(self.property())
        self.eat_sym(")")
        return tuple(out)

    def property(self) -> A.Property:
        name = self.escaped_identifier()
        # collect the type's raw token span up to ',' / ')' / KEY; parens may
        # nest inside the type itself (LIST(STRING), MAP(...))
        parts: List[str] = []
        depth = 0
        while True:
            t = self.peek()
            if t is None:
                break
            if t.kind == "sym" and t.text == "(":
                depth += 1
            elif t.kind == "sym" and t.text == ")":
                if depth == 0:
                    break
                depth -= 1
            elif t.kind == "sym" and t.text == "," and depth == 0:
                break
            elif t.kind == "word" and t.text.upper() == "KEY" and depth == 0:
                break
            self.next()
            parts.append(t.text)
        if not parts:
            self.fail("a Cypher type")
        try:
            ct = parse_cypher_type(" ".join(parts))
        except Exception as e:
            raise GraphDdlParseError(
                f"Cannot parse type {' '.join(parts)!r} for property {name!r}: {e}"
            )
        return (name, ct)

    def key_definition(self) -> A.KeyDefinition:
        self.eat_keyword("KEY")
        name = self.identifier()
        self.eat_sym("(")
        cols = [self.escaped_identifier()]
        while self.opt_sym(","):
            cols.append(self.escaped_identifier())
        self.eat_sym(")")
        return (name, tuple(cols))

    def node_type_definition(self) -> A.NodeTypeDefinition:
        self.eat_sym("(")
        ets = [self.identifier()]
        while self.opt_sym(","):
            ets.append(self.identifier())
        self.eat_sym(")")
        return A.NodeTypeDefinition(tuple(ets))

    def rel_type_definition(
        self, start: Optional[A.NodeTypeDefinition] = None
    ) -> A.RelationshipTypeDefinition:
        if start is None:
            start = self.node_type_definition()
        self.eat_sym("-")
        self.eat_sym("[")
        ets = [self.identifier()]
        while self.opt_sym(","):
            ets.append(self.identifier())
        self.eat_sym("]")
        self.eat_sym("->")
        end = self.node_type_definition()
        return A.RelationshipTypeDefinition(start, tuple(ets), end)

    def _looks_like_rel_type(self) -> bool:
        """After a '(' group, a '-' begins the `-[R]->` arm of a rel type."""
        depth = 0
        j = 0
        while True:
            t = self.peek(j)
            if t is None:
                return False
            if t.kind == "sym" and t.text == "(":
                depth += 1
            elif t.kind == "sym" and t.text == ")":
                depth -= 1
                if depth == 0:
                    nxt = self.peek(j + 1)
                    return nxt is not None and nxt.kind == "sym" and nxt.text == "-"
            j += 1

    def graph_type_statement(self):
        """elementTypeDefinition | relTypeDefinition | nodeTypeDefinition —
        order matters (reference ``GraphDdlParser.scala:124-126``)."""
        if self.at_sym("("):
            if self._looks_like_rel_type():
                return self.rel_type_definition()
            return self.node_type_definition()
        return self.element_type_definition()

    def graph_type_definition(self) -> A.GraphTypeDefinition:
        self.eat_keyword("CREATE")
        self.eat_keyword("GRAPH")
        self.eat_keyword("TYPE")
        name = self.identifier()
        self.eat_sym("(")
        stmts: List[object] = []
        if not self.at_sym(")"):
            stmts.append(self.graph_type_statement())
            while self.opt_sym(","):
                stmts.append(self.graph_type_statement())
        self.eat_sym(")")
        return A.GraphTypeDefinition(name, tuple(stmts))

    # -- graph (mapping) definitions --------------------------------------

    def view_id(self) -> Tuple[str, ...]:
        parts = [self.escaped_identifier()]
        while len(parts) < 3 and self.at_sym("."):
            self.next()
            parts.append(self.escaped_identifier())
        return tuple(parts)

    def property_mapping(self) -> Tuple[Tuple[str, str], ...]:
        """``( column AS property, ... )`` → prop → column pairs."""
        self.eat_sym("(")
        out: List[Tuple[str, str]] = []
        col = self.escaped_identifier()
        self.eat_keyword("AS")
        prop = self.escaped_identifier()
        out.append((prop, col))
        while self.opt_sym(","):
            col = self.escaped_identifier()
            self.eat_keyword("AS")
            prop = self.escaped_identifier()
            out.append((prop, col))
        self.eat_sym(")")
        return tuple(out)

    def node_to_view(self) -> A.NodeToViewDefinition:
        self.eat_keyword("FROM")
        vid = self.view_id()
        pm = None
        if self.at_sym("("):
            pm = self.property_mapping()
        return A.NodeToViewDefinition(vid, pm)

    def column_identifier(self) -> Tuple[str, ...]:
        parts = [self.identifier()]
        self.eat_sym(".")
        parts.append(self.identifier())
        while self.at_sym("."):
            self.next()
            parts.append(self.identifier())
        return tuple(parts)

    def join_on(self) -> A.JoinOnDefinition:
        self.eat_keyword("JOIN")
        self.eat_keyword("ON")
        preds = []
        lhs = self.column_identifier()
        self.eat_sym("=")
        rhs = self.column_identifier()
        preds.append((lhs, rhs))
        while self.opt_keyword("AND"):
            lhs = self.column_identifier()
            self.eat_sym("=")
            rhs = self.column_identifier()
            preds.append((lhs, rhs))
        return A.JoinOnDefinition(tuple(preds))

    def node_type_to_view(self) -> A.NodeTypeToViewDefinition:
        nt = self.node_type_definition()
        self.eat_keyword("FROM")
        vid = self.view_id()
        alias = self.identifier()
        join = self.join_on()
        return A.NodeTypeToViewDefinition(nt, A.ViewDefinition(vid, alias), join)

    def rel_type_to_view(self) -> A.RelationshipTypeToViewDefinition:
        self.eat_keyword("FROM")
        vid = self.view_id()
        alias = self.identifier()
        pm = None
        if self.at_sym("("):
            pm = self.property_mapping()
        self.eat_keyword("START")
        self.eat_keyword("NODES")
        start = self.node_type_to_view()
        self.eat_keyword("END")
        self.eat_keyword("NODES")
        end = self.node_type_to_view()
        return A.RelationshipTypeToViewDefinition(
            A.ViewDefinition(vid, alias), pm, start, end
        )

    def graph_statement(self):
        """relMapping | nodeMapping | elementType | relType | nodeType —
        order matters (reference ``GraphDdlParser.scala:180-182``)."""
        if self.at_sym("("):
            if self._looks_like_rel_type():
                rel = self.rel_type_definition()
                if self.at_keyword("FROM"):
                    views = [self.rel_type_to_view()]
                    while True:
                        if self.at_keyword("FROM"):
                            views.append(self.rel_type_to_view())
                        elif self.at_sym(",") and self._comma_then("FROM"):
                            self.next()
                            views.append(self.rel_type_to_view())
                        else:
                            break
                    return A.RelationshipMappingDefinition(rel, tuple(views))
                return rel
            nt = self.node_type_definition()
            if self.at_keyword("FROM"):
                views = [self.node_to_view()]
                while True:
                    if self.at_keyword("FROM"):
                        views.append(self.node_to_view())
                    elif self.at_sym(",") and self._comma_then("FROM"):
                        self.next()
                        views.append(self.node_to_view())
                    else:
                        break
                return A.NodeMappingDefinition(nt, tuple(views))
            return nt
        return self.element_type_definition()

    def _comma_then(self, kw: str) -> bool:
        t = self.peek(1)
        return t is not None and t.kind == "word" and t.text.upper() == kw

    def graph_definition(self) -> A.GraphDefinition:
        self.eat_keyword("CREATE")
        self.eat_keyword("GRAPH")
        name = self.identifier()
        gt = None
        if self.opt_keyword("OF"):
            gt = self.identifier()
        self.eat_sym("(")
        stmts: List[object] = []
        if not self.at_sym(")"):
            stmts.append(self.graph_statement())
            while self.opt_sym(","):
                stmts.append(self.graph_statement())
        self.eat_sym(")")
        return A.GraphDefinition(name, gt, tuple(stmts))


def parse_ddl(text: str) -> A.DdlDefinition:
    """Parse a Graph DDL script into its AST
    (reference ``GraphDdlParser.parseDdl``, ``GraphDdlParser.scala:50``)."""
    return _Parser(text).parse()
