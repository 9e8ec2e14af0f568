"""Parser for the textual CypherType syntax emitted by ``repr(CypherType)``.

Mirrors ``okapi-api/src/main/scala/org/opencypher/okapi/impl/types/CypherTypeParser.scala``
for schema JSON round-trips.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from . import types as T

_TOKEN = re.compile(
    r"\s*(?:(?P<lparen>\()|(?P<rparen>\))|(?P<comma>,)|(?P<colon>:)"
    r"|(?P<qmark>\?)|(?P<pipe>\|)|(?P<num>\d+)"
    r"|(?P<word>[A-Za-z_][A-Za-z0-9_]*)|(?P<str>`[^`]*`))"
)


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"Cannot tokenize type string at {s[pos:]!r}")
        pos = m.end()
        for name, val in m.groupdict().items():
            if val is not None:
                out.append((name, val.strip()))
                break
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, kind):
        k, v = self.next()
        if k != kind:
            raise ValueError(f"Expected {kind}, got {k}:{v}")
        return v

    def parse(self) -> T.CypherType:
        t = self.parse_one()
        k, _ = self.peek()
        if k == "qmark":
            self.next()
            t = t.nullable
        return t

    def _name(self) -> str:
        k, v = self.next()
        if k == "word":
            return v
        if k == "str":
            return v[1:-1]
        raise ValueError(f"Expected name, got {k}:{v}")

    def parse_one(self) -> T.CypherType:
        k, v = self.next()
        if k != "word":
            raise ValueError(f"Expected type name, got {k}:{v}")
        u = v.upper()
        simple = {
            "ANY": T.CTAny,
            "VOID": T.CTVoid,
            "NOTHING": T.CTVoid,
            "NULL": T.CTNull,
            "BOOLEAN": T.CTBoolean,
            "STRING": T.CTString,
            "INTEGER": T.CTInteger,
            "FLOAT": T.CTFloat,
            "NUMBER": T.CTNumber,
            "DATE": T.CTDate,
            "LOCALDATETIME": T.CTLocalDateTime,
            "DATETIME": T.CTDateTime,
            "LOCALTIME": T.CTLocalTime,
            "TIME": T.CTTime,
            "DURATION": T.CTDuration,
            "PATH": T.CTPath,
            "ELEMENTID": T.CTElementId,
        }
        if u in simple:
            return simple[u]
        if u == "NODE":
            labels = []
            if self.peek()[0] == "lparen":
                self.next()
                while self.peek()[0] != "rparen":
                    if self.peek()[0] == "colon":
                        self.next()
                        continue
                    labels.append(self._name())
                self.expect("rparen")
            return T.CTNodeType(labels)
        if u == "RELATIONSHIP":
            types = []
            if self.peek()[0] == "lparen":
                self.next()
                while self.peek()[0] != "rparen":
                    if self.peek()[0] in ("pipe", "colon"):
                        self.next()
                        continue
                    types.append(self._name())
                self.expect("rparen")
            return T.CTRelationshipType(types)
        if u == "LIST":
            self.expect("lparen")
            inner = self.parse()
            self.expect("rparen")
            return T.CTListType(inner)
        if u == "MAP":
            if self.peek()[0] != "lparen":
                return T.CTMapType(None)
            self.next()
            fields = {}
            while self.peek()[0] != "rparen":
                if self.peek()[0] == "comma":
                    self.next()
                    continue
                key = self._name()
                self.expect("colon")
                fields[key] = self.parse()
            self.expect("rparen")
            return T.CTMapType(fields)
        if u == "BIGDECIMAL":
            if self.peek()[0] != "lparen":
                return T.CTBigDecimalType()
            self.next()
            prec = int(self.expect("num"))
            self.expect("comma")
            scale = int(self.expect("num"))
            self.expect("rparen")
            return T.CTBigDecimalType(prec, scale)
        if u == "UNION":
            self.expect("lparen")
            alts = []
            while self.peek()[0] != "rparen":
                if self.peek()[0] == "comma":
                    self.next()
                    continue
                alts.append(self.parse())
            self.expect("rparen")
            return T.CTUnion.of(*alts)
        raise ValueError(f"Unknown type name {v!r}")


def parse_cypher_type(s: str) -> T.CypherType:
    return _Parser(_tokenize(s)).parse()
