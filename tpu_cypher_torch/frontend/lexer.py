"""Cypher lexer.

Hand-rolled tokenizer for the openCypher 9 surface (the reference uses Neo4j's
``cypher-frontend``; we own the whole frontend — SURVEY.md §7 step 2).

Keywords are not distinguished from identifiers at the token level (Cypher
keywords are contextual); the parser matches them case-insensitively via the
token's ``upper`` form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class CypherSyntaxError(Exception):
    def __init__(self, msg: str, text: str = "", pos: int = 0):
        self.pos = pos
        if text:
            line = text.count("\n", 0, pos) + 1
            col = pos - (text.rfind("\n", 0, pos) + 1) + 1
            snippet = text[max(0, pos - 20) : pos + 20].replace("\n", " ")
            msg = f"{msg} (line {line}, column {col}, near {snippet!r})"
        super().__init__(msg)


@dataclass(frozen=True)
class Token:
    kind: str  # IDENT ESC_IDENT INT FLOAT STRING PARAM SYM EOF
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


# multi-char symbols, longest first
_SYMBOLS = [
    "<=",
    ">=",
    "<>",
    "=~",
    "->",
    "<-",
    "..",
    "+=",
    "(",
    ")",
    "[",
    "]",
    "{",
    "}",
    ",",
    ":",
    ";",
    ".",
    "+",
    "-",
    "*",
    "/",
    "%",
    "^",
    "=",
    "<",
    ">",
    "|",
    "$",
]

_ID_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_ID_CONT = _ID_START | set("0123456789")
_DIGITS = set("0123456789")
_HEX = _DIGITS | set("abcdefABCDEF")

_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "b": "\b",
    "f": "\f",
    "'": "'",
    '"': '"',
    "\\": "\\",
    "/": "/",
}


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            i += 1
            continue
        # comments
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise CypherSyntaxError("Unterminated block comment", text, i)
            i = j + 2
            continue
        # strings
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n:
                ch = text[j]
                if ch == "\\":
                    if j + 1 >= n:
                        raise CypherSyntaxError("Unterminated escape", text, j)
                    esc = text[j + 1]
                    if esc == "u":
                        hexpart = text[j + 2 : j + 6]
                        if len(hexpart) < 4 or not all(c in _HEX for c in hexpart):
                            raise CypherSyntaxError("Bad unicode escape", text, j)
                        buf.append(chr(int(hexpart, 16)))
                        j += 6
                        continue
                    if esc not in _ESCAPES:
                        raise CypherSyntaxError(f"Unknown escape \\{esc}", text, j)
                    buf.append(_ESCAPES[esc])
                    j += 2
                    continue
                if ch == quote:
                    break
                buf.append(ch)
                j += 1
            else:
                raise CypherSyntaxError("Unterminated string literal", text, i)
            tokens.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        # escaped identifiers
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise CypherSyntaxError("Unterminated escaped identifier", text, i)
            tokens.append(Token("ESC_IDENT", text[i + 1 : j], i))
            i = j + 1
            continue
        # numbers
        if c in _DIGITS or (c == "." and i + 1 < n and text[i + 1] in _DIGITS):
            # hex / octal
            if c == "0" and i + 1 < n and text[i + 1] in "xX":
                j = i + 2
                while j < n and text[j] in _HEX:
                    j += 1
                if j == i + 2:
                    raise CypherSyntaxError("Malformed hex literal", text, i)
                tokens.append(Token("INT", str(int(text[i:j], 16)), i))
                i = j
                continue
            j = i
            is_float = False
            while j < n and text[j] in _DIGITS:
                j += 1
            # don't consume '..' (range), only '.' followed by a digit
            if j < n and text[j] == "." and j + 1 < n and text[j + 1] in _DIGITS:
                is_float = True
                j += 1
                while j < n and text[j] in _DIGITS:
                    j += 1
            if c == "." :
                is_float = True
            if j < n and text[j] in "eE":
                k = j + 1
                if k < n and text[k] in "+-":
                    k += 1
                if k < n and text[k] in _DIGITS:
                    is_float = True
                    j = k
                    while j < n and text[j] in _DIGITS:
                        j += 1
            kind = "FLOAT" if is_float else "INT"
            tokens.append(Token(kind, text[i:j], i))
            i = j
            continue
        # identifiers / keywords
        if c in _ID_START:
            j = i + 1
            while j < n and text[j] in _ID_CONT:
                j += 1
            tokens.append(Token("IDENT", text[i:j], i))
            i = j
            continue
        # symbols
        for sym in _SYMBOLS:
            if text.startswith(sym, i):
                tokens.append(Token("SYM", sym, i))
                i += len(sym)
                break
        else:
            raise CypherSyntaxError(f"Unexpected character {c!r}", text, i)
    tokens.append(Token("EOF", "", n))
    return tokens
