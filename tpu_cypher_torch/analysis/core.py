"""Shared analysis substrate: one parse + one scope-resolution pass per file.

The port's copy of ``tpu_cypher/analysis/core.py``.

Every rule consumes the same ``FileContext``: the AST with parent links, an
enclosing-function index, a per-function assignment table (for one-level
value chasing: "was this name bound from a device-producing call?"), the
pre-extracted call list, and the parsed suppression comments. Building
these once per file — instead of once per rule per file — is what lets the
whole port lint in seconds (seven rules over ~130 modules is one parse,
not seven).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location. ``path`` is normalized to
    a posix-style path relative to the analysis root so baselines and JSON
    output are machine-portable."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def baseline_key(self) -> Tuple[str, str, str]:
        # line numbers drift with unrelated edits; (rule, path, message)
        # is stable as long as the offending construct survives
        return (self.rule, self.path, self.message)


# ---------------------------------------------------------------------------
# suppressions: `# tpulint: allow[rule-a,rule-b] reason=...`
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*tpulint:\s*allow\[(?P<rules>[^\]]*)\]\s*(?:reason=(?P<reason>.*))?$"
)
_TPULINT_RE = re.compile(r"#\s*tpulint:")


@dataclass
class Suppression:
    line: int  # the line the comment sits on
    rules: Tuple[str, ...]
    reason: str
    covers: Tuple[int, ...] = ()  # lines this suppression applies to


def _parse_suppressions(lines: Sequence[str]) -> Tuple[List[Suppression], List[Finding]]:
    """A suppression covers the line it shares with code; a comment-only
    line covers the next line instead (the ``# noqa``-above style). The
    reason is MANDATORY — an allow without one is reported as a
    ``suppression`` finding and ignored, as is any malformed ``tpulint:``
    comment (a typo must not silently stop suppressing)."""
    sups: List[Suppression] = []
    bad: List[Finding] = []
    for i, text in enumerate(lines, start=1):
        if "tpulint" not in text:
            continue
        m = _SUPPRESS_RE.search(text)
        if not m:
            if _TPULINT_RE.search(text):
                bad.append(
                    Finding(
                        "suppression",
                        "",
                        i,
                        max(text.find("#"), 0),
                        "malformed tpulint comment (expected "
                        "'# tpulint: allow[rule-id] reason=...')",
                    )
                )
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        reason = (m.group("reason") or "").strip()
        comment_only = text[: m.start()].strip() == ""
        covered = (i + 1,) if comment_only else (i,)
        if not rules or not reason:
            bad.append(
                Finding(
                    "suppression",
                    "",
                    i,
                    max(text.find("#"), 0),
                    "suppression without a %s — every allow must name its "
                    "rule(s) and carry reason=<why this site is exempt>"
                    % ("reason" if rules else "rule id"),
                )
            )
            continue
        sups.append(Suppression(i, rules, reason, covered))
    return sups, bad


# ---------------------------------------------------------------------------
# file context
# ---------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> str:
    """``torch.nonzero`` / ``os.environ.get`` / ``fault_point`` as a dotted
    string; '' when the expression is not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class FileContext:
    """Parsed AST + indexes for one source file. Raises ``SyntaxError`` on
    unparsable input (the runner reports it as a ``parse`` finding)."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace("\\", "/")
        self.source = source
        self.lines: List[str] = source.splitlines()
        self.tree = ast.parse(source)

        self.parent: Dict[ast.AST, ast.AST] = {}
        self.functions: List[ast.AST] = []
        self.calls: List[ast.Call] = []
        self._enclosing: Dict[ast.AST, Optional[ast.AST]] = {}
        self._func_assigns: Dict[Optional[ast.AST], Dict[str, List[ast.expr]]] = {}
        self._func_unpacks: Dict[
            Optional[ast.AST], Dict[str, List[Tuple[ast.expr, Optional[int]]]]
        ] = {}
        self._func_calls: Dict[Optional[ast.AST], List[ast.Call]] = {}

        self._index()
        self.suppressions, self.suppression_findings = _parse_suppressions(
            self.lines
        )
        self._allow: Dict[int, Dict[str, str]] = {}
        for s in self.suppressions:
            for ln in s.covers:
                slot = self._allow.setdefault(ln, {})
                for r in s.rules:
                    slot[r] = s.reason

    # -- construction -------------------------------------------------------

    def _index(self) -> None:
        stack: List[ast.AST] = []

        def visit(node: ast.AST) -> None:
            fn = stack[-1] if stack else None
            self._enclosing[node] = fn
            if isinstance(node, ast.Call):
                self.calls.append(node)
                self._func_calls.setdefault(fn, []).append(node)
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    self._func_assigns.setdefault(fn, {}).setdefault(
                        t.id, []
                    ).append(node.value)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    starred = any(isinstance(e, ast.Starred) for e in t.elts)
                    for i, e in enumerate(t.elts):
                        if isinstance(e, ast.Name):
                            self._func_unpacks.setdefault(fn, {}).setdefault(
                                e.id, []
                            ).append((node.value, None if starred else i))
            is_fn = isinstance(node, _FUNC_NODES)
            if is_fn:
                self.functions.append(node)
                # decorators, parameter defaults, and annotations evaluate
                # in the ENCLOSING scope — visit them before pushing
                outer_children = list(node.decorator_list) + [
                    d for d in node.args.defaults if d is not None
                ] + [d for d in node.args.kw_defaults if d is not None]
                if node.returns is not None:
                    outer_children.append(node.returns)
                for child in outer_children:
                    self.parent[child] = node
                    visit(child)
                stack.append(node)
                for child in node.body:
                    self.parent[child] = node
                    visit(child)
                stack.pop()
                return
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
                visit(child)

        visit(self.tree)

    # -- queries ------------------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        """Innermost FunctionDef/AsyncFunctionDef containing ``node`` (None
        at module scope)."""
        return self._enclosing.get(node)

    def calls_in(self, fn: Optional[ast.AST]) -> List[ast.Call]:
        """Calls whose innermost enclosing function is ``fn`` — NOT
        transitive into nested defs (a nested closure is its own scope)."""
        return self._func_calls.get(fn, [])

    def calls_under(self, fn: ast.AST) -> Iterator[ast.Call]:
        """All calls lexically under ``fn``, including nested defs."""
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                yield n

    def assignments(self, fn: Optional[ast.AST], name: str) -> List[ast.expr]:
        """Every ``name = <expr>`` value bound in ``fn``'s own scope."""
        return self._func_assigns.get(fn, {}).get(name, [])

    def unpacks(
        self, fn: Optional[ast.AST], name: str
    ) -> List[Tuple[ast.expr, Optional[int]]]:
        """Every ``a, name, .. = <expr>`` in ``fn``'s own scope, as (expr,
        the position of ``name``; None after a starred target)."""
        return self._func_unpacks.get(fn, {}).get(name, [])

    def param_names(self, fn: ast.AST) -> List[str]:
        a = fn.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def allowed(self, lineno: int, rule: str) -> Optional[str]:
        """The suppression reason covering (line, rule), or None."""
        slot = self._allow.get(lineno)
        if not slot:
            return None
        return slot.get(rule)

    def finding(
        self, rule: str, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule,
            self.relpath,
            getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0),
            message,
        )


# ---------------------------------------------------------------------------
# rule base
# ---------------------------------------------------------------------------


class Rule:
    """One invariant. ``check`` yields findings for a single file; cross-
    file facts (the config registry's declared names, dispatch's registered
    impls) come in via the ``ProjectContext`` built by the runner."""

    id: str = ""
    title: str = ""
    rationale: str = ""

    def check(self, ctx: FileContext, project: "ProjectContext"):  # noqa: F821
        raise NotImplementedError
        yield  # pragma: no cover
