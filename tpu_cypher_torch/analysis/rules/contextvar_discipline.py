"""contextvar-discipline: every ``ContextVar.set`` balances its token.

The engine's per-query state — guard deadline, ladder rung, trace span,
metric scopes, scoped fault schedules — is all ``contextvars``. The
serving tier multiplexes 100 clients onto one process by running each
query in a FRESH ``contextvars.Context`` (``SessionPool._isolated``), so
a ``set`` inside a lane dies with the query. Everywhere else, an
unbalanced ``set`` leaks state into the next query sharing that context:
the classic "deadline from request A kills request B" bug.

The rule identifies ContextVars by RESOLUTION, not by name: a module-level
``X = ContextVar(..)`` / ``X: ContextVar[..] = ContextVar(..)`` binding
(local or imported) is a ContextVar; ``bucketing.MODE.set(..)`` — a
``ConfigOption`` with its own override stack — never matches. On every
resolved ``X.set(..)``:

* module scope: flagged outright (an import-time ``set`` poisons every
  context that ever forks from the main thread's).
* the returned token must be kept: a bare ``X.set(..)`` expression
  statement discards the only handle that can restore the previous value.
* a token kept in a local must be ``X.reset(tok)`` inside a ``finally``
  in the same function (the only construct that runs on ALL exit paths).
* a token kept on ``self`` (the ``__enter__``/``__exit__`` idiom every
  engine scope uses: ``guard.activate``, ``guard.request_deadline``,
  ``faults.scoped_spec``, ``obs.trace.activate``/``span``,
  ``obs.metrics`` scopes) needs SOME method of the same class calling
  ``X.reset(self.<attr>)``.
* functions that only ever run on a pool lane (``lane_reachable`` in the
  call graph) are exempt — their context is born and dies with the query.

Declarations are checked too: a mutable default (``default=[]``) is
shared across every context that never ``set`` — mutation through one
context is visible to all of them.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..callgraph import module_path
from ..core import FileContext, Finding, Rule, dotted_name
from ..project import ProjectContext

_MUTABLE_CALLS = ("list", "dict", "set", "defaultdict", "deque")


def _is_contextvar_decl(expr: ast.expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func)
    return name in ("ContextVar", "contextvars.ContextVar")


def _mutable_default(expr: ast.Call) -> Optional[ast.expr]:
    for kw in expr.keywords:
        if kw.arg != "default":
            continue
        v = kw.value
        if isinstance(v, (ast.List, ast.Dict, ast.Set)):
            return v
        if (
            isinstance(v, ast.Call)
            and dotted_name(v.func).split(".")[-1] in _MUTABLE_CALLS
        ):
            return v
    return None


class ContextvarDisciplineRule(Rule):
    id = "contextvar-discipline"
    title = "ContextVar.set keeps and resets its token on all exit paths"
    rationale = (
        "an unbalanced set leaks one query's deadline/rung/trace into the "
        "next query sharing the context; a mutable default is shared "
        "across every context"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        graph = project.callgraph
        mod = graph.modules.get(module_path(ctx.relpath))
        if mod is None:
            return
        cvars = _project_contextvars(project)
        local = cvars.get(mod.path, {})

        # declaration hygiene: no mutable defaults
        for name, decl in local.items():
            bad = _mutable_default(decl)
            if bad is not None:
                yield ctx.finding(
                    self.id,
                    bad,
                    f"ContextVar '{name}' has a MUTABLE default — the "
                    "default object is shared by every context that never "
                    "set(); use an immutable sentinel and copy on write",
                )

        lane = graph.lane_reachable()
        for call in ctx.calls:
            target = self._resolved_set(graph, mod, cvars, call)
            if target is None:
                continue
            var_name = target
            fn = ctx.enclosing_function(call)
            if fn is None:
                yield ctx.finding(
                    self.id,
                    call,
                    f"module-scope {var_name}.set() poisons every context "
                    "forked after import — set per-query state inside a "
                    "scope object (enter/exit) instead",
                )
                continue
            if fn in lane:
                continue  # fresh-Context lane: state dies with the query
            parent = ctx.parent.get(call)
            if isinstance(parent, ast.Expr):
                yield ctx.finding(
                    self.id,
                    call,
                    f"{var_name}.set() discards its token — keep it and "
                    "reset() on all exit paths, or the previous value is "
                    "unrestorable",
                )
                continue
            if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
                t = parent.targets[0]
                if isinstance(t, ast.Name):
                    if not self._reset_in_finally(ctx, fn, var_name, t.id):
                        yield ctx.finding(
                            self.id,
                            call,
                            f"token of {var_name}.set() is not reset in a "
                            f"finally block of this function — "
                            f"'{var_name}.reset({t.id})' must run on ALL "
                            "exit paths",
                        )
                    continue
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    if not self._reset_in_class(
                        graph, ctx, fn, var_name, t.attr
                    ):
                        yield ctx.finding(
                            self.id,
                            call,
                            f"token of {var_name}.set() is stored on "
                            f"self.{t.attr} but no method of this class "
                            f"calls {var_name}.reset(self.{t.attr}) — the "
                            "scope has no exit path",
                        )
                    continue
            yield ctx.finding(
                self.id,
                call,
                f"token of {var_name}.set() is not kept in a resettable "
                "binding (local or self attribute) — the previous value "
                "is unrestorable",
            )

    # -- resolution ----------------------------------------------------------

    @staticmethod
    def _resolved_set(graph, mod, cvars, call: ast.Call) -> Optional[str]:
        """The spelled receiver name when ``call`` is ``X.set(..)`` on a
        resolved ContextVar, else None."""
        name = dotted_name(call.func)
        if not name.endswith(".set") or name.count(".") > 2:
            return None
        recv = name[: -len(".set")]
        parts = recv.split(".")
        if len(parts) == 1:
            if parts[0] in cvars.get(mod.path, {}):
                return recv
            imp = mod.imports.get(parts[0])
            if imp is not None and imp[1] is not None:
                target = graph._find_module(imp[0])  # noqa: SLF001
                if target is not None and imp[1] in cvars.get(
                    target.path, {}
                ):
                    return recv
            return None
        # mod_alias.X.set(..): the head must be an imported module
        imp = mod.imports.get(parts[0])
        if imp is None:
            return None
        target_path = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
        target = graph._find_module(target_path)  # noqa: SLF001
        if target is not None and parts[1] in cvars.get(target.path, {}):
            return recv
        return None

    # -- token discipline -----------------------------------------------------

    @staticmethod
    def _reset_in_finally(
        ctx: FileContext, fn: ast.AST, var_name: str, token: str
    ) -> bool:
        leaf = var_name.split(".")[-1]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try) or not node.finalbody:
                continue
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    name = dotted_name(sub.func)
                    if not name.endswith(".reset"):
                        continue
                    if name[: -len(".reset")].split(".")[-1] != leaf:
                        continue
                    if any(
                        isinstance(a, ast.Name) and a.id == token
                        for a in sub.args
                    ):
                        return True
        return False

    @staticmethod
    def _reset_in_class(
        graph, ctx: FileContext, fn: ast.AST, var_name: str, attr: str
    ) -> bool:
        leaf = var_name.split(".")[-1]
        cls = _enclosing_classdef(ctx, fn)
        if cls is None:
            return False
        for sub in ast.walk(cls):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            if not name.endswith(".reset"):
                continue
            if name[: -len(".reset")].split(".")[-1] != leaf:
                continue
            for a in sub.args:
                if (
                    isinstance(a, ast.Attribute)
                    and a.attr == attr
                    and isinstance(a.value, ast.Name)
                    and a.value.id == "self"
                ):
                    return True
        return False


# -- shared helpers ----------------------------------------------------------


def _enclosing_classdef(ctx: FileContext, fn: ast.AST) -> Optional[ast.AST]:
    node = ctx.parent.get(fn)
    while node is not None:
        if isinstance(node, ast.ClassDef):
            return node
        node = ctx.parent.get(node)
    return None


def _project_contextvars(
    project: ProjectContext,
) -> Dict[str, Dict[str, ast.Call]]:
    """module path -> {name: declaration Call} for every module-level
    ContextVar in the analyzed set. Cached on the project (one pass)."""
    cached = getattr(project, "_contextvar_index", None)
    if cached is not None:
        return cached
    out: Dict[str, Dict[str, ast.Call]] = {}
    for path, mod in project.callgraph.modules.items():
        found: Dict[str, ast.Call] = {}
        for name, exprs in mod.globals.items():
            for e in exprs:
                if _is_contextvar_decl(e):
                    found[name] = e
        if found:
            out[path] = found
    project._contextvar_index = out  # noqa: SLF001
    return out
